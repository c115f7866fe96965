"""Training-schedule hooks (port of ``train/hooks.py``): step-indexed
runtime toggles the train loop evaluates on the host and passes into the
step as scalars (detection weight, threshold buffer) or into the data
pipeline (augmentation switch)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RuntimeSchedule:
    enable_detection_step: int = 0       # detection losses off before this
    threshold_buffer_start: float = 0.0  # extra foreground-score threshold at enable
    threshold_buffer_end_step: int = 0   # linear decay to 0 by this step
    disable_aug_step: int = -1           # GT-paste augmentation off from this step (-1 = never)

    def enable_detection(self, step: int) -> bool:
        return step >= self.enable_detection_step

    def threshold_buffer(self, step: int) -> float:
        """0 before detection is enabled; from there a linear decay from
        ``threshold_buffer_start`` to 0 at ``threshold_buffer_end_step``."""
        if self.threshold_buffer_end_step <= self.enable_detection_step:
            return 0.0
        if step < self.enable_detection_step:
            return 0.0
        span = self.threshold_buffer_end_step - self.enable_detection_step
        frac = min((step - self.enable_detection_step) / span, 1.0)
        return self.threshold_buffer_start * (1.0 - frac)

    def augmentation_enabled(self, step: int) -> bool:
        return self.disable_aug_step < 0 or step < self.disable_aug_step
