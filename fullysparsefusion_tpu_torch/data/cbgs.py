"""Class-balanced resampling (CBGS), the port's copy of the JAX package's
``data/cbgs.py``: the same indices from the same generator state. Replaces
mmdet3d CBGSDataset and the reference's My_Resample_Dataset
(datasets/dataset_wrappers.py:7-81).

Pure index math on host: given per-sample class sets, repeat samples so each
class's expected frequency approaches 1/num_classes (Zhu et al., CBGS).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def class_balanced_indices(
    sample_classes: Sequence[Sequence[int]],
    num_classes: int,
    rng: np.random.Generator,
    extra_class_fraction: Optional[Dict[int, float]] = None,
) -> np.ndarray:
    """Resampled dataset indices.

    sample_classes[i] = set of class ids present in sample i. Each sample is
    duplicated with ratio Σ_{c ∈ sample} (target_c / freq_c) / |classes in
    sample| where target = 1/num_classes, following mmdet3d's CBGSDataset.
    ``extra_class_fraction`` adds per-class extra duplication
    (My_Resample_Dataset's per-class fractions).
    """
    n = len(sample_classes)
    counts = np.zeros(num_classes, np.int64)
    for cls_list in sample_classes:
        for c in set(cls_list):
            counts[c] += 1
    freqs = counts / max(counts.sum(), 1)
    target = 1.0 / num_classes
    ratios = np.where(freqs > 0, target / np.maximum(freqs, 1e-12), 0.0)

    out: List[int] = []
    for i, cls_list in enumerate(sample_classes):
        cs = sorted(set(cls_list))
        if not cs:
            out.append(i)
            continue
        r = float(np.mean([ratios[c] for c in cs]))
        if extra_class_fraction:
            r += sum(extra_class_fraction.get(c, 0.0) for c in cs)
        whole = int(np.floor(r))
        frac = r - whole
        reps = whole + (1 if rng.random() < frac else 0)
        out.extend([i] * max(reps, 1))
    idx = np.asarray(out, np.int64)
    rng.shuffle(idx)
    return idx
