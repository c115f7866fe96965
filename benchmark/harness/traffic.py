"""The one generator of every traffic mix: a pool of frames made from the
seed by the parameters of ``benchmark/traffic/<name>.json``.

Every seed gets the same set of object counts (``objects`` spread evenly
over ``pool`` frames) in its own order, and each frame its own seed from
``(seed, frame)``: the seed changes which scene, not how many objects. The
configuration's family makes each frame from them (``make_frame``).
``points_on`` says where a frame's sensor data waits for its unit: on the
host (a sensor delivers it frame by frame, and the unit copies it to the
device) or on the device.

The harness runs one frame at a time at batch 1, in a closed loop; a mix
file holds only the keys of :data:`KEYS` for its mode and those its
family reads, and any other key is refused rather than left unread."""
from __future__ import annotations

from typing import Any, Collection, List, Mapping

import numpy as np

SEED_MASK = (1 << 64) - 1

# the keys a mix file of each mode holds; "note" is free text
KEYS = {
    "serve": {"mode", "pool", "objects", "points_on", "traced_units", "judged_units", "note"},
    "train": {"mode", "pool", "objects", "points_on", "checked_steps", "traced_units", "note"},
}
POINTS_ON = ("host", "device")


def check(traffic: Mapping[str, Any], family_keys: Collection[str] = ()) -> Mapping[str, Any]:
    """``traffic`` if the harness can run it as written, reading
    ``family_keys`` besides its own; else ValueError."""
    mode = traffic.get("mode")
    if mode not in KEYS:
        raise ValueError(f"traffic mode {mode!r}: the harness runs {sorted(KEYS)}")
    unknown = set(traffic) - KEYS[mode] - set(family_keys)
    missing = KEYS[mode] - {"note"} - set(traffic)
    if unknown or missing:
        raise ValueError(f"traffic ({mode}): keys the harness does not read {sorted(unknown)}, "
                         f"keys it needs {sorted(missing)}")
    if traffic["points_on"] not in POINTS_ON:
        raise ValueError(f"traffic points_on {traffic['points_on']!r}: one of {POINTS_ON}")
    return traffic


def object_counts(traffic: Mapping[str, Any], seed: int) -> List[int]:
    lo, hi = traffic["objects"]
    counts = np.round(np.linspace(lo, hi, traffic["pool"])).astype(int)
    return [int(c) for c in np.random.default_rng(seed & SEED_MASK).permutation(counts)]


def frame_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed & SEED_MASK, i]).generate_state(1)[0])


def make_pool(family, cfg_file, traffic, seed: int, device) -> List[Any]:
    """The family's frames of the pool, in order; each has ``index`` and
    ``objects``."""
    return [family.make_frame(cfg_file, traffic, seed, i, n, device)
            for i, n in enumerate(object_counts(traffic, seed))]
