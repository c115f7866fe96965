"""The one generator of every traffic mix: a pool of frames made from the
seed by the parameters of ``benchmark/traffic/<name>.json``.

Every seed gets the same set of object counts (``objects`` spread evenly
over ``pool`` frames) in its own order, and each frame its own scene from
``(seed, frame)``: the seed changes which points and boxes, not how many
objects. Points stay on the host when ``points_on`` is ``host`` (a LiDAR
sensor delivers them frame by frame) and go to the device otherwise;
the cameras' mask planes are painted on the device.

The harness runs one frame at a time at batch 1, in a closed loop, with the
masks on the device; a mix file holds only the keys of :data:`KEYS`, and
any other key is refused rather than left unread."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from . import scenes

SEED_MASK = (1 << 64) - 1

# the keys a mix file of each mode holds; "note" is free text
KEYS = {
    "serve": {"mode", "pool", "objects", "points_on", "traced_units", "judged_units", "note"},
    "train": {"mode", "pool", "objects", "points_on", "checked_steps", "traced_units", "note"},
}
POINTS_ON = ("host", "device")


def check(traffic: Mapping[str, Any]) -> Mapping[str, Any]:
    """``traffic`` if the harness can run it as written; else ValueError."""
    mode = traffic.get("mode")
    if mode not in KEYS:
        raise ValueError(f"traffic mode {mode!r}: the harness runs {sorted(KEYS)}")
    unknown = set(traffic) - KEYS[mode]
    missing = KEYS[mode] - {"note"} - set(traffic)
    if unknown or missing:
        raise ValueError(f"traffic ({mode}): keys the harness does not read {sorted(unknown)}, "
                         f"keys it needs {sorted(missing)}")
    if traffic["points_on"] not in POINTS_ON:
        raise ValueError(f"traffic points_on {traffic['points_on']!r}: one of {POINTS_ON}")
    return traffic


@dataclass
class Frame:
    index: int                 # position in the pool
    objects: int               # GT boxes placed in the scene
    points: Any                # [N, D + 3] f32 with the no-aug xyz, host or device
    batch_idx: Any             # [N] i32
    valid: Any                 # [N] bool
    gt: Dict[str, torch.Tensor]   # boxes [1, M, 10], labels [1, M], valid [1, M] on the device
    cam: Dict[str, Any]        # masks, anno, lidar2img on the device; img_h, img_w


def object_counts(traffic: Mapping[str, Any], seed: int) -> List[int]:
    lo, hi = traffic["objects"]
    counts = np.round(np.linspace(lo, hi, traffic["pool"])).astype(int)
    return [int(c) for c in np.random.default_rng(seed & SEED_MASK).permutation(counts)]


def frame_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed & SEED_MASK, i]).generate_state(1)[0])


def make_frame(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any], seed: int, i: int,
               objects: int, device) -> Frame:
    model = cfg_file["model"]
    caps = model["fsd"]["caps"]
    sc_cfg = dict(cfg_file["scene"])
    if sc_cfg.pop("generator") != "lidar_scene":
        raise ValueError("unknown scene generator")
    sc = scenes.make_lidar_scene_arrays(
        seed=frame_seed(seed, i), n_cap=caps["points"], max_gt=caps["max_gt"], n_boxes=objects,
        num_classes=model["fsd"]["segmentor"]["num_classes"], **sc_cfg)
    pts = scenes.with_noaug_channels_array(sc["points"])
    cam = scenes.camera_tensors(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], device,
                                batch_size=1, num_classes=model["fsd"]["segmentor"]["num_classes"],
                                **cfg_file["cameras"])
    on_host = traffic["points_on"] == "host"

    def put(a):
        return a if on_host else torch.as_tensor(a, device=device)

    gt = dict(boxes=torch.as_tensor(sc["gt_boxes"], device=device),
              labels=torch.as_tensor(sc["gt_labels"], device=device),
              valid=torch.as_tensor(sc["gt_valid"], device=device))
    return Frame(i, objects, put(pts), put(sc["batch_idx"]), put(sc["valid"]), gt, cam)


def make_pool(cfg_file, traffic, seed: int, device) -> List[Frame]:
    return [make_frame(cfg_file, traffic, seed, i, n, device)
            for i, n in enumerate(object_counts(traffic, seed))]
