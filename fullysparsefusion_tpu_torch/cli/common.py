"""What the train and test entry points share: the device, the config from
the flags, the model by name at the data's point width, the batches on the
device, the offline masks, device timing and the kernels' launch
counters."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import FSFConfig, nusc_fsf_config, tiny_fsf_config
from ..config_compat import load_fsf_config
from ..data.masks import load_sample_masks, pack_mask_scores
from ..ops import ccl, nms, sparse_conv
from ..utils.containers import GroundTruth, PointBatch
from ..weights import build_fsd, build_fsf, build_two_stage_fsd

MODELS = ("fsd", "fsd2", "fsf")
# the reader's point channels: x, y, z, intensity, ring; the sweep's time
# lag; the no-aug xyz
READER_POINT_WIDTH = 5 + 1 + 3
# the JAX package's training tool's lr multipliers (by parameter-name prefix)
LR_MULT_RULES = {"segmentor.SegmentorCore_0": 0.2, "seg_core": 0.2}


def resolve_device(cpu: bool) -> torch.device:
    """The card unless ``cpu``; raises when no card is there."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --cpu to run on the CPU")
    return torch.device("cuda")


def config_from_args(args) -> FSFConfig:
    """The tiny test config for ``--tiny`` / ``--synthetic``, else the
    reference-style file of ``--config`` at the default capacities, else
    the full nuScenes config."""
    if args.tiny or args.synthetic:
        return tiny_fsf_config()
    if args.config:
        return load_fsf_config(args.config)
    return nusc_fsf_config()


def model_config(cfg: FSFConfig, model: str, point_width: int) -> FSFConfig:
    """``cfg`` with the segmentor's ``point_dim`` set to the point channels
    the model reads of the data's ``point_width`` (FSF drops the last three,
    the no-aug xyz; FSD reads them all), as the JAX package's models take
    their input width from the data."""
    dim = point_width - 3 if model == "fsf" else point_width
    seg = dataclasses.replace(cfg.fsd.segmentor, point_dim=dim)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))


def build_model(name: str, cfg: FSFConfig, seed: int, device):
    """``fsf`` = the fusion detector, ``fsd`` = the LiDAR-only single stage,
    ``fsd2`` = its two-stage form; in eval mode, weights from ``seed``."""
    if name == "fsf":
        return build_fsf(cfg, seed, device)
    if name == "fsd2":
        return build_two_stage_fsd(cfg.fsd, seed, device)
    if name == "fsd":
        return build_fsd(cfg.fsd, seed, device)
    raise ValueError(f"unknown model {name!r}; one of {MODELS}")


def point_batch(batch: Dict[str, np.ndarray], device) -> PointBatch:
    return PointBatch(points=torch.as_tensor(batch["points"], device=device),
                      batch_idx=torch.as_tensor(batch["batch_idx"], device=device),
                      valid=torch.as_tensor(batch["valid"], device=device))


def ground_truth(batch: Dict[str, np.ndarray], device, key: str = "gt_boxes") -> GroundTruth:
    """The collated GT (``key``: ``gt_boxes`` or ``no_aug_gt_boxes``)."""
    return GroundTruth(boxes=torch.as_tensor(batch[key], device=device),
                       labels=torch.as_tensor(batch["gt_labels"], device=device),
                       valid=torch.as_tensor(batch["gt_valid"], device=device))


def load_masks(samples: Sequence[Dict], mask_dir: str, num_classes: int, img_hw,
               downsample: int):
    """The offline masks of ``samples``: (packed planes [B, cams, H/d, W/d,
    cls] uint16, anno [B, A, 9], lidar2img [B, cams, 4, 4] with its pixel
    rows divided by ``downsample``). The camera count comes from the data."""
    masks_l: List[np.ndarray] = []
    annos_l: List[np.ndarray] = []
    l2i_l: List[np.ndarray] = []
    for s in samples:
        if s["lidar2img"] is None:
            raise ValueError(f"sample {s['token']!r}: the info pickle gives no camera matrices")
        l2i = np.asarray(s["lidar2img"], np.float32).copy()
        m, a = load_sample_masks(mask_dir, s["token"], l2i.shape[0], num_classes, img_hw,
                                 downsample=downsample)
        l2i[:, :2] /= downsample
        masks_l.append(m)
        annos_l.append(a)
        l2i_l.append(l2i)
    anno = np.stack(annos_l)
    return pack_mask_scores(np.stack(masks_l), anno), anno, np.stack(l2i_l)


def timed(fn, device):
    """(``fn()``, its ms): CUDA events on the card, the host clock on the
    CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_launches() -> Dict[str, int]:
    """The kernels' launch counters (each wrapper counts its CUDA launches)."""
    return {"gather_conv": sparse_conv.gather_conv.launches, "ccl_roots": ccl.ccl_roots.launches,
            "nms_keep": nms.nms_keep.launches, "dw_per_tap": sparse_conv.dw_per_tap.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}
