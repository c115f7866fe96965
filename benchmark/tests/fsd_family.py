"""A second model family for the benchmark's tests: the program's LiDAR-only
``models.fsd.SingleStageFSD`` against the reference's frozen copy
(``benchmark/reference/models/fsd.py``), on LiDAR scenes with no cameras.
It serves and does not train.

``test_bench_data_driven.py`` copies this file to
``benchmark/families/fsd.py`` of a checkout, beside a configuration, a
traffic mix and manifest entries, to show that a family joins by files
alone."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping

import torch
from torch import nn

from benchmark.harness import configs, costs, judge, scenes, traffic as traffic_mod, weights

MODES = {"serve": ()}


def check_cell(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any]) -> None:
    """Every serving mix runs."""


def reference_model(cfg_file: Mapping[str, Any], device):
    from benchmark.reference.config import FSDConfig
    from benchmark.reference.models.fsd import SingleStageFSD

    with torch.device(device):
        return SingleStageFSD(configs.dataclass_from_dict(FSDConfig, cfg_file["model"]))


def program_model(cfg_file: Mapping[str, Any], state, device):
    from fullysparsefusion_tpu_torch.config import FSDConfig
    from fullysparsefusion_tpu_torch.models.fsd import SingleStageFSD

    with torch.device(device):
        model = SingleStageFSD(configs.dataclass_from_dict(FSDConfig, cfg_file["model"]))
    model.load_state_dict(state, strict=True)
    return model.eval()


def _layout(model: nn.Module):
    """Dense and sparse-conv weights truncated normal, biases 0, norm scales
    1 with statistics 0 / 1."""
    from benchmark.reference.models.layers import LayerNorm, MaskedBatchNorm
    from benchmark.reference.models.sparse_unet import _ConvBlock

    normal, zeros, ones = [], [], []
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, nn.Linear):
            normal.append((p + "weight", m.weight.shape[1]))
            if m.bias is not None:
                zeros.append(p + "bias")
        elif isinstance(m, _ConvBlock):
            normal.append((p + "w", m.w.shape[0] * m.w.shape[1]))
        elif isinstance(m, (LayerNorm, MaskedBatchNorm)):
            ones.append(p + "weight")
            zeros.append(p + "bias")
            if isinstance(m, MaskedBatchNorm):
                zeros.append(p + "running_mean")
                ones.append(p + "running_var")
    return normal, zeros, ones


def make_state(cfg_file: Mapping[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make_state(reference_model(cfg_file, "meta"), seed, device, _layout)


@dataclass
class Frame:
    index: int
    objects: int
    points: Any                # [N, D] f32, host or device
    batch_idx: Any
    valid: Any


def make_frame(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any], seed: int, i: int,
               objects: int, device) -> Frame:
    model = cfg_file["model"]
    sc = scenes.make_lidar_scene_arrays(
        seed=traffic_mod.frame_seed(seed, i), n_cap=model["caps"]["points"],
        max_gt=model["caps"]["max_gt"], n_boxes=objects,
        num_classes=model["segmentor"]["num_classes"], **cfg_file["scene"])

    def put(a):
        return a if traffic["points_on"] == "host" else torch.as_tensor(a, device=device)

    return Frame(i, objects, put(sc["points"]), put(sc["batch_idx"]), put(sc["valid"]))


def _point_batch(frame: Frame, device, point_cls):
    return point_cls(points=torch.as_tensor(frame.points, device=device),
                     batch_idx=torch.as_tensor(frame.batch_idx, device=device),
                     valid=torch.as_tensor(frame.valid, device=device))


def serve_one(model, frame: Frame, device):
    from fullysparsefusion_tpu_torch.utils.containers import PointBatch

    pb = _point_batch(frame, device, PointBatch)
    with torch.inference_mode():
        det = model.get_bboxes(model(pb, 1), 1)
    return {k: getattr(det, k)[0].cpu() for k in ("boxes", "scores", "labels", "valid")}


def failed(answer) -> bool:
    return not all(torch.isfinite(answer[k]).all() for k in ("boxes", "scores"))


def serve_spans(spans, model) -> None:
    spans.module("segmentor", model.segmentor)


def reference_answer(ref, frame: Frame, device):
    from benchmark.reference.utils.containers import PointBatch

    pb = _point_batch(frame, device, PointBatch)
    with torch.inference_mode():
        return judge.as_dict(ref.get_bboxes(ref(pb, 1), 1))


def served_numbers(want, got) -> Dict[str, float]:
    return {"moved_share": judge.moved_share(want, got)}


def work_count(ref, training: bool = False) -> costs.WorkCount:
    return costs.WorkCount(ref, training=training)
