"""The two sides of a run: the program under test (``fullysparsefusion_tpu_torch``)
and the reference (``benchmark/reference``), built from one configuration
file and one weight state, and fed the same frames in their own containers."""
from __future__ import annotations

from typing import Any, Mapping

import torch

from . import configs
from .traffic import Frame


def reference_model(cfg_file: Mapping[str, Any], device):
    from ..reference.models.fsf import FSF

    with torch.device(device):
        return FSF(configs.reference_config(cfg_file))


def program_model(cfg_file: Mapping[str, Any], state, device):
    """The program's ``FSF`` on ``device`` with ``state`` loaded strictly, in
    eval mode."""
    from fullysparsefusion_tpu_torch.models.fsf import FSF

    with torch.device(device):
        model = FSF(configs.program_config(cfg_file))
    model.load_state_dict(state, strict=True)
    return model.eval()


def _inputs(frame: Frame, device, point_cls, cam_cls, gt_cls):
    pts = torch.as_tensor(frame.points, device=device)
    pb = point_cls(points=pts, batch_idx=torch.as_tensor(frame.batch_idx, device=device),
                   valid=torch.as_tensor(frame.valid, device=device))
    c = frame.cam
    cam = cam_cls(masks=c["masks"], anno=c["anno"], lidar2img=c["lidar2img"],
                  img_h=c["img_h"], img_w=c["img_w"])
    gt = gt_cls(boxes=frame.gt["boxes"], labels=frame.gt["labels"], valid=frame.gt["valid"])
    return pb, cam, gt


def program_inputs(frame: Frame, device):
    """(PointBatch, CameraData, GroundTruth) of the program; points that
    live on the host are copied to ``device`` here, as a frame arrives."""
    from fullysparsefusion_tpu_torch.utils.containers import CameraData, GroundTruth, PointBatch

    return _inputs(frame, device, PointBatch, CameraData, GroundTruth)


def reference_inputs(frame: Frame, device):
    from ..reference.utils.containers import CameraData, GroundTruth, PointBatch

    return _inputs(frame, device, PointBatch, CameraData, GroundTruth)
