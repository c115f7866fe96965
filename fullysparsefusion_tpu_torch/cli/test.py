"""Evaluation / inference entry point (the port's counterpart of the JAX
package's ``tools/test.py``): run detection over a nuScenes info tree on the
card (``--cpu``: on the host), write the detections as JSON and, with
``--eval``, score them (nuScenes mAP / NDS or AV2 AP / CDS). ``--tta`` runs
the scale × rotation × flip grid and fuses the union by rotated NMS;
``--tmpdir`` writes this rank's shard file and merges them on rank 0.
:func:`run` serves a given config; :func:`main` builds the config from
``--tiny`` / ``--synthetic`` (the tiny test config), else from a
reference-style config file (``--config``), else takes the full nuScenes
config. ``--vis-dir`` writes BEV (and, for FSF, camera-mask) PNGs of the
first ``--vis-max`` samples (``utils/visualize.py``; needs matplotlib).

    python -m fullysparsefusion_tpu_torch.cli.test --model fsf --checkpoint CKPT \
        --info-pkl data/nuscenes_infos_val.pkl --data-root data/nuscenes \
        --mask-dir data/masks --out results/dets.json --eval
    python -m fullysparsefusion_tpu_torch.cli.test --synthetic --cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import synthetic as S
from ..config import FSFConfig
from ..data.nuscenes import NuScenesReader
from ..data.pipelines import collate_scene
from ..data.tta import fuse_union, run_tta, tta_grid
from ..eval.av2_detection import evaluate_av2
from ..eval.detection import DetectionRecord, default_attributes, evaluate_detections
from ..models.camera import CameraData
from ..parallel.eval import merge_shard_results, shard_indices, write_shard_results
from ..train.checkpoint import load_model_vars
from ..utils.visualize import dump_bev, dump_camera_assignment
from .common import (MODELS, READER_POINT_WIDTH, build_model, config_from_args, kernel_launches,
                     launches_since, load_masks, model_config, point_batch, resolve_device, timed)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", help="reference-style config file (config_compat)")
    p.add_argument("--checkpoint", help="a training checkpoint (cli.train's step_*.pt)")
    p.add_argument("--info-pkl")
    p.add_argument("--data-root")
    p.add_argument("--out", default="results/detections.json")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--eval", action="store_true", help="run the built-in evaluator")
    p.add_argument("--eval-protocol", default="nuscenes", choices=["nuscenes", "av2"],
                   help="nuScenes mAP/NDS or AV2 AP/CDS")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--model", default="fsd", choices=MODELS)
    p.add_argument("--tiny", action="store_true", help="the tiny test config (CI)")
    p.add_argument("--mask-dir", help="pre-computed 2D instance masks (FSF)")
    p.add_argument("--mask-downsample", type=int, default=2)
    p.add_argument("--img-h", type=int, default=900)
    p.add_argument("--img-w", type=int, default=1600)
    p.add_argument("--tta", action="store_true",
                   help="flip/rotate/scale TTA fused with rotated NMS")
    p.add_argument("--tta-rotations", default="0", help="comma-separated yaw rotations (rad)")
    p.add_argument("--tta-scales", default="1.0")
    p.add_argument("--tta-no-flip", action="store_true")
    p.add_argument("--tmpdir", help="shard-file collect dir for multi-process eval")
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    p.add_argument("--vis-dir", help="per-sample BEV (+ camera) debug PNGs (needs matplotlib)")
    p.add_argument("--vis-max", type=int, default=8, help="samples to visualize")
    return p.parse_args(argv)


def _synthetic(cfg: FSFConfig, args, device) -> Dict:
    """The JAX tool's smoke inference: the LiDAR-only model on the test scene."""
    model = build_model("fsd2" if args.model == "fsd2" else "fsd", cfg, 0, device)
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    with torch.inference_mode():
        res = model.get_bboxes(model(S.to_point_batch(sc, device), 2), 2)
    out = {"mode": "synthetic", "detections": int(res.valid.sum())}
    print(json.dumps(out))
    return out


def run(cfg: FSFConfig, args) -> Dict:
    """Serve ``cfg`` over the tree ``args`` name. Returns the ``model``, the
    JSON ``results`` (token, boxes, scores, labels per sample), a record per
    sample of this rank (``samples``: the host ms of ``read`` (the reader),
    ``collate``, ``masks`` (PNG decode and pack) and ``input`` (conversion
    and copy to the device), the device ms ``gpu_ms`` of forward +
    ``get_bboxes`` (summed over the TTA variants), the ``detections``, the
    TTA ``union``'s size and the kernels' ``launches``) and, with
    ``--eval``, the ``metrics``."""
    device = resolve_device(args.cpu)
    if args.synthetic:
        return _synthetic(cfg, args, device)
    if not (args.info_pkl and args.data_root):
        raise ValueError("--info-pkl and --data-root are required (or use --synthetic)")
    use_fsf = args.model == "fsf"
    if use_fsf and not args.mask_dir:
        raise ValueError("--mask-dir is required for --model fsf")
    fsd_cfg = cfg.fsd
    reader = NuScenesReader(info_path=args.info_pkl, data_root=args.data_root,
                            class_names=fsd_cfg.class_names, training=False, with_cbgs=False)
    model = build_model(args.model, model_config(cfg, args.model, READER_POINT_WIDTH), 0, device)
    if args.checkpoint:
        load_model_vars(args.checkpoint, model)

    def collate(s):
        return collate_scene([s], cfg.caps.points, cfg.caps.max_gt)

    def infer(batch, cam):
        """(boxes, scores, labels) of the valid detections, device ms of
        forward + get_bboxes."""
        pb = point_batch(batch, device)

        def forward():
            with torch.inference_mode():
                out = model(pb, cam, 1) if use_fsf else model(pb, 1)
                return model.get_bboxes(out, 1)
        res, ms = timed(forward, device)
        res = [t[0].cpu().numpy() for t in res]
        v = res[3]
        return (res[0][v], res[1][v], res[2][v]), ms

    variants = None
    if args.tta:
        variants = tta_grid(scales=[float(x) for x in args.tta_scales.split(",")],
                            rotations=[float(x) for x in args.tta_rotations.split(",")],
                            flip_horizontal=not args.tta_no_flip,
                            flip_vertical=not args.tta_no_flip)

    def infer_sample(s, batch, cam, rec):
        if variants is None:
            dets, rec["gpu_ms"] = infer(batch, cam)
            return dets
        # re-collate per variant: TTA transforms the live channels only (the
        # saved no-aug tail keeps the camera projection valid)
        live, tail = s["points"][:, :-3], s["points"][:, -3:]
        rec["gpu_ms"] = 0.0

        def one(aug_live):
            dets, ms = infer(collate(dict(s, points=np.concatenate([aug_live, tail], 1))), cam)
            rec["gpu_ms"] += ms
            return dets

        boxes, scores, labels = run_tta(live, variants, one)
        rec["union"] = len(boxes)
        if not len(boxes):
            return boxes, scores, labels
        res = fuse_union(boxes, scores, labels, fsd_cfg.num_classes, fsd_cfg.head.nms_thr,
                         fsd_cfg.head.score_thr, fsd_cfg.head.max_num, device)
        v = res.valid.cpu().numpy()
        return res.boxes.cpu().numpy()[v], res.scores.cpu().numpy()[v], res.labels.cpu().numpy()[v]

    def visualize(s, batch, planes, boxes, scores):
        dump_bev(os.path.join(args.vis_dir, f"{s['token']}_bev.png"), batch["points"][:, :3],
                 point_valid=batch["valid"], gt_boxes=s.get("gt_boxes"), pred_boxes=boxes,
                 pred_scores=scores, title=str(s["token"]))
        if planes is not None:
            dump_camera_assignment(os.path.join(args.vis_dir, f"{s['token']}_cam0.png"),
                                   planes[0][0, 0], title=f"{s['token']} cam0 masks")

    records, results, per_sample = [], [], []
    n_total = min(len(reader), args.max_samples) if args.max_samples else len(reader)
    own = shard_indices(n_total)
    t_all = time.time()
    for i in own.tolist():
        before = kernel_launches()
        read0 = reader.host_ms["read"]
        s = reader.sample(i, augment=False)
        rec = {"token": s["token"], "read_ms": reader.host_ms["read"] - read0}
        t0 = time.perf_counter()
        batch = collate(s)
        rec["collate_ms"] = (time.perf_counter() - t0) * 1e3
        cam = planes = None
        if use_fsf:
            t0 = time.perf_counter()
            planes = load_masks([s], args.mask_dir, fsd_cfg.num_classes, (args.img_h, args.img_w),
                                args.mask_downsample)
            rec["mask_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            cam = CameraData.build(*planes, device=device)
            rec["input_ms"] = (time.perf_counter() - t0) * 1e3
        boxes, scores, labels = infer_sample(s, batch, cam, rec)
        if args.vis_dir and len(per_sample) < args.vis_max:
            visualize(s, batch, planes, boxes, scores)
        rec["detections"] = len(boxes)
        rec["launches"] = launches_since(before)
        per_sample.append(rec)
        results.append(dict(token=s["token"], boxes=boxes.tolist(), scores=scores.tolist(),
                            labels=labels.tolist()))
        if args.eval:
            # the mmdet3d velocity heuristic gives the prediction attributes;
            # AAE joins NDS only when the pickles carry GT attribute ids
            gt_attrs = s.get("gt_attrs")
            records.append(DetectionRecord(
                boxes=boxes, scores=scores, labels=labels, gt_boxes=s["gt_boxes"],
                gt_labels=s["gt_labels"],
                attrs=(default_attributes(boxes, labels, fsd_cfg.class_names)
                       if gt_attrs is not None else None),
                gt_attrs=np.asarray(gt_attrs, np.int32) if gt_attrs is not None else None))
    out = dict(model=model, samples=per_sample,
               sec_per_sample=(time.time() - t_all) / max(len(own), 1))
    if args.tmpdir:
        write_shard_results(results, args.tmpdir)
        if dist.is_initialized():
            dist.barrier()  # every rank's shard file is written
            if dist.get_rank() != 0:
                return dict(out, results=results)
        results = merge_shard_results(args.tmpdir)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    out.update(results=results, out=args.out)
    if args.eval:
        evaluate = evaluate_av2 if args.eval_protocol == "av2" else evaluate_detections
        out["metrics"] = evaluate(records, fsd_cfg.num_classes, fsd_cfg.class_names)
    return out


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    out = run(config_from_args(args), args)
    if args.synthetic or "out" not in out:
        return
    print(json.dumps({"samples": len(out["results"]),
                      "sec_per_sample": round(out["sec_per_sample"], 3), "out": out["out"]}))
    if "metrics" in out:
        print(json.dumps(out["metrics"], indent=2))


if __name__ == "__main__":
    main()
