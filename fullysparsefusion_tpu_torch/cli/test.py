"""Evaluation / inference entry point (the port's counterpart of the JAX
package's ``tools/test.py``): run detection over a nuScenes info tree on the
card (``--cpu``: on the host), write the detections as JSON and, with
``--eval``, score them (nuScenes mAP / NDS). ``--eval-protocol av2`` serves
an Argoverse 2 tree instead: the info pickle of ``cli/prepare_av2.py``
(``--fusion`` for FSF's camera entries) read by ``data/av2.AV2Reader``, the
single-channel masks of ``--mask-dir`` (``cli/common.load_av2_masks``),
``--img-h`` / ``--img-w`` by default the ring cameras' size in the pickle,
the detections written as an AV2 feather (``AV2Reader.format_results``)
and scored by AV2 AP / CDS. ``--tta`` runs the scale × rotation × flip
grid and fuses the union by rotated NMS. ``--multihost`` makes this process
one rank of the group that ``python -m torch.distributed.run`` starts on
every node (``env://``; ``tools/launch_test_torch.sh``): each rank serves
its ``idx % world`` shard of the samples, and rank 0 alone writes ``--out``
and the metrics, over every rank's samples in dataset order. The results
come together through ``--tmpdir`` (each rank writes its
``results_rank{r:03d}.json``, the JAX package's shard file, and rank 0
merges them after a barrier) or, without it, through an all-gather.
:func:`run` serves a given config; :func:`main` builds the config from
``--tiny`` / ``--synthetic`` (the tiny test config), else from a
reference-style config file (``--config``), else takes the full nuScenes
config. ``--vis-dir`` writes BEV (and, for FSF, camera-mask) PNGs of the
first ``--vis-max`` samples (``utils/visualize.py``; needs matplotlib).

    python -m fullysparsefusion_tpu_torch.cli.test --model fsf --checkpoint CKPT \
        --info-pkl data/nuscenes_infos_val.pkl --data-root data/nuscenes \
        --mask-dir data/masks --out results/dets.json --eval
    python -m fullysparsefusion_tpu_torch.cli.test --model fsf --eval-protocol av2 \
        --info-pkl data/av2/av2_infos_val.pkl --data-root data/av2 \
        --mask-dir data/av2/masks --out results/dets.feather --eval
    python -m fullysparsefusion_tpu_torch.cli.test --synthetic --cpu
    # every card of this node, shard files in a directory all ranks share
    tools/launch_test_torch.sh CONFIG CKPT INFO_PKL DATA_ROOT --model fsf \
        --mask-dir data/masks --tmpdir work_dirs/shards --out results/dets.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import synthetic as S
from ..config import FSFConfig
from ..data.av2 import AV2Reader
from ..data.nuscenes import NuScenesReader
from ..data.pipelines import collate_scene
from ..data.tta import fuse_union, run_tta, tta_grid
from ..eval.av2_detection import evaluate_av2
from ..eval.detection import DetectionRecord, default_attributes, evaluate_detections
from ..models.camera import CameraData
from ..parallel.eval import (allgather_in_dataset_order, allgather_results, merge_shard_results,
                             shard_indices, write_shard_results)
from ..parallel.launch import env_group
from ..train.checkpoint import load_model_vars
from ..utils.visualize import dump_bev, dump_camera_assignment
from .common import (AV2_POINT_WIDTH, MODELS, READER_POINT_WIDTH, build_model, config_from_args,
                     kernel_launches, launches_since, load_av2_masks, load_masks, model_config,
                     point_batch, resolve_device, timed)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", help="reference-style config file (config_compat)")
    p.add_argument("--checkpoint", help="a training checkpoint (cli.train's step_*.pt)")
    p.add_argument("--info-pkl")
    p.add_argument("--data-root")
    p.add_argument("--out", help="results/detections.json (AV2: results/detections.feather)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--eval", action="store_true", help="run the built-in evaluator")
    p.add_argument("--eval-protocol", default="nuscenes", choices=["nuscenes", "av2"],
                   help="a nuScenes tree scored by mAP/NDS, or an AV2 tree by AP/CDS")
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--model", default="fsd", choices=MODELS)
    p.add_argument("--tiny", action="store_true", help="the tiny test config (CI)")
    p.add_argument("--mask-dir", help="pre-computed 2D instance masks (FSF)")
    p.add_argument("--mask-downsample", type=int, default=2)
    p.add_argument("--img-h", type=int, help="mask grid height (900; AV2: the ring cameras')")
    p.add_argument("--img-w", type=int, help="mask grid width (1600; AV2: the ring cameras')")
    p.add_argument("--tta", action="store_true",
                   help="flip/rotate/scale TTA fused with rotated NMS")
    p.add_argument("--tta-rotations", default="0", help="comma-separated yaw rotations (rad)")
    p.add_argument("--tta-scales", default="1.0")
    p.add_argument("--tta-no-flip", action="store_true")
    p.add_argument("--tmpdir", help="shard-file collect dir for multi-process eval")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of the group torch.distributed.run starts on every node "
                        "(env://; tools/launch_test_torch.sh)")
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


def av2_image_size(infos) -> Tuple[int, int]:
    """The (h, w) that every frame's ring cameras but the front one share
    (``cams`` of ``prepare_av2 --fusion``); raises when they differ or the
    pickle has no camera entries."""
    sizes = set()
    for info in infos:
        if "cams" not in info:
            raise ValueError(f"frame {info['log_id']}_{info['timestamp_ns']} has no camera "
                             "entries (prepare it with prepare_av2 --fusion)")
        sizes |= {(c["height_px"], c["width_px"]) for name, c in info["cams"].items()
                  if name != info["cam_names"][0]}
    if len(sizes) != 1:
        raise ValueError(f"the ring cameras' sizes differ: {sorted(sizes)}; pass --img-h/--img-w")
    return sizes.pop()


def run(cfg: FSFConfig, args, model=None) -> Dict:
    """Serve ``cfg`` over the tree ``args`` name (``model``: an already
    built model to serve instead of one from seed 0); with ``--multihost``
    as this process's rank of the ``torch.distributed.run`` group, joined
    for the call. Returns the ``model``,
    the ``results`` (token, boxes, scores, labels per sample; AV2 adds
    ``log_id`` and ``timestamp_ns``), a record per sample of this rank
    (``samples``: the host ms of ``read`` (the reader), ``collate``,
    ``masks`` (PNG decode and pack) and ``input`` (conversion and copy to
    the device), the device ms ``gpu_ms`` of forward + ``get_bboxes``
    (summed over the TTA variants), the ``detections``, the TTA
    ``union``'s size and the kernels' ``launches``), the kernels'
    ``launches`` over every rank's samples and, with ``--eval``, the
    ``metrics``. Under a process group, rank 0 returns every rank's
    ``results`` and alone writes ``--out`` and scores them; the other ranks
    return their own (``--tmpdir``) or every rank's results, nothing
    written."""
    device = resolve_device(args.cpu)
    if args.synthetic:
        return _synthetic(cfg, args, device)
    if args.multihost:
        with env_group(args.cpu):
            return _serve(cfg, args, model, device)
    return _serve(cfg, args, model, device)


def _serve(cfg: FSFConfig, args, model, device) -> Dict:
    if not (args.info_pkl and args.data_root):
        raise ValueError("--info-pkl and --data-root are required (or use --synthetic)")
    use_fsf = args.model == "fsf"
    if use_fsf and not args.mask_dir:
        raise ValueError("--mask-dir is required for --model fsf")
    fsd_cfg = cfg.fsd
    av2 = args.eval_protocol == "av2"
    if av2:
        reader = AV2Reader(info_path=args.info_pkl, data_root=args.data_root,
                           class_names=fsd_cfg.class_names, training=False,
                           point_cloud_range=fsd_cfg.segmentor.point_cloud_range)
        point_width = AV2_POINT_WIDTH
    else:
        reader = NuScenesReader(info_path=args.info_pkl, data_root=args.data_root,
                                class_names=fsd_cfg.class_names, training=False, with_cbgs=False)
        point_width = READER_POINT_WIDTH
    img_hw = (args.img_h, args.img_w)
    if use_fsf and None in img_hw:
        default = av2_image_size(reader.infos) if av2 else (900, 1600)
        img_hw = (args.img_h or default[0], args.img_w or default[1])
    if model is None:
        model = build_model(args.model, model_config(cfg, args.model, point_width), 0, device)
    if args.checkpoint:
        load_model_vars(args.checkpoint, model)

    def read(i):
        """(sample ``i`` in eval form with its ``token``, the reader's ms)."""
        if not av2:
            read0 = reader.host_ms["read"]
            s = reader.sample(i, augment=False)
            return s, reader.host_ms["read"] - read0
        t0 = time.perf_counter()
        s = reader.sample(i, augment=False)
        ms = (time.perf_counter() - t0) * 1e3
        return dict(s, token=f"{s['log_id']}_{s['timestamp_ns']}"), ms

    def masks(i, s):
        if not av2:
            return load_masks([s], args.mask_dir, fsd_cfg.num_classes, img_hw,
                              args.mask_downsample)
        info = reader.infos[i]
        front = info["cams"][info["cam_names"][0]]
        return load_av2_masks([s], [(front["height_px"], front["width_px"])], args.mask_dir,
                              fsd_cfg.num_classes, img_hw, args.mask_downsample)

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
        s, read_ms = read(i)
        rec = {"token": s["token"], "read_ms": read_ms}
        t0 = time.perf_counter()
        batch = collate(s)
        rec["collate_ms"] = (time.perf_counter() - t0) * 1e3
        cam = planes = None
        if use_fsf:
            t0 = time.perf_counter()
            planes = masks(i, s)
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
        if av2:
            results[-1].update(log_id=s["log_id"], timestamp_ns=int(s["timestamp_ns"]))
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
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = {k: sum(r["launches"][k] for r in per_sample) for k in kernel_launches()}
    parts = allgather_results([mine])
    out["launches"] = {k: sum(p[k] for p in parts) for k in mine}   # over every rank's samples
    if args.tmpdir:
        write_shard_results(results, args.tmpdir)
        if dist.is_initialized():
            dist.barrier()  # every rank's shard file is written
        if rank == 0:
            results = merge_shard_results(args.tmpdir)
    else:
        results = allgather_in_dataset_order(results)
    if args.eval:
        records = allgather_in_dataset_order(records)
    if rank != 0:
        return dict(out, results=results)
    out_path = args.out or f"results/detections.{'feather' if av2 else 'json'}"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    if av2:
        reader.format_results([av2_detections(r) for r in results], out_path)
    else:
        with open(out_path, "w") as f:
            json.dump(results, f)
    out.update(results=results, out=out_path)
    if args.eval:
        evaluate = evaluate_av2 if av2 else evaluate_detections
        out["metrics"] = evaluate(records, fsd_cfg.num_classes, fsd_cfg.class_names)
    return out


def av2_detections(result: Dict) -> tuple:
    """One result of :func:`run` as ``AV2Reader.format_results`` takes it:
    (boxes [N, 7] f32, scores f32, labels, log id, timestamp), the f32
    values the model gave."""
    boxes = np.asarray(result["boxes"], np.float32).reshape(len(result["scores"]), -1) \
        if result["scores"] else np.zeros((0, 7), np.float32)
    return (boxes, np.asarray(result["scores"], np.float32), np.asarray(result["labels"]),
            result["log_id"], result["timestamp_ns"])


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    out = run(config_from_args(args), args)
    if args.synthetic or "out" not in out:
        return
    print(json.dumps({"samples": len(out["results"]),
                      "sec_per_sample": round(out["sec_per_sample"], 3), "out": out["out"],
                      "launches": out["launches"]}))
    if "metrics" in out:
        print(json.dumps(out["metrics"], indent=2))


if __name__ == "__main__":
    main()
