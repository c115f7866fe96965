"""Training entry point (the port's counterpart of the JAX package's
``tools/train.py``).

One process trains on the card (``--cpu``: on the host); with ``--ranks N``
it spawns N processes joined by ``torch.distributed`` (NCCL on the cards,
gloo with ``--cpu``), each on its stride of the dataset, that step through
``parallel.train.sharded_train_step``. The loop gates GT paste, the
detection losses and the foreground-threshold buffer by ``RuntimeSchedule``,
appends ``train_log.jsonl`` records and writes ``step_{step:08d}.pt``
checkpoints into ``--work-dir``. :func:`run` is the loop for a given config;
:func:`main` builds the config from ``--tiny`` / ``--synthetic`` (the tiny
test config), else from a reference-style config file (``--config``,
through ``config_compat.load_fsf_config``), else takes the full nuScenes
config. ``--vis-dir`` writes a BEV PNG of the batch every
``--vis-interval`` steps (``utils/visualize.py``; needs matplotlib).

    # full-fusion training on a nuScenes info tree, masks from the mask tool
    python -m fullysparsefusion_tpu_torch.cli.train --model fsf \
        --info-pkl data/nuscenes_infos_train.pkl --data-root data/nuscenes \
        --mask-dir data/masks --gt-db data/gt_db.pkl --work-dir work_dirs/fsf
    # the model a reference config file describes, warm-started from a
    # converted FSD pretrain (cli.convert_checkpoint)
    python -m fullysparsefusion_tpu_torch.cli.train --model fsf \
        --config FSF_nuScenes_config.py --init-from vars.pkl ...
    # smoke run on the synthetic scene, on the CPU
    python -m fullysparsefusion_tpu_torch.cli.train --synthetic --tiny --cpu --max-steps 2
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from .. import synthetic as S
from ..config import FSFConfig
from ..data.gt_sampling import GTPasteSampler
from ..data.nuscenes import NuScenesReader
from ..models.camera import CameraData
from ..parallel.launch import spawn_ranks
from ..parallel.train import Batch, make_optimizer, sharded_train_step
from ..train import checkpoint as ckpt
from ..train.hooks import RuntimeSchedule
from ..utils.visualize import dump_bev
from .common import (LR_MULT_RULES, MODELS, READER_POINT_WIDTH, build_model, config_from_args,
                     ground_truth, kernel_launches, launches_since, load_masks, model_config,
                     point_batch, resolve_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", help="reference-style config file (config_compat)")
    p.add_argument("--info-pkl")
    p.add_argument("--data-root")
    p.add_argument("--work-dir", default="work_dirs/default")
    p.add_argument("--max-steps", type=int, default=0, help="0 = --epochs over the dataset")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=0, help="0 = one per rank")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true", help="synthetic-scene smoke run")
    p.add_argument("--tiny", action="store_true", help="the tiny test config (CI)")
    p.add_argument("--model", default="fsd", choices=MODELS,
                   help="fsd = LiDAR-only; fsd2 = two-stage; fsf = full fusion (needs --mask-dir)")
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--ckpt-interval", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain-steps", type=int, default=0,
                   help="segmentor-only warmup: detection losses gated off")
    p.add_argument("--threshold-buffer", type=float, default=0.0,
                   help="initial fg-threshold buffer, decays over the warmup tail")
    p.add_argument("--init-from", help="pickle of the JAX package's variables to warm-start from")
    p.add_argument("--mask-dir", help="pre-computed 2D instance masks (FSF)")
    p.add_argument("--mask-downsample", type=int, default=2)
    p.add_argument("--img-h", type=int, default=900)
    p.add_argument("--img-w", type=int, default=1600)
    p.add_argument("--gt-db", help="GT database pickle (cli.create_gt_database)")
    p.add_argument("--paste-max", default="2",
                   help="per-class paste budget: single int or 'cls:k,cls:k'")
    p.add_argument("--disable-aug-step", type=int, default=-1,
                   help="turn GT-paste off from this step (DisableAugmentationHook)")
    p.add_argument("--ranks", type=int, default=1,
                   help="data-parallel processes (one card each; gloo with --cpu)")
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    p.add_argument("--vis-dir", help="BEV debug PNGs of the training batches (needs matplotlib)")
    p.add_argument("--vis-interval", type=int, default=200)
    return p.parse_args(argv)


def _parse_paste_max(spec: str, num_classes: int) -> Dict[int, int]:
    if ":" in spec:
        return {int(k): int(v) for k, v in (part.split(":") for part in spec.split(","))}
    return {c: int(spec) for c in range(num_classes)}


def _synthetic_batches(cfg: FSFConfig, use_fsf: bool, device):
    """The JAX tool's synthetic stream: the test scene of seed 0, 1, ...
    (batch 2), with its cameras for FSF."""
    i = 0
    while True:
        sc = S.make_scene_arrays(seed=i, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
        gt = S.to_ground_truth(sc, device)
        if use_fsf:
            cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                       num_cams=cfg.num_cams, num_classes=cfg.num_classes)
            yield Batch(*S.fsf_inputs(sc, cam, device), gt, gt), {}
        else:
            yield Batch(S.to_point_batch(sc, device), None, gt, None), {}
        i += 1


def _reader_batches(reader: NuScenesReader, cfg: FSFConfig, args, use_fsf: bool,
                    batch_size: int, device):
    """Batches of the reader, epoch after epoch, each with its host ms:
    ``read``, ``paste``, ``collate`` (the reader's), ``masks`` (PNG decode
    and pack) and ``input`` (conversion and copy to the device)."""
    while True:
        epoch = reader.batches(batch_size, cfg.caps.points, cfg.caps.max_gt)
        while True:
            before = dict(reader.host_ms)
            try:
                batch, samples = next(epoch)
            except StopIteration:
                break
            host = {k: reader.host_ms[k] - before[k] for k in before}
            cam = no_aug = None
            if use_fsf:
                t0 = time.perf_counter()
                planes = load_masks(samples, args.mask_dir, cfg.num_classes,
                                    (args.img_h, args.img_w), args.mask_downsample)
                host["masks"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            pb, gt = point_batch(batch, device), ground_truth(batch, device)
            if use_fsf:
                cam = CameraData.build(*planes, device=device)
                no_aug = ground_truth(batch, device, "no_aug_gt_boxes")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            host["input"] = (time.perf_counter() - t0) * 1e3
            yield Batch(pb, cam, gt, no_aug), host


def _dump_batch(vis_dir: str, step: int, batch: Batch, paste: bool) -> None:
    """The batch's first sample in bird's-eye view: points and GT boxes."""
    pb, gt = batch.pb, batch.gt
    sel = (pb.batch_idx == 0).cpu().numpy()
    gv = gt.valid[0].cpu().numpy()
    dump_bev(os.path.join(vis_dir, f"step{step:06d}_bev.png"),
             pb.points[:, :3].cpu().numpy()[sel], point_valid=pb.valid.cpu().numpy()[sel],
             gt_boxes=gt.boxes[0].cpu().numpy()[gv], title=f"step {step} paste={paste}")


class _StepTimer:
    """The step's phases ("forward", "backward", "allreduce", "optimizer"),
    by CUDA events on the card and the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.at = {}

    def mark(self, phase: str) -> None:
        if self.cuda:
            self.at[phase] = torch.cuda.Event(enable_timing=True)
            self.at[phase].record()
        else:
            self.at[phase] = time.perf_counter()

    def ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        names = list(self.at)
        out = {}
        for a, b in zip(names, names[1:]):
            out[f"{b}_ms"] = (self.at[a].elapsed_time(self.at[b]) if self.cuda
                              else (self.at[b] - self.at[a]) * 1e3)
        return out


def _train(cfg: FSFConfig, args, group=None) -> Dict:
    """The loop in this process (rank ``group``'s, or the only one)."""
    rank = torch.distributed.get_rank(group) if group is not None else 0
    world = torch.distributed.get_world_size(group) if group is not None else 1
    device = resolve_device(args.cpu)
    os.makedirs(args.work_dir, exist_ok=True)
    use_fsf = args.model == "fsf"
    reader = None
    if args.synthetic:
        batch_size = 2
        batches = _synthetic_batches(cfg, use_fsf, device)
        total_steps = args.max_steps or 50
        width = 8 if use_fsf else 5
    else:
        if not (args.info_pkl and args.data_root):
            raise ValueError("--info-pkl and --data-root are required (or use --synthetic)")
        if use_fsf and not args.mask_dir:
            raise ValueError("--mask-dir is required for --model fsf")
        batch_size = args.batch_size or 1
        sampler = None
        if args.gt_db:
            sampler = GTPasteSampler(db_path=args.gt_db,
                                     max_per_class=_parse_paste_max(args.paste_max,
                                                                    cfg.num_classes),
                                     seed=args.seed)
        reader = NuScenesReader(
            info_path=args.info_pkl, data_root=args.data_root,
            class_names=cfg.fsd.class_names, seed=args.seed, gt_sampler=sampler)
        # each rank takes every world-th sample (DistributedSampler's split)
        reader._indices = reader._indices[rank::world]
        total_steps = args.max_steps or max(len(reader) // batch_size, 1) * args.epochs
        batches = _reader_batches(reader, cfg, args, use_fsf, batch_size, device)
        width = READER_POINT_WIDTH

    model = build_model(args.model, model_config(cfg, args.model, width), args.seed, device)
    if args.init_from:
        ckpt.load_jax_variables(args.init_from, model)
        print(f"initialized from {args.init_from}")
    opt = make_optimizer(model, base_lr=args.lr, total_steps=total_steps,
                         lr_mult_rules=LR_MULT_RULES)
    start = 0
    if args.resume:
        path = ckpt.latest_checkpoint(args.work_dir)
        if path:
            start = ckpt.load_checkpoint(path, model, opt)
            print(f"resumed from {path} at step {start}")

    schedule = RuntimeSchedule(
        enable_detection_step=args.pretrain_steps,
        threshold_buffer_start=args.threshold_buffer,
        threshold_buffer_end_step=2 * args.pretrain_steps,
        disable_aug_step=args.disable_aug_step,
    )
    log_path = os.path.join(args.work_dir, "train_log.jsonl")
    cuda = device.type == "cuda"
    steps = []
    t0 = time.time()
    for i in range(start, total_steps):
        if reader is not None:
            reader.paste_enabled = schedule.augmentation_enabled(i)
        batch, host = next(batches)
        if args.vis_dir and i % args.vis_interval == 0 and rank == 0:
            _dump_batch(args.vis_dir, i, batch, schedule.augmentation_enabled(i))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = kernel_launches()
        timer = _StepTimer(device)
        timer.mark("start")
        loss, losses, _ = sharded_train_step(model, opt, schedule, batch, i, group, timer.mark)
        rec = {"step": i + 1, "loss": float(loss), "paste": schedule.augmentation_enabled(i),
               "host_ms": host, **timer.ms(), "launches": launches_since(before),
               "losses": {k: float(v) for k, v in losses.items()}}
        if cuda:
            rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        steps.append(rec)
        if (i + 1) % args.log_interval == 0 and rank == 0:
            dt = (time.time() - t0) / args.log_interval
            t0 = time.time()
            line = {"step": i + 1, "loss": round(rec["loss"], 4), "sec_per_step": round(dt, 3),
                    "paste": rec["paste"],
                    **{k: round(v, 4) for k, v in rec["losses"].items()}}
            print(json.dumps(line))
            with open(log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        if ((i + 1) % args.ckpt_interval == 0 or i + 1 == total_steps) and rank == 0:
            ckpt.save_checkpoint(ckpt.checkpoint_path(args.work_dir, i + 1), model, opt, i + 1)
    if rank == 0:
        print(f"done: {total_steps} steps; checkpoints in {args.work_dir}")
    return dict(model=model, opt=opt, steps=steps, start=start, total_steps=total_steps)


def _rank_main(rank: int, world: int, group, cfg: FSFConfig, args) -> Dict:
    out = _train(cfg, args, group)
    return dict(steps=out["steps"], start=out["start"], total_steps=out["total_steps"])


def run(cfg: FSFConfig, args) -> Dict:
    """Train ``cfg`` as ``args`` say. One rank: returns the ``model``, the
    optimizer ``opt``, the first step ``start`` (after a resume) and a
    record per step (``steps``: loss and losses, the host ms of ``read``,
    ``paste``, ``collate``, ``masks`` and ``input``, the device ms of each
    phase, the kernels' ``launches`` and, on the card, ``peak_mib``).
    Several ranks: each rank's ``steps``, ``start`` and ``total_steps``."""
    if args.ranks <= 1:
        return _train(cfg, args)
    with tempfile.TemporaryDirectory() as tmp:
        return {"ranks": spawn_ranks(_rank_main, args.ranks, os.path.join(tmp, "rendezvous"),
                                     (cfg, args), backend="gloo" if args.cpu else "nccl",
                                     device="cpu" if args.cpu else "cuda")}


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    run(config_from_args(args), args)


if __name__ == "__main__":
    main()
