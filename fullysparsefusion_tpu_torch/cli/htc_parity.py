"""HTC activation-parity CLI (the port's counterpart of the JAX package's
``tools/htc_parity.py``); the workflow is ``utils/htc_parity.py``'s.

``dump`` runs the port's HTC on the card (``--cpu``: on the host, f32
without TF32 on the card) with seeded weights, or with a reference mmdet
HTC ``.pth`` (``--ckpt``, read by ``train/checkpoint.load_torch_state_dict``
and mapped by ``train/torch_map.convert_state_dict``), and saves the taps
of ``utils/htc_parity.ACTIVATION_ORDER`` (the image-level ones, and with
``--rois`` the cascade's on that fixed RoI set) as an ``.npz`` under the
JAX package's keys and layouts. ``compare`` prints the per-tap table in
that order and exits 1 at the first divergent tap. ``--print-torch-snippet``
prints the mmdet-side dump script (the JAX tool's text).

The JAX tool's default image is ``jax.random.uniform(key(1))``, which
NumPy cannot reproduce: without ``--image`` the port draws its image from
``--seed`` with NumPy. Dumps of the two packages compare only when both
are given the same ``--image`` and ``--rois``.

    # the port's side (seeded weights without --ckpt; converted mmdet weights with)
    python -m fullysparsefusion_tpu_torch.cli.htc_parity dump --out ours.npz \
        [--ckpt htc.pth] [--image img.npy] [--rois rois.npy] [--hw 928,1600]

    # after dumping the mmdet side elsewhere (the snippet below):
    python -m fullysparsefusion_tpu_torch.cli.htc_parity compare theirs.npz ours.npz [--atol 1e-3]

    # the mmdet-side dump script (run where mmdet, torch and the checkpoint are):
    python -m fullysparsefusion_tpu_torch.cli.htc_parity --print-torch-snippet > dump_mmdet_htc.py
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..train.checkpoint import load_torch_state_dict
from ..train.torch_map import convert_state_dict
from ..utils.htc_parity import (compare_activations, dump_torch_activations, first_divergent,
                                load_activations, save_activations)
from ..weights import build_htc, to_jax_variables
from .common import resolve_device

# the tiny HTC of the tests (ResNeXt with one block a stage)
TINY = dict(depth_blocks=(1, 1, 1, 1), num_proposals=16, rpn_pre_nms=16, max_dets=4)

# The mmdet side: the JAX tool's template, word for word (a starting point
# pinned to mmdet 2.x HTC APIs; its hooks mirror ACTIVATION_ORDER).
TORCH_SNIPPET = '''\
"""Dump mmdet HTC activations for parity with fullysparsefusion_tpu.

Usage (mmdet 2.x environment):
    python dump_mmdet_htc.py CONFIG CKPT IMAGE.npy ROIS.npy OUT.npz
IMAGE.npy: [1, H, W, 3] RGB 0-255 float32 (the JAX side uses the same
array); ROIS.npy: [P, 4] xyxy image pixels.
"""
import sys
import numpy as np
import torch
from mmdet.apis import init_detector

cfg, ckpt, image_npy, rois_npy, out = sys.argv[1:6]
model = init_detector(cfg, ckpt, device="cpu").eval()
img = np.load(image_npy)  # [1, H, W, 3] RGB 0-255
rois = np.load(rois_npy)  # [P, 4] xyxy

# mmdet normalizes inside the data pipeline; replicate img_norm_cfg
norm = model.cfg.img_norm_cfg
x = (img - np.array(norm["mean"])) / np.array(norm["std"])
if not norm.get("to_rgb", True):
    x = x[..., ::-1]
x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).float()

acts = {}
with torch.no_grad():
    feats = model.backbone(x)
    for i, c in enumerate(feats):
        acts[f"backbone.c{i + 2}"] = c.permute(0, 2, 3, 1).numpy()
    pyr = model.neck(feats)
    for i, p in enumerate(pyr):
        acts[f"fpn.p{i + 2}"] = p.permute(0, 2, 3, 1).numpy()
    cls_lvls, reg_lvls = model.rpn_head(pyr)
    for i, (c, r) in enumerate(zip(cls_lvls, reg_lvls)):
        acts[f"rpn.cls.l{i}"] = c.permute(0, 2, 3, 1).numpy()
        acts[f"rpn.reg.l{i}"] = r.permute(0, 2, 3, 1).numpy()
    sem_logits, sem_feat = model.roi_head.semantic_head(pyr)
    acts["semantic.logits"] = sem_logits.permute(0, 2, 3, 1).numpy()
    acts["semantic.embed"] = sem_feat.permute(0, 2, 3, 1).numpy()

    rh = model.roi_head
    t_rois = torch.cat(
        [torch.zeros(len(rois), 1), torch.from_numpy(rois).float()], 1)
    r = t_rois
    img_hw = img.shape[1:3]
    for si in range(3):
        bf = rh.bbox_roi_extractor[si](
            pyr[: rh.bbox_roi_extractor[si].num_inputs], r)
        sf = rh.semantic_roi_extractor([sem_feat], r)
        bf = bf + sf
        acts[f"roi.bbox_feats{si}"] = bf.permute(0, 2, 3, 1).numpy()
        cls, reg = rh.bbox_head[si](bf)
        acts[f"bbox_head{si}.cls"] = cls.numpy()
        acts[f"bbox_head{si}.reg"] = reg.numpy()
        boxes = rh.bbox_head[si].bbox_coder.decode(
            r[:, 1:], reg, max_shape=img_hw)
        acts[f"bbox_head{si}.rois"] = boxes.numpy()
        r = torch.cat([r[:, :1], boxes], 1)
    mf = rh.mask_roi_extractor[-1](
        pyr[: rh.mask_roi_extractor[-1].num_inputs], t_rois)
    msf = rh.semantic_roi_extractor([sem_feat], t_rois)
    mf = mf + msf
    acts["roi.mask_feats"] = mf.permute(0, 2, 3, 1).numpy()
    last = None
    for si in range(3):
        head = rh.mask_head[si]
        if si == 0:
            lg = head(mf, return_feat=False)
        else:
            lg, last_new = head(mf + (last if last is not None else 0),
                                return_feat=True)  # adapt per mmdet version
            last = last_new
        acts[f"mask_head{si}.logits"] = (
            lg.permute(0, 2, 3, 1).numpy() if lg.dim() == 4 else lg.numpy())

np.savez_compressed(out, **acts)
print(f"wrote {len(acts)} activations to {out}")
'''


def build(ckpt: Optional[str], tiny: bool, seed: int, device):
    """The port's HTC on ``device``: weights from ``seed``, or ``ckpt``'s
    converted onto that model's tree (leaves the checkpoint lacks keep the
    seeded values); the conversion's report is printed."""
    kw = TINY if tiny else {}
    model = build_htc(seed, device="cpu", **kw)
    if ckpt:
        variables, report = convert_state_dict(load_torch_state_dict(ckpt),
                                               to_jax_variables(model), model="htc")
        print(f"# converted: {report}")
        model = build_htc(device="cpu", jax_variables=variables, **kw)
    return model.to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--print-torch-snippet", action="store_true")
    sub = ap.add_subparsers(dest="cmd")
    d = sub.add_parser("dump")
    d.add_argument("--out", required=True)
    d.add_argument("--ckpt", default=None, help="a reference mmdet HTC .pth")
    d.add_argument("--image", default=None, help="[1,H,W,3] RGB .npy")
    d.add_argument("--rois", default=None, help="[P,4] xyxy .npy")
    d.add_argument("--hw", default="928,1600", help="the drawn image's size without --image")
    d.add_argument("--seed", type=int, default=0, help="the weights' and the drawn image's seed")
    d.add_argument("--tiny", action="store_true", help="the tiny HTC of the tests")
    d.add_argument("--cpu", action="store_true", help="run on the host CPU")
    c = sub.add_parser("compare")
    c.add_argument("ref")
    c.add_argument("ours")
    c.add_argument("--atol", type=float, default=1e-3)
    c.add_argument("--rtol", type=float, default=1e-3)
    return ap, ap.parse_args(argv)


def dump(args) -> Dict[str, np.ndarray]:
    """The taps of ``args``' model on ``args``' image (and RoIs), saved to
    ``args.out``."""
    device = resolve_device(args.cpu)
    if args.image:
        img = np.load(args.image).astype(np.float32)
    else:
        hw = tuple(int(v) for v in args.hw.split(","))
        img = np.random.default_rng(args.seed).uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    rois = np.load(args.rois).astype(np.float32) if args.rois else None
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False     # f32 taps mean f32
        try:
            model = build(args.ckpt, args.tiny, args.seed, device)
            acts = dump_torch_activations(
                model, torch.as_tensor(img, device=device),
                None if rois is None else torch.as_tensor(rois, device=device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    save_activations(acts, args.out)
    print(f"wrote {len(acts)} activations to {args.out}")
    return acts


def compare(args) -> int:
    """Print the per-tap table; 1 at a divergent tap, else 0."""
    rows = compare_activations(load_activations(args.ref), load_activations(args.ours),
                               atol=args.atol, rtol=args.rtol)
    wa = max(len(r["name"]) for r in rows)
    for r in rows:
        ma = "—" if r["max_abs"] is None else f"{r['max_abs']:.3e}"
        mr = "—" if r["max_rel"] is None else f"{r['max_rel']:.3e}"
        flag = "ok" if r["ok"] else "DIVERGED"
        print(f"{r['name']:<{wa}}  max_abs={ma:>10}  max_rel={mr:>10}  {flag}")
    bad = first_divergent(rows)
    if bad:
        print(f"\nfirst divergent module: {bad}")
        return 1
    print("\nall modules match")
    return 0


def main(argv=None) -> int:
    ap, args = parse_args(argv)
    if args.print_torch_snippet:
        print(TORCH_SNIPPET)
        return 0
    if args.cmd == "dump":
        dump(args)
        return 0
    if args.cmd == "compare":
        return compare(args)
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
