#!/usr/bin/env python3
"""How far the tiny FSF's gradients move when K1's output moves at f32
rounding level: the floor under any comparison of two devices' gradients.

    python3 tools/grad_noise_floor.py [--rel 3e-7] [--seed 0]

Runs the tiny config (every UNet conv on the gather path, as the parity
tests and ``chip_smoke.py`` run it) forward + losses + backward on the CPU
twice from the same weights: once as is, once with every gather-conv output
(forward and input gradients) multiplied by ``1 + rel · N(0, 1)``, which is
what a different f32 summation order does. Prints, for eval-form and
train-form BN, the relative L2 distance of the whole gradient tree, the
number of leaves beyond 5e-2, and the worst leaves.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fullysparsefusion_tpu_torch import synthetic as S  # noqa: E402
from fullysparsefusion_tpu_torch.config import tiny_fsf_config  # noqa: E402
from fullysparsefusion_tpu_torch.ops import sparse_conv  # noqa: E402
from fullysparsefusion_tpu_torch.parallel.train import total_loss  # noqa: E402
from fullysparsefusion_tpu_torch.weights import build_fsf  # noqa: E402


def gradients(model, sc, cam, train: bool):
    m = copy.deepcopy(model)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    gt = S.to_ground_truth(sc, device="cpu")
    total_loss(m(pb, cd, 2, gt, gt, train=train)["losses"]).backward()
    return {n: p.grad.clone() for n, p in m.named_parameters()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rel", type=float, default=3e-7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cfg = tiny_fsf_config()
    seg = dataclasses.replace(cfg.fsd.segmentor, unet_dense_min_occupancy=2.0)
    cfg = dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))
    sc = S.make_scene_arrays(seed=args.seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    model = build_fsf(cfg, seed=args.seed, device="cpu")
    plain = sparse_conv.gather_conv_plain
    gen = torch.Generator().manual_seed(args.seed)

    def perturbed(feats, rows, w):
        out = plain(feats, rows, w)
        return out * (1 + args.rel * torch.randn(out.shape, generator=gen))

    for form, train in (("eval_bn", False), ("train_bn", True)):
        ref = gradients(model, sc, cam, train)
        sparse_conv.gather_conv_plain = perturbed
        try:
            got = gradients(model, sc, cam, train)
        finally:
            sparse_conv.gather_conv_plain = plain
        leaves = sorted(((float((got[n] - g).norm()) / max(float(g.norm()), 1e-12), n)
                         for n, g in ref.items()), reverse=True)
        num = sum(float((got[n] - g).norm()) ** 2 for n, g in ref.items())
        den = sum(float(g.norm()) ** 2 for g in ref.values())
        print(json.dumps({"form": form, "rel": args.rel, "grad_total_rel": (num / den) ** 0.5,
                          "leaves_over_5e-2": sum(e > 5e-2 for e, _ in leaves),
                          "leaves": len(leaves),
                          "worst": [[n, e] for e, n in leaves[:4]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
