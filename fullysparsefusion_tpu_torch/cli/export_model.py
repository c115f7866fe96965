"""Whole-model export for serving: FSF's or FSD's forward as a
``torch.export`` program saved in a ``.pt2`` file (the port's counterpart of
the JAX package's ``tools/export_model.py``).

The program is traced once (non-strict ``torch.export.export``, eval-form
BN, no gradient) at the fixed shapes of its inputs, and a serving process
loads and runs it with no model code: importing ``ops.library`` (the
kernels as the ``fsf::`` custom ops, and the input containers as pytree
nodes) is enough (``cli/serve_exported.py``). Signatures, as in JAX:

* FSF: ``(PointBatch, CameraData) -> (cls_logits, reg_preds, centers)`` of
  the last refinement stage (``out["final"]``);
* FSD: ``(PointBatch) -> (cls_logits, reg_preds, cluster_xyz)`` (one task).

Decode and NMS are not exported. The JAX tool passes the variables as
arguments; here the parameters and buffers are lifted into the program,
under the model's own ``state_dict`` keys, so ``program.module()`` takes
``load_state_dict`` of another checkpoint of the same config.

    # export the tiny FSF on the CPU (the card is the default device)
    python -m fullysparsefusion_tpu_torch.cli.export_model --model fsf --tiny \
        --device cpu --out fsf.pt2
    # load an artifact and hold it to the live model on the same inputs
    python -m fullysparsefusion_tpu_torch.cli.export_model --model fsf --tiny \
        --device cpu --check fsf.pt2
    # both, on the card, from a reference config file
    python -m fullysparsefusion_tpu_torch.cli.export_model --model fsf \
        --config FSF_nuScenes_config.py --out fsf.pt2 --check
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .. import synthetic as S
from ..config import tiny_fsd_config, tiny_fsf_config
from ..config_compat import load_fsf_config
from ..models.fsd import SingleStageFSD
from ..models.fsf import FSF
from ..weights import build_fsd, build_fsf

MODELS = ("fsf", "fsd")
# the JAX tool's batch for --tiny and --config
BATCH = 2
# the JAX tool's --check bounds
CHECK_RTOL = CHECK_ATOL = 1e-5


def serving_module(model: nn.Module, batch_size: int) -> nn.Module:
    """``model`` with the exported signature as its ``forward``: an instance
    of a subclass of the model's class that shares the model's state
    (parameters, buffers, submodules), so the program's ``state_dict`` has
    the model's keys. Eval-form BN whatever the model's mode."""
    base = type(model)
    if isinstance(model, FSF):
        def forward(self, pb, cam):
            fin = base.forward(self, pb, cam, batch_size, train=False)["final"]
            return fin["cls_logits"], fin["reg_preds"], fin["centers"]
    elif isinstance(model, SingleStageFSD):
        def forward(self, pb):
            out = base.forward(self, pb, batch_size, train=False)
            if "cls_logits" not in out:
                raise ValueError("export takes an FSD with one task")
            return out["cls_logits"], out["reg_preds"], out["cluster_xyz"]
    else:
        raise TypeError(f"no exported signature for {base.__name__}")
    cls = type(f"{base.__name__}Serving", (base,), {"forward": forward})
    view = cls.__new__(cls)
    view.__dict__ = model.__dict__
    return view


def export(model: nn.Module, inputs: Tuple, batch_size: int) -> torch.export.ExportedProgram:
    """``model``'s serving forward on ``inputs`` (``(pb, cam)`` for FSF,
    ``(pb,)`` for FSD) as an exported program at their shapes. The trace's
    example inputs are not kept: the artifact holds the program and its
    weights, not a request (FSF's mask planes alone are 86 MB at the
    bench's six 450 x 800 cameras)."""
    with torch.no_grad():
        program = torch.export.export(serving_module(model, batch_size), tuple(inputs),
                                      strict=False)
    program.example_inputs = None
    return program


def configs(tiny: bool, config: str | None):
    """(FSF config, FSD config): the tiny test configs, or a reference config
    file's FSF and its ``fsd`` (as the JAX tool takes them)."""
    if tiny or not config:
        return tiny_fsf_config(), tiny_fsd_config()
    fsf_cfg = load_fsf_config(config)
    return fsf_cfg, fsf_cfg.fsd


def build(model_name: str, tiny: bool, config: str | None, device="cuda"):
    """(model, inputs) as the JAX tool's ``build()`` makes them: the seed-0
    test scene at batch ``BATCH`` and the config's capacities (FSF: with its
    cameras and the no-aug channels), the model's weights from seed 0."""
    fsf_cfg, fsd_cfg = configs(tiny, config)
    if model_name == "fsf":
        cfg = fsf_cfg
        sc = S.make_scene_arrays(seed=0, batch_size=BATCH, n_cap=cfg.fsd.caps.points,
                                 max_gt=cfg.fsd.caps.max_gt)
        cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                   batch_size=BATCH, num_cams=cfg.num_cams,
                                   num_classes=cfg.num_classes)
        return build_fsf(cfg, 0, device), S.fsf_inputs(sc, cam, device)
    if model_name == "fsd":
        cfg = fsd_cfg
        sc = S.make_scene_arrays(seed=0, batch_size=BATCH, n_cap=cfg.caps.points,
                                 max_gt=cfg.caps.max_gt)
        return build_fsd(cfg, 0, device), (S.to_point_batch(sc, device),)
    raise ValueError(f"unknown model {model_name!r}; one of {MODELS}")


def run(program_module: nn.Module, inputs: Tuple):
    """The loaded program's outputs on ``inputs`` (no autograd)."""
    with torch.inference_mode():
        return tuple(program_module(*inputs))


def check(path: str, model: nn.Module, inputs: Tuple, batch_size: int) -> Dict:
    """Load the artifact at ``path`` and hold its outputs to the live model's
    on the same inputs at ``CHECK_RTOL`` / ``CHECK_ATOL``; raises on a
    mismatch. Returns whether they are bitwise equal too."""
    got = run(torch.export.load(path).module(), inputs)
    want = run(serving_module(model, batch_size), inputs)
    if len(got) != len(want):
        raise AssertionError(f"the artifact gives {len(got)} outputs, the model {len(want)}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=CHECK_RTOL,
                                   atol=CHECK_ATOL)
    return {"outputs": len(got), "bitwise": all(torch.equal(g, w) for g, w in zip(got, want))}


def mb(path: str) -> float:
    return os.path.getsize(path) / 1e6


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="fsf", choices=MODELS)
    ap.add_argument("--tiny", action="store_true", help="the tiny test configs")
    ap.add_argument("--config", help="reference config file (FSD takes its fsd part)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model is traced and the artifact runs (default: the card)")
    ap.add_argument("--out", help="the .pt2 to write")
    ap.add_argument("--check", nargs="?", const=True, default=None,
                    help="load an artifact (default: --out, after writing it) and run it "
                         "against the live model on the same inputs")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to export on the CPU")
    if not args.out and not isinstance(args.check, str):
        raise SystemExit("--out or --check PATH required")
    model, inputs = build(args.model, args.tiny, args.config, args.device)
    res: Dict = {"model": args.model}
    if args.out:
        t0 = time.perf_counter()
        program = export(model, inputs, BATCH)
        res["export_seconds"] = time.perf_counter() - t0
        torch.export.save(program, args.out)
        res.update(out=args.out, mb=mb(args.out), nodes=len(program.graph.nodes))
        print(f"exported {args.model} ({res['mb']:.1f} MB .pt2, {res['nodes']} graph nodes, "
              f"{res['export_seconds']:.1f} s, device {args.device}) -> {args.out}")
    if args.check:
        path = args.check if isinstance(args.check, str) else args.out
        res["check"] = check(path, model, inputs, BATCH)
        print(f"artifact matches live model on {args.model} ({res['check']['outputs']} outputs, "
              f"{mb(path):.1f} MB .pt2, bitwise {res['check']['bitwise']})")
    return res


if __name__ == "__main__":
    main()
