"""Reference checkpoint (mmdet3d ``.pth``) → a pickle of flax-named variables,
and back (the port's counterpart of the JAX package's
``tools/convert_checkpoint.py``).

FSF's recipe warm-starts from an FSD pretrain (the reference config's
``load_from``). ``train/torch_map.py`` maps every tensor of the reference's
layout onto the flax variable tree; this CLI applies it against a skeleton
of the model and writes the tree as the pickle that both packages'
``--init-from`` read (``train.checkpoint.load_jax_variables`` here).

The skeleton is the port's model seeded with ``--seed``, built on the CPU
(no card needed), so a leaf the checkpoint lacks keeps its initial value.
The JAX tool's skeleton comes from ``jax.eval_shape``, so such leaves come
out as zeros there: for an FSD pretrain loaded into FSF, every LayerNorm
scale and BN variance of the FSF-only modules. ``torch_map.convert_state_dict``
itself is the JAX package's function and gives the same output for the same
skeleton.

    # a checkpoint's keys
    python -m fullysparsefusion_tpu_torch.cli.convert_checkpoint --pth fsd_pretrain.pth --list
    # convert (the config file gives the model's shape)
    python -m fullysparsefusion_tpu_torch.cli.convert_checkpoint --pth fsd_pretrain.pth \
        --model fsf --config FSF_nuScenes_config.py --point-dim 6 --out vars.pkl
    # export back to the reference layout
    python -m fullysparsefusion_tpu_torch.cli.convert_checkpoint --export vars.pkl \
        --model fsf --out sd.pth
"""
from __future__ import annotations

import argparse
import dataclasses
import pickle
from typing import Dict, Optional

import torch

from ..config import tiny_fsd_config, tiny_fsf_config
from ..config_compat import load_fsf_config
from ..train.checkpoint import load_torch_state_dict
from ..train.torch_map import convert_state_dict, synthesize_state_dict
from ..weights import build_fsd, build_fsf, build_htc, to_jax_variables

MODELS = ("fsd", "fsf", "htc")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pth", help=".pth checkpoint to convert")
    ap.add_argument("--export", help="converted-variables pickle to export to the torch layout")
    ap.add_argument("--model", default="fsd", choices=MODELS)
    ap.add_argument("--config", help="reference config file (the model's shape)")
    ap.add_argument("--tiny", action="store_true", help="the tiny test config's shapes")
    ap.add_argument("--point-dim", type=int,
                    help="point channels the segmentor reads (default: the config's); "
                         "cli.train serves FSF 6 from the nuScenes reader")
    ap.add_argument("--seed", type=int, default=0,
                    help="the skeleton's initialisation: what unfilled leaves keep")
    ap.add_argument("--list", action="store_true", help="print the checkpoint's keys and exit")
    ap.add_argument("--out")
    return ap.parse_args(argv)


def build_skeleton(model_name: str, config_path: Optional[str], tiny: bool, seed: int = 0,
                   point_dim: Optional[int] = None) -> Dict:
    """The variable tree (``weights.to_jax_variables``) of the port's
    ``model_name`` seeded with ``seed``, on the CPU: FSF / FSD from the
    config file (the tiny test config with ``tiny`` or without a file), HTC
    at its defaults."""
    if model_name == "htc":
        return to_jax_variables(build_htc(seed, device="cpu"))
    if tiny or not config_path:
        fsf_cfg, fsd_cfg = tiny_fsf_config(), tiny_fsd_config()
    else:
        fsf_cfg = load_fsf_config(config_path)
        fsd_cfg = fsf_cfg.fsd
    if point_dim is not None:
        fsd_cfg = dataclasses.replace(fsd_cfg, segmentor=dataclasses.replace(
            fsd_cfg.segmentor, point_dim=point_dim))
        fsf_cfg = dataclasses.replace(fsf_cfg, fsd=fsd_cfg)
    if model_name == "fsf":
        return to_jax_variables(build_fsf(fsf_cfg, seed, device="cpu"))
    return to_jax_variables(build_fsd(fsd_cfg, seed, device="cpu"))


def main(argv=None) -> Dict:
    """Runs the CLI; returns what it did: ``exported`` (tensors written),
    the checkpoint's ``keys`` (``--list``), or the conversion's ``report``
    (``filled`` / ``total``, ``missing``, ``unmapped``, ``mismatch``)."""
    args = parse_args(argv)
    if args.export:
        if not args.out:
            raise ValueError("--out is required with --export")
        with open(args.export, "rb") as f:
            variables = pickle.load(f)
        sd = synthesize_state_dict(variables, args.model)
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, args.out)
        print(f"exported {len(sd)} tensors to {args.out}")
        return {"exported": len(sd)}

    if not args.pth:
        raise ValueError("--pth is required (or --export)")
    sd = load_torch_state_dict(args.pth)
    if args.list:
        for k, v in sd.items():
            print(f"{k:90s} {tuple(v.shape)}")
        return {"keys": {k: tuple(v.shape) for k, v in sd.items()}}

    skeleton = build_skeleton(args.model, args.config, args.tiny, args.seed, args.point_dim)
    variables, report = convert_state_dict(sd, skeleton, args.model)
    print(f"filled {report['filled']}/{report['total']} mapped tensors")
    for kind in ("missing", "unmapped"):
        print(f"{kind}: {len(report[kind])}")
        for k in report[kind][:30]:
            print("  ", k)
    print(f"mismatch: {len(report['mismatch'])}")
    for k, got, want in report["mismatch"][:30]:
        print(f"   {k}: checkpoint {got} against model {want}")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(variables, f)
        print(f"wrote {args.out}")
    return {"report": report}


if __name__ == "__main__":
    main()
