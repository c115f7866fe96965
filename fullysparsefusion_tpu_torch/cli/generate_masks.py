"""Offline 2D instance-mask pre-inference (the port's counterpart of the JAX
package's ``tools/generate_masks.py``): per sample token, one PNG per
(camera, class) whose pixels hold instance ids (anno row + 1) and an
``anno.json`` table, the tree that FSF's ``--mask-dir`` reads.

``--backend``:
  * ``htc``: the HTC model (``weights.build_htc`` on ``--device``; the
    ``jax-htc`` backend's counterpart) over each info-pickle sample's camera
    JPEGs, decoded by ``data/jpeg.py``: one batch per sample on the device,
    then on the host the paste and paint of ``generate_masks.py``. Weights
    from ``--weights`` (a variables pickle of ``cli/convert_checkpoint.py
    --model htc``, loaded strictly), else (``none`` / ``DEFAULT``) seeded
    from ``--seed``; ``--tiny`` builds the small plumbing model (64
    proposals, 8 detections, one bottleneck per stage);
  * ``precomputed``: a per-sample JSON of detections (bbox, score,
    category, cam_id), each painted as its box;
  * ``random``: ten random boxes per token (pipeline smoke tests), the JAX
    tool's draws from ``default_rng(0)`` across tokens.

Painting follows the reference: the top 250 detections of a sample by
score, higher scores painted last, pixel value = anno row + 1; a PNG is
written for every (camera, class) of those detections, even one whose mask
came out empty. Each sample prints the JAX tool's line, and for ``htc``
its decode, device, paste-and-paint and write ms.

    python -m fullysparsefusion_tpu_torch.cli.generate_masks --backend htc \\
        --info-pkl data/nuscenes/nuscenes_infos_val.pkl --data-root data/nuscenes \\
        --weights htc_vars.pkl --out-dir data/nuscenes/masks
    python -m fullysparsefusion_tpu_torch.cli.generate_masks --backend htc --tiny \\
        --device cpu --info-pkl ... --out-dir /tmp/masks
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import generate_masks as gm
from ..data.jpeg import load_sample_images
from ..data.masks import save_sample
from ..weights import build_htc
from .common import kernel_launches, launches_since, timed

BACKENDS = ("random", "precomputed", "htc")
# the JAX tool's FSF_HTC_TINY model
TINY_HTC = dict(num_proposals=64, rpn_pre_nms=64, max_dets=8, depth_blocks=(1, 1, 1, 1))
MAX_ANNO = 250


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="random", choices=BACKENDS)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--tokens", nargs="+", default=None,
                    help="sample tokens (random/precomputed backends; "
                         "defaults to every info-pkl sample, else 'sample0')")
    ap.add_argument("--info-pkl", help="mmdet3d info pickle with per-sample 'cams' image "
                    "paths (htc backend)")
    ap.add_argument("--data-root", default="")
    ap.add_argument("--num-cams", type=int, default=6)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--img-h", type=int, default=900)
    ap.add_argument("--img-w", type=int, default=1600)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--weights", default="DEFAULT",
                    help="HTC variables pickle (cli/convert_checkpoint.py --model htc), or "
                         "'none' / 'DEFAULT' for weights seeded from --seed")
    ap.add_argument("--max-samples", type=int, default=0)
    ap.add_argument("--precomputed-json", help="for --backend precomputed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the HTC weights")
    ap.add_argument("--tiny", action="store_true", help="the small plumbing HTC (tests)")
    return ap.parse_args(argv)


def backend_random(rng, num_cams, num_classes, img_hw, n=10) -> List[dict]:
    """The JAX tool's random boxes, the same draws from ``rng``; each mask
    on the full canvas (offset (0, 0))."""
    h, w = img_hw
    out = []
    for _ in range(n):
        cam = int(rng.integers(num_cams))
        cls = int(rng.integers(num_classes))
        x1, y1 = rng.integers(0, w - 40), rng.integers(0, h - 40)
        bw, bh = rng.integers(20, 40), rng.integers(20, 40)
        mask = np.zeros((h, w), bool)
        mask[y1:y1 + bh, x1:x1 + bw] = True
        out.append(dict(cam_id=cam, category=cls, score=float(rng.random()),
                        bbox=[float(x1), float(y1), float(x1 + bw), float(y1 + bh)],
                        mask=mask, offset=(0, 0)))
    return out


def backend_precomputed(raw: List[dict], img_hw) -> List[dict]:
    """Each detection's box as its mask on the full canvas, exactly as the
    JAX tool builds it (``m[y1:y2, x1:x2] = True``, NumPy's slice rules,
    negative indices included)."""
    h, w = img_hw
    dets = []
    for d in raw:
        m = np.zeros((h, w), bool)
        x1, y1, x2, y2 = [int(v) for v in d["bbox"]]
        m[y1:y2, x1:x2] = True  # bbox-mask fallback when no RLE
        dets.append(dict(d, mask=m, offset=(0, 0)))
    return dets


def write_sample(out_dir: str, token: str, dets: List[dict], num_cams: int, num_classes: int,
                 img_hw):
    """Paint ``dets`` and write the token's PNGs and ``anno.json``; returns
    (planes, annos, the written (camera, class) keys, paint ms, write ms)."""
    t0 = time.perf_counter()
    planes, annos = gm.paint_sample(dets, num_cams, num_classes, img_hw, MAX_ANNO)
    keys = gm.plane_keys(dets, MAX_ANNO)
    t1 = time.perf_counter()
    save_sample(out_dir, token, {k: planes[k[0], :, :, k[1]] for k in keys}, annos)
    return planes, annos, keys, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def load_htc(args, device):
    """``build_htc`` on ``device``: the converted variables of ``--weights``
    (strict), else seeded from ``--seed``."""
    kw = TINY_HTC if args.tiny else {}
    variables = None
    if args.weights and args.weights not in ("none", "DEFAULT"):
        with open(args.weights, "rb") as f:
            variables = pickle.load(f)
    return build_htc(seed=args.seed, device=device, jax_variables=variables, **kw)


def run_htc_backend(args, infos: List[Dict]) -> List[Dict]:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    model = load_htc(args, device)
    records = []
    for info in infos:
        token = info.get("token", "")
        t0 = time.perf_counter()
        images = load_sample_images(info, args.data_root)
        decode_ms = (time.perf_counter() - t0) * 1e3
        n, h, w, _ = images.shape
        before = kernel_launches()
        dets, gpu_ms = timed(lambda: gm.run_htc(model, images), device)
        launches = launches_since(before)
        t1 = time.perf_counter()
        pasted = gm.paste_detections(dets, (h, w), args.score_thr)
        paste_ms = (time.perf_counter() - t1) * 1e3
        planes, annos, keys, paint_ms, write_ms = write_sample(
            args.out_dir, token, pasted, n, args.num_classes, (h, w))
        print(f"{token}: {len(annos)} instances, {len(keys)} mask planes")
        rec = dict(token=token, instances=len(annos), planes=len(keys),
                   nonempty_planes=int(sum(planes[c, :, :, k].any() for c, k in keys)),
                   decode_ms=decode_ms, gpu_ms=gpu_ms, paste_paint_ms=paste_ms + paint_ms,
                   write_ms=write_ms, launches=launches)
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in rec.items() if k != "token"}))
        records.append(rec)
    return records


def main(argv: Optional[list] = None) -> List[Dict]:
    """Runs the CLI; returns one record per sample (token, instances,
    planes written; for ``htc`` also the non-empty planes, the ms of each
    step and the kernels' launches)."""
    args = parse_args(argv)
    infos = None
    if args.info_pkl:
        with open(args.info_pkl, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        if args.max_samples:
            infos = infos[: args.max_samples]

    if args.backend == "htc":
        if infos is None:
            raise ValueError("--info-pkl is required for --backend htc")
        return run_htc_backend(args, infos)

    rng = np.random.default_rng(0)
    tokens = args.tokens
    if tokens is None:
        tokens = [i.get("token", "") for i in infos] if infos else ["sample0"]
    hw = (args.img_h, args.img_w)
    raw_all = None
    if args.backend == "precomputed":
        if not args.precomputed_json:
            raise ValueError("--precomputed-json is required for --backend precomputed")
        with open(args.precomputed_json) as f:
            raw_all = json.load(f)
    records = []
    for token in tokens:
        if args.backend == "random":
            dets = backend_random(rng, args.num_cams, args.num_classes, hw)
        else:
            dets = backend_precomputed(raw_all[token], hw)
        _, annos, keys, _, _ = write_sample(args.out_dir, token, dets, args.num_cams,
                                            args.num_classes, hw)
        print(f"{token}: {len(annos)} instances, {len(keys)} mask planes")
        records.append(dict(token=token, instances=len(annos), planes=len(keys)))
    return records


if __name__ == "__main__":
    main()
