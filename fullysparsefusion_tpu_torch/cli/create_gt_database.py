"""Build the GT-paste object database from a training info pickle (the port's
copy of the JAX package's ``tools/create_gt_database.py``; the same tree gives
the same database pickle).

Counterpart of mmdet3d's ``create_groundtruth_database``: crop every
annotated object's points into a per-class pickle that ``GTPasteSampler``
draws from.

    python -m fullysparsefusion_tpu_torch.cli.create_gt_database \
        --info-pkl data/infos_train.pkl --data-root data/nuscenes --out data/gt_db.pkl
"""
from __future__ import annotations

import argparse

from ..config import FSDConfig
from ..data.gt_sampling import build_gt_database
from ..data.nuscenes import NuScenesReader


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--info-pkl", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--min-points", type=int, default=5)
    ap.add_argument("--max-samples", type=int, default=0)
    return ap.parse_args(argv)


def run(args):
    """Write the database; returns the object count per class id."""
    class_names = FSDConfig().class_names
    reader = NuScenesReader(
        info_path=args.info_pkl, data_root=args.data_root,
        class_names=class_names, training=False, with_cbgs=False,
    )
    n = min(len(reader), args.max_samples) if args.max_samples else len(reader)
    samples = (reader.sample(i, augment=False) for i in range(n))
    return build_gt_database(samples, class_names, args.out, args.min_points)


def main(argv=None):
    args = parse_args(argv)
    counts = run(args)
    print({k: v for k, v in counts.items() if v})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
