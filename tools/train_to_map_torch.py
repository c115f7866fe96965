"""Train-to-mAP closure for the PyTorch port: overfit the tiny FSF config
on synthetic scenes and measure detection quality through the full decode
path (eval-form forward -> ``FSF.get_bboxes`` with rotated NMS -> the
nuScenes-protocol ``evaluate_detections``), not only the loss.

The port's counterpart of ``tools/train_to_map.py``, with its flags and
the fields of its JSON artifact: the mAP curve on the train pool and on
held-out scenes. Runs on the card unless asked otherwise.

    python tools/train_to_map_torch.py --steps 300              # on the GPU
    python tools/train_to_map_torch.py --device cpu --steps 20
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_scenes(cfg, n_scenes, batch_size, seed0, scene_classes, device):
    """``n_scenes`` batches of the synthetic scene (seeds from ``seed0``),
    GT labels restricted to the first ``scene_classes`` classes (18 boxes
    over 10 classes give 1-2 GT per class, too few for a stable AP)."""
    from fullysparsefusion_tpu_torch import synthetic as S

    return [S.train_scene(seed0 + s, cfg, batch_size, scene_classes, device)
            for s in range(n_scenes)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--held-scenes", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--scene-classes", type=int, default=3)
    ap.add_argument("--train-eval-scenes", type=int, default=8,
                    help="train-pool scenes per train-mAP eval")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "train_to_map_torch.json"))
    args = ap.parse_args()
    device = "cpu" if args.cpu else args.device

    import torch

    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.eval.records import eval_map
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
    from fullysparsefusion_tpu_torch.weights import build_fsf

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_to_map_torch: no CUDA device (pass --device cpu for the CPU)")
    cfg = tiny_fsf_config()
    batch = 2
    train_scenes = build_scenes(cfg, args.scenes, batch, 7, args.scene_classes, device)
    held_scenes = build_scenes(cfg, args.held_scenes, batch, 9000, args.scene_classes, device)
    model = build_fsf(cfg, seed=0, device=device)
    opt = make_optimizer(model, base_lr=args.lr, total_steps=args.steps)
    sched = RuntimeSchedule()
    names = cfg.fsd.class_names

    curve = []
    t0 = time.time()
    for i in range(args.steps + 1):
        if i % args.eval_every == 0:
            m_tr = eval_map(model, train_scenes[:args.train_eval_scenes], batch, names)
            m_ho = eval_map(model, held_scenes, batch, names)
            curve.append({"step": i, "train_mAP": round(m_tr["mAP"], 4),
                          "heldout_mAP": round(m_ho["mAP"], 4),
                          "loss": curve[-1]["loss"] if curve else None,
                          "heldout_per_class": {c: round(a["AP"], 4) for c, a in
                                                m_ho.get("per_class", {}).items()},
                          "t": round(time.time() - t0, 1)})
            print(json.dumps(curve[-1]), flush=True)
        if i == args.steps:
            break
        pb, cam, gt = train_scenes[i % len(train_scenes)]
        loss, _, _ = train_step(model, opt, sched, Batch(pb, cam, gt, gt), i)
        if (i + 1) % args.eval_every == 0:
            curve[-1]["loss"] = round(float(loss), 4)

    artifact = {
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "config": f"tiny_fsf, {args.scenes} train scenes batch {batch}, lr {args.lr}",
        "steps": args.steps,
        "final_train_mAP": curve[-1]["train_mAP"],
        "final_heldout_mAP": curve[-1]["heldout_mAP"],
        "curve": curve,
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
