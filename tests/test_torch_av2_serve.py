"""The AV2 slice as a whole on the CPU: a tiny synthesised AV2 log
(``cli/make_fake_av2.py``: the tiny ring rig, a moving ego, a box in front
of each camera, single-channel masks painted from the rig's geometry)
prepared by ``cli/prepare_av2.py --fusion`` and served by ``cli/test.py
--eval-protocol av2 --model fsf --cpu --eval`` at ``test_torch_av2``'s tiny
AV2-shaped config (``config.tiny_av2_fsf_config``), its weights drawn by
``test_torch_fsf._numpy_variables`` into the JAX tree and carried through
``weights.from_jax_variables`` into the ``--checkpoint``.

One ``FAST_COMPILE`` jit of the JAX FSF's eval forward + ``get_bboxes`` is
fed each frame's batch (``collate_scene`` of the reader's sample) and
camera data (``cli/common.load_av2_masks``' planes, anno and scaled
``lidar2img``). Tolerances, as ``test_torch_av2.py``'s: detection counts
and labels equal, boxes and scores within 4e-3 relative / absolute (bf16
activations in the sparse UNet), each CLI detection paired with one JAX
detection of the same label in that order, except that detections whose
scores lie within that tolerance of each other may trade places (the
scene has pairs ~3e-5 apart, which the bf16 chain reorders). The sweeps
are float16, as AV2's, so points lie exactly on voxel edges, where the
voxel coordinates must agree too (``ops/voxelize.voxel_coords``). The
feather ``--out`` is read back equal to ``data/av2.boxes_to_av2_rows`` of the CLI's own detections (bitwise,
``read_feather``), and the metrics are finite.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu import config as jcfg
from fullysparsefusion_tpu.models.camera import CameraData as JCameraData
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.utils.containers import PointBatch as JPointBatch
from fullysparsefusion_tpu_torch import config as tcfg
from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
from fullysparsefusion_tpu_torch.cli import prepare_av2 as P
from fullysparsefusion_tpu_torch.cli import test as T
from fullysparsefusion_tpu_torch.cli.common import load_av2_masks
from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES
from fullysparsefusion_tpu_torch.data.av2 import AV2Reader, boxes_to_av2_rows
from fullysparsefusion_tpu_torch.data.feather import read_feather
from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
from fullysparsefusion_tpu_torch.weights import build_fsf
from test_torch_av2 import BF16_CHAIN_TOL, tiny_av2_config
from test_torch_av2_fusion_masks import ring_frame
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import FAST_COMPILE, _numpy_variables

FRAMES = (0, 1)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("av2"))
    F.write_log(os.path.join(root, "sensor"), "log", [ring_frame(F.TINY_RIG, s) for s in FRAMES],
                F.TINY_RIG, mask_dir=os.path.join(root, "masks"), radius=1)
    info = os.path.join(root, "infos.pkl")
    P.main(["--av2-root", os.path.join(root, "sensor"), "--out", info, "--points-out",
            os.path.join(root, "points"), "--fusion"])
    cfg = tcfg.tiny_av2_fsf_config()
    reader = AV2Reader(info, root, AV2_CLASS_NAMES, training=False,
                       point_cloud_range=cfg.fsd.segmentor.point_cloud_range)
    inputs = []
    for i, meta in enumerate(reader.infos):
        s = reader.sample(i)
        front = meta["cams"]["ring_front_center"]
        planes = load_av2_masks([s], [(front["height_px"], front["width_px"])],
                                os.path.join(root, "masks"), cfg.num_classes,
                                F.TINY_RIG.ring_hw, 2)
        inputs.append((s, collate_scene([s], cfg.caps.points, cfg.caps.max_gt), planes))

    def jax_inputs(batch, planes):
        pb = JPointBatch(points=jnp.asarray(batch["points"]),
                         batch_idx=jnp.asarray(batch["batch_idx"]),
                         valid=jnp.asarray(batch["valid"]))
        return pb, JCameraData.build(*planes)

    jmodel = JFSF(cfg=tiny_av2_config(jcfg))
    pb0, cam0 = jax_inputs(*inputs[0][1:])
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, pb0, cam0, 1, None, None, False,
                              method=lambda m, *a, **kw: m(*a, **kw)), jax.random.key(0))
    jvars = _numpy_variables(shapes)

    def run(v, pb, cam):
        return jmodel.apply(v, jmodel.apply(v, pb, cam, 1, None, None, False), 1,
                            method=JFSF.get_bboxes)

    fwd = jax.jit(run, compiler_options=FAST_COMPILE)
    jdets = [jax.tree_util.tree_map(np.asarray, fwd(jvars, *jax_inputs(b, p)))
             for _, b, p in inputs]

    ckpt = os.path.join(root, "vars.pt")
    torch.save({"model": build_fsf(cfg, device="cpu", jax_variables=jvars).state_dict(),
                "step": 0}, ckpt)
    out = os.path.join(root, "dets.feather")
    res = T.run(cfg, T.parse_args([
        "--model", "fsf", "--eval-protocol", "av2", "--cpu", "--eval", "--info-pkl", info,
        "--data-root", root, "--mask-dir", os.path.join(root, "masks"), "--checkpoint", ckpt,
        "--out", out]))
    return dict(res=res, jdets=jdets, inputs=inputs, out=out)


def test_av2_cli_detections_match_the_jax_fsf(served):
    res = served["res"]
    assert len(res["results"]) == len(FRAMES)
    for r, jdet, (s, _, planes) in zip(res["results"], served["jdets"], served["inputs"]):
        assert r["token"] == f"log_{s['timestamp_ns']}"
        assert planes[0].shape[:2] == (1, 7) and planes[2].shape == (1, 7, 4, 4)
        v = jdet.valid[0]
        assert 0 < v.sum() == len(r["scores"])
        boxes, scores = np.asarray(r["boxes"], np.float32), np.asarray(r["scores"], np.float32)
        jboxes, jscores, jlabels = jdet.boxes[0][v], jdet.scores[0][v], jdet.labels[0][v]

        def close(a, b):
            return np.all(np.abs(a - b) <= BF16_CHAIN_TOL * (1 + np.abs(b)))

        free = list(range(len(scores)))
        for i in range(len(jscores)):       # in score order; near-ties may trade places
            match = [j for j in free if close(scores[j], jscores[i]) and r["labels"][j] ==
                     jlabels[i] and close(boxes[j], jboxes[i])]
            assert match, (r["token"], i, jscores[i], jlabels[i], jboxes[i])
            free.remove(match[0])


def test_av2_cli_feather_records_and_metrics(served):
    res = served["res"]
    back = read_feather(served["out"])
    rows = [row for r in res["results"] for row in boxes_to_av2_rows(
        *T.av2_detections(r)[:3], AV2_CLASS_NAMES, r["log_id"], r["timestamp_ns"])]
    assert len(rows) == len(back["score"]) > 0
    for k in rows[0]:
        assert back[k].tolist() == [row[k] for row in rows], k
    for rec in res["samples"]:
        assert {"read_ms", "collate_ms", "mask_ms", "input_ms", "gpu_ms", "detections",
                "launches"} <= set(rec)
        assert rec["launches"]["gather_conv"] == 0          # the CPU runs plain versions
    assert np.isfinite(res["metrics"]["mAP"]) and np.isfinite(res["metrics"]["CDS"])
