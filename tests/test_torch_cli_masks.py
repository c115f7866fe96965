"""The port's mask tool (``cli/generate_masks.py``) against the JAX package's
``tools/generate_masks.py``, all bitwise: for ``random`` and ``precomputed``
(a box with negative and out-of-canvas coordinates, and one that paints no
pixel) both tools, run in-process from the same flags, write the same file
set, each PNG decoding to the same array and ``anno.json`` equal. For
``htc --tiny --device cpu`` over a tiny tree of PIL-written camera JPEGs,
the written planes equal ``generate_masks.sample_masks`` on PIL's decode of
the same files, the file set and PNGs equal what the JAX tool's painter and
writer make of the same detections, and ``cli/common.load_masks`` reads
the tree back."""
import json
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image

from fullysparsefusion_tpu_torch import generate_masks as gm
from fullysparsefusion_tpu_torch.cli import generate_masks as T
from fullysparsefusion_tpu_torch.cli.common import load_masks
from test_torch_data_nuscenes import jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from torch_offline_fixtures.make_fixtures import smooth_rgb

CAMS = ["CAM_FRONT", "CAM_FRONT_RIGHT"]
IMG_HW = (40, 60)


def run_jax_tool(argv):
    with jax_tools(), pytest.MonkeyPatch.context() as mp:
        import generate_masks as J

        mp.setattr(sys, "argv", ["generate_masks.py"] + argv)
        J.main()


def tree(root):
    """{token: {file: decoded PNG array or anno.json contents}}."""
    out = {}
    for tok in sorted(os.listdir(root)):
        files = {}
        for f in sorted(os.listdir(os.path.join(root, tok))):
            p = os.path.join(root, tok, f)
            if f.endswith(".png"):
                files[f] = np.asarray(Image.open(p))
            else:
                with open(p) as fh:
                    files[f] = json.load(fh)
        out[tok] = files
    return out


def assert_same_tree(a, b):
    assert {t: sorted(f) for t, f in a.items()} == {t: sorted(f) for t, f in b.items()}
    for tok in a:
        for f, v in a[tok].items():
            if f.endswith(".png"):
                w = b[tok][f]
                assert v.dtype == w.dtype and v.shape == w.shape, (tok, f)
                np.testing.assert_array_equal(v, w, err_msg=f"{tok}/{f}")
            else:
                assert v == b[tok][f], (tok, f)


@pytest.mark.parametrize("backend", ["random", "precomputed"])
def test_random_and_precomputed_match_the_jax_tool(tmp_path, backend):
    argv = ["--backend", backend, "--img-h", "60", "--img-w", "90", "--num-cams", "3"]
    if backend == "random":
        argv += ["--tokens", "a", "b", "c"]
    else:
        pre = {"t0": [dict(bbox=[-30, 5, 40, 50], score=0.9, category=2, cam_id=1),
                      dict(bbox=[70, 40, 120, 99], score=0.5, category=2, cam_id=1),
                      dict(bbox=[10, -50, 30, -20], score=0.6, category=4, cam_id=0),
                      dict(bbox=[10, 10, 5, 5], score=0.7, category=3, cam_id=0)],
               "t1": [], "t2": [dict(bbox=[0.5, 1.5, 30.9, 20.2], score=0.1, category=9,
                                     cam_id=2)]}
        path = tmp_path / "pre.json"
        path.write_text(json.dumps(pre))
        argv += ["--tokens", "t0", "t1", "t2", "--precomputed-json", str(path)]
    run_jax_tool(argv + ["--out-dir", str(tmp_path / "jax")])
    T.main(argv + ["--out-dir", str(tmp_path / "port")])
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert_same_tree(got, want)
    if backend == "precomputed":  # the empty box still gets its plane
        assert "0_3.png" in got["t0"] and not got["t0"]["0_3.png"].any()


@pytest.fixture(scope="module")
def jpeg_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("htc_tree"))
    cams = {}
    for i, c in enumerate(CAMS):
        rel = f"samples/{c}/{c}_0.jpg"
        os.makedirs(os.path.join(root, os.path.dirname(rel)))
        Image.fromarray(smooth_rgb(*IMG_HW, seed=i)).save(os.path.join(root, rel), quality=85)
        cams[c] = dict(data_path=rel)
    info = dict(token="tok0", cams=cams, lidar2img=np.eye(4, dtype=np.float32)[None].repeat(2, 0))
    path = os.path.join(root, "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": [info]}, f)
    return root, path, info


def test_htc_backend_writes_sample_masks_of_the_decoded_jpegs(tmp_path, jpeg_tree, monkeypatch):
    root, info_pkl, info = jpeg_tree
    thr = 0.0
    built, pasted = [], []  # the CLI's model; sample_masks' detections
    load_htc, paste = T.load_htc, gm.paste_detections
    monkeypatch.setattr(T, "load_htc", lambda *a: built.append(load_htc(*a)) or built[-1])
    recs = T.main(["--backend", "htc", "--tiny", "--device", "cpu", "--info-pkl", info_pkl,
                   "--data-root", root, "--out-dir", str(tmp_path / "port"),
                   "--score-thr", str(thr), "--num-classes", "10"])
    images = np.stack([np.asarray(Image.open(os.path.join(root, info["cams"][c]["data_path"]))
                                  .convert("RGB")) for c in CAMS])
    monkeypatch.setattr(gm, "paste_detections", lambda *a: pasted.append(paste(*a)) or pasted[-1])
    planes, anno = gm.sample_masks(built[0], images, score_thr=thr)
    got = tree(tmp_path / "port")["tok0"]
    assert recs[0]["planes"] == len(got) - 1 > 0 and recs[0]["instances"] == int(anno[:, 8].sum())
    for c in range(len(CAMS)):
        for k in range(10):
            f = f"{c}_{k}.png"
            np.testing.assert_array_equal(got[f] if f in got else 0, planes[c, :, :, k], err_msg=f)

    # the file set and the PNGs are the JAX tool's painter and writer's on the same detections
    full = []
    for d in pasted[0]:
        m = np.zeros(IMG_HW, bool)
        (yy, xx), sub = d["offset"], d["mask"]
        m[yy:yy + sub.shape[0], xx:xx + sub.shape[1]] = sub
        full.append(dict(d, mask=m))
    with jax_tools():
        import generate_masks as J

        masks, annos = J.paint_sample(full, len(CAMS), 10, IMG_HW)
        J.save_sample(str(tmp_path / "jax"), "tok0", masks, annos)
    assert_same_tree({"tok0": got}, tree(tmp_path / "jax"))

    packed, anno_read, _ = load_masks([dict(info, token="tok0")], str(tmp_path / "port"), 10,
                                      IMG_HW, 1)
    np.testing.assert_array_equal(packed[0] & 0xFF, planes)
    np.testing.assert_array_equal(anno_read[0], anno)
