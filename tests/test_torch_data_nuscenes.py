"""The port's nuScenes reader (``data/nuscenes.py``), its tree writer
(``cli/make_fake_nuscenes.py``) and the host loader library
(``data/native.py``) against the JAX package.

On the JAX package's own fake tree (2 samples, 2 sweeps) both readers give
bitwise equal samples and ``batches()`` in eval form and in train form
(CBGS, GT paste, augmentation: the same generator sequence from the same
seed). The port's writer, from the same seed, writes the same pickle and
``.bin`` files, and masks that decode to the same planes. The host library
is built with ``g++`` here and held to NumPy reads of the same files
(bitwise).
"""
import contextlib
import filecmp
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from fullysparsefusion_tpu.config import FSDConfig
from fullysparsefusion_tpu.data import gt_sampling as jgs
from fullysparsefusion_tpu.data import nuscenes as jn
from fullysparsefusion_tpu_torch.cli import make_fake_nuscenes as tmk
from fullysparsefusion_tpu_torch.data import gt_sampling as tgs
from fullysparsefusion_tpu_torch.data import native
from fullysparsefusion_tpu_torch.data import nuscenes as tn
from fullysparsefusion_tpu_torch.data.png import read_png
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = FSDConfig().class_names


@contextlib.contextmanager
def jax_tools():
    """The JAX package's ``tools/`` importable inside the block. ``sys.path``,
    which the tools also extend when imported, is restored after it, so
    ``tools/train.py`` and ``tools/test.py`` shadow no module later on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(REPO, "tools"))
        yield


def assert_same(a, b, path="sample"):
    """Bitwise equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's fake tree, its GT database (JAX) and the port's
    database over the same samples."""
    root = str(tmp_path_factory.mktemp("nusc"))
    with jax_tools():
        from make_fake_nuscenes import write_dataset

        info, masks = write_dataset(root, n_samples=2, n_sweeps=2, extent=20.0)
    readers = [m.NuScenesReader(info_path=info, data_root=root, class_names=CLASSES,
                                num_sweeps=2, training=False, with_cbgs=False) for m in (jn, tn)]
    counts = []
    for build, reader, name in ((jgs.build_gt_database, readers[0], "db_jax.pkl"),
                                (tgs.build_gt_database, readers[1], "db_port.pkl")):
        samples = [reader.sample(i, augment=False) for i in range(len(reader))]
        counts.append(build(samples, CLASSES, os.path.join(root, name), min_points=3))
    return dict(root=root, info=info, masks=masks, db_counts=counts)


def _readers(tree, **kw):
    return [m.NuScenesReader(info_path=tree["info"], data_root=tree["root"], class_names=CLASSES,
                             **kw) for m in (jn, tn)]


def test_helpers_match_jax(tree):
    with open(tree["info"], "rb") as f:
        info = pickle.load(f)["infos"][0]
    assert tn.NUSC_CLASS_MAP == jn.NUSC_CLASS_MAP
    assert tn.ordered_cam_names(info["cams"]) == jn.ordered_cam_names(info["cams"])
    assert_same(tn.lidar2img_from_cams(info["cams"]), jn.lidar2img_from_cams(info["cams"]))
    path = os.path.join(tree["root"], info["lidar_path"])
    assert_same(tn.load_points_bin(path), jn.load_points_bin(path))
    assert_same(tn.load_points_bin(path, 5, 4), jn.load_points_bin(path, 5, 4))
    vp = os.path.join(tree["root"], "vp.npy")
    np.save(vp, np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32))
    assert_same(tn.load_virtual_points(vp), jn.load_virtual_points(vp))
    for rng_seed in (None, 4):
        a, b = [m.aggregate_sweeps(info, tree["root"], num_sweeps=1,
                                   rng=None if rng_seed is None else np.random.default_rng(rng_seed))
                for m in (jn, tn)]
        assert_same(a, b)


def test_eval_form_samples_and_batches_match_jax(tree):
    jr, tr = _readers(tree, num_sweeps=2, training=False, with_cbgs=False)
    assert len(jr) == len(tr) == 2
    for i in range(len(jr)):
        assert_same(tr.sample(i, augment=False), jr.sample(i, augment=False))
    for (jb, js), (tb, ts) in zip(jr.batches(2, 4096, 16), tr.batches(2, 4096, 16)):
        assert_same(tb, jb)
        assert_same(ts, js)
    assert tr.host_ms["read"] > 0 and tr.host_ms["collate"] > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_train_form_with_cbgs_and_paste_matches_jax(tree, seed):
    """Train form: CBGS indices, the sweep draw, GT paste, augmentation and
    the shuffle come from one generator per reader (and one per sampler)."""
    db = os.path.join(tree["root"], "db_jax.pkl")
    samplers = [m.GTPasteSampler(db_path=db, max_per_class={c: 2 for c in range(10)}, seed=seed)
                for m in (jgs, tgs)]
    jr, tr = [m.NuScenesReader(info_path=tree["info"], data_root=tree["root"],
                               class_names=CLASSES, num_sweeps=1, seed=seed, gt_sampler=s)
              for m, s in zip((jn, tn), samplers)]
    assert_same(tr._indices, jr._indices)
    for epoch in range(2):
        for (jb, js), (tb, ts) in zip(jr.batches(1, 4096, 32), tr.batches(1, 4096, 32)):
            assert_same(tb, jb)
            assert_same(ts, js)
        jr.paste_enabled = tr.paste_enabled = False
    assert tr.host_ms["paste"] > 0


def test_gt_database_matches_jax(tree):
    jc, tc = tree["db_counts"]
    assert tc == jc and sum(tc.values()) > 0
    dbs = []
    for name in ("db_jax.pkl", "db_port.pkl"):
        with open(os.path.join(tree["root"], name), "rb") as f:
            dbs.append(pickle.load(f))
    assert_same(dbs[1], dbs[0])


def test_port_writer_gives_the_jax_tree(tree, tmp_path):
    """The port's writer, same seed: the same pickle and ``.bin`` files, the
    same mask files decoding to the same planes; the JAX reader reads it as
    it reads its own."""
    info, masks = tmk.write_dataset(str(tmp_path), n_samples=2, n_sweeps=2, extent=20.0)
    for path in (info, tree["info"]):
        assert os.path.basename(path) == "fake_infos_train.pkl"
    with open(info, "rb") as f, open(tree["info"], "rb") as g:
        assert_same(pickle.load(f), pickle.load(g))
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        names = sorted(os.listdir(os.path.join(tree["root"], d)))
        assert names == sorted(os.listdir(tmp_path / d)) and names
        for n in names:
            assert filecmp.cmp(os.path.join(tree["root"], d, n), tmp_path / d / n, shallow=False)
    for token in sorted(os.listdir(tree["masks"])):
        names = sorted(os.listdir(os.path.join(tree["masks"], token)))
        assert names == sorted(os.listdir(os.path.join(masks, token)))
        for n in names:
            a, b = os.path.join(tree["masks"], token, n), os.path.join(masks, token, n)
            if n.endswith(".png"):
                assert_same(read_png(b), np.asarray(Image.open(a)))
            else:
                assert open(a).read() == open(b).read()
    readers = [jn.NuScenesReader(info_path=p, data_root=r, class_names=CLASSES, num_sweeps=2,
                                 training=False, with_cbgs=False)
               for p, r in ((tree["info"], tree["root"]), (info, str(tmp_path)))]
    for i in range(2):
        assert_same(readers[1].sample(i, augment=False), readers[0].sample(i, augment=False))


def test_scene_writer_round_trips_a_synthetic_scene(tmp_path):
    """``write_scene``: a synthetic scene's points come back through the
    reader's sweep chain (to f32 rounding, minus remove_close's near-ego
    points and the range filter), its cameras' matrices and masks exactly
    at the written scale's downsample."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.cli.common import load_masks

    sc = S.make_scene_arrays(seed=3, batch_size=1, n_cap=2048, max_gt=16)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], batch_size=1,
                               num_cams=3, img_h=32, img_w=48, max_anno=250, fx=20.0)
    info = tmk.write_scene(str(tmp_path), 0, sc, cam, img_h=32, img_w=48, fx=20.0, scale=2,
                           n_sweeps=3)
    path = tmk.write_infos(str(tmp_path), [info])
    reader = tn.NuScenesReader(info_path=path, data_root=str(tmp_path), class_names=CLASSES,
                               num_sweeps=3, training=False, with_cbgs=False,
                               point_cloud_range=(-20, -20, -5, 20, 20, 5))
    s = reader.sample(0, augment=False)
    for got, want in zip(load_masks([s], str(tmp_path / "masks"), 10, (64, 96), 2),
                         (cam["masks"], cam["anno"], cam["lidar2img"])):
        assert_same(got, want)
    src = sc["points"][sc["valid"]]
    assert len(s["points"]) == len(src)  # nothing near the ego, nothing out of range
    order = np.lexsort(np.round(s["points"][:, :3], 3).T)
    ref = np.lexsort(np.round(src[:, :3], 3).T)
    np.testing.assert_allclose(s["points"][order, :3], src[ref, :3], atol=1e-5)
    np.testing.assert_allclose(np.unique(s["points"][:, 5]), [0.0, 0.05, 0.1, 0.15], atol=1e-6)
    gv = sc["gt_valid"][0]
    np.testing.assert_array_equal(s["gt_labels"], sc["gt_labels"][0][gv])
    np.testing.assert_array_equal(s["gt_boxes"], sc["gt_boxes"][0][gv, :9])


def test_native_library_reads_as_numpy(tmp_path):
    rng = np.random.default_rng(0)
    for j in range(3):
        pts = rng.normal(size=(100 + 17 * j, 5)).astype(np.float32)
        p = str(tmp_path / f"s{j}.bin")
        pts.tofile(p)
        assert_same(native.read_points(p, 5), np.fromfile(p, np.float32).reshape(-1, 5))
        assert_same(native.read_points(p, 5), pts)
    with pytest.raises(FileNotFoundError):
        native.read_points(str(tmp_path / "absent.bin"), 5)


def test_native_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """No fallback: a build that fails raises, with the compiler's output.
    The library's name hashes the compiler's ``--version``, so a library that
    another compiler built is rebuilt, not loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    fakes = []
    for version in ("1.0", "2.0"):
        fake = tmp_path / f"cxx-{version}"
        fake.write_text(f'#!/bin/sh\n[ "$1" = --version ] && {{ echo fake {version}; exit 0; }}\n'
                        "echo broken-compile >&2; exit 1\n")
        fake.chmod(0o755)
        fakes.append(str(fake))
    assert native.library_path(fakes[0]) != native.library_path(fakes[1])
    assert native.library_path(fakes[0]) == native.library_path(fakes[0])
    monkeypatch.setenv("CXX", fakes[0])
    with pytest.raises(RuntimeError, match="broken-compile"):
        native.build()
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false --version failed"):
        native.build()
    monkeypatch.setenv("CXX", "no-such-compiler-fsf")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
