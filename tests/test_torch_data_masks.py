"""The port's PNG codec (``data/png.py``) and offline-mask loaders
(``data/masks.py``) against PIL and the JAX package's ``data/masks.py``.

Everything is held bitwise: decoded pixels against PIL's on PIL-written
files (PIL picks each row's filter), on hand-built files with each of the
five filter types (8 and 16 bits, the zlib stream cut over several IDAT
chunks), and PIL's reading of the port's files; the host library's
unfilter against its NumPy version; the ``load_sample_masks*`` family and
``make_camera_batch`` against the JAX package on the same directories.
"""
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from fullysparsefusion_tpu.data import masks as jm
from fullysparsefusion_tpu_torch.data import masks as tm
from fullysparsefusion_tpu_torch.data import native, png
from test_torch_data_nuscenes import jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def _mask_plane(rng, h=90, w=160, dtype=np.uint8, noise_rows=8):
    """Instance-id rectangles plus a few noisy rows (so that PIL's encoder
    picks more than one filter type)."""
    top = 255 if dtype == np.uint8 else 65535
    img = np.zeros((h, w), dtype)
    for k in range(1, 9):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        img[y:y + rng.integers(3, 30), x:x + rng.integers(3, 60)] = k * (top // 9)
    rows = rng.choice(h, noise_rows, replace=False)
    img[rows] = rng.integers(0, top, (noise_rows, w)).astype(dtype)
    return img


def _pil_png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _pil_read(buf: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(buf)))


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _filter_rows(img: np.ndarray, filters, bpp: int) -> bytes:
    """Row-filter ``img``'s bytes (big-endian samples) with filter type
    ``filters[y % len(filters)]`` per row, as a PNG encoder does."""
    raw = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
    raw = raw.reshape(img.shape[0], -1).astype(np.int64)
    h, stride = raw.shape
    out = np.zeros((h, stride + 1), np.uint8)
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        b = raw[y - 1] if y else np.zeros(stride, np.int64)
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = b
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[y, 0] = ft
        out[y, 1:] = (x - pred) & 0xFF
    return out.tobytes()


def _hand_png(img, filters, idat_parts=1, depth=None, colour=0, interlace=0) -> bytes:
    """A PNG written here: the given row filters, the zlib stream cut into
    ``idat_parts`` IDAT chunks."""
    h, w = img.shape[:2]
    depth = depth or (16 if img.dtype == np.uint16 else 8)
    stream = zlib.compress(_filter_rows(img, filters, depth // 8), 9)
    cuts = np.linspace(0, len(stream), idat_parts + 1).astype(int)
    idat = b"".join(_chunk(b"IDAT", stream[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
    return (png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                         interlace))
            + _chunk(b"tEXt", b"Comment\x00hand-built") + idat + _chunk(b"IEND", b""))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pil_written_planes_decode_bitwise(seed):
    img = _mask_plane(np.random.default_rng(seed), 180, 320)
    buf = _pil_png(img)
    np.testing.assert_array_equal(png.decode(buf), _pil_read(buf))
    np.testing.assert_array_equal(png.decode(buf), img)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_each_filter_type_decodes_bitwise(filters, dtype):
    img = _mask_plane(np.random.default_rng(7), 40, 70, dtype)
    buf = _hand_png(img, filters, idat_parts=3)
    got = png.decode(buf)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, _pil_read(buf))
    np.testing.assert_array_equal(got, img)


def test_pil_written_16_bit_decodes_bitwise():
    img = _mask_plane(np.random.default_rng(3), 64, 96, np.uint16)
    buf = _pil_png(img)
    assert _pil_read(buf).dtype == np.uint16
    np.testing.assert_array_equal(png.decode(buf), _pil_read(buf))


@pytest.mark.parametrize("bpp", [1, 2])
def test_native_unfilter_matches_numpy(bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 37, 50 * bpp
    data = rng.integers(0, 256, (h, stride + 1)).astype(np.uint8)
    data[:, 0] = np.arange(h) % 5
    np.testing.assert_array_equal(native.png_unfilter(data.ravel(), h, stride, bpp),
                                  png.unfilter_plain(data.ravel(), h, stride, bpp))


def test_port_written_files_read_back_in_pil(tmp_path):
    img = _mask_plane(np.random.default_rng(5), 90, 160)
    path = str(tmp_path / "m.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError):
        png.encode(img.astype(np.uint16))


@pytest.mark.parametrize("case", ["rgb", "palette", "1_bit", "interlaced", "bad_crc",
                                  "bad_filter", "not_png"])
def test_unsupported_files_raise_naming_the_file(case, tmp_path):
    img = _mask_plane(np.random.default_rng(0), 20, 30)
    if case == "rgb":
        buf = _pil_png(np.stack([img] * 3, -1))
    elif case == "palette":
        out = io.BytesIO()
        Image.fromarray(img).convert("P").save(out, format="PNG")
        buf = out.getvalue()
    elif case == "1_bit":
        buf = _hand_png(img, (0,), depth=1)
    elif case == "interlaced":
        buf = _hand_png(img, (0,), interlace=1)
    elif case == "bad_crc":
        buf = bytearray(_hand_png(img, (0,)))
        buf[20] ^= 1  # inside IHDR's data
        buf = bytes(buf)
    elif case == "bad_filter":
        buf = _hand_png(img, (5,))
    else:
        buf = b"GIF89a" + bytes(40)
    path = tmp_path / f"{case}.png"
    path.write_bytes(buf)
    with pytest.raises(ValueError, match=case):
        png.read_png(str(path))


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def mask_tree(tmp_path_factory):
    """The JAX package's fake nuScenes tree (PIL-written masks)."""
    root = tmp_path_factory.mktemp("nusc")
    with jax_tools():
        from make_fake_nuscenes import write_dataset

        return write_dataset(str(root), n_samples=2, n_sweeps=1)[1]


@pytest.mark.parametrize("downsample", [1, 2])
def test_load_sample_masks_matches_jax(mask_tree, downsample):
    for token in sorted(os.listdir(mask_tree)) + ["missing_token"]:
        got = tm.load_sample_masks(mask_tree, token, 6, 10, (128, 224), downsample=downsample)
        want = jm.load_sample_masks(mask_tree, token, 6, 10, (128, 224), downsample=downsample)
        for g, w in zip(got, want):
            _assert_same(g, w)
    assert got[0].any() or token == "missing_token"


def test_save_sample_reads_back_as_the_mask_tool_wrote(mask_tree, tmp_path):
    """The port's ``save_sample`` writes a tree that both packages load as
    the mask tool's (PIL) tree."""
    token = sorted(os.listdir(mask_tree))[0]
    sdir = os.path.join(mask_tree, token)
    with open(os.path.join(sdir, "anno.json")) as f:
        annos = json.load(f)
    planes = {tuple(int(x) for x in f[:-4].split("_")): np.asarray(Image.open(os.path.join(sdir, f)))
              for f in os.listdir(sdir) if f.endswith(".png")}
    tm.save_sample(str(tmp_path), token, planes, annos)
    assert sorted(os.listdir(tmp_path / token)) == sorted(os.listdir(sdir))
    for load in (tm.load_sample_masks, jm.load_sample_masks):
        for g, w in zip(load(str(tmp_path), token, 6, 10, (128, 224)),
                        jm.load_sample_masks(mask_tree, token, 6, 10, (128, 224))):
            _assert_same(g, w)


def _single_channel_dir(root):
    sdir = root / "tok"
    sdir.mkdir()
    h, w = 40, 60
    rng = np.random.default_rng(11)
    annos = []
    for cam in range(3):
        shape = (h // 2, w // 2) if cam == 0 else (h, w)  # the front camera at another size
        m = np.zeros(shape, np.uint8)
        for j in range(3):
            oid = cam * 3 + j
            y, x = rng.integers(0, shape[0] - 6), rng.integers(0, shape[1] - 6)
            m[y:y + 6, x:x + 6] = oid + 1
            annos.append(dict(bbox=[float(x), float(y), float(x + 6), float(y + 6)],
                              score=float(rng.uniform(0.3, 1.0)), category=int(rng.integers(0, 4)),
                              cam_id=cam, obj_id=oid))
        Image.fromarray(m).save(sdir / f"{cam}.png")
    (sdir / "anno.json").write_text(json.dumps({"annos": annos}))
    return (h, w)


@pytest.mark.parametrize("downsample", [1, 2])
def test_load_sample_masks_single_channel_matches_jax(tmp_path, downsample):
    hw = _single_channel_dir(tmp_path)
    kw = dict(front_cam=0, front_hw=(hw[0] // 2, hw[1] // 2), downsample=downsample)
    for g, w in zip(tm.load_sample_masks_single_channel(str(tmp_path), "tok", 3, 4, hw, **kw),
                    jm.load_sample_masks_single_channel(str(tmp_path), "tok", 3, 4, hw, **kw)):
        _assert_same(g, w)


@pytest.mark.parametrize("downsample", [1, 2])
def test_load_sample_masks_waymo_matches_jax(tmp_path, downsample):
    sdir = tmp_path / "seg0"
    sdir.mkdir()
    h, w = 64, 96
    m0 = np.zeros((h, w), np.uint8)
    m0[10:20, 30:50] = 1
    Image.fromarray(m0).save(sdir / "0_vehicle.png")
    m3 = np.zeros((h // 2, w // 2), np.uint8)  # a back camera at half size
    m3[5:10, 15:25] = 2
    Image.fromarray(m3).save(sdir / "3_pedestrian.png")
    m4 = np.zeros((h // 2, w // 2), np.uint8)
    m4[2:6, 3:9] = 3
    Image.fromarray(m4).save(sdir / "4_2.png")  # the index-named fallback
    anno = {
        "0": {"vehicle": [{"bbox": [30, 10, 50, 20], "score": 0.9}]},
        "3": {"pedestrian": [{"bbox": [15, 5, 25, 10], "score": 0.8}]},
        "4": {"cyclist": [{"bbox": [3, 2, 9, 6], "score": 0.7}]},
    }
    (sdir / "anno.json").write_text(json.dumps(anno))
    l2i = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    got = tm.load_sample_masks_waymo(str(tmp_path), "seg0", l2i, img_hw=(h, w),
                                     downsample=downsample)
    want = jm.load_sample_masks_waymo(str(tmp_path), "seg0", l2i, img_hw=(h, w),
                                      downsample=downsample)
    for g, w_ in zip(got, want):
        _assert_same(g, w_)
    assert got[0][3].any() and got[0][4].any()


def test_anno_helpers_and_camera_batch_match_jax():
    rng = np.random.default_rng(2)
    raw = {"1": {"car": [{"bbox": [1, 2, 3, 4], "score": 0.4}, {"bbox": [5, 6, 7, 8],
                                                                 "score": 0.9}]},
           "0": {"truck": [{"bbox": [0, 0, 2, 2], "score": 0.6}]}}
    assert tm._flatten_nested_anno(raw, ("car", "truck")) == \
        jm._flatten_nested_anno(raw, ("car", "truck"))
    img = rng.integers(0, 9, (30, 50)).astype(np.uint8)
    for hw in ((60, 100), (17, 33), (30, 50)):
        _assert_same(tm._nearest_resize(img, hw), jm._nearest_resize(img, hw))
    rows = [dict(bbox=[1.5, 2, 3, 4], score=0.25 * k, category=k, cam_id=k % 2, obj_id=4 - k)
            for k in range(5)]
    _assert_same(tm.reorg_anno(rows, 8), jm.reorg_anno(rows, 8))
    masks = [rng.integers(0, 6, (2, 8, 9, 3)).astype(np.uint8) for _ in range(2)]
    annos = [jm.reorg_anno(rows, 8)] * 2
    l2i = [rng.normal(size=(2, 4, 4)).astype(np.float32) for _ in range(2)]
    for g, w in zip(tm.make_camera_batch(masks, annos, l2i),
                    jm.make_camera_batch(masks, annos, l2i)):
        _assert_same(g, w)
    _assert_same(tm.pack_mask_scores(np.stack(masks), np.stack(annos)),
                 jm.pack_mask_scores(np.stack(masks), np.stack(annos)))
