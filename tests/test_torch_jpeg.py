"""The port's JPEG decoder (``data/jpeg.py`` over ``csrc/jpeg.cpp``) against
PIL: every decoded image bitwise ``np.asarray(Image.open(p).convert("RGB"))``
(no tolerance). JPEGs that PIL writes (RGB at 4:4:4, 4:2:2 and 4:2:0,
grayscale; qualities 50 to 100; optimized Huffman tables; restart markers;
sizes down to 1 x 1 and one 900 x 1,600), JPEGs from the fixtures' own
encoder for what PIL cannot write (4:4:0, SOF1 with 16-bit quantization
tables), the committed fixtures against their manifest, and the kinds the
decoder does not read, each raising ``ValueError`` that names it."""
import io
import itertools
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from fullysparsefusion_tpu_torch.data.jpeg import decode_jpeg, load_sample_images
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from torch_offline_fixtures.make_fixtures import (HERE, encode_baseline, image_digest,
                                                  smooth_rgb)

SIZES = ((1, 1), (7, 13), (17, 33), (2, 3))


def pil_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_bitwise(data: bytes, what):
    got, want = decode_jpeg(data), pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("mode,subsampling", [("RGB", 0), ("RGB", 1), ("RGB", 2), ("L", None)])
def test_pil_jpegs_decode_bitwise(mode, subsampling, quality):
    """Every size x optimize x restart interval of one (mode, sampling,
    quality) cell."""
    for n, ((h, w), optimize, restart) in enumerate(
            itertools.product(SIZES, (False, True), (0, 2))):
        img = smooth_rgb(h, w, n + quality)
        kw = dict(quality=quality, optimize=optimize)
        if mode == "L":
            img = img[..., 1]
        else:
            kw["subsampling"] = subsampling
        if restart:
            kw["restart_marker_blocks"] = restart
        assert_bitwise(pil_jpeg(img, **kw), (h, w, optimize, restart))


@pytest.mark.parametrize("subsampling", [0, 2])
def test_camera_sized_jpeg_decodes_bitwise(subsampling):
    rng = np.random.default_rng(subsampling)
    img = np.clip(smooth_rgb(900, 1600, 3).astype(np.int16)
                  + rng.integers(-20, 21, (900, 1600, 3)), 0, 255).astype(np.uint8)
    assert_bitwise(pil_jpeg(img, quality=75, subsampling=subsampling), subsampling)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (17, 33), (40, 24)])
def test_encoder_samplings_decode_bitwise(h, w):
    """4:4:0 (h1v2), which PIL does not write, plus 4:2:0 and 4:2:2 with
    restart intervals, and SOF1 with 16-bit quantization tables."""
    img = smooth_rgb(h, w, h * w)
    for sampling, kw in ((((1, 2), (1, 1), (1, 1)), {}),
                         (((1, 2), (1, 1), (1, 1)), dict(restart=1)),
                         (((2, 2), (1, 1), (1, 1)), dict(sof=0xC1, precision16=True)),
                         (((2, 1), (1, 1), (1, 1)), dict(restart=3, quality_step=5))):
        assert_bitwise(encode_baseline(img, sampling, **kw), (sampling, kw))
    assert_bitwise(encode_baseline(img[..., 0], ((1, 1),), restart=2), "grayscale")


def test_committed_fixtures_match_manifest():
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    for group in ("jpeg", "cameras"):
        for name, entry in manifest[group].items():
            path = os.path.join(HERE, name)
            if "port_raises" in entry:
                with pytest.raises(ValueError, match=entry["port_raises"]):
                    decode_jpeg(path)
                continue
            img = decode_jpeg(path)
            assert list(img.shape) == entry["shape"] and image_digest(img) == entry["sha256"], name
            with open(path, "rb") as f:
                np.testing.assert_array_equal(decode_jpeg(f.read()), img)
    assert len(manifest["cameras"]) == 6 and len(manifest["jpeg"]) >= 10


def _header_only(sof: int, precision: int = 8, comps: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, comps) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(comps))
    return b"\xff\xd8" + struct.pack(">BBH", 0xFF, sof, len(body) + 2) + body + b"\xff\xd9"


def _unsupported():
    img = smooth_rgb(16, 16, 0)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    return {
        "progressive": pil_jpeg(img, progressive=True),
        "arithmetic": _header_only(0xC9),
        "12-bit": _header_only(0xC1, precision=12),
        "CMYK": cmyk.getvalue(),
        "Adobe transform=0": encode_baseline(img, jfif=False, adobe_transform=0),
        "not interleaved": encode_baseline(img, ((2, 2), (1, 1), (1, 1)), interleaved=False),
    }


@pytest.mark.parametrize("kind", list(_unsupported()))
def test_unsupported_kinds_raise_naming_them(kind):
    with pytest.raises(ValueError, match=kind):
        decode_jpeg(_unsupported()[kind])


def test_load_sample_images_orders_cameras_and_refuses_unequal_sizes(tmp_path):
    names = ["CAM_BACK", "CAM_FRONT", "CAM_EXTRA"]  # canonical names first, extras sorted
    cams = {}
    for i, c in enumerate(names):
        p = tmp_path / f"{c}.jpg"
        p.write_bytes(pil_jpeg(smooth_rgb(9, 11, i), quality=90))
        cams[c] = dict(data_path=p.name if i else str(p))
    images = load_sample_images(dict(token="t", cams=cams), str(tmp_path))
    assert images.shape == (3, 9, 11, 3)
    for k, c in enumerate(["CAM_FRONT", "CAM_BACK", "CAM_EXTRA"]):
        np.testing.assert_array_equal(images[k], pil_rgb((tmp_path / f"{c}.jpg").read_bytes()))
    (tmp_path / "CAM_BACK.jpg").write_bytes(pil_jpeg(smooth_rgb(9, 12, 0), quality=90))
    with pytest.raises(ValueError, match="unequal size"):
        load_sample_images(dict(token="t", cams=cams), str(tmp_path))
