"""Make the offline tools' fixtures (JPEGs and Feather files) and their
manifest, with PIL and pyarrow, from fixed seeds:

    python tests/torch_offline_fixtures/make_fixtures.py

* small JPEGs covering the port's decoder (``data/jpeg.py``): PIL's 4:4:4,
  4:2:2 and 4:2:0, grayscale, optimized Huffman tables with restart
  markers, 1 x 1, quality 50 to 100, and from :func:`encode_baseline`
  (below) 4:4:0 and an extended-sequential (SOF1) file with 16-bit
  quantization tables; one progressive JPEG, which the decoder must refuse;
* six 900 x 1,600 camera JPEGs (4:2:0, quality 75) of a smooth synthetic
  street scene, one per nuScenes camera;
* small Feather V2 files of AV2's sweep columns plus strings, a dictionary,
  bools and float nulls: uncompressed, LZ4, LZ4 in batches of 300 rows,
  and ZSTD (which the port's reader must refuse);
* ``manifest.json``: per JPEG the shape and sha256 of
  ``np.asarray(Image.open(p).convert("RGB"))``, per Feather file the rows
  and per column the dtype and :func:`column_digest` of
  ``pd.read_feather``'s values.

:func:`encode_baseline` is a small baseline JPEG encoder in NumPy (any
sampling factors, interleaved or one scan per component, restart
intervals, SOF0 or SOF1, optional JFIF / Adobe markers), for the cases PIL
cannot write; the tests import it.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK", "CAM_BACK_LEFT",
           "CAM_BACK_RIGHT")
CAMERA_HW = (900, 1600)

# zigzag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def image_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def column_digest(values: np.ndarray) -> str:
    """sha256 of a column: its bytes for numbers and bools, its strings
    joined by NUL for text."""
    values = np.asarray(values)
    if values.dtype == object:
        return hashlib.sha256("\0".join(values).encode()).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(values).tobytes()).hexdigest()


# -- a baseline JPEG encoder -------------------------------------------------------


def _dct_matrix() -> np.ndarray:
    k, n = np.mgrid[0:8, 0:8]
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c * np.cos((2 * n + 1) * k * np.pi / 16)


# fixed-length canonical Huffman tables: DC categories 0-11 in 4 bits, the
# 162 baseline AC symbols in 8 bits (no code is all ones)
_DC_SYMS = list(range(12))
_AC_SYMS = sorted([0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)])


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            self.n -= 8
            self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int) -> Tuple[int, int]:
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_baseline(rgb: np.ndarray, sampling: Sequence[Tuple[int, int]] = ((1, 1),) * 3,
                    quality_step: int = 2, restart: int = 0, interleaved: bool = True,
                    sof: int = 0xC0, precision16: bool = False, jfif: bool = True,
                    adobe_transform: Optional[int] = None,
                    ids: Sequence[int] = (1, 2, 3)) -> bytes:
    """``rgb`` ([H, W, 3], or [H, W] for one component) as a sequential
    Huffman JPEG. ``sampling`` gives each component's (h, v) factors;
    ``interleaved=False`` writes one scan per component; ``restart`` MCUs
    per restart interval; ``sof`` 0xC0 (baseline) or 0xC1 (extended, with
    16-bit quantization tables when ``precision16``)."""
    rgb = np.asarray(rgb, np.float64)
    if rgb.ndim == 2:
        planes = [rgb]
    else:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    ncomp = len(planes)
    sampling = list(sampling)[:ncomp]
    h, w = planes[0].shape
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    u, v = np.mgrid[0:8, 0:8]
    qtabs = [1 + quality_step * (u + v), 2 + quality_step * 2 * (u + v)]
    if precision16:
        qtabs = [q * 40 for q in qtabs]  # past 255: 16-bit entries
    C = _dct_matrix()
    comps = []
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // hs, vmax // vs
        dw, dh = -(-w * hs // hmax), -(-h * vs // vmax)
        padded = np.pad(plane, ((0, dh * fy - h), (0, dw * fx - w)), mode="edge")
        sub = padded.reshape(dh, fy, dw, fx).mean(axis=(1, 3))
        sub = np.clip(np.round(sub), 0, 255)
        bw, bh = (mx * hs, my * vs) if interleaved and ncomp > 1 else (-(-dw // 8), -(-dh // 8))
        bw, bh = max(bw, mx * hs), max(bh, my * vs)
        full = np.pad(sub, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        q = qtabs[min(ci, 1)]
        coef = np.round(C @ blocks @ C.T / q).astype(np.int64)
        comps.append(dict(coef=coef, hs=hs, vs=vs, dw=dw, dh=dh, tq=min(ci, 1)))

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    for t in range(min(ncomp, 2)):
        zz = qtabs[t].reshape(-1)[ZIGZAG]
        out += _segment(0xDB, bytes([(0x10 if precision16 else 0) | t])
                        + (struct.pack(">64H", *zz) if precision16 else bytes(zz.astype(np.uint8))))
    out += _segment(sof, struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
        bytes([ids[i], (c["hs"] << 4) | c["vs"], c["tq"]]) for i, c in enumerate(comps)))
    for cls, syms, length in ((0, _DC_SYMS, 4), (1, _AC_SYMS, 8)):
        counts = [0] * 16
        counts[length - 1] = len(syms)
        out += _segment(0xC4, bytes([cls << 4]) + bytes(counts) + bytes(syms))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))

    def code_block(bits: _Bits, c: dict, by: int, bx: int):
        zz = c["coef"][by, bx].reshape(-1)[ZIGZAG]
        size, val = _magnitude(int(zz[0]) - c["pred"])
        c["pred"] = int(zz[0])
        bits.put(_DC_SYMS.index(size), 4)
        bits.put(val, size)
        run = 0
        for k in range(1, 64):
            a = int(zz[k])
            if a == 0:
                run += 1
                continue
            while run > 15:
                bits.put(_AC_SYMS.index(0xF0), 8)
                run -= 16
            size, val = _magnitude(a)
            bits.put(_AC_SYMS.index((run << 4) | size), 8)
            bits.put(val, size)
            run = 0
        if run:
            bits.put(_AC_SYMS.index(0x00), 8)

    def scan(members, units):
        out.extend(_segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[i], 0x00]) for i in members) + b"\x00\x3f\x00"))
        bits = _Bits()
        for c in comps:
            c["pred"] = 0
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                for c in comps:
                    c["pred"] = 0
            for ci, by, bx in unit:
                code_block(bits, comps[ci], by, bx)
        bits.flush()
        out.extend(bits.out)

    if interleaved and ncomp > 1:
        scan(range(ncomp), [[(ci, my_ * c["vs"] + yy, mx_ * c["hs"] + xx)
                             for ci, c in enumerate(comps)
                             for yy in range(c["vs"]) for xx in range(c["hs"])]
                            for my_ in range(my) for mx_ in range(mx)])
    else:
        for ci, c in enumerate(comps):
            scan([ci], [[(ci, by, bx)] for by in range(-(-c["dh"] // 8))
                        for bx in range(-(-c["dw"] // 8))])
    out += b"\xff\xd9"
    return bytes(out)


# -- images ------------------------------------------------------------------------


def smooth_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth [h, w, 3] uint8 test pattern (sines and a gradient)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([128 + 90 * np.sin(x / (3 + 2 * c) + ph[c]) * np.cos(y / (4 + c) - ph[c])
                    + 30 * (y / max(h, 1) - 0.5) for c in range(3)], -1)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def camera_scene(cam: int, h: int = CAMERA_HW[0], w: int = CAMERA_HW[1]) -> np.ndarray:
    """A smooth street scene for camera ``cam``: sky, road with lane marks
    in perspective, and soft-edged vehicles and pedestrians."""
    rng = np.random.default_rng(100 + cam)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    horizon = h * (0.42 + 0.04 * rng.uniform(-1, 1))
    sky = np.stack([110 + 60 * y / h, 150 + 50 * y / h, 235 - 20 * y / h], -1)
    ground = np.stack([95 + 40 * (y - horizon) / h] * 3, -1) + np.array([5, 3, 0])
    img = np.where((y < horizon)[..., None], sky, ground)
    cx = w / 2 + rng.uniform(-150, 150)
    for lane in (-1.0, 1.0, -3.0, 3.0):
        xl = cx + lane * 120 * (y - horizon) / (h - horizon)
        mark = (y > horizon) & (np.abs(x - xl) < 1 + 5 * (y - horizon) / h) & \
               (np.sin(np.sqrt(np.maximum(y - horizon, 0)) * 3.0) > 0)
        img[mark] = (225, 225, 210)
    for _ in range(7):
        bw, bh = rng.uniform(60, 260), rng.uniform(40, 180)
        x0, y0 = rng.uniform(0, w - bw), horizon - bh * 0.3 + rng.uniform(0, h - horizon - bh)
        colour = rng.uniform(20, 230, 3)
        d = np.maximum(np.maximum(x0 - x, x - x0 - bw), np.maximum(y0 - y, y - y0 - bh))
        a = np.clip(0.5 - d / 6.0, 0, 1)[..., None]
        img = img * (1 - a) + a * (colour * (0.8 + 0.2 * (y - y0)[..., None] / bh))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _small_jpegs() -> Dict[str, bytes]:
    from PIL import Image

    def pil(arr, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", **kw)
        return buf.getvalue()

    return {
        "rgb_444_q95_17x33.jpg": pil(smooth_rgb(17, 33, 1), quality=95, subsampling=0),
        "rgb_422_q75_7x13.jpg": pil(smooth_rgb(7, 13, 2), quality=75, subsampling=1),
        "rgb_420_q50_1x1.jpg": pil(smooth_rgb(1, 1, 3), quality=50, subsampling=2),
        "rgb_420_q100_41x57.jpg": pil(smooth_rgb(41, 57, 4), quality=100, subsampling=2),
        "rgb_420_optimized_restart_33x47.jpg": pil(smooth_rgb(33, 47, 5), quality=85,
                                                    subsampling=2, optimize=True,
                                                    restart_marker_blocks=2),
        "rgb_422_restart_rows_18x70.jpg": pil(smooth_rgb(18, 70, 6), quality=90, subsampling=1,
                                              restart_marker_rows=1),
        "gray_q90_13x7.jpg": pil(smooth_rgb(13, 7, 7)[..., 0], quality=90),
        "gray_optimized_restart_24x40.jpg": pil(smooth_rgb(24, 40, 8)[..., 1], quality=70,
                                                optimize=True, restart_marker_blocks=3),
        "rgb_440_19x21.jpg": encode_baseline(smooth_rgb(19, 21, 9), ((1, 2), (1, 1), (1, 1))),
        "rgb_420_sof1_q16_restart_23x29.jpg": encode_baseline(
            smooth_rgb(23, 29, 10), ((2, 2), (1, 1), (1, 1)), sof=0xC1, precision16=True,
            restart=2),
        "progressive_20x30.jpg": pil(smooth_rgb(20, 30, 11), quality=80, progressive=True),
    }


# -- feathers ------------------------------------------------------------------------


def feather_table(n: int, seed: int):
    """AV2's sweep columns plus a string, a dictionary, bools and a float
    column with nulls, ``n`` rows."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    return pa.table({
        "x": pa.array((rng.normal(size=n) * 40).astype(np.float16)),
        "y": pa.array((rng.normal(size=n) * 40).astype(np.float16)),
        "z": pa.array(rng.normal(size=n).astype(np.float16)),
        "intensity": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "laser_number": pa.array(rng.integers(0, 64, n).astype(np.uint8)),
        "offset_ns": pa.array(rng.integers(0, 10**8, n).astype(np.int32)),
        "timestamp_ns": pa.array(rng.integers(0, 2**62, n).astype(np.int64)),
        "score": pa.array(rng.random(n).astype(np.float32)),
        "category": pa.array([("REGULAR_VEHICLE", "PEDESTRIAN", "BUS")[i % 3] for i in range(n)]),
        "log_id": pa.array([f"log{i % 5}" for i in range(n)]).dictionary_encode(),
        "flag": pa.array(rng.random(n) > 0.5),
        "maybe": pa.array(np.where(rng.random(n) > 0.8, np.nan, f), from_pandas=True),
    })


FEATHERS = {
    "sweep_uncompressed.feather": dict(rows=500, compression="uncompressed"),
    "sweep_lz4.feather": dict(rows=700, compression="lz4"),
    "sweep_lz4_batches.feather": dict(rows=1000, compression="lz4", chunksize=300),
    "sweep_zstd.feather": dict(rows=200, compression="zstd"),
}


def pandas_columns(path: str) -> Dict[str, np.ndarray]:
    """``pd.read_feather``'s columns as NumPy (categoricals and strings as
    object arrays of str)."""
    import pandas as pd

    df = pd.read_feather(path)
    out = {}
    for k in df.columns:
        s = df[k]
        if isinstance(s.dtype, pd.CategoricalDtype) or not isinstance(s.dtype, np.dtype):
            out[k] = np.asarray(s.astype(object), object)
        else:
            out[k] = s.to_numpy()
    return out


def main():
    from PIL import Image
    import pyarrow.feather as pf

    manifest = {"jpeg": {}, "cameras": {}, "feather": {}}
    for name, data in _small_jpegs().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        entry = {"shape": list(img.shape), "sha256": image_digest(img)}
        if name.startswith("progressive"):
            entry["port_raises"] = "progressive"
        manifest["jpeg"][name] = entry
    for i, cam in enumerate(CAMERAS):
        name = f"{cam}.jpg"
        path = os.path.join(HERE, name)
        Image.fromarray(camera_scene(i)).save(path, "JPEG", quality=75, subsampling=2)
        img = np.asarray(Image.open(path).convert("RGB"))
        manifest["cameras"][name] = {"shape": list(img.shape), "sha256": image_digest(img)}
    for i, (name, spec) in enumerate(FEATHERS.items()):
        path = os.path.join(HERE, name)
        kw = {k: v for k, v in spec.items() if k != "rows"}
        pf.write_feather(feather_table(spec["rows"], i), path, **kw)
        entry = {"rows": spec["rows"], **kw}
        if spec["compression"] == "zstd":
            entry["port_raises"] = "ZSTD"
        else:
            cols = pandas_columns(path)
            entry["columns"] = {k: {"dtype": str(v.dtype), "sha256": column_digest(v)}
                                for k, v in cols.items()}
        manifest["feather"][name] = entry
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    sizes = sum(os.path.getsize(os.path.join(HERE, f)) for f in os.listdir(HERE))
    print(f"wrote {len(os.listdir(HERE))} files, {sizes} bytes")


if __name__ == "__main__":
    main()
