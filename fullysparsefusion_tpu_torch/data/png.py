"""Grayscale PNG codec in NumPy + ``zlib``, for the offline mask files (in
place of PIL / cv2, which the port does not depend on).

Reading takes non-interlaced grayscale PNGs (colour type 0) at 8 and 16
bits, over any number of IDAT chunks, with every chunk's CRC checked; the
five row filters (None, Sub, Up, Average, Paeth) are undone by the host
library (``native.png_unfilter``), whose plain counterpart is
:func:`unfilter_plain`. Anything else raises ``ValueError`` naming the file.
Writing gives 8-bit grayscale, every row filter 0, one zlib stream.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(buf: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 12 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(buf):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def decode(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes: ``[H, W]`` uint8 at 8 bits, uint16
    at 16 (native byte order)."""
    if buf[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {colour} at {depth} bits; only 8- and 16-bit "
                         "grayscale are read")
    if interlace != 0 or compression != 0 or filter_method != 0:
        raise ValueError(f"{path}: interlace {interlace}, compression {compression}, filter "
                         f"method {filter_method}; only 0, 0, 0 are read")
    bpp = depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: {e}") from e
    try:
        rows = native.png_unfilter(raw, h, w * bpp, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    if bpp == 1:
        return rows
    return rows.view(">u2").astype(np.uint16)


def read_png(path: str) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def unfilter_plain(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """NumPy version of ``native.png_unfilter``: Sub and Up vectorised, Average
    and Paeth byte by byte."""
    data = np.asarray(data, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"{data.size} filtered bytes for {h} rows of {stride}")
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ft == 0:
            cur = src
        elif ft == 1:
            cur = np.zeros(stride, np.int64)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(src[c::bpp]) & 0xFF
        elif ft == 2:
            cur = (src + prev) & 0xFF
        elif ft in (3, 4):
            cur = np.zeros(stride, np.int64)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of a 2-D uint8 array: filter 0 on every row,
    one zlib stream in one IDAT chunk."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"encode takes a 2-D uint8 array, not {img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = img
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """:func:`encode` ``img`` into the file at ``path``."""
    with open(path, "wb") as f:
        f.write(encode(img))
