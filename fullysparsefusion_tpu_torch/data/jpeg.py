"""Baseline JPEG decoding for the offline mask tool (in place of PIL, which
the port does not depend on), and one nuScenes sample's camera images.

:func:`decode_jpeg` runs the host library's decoder (``csrc/jpeg.cpp``,
through ``native.jpeg_decode``): sequential Huffman JPEG (SOF0 / SOF1),
8-bit, one or three components, 4:4:4, 4:2:2, 4:2:0 or 4:4:0, any size,
restart intervals. Its output is bitwise what
``np.asarray(PIL.Image.open(path).convert("RGB"))`` gives with PIL's
libjpeg-turbo: the accurate integer IDCT, the library's fancy upsampling,
its fixed-point YCbCr → RGB. Progressive, arithmetic-coded, 12-bit, CMYK,
Adobe transform 0 and non-interleaved scans raise ``ValueError`` naming
what was met.
"""
from __future__ import annotations

import os
from typing import Dict, Union

import numpy as np

from . import native
from .nuscenes import ordered_cam_names


def decode_jpeg(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A JPEG file (path) or its bytes → ``[H, W, 3]`` uint8 RGB; a
    grayscale JPEG has its plane repeated, as ``convert("RGB")`` does."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data, name = bytes(src), "JPEG bytes"
    else:
        with open(src, "rb") as f:
            data = f.read()
        name = os.fspath(src)
    try:
        img = native.jpeg_decode(data)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def load_sample_images(info: Dict, data_root: str) -> np.ndarray:
    """One mmdet3d info record's cameras → ``[cams, H, W, 3]`` uint8, in
    ``data/nuscenes.ordered_cam_names`` order (the order of the reader's
    ``lidar2img`` rows), each relative ``data_path`` joined to
    ``data_root`` (the mask tool's ``load_sample_images``). Cameras of
    unequal size raise: the HTC batch stacks them."""
    cams = info.get("cams", {})
    names = ordered_cam_names(cams)
    if not names:
        raise ValueError(f"sample {info.get('token', '')!r} has no cameras")
    images = []
    for c in names:
        path = cams[c]["data_path"]
        if not os.path.isabs(path):
            path = os.path.join(data_root, path)
        images.append(decode_jpeg(path))
    shapes = {im.shape for im in images}
    if len(shapes) != 1:
        raise ValueError(f"sample {info.get('token', '')!r}: cameras of unequal size "
                         f"{dict(zip(names, (im.shape[:2] for im in images)))}")
    return np.stack(images)
