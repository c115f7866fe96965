"""ctypes bindings of the host library (the port's counterpart of the JAX
package's ``data/native.py``, plus the decoders that the JAX package takes
from PIL and pyarrow).

One library is built from every host source: ``csrc/pointloader.cpp`` (the
``.bin`` reads and the PNG row unfilter of ``data/png.py``),
``csrc/jpeg.cpp`` (the baseline JPEG decoder of ``data/jpeg.py``) and
``csrc/lz4.cpp`` (the LZ4 frames of ``data/feather.py``). The host compiler
(``$CXX``, else ``g++``) compiles it at first use into ``build/torch_host/``
at the repository root, named by a hash of the sources, the flags, the
compiler's ``--version`` and the machine, the way ``kernels.py`` builds the
CUDA sources: a library built on another host, by another compiler or from
other sources is rebuilt, never loaded. There is no NumPy fallback: a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", f)
                for f in ("pointloader.cpp", "jpeg.cpp", "lz4.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_host")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"{cxx} not found: the host loader library cannot be built")
    return cxx


def library_path(cxx: str) -> str:
    """The library's file for compiler ``cxx`` on this machine."""
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    if version.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{version.stdout}{version.stderr}")
    h = hashlib.sha1(repr((_FLAGS, version.stdout, platform.machine())).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfsfhost-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is built already; returns its path.
    Raises with the compiler's output if the build fails."""
    cxx = _compiler()
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, *SOURCES], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {', '.join(SOURCES)}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    lib.fsf_file_num_floats.restype = ctypes.c_longlong
    lib.fsf_file_num_floats.argtypes = [ctypes.c_char_p]
    lib.fsf_read_floats.restype = ctypes.c_longlong
    lib.fsf_read_floats.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_longlong]
    lib.fsf_png_unfilter.restype = ctypes.c_int
    lib.fsf_png_unfilter.argtypes = [_U8P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     _U8P]
    lib.fsf_jpeg_info.restype = ctypes.c_int
    lib.fsf_jpeg_info.argtypes = [_U8P, ctypes.c_longlong, _IP, _IP, _IP, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.fsf_jpeg_decode.restype = ctypes.c_int
    lib.fsf_jpeg_decode.argtypes = [_U8P, ctypes.c_longlong, _U8P, ctypes.c_longlong,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.fsf_lz4_frame_decompress.restype = ctypes.c_longlong
    lib.fsf_lz4_frame_decompress.argtypes = [_U8P, ctypes.c_longlong, _U8P, ctypes.c_longlong]
    _LIB = lib
    return lib


def read_points(path: str, dim: int) -> np.ndarray:
    """A float32 ``.bin`` as ``[N, dim]`` (what ``np.fromfile`` gives)."""
    lib = _load()
    n = lib.fsf_file_num_floats(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    buf = np.empty(n, np.float32)
    got = lib.fsf_read_floats(path.encode(), buf.ctypes.data_as(_F32P), n)
    if got < 0:
        raise OSError(f"cannot read {path}")
    return buf[:got].reshape(-1, dim)


def png_unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``data`` (``h`` rows of a filter-type byte
    and ``stride`` bytes, as zlib gives them) → ``[h, stride]`` uint8."""
    data = np.ascontiguousarray(data, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"{data.size} filtered bytes for {h} rows of {stride}")
    out = np.empty((h, stride), np.uint8)
    err = _load().fsf_png_unfilter(data.ctypes.data_as(_U8P), h, stride, bpp,
                                   out.ctypes.data_as(_U8P))
    if err != 0:
        raise ValueError(f"PNG row {-err - 1} has filter type {data[(-err - 1) * (stride + 1)]}")
    return out


def jpeg_decode(data: bytes) -> np.ndarray:
    """A baseline JPEG's bytes → ``[H, W, 3]`` RGB or ``[H, W]`` grayscale
    uint8 (``csrc/jpeg.cpp``); raises ``ValueError`` naming what it met for
    a kind it does not read or a corrupt file."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    h, w, comps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.fsf_jpeg_info(src.ctypes.data_as(_U8P), src.size, ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(comps), err, len(err)):
        raise ValueError(err.value.decode())
    shape = (h.value, w.value, 3) if comps.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.uint8)
    if lib.fsf_jpeg_decode(src.ctypes.data_as(_U8P), src.size, out.ctypes.data_as(_U8P),
                           out.size, err, len(err)):
        raise ValueError(err.value.decode())
    return out


_LZ4_ERRORS = {-1: "bad frame magic or header", -3: "more bytes than the stated length",
               -7: "truncated frame", -8: "a dictionary id (not supported)"}


def lz4_frame_decompress(data, size: int) -> np.ndarray:
    """The LZ4 frames of ``data`` (bytes or a uint8 array) → exactly
    ``size`` bytes as uint8 (``csrc/lz4.cpp``); raises ``ValueError`` on a
    corrupt frame or another length."""
    src = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data, np.uint8)
    out = np.empty(size, np.uint8)
    got = _load().fsf_lz4_frame_decompress(src.ctypes.data_as(_U8P), src.size,
                                           out.ctypes.data_as(_U8P), size)
    if got < 0:
        raise ValueError(f"LZ4 frame: {_LZ4_ERRORS.get(got, 'corrupt block')} ({got})")
    if got != size:
        raise ValueError(f"LZ4 frame decompressed to {got} bytes, expected {size}")
    return out
