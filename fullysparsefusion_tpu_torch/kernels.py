"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``. Libraries go to
``build/torch_kernels/`` at the repository root, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source rebuilds and an unchanged one loads as is. :func:`build_all` starts
one ``nvcc`` per source at once.

Nothing here runs at import time: the first call of a kernel wrapper on a
CUDA tensor builds (if needed) and loads its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# name -> (source file, extra nvcc flags, C symbol, argtypes); names that
# share a source and flags share one library
KERNELS = {
    "gather_conv": ("gather_conv.cu", [], "fsf_gather_conv",
                    [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P]),
    # the dw kernel's work list, then its product and sum over that list
    "gather_conv_dw_list": ("gather_conv_dw.cu", [], "fsf_dw_work_list",
                            [_P, _P, _I, _I, _I, _P, _P]),
    "gather_conv_dw": ("gather_conv_dw.cu", [], "fsf_gather_conv_dw",
                       [_P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P]),
    # no FMA contraction anywhere in the CCL distance test
    "ccl": ("ccl.cu", ["--fmad=false"], "fsf_ccl_roots",
            [_P, _P, _P, _I, _I, _P, _P, _P, _P]),
    "nms": ("nms.cu", [], "fsf_nms_keep",
            [_P, _P, _P, _I, _I, _F, _P, _P, _P]),
    "segment_sum": ("segment.cu", [], "fsf_segment_sum",
                    [_P, _L, _I, _P, _P, _I, _P, _P]),
}

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> str:
    src, flags, _, _ = KERNELS[name]
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha1(repr(_BASE_FLAGS + flags).encode())
    for f in [src, *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(src)[0]}-{digest}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every (or the named) kernel's library that is not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each source's build took (0.0 for one already built); raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names or KERNELS:
        src, flags, _, _ = KERNELS[name]
        path = _lib_path(name)
        if src in seconds or src in procs:
            continue
        if os.path.exists(path):
            seconds[src] = 0.0
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *_BASE_FLAGS, *flags, "-o", tmp, os.path.join(CSRC_DIR, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path, time.perf_counter())
    errors = []
    for src, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def kernel(name: str):
    """The loaded C entry point of kernel ``name`` (built on first use)."""
    fn = _loaded.get(name)
    if fn is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        _, _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(path), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise on a launch error."""
    err = kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
