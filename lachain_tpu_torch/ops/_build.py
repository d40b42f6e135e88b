"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

`library()` compiles `csrc/g1.cu` with nvcc for sm_90a into
`lachain_tpu_torch/_build/` (listed in .gitignore), under a name keyed by a
hash of the sources and flags, and loads it. The first call in a fresh
checkout therefore builds; later calls in the same checkout reuse the
library. There is no fallback: without nvcc, or on a failed build, it
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("g1.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None
# wall seconds of this process's nvcc run (None when the library came from
# an earlier build)
build_seconds = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lt_g1_fp_mul": [_P, _P, _P, _I, _P],
    "lt_g1_dbl": [_P, _P, _I, _P],
    "lt_g1_add": [_P, _P, _P, _I, _P],
    "lt_g1_msm_scan": [_P, _P, _P, _P, _I, _I, _P],
    "lt_g1_kernel_attrs": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _target() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblt_g1_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp] + [str(CSRC / s) for s in SOURCES]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        target = _target()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_attrs() -> dict:
    """{kernel: (registers per thread, local spill bytes)} from the loaded
    library."""
    lib = library()
    out = {}
    for i, name in enumerate(("fp_mul", "g1_dbl", "g1_add", "g1_msm_scan")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        rc = lib.lt_g1_kernel_attrs(i, ctypes.byref(regs), ctypes.byref(local))
        if rc != 0:
            raise RuntimeError(f"cudaFuncGetAttributes({name}) failed: {rc}")
        out[name] = (regs.value, local.value)
    return out
