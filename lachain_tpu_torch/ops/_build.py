"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

`library()` compiles `csrc/g1.cu`, `csrc/g2.cu` (both include
`csrc/fp.cuh` and, for their group-field kernels, `csrc/coop.cuh` over
fp.cuh's BlsFp) and `csrc/secp.cu` (its own one-thread field code, and
`csrc/coop.cuh` for its group-field kernels) with nvcc for sm_90a, one
nvcc process per source, all started together, links them into one
shared library in `lachain_tpu_torch/_build/` (listed in .gitignore)
under a name keyed by a hash of the sources, the headers and the flags,
and loads it. The first
call in a fresh checkout therefore builds; later calls in the same
checkout reuse the library. There is no fallback: without nvcc, or on a
failed build, it raises.
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
SOURCES = ("g1.cu", "g2.cu", "secp.cu")
HEADERS = ("fp.cuh", "coop.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
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
    "lt_g1_table": [_P, _P, _I, _P],
    "lt_g1_msm_scan": [_P, _P, _P, _P, _I, _I, _P],
    "lt_g1_kernel_attrs": [_I] + [ctypes.POINTER(_I)] * 4,
    "lt_g2_dbl": [_P, _P, _I, _P],
    "lt_g2_add": [_P, _P, _P, _I, _P],
    "lt_g2_table": [_P, _P, _I, _P],
    "lt_g2_msm_scan": [_P, _P, _P, _P, _I, _I, _P],
    "lt_g2_kernel_attrs": [_I] + [ctypes.POINTER(_I)] * 4,
    "lt_secp_fp_mul": [_P, _P, _P, _I, _P],
    "lt_secp_dbl": [_P, _P, _I, _P],
    "lt_secp_add": [_P, _P, _P, _I, _P],
    "lt_secp_table": [_P, _P, _I, _P],
    "lt_secp_msm_scan": [_P, _P, _P, _P, _I, _I, _P],
    "lt_secp_sqrt": [_P, _P, _I, _P],
    "lt_secp_kernel_attrs": [_I] + [ctypes.POINTER(_I)] * 4,
}
# (attrs entry, kernel names in its index order)
_ATTRS = (
    ("lt_g1_kernel_attrs", ("fp_mul", "g1_dbl", "g1_add", "g1_msm_scan",
                            "g1_table")),
    ("lt_g2_kernel_attrs", ("g2_dbl", "g2_add", "g2_msm_scan", "g2_table")),
    ("lt_secp_kernel_attrs", ("secp_fp_mul", "secp_dbl", "secp_add",
                              "secp_msm_scan", "secp_sqrt", "secp_table")),
)


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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblt_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with the output of any that
    fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _build(target: Path) -> None:
    global build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    objs = [work / (Path(s).stem + ".o") for s in SOURCES]
    tmp = work / "lib.so"
    try:
        t0 = time.perf_counter()
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)
        ])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


ATTR_KEYS = ("regs", "local_bytes", "threads_per_lane", "block")


def kernel_attrs() -> dict:
    """{kernel: {regs, local_bytes, threads_per_lane, block}} from the
    loaded library: registers per thread, local (spill) bytes, threads per
    lane and threads per block, as compiled."""
    lib = library()
    out = {}
    for entry, names in _ATTRS:
        fn = getattr(lib, entry)
        for i, name in enumerate(names):
            vals = [ctypes.c_int() for _ in ATTR_KEYS]
            rc = fn(i, *map(ctypes.byref, vals))
            if rc != 0:
                raise RuntimeError(
                    f"cudaFuncGetAttributes({name}) failed: {rc}"
                )
            out[name] = dict(zip(ATTR_KEYS, (v.value for v in vals)))
    return out
