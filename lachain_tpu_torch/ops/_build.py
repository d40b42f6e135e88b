"""Build and bind the port's native code: the CUDA kernels, the host
pairing library and the native consensus engine (plain C interfaces +
ctypes).

`library()` compiles `csrc/g1.cu`, `csrc/g2.cu` (both include
`csrc/fp.cuh` and, for their group-field kernels, `csrc/coop.cuh` over
fp.cuh's BlsFp), `csrc/secp.cu` (every kernel on `csrc/coop.cuh`'s
group field over its SecpFp) and `csrc/rs.cu` (the
Reed-Solomon GF(2^8) / GF(2^16) matrix product) with nvcc for sm_90a, one
nvcc process per source, all started together, links them into one
shared library in `lachain_tpu_torch/_build/` (listed in .gitignore)
under a name keyed by a hash of the sources, the headers, the flags and
`nvcc --version` (as the JAX package's kernel cache keys by toolchain,
`lachain_tpu/crypto/kernel_cache.py:84-96`), so that a toolkit update
rebuilds, and loads it. The first
call in a fresh checkout therefore builds; later calls in the same
checkout reuse the library. There is no fallback: without nvcc, or on a
failed build, it raises.

`host_library()` compiles the host BLS12-381 library (`crypto/native/`
bls381.cpp and secp256k1.cpp, copies of the JAX package's) with g++ and
the reference Makefile's flags into one shared library in the same
directory, under a name keyed by a hash of the sources, the flags, `g++
--version` and what `-march=native` resolves to on this CPU (`g++
-march=native -Q --help=target`), so that a checkout shared by two CPUs
never loads code built for the other. One process builds at a time (a
file lock), others wait and load its result. Without g++, or on a failed
build, it raises. This module imports no torch: the host backend that
loads the library (`crypto/native_backend.py`) serves torch-free callers.

`consensus_library()` builds the native consensus engine
(`consensus/native/consensus_rt.cpp`, the port's copy of the JAX
package's) the same way: g++ with the reference Makefile's flags, a name
keyed by the source, the flags, `g++ --version` and `-march=native`, a
file lock of its own, the same directory. There is no prebuilt library and
no override: the engine always comes from the checkout's source. Without
g++, or on a failed build, it raises.

Each lazy build runs under a lock of its own, so that two threads of one
process (the node-start warmup of `crypto/warmup.py` and its caller) build
and load each library once.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("g1.cu", "g2.cu", "secp.cu", "rs.cu")
HEADERS = ("fp.cuh", "coop.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

HOST_SRC = _PKG / "crypto" / "native"
HOST_SOURCES = ("bls381.cpp", "secp256k1.cpp")
# the flags of lachain_tpu/crypto/native/Makefile, warnings aside
HOST_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
              "-std=c++17", "-pthread")

CONSENSUS_SRC = _PKG / "consensus" / "native"
CONSENSUS_SOURCES = ("consensus_rt.cpp",)
# the flags of lachain_tpu/consensus/native/Makefile, warnings aside
CONSENSUS_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC",
                   "-shared", "-std=c++17")

_LIB = None
_HOST_LIB = None
_CONSENSUS_LIB = None
_LIB_LOCK = threading.Lock()
_HOST_LIB_LOCK = threading.Lock()
_CONSENSUS_LIB_LOCK = threading.Lock()
# wall seconds of this process's nvcc run (None when the library came from
# an earlier build)
build_seconds = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "lt_g1_fp_mul": [_P, _P, _P, _I, _P],
    "lt_g1_dbl": [_P, _P, _I, _P],
    "lt_g1_add": [_P, _P, _P, _I, _P],
    "lt_g1_table": [_P, _P, _I, _P],
    "lt_g1_msm_scan": [_P, _P, _P, _P, _I, _I, _P],
    "lt_g1_mont": [_P, _P, _I, _I, _I, _P],
    "lt_g1_fixed_tables": [_P, _P, _I, _P],
    "lt_g1_fixed_scan": [_P, _P, _P, _P, _I, _I, _P],
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
    "lt_secp_mont": [_P, _P, _I, _I, _I, _P],
    "lt_secp_kernel_attrs": [_I] + [ctypes.POINTER(_I)] * 4,
    "lt_rs_matmul8": [_P, _I, _L, _P, _I, _P, _I, _I, _I, _I, _P],
    "lt_rs_matmul16": [_P, _P, _P, _I, _L, _P, _I, _P, _I, _I, _I, _I, _P],
    "lt_rs_geometry": [_I] + [ctypes.POINTER(_I)] * 6,
    "lt_rs_kernel_attrs": [_I] + [ctypes.POINTER(_I)] * 4,
}
# (attrs entry, kernel names in its index order)
_ATTRS = (
    ("lt_g1_kernel_attrs", ("fp_mul", "g1_dbl", "g1_add", "g1_msm_scan",
                            "g1_table", "g1_mont", "g1_fixed_tables",
                            "g1_fixed_scan")),
    ("lt_g2_kernel_attrs", ("g2_dbl", "g2_add", "g2_msm_scan", "g2_table")),
    ("lt_secp_kernel_attrs", ("secp_fp_mul", "secp_dbl", "secp_add",
                              "secp_msm_scan", "secp_sqrt", "secp_table",
                              "secp_mont")),
    ("lt_rs_kernel_attrs", ("rs_matmul8", "rs_matmul16")),
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _target(nvcc: str) -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            check=True).stdout)
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
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def _publish(target: Path, steps) -> None:
    """steps(work) builds `work / "lib.so"` in a fresh directory under
    BUILD_DIR; it then replaces `target` atomically, so that a concurrent
    loader never sees half a library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        steps(work)
        os.replace(work / "lib.so", target)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _build(target: Path, nvcc: str) -> None:
    global build_seconds

    def steps(work: Path) -> None:
        objs = [work / (Path(s).stem + ".o") for s in SOURCES]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)
        ])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(work / "lib.so"),
                   *map(str, objs)]])

    t0 = time.perf_counter()
    _publish(target, steps)
    build_seconds = time.perf_counter() - t0


def library():
    """The loaded kernel library, built first if needed."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            nvcc = _nvcc()
            target = _target(nvcc)
            if not target.exists():
                _build(target, nvcc)
            lib = ctypes.CDLL(str(target))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found: the host libraries build only where a C++ "
            "compiler is installed"
        )
    return path


def _gxx_target(gxx: str, prefix: str, src: Path, sources, flags) -> Path:
    """BUILD_DIR / f"{prefix}_<hash>.so", the hash over the sources, the
    flags, `g++ --version` and what `-march=native` resolves to."""
    h = hashlib.sha256()
    for name in sources:
        h.update(name.encode())
        h.update((src / name).read_bytes())
    h.update(" ".join(flags).encode())
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        h.update(subprocess.run([gxx, *args], capture_output=True,
                                check=True).stdout)
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"


def _gxx_load(gxx: str, target: Path, lock_name: str, src: Path, sources,
              flags):
    """Build `target` from `sources` under a file lock unless it exists,
    and load it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / lock_name, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not target.exists():
            _publish(target, lambda work: _run_all([[
                gxx, *flags, "-o", str(work / "lib.so"),
                *(str(src / s) for s in sources)]]))
    return ctypes.CDLL(str(target))


def _host_target(gxx: str) -> Path:
    return _gxx_target(gxx, "libhost", HOST_SRC, HOST_SOURCES, HOST_FLAGS)


def host_library():
    """The loaded host pairing library, built first if needed."""
    global _HOST_LIB
    with _HOST_LIB_LOCK:
        if _HOST_LIB is None:
            gxx = _gxx()
            _HOST_LIB = _gxx_load(gxx, _host_target(gxx), "host.lock",
                                  HOST_SRC, HOST_SOURCES, HOST_FLAGS)
    return _HOST_LIB


def consensus_library():
    """The loaded native consensus engine, built first if needed (its
    binding: `consensus/native_rt.load_rt`)."""
    global _CONSENSUS_LIB
    with _CONSENSUS_LIB_LOCK:
        if _CONSENSUS_LIB is None:
            gxx = _gxx()
            target = _gxx_target(gxx, "libconsensus", CONSENSUS_SRC,
                                 CONSENSUS_SOURCES, CONSENSUS_FLAGS)
            _CONSENSUS_LIB = _gxx_load(gxx, target, "consensus.lock",
                                       CONSENSUS_SRC, CONSENSUS_SOURCES,
                                       CONSENSUS_FLAGS)
    return _CONSENSUS_LIB


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
