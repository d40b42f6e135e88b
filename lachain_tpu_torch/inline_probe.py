"""The G2 kernels with their Fp2 products inlined, against the shipped source.

    python3 -m lachain_tpu_torch.inline_probe [--seed S] [--lanes N]

`csrc/g2.cu` keeps the Fp2 products `fp2_mul` / `fp2_sqr` and the group
law `g2_dbl` / `g2_add` out of line (`__noinline__`). This script compiles
two copies of `g2.cu` side by side with `-Xptxas -v`: the shipped source
and a variant whose `fp2_mul` / `fp2_sqr` are `__forceinline__`. It prints
each nvcc's wall seconds and, per kernel, the registers, stack frame and
spills ptxas reports (the callees' spills too). It then runs the three G2
kernels of both libraries on the same seeded inputs at N lanes (the scan
with 64 windows of random 256-bit digits, every 61st lane zero), checks
that their outputs are equal word for word, and times each with CUDA events
in the order shipped, variant, variant, shipped. The last line of standard
output is one JSON object. Needs a CUDA card and nvcc; builds into
`lachain_tpu_torch/_build/` and removes what it built.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .crypto import bls12381 as bls
from .ops import _build, g1, g2, glv

_VARIANT_OF = {
    "__device__ __noinline__ Fp2 fp2_mul": "__device__ __forceinline__ Fp2 fp2_mul",
    "__device__ __noinline__ Fp2 fp2_sqr": "__device__ __forceinline__ Fp2 fp2_sqr",
}
# kernels first: "g2_add" is a prefix of "g2_add_kernel"
_NAMES = ("g2_msm_scan_kernel", "g2_add_kernel", "g2_dbl_kernel", "g2_add",
          "g2_dbl", "fp2_mul", "fp2_sqr")


def _short(mangled: str):
    return next((n for n in _NAMES if n in mangled), None)


def parse_ptxas(text: str) -> dict:
    """ptxas -v output -> {kernel: {regs, stack, spill_stores, spill_loads,
    callees: {function: [stack, spill_stores, spill_loads]}}}."""
    out, entry = {}, None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _short(m[1])
            out[entry] = {"callees": {}}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m and entry and i + 1 < len(lines):
            name = _short(m[1])
            nums = [int(v) for v in re.findall(r"(\d+) bytes", lines[i + 1])]
            if name == entry:
                out[entry].update(zip(("stack", "spill_stores", "spill_loads"), nums))
            elif name:
                out[entry]["callees"][name] = nums
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["regs"] = int(m[1])
    return out


def _build_both(work) -> dict:
    """Compile the shipped g2.cu and the inlined variant in parallel ->
    {label: (ctypes library, nvcc seconds, ptxas report)}."""
    src = (_build.CSRC / "g2.cu").read_text()
    variant = src
    for old, new in _VARIANT_OF.items():
        if old not in variant:
            raise RuntimeError(f"g2.cu no longer holds {old!r}")
        variant = variant.replace(old, new)
    (work / "g2_inlined.cu").write_text(variant)
    sources = {"shipped": _build.CSRC / "g2.cu", "inlined": work / "g2_inlined.cu"}
    nvcc = _build._nvcc()
    procs = {}
    for label, path in sources.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-shared", "-o", str(work / f"{label}.so"), str(path)]
        procs[label] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (t0, proc) in procs.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {label} -> {proc.returncode}:\n{text}")
        lib = ctypes.CDLL(str(work / f"{label}.so"))
        for name, args in _build._SIGNATURES.items():
            if name.startswith("lt_g2_"):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = ctypes.c_int
        out[label] = (lib, seconds, parse_ptxas(text))
    return out


def _attrs(lib) -> dict:
    out = {}
    for i, name in enumerate(("g2_dbl", "g2_add", "g2_msm_scan")):
        regs, local = ctypes.c_int(), ctypes.c_int()
        if lib.lt_g2_kernel_attrs(i, ctypes.byref(regs), ctypes.byref(local)):
            raise RuntimeError(f"cudaFuncGetAttributes({name}) failed")
        out[name] = (regs.value, local.value)
    return out


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _inputs(n: int, seed: int, dev):
    rng = random.Random(seed)

    def run():
        p = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
        step = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
        pts = []
        for _ in range(n):
            pts.append(p)
            p = bls.g2_add(p, step)
        return g2.g2_pack(pts, dev)

    kp, kq = run(), run()
    scalars = [0 if i % 61 == 0 else rng.randrange(1 << 256) for i in range(n)]
    digits = torch.from_numpy(glv.digits_col(scalars, 64)).to(dev)
    return kp, kq, g2.build_table2(kp), digits


def _launchers(lib, kp, kq, table, digits):
    """{kernel: (launch(), outputs)} of one library on shared inputs."""
    n, stream = kp.shape[-1], g1._stream(kp)
    out_d, out_a = torch.empty_like(kp), torch.empty_like(kp)
    acc = torch.empty_like(kp)
    flags = torch.empty((n,), dtype=torch.bool, device=kp.device)

    def ok(rc):
        if rc:
            raise RuntimeError(f"kernel launch failed with CUDA error {rc}")

    return {
        "g2_dbl": (lambda: ok(lib.lt_g2_dbl(kp.data_ptr(), out_d.data_ptr(), n,
                                             stream)), (out_d,)),
        "g2_add": (lambda: ok(lib.lt_g2_add(kp.data_ptr(), kq.data_ptr(),
                                             out_a.data_ptr(), n, stream)), (out_a,)),
        "g2_msm_scan": (lambda: ok(lib.lt_g2_msm_scan(
            table.data_ptr(), digits.data_ptr(), acc.data_ptr(), flags.data_ptr(),
            n, digits.shape[0], stream)), (acc, flags)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--lanes", type=int, default=8192)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("inline_probe: needs a CUDA device")
    dev = torch.device("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    try:
        libs = _build_both(work)
        kp, kq, table, digits = _inputs(args.lanes, args.seed, dev)
        runs = {label: _launchers(lib, kp, kq, table, digits)
                for label, (lib, _, _) in libs.items()}
        reps = {"g2_dbl": 50, "g2_add": 50, "g2_msm_scan": 3}
        ms = {k: {"shipped": [], "inlined": []} for k in reps}
        for label in ("shipped", "inlined", "inlined", "shipped"):
            for k, r in reps.items():
                ms[k][label].append(_cuda_ms(runs[label][k][0], r))
        equal = {
            k: all(torch.equal(a, b) for a, b in
                   zip(runs["shipped"][k][1], runs["inlined"][k][1]))
            for k in reps
        }
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        report = {
            "card": smi, "lanes": args.lanes, "windows": int(digits.shape[0]),
            "nvcc_s": {label: v[1] for label, v in libs.items()},
            "attrs": {label: _attrs(v[0]) for label, v in libs.items()},
            "ptxas": {label: v[2] for label, v in libs.items()},
            "ms": ms, "equal": equal,
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
