"""Variants of the group-field kernels built beside the shipped ones, on one
card.

    python3 -m lachain_tpu_torch.scan_sweep [--seed S] [--baseline DIR ...]
                                            [--int-rate] [--out FILE]

`csrc/g1.cu`, `csrc/g2.cu` and `csrc/secp.cu` run their scans, adds and
table builds with SCAN_T threads per lane, a compile-time constant
(`LT_G1_SCAN_T`, `LT_G2_SCAN_T`, `LT_SECP_SCAN_T`) over the group field of
`csrc/coop.cuh`. This script builds each source at the other
values of T in {1, 2, 4}, and at the shipped T with one design choice of
the shipped source undone in a copy of it (`VARIANTS`: text edits, each of
which must find its text):
  * groupmask   each group's own lanes as the collectives' mask and groups
                that diverge on their flags (coop.cuh);
  * prefetch    the window's table entry loaded before the doublings;
  * fp2inline   the group-field Fp2 products inlined (g2.cu).
All nvcc processes start together, with `-Xptxas -v`; the report holds
each build's seconds and, per kernel, the registers, stack frame and
spills ptxas reports, its callees' too, or the compiler's failure.

Every library's kernels then run on the same seeded inputs, and each
output must equal the shipped library's word for word. They are timed
with CUDA events in ROUNDS rounds whose order alternates forward and
reversed, so that each library runs before and after each other one:
  * the G1 scan at `check` (32 windows x 8192 lanes of random 128-bit
    digits, every 61st lane zero: chip_smoke.py's kernel check) and at
    `tpke`, the N=64 TPKE era's joined scan (`g1.tpke_digits`, 32 windows x
    16,384 lanes); the G1 table build at 8192 lanes, at the TPKE era's
    16,384 joined lanes (`g1.tpke_lanes`) and at the coin era's 4096 key
    lanes (64 keys tiled per coin); g1_add at 8192 lanes and at 256, the
    TPKE era's last tree pass;
  * the G2 scan at `check` (64 windows x 8192 lanes of random 256-bit
    digits) and at `coin`, the N=64 coin era's scan (`g2.coin_digits`);
    the G2 table build at the coin era's 4096 signature lanes
    (`g2.coin_lanes`: 22 live lanes of each 64, the others infinity);
  * the secp scan at `check` (64 windows x 8192 lanes of random 256-bit
    digits) and at `recover`, one 4096-signature chunk of the recovery
    (`secp.recover_layout`: [R_i, G] interleaved, full-width u1, u2); the
    secp table build at that chunk's 8192 lanes; secp_add at 8192 lanes
    and at 4096, the chunk's pair add;
  * the other kernels of the same source (fp_mul, g1_dbl; g2_dbl, g2_add;
    secp_dbl) at 8192 lanes.

`--baseline DIR` also builds DIR's `lachain_tpu_torch/csrc/g1.cu`, `g2.cu`
and `secp.cu` as they are (an unpacked earlier commit, e.g. `git archive
<commit> | tar -x -C _scratch/base`) and times them in the same rounds,
labelled `<source>_baseline_<DIR's name>`; it may be given more than once;
where it lacks a table entry of this tree (`lt_g1_table`, `lt_g2_table`,
`lt_secp_table`) it builds the table by the chain of one doubling and 13
add launches.

`--int-rate` also builds a probe kernel and measures the card's sustained
32x32->64-bit multiply-add rate, as `mad.wide.u32` (what coop.cuh's
column products run) and as the pair `mad.lo.cc.u32` + `madc.hi.u32` (a
product along a carry chain).

Needs a CUDA card and nvcc; builds into `lachain_tpu_torch/_build/` and
removes what it built. The last line of standard output is one JSON
object, each timing's rounds under `ms` and their medians under
`median_ms`; `--out` also writes it to a file. Exits 1 when a variant's output
differs from the shipped library's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .crypto import bls12381 as bls
from .crypto import ecdsa
from .ops import _build, g1, g2, glv, secp

LANES = 8192
ROUNDS = 10  # timing rounds, their order alternating
SCANS = ("g1", "g2", "secp")  # the sources, each with its group-field scan
# the main path's layout of each scan, beside the random-digit `check`
MAIN_LAYOUT = {"g1": "tpke", "g2": "coin", "secp": "recover"}

# label -> (scans, {file: [(shipped text, variant text)]})
VARIANTS = {
    "groupmask": (SCANS, {"coop.cuh": [
        ("static constexpr uint32_t mask = 0xffffffffu;  // every collective's lanes",
         "uint32_t mask;  // the group's own lanes"),
        ("  g.shift = wl - g.rank;\n",
         "  g.shift = wl - g.rank;\n  g.mask = ((1u << T) - 1u) << g.shift;\n"),
        ("  return __any_sync(g.mask, pred);", "  return pred;"),
    ]}),
    "prefetch": (SCANS, {f"{s}.cu": [(
        f"""    if (lanes_any(g, !flag)) {{  // a flagged accumulator is the zero point
#pragma unroll 1
      for (int k = 0; k < WINDOW; ++k) acc = {s}_dbl_g(g, acc);
    }}
    const {pt}<T> entry = {sel}(g, table, d, n, col);
""",
        f"""    const {pt}<T> entry = {sel}(g, table, d, n, col);
    if (lanes_any(g, !flag)) {{
#pragma unroll 1
      for (int k = 0; k < WINDOW; ++k) acc = {s}_dbl_g(g, acc);
    }}
""")] for s, pt, sel in (("g1", "PtG", "select_entry_g"),
                         ("g2", "Pt2G", "select_entry2_g"),
                         ("secp", "PtG", "select_entry_g"))}),
    "fp2inline": (("g2",), {"g2.cu": [
        (f"__device__ __noinline__ Fp2G<T> fp2g_{op}(",
         f"__device__ __forceinline__ Fp2G<T> fp2g_{op}(") for op in ("mul", "sqr")
    ]}),
}

# kernels first, longest names first: "dbl_kernel" is inside "g2_dbl_kernel"
_NAMES = ("secp_msm_scan_kernel", "g2_msm_scan_kernel", "msm_scan_kernel",
          "secp_table_kernel", "g2_table_kernel", "g1_table_kernel",
          "secp_fp_mul_kernel", "secp_dbl_kernel",
          "secp_add_kernel", "secp_sqrt_kernel", "g2_dbl_kernel",
          "g2_add_kernel", "fp_mul_kernel", "dbl_kernel", "add_kernel",
          "secp_dbl", "secp_add", "g2_dbl", "g2_add", "g1_dbl", "g1_add",
          "fp2g_mul", "fp2g_sqr", "fp2_mul", "fp2_sqr")


def _short(mangled: str):
    return next((n for n in _NAMES if n in mangled), None)


def parse_ptxas(text: str) -> dict:
    """ptxas -v output -> {kernel: {regs, stack, spill_stores, spill_loads,
    callees: {function: [stack, spill_stores, spill_loads]}}} for the
    kernels of g1.cu / g2.cu / secp.cu, templated or not."""
    out, entry = {}, None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _short(m[1])
            if entry:
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


def scan_of(label: str) -> str:
    """The source of a library label ("secp_T2" -> "secp")."""
    return label.split("_")[0]


def variant_sources(work: Path, shipped_t: dict, baselines=()) -> dict:
    """{label: (source, include dir, -D defines)}: each scan at the other
    values of T, each VARIANTS edit at the shipped T in its own copy of
    csrc/, and each baseline checkout's sources."""
    out = {}
    for scan in SCANS:
        macro = f"LT_{scan.upper()}_SCAN_T"
        for t in (1, 2, 4):
            if t != shipped_t[scan]:
                out[f"{scan}_T{t}"] = (_build.CSRC / f"{scan}.cu", _build.CSRC,
                                       [f"-D{macro}={t}"])
    for name, (scans, edits) in VARIANTS.items():
        for scan in scans:
            label = f"{scan}_{name}"
            src = work / label
            shutil.copytree(_build.CSRC, src)
            for fname, pairs in edits.items():
                path = src / fname
                text = path.read_text()
                for old, new in pairs:
                    if old not in text:
                        raise RuntimeError(f"{label}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
                path.write_text(text)
            out[label] = (src / f"{scan}.cu", src, [])
    for base in baselines:
        csrc = Path(base) / "lachain_tpu_torch" / "csrc"
        for scan in SCANS:
            out[f"{scan}_baseline_{Path(base).name}"] = (csrc / f"{scan}.cu", csrc, [])
    return out


def build_variants(work: Path, sources: dict) -> dict:
    """Compile every variant in parallel -> {label: {lib | error, nvcc_s,
    ptxas}}."""
    nvcc = _build._nvcc()
    procs = {}
    for label, (src, inc, defs) in sources.items():
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs, "-I", str(inc),
               "-shared", "-o", str(work / f"{label}.so"), str(src)]
        procs[label] = (time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (t0, proc) in procs.items():
        try:
            text, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += "\n(timed out after 900 s)"
        rec = {"nvcc_s": round(time.perf_counter() - t0, 1),
               "ptxas": parse_ptxas(text)}
        if proc.returncode != 0:
            rec["error"] = text[-3000:]
        else:
            lib = ctypes.CDLL(str(work / f"{label}.so"))
            for name, args in _build._SIGNATURES.items():
                # a baseline may lack an entry of this tree (a table build)
                if name.startswith(f"lt_{scan_of(label)}_") and hasattr(lib, name):
                    getattr(lib, name).argtypes = args
                    getattr(lib, name).restype = ctypes.c_int
            rec["lib"] = lib
        out[label] = rec
    return out


# ---------------------------------------------------------------------------
# inputs and launches
# ---------------------------------------------------------------------------


def random_digits(rng: random.Random, n: int, nwin: int):
    """Random full-width digits, every 61st lane zero and lane 1 holding
    5 (leading zero windows, then one nonzero digit)."""
    scalars = [0 if i % 61 == 0 else rng.randrange(1 << (4 * nwin))
               for i in range(n)]
    scalars[1] = 5
    return glv.digits_col(scalars, nwin)


def make_inputs(seed: int, dev) -> dict:
    """Seeded points, tables and digits on the card."""
    rng = random.Random(seed)
    pts1 = g1.g1_pack(glv.point_run(rng, 2 * LANES), dev)
    pts2 = g2.g2_pack(glv.point_run(rng, 2 * LANES, bls.g2_mul, bls.g2_add,
                                    bls.G2_GEN), dev)
    tpke = g1.g1_pack(g1.tpke_lanes(rng), dev)
    keys = glv.point_run(rng, 64)
    tab1, tab2 = g1.build_table(tpke), g2.build_table2(pts2[:, :LANES].contiguous())
    pts3 = secp.pt_pack(glv.point_run(rng, 2 * LANES, ecdsa._mul, ecdsa._add,
                                      ecdsa.G, ecdsa.N), dev)
    rec_pts, rec_digits = secp.recover_layout(rng)
    rec = secp.pt_pack(rec_pts, dev)
    on = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    half = lambda t, m: t[:, :m].contiguous()  # noqa: E731
    p1, q1 = half(pts1, LANES), pts1[:, LANES:].contiguous()
    p3, q3 = half(pts3, LANES), pts3[:, LANES:].contiguous()
    return {
        "g1": {"check": (g1.build_table(p1), on(random_digits(rng, LANES, glv.W128))),
               "tpke": (tab1, on(g1.tpke_digits(rng))),
               "tables": {"check": p1, "tpke": tpke,
                          "coin": g1.g1_pack(keys * 64, dev)},
               "adds": {"check": (p1, q1), "tree": (half(p1, 256), half(q1, 256))},
               "points": (p1, q1)},
        "g2": {"check": (tab2, on(random_digits(rng, LANES, glv.W256))),
               "coin": (tab2, on(g2.coin_digits(rng))),
               "tables": {"coin": g2.g2_pack(g2.coin_lanes(rng), dev)},
               "points": (pts2[:, :LANES].contiguous(), pts2[:, LANES:].contiguous())},
        "secp": {"check": (secp.build_table(p3), on(random_digits(rng, LANES, glv.W256))),
                 "recover": (secp.build_table(rec), on(rec_digits)),
                 "tables": {"recover": rec},
                 "adds": {"check": (p3, q3),
                          "pair": (half(p3, LANES // 2), half(q3, LANES // 2))},
                 "points": (p3, q3)},
    }


def _check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"kernel launch failed with CUDA error {rc}")


def _scan(lib, scan: str, table, digits):
    n, nwin = table.shape[-1], digits.shape[0]
    acc = torch.empty(table.shape[1:], dtype=torch.int32, device=table.device)
    flags = torch.empty((n,), dtype=torch.bool, device=table.device)
    fn = getattr(lib, f"lt_{scan}_msm_scan")
    stream = g1._stream(table)
    return (lambda: _check(fn(table.data_ptr(), digits.data_ptr(), acc.data_ptr(),
                              flags.data_ptr(), n, nwin, stream)), (acc, flags))


def _table_chain(lib, scan: str, lanes, table) -> list:
    """A table as the design before `lt_<scan>_table` built it: one
    doubling and 13 chained add launches, into `table`'s entries (entry 0
    zeroed)."""
    n, stream = lanes.shape[-1], g1._stream(lanes)
    dbl, add = getattr(lib, f"lt_{scan}_dbl"), getattr(lib, f"lt_{scan}_add")
    table[0].zero_()
    table[1].copy_(lanes)
    ptr = [table[k].data_ptr() for k in range(glv.TABLE)]
    return [lambda: _check(dbl(lanes.data_ptr(), ptr[2], n, stream))] + [
        (lambda k=k: _check(add(ptr[k - 1], lanes.data_ptr(), ptr[k], n, stream)))
        for k in range(3, glv.TABLE)]


def _table(lib, scan: str, lanes):
    """([launch()], (table,)) of `scan`'s table build over `lanes`: one
    launch, or the chain where the library has no table entry."""
    m, stream = lanes.shape[-1], g1._stream(lanes)
    table = torch.empty((glv.TABLE,) + tuple(lanes.shape), dtype=torch.int32,
                        device=lanes.device)
    fn = getattr(lib, f"lt_{scan}_table", None)
    if fn is None:
        return _table_chain(lib, scan, lanes, table), (table,)
    return [lambda: _check(fn(lanes.data_ptr(), table.data_ptr(), m, stream))], (table,)


def _add(lib, scan: str, p, q):
    out, n, stream = torch.empty_like(p), p.shape[-1], g1._stream(p)
    fn = getattr(lib, f"lt_{scan}_add")
    return [lambda: _check(fn(p.data_ptr(), q.data_ptr(), out.data_ptr(), n,
                              stream))], (out,)


def launchers(lib, scan: str, inputs: dict) -> dict:
    """{kernel: ([launch()], outputs)} of one library's kernels of `scan`'s
    source on the shared inputs; a library without a table entry (an
    earlier tree) builds the table by its chain of launches."""
    inp = inputs[scan]
    p, q = inp["points"]
    n, stream = p.shape[-1], g1._stream(p)
    out = {}
    for layout in ("check", MAIN_LAYOUT[scan]):
        launch, outs = _scan(lib, scan, *inp[layout])
        out[f"scan_{layout}"] = ([launch], outs)
    for layout, lanes in inp["tables"].items():
        out[f"{scan}_table_{layout}"] = _table(lib, scan, lanes)
    adds = inp.get("adds", {"": (p, q)})
    for layout, (a, b) in adds.items():
        out[f"{scan}_add" + (f"_{layout}" if layout else "")] = _add(lib, scan, a, b)
    if scan == "g1":
        x, y, o1 = p[:12].contiguous(), q[:12].contiguous(), torch.empty_like(p[:12])
        out["fp_mul"] = ([lambda: _check(lib.lt_g1_fp_mul(
            x.data_ptr(), y.data_ptr(), o1.data_ptr(), n, stream))], (o1,))
    od = torch.empty_like(p)
    out[f"{scan}_dbl"] = ([lambda: _check(getattr(lib, f"lt_{scan}_dbl")(
        p.data_ptr(), od.data_ptr(), n, stream))], (od,))
    return out


def cuda_ms(fn, reps: int) -> float:
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


# ---------------------------------------------------------------------------
# the 32x32->64-bit multiply-add rate
# ---------------------------------------------------------------------------

_PROBE = r"""
#include <cstdint>
// Independent chains of 32x32->64-bit multiply-adds, 8 per thread.
extern "C" __global__ void mad_wide(const uint32_t* in, uint64_t* out,
                                    int iters) {
  uint32_t a[8];
  uint64_t acc[8];
  for (int k = 0; k < 8; ++k) { a[k] = in[k] | 1u; acc[k] = in[8 + k]; }
  const uint32_t b = in[16] + threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc[k]) : "r"(a[k]), "r"(b));
    }
  }
  uint64_t s = 0;
  for (int k = 0; k < 8; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void mad_lohi(const uint32_t* in, uint64_t* out,
                                    int iters) {
  uint32_t a[8], lo[8], hi[8];
  for (int k = 0; k < 8; ++k) { a[k] = in[k] | 1u; lo[k] = in[8 + k]; hi[k] = 0; }
  const uint32_t b = in[16] + threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.u32 %1, %2, %3, %1;"
                     : "+r"(lo[k]), "+r"(hi[k]) : "r"(a[k]), "r"(b));
    }
  }
  uint64_t s = 0;
  for (int k = 0; k < 8; ++k) s ^= ((uint64_t)hi[k] << 32) | lo[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int lt_probe(int which, const void* in, void* out, int blocks,
                        int threads, int iters) {
  if (which == 0)
    mad_wide<<<blocks, threads>>>((const uint32_t*)in, (uint64_t*)out, iters);
  else
    mad_lohi<<<blocks, threads>>>((const uint32_t*)in, (uint64_t*)out, iters);
  return (int)cudaGetLastError();
}
"""


def int_rate(work: Path, dev) -> dict:
    """{form: sustained 32x32->64-bit multiply-adds per second}."""
    src = work / "int_probe.cu"
    src.write_text(_PROBE)
    so = work / "int_probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.lt_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int]
    props = torch.cuda.get_device_properties(dev)
    blocks, threads, iters = props.multi_processor_count * 8, 256, 2048
    inp = torch.randint(0, 1 << 30, (17,), dtype=torch.int32, device=dev)
    out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    rates = {}
    for which, form in enumerate(("mad.wide.u32", "mad.lo.cc+madc.hi")):
        ms = cuda_ms(lambda: _check(lib.lt_probe(
            which, inp.data_ptr(), out.data_ptr(), blocks, threads, iters)), 5)
        rates[form] = blocks * threads * iters * 16 * 8 / (ms * 1e-3)
    return rates


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--baseline", action="append", default=[],
                    help="root of an earlier checkout to time beside this one"
                         " (repeatable)")
    ap.add_argument("--int-rate", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    shipped = _build.library()
    attrs = _build.kernel_attrs()
    shipped_t = {s: attrs[f"{s}_msm_scan"]["threads_per_lane"] for s in SCANS}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    try:
        t0 = time.perf_counter()
        built = build_variants(work, variant_sources(work, shipped_t, args.baseline))
        print(f"variants built in {time.perf_counter() - t0:.1f} s: "
              f"{ {k: ('ok' if 'lib' in v else 'FAILED', v['nvcc_s']) for k, v in built.items()} }",
              flush=True)
        inputs = make_inputs(args.seed, dev)
        libs = {f"{s}_shipped": shipped for s in SCANS}
        libs.update((k, v["lib"]) for k, v in built.items() if "lib" in v)
        runs = {label: launchers(lib, scan_of(label), inputs)
                for label, lib in libs.items()}
        for kernels in runs.values():
            for launches, _ in kernels.values():
                for fn in launches:
                    fn()
        torch.cuda.synchronize()
        equal = {
            f"{label}/{k}": all(torch.equal(a, b) for a, b in
                                zip(outs, runs[f"{scan_of(label)}_shipped"][k][1]))
            for label, kernels in runs.items() if not label.endswith("shipped")
            for k, (_, outs) in kernels.items()
        }
        reps = {"g1": 10, "g2": 5, "secp": 10}
        ms: dict = {}
        order = [(label, k, launches) for label, kernels in runs.items()
                 for k, (launches, _) in kernels.items()]
        for i in range(ROUNDS):
            for label, k, launches in (order if i % 2 == 0 else order[::-1]):
                r = reps[scan_of(label)] if k.startswith("scan") or "_table" in k else 100
                ms.setdefault(f"{label}/{k}", []).append(
                    round(sum(cuda_ms(fn, r) for fn in launches), 5))
        report = {
            "card": smi, "seed": args.seed, "shipped_t": shipped_t,
            "attrs_shipped": attrs,
            "build": {k: {kk: vv for kk, vv in v.items() if kk != "lib"}
                      for k, v in built.items()},
            "equal_to_shipped": equal, "ms": ms,
            "median_ms": {k: statistics.median(v) for k, v in ms.items()},
        }
        if args.int_rate:
            report["int_rate_per_s"] = int_rate(work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
