"""Variants of the group-field kernels and of the Reed-Solomon product built
beside the shipped ones, on one card.

    python3 -m lachain_tpu_torch.scan_sweep [--seed S] [--baseline DIR ...]
                                            [--sources g1 g2 secp rs]
                                            [--int-rate] [--out FILE]

`csrc/g1.cu`, `csrc/g2.cu` and `csrc/secp.cu` run their scans, adds and
table builds with SCAN_T threads per lane, a compile-time constant
(`LT_G1_SCAN_T`, `LT_G2_SCAN_T`, `LT_SECP_SCAN_T`) over the group field of
`csrc/coop.cuh`. This script builds each source at the other
values of T in {1, 2, 4} (secp.cu also at 8, one word a thread: BLS12-381's
12 words do not split 8 ways), and at the shipped T with one design choice of
the shipped source undone in a copy of it (`VARIANTS`: text edits, each of
which must find its text):
  * groupmask   each group's own lanes as the collectives' mask and groups
                that diverge on their flags (coop.cuh);
  * prefetch    the window's table entry loaded before the doublings;
  * fp2inline   the group-field Fp2 products inlined (g2.cu);
  * chainserial g1_fixed_tables' doubling chain on one group, the 7
                products of a doubling in sequence, not over three groups
                of its warp (g1.cu);
  * mulinline   the two fixed-base kernels' group law with its products
                inlined, not called out of line (g1.cu MulCall);
  * dbltrio     the doublings (dbl_kernel, g2_dbl_kernel) a lane on three
                groups of a warp, a level's independent products one a
                group, not a lane on one group (g1.cu, g2.cu, coop.cuh);
  * dblcall     dbl_kernel's products called out of line (MulCall).
All nvcc processes start together, with `-Xptxas -v`; the report holds
each build's seconds and, per kernel, the registers, stack frame and
spills ptxas reports, its callees' too, or the compiler's failure.

Every library's kernels then run on the same seeded inputs, and each
output must equal the shipped library's word for word. They are timed
with CUDA events in ROUNDS rounds whose order alternates forward and
reversed, so that each library runs before and after each other one; the
stream is held (`HOLD_CYCLES`) while a timing's launches are enqueued, so
that a kernel shorter than its launch's host time is timed on the device:
  * the G1 scan at `check` (32 windows x 8192 lanes of random 128-bit
    digits, every 61st lane zero: chip_smoke.py's kernel check) and at
    `tpke`, the N=64 TPKE era's joined scan (`g1.tpke_digits`, 32 windows x
    16,384 lanes); the G1 table build at 8192 lanes, at the TPKE era's
    16,384 joined lanes (`g1.tpke_lanes`) and at the coin era's 4096 key
    lanes (64 keys tiled per coin); g1_add at 8192 lanes and at 256, the
    TPKE era's last tree pass; the G1 conversions (`g1_mont`) into form on
    the TPKE era's (36, 4096) share pack and the coin era's (72, 4096) G2
    signature pack, out of it on a (37, 8192) buffer with a flag row, and
    phi's product by beta on (12, 4096);
  * the G2 scan at `check` (64 windows x 8192 lanes of random 256-bit
    digits) and at `coin`, the N=64 coin era's scan (`g2.coin_digits`);
    the G2 table build at the coin era's 4096 signature lanes
    (`g2.coin_lanes`: 22 live lanes of each 64, the others infinity);
  * the secp scan at `check` (64 windows x 8192 lanes of random 256-bit
    digits) and at `recover`, one 4096-signature chunk of the recovery
    (`secp.recover_layout`: [R_i, G] interleaved, full-width u1, u2); the
    secp table build at that chunk's 8192 lanes; secp_add at 8192 lanes
    and at 4096, the chunk's pair add; the square root at chip_smoke.py's
    16,384-lane check and at the 10,000-signature recovery's 9,980 lanes;
    the Montgomery conversions of a chunk, into form on the pack's (24,
    8192) words and out of it on a (25, 8192) buffer with a flag row;
  * the other kernels of the same source (fp_mul, g1_dbl; g2_dbl, g2_add;
    secp_fp_mul, secp_dbl) at 8192 lanes, the field products on the
    points' X words;
  * the GLV era's fixed-base kernels at N=64's and N=256's shapes
    (`FIXED_ERAS`): g1_fixed_tables over N keys, g1_fixed_scan over the
    N x N key lanes of 64-bit RLC digits over the shipped library's
    tables.

A baseline's fixed-base kernels are compared with the shipped ones as
affine points (and the scan's infinity flags exactly), not word for word:
the shipped g1_fixed_tables builds its tables in log depth and
g1_fixed_scan sums a lane's windows over 4 sub-lanes in another order, so
their Jacobian words differ from an earlier design's by design.

`csrc/rs.cu` (`--sources rs`) is built at each value of its rows a thread,
`LT_RS8_ROWS` in RS_ROWS[8] and `LT_RS16_ROWS` in RS_ROWS[16] (the shipped
value too, a second build of the same code: its spread is the noise), and
its kernels are timed at every launch shape of the RBC flushes (`RS_SHAPES`:
N=64's encode, decode of 64 erasure patterns and re-encode, a 10,000-
transaction block's re-encode; N=256's encode, decode of 256 patterns and
re-encode), the shipped library also at other tiles than the wrapper's
(`RS_TILES`); every output must equal the shipped library's at the
wrapper's tiles word for word.

`--baseline DIR` also builds DIR's `lachain_tpu_torch/csrc/g1.cu`, `g2.cu`,
`secp.cu` and `rs.cu` as they are (an unpacked earlier commit, e.g. `git archive
<commit> | tar -x -C _scratch/base`) and times them in the same rounds,
labelled `<source>_baseline_<DIR's name>`; it may be given more than once;
it must have this tree's table entries, secp conversion and plain-word
square root (`lt_g1_table`, `lt_g2_table`, `lt_secp_table`,
`lt_secp_mont`); where it lacks `lt_g1_mont`, its G1 conversions and
product by beta run the path `g1_mont` replaced (`_mont_apply`: a permute
copy, the factor uploaded and expanded over every lane, one `fp_mul`
launch, a permute copy back; `torch.cat` with the flag row). A baseline
`rs.cu` without `lt_rs_geometry` (the earlier design: A as symbols, exp/log tables,
int64 group rows [A, rows, k, column end]) gets its own operands.

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

import numpy as np
import torch

from .crypto import bls12381 as bls
from .crypto import ecdsa
from .ops import _build, g1, g2, glv, rs_batch, secp

LANES = 8192
ROUNDS = 10  # timing rounds, their order alternating
SCANS = ("g1", "g2", "secp")  # the sources, each with its group-field scan
# the values of T each source is built at (T must divide the field's words)
T_VALUES = {"g1": (1, 2, 4), "g2": (1, 2, 4), "secp": (1, 2, 4, 8)}
SQRT_LANES = {"check": 16384, "recover": 9980}
# the main path's layout of each scan, beside the random-digit `check`
MAIN_LAYOUT = {"g1": "tpke", "g2": "coin", "secp": "recover"}
# the fixed-base kernels' shapes: N keys, N slots x N key lanes
FIXED_ERAS = (64, 256)

# `dbltrio`: the doublings a lane on three groups of a warp, each group
# taking one of a level's three independent products (3 levels: G1's 7
# products 3 deep, G2's Fp2 operations 8 Fp products deep), results read
# by shuffles from the trio's groups; 2 lanes a warp at T = 4, groups 6 and
# 7 idle. It issued 1.7 (G1) and 2 (G2) times the instructions a lane of
# the shipped doublings and ran 1.7 and 2.2 times slower (PERF.md, PR 16).
_GROUP_BLOCKS = """inline int group_blocks(int n) {
  return (int)(((long long)n * T + BLOCK - 1) / BLOCK);
}
"""
_TRIO = """
struct Trio {
  int lane, slot;
  bool live;
};

// group j of a warp works at slot j % 3 on the warp's lane j / 3
template <int T, int BLOCK>
__device__ __forceinline__ Trio trio_lane(int n) {
  constexpr int LANES = 32 / T / 3;
  const int gi = (int)(threadIdx.x & 31u) / T;
  const int lane =
      (int)((blockIdx.x * (unsigned)BLOCK + threadIdx.x) / 32u) * LANES + gi / 3;
  Trio t;
  t.live = gi / 3 < LANES && lane < n;
  t.lane = t.live ? lane : 0;
  t.slot = gi % 3;
  return t;
}

// the first group of this thread's trio (0 for the groups left over)
template <int T>
__device__ __forceinline__ int trio_base() {
  const int trio = (int)(threadIdx.x & 31u) / T / 3;
  return trio < 32 / T / 3 ? 3 * trio : 0;
}

template <int T, int BLOCK>
inline int trio_blocks(int n) {
  constexpr int LANES = 32 / T / 3 * (BLOCK / 32);
  return (n + LANES - 1) / LANES;
}
"""
_Z_POW2 = "// q.z^2 and q.z^3 for g2_add_g"
_G2_TRIO = """template <int T>
__device__ __forceinline__ Fp2G<T> from_trio2(const Group<T>& g,
                                              const Fp2G<T>& x, int src) {
  const int lane = (trio_base<T>() + src) * T + g.rank;
  Fp2G<T> r;
#pragma unroll
  for (int j = 0; j < NL / T; ++j) {
    r.c0.v[j] = __shfl_sync(g.mask, x.c0.v[j], lane);
    r.c1.v[j] = __shfl_sync(g.mask, x.c1.v[j], lane);
  }
  return r;
}

// level 1 (X X, Y Y, Y Z) as Karatsuba products, level 2 three squares,
// level 3 E (D - X3)
template <int T>
__device__ __forceinline__ Pt2G<T> g2_dbl_trio(const Group<T>& g,
                                               const Pt2G<T>& p) {
  const int slot = ((int)(threadIdx.x & 31u) / T) % 3;
  const Fp2G<T> a1 = slot == 0 ? p.x : p.y;
  const Fp2G<T> b1 = slot == 0 ? p.x : slot == 1 ? p.y : p.z;
  const Fp2G<T> r1 = fp2g_mul(g, a1, b1);
  const Fp2G<T> A = from_trio2(g, r1, 0), B = from_trio2(g, r1, 1);
  const Fp2G<T> YZ = from_trio2(g, r1, 2);
  const Fp2G<T> XB = fp2g_add(g, p.x, B);
  const Fp2G<T> E = fp2g_add(g, fp2g_dbl(g, A), A);
  const Fp2G<T> a2 = slot == 0 ? B : slot == 1 ? XB : E;
  const Fp2G<T> r2 = fp2g_sqr(g, a2);
  const Fp2G<T> C = from_trio2(g, r2, 0), XB2 = from_trio2(g, r2, 1);
  const Fp2G<T> F = from_trio2(g, r2, 2);
  Fp2G<T> D = fp2g_dbl(g, fp2g_sub(g, fp2g_sub(g, XB2, A), C));
  Pt2G<T> r;
  r.x = fp2g_sub(g, F, fp2g_dbl(g, D));
  const Fp2G<T> C8 = fp2g_dbl(g, fp2g_dbl(g, fp2g_dbl(g, C)));
  r.y = fp2g_sub(g, fp2g_mul(g, E, fp2g_sub(g, D, r.x)), C8);
  r.z = fp2g_dbl(g, YZ);
  return r;
}

"""

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
    "chainserial": (("g1",), {"g1.cu": [
        ("      for (int i = 0; i < WINDOW; ++i) p = g1_dbl_warp(g, p);",
         "      for (int i = 0; i < WINDOW; ++i) p = g1_dbl_g(g, p);")]}),
    "dbltrio": (("g1", "g2"), {
        "coop.cuh": [(_GROUP_BLOCKS, _GROUP_BLOCKS + _TRIO)],
        "g1.cu": [("x.v[j], src * T + g.rank);", "x.v[j], (trio_base<T>() + src) * T + g.rank);"),
                  ("""  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const PtG<T> r = g1_dbl_g(g, load_pt_g(g, p, n, col));
  if (live) store_pt_g(g, out, n, col, r);
""", """  const Trio t = trio_lane<T, SCAN_BLOCK>(n);
  const PtG<T> r = g1_dbl_warp(g, load_pt_g(g, p, n, t.lane));
  if (t.live)
    store_fpg(g, out, t.slot * NL, n, t.lane,
              t.slot == 0 ? r.x : t.slot == 1 ? r.y : r.z);
"""), ("dbl_kernel<SCAN_T><<<group_blocks<SCAN_T, SCAN_BLOCK>(n)",
       "dbl_kernel<SCAN_T><<<trio_blocks<SCAN_T, SCAN_BLOCK>(n)")],
        "g2.cu": [(_Z_POW2, _G2_TRIO + _Z_POW2),
                  ("""  bool live;
  const int col = group_lane<T, SCAN_BLOCK>(n, live);
  const Pt2G<T> r = g2_dbl_g(g, load_pt2_g(g, p, n, col));
  if (live) store_pt2_g(g, out, n, col, r);
""", """  const Trio t = trio_lane<T, SCAN_BLOCK>(n);
  const Pt2G<T> r = g2_dbl_trio(g, load_pt2_g(g, p, n, t.lane));
  if (t.live) {
    const Fp2G<T>& c = t.slot == 0 ? r.x : t.slot == 1 ? r.y : r.z;
    store_fpg(g, out, 2 * t.slot * NL, n, t.lane, c.c0);
    store_fpg(g, out, (2 * t.slot + 1) * NL, n, t.lane, c.c1);
  }
"""), ("""    g2_dbl_kernel<SCAN_T>
        <<<group_blocks<SCAN_T, SCAN_BLOCK>(n)""", """    g2_dbl_kernel<SCAN_T>
        <<<trio_blocks<SCAN_T, SCAN_BLOCK>(n)""")]}),
    "dblcall": (("g1",), {"g1.cu": [
        ("g1_dbl_g(g, load_pt_g(g, p, n, col))",
         "g1_dbl_g<T, MulCall>(g, load_pt_g(g, p, n, col))")]}),
    "mulinline": (("g1",), {"g1.cu": [("<T, MulCall>", "<T, MulInline>")]}),
    "fp2inline": (("g2",), {"g2.cu": [
        (f"__device__ __noinline__ Fp2G<T> fp2g_{op}(",
         f"__device__ __forceinline__ Fp2G<T> fp2g_{op}(") for op in ("mul", "sqr")
    ]}),
}

# kernels first, longest names first: "dbl_kernel" is inside "g2_dbl_kernel"
_NAMES = ("g1_fixed_tables_kernel", "g1_fixed_scan_kernel", "rs_matmul8_kernel", "rs_matmul16_kernel", "secp_msm_scan_kernel", "g2_msm_scan_kernel", "msm_scan_kernel",
          "secp_table_kernel", "g2_table_kernel", "g1_table_kernel",
          "secp_mont_kernel", "g1_mont_kernel",
          "secp_fp_mul_kernel", "secp_dbl_kernel",
          "secp_add_kernel", "secp_sqrt_kernel", "g2_dbl_kernel",
          "g2_add_kernel", "fp_mul_kernel", "dbl_kernel", "add_kernel",
          "secp_add", "g2_dbl", "g2_add", "g1_dbl", "g1_add",
          "fp2g_mul", "fp2g_sqr")


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


def variant_sources(work: Path, shipped_t: dict, baselines=(), scans=SCANS) -> dict:
    """{label: (source, include dir, -D defines)}: each of `scans` at the
    other values of T, each VARIANTS edit at the shipped T in its own copy
    of csrc/, and each baseline checkout's sources."""
    out = {}
    for scan in scans:
        macro = f"LT_{scan.upper()}_SCAN_T"
        for t in T_VALUES[scan]:
            if t != shipped_t[scan]:
                out[f"{scan}_T{t}"] = (_build.CSRC / f"{scan}.cu", _build.CSRC,
                                       [f"-D{macro}={t}"])
    for name, (variant_scans, edits) in VARIANTS.items():
        for scan in (s for s in variant_scans if s in scans):
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
        for scan in scans:
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
                # a baseline may lack an entry of this tree (g1_mont)
                if name.startswith(f"lt_{scan_of(label)}_") and hasattr(lib, name):
                    getattr(lib, name).argtypes = args
                    getattr(lib, name).restype = ctypes.c_int
            if scan_of(label) == "rs" and not hasattr(lib, "lt_rs_geometry"):
                for name in ("lt_rs_matmul8", "lt_rs_matmul16"):  # the earlier entries
                    getattr(lib, name).argtypes = _RS_BASELINE_ARGS
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
    g1_flag = torch.randint(0, 2, (1, LANES), dtype=torch.int32, device=dev)
    tab1, tab2 = g1.build_table(tpke), g2.build_table2(pts2[:, :LANES].contiguous())
    pts3 = secp.pt_pack(glv.point_run(rng, 2 * LANES, ecdsa._mul, ecdsa._add,
                                      ecdsa.G, ecdsa.N), dev)
    rec_pts, rec_digits = secp.recover_layout(rng)
    rec = secp.pt_pack(rec_pts, dev)
    sqrt_x = {k: [0, 1, ecdsa.P - 1, ecdsa.GX][:m]
              + [rng.randrange(ecdsa.P) for _ in range(m - 4)]
              for k, m in SQRT_LANES.items()}
    sqrt_in = {k: secp._upload_words(secp._words(x), dev) for k, x in sqrt_x.items()}
    flag = torch.randint(0, 2, (1, LANES), dtype=torch.int32, device=dev)
    on = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    half = lambda t, m: t[:, :m].contiguous()  # noqa: E731
    p1, q1 = half(pts1, LANES), pts1[:, LANES:].contiguous()
    p3, q3 = half(pts3, LANES), pts3[:, LANES:].contiguous()
    fixed = {}
    for k in FIXED_ERAS:
        ykeys = g1.g1_pack(glv.point_run(rng, k), dev)
        rlc = [rng.randrange(1, 1 << 64) for _ in range(k * k)]
        rlc[0], rlc[1] = 0, 0xF00000000000000F  # an all-zero lane, zero windows
        fixed[k] = (ykeys, g1.fixed_tables(ykeys), on(glv.digits_col(rlc, glv.W64)))
    return {
        "g1": {"check": (g1.build_table(p1), on(random_digits(rng, LANES, glv.W128))),
               "fixed": fixed,
               "tpke": (tab1, on(g1.tpke_digits(rng))),
               "tables": {"check": p1, "tpke": tpke,
                          "coin": g1.g1_pack(keys * 64, dev)},
               "adds": {"check": (p1, q1), "tree": (half(p1, 256), half(q1, 256))},
               # plain words of the eras' packs, a fused fetch buffer, the
               # share X that phi multiplies by beta
               "mont": {"into": g1.mont_convert(half(tpke, LANES // 2), into=False),
                        "into_g2": g1.mont_convert(half(pts2, LANES // 2), into=False),
                        "out": torch.cat([p1, g1_flag]),
                        "beta": half(tpke[: g1.NL], LANES // 2)},
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
                 "sqrt": sqrt_in,  # plain words
                 "mont": {"into": secp.mont_convert(rec, into=False),
                          "out": torch.cat([rec, flag])},
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


def _table(lib, scan: str, lanes):
    """([launch()], (table,)) of `scan`'s table build over `lanes`."""
    m, stream = lanes.shape[-1], g1._stream(lanes)
    table = torch.empty((glv.TABLE,) + tuple(lanes.shape), dtype=torch.int32,
                        device=lanes.device)
    fn = getattr(lib, f"lt_{scan}_table")
    return [lambda: _check(fn(lanes.data_ptr(), table.data_ptr(), m, stream))], (table,)


def _add(lib, scan: str, p, q):
    out, n, stream = torch.empty_like(p), p.shape[-1], g1._stream(p)
    fn = getattr(lib, f"lt_{scan}_add")
    return [lambda: _check(fn(p.data_ptr(), q.data_ptr(), out.data_ptr(), n,
                              stream))], (out,)


def _fixed_tables(lib, keys):
    k, stream = keys.shape[-1], g1._stream(keys)
    tables = torch.empty((glv.W64, glv.TABLE, 3 * g1.NL, k), dtype=torch.int32,
                         device=keys.device)
    return [lambda: _check(lib.lt_g1_fixed_tables(keys.data_ptr(), tables.data_ptr(),
                                                  k, stream))], (tables,)


def _fixed_scan(lib, tables, digits):
    k, n, stream = tables.shape[-1], digits.shape[-1], g1._stream(tables)
    acc = torch.empty((3 * g1.NL, n), dtype=torch.int32, device=tables.device)
    flags = torch.empty((n,), dtype=torch.bool, device=tables.device)
    return [lambda: _check(lib.lt_g1_fixed_scan(
        tables.data_ptr(), digits.data_ptr(), acc.data_ptr(), flags.data_ptr(), n, k,
        stream))], (acc, flags)


def _columns(t):
    """(36, n) points, or (16, 16, 36, K) tables as (36, 256 K) points."""
    if t.dim() == 4:
        t = t.permute(2, 0, 1, 3).reshape(3 * g1.NL, -1)
    return t.contiguous()


def same_points(a, b) -> bool:
    """Card points a and b (Montgomery words; (36, n) or fixed-base tables)
    are the same affine points lane by lane: X1 Z2^2 = X2 Z1^2 and Y1 Z2^3
    = Y2 Z1^3 mod p, Z = 0 (infinity) on both sides or neither."""
    ca = g1.g1_coords(_columns(a))
    cb = g1.g1_coords(_columns(b))
    n, p = len(ca) // 3, bls.P
    for i in range(n):
        x1, y1, z1 = ca[i], ca[n + i], ca[2 * n + i]
        x2, y2, z2 = cb[i], cb[n + i], cb[2 * n + i]
        if (z1 == 0) != (z2 == 0):
            return False
        if z1 == 0:
            continue
        z11, z22 = z1 * z1 % p, z2 * z2 % p
        if (x1 * z22 - x2 * z11) % p or (y1 * z22 * z2 - y2 * z11 * z1) % p:
            return False
    return True


def _sqrt(lib, x):
    """([launch()], outputs) of the square root on plain words."""
    out, n, stream = torch.empty_like(x), x.shape[-1], g1._stream(x)
    return [lambda: _check(lib.lt_secp_sqrt(x.data_ptr(), out.data_ptr(), n,
                                            stream))], (out,)


# the conversions' directions: (module, {direction: (raw word factor of
# the product, the op of lt_<scan>_mont)})
_MONT = {
    "secp": (secp, {"out": (1, 0), "into": (secp._R2, 1)}),
    "g1": (g1, {"out": (1, g1._MONT_OUT), "into": (g1._R2, g1._MONT_INTO),
                "into_g2": (g1._R2, g1._MONT_INTO),
                "beta": (g1._BETA_R, g1._MONT_BETA)}),
}


def _mont_apply(lib, scan: str, t, factor: int):
    """The conversion before `<scan>_mont`, through `lib`'s fp_mul: a
    permute copy of the coordinates, the word factor (R^2 mod p, 1 or beta
    R) uploaded and expanded over every lane, one launch, a permute copy
    back, and a `torch.cat` with a flag row -> (launch(), out holder)."""
    mod = _MONT[scan][0]
    nl = mod.NL
    rows, n = t.shape
    c = rows // nl
    fp_mul = getattr(lib, f"lt_{scan}_fp_mul")
    holder = []

    def run():
        flat = t[: c * nl].view(c, nl, n).permute(1, 0, 2)
        flat = flat.reshape(nl, c * n).contiguous()
        k = torch.from_numpy(mod._words([factor]).view(np.int32)).to(t.device)
        k = k.expand(nl, c * n).contiguous()
        prod = torch.empty_like(flat)
        _check(fp_mul(flat.data_ptr(), k.data_ptr(), prod.data_ptr(), c * n,
                      g1._stream(t)))
        out = prod.view(nl, c, n).permute(1, 0, 2).reshape(c * nl, n)
        if rows > c * nl:
            out = torch.cat([out, t[c * nl :]], dim=0)
        holder[:] = [out.contiguous()]
    return run, holder


def _mont(lib, scan: str, t, direction: str):
    """([launch()], outputs) of one conversion of `t`: one `lt_<scan>_mont`
    launch, or an earlier tree's `_mont_apply` path."""
    factor, op = _MONT[scan][1][direction]
    entry = getattr(lib, f"lt_{scan}_mont", None)
    if entry is None:
        run, holder = _mont_apply(lib, scan, t, factor)
        return [run], lambda: tuple(holder)
    out, stream = torch.empty_like(t), g1._stream(t)
    return [lambda: _check(entry(t.data_ptr(), out.data_ptr(), t.shape[0],
                                 t.shape[1], op, stream))], (out,)


def launchers(lib, scan: str, inputs: dict) -> dict:
    """{kernel: ([launch()], outputs)} of one library's kernels of `scan`'s
    source on the shared inputs. Outputs are tensors, or a function that
    gives them after the launches."""
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
    for layout, x in inp.get("sqrt", {}).items():
        out[f"sqrt_{layout}"] = _sqrt(lib, x)
    for direction, t in inp.get("mont", {}).items():
        out[f"mont_{direction}"] = _mont(lib, scan, t, direction)
    if scan == "g1":
        for k, (keys, tables, digits) in inp["fixed"].items():
            out[f"fixed_tables_n{k}"] = _fixed_tables(lib, keys)
            out[f"fixed_scan_n{k}"] = _fixed_scan(lib, tables, digits)
    if scan in ("g1", "secp"):  # the field product on the points' X words
        nl = (g1 if scan == "g1" else secp).NL
        x, y, o1 = p[:nl].contiguous(), q[:nl].contiguous(), torch.empty_like(p[:nl])
        mul = getattr(lib, f"lt_{scan}_fp_mul")
        out["fp_mul" if scan == "g1" else "secp_fp_mul"] = ([lambda: _check(mul(
            x.data_ptr(), y.data_ptr(), o1.data_ptr(), n, stream))], (o1,))
    od = torch.empty_like(p)
    out[f"{scan}_dbl"] = ([lambda: _check(getattr(lib, f"lt_{scan}_dbl")(
        p.data_ptr(), od.data_ptr(), n, stream))], (od,))
    return out


# torch.cuda._sleep cycles that hold the stream while the host enqueues a
# timing's launches (~2 ms at 1.98 GHz, more than 100 launches take), so
# that the events time the device alone: unheld, a kernel shorter than its
# launch's host time (~7-8 us through ctypes) reads the enqueue rate
HOLD_CYCLES = 4_000_000


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# the Reed-Solomon product
# ---------------------------------------------------------------------------

# rows a thread (`LT_RS8_ROWS`, `LT_RS16_ROWS`) each field's kernel is built at
RS_ROWS = {8: (2, 4, 8, 16), 16: (1, 2, 4)}
# the tiles the shipped library is timed at: the wrapper's (`tiles_for`),
# "wide" (as many units an item as a block has threads: fewer, larger
# items) and "narrow" (half the wrapper's ctile: more, smaller items)
RS_TILES = ("auto", "wide", "narrow")
# shape -> (bits, (rows, k, columns) of its groups, timing reps); the N=64
# encode and decode twice: 131 columns a group as they lie (ragged words
# shared by two groups) and from 4-column boundaries (131 -> 132)
RS_SHAPES = {
    "n64_encode": (8, [(64, 22, 131)], 100),
    "n64_encode_aligned": (8, [(64, 22, 132)], 100),
    "n64_decode": (8, [(22, 22, 131)] * 64, 100),
    "n64_decode_aligned": (8, [(22, 22, 132)] * 64, 100),
    "n64_reencode": (8, [(64, 22, 8384)], 100),
    "block10k": (8, [(64, 22, 82624)], 20),
    "n256_encode": (16, [(256, 86, 5)], 100),
    "n256_decode": (16, [(86, 86, 5)] * 256, 50),
    "n256_reencode": (16, [(256, 86, 1280)], 50),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the earlier design's lt_rs_matmul<bits>(exp, log, groups, G, b, C, out, R, stream)
_RS_BASELINE_ARGS = [_P, _P, _P, _I, _P, _I, _P, _I, _P]


def rs_variant_sources(baselines=()) -> dict:
    """{label: (source, include dir, -D defines)}: rs.cu at each value of
    RS_ROWS, and each baseline checkout's rs.cu."""
    out = {f"rs_rows{bits}_{r}": (_build.CSRC / "rs.cu", _build.CSRC,
                                  [f"-DLT_RS{bits}_ROWS={r}"])
           for bits, values in RS_ROWS.items() for r in values}
    for base in baselines:
        csrc = Path(base) / "lachain_tpu_torch" / "csrc"
        out[f"rs_baseline_{Path(base).name}"] = (csrc / "rs.cu", csrc, [])
    return out


def rs_inputs(seed: int, dev) -> dict:
    """{shape: (bits, A matrices (numpy), B on the card, widths)}: the
    codec's Vandermonde matrices and GF(2^8) inverses; the 256 GF(2^16)
    decode matrices random nonzero symbols (256 Gauss-Jordan inverses at k
    = 86 take ~20 s on the host; neither kernel's work depends on the
    values beyond their zeros)."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    out = {}
    for name, (bits, shapes, _reps) in RS_SHAPES.items():
        field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
        mats = []
        for r, k, _c in shapes:
            if len(shapes) == 1:
                mats.append(rs_batch.vandermonde(field, k, r))
            elif bits == 8:
                xs = tuple(sorted(pyrng.sample(range(1, 65), k)))
                mats.append(rs_batch._inverse_for(field, k, xs))
            else:
                mats.append(rng.integers(1, field.order + 1, (r, k)).astype(field.dtype))
        k = max(k for _r, k, _c in shapes)
        b = rng.integers(0, field.order + 1, (k, sum(c for *_x, c in shapes)))
        out[name] = (bits, mats, torch.from_numpy(b.astype(field.dtype)).to(dev),
                     [c for *_x, c in shapes])
    return out


def rs_tiles(lib, bits: int, info, widths, rows: int, which: str, dev):
    """(rtile, ctile, kd) of `which` in RS_TILES for `lib`'s kernel over
    the groups `info` (`rs_batch.group_info`)."""
    geom = rs_batch.geometry(lib, bits)
    rtile, ctile, kd = rs_batch.group_rows(bits, info, widths, rows, None, geom,
                                           rs_batch._sms(dev))[2]
    nrb = -(-rtile // geom[0])
    if which == "wide":
        ctile = min(geom[2] // nrb, geom[4])
    elif which == "narrow":
        ctile = max(1, ctile // 2)
    return rtile, ctile, kd


def rs_launcher(lib, inp, which: str = "auto"):
    """(launch(), out) of one rs_matmul launch of `lib` on `inp`: this
    tree's operands (the matrices' forms, group rows with items) cut at
    tiles `which`, or an earlier design's baseline (A as symbols, its exp/log, its
    group rows); group rows and output made once, outside the timing."""
    bits, mats, b, widths = inp
    dev, stream = b.device, g1._stream(b)
    rows, cols = max(m.shape[0] for m in mats), b.shape[1]
    out = torch.empty((rows, cols), dtype=b.dtype, device=dev)
    fn = getattr(lib, f"lt_rs_matmul{bits}")
    if hasattr(lib, "lt_rs_geometry"):
        forms = [torch.from_numpy(rs_batch.operand(bits, m)).to(dev) for m in mats]
        info = rs_batch.group_info(bits, forms)
        tiles = rs_tiles(lib, bits, info, widths, rows, which, dev)
        host, items, _tiles = rs_batch.group_rows(bits, info, widths, rows, tiles)
        groups = torch.as_tensor(host, dtype=torch.int64).to(dev)
        args = (groups.data_ptr(), len(mats), items, b.data_ptr(), cols, out.data_ptr(),
                rows, *tiles, stream)
        if bits == 16:
            exp, log = rs_batch._tables16(dev)
            args = (exp.data_ptr(), log.data_ptr()) + args
        keep = (forms, groups)
    else:
        field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
        amats = [torch.from_numpy(np.ascontiguousarray(m)).to(dev) for m in mats]
        exp = torch.from_numpy(field.exp[: field.order].copy()).to(dev)
        log = torch.from_numpy(field.log.astype(field.dtype)).to(dev)
        ends = np.cumsum(widths).tolist()
        groups = torch.tensor([[m.data_ptr(), m.shape[0], m.shape[1], e]
                               for m, e in zip(amats, ends)], dtype=torch.int64).to(dev)
        args = (exp.data_ptr(), log.data_ptr(), groups.data_ptr(), len(mats), b.data_ptr(),
                cols, out.data_ptr(), rows, stream)
        keep = (amats, exp, log, groups)

    def launch(_keep=keep):  # the operands live as long as the launcher
        _check(fn(*args))
    return launch, out


def rs_sweep(libs: dict, inputs: dict, rounds: int) -> dict:
    """Every library's launches at every shape of its fields, the shipped
    one at each of RS_TILES: outputs equal to the shipped library's at the
    wrapper's tiles, and CUDA-event ms in `rounds` alternating rounds."""
    runs = {}
    for label, lib in libs.items():
        for shape, inp in inputs.items():
            bits = inp[0]
            if label.startswith("rs_rows") and not label.startswith(f"rs_rows{bits}_"):
                continue
            for which in (RS_TILES if label == "rs_shipped" else ("auto",)):
                runs[f"{label}/{shape}/{which}"] = rs_launcher(lib, inp, which)
    for fn, _out in runs.values():
        fn()
    torch.cuda.synchronize()

    def words(t):
        return t.view(torch.int16) if t.dtype == torch.uint16 else t

    equal = {key: bool(torch.equal(words(out), words(runs[f"rs_shipped/{key.split('/')[1]}/auto"][1])))
             for key, (_fn, out) in runs.items() if key.split("/")[0] != "rs_shipped"
             or not key.endswith("/auto")}
    ms: dict = {}
    order = list(runs.items())
    for i in range(rounds):
        for key, (fn, _out) in (order if i % 2 == 0 else order[::-1]):
            ms.setdefault(key, []).append(round(cuda_ms(fn, RS_SHAPES[key.split("/")[1]][2]), 5))
    return {"equal_to_shipped": equal, "ms": ms,
            "median_ms": {k: statistics.median(v) for k, v in ms.items()}}


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
    ap.add_argument("--sources", nargs="+", default=list(SCANS) + ["rs"],
                    choices=list(SCANS) + ["rs"], help="the sources to sweep")
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
    scans = tuple(s for s in SCANS if s in args.sources)
    shipped_t = {s: attrs[f"{s}_msm_scan"]["threads_per_lane"] for s in SCANS}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    report = {"card": smi, "seed": args.seed, "shipped_t": shipped_t,
              "attrs_shipped": attrs}
    equal = {}
    try:
        t0 = time.perf_counter()
        sources = variant_sources(work, shipped_t, args.baseline, scans) if scans else {}
        if "rs" in args.sources:
            sources.update(rs_variant_sources(args.baseline))
        built = build_variants(work, sources)
        print(f"variants built in {time.perf_counter() - t0:.1f} s: "
              f"{ {k: ('ok' if 'lib' in v else 'FAILED', v['nvcc_s']) for k, v in built.items()} }",
              flush=True)
        report["build"] = {k: {kk: vv for kk, vv in v.items() if kk != "lib"}
                           for k, v in built.items()}
        if scans:
            inputs = make_inputs(args.seed, dev)
            libs = {f"{s}_shipped": shipped for s in scans}
            libs.update((k, v["lib"]) for k, v in built.items()
                        if "lib" in v and scan_of(k) in scans)
            runs = {label: launchers(lib, scan_of(label), inputs)
                    for label, lib in libs.items()}
            for kernels in runs.values():
                for launches, _ in kernels.values():
                    for fn in launches:
                        fn()
            torch.cuda.synchronize()

            def tensors(outs):
                return outs() if callable(outs) else outs

            def same(label, k, outs):
                ref = tensors(runs[f"{scan_of(label)}_shipped"][k][1])
                if "_baseline_" in label and k.startswith("fixed_tables"):
                    return same_points(tensors(outs)[0], ref[0])
                if "_baseline_" in label and k.startswith("fixed_scan"):
                    (acc, flags), (racc, rflags) = tensors(outs), ref
                    return bool(torch.equal(flags, rflags)) and same_points(
                        acc[:, ~flags], racc[:, ~rflags])
                return all(torch.equal(a, b) for a, b in zip(tensors(outs), ref))

            equal.update({
                f"{label}/{k}": same(label, k, outs)
                for label, kernels in runs.items() if not label.endswith("shipped")
                for k, (_, outs) in kernels.items()
            })
            reps = {"g1": 10, "g2": 5, "secp": 10}
            ms: dict = {}
            order = [(label, k, launches) for label, kernels in runs.items()
                     for k, (launches, _) in kernels.items()]
            for i in range(ROUNDS):
                for label, k, launches in (order if i % 2 == 0 else order[::-1]):
                    long = k.startswith(("scan", "sqrt", "fixed")) or "_table" in k
                    r = reps[scan_of(label)] if long else 100
                    ms.setdefault(f"{label}/{k}", []).append(
                        round(sum(cuda_ms(fn, r) for fn in launches), 5))
            report.update(ms=ms, median_ms={k: statistics.median(v) for k, v in ms.items()})
        if "rs" in args.sources:
            libs = {"rs_shipped": shipped}
            libs.update((k, v["lib"]) for k, v in built.items()
                        if "lib" in v and scan_of(k) == "rs")
            report["rs"] = rs_sweep(libs, rs_inputs(args.seed, dev), ROUNDS)
            report["rs"]["geometry"] = {
                label: {bits: rs_batch.geometry(lib, bits) for bits in (8, 16)}
                for label, lib in libs.items() if hasattr(lib, "lt_rs_geometry")}
            equal.update({f"rs/{k}": v for k, v in report["rs"]["equal_to_shipped"].items()})
        report["equal_to_shipped"] = equal
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
