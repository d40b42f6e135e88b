"""G2 coin-era engine: the kernel wrappers and pg2's composite programs.

The port of `lachain_tpu/ops/pg2.py`. Four wrappers front the CUDA kernels
of `csrc/g2.cu` (`g2_dbl`, `g2_add`, `build_table2`, `msm2_scan`); the
composites above them (`msm2_windowed`, `tree_reduce2_k`, `ts_era_kernel`,
`msm2_reduce`) are plain tensor code over those wrappers and, for the key
aggregate of the coin era, over the G1 composites of `ops/g1.py`.

Every wrapper dispatches on the device its tensors lie on, and on nothing
else: on `cuda` it launches its kernel (or raises), on `cpu` it runs the
plain version in `ops/g2_ref.py`. Point layouts, each the natural one for
its arithmetic:
  * cuda: (72, n) int32, six Fp components X.c0 | X.c1 | Y.c0 | Y.c1 |
    Z.c0 | Z.c1 of 12 Montgomery words each;
  * cpu:  (288, n) int64, pg2's 44 x 10-bit plain limbs per component in
    48-row slots, so the CPU tests compare with pg2 limb for limb.
`g2_pack` / `g2_coords` convert oracle points through `g1.encode_words` /
`g1.fp_decode` (on the card one `g1_mont` launch over the (72, n) buffer); `g2_unpack_host` reads oracle tuples
from a buffer that `g1.fetch` brought to the host (pg2.g2_unpack).

`LAUNCHES` counts the kernel launches of each wrapper (CUDA only).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..crypto import bls12381 as bls
from . import _build, g1, g2_ref, glv
from .g1 import NL, _check, _cpu_layout, _on_cpu, _run
from .g1_ref import NLIMBS
from .glv import TABLE

ROWS2 = 6 * NL  # rows of a point on the card

LAUNCHES = {"g2_dbl": 0, "g2_add": 0, "g2_table": 0, "g2_msm_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _slots(cpu_layout: bool):
    """(rows per component slot, field rows used in each) of a layout."""
    return (g2_ref.COMP_ROWS, NLIMBS) if cpu_layout else (NL, NL)


# ---------------------------------------------------------------------------
# the four kernel wrappers
# ---------------------------------------------------------------------------


def g2_dbl(p):
    """(72, n) -> (72, n) Jacobian G2 doubling (replaces pg2 `_dbl2_kernel`)."""
    if _on_cpu(p):
        return g2_ref.dbl(p)
    n = p.shape[-1]
    _check("g2_dbl p", p, (ROWS2, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_g2_dbl, p, p.data_ptr(), out.data_ptr(), n)
    _launched("g2_dbl", rc)
    return out


def g2_add(p, q):
    """(72, n) x (72, n) -> (72, n) incomplete G2 add, p != +-q, both finite
    (replaces pg2 `_add2_kernel`)."""
    if _on_cpu(p, q):
        return g2_ref.add_incomplete(p, q)
    n = p.shape[-1]
    _check("g2_add p", p, (ROWS2, n))
    _check("g2_add q", q, (ROWS2, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_g2_add, p, p.data_ptr(), q.data_ptr(),
              out.data_ptr(), n)
    _launched("g2_add", rc)
    return out


def build_table2(lanes):
    """Points (72, n) -> (16, 72, n): entry k = k*P, entry 0 zero and never
    selected, in one launch (replaces pg2 `build_table2`, :356: its one
    `_dbl2_kernel` and 13 chained `_add2_kernel` launches, whose values it
    gives word for word)."""
    if _on_cpu(lanes):
        return g2_ref.build_table(lanes)
    n = lanes.shape[-1]
    _check("build_table2 lanes", lanes, (ROWS2, n))
    table = torch.empty((TABLE, ROWS2, n), dtype=torch.int32, device=lanes.device)
    rc = _run(_build.library().lt_g2_table, lanes, lanes.data_ptr(),
              table.data_ptr(), n)
    _launched("g2_table", rc)
    return table


def msm2_scan(table, digits, digits_checked: bool = False):
    """table (16, 72, n), digits (W, n) int32 in [0, 16), MSB-first ->
    ((72, n) accumulators, (n,) bool infinity flags)
    (replaces pg2 `_msm2_kernel` / `_msm2_scan`). `digits_checked` as in
    g1.msm_scan."""
    if _on_cpu(table, digits):
        return g2_ref.msm_scan(table, digits)
    n = table.shape[-1]
    nwin = digits.shape[0]
    if nwin < 1:
        raise ValueError("msm2_scan: need at least one window")
    _check("msm2_scan table", table, (TABLE, ROWS2, n))
    _check("msm2_scan digits", digits, (nwin, n))
    if not digits_checked:
        lo, hi = torch.aminmax(digits)
        if lo.item() < 0 or hi.item() >= TABLE:  # the kernel indexes table[d]
            raise ValueError("msm2_scan: digits must lie in [0, 16)")
    acc = torch.empty((ROWS2, n), dtype=torch.int32, device=table.device)
    flags = torch.empty((n,), dtype=torch.bool, device=table.device)
    rc = _run(_build.library().lt_g2_msm_scan, table, table.data_ptr(),
              digits.data_ptr(), acc.data_ptr(), flags.data_ptr(), n, nwin)
    _launched("g2_msm_scan", rc)
    return acc, flags


# ---------------------------------------------------------------------------
# marshal: oracle points <-> the device's layout
# ---------------------------------------------------------------------------


def g2_pack(points: Sequence[tuple], device="cuda") -> torch.Tensor:
    """Oracle G2 Jacobian tuples -> points on `device`. Infinity maps to
    ((0,0),(1,0),(0,0)); callers carry it in flags (pg2.g2_pack)."""
    if _cpu_layout(device):
        return torch.from_numpy(g2_ref.points_to_limbs(points))
    comps = g2_ref.components(points)
    return g1.encode_words([[c[j] for c in comps] for j in range(6)], device)


def _by_component(a, slot: int, used: int):
    """(6 * slot, m) point rows -> (used, 6m): component j's lanes at
    columns [j*m, (j+1)*m)."""
    m = a.shape[-1]
    return a.reshape(6, slot, m)[:, :used].transpose(1, 0, 2).reshape(used, 6 * m)


def _g2_points(coords, n: int, fl) -> list:
    out = []
    for i in range(n):
        v = [coords[j * n + i] for j in range(6)]
        if fl[i] or (v[4] == 0 and v[5] == 0):
            out.append(bls.G2_INF)
        else:
            out.append(((v[0], v[1]), (v[2], v[3]), (v[4], v[5])))
    return out


def g2_coords(arr) -> list:
    """Points -> the 6n canonical coordinate ints, component-major:
    X.c0... | X.c1... | Y.c0... | Y.c1... | Z.c0... | Z.c1... (no infinity
    mapping)."""
    if not _cpu_layout(arr.device):
        return g1.fp_decode(arr)  # (72, n) converted as it lies
    slot, used = _slots(True)
    n = arr.shape[-1]
    comps = arr.reshape(6, slot, n)[:, :used].permute(1, 0, 2)
    return g1.fp_decode(comps.reshape(used, 6 * n))


def g2_unpack_host(rows, flags, cpu_layout: bool) -> list:
    """(6 * slot, m) numpy point rows + (m,) flags from `g1.fetch` ->
    oracle G2 Jacobian tuples; a flagged lane or Z == 0 is infinity."""
    slot, used = _slots(cpu_layout)
    coords = g1.decode_host(_by_component(rows, slot, used), cpu_layout)
    return _g2_points(coords, rows.shape[-1], flags)


# ---------------------------------------------------------------------------
# composites (pg2.py:356-448)
# ---------------------------------------------------------------------------


def msm2_windowed(lanes, digits, digits_checked: bool = False):
    """Per-lane windowed G2 scalar multiply: lanes (P, n), digits (W, n)
    MSB-first -> ((P, n) accumulators, (n,) infinity flags)."""
    return msm2_scan(build_table2(lanes), digits, digits_checked)


def tree_reduce2_k(acc, flags, k: int):
    """Sum groups of k adjacent G2 lanes (k a power of two), infinity
    carried in flags: acc (P, n), flags (n,) -> (P, n/k), (n/k,)."""
    assert k & (k - 1) == 0
    while k > 1:
        a, b = acc[:, 0::2].contiguous(), acc[:, 1::2].contiguous()
        fa, fb = flags[0::2], flags[1::2]
        r = g2_add(a, b)
        acc = torch.where(fb, a, torch.where(fa, b, r))
        flags = fa & fb
        k //= 2
    return acc, flags


def ts_era_digits(rlc16, lag64):
    """The coin era's scan digits [rlc64 | lag64] (ts_era_kernel): rlc16
    behind leading zero windows up to lag64's."""
    return torch.cat([g1.lead_zeros(rlc16, lag64.shape[0]), lag64], dim=1)


def coin_digits(rng, coins: int = 64, k: int = 64, live: int = 22):
    """ts_era_digits of seeded scalars, for timing the scan at the coin
    era's layout: a 64-bit RLC coefficient and a Lagrange coefficient on
    the first `live` lanes of each coin of k, the other lanes masked (zero
    digits; the N=64 era: 64 coins x 64 signers, t + 1 = 22 live). rng: a
    random.Random. -> (64, 2 * coins * k) int32 on the CPU."""
    n = coins * k
    rlc = [rng.randrange(1, 1 << 64) if i % k < live else 0 for i in range(n)]
    lag = [rng.randrange(1, bls.R) if i % k < live else 0 for i in range(n)]
    return ts_era_digits(g1.digits_col(rlc, glv.W64, "cpu"),
                         g1.digits_col(lag, glv.W256, "cpu"))


def coin_lanes(rng, coins: int = 64, k: int = 64, live: int = 22) -> list:
    """Oracle G2 points at the coin era's signature lanes, for timing the
    table build at its layout: distinct points P0 + i*S on the first `live`
    lanes of each coin of k, infinity on the others (masked signers).
    rng: a random.Random."""
    p = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    step = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    out = []
    for i in range(coins * k):
        if i % k < live:
            out.append(p)
            p = bls.g2_add(p, step)
        else:
            out.append(bls.G2_INF)
    return out


def ts_era_kernel(sig, y, rlc16, lag64, k: int):
    """The coin era on the device (pg2.ts_era_kernel, :391-435).

    sig: (P, S*K) signature shares (G2); y: (3R, S*K) per-lane verification
    keys (G1, tiled per coin); rlc16: (16, S*K) 64-bit RLC digits; lag64:
    (64, S*K) Lagrange digits; k = K (a power of two).

    One table build over the signature lanes serves both G2 passes: ONE
    64-window scan over [table | table] with digits [rlc64 | lag64], rlc64
    being rlc16 behind 48 leading zero windows (the flag stays set through
    them). The key RLC runs on the G1 composites. Returns one fused
    (P + 1, 3S) buffer, the flag row last:
      cols [0,   S): per-coin signature RLC aggregates (G2)  - verify
      cols [S,  2S): per-coin Lagrange combines (G2)         - the signature
      cols [2S, 3S): per-coin key RLC aggregates (G1 in rows [0, 3R), the
                     other rows zero)."""
    n = sig.shape[-1]
    table = build_table2(sig)
    acc, fl = msm2_scan(torch.cat([table, table], dim=-1),
                        ts_era_digits(rlc16, lag64))
    acc_y, fl_y = g1.msm_windowed(y, rlc16)
    out_r, ofl_r = tree_reduce2_k(acc[:, :n], fl[:n], k)
    out_l, ofl_l = tree_reduce2_k(acc[:, n:], fl[n:], k)
    out_y, ofl_y = g1.tree_reduce_k(acc_y, fl_y, k)
    s = out_r.shape[-1]
    y_padded = torch.cat([
        out_y,
        torch.zeros((sig.shape[0] - y.shape[0], s), dtype=out_y.dtype,
                    device=out_y.device),
    ], dim=0)
    pts = torch.cat([out_r, out_l, y_padded], dim=1)
    flags = torch.cat([ofl_r, ofl_l, ofl_y]).to(pts.dtype)[None, :]
    return torch.cat([pts, flags], dim=0)


def msm2_reduce(lanes, digits, k: int, digits_checked: bool = False):
    """G2 windowed MSM + tree reduce over groups of k lanes
    (pg2.msm2_reduce, :441): -> (P + 1, n/k), the flag row last."""
    acc, fl = msm2_windowed(lanes, digits, digits_checked)
    out, ofl = tree_reduce2_k(acc, fl, k)
    return torch.cat([out, ofl.to(out.dtype)[None, :]], dim=0)
