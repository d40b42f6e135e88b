"""G1 era engine: the kernel wrappers and pg1's composite programs.

The port of `lachain_tpu/ops/pg1.py`. Five wrappers front the CUDA kernels
of `csrc/g1.cu` that replace pg1's (`fp_mul`, `g1_dbl`, `g1_add`,
`build_table`, `msm_scan`), two front the port's own conversion kernel
(`mont_convert`, `mul_beta`: `g1_mont`), and two the fixed-base key
kernels that replace XLA programs of `lachain_tpu/ops/msm.py`
(`fixed_tables`, `fixed_scan`; their composites are `ops/msm.py`'s); the
composites above them
(`msm_windowed`, `tree_reduce_k`, `era_kernel`, `era_kernel_fused`,
`msm_reduce`) are plain tensor code over those wrappers.

Every wrapper dispatches on the device its tensors lie on, and on nothing
else: on `cuda` it launches its kernel (or raises), on `cpu` it runs the
plain version in `ops/g1_ref.py`. The two devices keep points in different
layouts, each the natural one for its arithmetic:
  * cuda: int32 rows holding 12 x 32-bit Montgomery limbs per coordinate,
    a point is (36, n);
  * cpu:  int64 rows holding pg1's 44 x 10-bit signed plain limbs, a point
    is (132, n), so the CPU tests compare with pg1 limb for limb.
`g1_pack` / `fp_encode` convert oracle ints into either layout (on the
card: plain words uploaded in the final layout, one `mont_convert` launch
into Montgomery form); `fetch` brings a fused output buffer (flag row last)
to the host in one copy, after one launch out of Montgomery form over the
whole buffer, and `g1_unpack_host` reads oracle tuples from it.
`g1_coords` / `fp_decode` read exact coordinates back. The composites only
ever slice a point into thirds.

`LAUNCHES` counts the kernel launches of each wrapper (CUDA only), so a run
can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..crypto import bls12381 as bls
from . import _build, g1_ref, glv
from .glv import TABLE

NL = 12  # 32-bit Montgomery limbs per coordinate on the card
_MONT_R = 1 << 384
_R2 = _MONT_R * _MONT_R % bls.P  # x * R^2 / R = x R: into Montgomery form
_BETA_R = glv.BETA * _MONT_R % bls.P  # x R * beta R / R = (x beta) R
# lt_g1_mont's op (csrc/g1.cu MontOp) -> the factor of its plain version
_MONT_OUT, _MONT_INTO, _MONT_BETA = 0, 1, 2
_MONT_FACTOR = {_MONT_OUT: 1, _MONT_INTO: _R2, _MONT_BETA: _BETA_R}

LAUNCHES = {"fp_mul": 0, "g1_dbl": 0, "g1_add": 0, "g1_table": 0,
            "g1_msm_scan": 0, "g1_mont": 0, "g1_fixed_tables": 0,
            "g1_fixed_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts) -> bool:
    """True when every tensor is on the CPU, False when all are on one CUDA
    device; raises on anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _cpu_layout(device) -> bool:
    """True where points use g1_ref's limbs (the CPU), False for the
    card's Montgomery words."""
    return torch.device(device).type == "cpu"


def _check(name: str, t, shape) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _run(fn, t, *args) -> int:
    """fn(*args, stream): a launch on t's device and its current stream
    there -> the CUDA error code. A ctypes launch goes to the host thread's
    current device, so t's is made current for the call: a mesh's shards
    (parallel/mesh.py) lie on devices other than the current one."""
    with torch.cuda.device(t.device):
        return fn(*args, _stream(t))


def fp_mul(x, y):
    """(R, n) x (R, n) -> (R, n) field product x*y mod p
    (replaces pg1 `_mul_kernel`)."""
    if _on_cpu(x, y):
        return g1_ref.fp_mul(x, y)
    n = x.shape[-1]
    _check("fp_mul x", x, (NL, n))
    _check("fp_mul y", y, (NL, n))
    out = torch.empty_like(x)
    rc = _run(_build.library().lt_g1_fp_mul, x, x.data_ptr(), y.data_ptr(),
              out.data_ptr(), n)
    _launched("fp_mul", rc)
    return out


def g1_dbl(p):
    """(3R, n) -> (3R, n) Jacobian doubling (replaces pg1 `_dbl_kernel`)."""
    if _on_cpu(p):
        return g1_ref.dbl(p)
    n = p.shape[-1]
    _check("g1_dbl p", p, (3 * NL, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_g1_dbl, p, p.data_ptr(), out.data_ptr(), n)
    _launched("g1_dbl", rc)
    return out


def g1_add(p, q):
    """(3R, n) x (3R, n) -> (3R, n) incomplete Jacobian add, p != +-q, both
    finite (replaces pg1 `_add_kernel`)."""
    if _on_cpu(p, q):
        return g1_ref.add_incomplete(p, q)
    n = p.shape[-1]
    _check("g1_add p", p, (3 * NL, n))
    _check("g1_add q", q, (3 * NL, n))
    out = torch.empty_like(p)
    rc = _run(_build.library().lt_g1_add, p, p.data_ptr(), q.data_ptr(),
              out.data_ptr(), n)
    _launched("g1_add", rc)
    return out


def build_table(lanes):
    """Points (3R, n) -> (16, 3R, n): entry k = k*P, entry 0 zero and never
    selected, in one launch (replaces pg1 `build_table`, :447: its one
    `_dbl_kernel` and 13 chained `_add_kernel` launches, whose values it
    gives word for word)."""
    if _on_cpu(lanes):
        return g1_ref.build_table(lanes)
    n = lanes.shape[-1]
    _check("build_table lanes", lanes, (3 * NL, n))
    table = torch.empty((TABLE, 3 * NL, n), dtype=torch.int32, device=lanes.device)
    rc = _run(_build.library().lt_g1_table, lanes, lanes.data_ptr(),
              table.data_ptr(), n)
    _launched("g1_table", rc)
    return table


def msm_scan(table, digits, digits_checked: bool = False):
    """table (16, 3R, n), digits (W, n) int32 in [0, 16), MSB-first ->
    ((3R, n) accumulators, (n,) bool infinity flags)
    (replaces pg1 `_msm_kernel` / `_msm_scan`).

    The card's range check reads the digits back, so it waits for the work
    queued on the stream; `digits_checked=True` skips it where the caller
    made the digits on the host with `glv.digits_col` (4-bit nibbles, in
    range by construction), so that an era dispatch never blocks."""
    if _on_cpu(table, digits):
        return g1_ref.msm_scan(table, digits)
    n = table.shape[-1]
    nwin = digits.shape[0]
    if nwin < 1:
        raise ValueError("msm_scan: need at least one window")
    _check("msm_scan table", table, (TABLE, 3 * NL, n))
    _check("msm_scan digits", digits, (nwin, n))
    if not digits_checked:
        lo, hi = torch.aminmax(digits)
        if lo.item() < 0 or hi.item() >= TABLE:  # the kernel indexes table[d]
            raise ValueError("msm_scan: digits must lie in [0, 16)")
    acc = torch.empty((3 * NL, n), dtype=torch.int32, device=table.device)
    flags = torch.empty((n,), dtype=torch.bool, device=table.device)
    rc = _run(_build.library().lt_g1_msm_scan, table, table.data_ptr(),
              digits.data_ptr(), acc.data_ptr(), flags.data_ptr(), n, nwin)
    _launched("g1_msm_scan", rc)
    return acc, flags


def fixed_tables(keys):
    """Keys (3R, K) -> (16, 16, 3R, K) fixed-base tables, entry [w, d] =
    d * 16^(15 - w) * Y, window w MSB-first, entry 0 zero and never
    selected, in one launch (replaces the XLA program
    `msm.y_fixed_base_tables`, msm.py:246): a block a key, its doubling
    chain once, then the 16 tables in log depth. Made once per validator
    set."""
    if _on_cpu(keys):
        return g1_ref.fixed_tables(keys)
    k = keys.shape[-1]
    _check("fixed_tables keys", keys, (3 * NL, k))
    tables = torch.empty((glv.W64, TABLE, 3 * NL, k), dtype=torch.int32,
                         device=keys.device)
    rc = _run(_build.library().lt_g1_fixed_tables, keys, keys.data_ptr(),
              tables.data_ptr(), k)
    _launched("g1_fixed_tables", rc)
    return tables


def fixed_scan(tables, digits, k_pad: int, digits_checked: bool = False):
    """tables (16, 16, 3R, k_pad) from `fixed_tables`, digits (16, n) int32
    in [0, 16), MSB-first, n a multiple of k_pad -> ((3R, n) accumulators,
    (n,) bool infinity flags): lane j sums tables[w, d_w] of key column
    j % k_pad with msm_scan's flag rules and no doubling, its windows split
    over 4 sub-lanes whose partials meet in shared memory (replaces the
    gathers of the XLA program `msm.y_agg_fixed_base`, msm.py:266).
    `digits_checked` as in msm_scan."""
    if _on_cpu(tables, digits):
        return g1_ref.fixed_scan(tables, digits, k_pad)
    n = digits.shape[-1]
    if k_pad < 1 or n % k_pad:
        raise ValueError(f"fixed_scan: {n} lanes are no multiple of k_pad {k_pad}")
    _check("fixed_scan tables", tables, (glv.W64, TABLE, 3 * NL, k_pad))
    _check("fixed_scan digits", digits, (glv.W64, n))
    if not digits_checked:
        lo, hi = torch.aminmax(digits)
        if lo.item() < 0 or hi.item() >= TABLE:  # the kernel indexes table[d]
            raise ValueError("fixed_scan: digits must lie in [0, 16)")
    acc = torch.empty((3 * NL, n), dtype=torch.int32, device=tables.device)
    flags = torch.empty((n,), dtype=torch.bool, device=tables.device)
    rc = _run(_build.library().lt_g1_fixed_scan, tables, tables.data_ptr(),
              digits.data_ptr(), acc.data_ptr(), flags.data_ptr(), n, k_pad)
    _launched("g1_fixed_scan", rc)
    return acc, flags


def _mont(t, op: int):
    """One g1_mont launch of `op` over a (12c [+ 1], n) card buffer."""
    rows, n = t.shape
    _check("g1_mont t", t, (rows, n))
    out = torch.empty_like(t)
    rc = _run(_build.library().lt_g1_mont, t, t.data_ptr(), out.data_ptr(), rows, n, op)
    _launched("g1_mont", rc)
    return out


def mont_convert(t, into: bool):
    """(12c, n) or (12c + 1, n) int32 words -> the same shape: every
    coordinate (rows 12c' .. 12c' + 11, lane-minor, as the card's G1 and G2
    buffers lie) into Montgomery form, x R mod p (`into`), or out of it, x /
    R mod p (any 384-bit x); a trailing flag row is copied as it is. One
    launch reads the buffer as it lies: no permute, no copy, no uploaded
    constant (this port's own representation; pg1 has no Montgomery form).
    A CPU tensor in the same layout takes the plain version."""
    if t.dim() != 2 or t.shape[0] < NL or t.shape[0] % NL > 1:
        raise ValueError(f"mont_convert: expected (12c [+ 1], n) rows, got {tuple(t.shape)}")
    op = _MONT_INTO if into else _MONT_OUT
    if _on_cpu(t):
        return g1_ref.mont_mul_words(t, _MONT_FACTOR[op])
    return _mont(t, op)


def mul_beta(x):
    """(R, n) field elements -> beta * x mod p, the X of phi(u) = (beta X,
    Y, Z) (era_kernel; pg1 multiplies by beta with `_mul_kernel`). On the
    card (12, n) Montgomery words, one g1_mont launch by beta R from its
    constant bank; on the CPU pg1's limbs through g1_ref.fp_mul."""
    if _on_cpu(x):
        beta = torch.from_numpy(g1_ref.ints_to_limbs([glv.BETA] * x.shape[-1]))
        return g1_ref.fp_mul(x, beta)
    _check("mul_beta x", x, (NL, x.shape[-1]))
    return _mont(x, _MONT_BETA)


# ---------------------------------------------------------------------------
# marshal: oracle ints <-> the device's layout
# ---------------------------------------------------------------------------


def _words(vals: Sequence[int]) -> np.ndarray:
    """ints in [0, 2^384) -> (12, n) uint32 little-endian words."""
    buf = b"".join(int(v).to_bytes(4 * NL, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), NL).T.copy()


def _from_words(a) -> list:
    """(12c, n) uint32 words -> the c * n ints, coordinate by coordinate:
    c0's n lanes, then c1's, ..."""
    a = np.asarray(a, dtype="<u4")
    c, n = a.shape[0] // NL, a.shape[-1]
    raw = np.ascontiguousarray(a.reshape(c, NL, n).transpose(0, 2, 1)).tobytes()
    w = 4 * NL
    return [
        int.from_bytes(raw[i * w : (i + 1) * w], "little")
        for i in range(len(raw) // w)
    ]


def plain_words(coords: Sequence[Sequence[int]]) -> np.ndarray:
    """c lists of n field ints -> (12c, n) int32 plain words in the card's
    layout (coordinate c at rows 12c .. 12c + 11), not yet in Montgomery
    form."""
    return np.concatenate([_words(v) for v in coords]).view(np.int32)


def encode_words(coords: Sequence[Sequence[int]], device) -> torch.Tensor:
    """c lists of n field ints -> (12c, n) Montgomery words on the card:
    the plain words uploaded in the final layout, then one launch into
    form."""
    return mont_convert(torch.from_numpy(plain_words(coords)).to(device), into=True)


def fp_encode(vals: Sequence[int], device="cuda") -> torch.Tensor:
    """Field ints in [0, p) -> (R, n) in the device's layout."""
    if _cpu_layout(device):
        return torch.from_numpy(g1_ref.ints_to_limbs(vals))
    return encode_words([vals], device)


def fp_decode(t) -> list:
    """(R, n) in the device's layout -> canonical field ints; on the card
    any (12c, n) buffer -> its c * n ints, coordinate by coordinate (one
    launch out of Montgomery form, one download)."""
    if _cpu_layout(t.device):
        return g1_ref.limbs_to_ints(t.numpy())
    plain = mont_convert(t.contiguous(), into=False)
    return _from_words(plain.cpu().numpy().view(np.uint32))


def g1_xyz(points) -> list:
    """Oracle Jacobian tuples -> [xs, ys, zs] with infinity as (0, 1, 0)."""
    return [[p[0] if p[2] != 0 else 0 for p in points],
            [p[1] if p[2] != 0 else 1 for p in points],
            [p[2] for p in points]]


def g1_pack(points, device="cuda") -> torch.Tensor:
    """Oracle Jacobian tuples -> (3R, n) points on `device`. Infinity maps
    to (0, 1, 0); callers carry it in flags (pg1.g1_pack)."""
    xs, ys, zs = g1_xyz(points)
    if _cpu_layout(device):
        return fp_encode(xs + ys + zs, device).view(-1, 3, len(points)).permute(
            1, 0, 2
        ).reshape(-1, len(points)).contiguous()
    return encode_words([xs, ys, zs], device)


def g1_coords(arr) -> list:
    """(3R, n) points -> the 3n canonical coordinate ints X... | Y... | Z...
    (no infinity mapping)."""
    if not _cpu_layout(arr.device):
        return fp_decode(arr)
    r, n = arr.shape[0] // 3, arr.shape[-1]
    return fp_decode(arr.reshape(3, r, n).permute(1, 0, 2).reshape(r, 3 * n))


def _g1_points(coords, n: int, fl) -> list:
    out = []
    for i in range(n):
        x, y, z = coords[i], coords[n + i], coords[2 * n + i]
        out.append(bls.G1_INF if fl[i] or z == 0 else (x, y, z))
    return out


def fetch(fused):
    """A fused (rows + 1, m) buffer, flag row last -> (numpy (rows, m) point
    rows, numpy (m,) bool flags) in ONE device->host copy. On the card the
    point rows leave Montgomery form on the device first, so they hold plain
    field words; decode them with `decode_host`."""
    if _cpu_layout(fused.device):
        a = fused.numpy()
    else:
        a = mont_convert(fused, into=False).cpu().numpy()
    return a[:-1], a[-1] != 0


def decode_host(rows, cpu_layout: bool) -> list:
    """(R, m) numpy rows from `fetch` -> m canonical field ints."""
    if cpu_layout:
        return g1_ref.limbs_to_ints(rows)
    return _from_words(np.ascontiguousarray(rows).view(np.uint32))


def g1_unpack_host(rows, flags, cpu_layout: bool) -> list:
    """(3R, m) numpy point rows + (m,) flags from `fetch` -> oracle
    Jacobian tuples; a flagged lane or Z == 0 is infinity."""
    r, m = rows.shape[0] // 3, rows.shape[-1]
    by_coord = rows.reshape(3, r, m).transpose(1, 0, 2).reshape(r, 3 * m)
    return _g1_points(decode_host(by_coord, cpu_layout), m, flags)


def digits_col(scalars: Sequence[int], nwindows: int, device="cuda"):
    """ints -> (nwindows, n) int32 MSB-first 4-bit digits on `device`."""
    return torch.from_numpy(glv.digits_col(scalars, nwindows)).to(device)


# ---------------------------------------------------------------------------
# composites (pg1.py:460-560)
# ---------------------------------------------------------------------------


def msm_windowed(lanes, digits, digits_checked: bool = False):
    """Per-lane windowed scalar multiply: lanes (3R, n), digits (W, n)
    MSB-first -> ((3R, n) accumulators, (n,) infinity flags).
    `digits_checked` as in msm_scan."""
    return msm_scan(build_table(lanes), digits, digits_checked)


def tree_reduce_k(acc, flags, k: int):
    """Sum groups of k adjacent lanes (k a power of two), infinity carried
    in flags: acc (3R, n), flags (n,) -> (3R, n/k), (n/k,)."""
    assert k & (k - 1) == 0
    while k > 1:
        a, b = acc[:, 0::2].contiguous(), acc[:, 1::2].contiguous()
        fa, fb = flags[0::2], flags[1::2]
        r = g1_add(a, b)
        acc = torch.where(fb, a, torch.where(fa, b, r))
        flags = fa & fb
        k //= 2
    return acc, flags


def lead_zeros(digits, nwin: int):
    """(W, n) MSB-first digits -> (nwin, n): the same scalars behind
    nwin - W leading zero windows (the flag stays set through them)."""
    pad = nwin - digits.shape[0]
    if pad == 0:
        return digits
    zeros = torch.zeros((pad, digits.shape[1]), dtype=digits.dtype,
                        device=digits.device)
    return torch.cat([zeros, digits], dim=0)


def era_digits(rlc16, lag1, lag2):
    """The joined scan's digits [rlc | rlc | lag1 | lag2] (era_kernel), each
    part behind leading zero windows up to the longest."""
    nwin = max(rlc16.shape[0], lag1.shape[0], lag2.shape[0])
    rlc = lead_zeros(rlc16, nwin)
    return torch.cat(
        [rlc, rlc, lead_zeros(lag1, nwin), lead_zeros(lag2, nwin)], dim=1)


def tpke_digits(rng, slots: int = 64, k: int = 64, live: int = 22):
    """era_digits of seeded scalars, for timing the scan at the TPKE era's
    layout: a 64-bit RLC coefficient on every lane, and the GLV halves of
    a Lagrange coefficient on the first `live` lanes of each slot of k (the
    N=64 era: 64 slots x 64 shares, t + 1 = 22 combined). rng: a
    random.Random. -> (32, 4 * slots * k) int32 on the CPU."""
    n = slots * k
    rlc = [rng.randrange(1, 1 << 64) for _ in range(n)]
    lag = [rng.randrange(1, bls.R) if i % k < live else 0 for i in range(n)]
    halves = [glv.glv_split(v) for v in lag]
    return era_digits(digits_col(rlc, glv.W64, "cpu"),
                      digits_col([h[0] for h in halves], glv.W128, "cpu"),
                      digits_col([h[1] for h in halves], glv.W128, "cpu"))


def tpke_lanes(rng, slots: int = 64, k: int = 64) -> list:
    """Oracle points at the TPKE era's joined lanes [u | y | u | phi(u)]
    (era_kernel), for timing the table build at its layout: distinct share
    points u on the slots x k share lanes, k distinct keys y tiled once per
    slot, phi(u) = (beta*X, Y, Z) (the N=64 era: 16,384 lanes). rng: a
    random.Random."""
    u = glv.point_run(rng, slots * k)
    y = glv.point_run(rng, k) * slots
    phi = [(glv.BETA * x % bls.P, py, z) for x, py, z in u]
    return u + y + u + phi


def era_kernel(u, y, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
    """u, y: (3R, S*K) share points / verification keys; rlc16 (16, S*K);
    lag1, lag2 (32, S*K) GLV halves; k = K (a power of two).

    pg1.era_kernel (:488-510) runs two passes, a 16-window RLC pass over
    [u | y] with digits [rlc16 | rlc16] and a 32-window GLV pass over
    [u | phi(u)] with [lag1 | lag2], phi(u) = (beta*X, Y, Z). Here they are
    one table build, one scan and one tree reduce over the joined lanes
    [u | y | u | phi(u)], the RLC digits behind leading zero windows (the
    idiom of ops/g2.py ts_era_kernel); groups of K never straddle two
    quarters, so the outputs are pg1's. Returns (rlc_pts (3R, 2S),
    rlc_flags, lag_pts (3R, 2S), lag_flags): per-slot u_agg | y_agg, then
    comb1 | comb2. `digits_checked` as in msm_scan."""
    r = u.shape[0] // 3
    phi_u = torch.cat([mul_beta(u[:r].contiguous()), u[r:]], dim=0)

    lanes = torch.cat([u, y, u, phi_u], dim=1)
    acc, fl = msm_scan(build_table(lanes), era_digits(rlc16, lag1, lag2),
                       digits_checked)
    out, ofl = tree_reduce_k(acc, fl, k)
    s2 = out.shape[-1] // 2
    return out[:, :s2], ofl[:s2], out[:, s2:], ofl[s2:]


def era_kernel_fused(u, y, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
    """era_kernel with every output in ONE (3R + 1, 4S) array, the last row
    carrying the infinity flags (pg1.py:516-524): one device->host copy."""
    out_r, ofl_r, out_l, ofl_l = era_kernel(u, y, rlc16, lag1, lag2, k,
                                            digits_checked)
    pts = torch.cat([out_r, out_l], dim=1)
    flags = torch.cat([ofl_r, ofl_l]).to(pts.dtype)[None, :]
    return torch.cat([pts, flags], dim=0)


def msm_reduce(lanes, digits, k: int, digits_checked: bool = False):
    """Windowed MSM + tree reduce over groups of k lanes (pg1.msm_reduce,
    :560): lanes (3R, n), digits (W, n) -> (3R + 1, n/k), the flag row
    last. `digits_checked` as in msm_scan."""
    acc, fl = msm_windowed(lanes, digits, digits_checked)
    out, ofl = tree_reduce_k(acc, fl, k)
    return torch.cat([out, ofl.to(out.dtype)[None, :]], dim=0)
