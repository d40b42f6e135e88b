"""Plain PyTorch versions of the G1 kernels, in pg1's own arithmetic.

`fp_mul`, `dbl`, `add_incomplete`, `build_table` and `msm_scan` carry the
math of `lachain_tpu/ops/pg1.py:110-220`, `build_table` (:447) and
`_msm_kernel` (:355) into int64 tensors: a field element is 44 signed
10-bit limbs (plain, not Montgomery), a point is (132, n) = X | Y | Z limb
rows, lane-last. Because the steps are
pg1's step for step, the outputs equal pg1's limb for limb
(tests/test_torch_g1_kernels.py, tests/test_torch_msm.py). `fixed_tables`
and `fixed_scan` are the fixed-base key tables and their gather-and-add
scan of `lachain_tpu/ops/msm.py:246-277` over the same group law, in the
order of the card's kernels (tables in log depth, a lane's windows split
over 4 sub-lanes), so they equal msm.py's as points
(tests/test_torch_glv_tables.py, tests/test_torch_fixed_base.py).

These run where the tensors lie: on the CPU they are what the kernel
wrappers in `ops/g1.py` use; on the card `chip_smoke.py` holds each CUDA
kernel against them. Two choices keep them exact on both devices:
  * everything stays int64, so a missed crush shows as a wrong value and
    never as an int32 wrap;
  * the residue fold is a float64 matrix product (CUDA has no int64
    matmul). It is exact: fold planes lie in [-2^10, 2^10), matrix entries
    below 2^10, so each 261-term sum stays below 2^29 << 2^53.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..crypto import bls12381 as bls
from .glv import TABLE, W64, WINDOW

NLIMBS = 44
BASE = 10
MASK = (1 << BASE) - 1
CONVLEN = 2 * NLIMBS - 1  # 87
POINT_ROWS = 3 * NLIMBS  # 132
FIXED_SPLIT = 4  # the sub-lanes of a fixed-scan lane (g1.cu FIXED_G)


def _int_to_limbs(v: int) -> np.ndarray:
    return np.array(
        [(v >> (BASE * i)) & MASK for i in range(NLIMBS)], dtype=np.int64
    )


# fold matrix: column (j, k), row l = limbs(2^(10(k+j)) mod p)[l]
_FOLD_M = np.zeros((NLIMBS, 3 * CONVLEN), dtype=np.int64)
for _j in range(3):
    for _k in range(CONVLEN):
        _FOLD_M[:, _j * CONVLEN + _k] = _int_to_limbs(
            (1 << (BASE * (_k + _j))) % bls.P
        )
# top-carry wrap constant for crush: 2^440 mod p, as a (44, 1) column
_WRAP = _int_to_limbs((1 << (BASE * NLIMBS)) % bls.P)[:, None]

_CONSTS: dict = {}


def _consts(device: torch.device):
    hit = _CONSTS.get(device)
    if hit is None:
        hit = (
            torch.as_tensor(_FOLD_M, dtype=torch.float64, device=device),
            torch.as_tensor(_WRAP, dtype=torch.int64, device=device),
        )
        _CONSTS[device] = hit
    return hit


# ---------------------------------------------------------------------------
# field (pg1.py:110-173)
# ---------------------------------------------------------------------------


def _crush(t, rounds: int = 1):
    """Per-limb overflow moves one limb up; the top limb's carry wraps
    through 2^440 mod p. Exact for any signed input."""
    wrap = _consts(t.device)[1]
    for _ in range(rounds):
        carry = t >> BASE
        shifted = torch.cat(
            [torch.zeros_like(carry[:1]), carry[: NLIMBS - 1]], dim=0
        )
        t = (t & MASK) + shifted + carry[NLIMBS - 1 :] * wrap
    return t


def _conv(x, y):
    """(44, B) x (44, B) -> (87, B) product coefficients:
    t[k] = sum_i x[i] * y[k - i]."""
    z = torch.zeros((NLIMBS - 1, y.shape[-1]), dtype=y.dtype, device=y.device)
    ypad = torch.cat([z, y, z], dim=0)  # (130, B); ypad[43 + j] = y[j]
    win = ypad.unfold(0, CONVLEN, 1)  # (44, B, 87): win[s, :, k] = ypad[s + k]
    return (x.unsqueeze(-1) * win.flip(0)).sum(0).T


def _fold(t):
    """(87, B) coefficients -> (44, B) crushed limbs of t mod p."""
    m = _consts(t.device)[0]
    planes = torch.cat(
        [t & MASK, (t >> BASE) & MASK, t >> (2 * BASE)], dim=0
    ).to(torch.float64)
    return _crush((m @ planes).to(torch.int64), 3)


def _mul(x, y):
    return _fold(_conv(x, y))


def _sqr(x):
    return _mul(x, x)


def _add(x, y):
    return _crush(x + y, 1)


def _sub(x, y):
    return _crush(x - y, 1)


def _mul_small(x, k: int):
    return _crush(x * k, 2)


def fp_mul(x, y):
    """(44, n) x (44, n) -> (44, n) x*y mod p (pg1 `_mul_kernel`)."""
    return _mul(x, y)


# ---------------------------------------------------------------------------
# group law (pg1.py:181-220): Jacobian, a=0, incomplete add
# ---------------------------------------------------------------------------


def dbl(p):
    """(132, n) -> (132, n) Jacobian doubling (pg1 `_dbl_kernel`)."""
    X1, Y1, Z1 = p[0:44], p[44:88], p[88:132]
    A = _sqr(X1)
    B = _sqr(Y1)
    C = _sqr(B)
    D = _sub(_sub(_sqr(_add(X1, B)), A), C)
    D = _add(D, D)
    E = _mul_small(A, 3)
    F = _sqr(E)
    X3 = _sub(F, _add(D, D))
    Y3 = _sub(_mul(E, _sub(D, X3)), _mul_small(C, 8))
    Z3 = _mul(Y1, Z1)
    Z3 = _add(Z3, Z3)
    return torch.cat([X3, Y3, Z3], dim=0)


def add_incomplete(p, q):
    """(132, n) x (132, n) -> (132, n); requires p != +-q, both finite
    (pg1 `_add_kernel`)."""
    X1, Y1, Z1 = p[0:44], p[44:88], p[88:132]
    X2, Y2, Z2 = q[0:44], q[44:88], q[88:132]
    Z1Z1 = _sqr(Z1)
    Z2Z2 = _sqr(Z2)
    U1 = _mul(X1, Z2Z2)
    U2 = _mul(X2, Z1Z1)
    S1 = _mul(_mul(Y1, Z2), Z2Z2)
    S2 = _mul(_mul(Y2, Z1), Z1Z1)
    H = _sub(U2, U1)
    Rr = _sub(S2, S1)
    I = _sqr(_add(H, H))
    J = _mul(H, I)
    Rr2 = _add(Rr, Rr)
    V = _mul(U1, I)
    X3 = _sub(_sub(_sqr(Rr2), J), _add(V, V))
    S1J = _mul(S1, J)
    Y3 = _sub(_mul(Rr2, _sub(V, X3)), _add(S1J, S1J))
    Z3 = _mul(_mul(Z1, Z2), H)
    Z3 = _add(Z3, Z3)
    return torch.cat([X3, Y3, Z3], dim=0)


def chain_table(lanes, dbl_fn, add_fn):
    """The table chain of pg1 `build_table` (:447), pg2 `build_table2` and
    psecp `build_table` over any point layout: (R, n) -> (16, R, n), entry
    k = k*P, entry 0 zero and never selected; one doubling, then 13 chained
    adds of P."""
    two = dbl_fn(lanes)
    rows = [torch.zeros_like(lanes), lanes, two]
    cur = two
    for _ in range(TABLE - 3):
        cur = add_fn(cur, lanes)
        rows.append(cur)
    return torch.stack(rows, dim=0)


def build_table(lanes):
    """(132, n) -> (16, 132, n) (pg1 `build_table`, :447)."""
    return chain_table(lanes, dbl, add_incomplete)


# ---------------------------------------------------------------------------
# windowed scan (pg1 `_msm_kernel` :355, `_msm_emulate` :389)
# ---------------------------------------------------------------------------


def _select_entry(table, d):
    """(16, R, n) table, (n,) digits -> (R, n) entry table[d]; digit 0
    selects the zero point (pg1 `_select_entry`: entry 0 never
    contributes)."""
    idx = d.to(torch.int64).expand(1, table.shape[1], -1)
    e = table.gather(0, idx)[0]
    return torch.where(d == 0, torch.zeros_like(e), e)


def scan(table, digits, dbl_fn, add_fn):
    """The windowed scan of pg1 `_msm_kernel` / pg2 `_msm2_kernel` over any
    point layout: table (16, R, n), digits (W, n) MSB-first -> ((R, n) acc,
    (n,) bool infinity flags). Window 0 selects table[d]; each later window
    does 4 doublings and a flag-merged add. A digit 0 keeps the accumulator
    and keeps the flag set, so an all-zero lane stays flagged."""
    assert table.shape[0] == TABLE
    acc = flag = None
    for w in range(digits.shape[0]):
        d = digits[w]
        keep = d == 0
        entry = _select_entry(table, d)
        if acc is None:
            acc, flag = entry, keep
            continue
        for _ in range(WINDOW):
            acc = dbl_fn(acc)
        added = add_fn(acc, entry)
        acc = torch.where(keep, acc, torch.where(flag, entry, added))
        flag = flag & keep
    return acc, flag


def msm_scan(table, digits):
    """table (16, 132, n), digits (W, n) MSB-first -> ((132, n) acc,
    (n,) bool infinity flags) (pg1 `_msm_kernel`)."""
    return scan(table, digits, dbl, add_incomplete)


# ---------------------------------------------------------------------------
# fixed-base tables of the verification keys (msm.py:246-277)
# ---------------------------------------------------------------------------


def log_table(bases):
    """(R, n) bases B -> (16, R, n) tables, entry d = d*B, entry 0 zero and
    never selected, in 4 levels: 2B = dbl(B); 4B = dbl(2B), 3B = 1B + 2B;
    8B = dbl(4B), 5B..7B = {1..3}B + 4B; 9B..15B = {1..7}B + 8B (entry
    h + j = add(entry j, entry h)). The order of `g1_fixed_tables`' table
    phase, operation for operation."""
    rows = [torch.zeros_like(bases), bases] + [None] * (TABLE - 2)
    h = 1
    while h < TABLE:
        if 2 * h < TABLE:
            rows[2 * h] = dbl(rows[h])
        for j in range(1, h):
            rows[h + j] = add_incomplete(rows[j], rows[h])
        h *= 2
    return torch.stack(rows, dim=0)


def fixed_tables(keys):
    """(132, K) keys -> (16, 16, 132, K) tables, entry [w, d] = d *
    16^(15 - w) * Y: window w is MSB-first, the index convention of
    `msm.y_fixed_base_tables` after its `rows[::-1]` (msm.py:261-263).
    The order of `g1_fixed_tables`: one chain of 60 doublings from Y gives
    the windows' bases 16^(15 - w) * Y (base_15 = Y, 4 doublings from one
    to the next, msm.py's own chain), then every window's table at once in
    log depth (`log_table`)."""
    bases = [keys]
    for _ in range(W64 - 1):
        base = bases[-1]
        for _ in range(WINDOW):
            base = dbl(base)
        bases.append(base)
    lanes = torch.cat(bases[::-1], dim=1)  # (132, 16K), window-major
    tables = log_table(lanes)
    k = keys.shape[-1]
    return tables.reshape(TABLE, POINT_ROWS, W64, k).permute(2, 0, 1, 3).contiguous()


def _fixed_windows(tables, digits, cols):
    """One sub-lane's sum over its windows of `tables` and `digits` (the
    same count, MSB-first) with msm_scan's flag rules and no doubling."""
    acc = flag = None
    for w in range(digits.shape[0]):
        d = digits[w]
        keep = d == 0
        entry = _select_entry(tables[w][:, :, cols], d)
        if acc is None:
            acc, flag = entry, keep
            continue
        added = add_incomplete(acc, entry)
        acc = torch.where(keep, acc, torch.where(flag, entry, added))
        flag = flag & keep
    return acc, flag


def fixed_scan(tables, digits, k_pad: int):
    """tables (16, 16, R, K) from `fixed_tables`, digits (16, n) MSB-first,
    lane j reading key column j % k_pad -> ((R, n) acc, (n,) bool infinity
    flags): acc = sum_w tables[w, d_w] in `g1_fixed_scan`'s order. The 16
    windows split over FIXED_SPLIT = 4 sub-lanes, sub-lane q summing
    windows [4q, 4q + 4) with the scan's flag rules (a zero digit keeps the
    accumulator, a flagged accumulator takes the entry, otherwise the entry
    is added with `add_incomplete`); the partials then meet in 2 levels,
    0 + 1, 2 + 3, then 01 + 23, a flagged side giving way to the other."""
    n = digits.shape[-1]
    assert tables.shape[0] == digits.shape[0] and n % k_pad == 0
    cols = torch.arange(n, device=digits.device) % k_pad
    per = digits.shape[0] // FIXED_SPLIT
    parts = [_fixed_windows(tables[q * per:(q + 1) * per],
                            digits[q * per:(q + 1) * per], cols)
             for q in range(FIXED_SPLIT)]
    s = 1
    while s < FIXED_SPLIT:
        for q in range(0, FIXED_SPLIT, 2 * s):
            (a, fa), (b, fb) = parts[q], parts[q + s]
            added = add_incomplete(a, b)
            parts[q] = (torch.where(fa, b, torch.where(fb, a, added)), fa & fb)
        s *= 2
    return parts[0]


# ---------------------------------------------------------------------------
# marshal: oracle ints <-> limb rows
# ---------------------------------------------------------------------------


def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """Field ints (each in [0, 2^384)) -> (44, n) int64 limbs."""
    buf = b"".join(int(v).to_bytes(48, "little") for v in vals)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(len(vals), 48)
    bits = np.unpackbits(a, axis=1, bitorder="little")  # (n, 384)
    bits = np.concatenate(
        [bits, np.zeros((len(vals), NLIMBS * BASE - 384), np.uint8)], axis=1
    )
    w = 1 << np.arange(BASE, dtype=np.int64)
    limbs = (bits.reshape(len(vals), NLIMBS, BASE) * w).sum(axis=2)
    return np.ascontiguousarray(limbs.T)


def limbs_to_ints(a) -> list:
    """(44, n) signed limbs -> canonical field ints. A carry pass makes the
    limbs 10-bit digits plus one signed top carry, so each lane becomes one
    int.from_bytes."""
    a = np.asarray(a, dtype=np.int64)
    n = a.shape[-1]
    digits = np.empty((NLIMBS, n), dtype=np.int64)
    carry = np.zeros(n, dtype=np.int64)
    for i in range(NLIMBS):
        v = a[i] + carry
        digits[i] = v & MASK
        carry = v >> BASE
    bits = ((digits.T[:, :, None] >> np.arange(BASE)) & 1).astype(np.uint8)
    raw = np.packbits(bits.reshape(n, NLIMBS * BASE), axis=1, bitorder="little")
    width = raw.shape[1]
    buf = raw.tobytes()
    top = 1 << (BASE * NLIMBS)
    return [
        (int.from_bytes(buf[j * width : (j + 1) * width], "little")
         + int(carry[j]) * top) % bls.P
        for j in range(n)
    ]


def points_to_limbs(points) -> np.ndarray:
    """Oracle Jacobian tuples -> (132, n) int64; infinity maps to (0, 1, 0)
    (pg1.g1_pack)."""
    xs = [p[0] if p[2] != 0 else 0 for p in points]
    ys = [p[1] if p[2] != 0 else 1 for p in points]
    zs = [p[2] for p in points]
    return np.concatenate(
        [ints_to_limbs(xs), ints_to_limbs(ys), ints_to_limbs(zs)], axis=0
    )


# ---------------------------------------------------------------------------
# the card's Montgomery words (pg1 has no Montgomery form)
# ---------------------------------------------------------------------------

WORD_ROWS = 12  # 32-bit words per coordinate on the card
_H = 16  # bits of a half-word limb
_HMASK = (1 << _H) - 1


def mont_words(t, k: int, p: int, words: int):
    """(words * c, n) or (words * c + 1, n) int32 words in the card's layout
    (coordinate c's little-endian words at rows words*c .. words*c +
    words - 1) -> the same shape, every coordinate x replaced by the
    canonical x * k / 2^(32 words) mod p, a trailing flag row copied. x may
    be any value below 2^(32 words), k below p. Montgomery's product over
    16-bit limbs in int64, every column exact (sums of at most 2 * 2 words
    products below 2^32); the value before the last subtraction is below
    (x k + 2^(32 words) p) / 2^(32 words) < 2p."""
    halves = 2 * words
    p_halves = [(p >> (_H * i)) & _HMASK for i in range(halves)]
    pinv = -pow(p, -1, 1 << _H) % (1 << _H)
    c = t.shape[0] // words
    n = t.shape[-1]
    w = (t[: words * c].to(torch.int64) & 0xFFFFFFFF).view(c, words, n)
    a = torch.stack([w & _HMASK, w >> _H], dim=2).view(c, halves, n)
    cols = torch.zeros((c, 2 * halves + 1, n), dtype=torch.int64, device=t.device)
    for j in range(halves):
        kj = (k >> (_H * j)) & _HMASK
        if kj:
            cols[:, j : j + halves] += a * kj
    p_col = torch.tensor(p_halves, dtype=torch.int64, device=t.device)[:, None]
    for i in range(halves):  # clear column i with m * p, carry it up
        m = ((cols[:, i] & _HMASK) * pinv) & _HMASK
        cols[:, i : i + halves] += m[:, None, :] * p_col
        cols[:, i + 1] += cols[:, i] >> _H
    r = cols[:, halves:]  # the value / 2^(32 words), below 2p: loose limbs
    for j in range(halves):
        r[:, j + 1] += r[:, j] >> _H
        r[:, j] &= _HMASK
    d = torch.empty_like(r)  # r - p, and whether it borrows (r < p)
    borrow = torch.zeros_like(r[:, 0])
    for j in range(halves + 1):
        v = r[:, j] - (p_halves[j] if j < halves else 0) - borrow
        borrow = (v < 0).to(torch.int64)
        d[:, j] = v + (borrow << _H)
    canon = torch.where(borrow.bool()[:, None, :], r[:, :halves], d[:, :halves])
    out_words = canon[:, 0::2] | (canon[:, 1::2] << _H)
    out_words = out_words - ((out_words >> 31) << 32)  # two's complement int32
    out = t.clone()
    out[: words * c] = out_words.reshape(words * c, n).to(torch.int32)
    return out


def mont_mul_words(t, k: int):
    """(12c, n) or (12c + 1, n) int32 words in the card's layout -> every
    coordinate x replaced by the canonical x * k / 2^384 mod p, a trailing
    flag row copied: with k = 2^768 mod p into Montgomery form, with k = 1
    out of it, with k = beta 2^384 mod p times beta (the plain version of
    `g1.mont_convert` and `g1.mul_beta` on the card's words)."""
    return mont_words(t, k, bls.P, WORD_ROWS)
