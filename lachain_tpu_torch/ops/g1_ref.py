"""Plain PyTorch versions of the five G1 kernels, in pg1's own arithmetic.

`fp_mul`, `dbl`, `add_incomplete`, `build_table` and `msm_scan` carry the
math of `lachain_tpu/ops/pg1.py:110-220`, `build_table` (:447) and
`_msm_kernel` (:355) into int64 tensors: a field element is 44 signed
10-bit limbs (plain, not Montgomery), a point is (132, n) = X | Y | Z limb
rows, lane-last. Because the steps are
pg1's step for step, the outputs equal pg1's limb for limb
(tests/test_torch_g1_kernels.py, tests/test_torch_msm.py).

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
from .glv import TABLE, WINDOW

NLIMBS = 44
BASE = 10
MASK = (1 << BASE) - 1
CONVLEN = 2 * NLIMBS - 1  # 87
POINT_ROWS = 3 * NLIMBS  # 132


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
