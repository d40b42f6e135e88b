"""Plain PyTorch versions of the four G2 kernels, in pg2's own arithmetic.

`dbl`, `add_incomplete`, `build_table` and `msm_scan` carry the math of
`lachain_tpu/ops/pg2.py:85-200`, `build_table2` (:356) and `_msm2_kernel`
(:272) into int64
tensors over g1_ref's field steps (`_conv`, `_fold`, `_add`, `_sub`,
`_mul_small`): an Fp2 component is 44 signed 10-bit limbs in a 48-row slot
(rows 44..47 zero), a point is (288, n) = X.c0 | X.c1 | Y.c0 | Y.c1 | Z.c0 |
Z.c1, lane-last. The compositions are pg2's step for step (Karatsuba with
each product folded before it is combined, the square as (a+b)(a-b) and
ab + ab), so the outputs equal pg2's limb for limb
(tests/test_torch_g2_kernels.py). As in pg2, the three Karatsuba products
ride one conv + fold on a lane block three times as wide; per lane that is
the same as three separate products.

On the CPU these are what the kernel wrappers of `ops/g2.py` run; on the
card `chip_smoke.py` holds each CUDA kernel of `csrc/g2.cu` against them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..crypto import bls12381 as bls
from . import g1_ref
from .g1_ref import NLIMBS, _add, _conv, _fold, _mul_small, _sub
from .glv import TABLE

COMP_ROWS = 48  # one Fp2 component per 48-row slot, as pg2 (pg2.py:71)
POINT2_ROWS = 6 * COMP_ROWS  # 288


# ---------------------------------------------------------------------------
# Fp2 (pg2.py:85-130): pairs of (44, n) limb blocks
# ---------------------------------------------------------------------------


def _fp2_add(x, y):
    return (_add(x[0], y[0]), _add(x[1], y[1]))


def _fp2_sub(x, y):
    return (_sub(x[0], y[0]), _sub(x[1], y[1]))


def _fp2_muls(x, k: int):
    return (_mul_small(x[0], k), _mul_small(x[1], k))


def _fp2_mul(x, y):
    """Karatsuba: (a+bi)(d+ei) = (ad - be) + ((a+b)(d+e) - ad - be) i."""
    a, b = x
    d, e = y
    w = a.shape[-1]
    f = _fold(_conv(torch.cat([a, b, _add(a, b)], dim=-1),
                    torch.cat([d, e, _add(d, e)], dim=-1)))
    f_ad, f_be, f_k = f[:, :w], f[:, w : 2 * w], f[:, 2 * w :]
    return (_sub(f_ad, f_be), _sub(_sub(f_k, f_ad), f_be))


def _fp2_sqr(x):
    """(a+bi)^2 = (a+b)(a-b) + 2ab i."""
    a, b = x
    w = a.shape[-1]
    f = _fold(_conv(torch.cat([_add(a, b), a], dim=-1),
                    torch.cat([_sub(a, b), b], dim=-1)))
    ab = f[:, w:]
    return (f[:, :w], _add(ab, ab))


def _split(p):
    c = [p[COMP_ROWS * j : COMP_ROWS * j + NLIMBS] for j in range(6)]
    return (c[0], c[1]), (c[2], c[3]), (c[4], c[5])


def _join(x, y, z):
    z4 = torch.zeros((COMP_ROWS - NLIMBS, x[0].shape[-1]), dtype=x[0].dtype,
                     device=x[0].device)
    return torch.cat([x[0], z4, x[1], z4, y[0], z4, y[1], z4, z[0], z4,
                      z[1], z4], dim=0)


# ---------------------------------------------------------------------------
# group law (pg2.py:154-200): Jacobian over Fp2, a=0, incomplete add
# ---------------------------------------------------------------------------


def dbl(p):
    """(288, n) -> (288, n) Jacobian doubling (pg2 `_dbl2_kernel`)."""
    X1, Y1, Z1 = _split(p)
    A = _fp2_sqr(X1)
    B = _fp2_sqr(Y1)
    C = _fp2_sqr(B)
    D = _fp2_sub(_fp2_sub(_fp2_sqr(_fp2_add(X1, B)), A), C)
    D = _fp2_add(D, D)
    E = _fp2_muls(A, 3)
    F = _fp2_sqr(E)
    X3 = _fp2_sub(F, _fp2_add(D, D))
    Y3 = _fp2_sub(_fp2_mul(E, _fp2_sub(D, X3)), _fp2_muls(C, 8))
    Z3 = _fp2_mul(Y1, Z1)
    Z3 = _fp2_add(Z3, Z3)
    return _join(X3, Y3, Z3)


def add_incomplete(p, q):
    """(288, n) x (288, n) -> (288, n); requires p != +-q, both finite
    (pg2 `_add2_kernel`)."""
    X1, Y1, Z1 = _split(p)
    X2, Y2, Z2 = _split(q)
    Z1Z1 = _fp2_sqr(Z1)
    Z2Z2 = _fp2_sqr(Z2)
    U1 = _fp2_mul(X1, Z2Z2)
    U2 = _fp2_mul(X2, Z1Z1)
    S1 = _fp2_mul(_fp2_mul(Y1, Z2), Z2Z2)
    S2 = _fp2_mul(_fp2_mul(Y2, Z1), Z1Z1)
    H = _fp2_sub(U2, U1)
    Rr = _fp2_sub(S2, S1)
    I = _fp2_sqr(_fp2_add(H, H))
    J = _fp2_mul(H, I)
    Rr2 = _fp2_add(Rr, Rr)
    V = _fp2_mul(U1, I)
    X3 = _fp2_sub(_fp2_sub(_fp2_sqr(Rr2), J), _fp2_add(V, V))
    S1J = _fp2_mul(S1, J)
    Y3 = _fp2_sub(_fp2_mul(Rr2, _fp2_sub(V, X3)), _fp2_add(S1J, S1J))
    Z3 = _fp2_mul(_fp2_mul(Z1, Z2), H)
    Z3 = _fp2_add(Z3, Z3)
    return _join(X3, Y3, Z3)


def build_table(lanes):
    """(288, n) -> (16, 288, n): entry k = k*P, entry 0 zero and never
    selected (pg2.build_table2, :356: one doubling, then 13 chained adds)."""
    two = dbl(lanes)
    rows = [torch.zeros_like(lanes), lanes, two]
    cur = two
    for _ in range(TABLE - 3):
        cur = add_incomplete(cur, lanes)
        rows.append(cur)
    return torch.stack(rows, dim=0)


def msm_scan(table, digits):
    """table (16, 288, n), digits (W, n) MSB-first -> ((288, n) acc,
    (n,) bool infinity flags): pg2 `_msm2_kernel` / `_msm2_emulate`
    (:272-319), the keep/flag rules of g1_ref.scan."""
    return g1_ref.scan(table, digits, dbl, add_incomplete)


# ---------------------------------------------------------------------------
# marshal: oracle ints <-> limb rows
# ---------------------------------------------------------------------------


def components(points) -> list:
    """Oracle G2 Jacobian tuples -> per point (X.c0, X.c1, Y.c0, Y.c1, Z.c0,
    Z.c1); infinity maps to ((0,0),(1,0),(0,0)) (pg2.g2_pack)."""
    out = []
    for p in points:
        if bls.g2_is_inf(p):
            out.append((0, 0, 1, 0, 0, 0))
        else:
            (x0, x1), (y0, y1), (z0, z1) = p
            out.append((x0, x1, y0, y1, z0, z1))
    return out


def points_to_limbs(points: Sequence[tuple]) -> np.ndarray:
    """Oracle G2 Jacobian tuples -> (288, n) int64 limbs, rows 44..47 of
    each slot zero (pg2.g2_pack)."""
    comps = components(points)
    out = np.zeros((POINT2_ROWS, len(points)), dtype=np.int64)
    for j in range(6):
        out[COMP_ROWS * j : COMP_ROWS * j + NLIMBS] = g1_ref.ints_to_limbs(
            [c[j] for c in comps]
        )
    return out
