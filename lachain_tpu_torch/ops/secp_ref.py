"""Plain PyTorch versions of the secp256k1 kernels, in psecp's own arithmetic.

`fp_mul`, `dbl`, `add_incomplete`, `build_table`, `msm_scan` and `sqrt`
carry the math of `lachain_tpu/ops/psecp.py` (field helpers :85-138,
group law :158-194, `build_table` :364, `_msm_kernel` :285 /
`_msm_emulate` :311, `sqrt_kernel` :380) into int64
tensors: a field element is 26 signed 10-bit limbs (plain, not Montgomery),
a point is (96, n) = X | Y | Z in 32-row slots (26 limbs, 6 zero rows),
lane-last. The steps are psecp's step for step, so the outputs equal
psecp's limb for limb (tests/test_torch_secp_kernels.py). The one
exception is `mont_mul_words`, the conversions of the card's own
Montgomery words, which psecp does not have: it works on those words
(`g1_ref.mont_words`).

These run where the tensors lie: on the CPU they are what the wrappers in
`ops/secp.py` use; on the card `chip_smoke.py` holds each CUDA kernel of
`csrc/secp.cu` against them. Two choices keep them exact on both devices:
  * everything stays int64, so a missed crush shows as a wrong value and
    never as an int32 wrap;
  * the residue fold is ONE float64 product with the whole fold matrix
    (psecp splits it into 5-bit halves for exact f32 MXU products and
    adds `lo + (hi << 5)`; the integers are the same). It is exact: fold
    planes lie in [-2^10, 2^10), matrix entries below 2^10, so each
    153-term sum stays below 2^28 << 2^53.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import g1_ref

P = 2**256 - 2**32 - 977  # the secp256k1 base field prime
NLIMBS = 26
BASE = 10
MASK = (1 << BASE) - 1
CONVLEN = 2 * NLIMBS - 1  # 51
COMP_ROWS = 32  # 26 limbs + 6 zero rows per coordinate
POINT_ROWS = 3 * COMP_ROWS  # 96


def _int_to_limbs(v: int) -> np.ndarray:
    return np.array(
        [(v >> (BASE * i)) & MASK for i in range(NLIMBS)], dtype=np.int64
    )


# fold matrix: column (j, k), row l = limbs(2^(10(k+j)) mod p)[l]
_FOLD_M = np.zeros((NLIMBS, 3 * CONVLEN), dtype=np.int64)
for _j in range(3):
    for _k in range(CONVLEN):
        _FOLD_M[:, _j * CONVLEN + _k] = _int_to_limbs(
            (1 << (BASE * (_k + _j))) % P
        )
# top-carry wrap constant for crush: 2^260 mod p, as a (26, 1) column
_WRAP = _int_to_limbs((1 << (BASE * NLIMBS)) % P)[:, None]

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
# field (psecp.py:85-138)
# ---------------------------------------------------------------------------


def _crush(t, rounds: int = 1):
    """Per-limb overflow moves one limb up; the top limb's carry wraps
    through 2^260 mod p. Exact for any signed input."""
    wrap = _consts(t.device)[1]
    for _ in range(rounds):
        carry = t >> BASE
        shifted = torch.cat(
            [torch.zeros_like(carry[:1]), carry[: NLIMBS - 1]], dim=0
        )
        t = (t & MASK) + shifted + carry[NLIMBS - 1 :] * wrap
    return t


def _conv(x, y):
    """(26, B) x (26, B) -> (51, B) product coefficients:
    t[k] = sum_i x[i] * y[k - i]."""
    z = torch.zeros((NLIMBS - 1, y.shape[-1]), dtype=y.dtype, device=y.device)
    ypad = torch.cat([z, y, z], dim=0)  # (76, B); ypad[25 + j] = y[j]
    win = ypad.unfold(0, CONVLEN, 1)  # (26, B, 51): win[s, :, k] = ypad[s + k]
    return (x.unsqueeze(-1) * win.flip(0)).sum(0).T


def _fold(t):
    """(51, B) coefficients -> (26, B) crushed limbs of t mod p."""
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
    """(26, n) x (26, n) -> (26, n) x*y mod p (psecp `_mul`)."""
    return _mul(x, y)


# ---------------------------------------------------------------------------
# group law (psecp.py:141-194): Jacobian, a = 0, incomplete add
# ---------------------------------------------------------------------------


def _split(p):
    return (
        p[0:NLIMBS],
        p[COMP_ROWS : COMP_ROWS + NLIMBS],
        p[2 * COMP_ROWS : 2 * COMP_ROWS + NLIMBS],
    )


def _join(x, y, z):
    z6 = torch.zeros(
        (COMP_ROWS - NLIMBS, x.shape[-1]), dtype=x.dtype, device=x.device
    )
    return torch.cat([x, z6, y, z6, z, z6], dim=0)


def dbl(p):
    """(96, n) -> (96, n) Jacobian doubling (psecp `_dbl_kernel`)."""
    X1, Y1, Z1 = _split(p)
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
    return _join(X3, Y3, Z3)


def add_incomplete(p, q):
    """(96, n) x (96, n) -> (96, n); requires p != +-q, both finite
    (psecp `_add_kernel`)."""
    X1, Y1, Z1 = _split(p)
    X2, Y2, Z2 = _split(q)
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
    return _join(X3, Y3, Z3)


def build_table(lanes):
    """(96, n) -> (16, 96, n): entry k = k*P, entry 0 zero and never
    selected (psecp `build_table`, :364: one doubling, then 13 chained
    adds)."""
    return g1_ref.chain_table(lanes, dbl, add_incomplete)


def msm_scan(table, digits):
    """table (16, 96, n), digits (W, n) MSB-first -> ((96, n) acc, (n,)
    bool infinity flags) (psecp `_msm_kernel` / `_msm_emulate`: pg1's
    window and flag rules, so g1_ref's generic scan runs it)."""
    return g1_ref.scan(table, digits, dbl, add_incomplete)


# ---------------------------------------------------------------------------
# square root (psecp.py:374-399)
# ---------------------------------------------------------------------------

SQRT_EXP = (P + 1) // 4  # y = (x^3 + 7)^((p+1)/4) when x^3 + 7 is a square
# the exponent's bits below its (set) top bit, MSB first: psecp's
# _SQRT_BITS[1:] (the loop runs steps 1..253)
SQRT_STEPS = [(SQRT_EXP >> i) & 1 for i in range(SQRT_EXP.bit_length() - 2, -1, -1)]


def sqrt(x):
    """(26, n) x -> (26, n) (x^3 + 7)^((p+1)/4), psecp `sqrt_kernel`
    step for step: square-and-multiply from y2 = x^3 + 7, each step
    computing the square and its product with y2 and keeping the one the
    exponent bit selects. Non-residues give values the caller rejects
    with its y^2 == x^3 + 7 check."""
    x3 = _mul(_sqr(x), x)
    seven = torch.zeros_like(x)
    seven[0] = 7
    y2 = _add(x3, seven)
    acc = y2
    for bit in SQRT_STEPS:
        sq = _mul(acc, acc)
        withmul = _mul(sq, y2)
        acc = withmul if bit else sq
    return acc


# ---------------------------------------------------------------------------
# the card's Montgomery words (psecp has no Montgomery form)
# ---------------------------------------------------------------------------

WORD_ROWS = 8  # 32-bit words per coordinate on the card


def mont_mul_words(t, k: int):
    """(8c, n) or (8c + 1, n) int32 words in the card's layout (coordinate
    c's little-endian words at rows 8c .. 8c + 7) -> the same shape, every
    coordinate x replaced by the canonical x * k / 2^256 mod p, a trailing
    flag row copied: with k = 2^512 mod p into Montgomery form, with k = 1
    out of it (the plain version of `secp.mont_convert`; the arithmetic is
    `g1_ref.mont_words` over this prime)."""
    return g1_ref.mont_words(t, k, P, WORD_ROWS)


# ---------------------------------------------------------------------------
# marshal: ints <-> limb rows
# ---------------------------------------------------------------------------


def ints_to_limbs(vals: Sequence[int]) -> np.ndarray:
    """Ints in [0, 2^256) -> (26, n) int64 limbs (psecp `limbs_from_ints`,
    transposed)."""
    raw = np.frombuffer(
        b"".join(int(v).to_bytes(32, "little") for v in vals), np.uint8
    ).reshape(len(vals), 32)
    bits = np.unpackbits(raw, axis=1, bitorder="little")  # (n, 256)
    bits = np.concatenate(
        [bits, np.zeros((len(vals), NLIMBS * BASE - 256), np.uint8)], axis=1
    )
    w = 1 << np.arange(BASE, dtype=np.int64)
    limbs = (bits.reshape(len(vals), NLIMBS, BASE) * w).sum(axis=2)
    return np.ascontiguousarray(limbs.T)


def limbs_to_ints(a) -> list:
    """(26, n) signed limbs -> canonical field ints. A carry pass makes the
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
         + int(carry[j]) * top) % P
        for j in range(n)
    ]


def points_to_limbs(points) -> np.ndarray:
    """Affine (x, y) tuples (None = infinity) -> (96, n) int64 Jacobian
    limbs with Z = 1, infinity as (0, 1, 0) (psecp `pt_pack`)."""
    n = len(points)
    out = np.zeros((POINT_ROWS, n), dtype=np.int64)
    out[0:NLIMBS] = ints_to_limbs([p[0] if p else 0 for p in points])
    out[COMP_ROWS : COMP_ROWS + NLIMBS] = ints_to_limbs(
        [p[1] if p else 1 for p in points]
    )
    out[2 * COMP_ROWS] = [0 if p is None else 1 for p in points]
    return out


def coords(arr) -> list:
    """(96, n) limb rows -> the 3n canonical coordinate ints
    X... | Y... | Z..."""
    a = np.asarray(arr)
    return limbs_to_ints(np.concatenate(
        [a[c * COMP_ROWS : c * COMP_ROWS + NLIMBS] for c in range(3)], axis=1
    ))
