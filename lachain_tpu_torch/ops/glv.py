"""GLV endomorphism constants, the scalar split and 4-bit digit planes.

The port's copy of `lachain_tpu/ops/msm.py:52-92` and of the digit planes
of `scalars_to_digits` (:353) / `pg1.digits_col` (:617).
phi(x, y) = (BETA*x, y) acts as multiplication by LAMBDA on G1, and
since LAMBDA ~ 2^127.6, k = k2*LAMBDA + k1 by plain divmod gives two
non-negative halves below 2^128: k*P = k1*P + k2*phi(P), 32 4-bit windows
each instead of 64.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..crypto import bls12381 as bls

WINDOW = 4
TABLE = 1 << WINDOW  # 16 entries: 0..15 * P
W64 = 64 // WINDOW  # 16 windows: 64-bit verifier RLC coefficients
W128 = 128 // WINDOW  # 32 windows: one GLV half
W256 = 256 // WINDOW  # 64 windows: a full scalar mod r (no GLV in G2)

_Z = 0xD201000000010000  # |z| for BLS12-381 (z itself is negative)
LAMBDA = (_Z * _Z - 1) % bls.R  # ~2^127.6, the small cube root of unity
assert (LAMBDA * LAMBDA + LAMBDA + 1) % bls.R == 0
assert LAMBDA.bit_length() <= 128


def _find_beta() -> int:
    """The cube root of unity in Fp matching LAMBDA on G1: lambda*(x,y) =
    (beta*x, y). Two candidates; pick by testing on the generator."""
    exp = (bls.P - 1) // 3
    g = 2
    while True:
        b = pow(g, exp, bls.P)
        if b != 1:
            break
        g += 1
    gen = bls.G1_GEN
    target = bls.g1_to_affine(bls.g1_mul(gen, LAMBDA))
    gx, gy = bls.g1_to_affine(gen)
    for cand in (b, b * b % bls.P):
        if (cand * gx % bls.P, gy) == target:
            return cand
    raise AssertionError("no beta matches lambda on G1")


BETA = _find_beta()


def glv_split(k: int) -> Tuple[int, int]:
    """k mod r -> (k1, k2) with k = k1 + k2*lambda, both in [0, 2^128)."""
    k %= bls.R
    k2, k1 = divmod(k, LAMBDA)
    return k1, k2


def point_run(rng, n: int, mul=bls.g1_mul, add=bls.g1_add, gen=bls.G1_GEN,
               order: int = bls.R) -> list:
    """n distinct oracle points P0 + i*S (chained host adds), P0 and S seeded
    multiples of gen, for timing and checking the kernels: G1 by default,
    or any curve given its oracle's mul, add, generator and group order.
    rng: a random.Random."""
    p, step = mul(gen, rng.randrange(1, order)), mul(gen, rng.randrange(1, order))
    out = []
    for _ in range(n):
        out.append(p)
        p = add(p, step)
    return out


def digits_col(scalars: Sequence[int], nwindows: int) -> np.ndarray:
    """ints -> (nwindows, n) int32 MSB-first 4-bit digits, lane-last
    (pg1.digits_col over msm.scalars_to_digits)."""
    nbytes = nwindows * WINDOW // 8
    buf = b"".join(int(s).to_bytes(nbytes, "big") for s in scalars)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), nbytes).T
    out = np.empty((nbytes * 2, len(scalars)), dtype=np.int32)
    out[0::2] = a >> 4
    out[1::2] = a & 0xF
    return out
