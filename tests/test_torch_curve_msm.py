"""The bit-serial MSM entries (`ops/curve.py`) vs the JAX package, on the CPU.

* `curve.g1_msm` against `jax.jit(curve.g1_msm)` at n=4 with 64 bits (an
  infinity input among the points): the same affine point, flag clear.
* `curve.g2_msm` against the JAX package's pure-Python backend
  (`lachain_tpu.crypto.provider.PythonBackend.g2_msm`, the sum of s_i * Q_i
  that curve.py:334-365 defines) and the port's host: jitting the JAX G2
  MSM compiles for ~130 s on one core, the Python backend compiles nothing.
* For both groups, the incomplete kernels' documented answers beside the
  JAX Python backend's complete MSM on the same inputs: an infinity input
  adds nothing (the same point); all inputs at infinity (or all scalars
  zero) set the flag (the reference's infinity); p with -p comes back with
  Z = 0 and the flag clear, the reference's infinity; a repeated point
  under equal scalars meets p = q in the tree and comes back with Z = 0
  and the flag clear where the reference gives 2c * p (the sum's collision
  mark, which GpuTpkeVerifier answers on the host:
  tests/test_torch_era_step.py).
* `curve.scalars_to_bits` equal to the JAX package's, bit for bit, at
  widths that are and are not multiples of 8, for zero, negative and
  oversize scalars; `bits_to_digits` the MSB-first nibbles of those bits.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.ops import curve as jcurve
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import curve, g1, g2

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

GROUPS = {
    "g1": (bls.G1_GEN, bls.g1_mul, bls.g1_neg, bls.G1_INF, bls.g1_eq, g1.g1_pack,
           curve.g1_msm),
    "g2": (bls.G2_GEN, bls.g2_mul, bls.g2_neg, bls.G2_INF, bls.g2_eq, g2.g2_pack,
           curve.g2_msm),
}


def _unpack(group: str, pt, flag):
    """A (rows,) point and its flag -> (oracle point, Z == 0)."""
    rows = torch.cat([pt, flag.to(pt.dtype)[None]])[:, None].numpy()
    if group == "g1":
        out = g1.g1_unpack_host(rows[:-1], rows[-1] != 0, True)[0]
        z = g1.g1_coords(pt[:, None])[2]
        return out, z == 0
    out = g2.g2_unpack_host(rows[:-1], rows[-1] != 0, True)[0]
    z = g2.g2_coords(pt[:, None])[4:]
    return out, z == [0, 0]


def _bits(scalars, nbits):
    return torch.from_numpy(curve.scalars_to_bits(scalars, nbits))


def test_g1_msm_equals_jax():
    rng = random.Random(0xC0E1)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(3)]
    pts.insert(2, bls.G1_INF)
    scalars = [rng.randrange(1, 1 << 64) for _ in pts]
    scalars[0] = 0
    want = jax.jit(jcurve.g1_msm)(jnp.asarray(jcurve.g1_to_device(pts)),
                                  jnp.asarray(jcurve.scalars_to_bits(scalars, 64)))
    want = jcurve.g1_from_device(np.asarray(want)[None])[0]
    pt, flag = curve.g1_msm(g1.g1_pack(pts, "cpu"), _bits(scalars, 64))
    got, _ = _unpack("g1", pt, flag)
    assert not bool(flag)
    assert bls.g1_eq(got, want if want[2] else bls.G1_INF)
    assert bls.g1_eq(got, HostBackend().g1_msm(pts, scalars))


def test_g2_msm_equals_host():
    rng = random.Random(0xC0E2)
    pts = [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) for _ in range(3)]
    scalars = [rng.randrange(bls.R) for _ in pts]
    pt, flag = curve.g2_msm(g2.g2_pack(pts, "cpu"), _bits(scalars, 256))
    got, _ = _unpack("g2", pt, flag)
    assert not bool(flag)
    assert bls.g2_eq(got, PythonBackend().g2_msm(pts, scalars))
    assert bls.g2_eq(got, HostBackend().g2_msm(pts, scalars))


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_incomplete_cases_give_flag_or_z_zero(group):
    gen, mul, neg, inf, eq, pack, msm_fn = GROUPS[group]
    ref_msm = getattr(PythonBackend(), f"{group}_msm")
    rng = random.Random(0xED6E + len(group))
    p, q = (mul(gen, rng.randrange(1, bls.R)) for _ in range(2))
    c, e = rng.randrange(1, 1 << 16), rng.randrange(1, 1 << 16)

    def run(points, scalars):
        pt, flag = msm_fn(pack(points, "cpu"), _bits(scalars, 16))
        return (*_unpack(group, pt, flag), bool(flag), ref_msm(points, scalars))

    got, z0, flag, ref = run([p, inf], [c, e])  # an infinity input adds nothing
    assert eq(got, ref) and eq(got, mul(p, c)) and not z0 and not flag
    got, _, flag, ref = run([inf, q], [c, 0])  # no lane contributed
    assert flag and eq(got, inf) and eq(ref, inf)
    got, z0, flag, ref = run([p, neg(p)], [c, c])  # p + -p: Z = 0
    assert not flag and z0 and eq(got, inf) and eq(ref, inf)
    got, z0, flag, ref = run([p, p], [c, c])  # P + P: Z = 0, the collision mark
    assert not flag and z0 and eq(ref, mul(p, 2 * c)) and not eq(got, ref)


def test_scalars_to_bits_equals_jax():
    rng = random.Random(0xB175)
    scalars = [0, 1, -1, -12345, bls.R - 1, (1 << 300) + 5, rng.randrange(1 << 64),
               rng.randrange(bls.R)]
    for nbits in (1, 7, 64, 128, 130, 256):
        want = jcurve.scalars_to_bits(scalars, nbits)
        got = curve.scalars_to_bits(scalars, nbits)
        assert got.dtype == want.dtype and np.array_equal(got, want), nbits
        masked = [s & ((1 << nbits) - 1) for s in scalars]
        nwin = (nbits + 3) // 4
        nibbles = [[(s >> (4 * (nwin - 1 - w))) & 15 for s in masked] for w in range(nwin)]
        assert curve.bits_to_digits(torch.from_numpy(got)).tolist() == nibbles
    assert curve.scalars_to_bits([], 128).shape == (0, 128)
