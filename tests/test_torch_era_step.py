"""The era steps vs the JAX package, on the CPU.

The JAX steps are three `curve.g1_msm` calls each (verify.py:48-50 and, a
slot at a time, :75-83); jitting `tpke_era_step` or `tpke_era_slots_step`
whole compiles for 120-150 s on one core. So the JAX side here is
`jax.jit(curve.g1_msm)` compiled once at n=4 and 256 bits (the RLC's bit
rows zero-extended in front, which is the same scalar), called for each of
the step's MSMs: `verify.tpke_era_step` (n=4; the RLC in 128 bits, the
Lagrange coefficients in 256, one zero) and `verify.tpke_era_slots_step`
(S=2, K=3, each slot padded to 4) must give (u_agg, y_agg, combined) equal
as affine points, flags clear. `GpuTpkeVerifier`, which runs these steps,
is held in tests/test_torch_tpke_verifier.py.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import curve as jcurve
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import curve, g1, verify

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

NBITS = 256
_JAX_MSM = jax.jit(jcurve.g1_msm)


def _jax_msm(dev_pts, bits):
    """jax.jit(curve.g1_msm) at its one compiled width: bit rows
    zero-extended in front to NBITS."""
    bits = jnp.pad(jnp.asarray(bits), ((0, 0), (NBITS - bits.shape[-1], 0)))
    return _JAX_MSM(jnp.asarray(dev_pts), bits)


def _jax_step(u_dev, y_dev, rlc_bits, lag_bits):
    """tpke_era_step's body (verify.py:48-51) on _jax_msm."""
    return (_jax_msm(u_dev, rlc_bits), _jax_msm(y_dev, rlc_bits),
            _jax_msm(u_dev, lag_bits))


def _oracle(jax_pt):
    pt = jcurve.g1_from_device(np.asarray(jax_pt)[None])[0]
    return pt if pt[2] else bls.G1_INF


def _port(pt):
    co = g1.g1_coords(pt[:, None])
    return tuple(co) if co[2] else bls.G1_INF


def _points(rng, n):
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


def test_era_step_equals_jax():
    rng = random.Random(0x5E9)
    u, y = _points(rng, 4), _points(rng, 4)
    rlc = [rng.randrange(1, 1 << 64) for _ in range(4)]
    lag = [rng.randrange(bls.R) for _ in range(4)]
    lag[2] = 0  # a share outside the combine
    rb, lb = curve.scalars_to_bits(rlc, 128), curve.scalars_to_bits(lag, 256)
    got = verify.tpke_era_step(g1.g1_pack(u, "cpu"), g1.g1_pack(y, "cpu"),
                               torch.from_numpy(rb), torch.from_numpy(lb))
    want = _jax_step(jcurve.g1_to_device(u), jcurve.g1_to_device(y), rb, lb)
    assert not got[3].any()
    for g, w in zip(got[:3], want):
        assert bls.g1_eq(_port(g), _oracle(w))


def test_era_slots_step_equals_jax():
    rng = random.Random(0x5E10)
    s, k = 2, 3
    u, y = _points(rng, s * k), _points(rng, k)
    rlc = [rng.randrange(1, 1 << 64) for _ in range(s * k)]
    lag = [rng.randrange(bls.R) for _ in range(s * k)]
    rb, lb = curve.scalars_to_bits(rlc, 128), curve.scalars_to_bits(lag, 256)
    pu = g1.g1_pack(u, "cpu").reshape(-1, s, k)
    py = g1.g1_pack(y * s, "cpu").reshape(-1, s, k)
    u_agg, y_agg, comb, flags = verify.tpke_era_slots_step(
        pu, py, torch.from_numpy(rb).reshape(s, k, -1),
        torch.from_numpy(lb).reshape(s, k, -1))
    assert tuple(u_agg.shape) == (132, s) and tuple(flags.shape) == (3, s)
    assert not flags.any()
    for i in range(s):
        lanes = slice(i * k, (i + 1) * k)
        pad = [jbls.G1_INF]  # the JAX MSM's compiled n = 4
        ud = jcurve.g1_to_device(u[lanes] + pad)
        yd = jcurve.g1_to_device(y + pad)
        zero = np.zeros((1, 1), np.int32)
        want = _jax_step(ud, yd, np.concatenate([rb[lanes], zero.repeat(128, 1)]),
                         np.concatenate([lb[lanes], zero.repeat(256, 1)]))
        for g, w in zip((u_agg, y_agg, comb), want):
            assert bls.g1_eq(_port(g[:, i]), _oracle(w)), i
