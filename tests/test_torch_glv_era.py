"""The GLV era kernels vs the JAX package, on the CPU.

`msm.tpke_era_glv_kernel3` (the scan over [u | u | phi(u)], per slot u_agg,
comb1, comb2) at S=2, K=3, the port padding each slot to k_pad=4 with
flagged lanes where the JAX kernel pads its odd tree levels, and
`msm.tpke_era_glv_kernel` (the 4K-lane entry, per slot u_agg, y_agg,
comb1, comb2) at S=2, K=2, each against `jax.jit` of the JAX function on
the same seeded points and coefficients (`msm.era_digits`' marshal on both
sides): every (slot, group) in the (S, groups) order must be the same
affine point with the same infinity flag. Lanes with a zero RLC or
Lagrange coefficient are among them, and one slot combines no share, so
its comb flags are set on both sides.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.ops import msm as jmsm
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import g1, msm

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _era(s: int, k: int, seed: int):
    rng = random.Random(seed)
    u = [[bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(k)]
         for _ in range(s)]
    y = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(k)]
    rlc = [[rng.randrange(1, 1 << 64) for _ in range(k)] for _ in range(s)]
    lag = [[rng.randrange(bls.R) for _ in range(k)] for _ in range(s)]
    rlc[0][1] = 0  # an absent share
    lag[0][0] = 0  # a share outside the combine
    lag[1] = [0] * k  # a slot that combines nothing
    return u, y, rlc, lag


def _port_inputs(u, y, rlc, lag, k_pad: int):
    pad = k_pad - len(y)
    u_flat = [p for row in u for p in row + [bls.G1_INF] * pad]
    rlc_flat = [c for row in rlc for c in row + [0] * pad]
    lag_flat = [c for row in lag for c in row + [0] * pad]
    digits = [torch.from_numpy(d) for d in msm.era_digits(rlc_flat, lag_flat)]
    y_tiled = g1.g1_pack((y + [bls.G1_INF] * pad) * len(u), "cpu")
    return g1.g1_pack(u_flat, "cpu"), y_tiled, digits


def _assert_equal(pts, flags, jax_pts, jax_flags):
    """Port (3R, S, G) points and (S, G) flags vs the JAX kernel's (S, G, 3,
    L) points and (S, G) flags."""
    s, groups = flags.shape
    jax_pts, jax_flags = np.asarray(jax_pts), np.asarray(jax_flags)
    assert jax_flags.shape == (s, groups)
    cols = pts.reshape(pts.shape[0], s * groups)
    got = g1.g1_unpack_host(cols.numpy(), flags.reshape(-1).numpy(), True)
    for i in range(s):
        want = jmsm.g1_from_device_loose(jax_pts[i], jax_flags[i])
        for g in range(groups):
            assert bool(flags[i, g]) == bool(jax_flags[i, g]), (i, g)
            assert bls.g1_eq(got[i * groups + g], want[g]), (i, g)


def test_glv_kernel3_equals_jax():
    s, k, k_pad = 2, 3, 4
    u, y, rlc, lag = _era(s, k, 0x61_3)
    pu, _, (rlc16, lag1, lag2) = _port_inputs(u, y, rlc, lag, k_pad)
    pts, flags = msm.tpke_era_glv_kernel3(pu, rlc16, lag1, lag2, k_pad)
    assert tuple(pts.shape) == (132, s, 3) and tuple(flags.shape) == (s, 3)

    u_dev = np.stack([jmsm.g1_to_device_loose(row) for row in u])
    _, rlc_d, jlag1, jlag2 = jmsm.era_digits(rlc, lag)
    jpts, jflags = jax.jit(jmsm.tpke_era_glv_kernel3)(
        jnp.asarray(u_dev), jnp.asarray(rlc_d), jnp.asarray(jlag1), jnp.asarray(jlag2))
    _assert_equal(pts, flags, jpts, jflags)
    assert flags[1, 1] and flags[1, 2]  # slot 1 combines nothing


def test_glv_kernel_equals_jax():
    s, k = 2, 2
    u, y, rlc, lag = _era(s, k, 0x61_4)
    pu, py, (rlc16, lag1, lag2) = _port_inputs(u, y, rlc, lag, k)
    pts, flags = msm.tpke_era_glv_kernel(pu, py, rlc16, lag1, lag2, k)
    assert tuple(pts.shape) == (132, s, 4) and tuple(flags.shape) == (s, 4)

    u_dev = np.stack([jmsm.g1_to_device_loose(row) for row in u])
    y_dev = np.stack([jmsm.g1_to_device_loose(y)] * s)
    _, rlc_d, jlag1, jlag2 = jmsm.era_digits(rlc, lag)
    jpts, jflags = jax.jit(jmsm.tpke_era_glv_kernel)(
        jnp.asarray(u_dev), jnp.asarray(y_dev), jnp.asarray(rlc_d),
        jnp.asarray(jlag1), jnp.asarray(jlag2))
    _assert_equal(pts, flags, jpts, jflags)
