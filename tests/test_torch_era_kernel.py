"""The port's era kernel (ops/g1.py:era_kernel) vs pg1.era_kernel, on the CPU.

At the tiny shape of tests/test_pg1.py:104-135 (S=2, K=4, 4 windows) pg1's
two passes — RLC over [u | y], GLV over [u | phi(u)] — and the per-slot
tree reduce must equal the port's one joined scan over [u | y | u | phi(u)]
limb for limb, flags included; a second case gives the RLC digits fewer
windows than the GLV digits (the joined scan pads them with leading zero
windows) and leaves a whole slot flagged. pg1 runs once per fixture
(interpret-mode emulation on the CPU).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import pg1
from lachain_tpu_torch.ops import g1

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _pts(rng, n):
    return [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(n)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def era_case():
    """S=2, K=4 with short scalars; lane 5 is an absent share (infinity,
    zero digits) and lane 1 of each slot sits outside the combine set."""
    rng = random.Random(0xE8A)
    s, k = 2, 4
    n = s * k
    u = _pts(rng, n)
    u[5] = jbls.G1_INF
    y = _pts(rng, n)
    rlc = [rng.randrange(1, 1 << 16) for _ in range(n)]
    rlc[5] = 0
    lag1 = [rng.randrange(1, 1 << 16) if i % k != 1 else 0 for i in range(n)]
    lag2 = [rng.randrange(1 << 16) if i % k == 2 else 0 for i in range(n)]
    lag1[5] = lag2[5] = 0
    args = (
        pg1.g1_pack(u), pg1.g1_pack(y), pg1.digits_col(rlc, 4),
        pg1.digits_col(lag1, 4), pg1.digits_col(lag2, 4),
    )
    out = pg1.era_kernel(*[jnp.asarray(a) for a in args], k)
    return args, k, [np.asarray(o) for o in out]


def test_era_kernel_vs_pg1(era_case):
    (u, y, r16, l1, l2), k, want = era_case
    got = g1.era_kernel(
        _t(u), _t(y), torch.from_numpy(r16), torch.from_numpy(l1),
        torch.from_numpy(l2), k,
    )
    for g, w in zip(got, want):
        assert (g.numpy() == w).all()


def test_era_kernel_fused_layout(era_case):
    (u, y, r16, l1, l2), k, want = era_case
    fused = g1.era_kernel_fused(
        _t(u), _t(y), torch.from_numpy(r16), torch.from_numpy(l1),
        torch.from_numpy(l2), k,
    )
    assert fused.shape == (133, 8)
    assert (fused[:132, :4].numpy() == want[0]).all()
    assert (fused[:132, 4:].numpy() == want[2]).all()
    assert (fused[132].numpy() == np.concatenate([want[1], want[3]])).all()


@pytest.fixture(scope="module")
def short_rlc_case():
    """S=2, K=4 with RLC digits of 2 windows against GLV digits of 4, so the
    joined scan runs the RLC lanes behind 2 leading zero windows. Slot 1 is
    wholly absent: every lane's digits are zero (its u lanes infinity), so
    all four of its outputs come back flagged."""
    rng = random.Random(0xE8B)
    s, k = 2, 4
    n = s * k
    u = _pts(rng, n)
    u[k:] = [jbls.G1_INF] * k
    y = _pts(rng, n)
    rlc = [rng.randrange(1, 1 << 8) if i < k else 0 for i in range(n)]
    lag1 = [rng.randrange(1, 1 << 16) if i < k else 0 for i in range(n)]
    lag2 = [rng.randrange(1, 1 << 16) if i in (0, 2) else 0 for i in range(n)]
    args = (
        pg1.g1_pack(u), pg1.g1_pack(y), pg1.digits_col(rlc, 2),
        pg1.digits_col(lag1, 4), pg1.digits_col(lag2, 4),
    )
    out = pg1.era_kernel(*[jnp.asarray(a) for a in args], k)
    return args, k, [np.asarray(o) for o in out]


def _port_args(args):
    u, y, r16, l1, l2 = args
    return (_t(u), _t(y), torch.from_numpy(r16), torch.from_numpy(l1),
            torch.from_numpy(l2))


def test_era_kernel_short_rlc_vs_pg1(short_rlc_case):
    args, k, want = short_rlc_case
    got = g1.era_kernel(*_port_args(args), k)
    for g, w in zip(got, want):
        assert (g.numpy() == w).all()


def test_era_kernel_flagged_slot(short_rlc_case):
    args, k, want = short_rlc_case
    fused = g1.era_kernel_fused(*_port_args(args), k)
    # columns u_agg0 u_agg1 y_agg0 y_agg1 | comb1_0 comb1_1 comb2_0 comb2_1
    assert fused[132].tolist() == [0, 1, 0, 1, 0, 1, 0, 1]
    assert (fused[:132, :4].numpy() == want[0]).all()
    assert (fused[:132, 4:].numpy() == want[2]).all()
    assert (fused[132].numpy() == np.concatenate([want[1], want[3]])).all()


@pytest.mark.parametrize("pad", [0, 2])
def test_lead_zeros_keeps_the_scalars(pad):
    scalars = [0, 1, 0xBEEF, (1 << 32) - 1]
    d = torch.from_numpy(pg1.digits_col(scalars, 8))
    padded = g1.lead_zeros(d, 8 + pad)
    assert padded.shape == (8 + pad, 4) and padded.dtype == d.dtype
    assert (padded[:pad] == 0).all() and torch.equal(padded[pad:], d)
    assert (padded.numpy() == pg1.digits_col(scalars, 8 + pad)).all()
