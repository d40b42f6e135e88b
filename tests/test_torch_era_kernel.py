"""The port's era kernel (ops/g1.py:era_kernel) vs pg1.era_kernel, on the CPU.

At the tiny shape of tests/test_pg1.py:104-135 (S=2, K=4, 4 windows) the
two passes — RLC over [u | y], GLV over [u | phi(u)] — and the per-slot
tree reduce must equal pg1's outputs limb for limb, flags included. pg1
runs once per module (interpret-mode emulation on the CPU).
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
