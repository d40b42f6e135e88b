"""The port's coin-era kernel (ops/g2.py:ts_era_kernel) vs pg2.ts_era_kernel,
on the CPU.

At the tiny shape of tests/test_pg2.py:111-146 (S=2, K=4, 4-window scalars)
the one G2 scan over [rlc | lag] lanes, the G1 key RLC and the per-coin tree
reduces must give pg2's fused (289, 3S) buffer limb for limb, flag row
included. Lane 5 is an absent share (infinity, zero digits) and lane 2 of
each coin sits outside the combine set. pg2 runs once per module
(interpret-mode emulation, about half a minute). The tolerance is exact.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import pg1, pg2
from lachain_tpu_torch.ops import g1, g2

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def era_case():
    rng = random.Random(0x75E4)
    s, k = 2, 4
    n = s * k
    sig = [jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, jbls.R)) for _ in range(n)]
    sig[5] = jbls.G2_INF
    y = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(n)]
    rlc = [rng.randrange(1, 1 << 16) for _ in range(n)]
    lag = [rng.randrange(1, 1 << 16) if i % k != 2 else 0 for i in range(n)]
    rlc[5] = lag[5] = 0
    args = (pg2.g2_pack(sig), pg1.g1_pack(y), pg1.digits_col(rlc, 4),
            pg1.digits_col(lag, 4))
    want = np.asarray(pg2.ts_era_kernel(*[jnp.asarray(a) for a in args], k))
    return (sig, y, rlc, lag), args, k, want


def test_ts_era_kernel_vs_pg2(era_case):
    (sig, y, rlc, lag), (sd, yd, r16, l64), k, want = era_case
    got = g2.ts_era_kernel(
        g2.g2_pack(sig, "cpu"), g1.g1_pack(y, "cpu"), torch.from_numpy(r16),
        torch.from_numpy(l64), k,
    )
    assert got.shape == want.shape == (289, 6)
    assert (got.numpy() == want).all()

    rows, flags = g1.fetch(got)
    sig_cols = g2.g2_unpack_host(rows[:, :4], flags[:4], cpu_layout=True)
    y_cols = g1.g1_unpack_host(rows[:132, 4:], flags[4:], cpu_layout=True)
    for c in range(2):
        sig_r = sig_l = jbls.G2_INF
        y_r = jbls.G1_INF
        for i in range(c * k, (c + 1) * k):
            sig_r = jbls.g2_add(sig_r, jbls.g2_mul(sig[i], rlc[i]))
            sig_l = jbls.g2_add(sig_l, jbls.g2_mul(sig[i], lag[i]))
            y_r = jbls.g1_add(y_r, jbls.g1_mul(y[i], rlc[i]))
        assert jbls.g2_eq(sig_cols[c], sig_r)
        assert jbls.g2_eq(sig_cols[2 + c], sig_l)
        assert jbls.g1_eq(y_cols[c], y_r)
