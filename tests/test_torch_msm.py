"""The G1 composites of the port (ops/g1.py) vs pg1's, on the CPU.

`build_table`, `msm_windowed` and `tree_reduce_k` run over the kernels'
plain versions here and must equal pg1's outputs limb for limb, flags
included, at the tiny shapes of tests/test_pg1.py:67-102 (n=16, 4 windows).
Each JAX call runs once per module (module fixtures): pg1 runs in its
interpret-mode emulation on the CPU, which takes seconds per call. The era
kernel is in tests/test_torch_era_kernel.py.
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


def _unpack(arr, flags=None) -> list:
    """Decode as the pipelines do: one fused buffer (flag row last) through
    `g1.fetch`, then `g1.g1_unpack_host`."""
    if flags is None:
        flags = torch.zeros(arr.shape[-1], dtype=torch.bool)
    rows, fl = g1.fetch(torch.cat([arr, flags.to(arr)[None, :]]))
    return g1.g1_unpack_host(rows, fl, arr.device.type == "cpu")


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random(0x4D534D)
    n = 16
    pts = _pts(rng, n)
    scalars = [rng.randrange(1, 1 << 16) for _ in range(n)]
    scalars[3] = 0  # a zero lane must come back flagged
    scalars[7] = 9  # leading zero windows
    dig = pg1.digits_col(scalars, 4)
    acc, flags = pg1.msm_windowed(jnp.asarray(pg1.g1_pack(pts)), jnp.asarray(dig))
    return pts, scalars, dig, np.asarray(acc), np.asarray(flags)


def test_msm_windowed_vs_pg1(msm_case):
    pts, scalars, dig, want_acc, want_flags = msm_case
    acc, flags = g1.msm_windowed(g1.g1_pack(pts, "cpu"), torch.from_numpy(dig))
    assert (acc.numpy() == want_acc).all()
    assert (flags.numpy() == want_flags).all()
    got = _unpack(acc, flags)
    for i, (p, s) in enumerate(zip(pts, scalars)):
        assert jbls.g1_eq(got[i], jbls.g1_mul(p, s)), i
    assert bool(flags[3]) and not bool(flags[7])


def test_build_table_entries(msm_case):
    pts = msm_case[0][:4]
    table = g1.build_table(g1.g1_pack(pts, "cpu"))
    assert table.shape == (16, 132, 4)
    want = np.asarray(pg1.build_table(jnp.asarray(pg1.g1_pack(pts))))
    assert (table.numpy() == want).all()


@pytest.fixture(scope="module")
def reduce_case():
    rng = random.Random(0x7EDC)
    n = 16
    pts = _pts(rng, n)
    flags = np.zeros(n, bool)
    flags[5] = flags[6] = True  # infinity lanes drop out of the sum
    packed = pg1.g1_pack(pts)
    acc, fl = pg1.tree_reduce_k(jnp.asarray(packed), jnp.asarray(flags), 4)
    acc_all, fl_all = pg1.tree_reduce_k(
        jnp.asarray(packed), jnp.asarray(np.ones(n, bool)), n
    )
    return pts, flags, (np.asarray(acc), np.asarray(fl)), np.asarray(fl_all)


def test_tree_reduce_k_vs_pg1(reduce_case):
    pts, flags, (want_acc, want_fl), want_fl_all = reduce_case
    acc, fl = g1.tree_reduce_k(g1.g1_pack(pts, "cpu"), torch.from_numpy(flags), 4)
    assert (acc.numpy() == want_acc).all()
    assert (fl.numpy() == want_fl).all()
    got = _unpack(acc, fl)
    for grp in range(4):
        want = jbls.G1_INF
        for i in range(4 * grp, 4 * grp + 4):
            if not flags[i]:
                want = jbls.g1_add(want, pts[i])
        assert jbls.g1_eq(got[grp], want)
    _, fl_all = g1.tree_reduce_k(
        g1.g1_pack(pts, "cpu"), torch.ones(len(pts), dtype=torch.bool), len(pts)
    )
    assert (fl_all.numpy() == want_fl_all).all() and bool(fl_all[0])
