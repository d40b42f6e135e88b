"""The G1 and secp256k1 table builds on the CPU: the plain versions that the
card's one-launch kernels (`g1_table_kernel`, `secp_table_kernel`) must
equal.

`g1_ref.build_table` and `secp_ref.build_table` must give pg1's and psecp's
`build_table` (one `_dbl_kernel` and 13 chained `_add_kernel` launches, in
interpret mode here) limb for limb, and their own chain of `dbl` and
`add_incomplete`. The lanes are seeded points with an infinity lane
(0, 1, 0) among them, whose Z = 0 every entry keeps; a chain k*P of a point
of prime order never collides, so the collision cases are the add tests'
(test_torch_g1_kernels.py, test_torch_secp_kernels.py). The wrappers
`g1.build_table` / `secp.build_table` run the plain versions for CPU
tensors and count no launch. The tolerance is exact equality.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.ops import pg1, psecp
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import g1, g1_ref, glv, secp, secp_ref

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

N = 6
INF_LANE = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.int32))


def _assert_chain(table, lanes, dbl, add):
    """Each entry from the one before: 0 zero, 1 the lanes P, 2 dbl(P), and
    entry k = add(entry k-1, P) up to 15."""
    assert not table[0].any() and torch.equal(table[1], lanes)
    assert torch.equal(table[2], dbl(lanes))
    for k in range(3, glv.TABLE):
        assert torch.equal(table[k], add(table[k - 1], lanes))


@pytest.fixture(scope="module")
def g1_case():
    rng = random.Random(0x7AB1)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(N)]
    pts[INF_LANE] = bls.G1_INF
    lanes = pg1.g1_pack(pts)
    want = np.asarray(pg1.build_table(_j(lanes)))
    return pts, lanes, want


@pytest.fixture(scope="module")
def secp_case():
    rng = random.Random(0x7AB2)
    pts = [ecdsa._mul(ecdsa.G, rng.randrange(1, ecdsa.N)) for _ in range(N)]
    pts[INF_LANE] = None
    lanes = psecp.pt_pack(pts)
    want = np.asarray(psecp.build_table(_j(lanes)))
    return pts, lanes, want


@pytest.mark.parametrize("build", ["plain", "wrapper"])
def test_g1_table_vs_pg1(g1_case, build):
    pts, lanes, want = g1_case
    g1.reset_launches()
    fn = g1_ref.build_table if build == "plain" else g1.build_table
    table = fn(_t(lanes))
    assert table.shape == (glv.TABLE, g1_ref.POINT_ROWS, N)
    assert (table.numpy() == want).all()
    assert all(v == 0 for v in g1.LAUNCHES.values())


def test_g1_table_is_the_chain_and_k_times_p(g1_case):
    pts, lanes, _ = g1_case
    table = g1_ref.build_table(_t(lanes))
    _assert_chain(table, _t(lanes), g1_ref.dbl, g1_ref.add_incomplete)
    for k in (1, 2, 3, 15):
        coords = g1.g1_coords(table[k])
        for i, p in enumerate(pts):
            z = coords[2 * N + i]
            if i == INF_LANE:
                assert z == 0  # (0, 1, 0) keeps Z = 0 in every entry
            else:
                assert bls.g1_eq((coords[i], coords[N + i], z), bls.g1_mul(p, k))


@pytest.mark.parametrize("build", ["plain", "wrapper"])
def test_secp_table_vs_psecp(secp_case, build):
    pts, lanes, want = secp_case
    secp.reset_launches()
    fn = secp_ref.build_table if build == "plain" else secp.build_table
    table = fn(_t(lanes))
    assert table.shape == (glv.TABLE, secp_ref.POINT_ROWS, N)
    assert (table.numpy() == want).all()
    assert all(v == 0 for v in secp.LAUNCHES.values())


def test_secp_table_is_the_chain_and_k_times_p(secp_case):
    pts, lanes, _ = secp_case
    table = secp_ref.build_table(_t(lanes))
    _assert_chain(table, _t(lanes), secp_ref.dbl, secp_ref.add_incomplete)
    P = ecdsa.P
    for k in (1, 2, 3, 15):
        x, y, z = np.split(np.asarray(secp_ref.coords(table[k].numpy())), 3)
        for i, p in enumerate(pts):
            if i == INF_LANE:
                assert z[i] == 0
                continue
            zi = pow(int(z[i]), -1, P)
            assert (int(x[i]) * zi * zi % P, int(y[i]) * zi ** 3 % P) == \
                ecdsa._mul(p, k)


def test_tpke_lanes_are_the_joined_era_layout():
    """g1.tpke_lanes: [u | y | u | phi(u)] with distinct u, k keys tiled per
    slot and phi(u) = lambda * u, the lanes era_kernel joins."""
    slots, k = 2, 4
    lanes = g1.tpke_lanes(random.Random(8), slots=slots, k=k)
    n = slots * k
    u, y, u2, phi = (lanes[i * n:(i + 1) * n] for i in range(4))
    assert len(lanes) == 4 * n and u2 == u and len(set(u)) == n
    assert y == y[:k] * slots and len(set(y[:k])) == k
    for a, b in zip(u, phi):
        assert bls.g1_eq(b, bls.g1_mul(a, glv.LAMBDA))
