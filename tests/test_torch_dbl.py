"""The plain versions of the G1, G2 and secp256k1 doublings vs the JAX
package's.

`g1_ref.dbl`, `g2_ref.dbl` and `secp_ref.dbl` are what the card's
`dbl_kernel`, `g2_dbl_kernel` and `secp_dbl_kernel` (a lane on one group of
4 threads of coop.cuh's group field) must equal word for word
(tests/test_torch_cuda.py, chip_smoke.py). Here they run through the
wrappers `g1.g1_dbl` / `g2.g2_dbl` / `secp.secp_dbl` on CPU tensors and are
held limb for limb against pg1's `pl_dbl`, pg2's `pl_dbl2` and psecp's
`pl_dbl` (Pallas in interpret mode, as tests/test_pg1.py, tests/test_pg2.py
and tests/test_torch_secp_kernels.py run them), and against the JAX
package's `bls12381.g1_dbl` / `g2_dbl` coordinate for coordinate (the same
formulas) and `ecdsa._add(p, p)` as affine points. Points are Jacobian
with Z != 1, made from a numpy seed; every fourth lane from lane 1 is
infinity (0, 1, 0), whose doubling keeps Z = 0. Tolerance: exact equality.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.ops import pg1, pg2, psecp
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import g1, g1_ref, g2, g2_ref, secp, secp_ref

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

LANES = (1, 5, 67)


def _below(rng: np.random.Generator, m: int) -> int:
    """A uniform-enough int in [1, m) from 64 random bytes."""
    return 1 + int.from_bytes(rng.bytes(64), "little") % (m - 1)


def _g1_lanes(seed: int, n: int) -> list:
    """n oracle Jacobian G1 points (X l^2, Y l^3, l) with random l != 1;
    lanes 1, 5, 9, ... infinity."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 4 == 1:
            out.append(bls.G1_INF)
            continue
        x, y = bls.g1_to_affine(bls.g1_mul(bls.G1_GEN, _below(rng, bls.R)))
        lz = 1 + _below(rng, bls.P - 1)
        out.append((x * lz * lz % bls.P, y * lz ** 3 % bls.P, lz))
    return out


def _g2_lanes(seed: int, n: int) -> list:
    """n oracle Jacobian G2 points (X l^2, Y l^3, l), l a random Fp2
    element off the base field; lanes 1, 5, 9, ... infinity."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 4 == 1:
            out.append(bls.G2_INF)
            continue
        x, y = bls.g2_to_affine(bls.g2_mul(bls.G2_GEN, _below(rng, bls.R)))
        lz = (_below(rng, bls.P), _below(rng, bls.P))
        l2 = bls.fp2_mul(lz, lz)
        out.append((bls.fp2_mul(x, l2), bls.fp2_mul(y, bls.fp2_mul(l2, lz)), lz))
    return out


@pytest.mark.parametrize("n", LANES)
def test_g1_dbl_equals_pg1_and_the_jax_doubling(n):
    pts = _g1_lanes(0xD0B1 + n, n)
    assert all(p[2] not in (0, 1) for i, p in enumerate(pts) if i % 4 != 1)
    packed = pg1.g1_pack(pts)
    want = np.asarray(pg1.pl_dbl(jnp.asarray(packed)))
    lanes = g1.g1_pack(pts, "cpu")
    assert (lanes.numpy() == packed).all()
    g1.reset_launches()
    got = g1.g1_dbl(lanes)
    assert all(v == 0 for v in g1.LAUNCHES.values())  # the plain version
    assert torch.equal(got, g1_ref.dbl(lanes))
    assert (got.numpy() == want).all()
    coords = g1.g1_coords(got)
    for i, p in enumerate(pts):
        x, y, z = coords[i], coords[n + i], coords[2 * n + i]
        if i % 4 == 1:  # (0, 1, 0) doubles to (0, -8, 0)
            assert (x, y, z) == (0, bls.P - 8, 0)
            assert jbls.g1_is_inf(jbls.g1_dbl(p))
        else:
            assert (x, y, z) == jbls.g1_dbl(p)


@pytest.mark.parametrize("n", LANES)
def test_g2_dbl_equals_pg2_and_the_jax_doubling(n):
    pts = _g2_lanes(0xD0B2 + n, n)
    assert all(p[2] != bls.FP2_ONE for p in pts)
    packed = pg2.g2_pack(pts)
    want = np.asarray(pg2.pl_dbl2(jnp.asarray(packed)))
    lanes = g2.g2_pack(pts, "cpu")
    assert (lanes.numpy() == packed).all()
    g2.reset_launches()
    got = g2.g2_dbl(lanes)
    assert all(v == 0 for v in g2.LAUNCHES.values())  # the plain version
    assert torch.equal(got, g2_ref.dbl(lanes))
    assert (got.numpy() == want).all()
    coords = g2.g2_coords(got)
    for i, p in enumerate(pts):
        x, y, z = ((coords[j * n + i], coords[(j + 1) * n + i]) for j in (0, 2, 4))
        if i % 4 == 1:  # (0, 1, 0) doubles to (0, -8, 0)
            assert (x, y, z) == ((0, 0), (bls.P - 8, 0), (0, 0))
            assert jbls.g2_is_inf(jbls.g2_dbl(p))
        else:
            assert (x, y, z) == jbls.g2_dbl(p)


def _secp_lanes(seed: int, n: int) -> tuple:
    """n secp256k1 Jacobian points (X l^2, Y l^3, l) with random l not in
    (0, 1) as Z, and their affine points; lanes 1, 5, 9, ... infinity (0,
    1, 0), affine None."""
    rng = np.random.default_rng(seed)
    P = ecdsa.P
    jac, aff = [], []
    for i in range(n):
        if i % 4 == 1:
            jac.append((0, 1, 0))
            aff.append(None)
            continue
        x, y = ecdsa._mul(ecdsa.G, _below(rng, ecdsa.N))
        lz = 1 + _below(rng, P - 1)
        jac.append((x * lz * lz % P, y * lz ** 3 % P, lz))
        aff.append((x, y))
    return jac, aff


@pytest.mark.parametrize("n", LANES)
def test_secp_dbl_equals_psecp_and_the_jax_doubling(n):
    jac, aff = _secp_lanes(0xD0B3 + n, n)
    P, rows = ecdsa.P, psecp.COMP_ROWS
    assert all(p[2] not in (0, 1) for i, p in enumerate(jac) if i % 4 != 1)
    packed = np.zeros((psecp.POINT_ROWS, n), dtype=np.int32)
    for c in range(3):
        packed[c * rows : c * rows + psecp.NLIMBS] = psecp.limbs_from_ints(
            [p[c] for p in jac]).T
    want = np.asarray(psecp.pl_dbl(jnp.asarray(packed)))
    lanes = torch.zeros((secp_ref.POINT_ROWS, n), dtype=torch.int64)
    for c in range(3):
        lanes[c * rows : c * rows + secp_ref.NLIMBS] = torch.from_numpy(
            secp_ref.ints_to_limbs([p[c] for p in jac]))
    assert (lanes.numpy() == packed).all()
    secp.reset_launches()
    got = secp.secp_dbl(lanes)
    assert all(v == 0 for v in secp.LAUNCHES.values())  # the plain version
    assert torch.equal(got, secp_ref.dbl(lanes))
    assert (got.numpy() == want).all()
    coords = secp.pt_coords(got)
    for i, p in enumerate(aff):
        x, y, z = coords[i], coords[n + i], coords[2 * n + i]
        if p is None:  # (0, 1, 0) doubles to (0, -8, 0)
            assert (x, y, z) == (0, P - 8, 0)
            assert jecdsa._add(p, p) is None
        else:
            zi = pow(z, -1, P)
            assert (x * zi * zi % P, y * zi ** 3 % P) == jecdsa._add(p, p)
