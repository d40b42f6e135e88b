"""Plain versions of the four G1 kernels vs the JAX package's pg1 kernels.

`lachain_tpu_torch/ops/g1_ref.py` carries pg1's 44 x 10-bit limb arithmetic
into int64 torch tensors, so on the same inputs it must give pg1's output
limb for limb (and the right value mod p). Shapes follow
tests/test_pg1.py:35-66; inputs come from a seeded `random.Random`; the
tolerance is exact equality. The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import msm as jmsm
from lachain_tpu.ops import pg1
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import g1, g1_ref, glv

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rng():
    return random.Random(0x70C4)


def _limbs(vals) -> np.ndarray:
    return g1_ref.ints_to_limbs(vals)


def _random_points(rng, n):
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


def _unpack(arr, flags=None) -> list:
    """Decode as the pipelines do: one fused buffer (flag row last) through
    `g1.fetch`, then `g1.g1_unpack_host`."""
    if flags is None:
        flags = torch.zeros(arr.shape[-1], dtype=torch.bool)
    rows, fl = g1.fetch(torch.cat([arr, flags.to(arr)[None, :]]))
    return g1.g1_unpack_host(rows, fl, arr.device.type == "cpu")


def test_limb_marshal_matches_pg1(rng):
    vals = [rng.randrange(bls.P) for _ in range(32)] + [0, 1, bls.P - 1]
    want = jmsm._ints_to_limbs_np(vals).T
    assert (_limbs(vals) == want).all()
    assert g1_ref.limbs_to_ints(_limbs(vals)) == vals
    pts = _random_points(rng, 4) + [bls.G1_INF]
    assert (g1_ref.points_to_limbs(pts) == pg1.g1_pack(pts)).all()


@pytest.mark.parametrize(
    "case", ["random", "edge"],
)
def test_fp_mul_vs_pg1(rng, case):
    if case == "random":
        xs = [rng.randrange(bls.P) for _ in range(128)]
        ys = [rng.randrange(bls.P) for _ in range(128)]
    else:
        xs = [0, 1, 2, bls.P - 1, bls.P - 2, (1 << 440) % bls.P, 3]
        ys = list(reversed(xs))
    want = np.asarray(
        pg1.pl_fp_mul(jnp.asarray(_limbs(xs).astype(np.int32)),
                      jnp.asarray(_limbs(ys).astype(np.int32)))
    )
    got = g1_ref.fp_mul(torch.from_numpy(_limbs(xs)), torch.from_numpy(_limbs(ys)))
    assert (got.numpy() == want).all()
    assert g1_ref.limbs_to_ints(got.numpy()) == [
        x * y % bls.P for x, y in zip(xs, ys)
    ]
    assert np.abs(got.numpy()).max() < 1 << 12  # crush(3) bound of pg1


def test_dbl_add_vs_pg1(rng):
    n = 16
    pts = _random_points(rng, n)
    qts = _random_points(rng, n)
    pd, qd = pg1.g1_pack(pts), pg1.g1_pack(qts)
    want_d = np.asarray(pg1.pl_dbl(jnp.asarray(pd)))
    want_a = np.asarray(pg1.pl_add(jnp.asarray(pd), jnp.asarray(qd)))
    tp, tq = torch.from_numpy(pd.astype(np.int64)), torch.from_numpy(qd.astype(np.int64))
    got_d = g1_ref.dbl(tp)
    got_a = g1_ref.add_incomplete(tp, tq)
    assert (got_d.numpy() == want_d).all()
    assert (got_a.numpy() == want_a).all()
    d_pts = _unpack(got_d)
    a_pts = _unpack(got_a)
    for i in range(n):
        assert jbls.g1_eq(d_pts[i], jbls.g1_dbl(pts[i]))
        assert jbls.g1_eq(a_pts[i], jbls.g1_add(pts[i], qts[i]))


def test_add_collision_gives_z_zero(rng):
    """p = -q: the incomplete add comes out with Z == 0, as pg1's does — the
    condition the era pipeline's host-MSM escape keys on."""
    p = _random_points(rng, 2)
    q = [bls.g1_neg(p[0]), p[1]]
    tp = torch.from_numpy(g1_ref.points_to_limbs(p))
    tq = torch.from_numpy(g1_ref.points_to_limbs(q))
    z = g1.g1_coords(g1_ref.add_incomplete(tp, tq))[4:6]
    assert z[0] == 0 and z[1] == 0  # p=-q and p=q both degenerate
    want = np.asarray(pg1.pl_add(jnp.asarray(pg1.g1_pack(p)), jnp.asarray(pg1.g1_pack(q))))
    assert (g1_ref.add_incomplete(tp, tq).numpy() == want).all()


def test_wrappers_take_plain_version_on_cpu(rng):
    xs = [rng.randrange(bls.P) for _ in range(8)]
    x = g1.fp_encode(xs, "cpu")
    g1.reset_launches()
    assert torch.equal(g1.fp_mul(x, x), g1_ref.fp_mul(x, x))
    pts = g1.g1_pack(_random_points(rng, 4), "cpu")
    assert torch.equal(g1.g1_dbl(pts), g1_ref.dbl(pts))
    assert torch.equal(g1.g1_add(pts, g1.g1_dbl(pts)), g1_ref.add_incomplete(pts, g1_ref.dbl(pts)))
    assert all(v == 0 for v in g1.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device, or operands on two devices, raise."""
    meta = torch.empty((g1.NL, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        g1.fp_mul(meta, meta)
    cpu = torch.zeros((g1_ref.NLIMBS, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        g1.fp_mul(cpu, meta)


def test_montgomery_word_marshal(rng):
    """The card's layout: 12 little-endian 32-bit words, x*R mod p."""
    vals = [rng.randrange(bls.P) for _ in range(6)] + [0, bls.P - 1]
    words = g1._words(vals)
    assert words.shape == (g1.NL, len(vals)) and words.dtype == np.uint32
    assert g1._from_words(words) == vals
    assert g1._R2 == pow(2, 768, bls.P)


def test_glv_constants_match_jax(rng):
    assert glv.LAMBDA == jmsm.LAMBDA and glv.BETA == jmsm.BETA
    ks = [rng.randrange(bls.R) for _ in range(16)] + [0, bls.R - 1]
    assert [glv.glv_split(k) for k in ks] == [jmsm.glv_split(k) for k in ks]
    for w in (4, glv.W64, glv.W128):
        sc = [rng.randrange(1 << (4 * w)) for _ in range(8)]
        assert (glv.digits_col(sc, w) == pg1.digits_col(sc, w)).all()
