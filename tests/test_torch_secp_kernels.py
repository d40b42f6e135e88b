"""Plain versions of the secp256k1 kernels vs the JAX package's psecp.

`lachain_tpu_torch/ops/secp_ref.py` carries psecp's 26 x 10-bit limb
arithmetic into int64 torch tensors, so on the same inputs it must give
psecp's output limb for limb (and the right value mod p): the field
product, the doubling and the incomplete add (a p = +-q collision
included), the windowed scan at 4 windows (psecp `_msm_emulate`; 64 windows
blow up XLA-CPU, tests/test_psecp.py), the square root, and psecp's whole
`recover_kernel` at 4 windows and 4 signatures. Inputs come from a seeded
`random.Random`; the tolerance is exact equality. The CUDA kernels run only
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.ops import psecp
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import glv, secp, secp_ref

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

P = ecdsa.P


@pytest.fixture(scope="module")
def rng():
    return random.Random(0x5EC7)


def _points(rng, n):
    return [ecdsa._mul(ecdsa.G, rng.randrange(1, ecdsa.N)) for _ in range(n)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.int32))


def _affine(j):
    x, y, z = j
    zi = pow(z, -1, P)
    return (x * zi * zi % P, y * zi * zi * zi % P)


def test_constants_and_marshal_match_psecp(rng):
    assert secp_ref.NLIMBS == psecp.NLIMBS and secp_ref.POINT_ROWS == psecp.POINT_ROWS
    assert (secp_ref._FOLD_M == psecp._FOLD_M).all()
    assert (secp_ref._WRAP == np.asarray(psecp._WRAP_COL)).all()
    assert secp_ref.P == psecp.P_INT == jecdsa.P
    assert int(psecp._SQRT_BITS[0, 0]) == 1  # both start from y2
    assert secp_ref.SQRT_STEPS == [int(b) for b in psecp._SQRT_BITS[1:, 0]]
    vals = [rng.randrange(P) for _ in range(16)] + [0, 1, P - 1]
    assert (secp_ref.ints_to_limbs(vals) == psecp.limbs_from_ints(vals).T).all()
    assert secp_ref.limbs_to_ints(secp_ref.ints_to_limbs(vals)) == vals
    pts = _points(rng, 3) + [None]
    assert (secp_ref.points_to_limbs(pts) == psecp.pt_pack(pts)).all()
    scalars = [rng.randrange(1 << 256) for _ in range(5)] + [0, ecdsa.N - 1]
    assert (secp.digits_col(scalars, "cpu").numpy() == psecp.digits_col(scalars)).all()


@pytest.mark.parametrize("case", ["random", "edge"])
def test_fp_mul_vs_psecp(rng, case):
    if case == "random":
        xs = [rng.randrange(P) for _ in range(64)]
        ys = [rng.randrange(P) for _ in range(64)]
    else:
        xs = [0, 1, 2, P - 1, P - 2, (1 << 260) % P, 1 << 255, 3]
        ys = list(reversed(xs))
    lx, ly = psecp.limbs_from_ints(xs).T, psecp.limbs_from_ints(ys).T
    want = np.asarray(psecp._mul(_j(lx), _j(ly), psecp._const_args()))
    got = secp_ref.fp_mul(_t(lx), _t(ly)).numpy()
    assert (got == want).all()
    assert secp_ref.limbs_to_ints(got) == [x * y % P for x, y in zip(xs, ys)]
    assert secp_ref.limbs_to_ints(got) == psecp.ints_from_limbs(want)
    assert np.abs(got).max() < 1 << 13  # psecp's loose-limb bound


def test_dbl_add_vs_psecp(rng):
    n = 8
    pts, qts = _points(rng, n), _points(rng, n)
    pd, qd = psecp.pt_pack(pts), psecp.pt_pack(qts)
    want_d = np.asarray(psecp.pl_dbl(_j(pd)))
    want_a = np.asarray(psecp.pl_add(_j(pd), _j(qd)))
    got_d = secp_ref.dbl(_t(pd)).numpy()
    got_a = secp_ref.add_incomplete(_t(pd), _t(qd)).numpy()
    assert (got_d == want_d).all() and (got_a == want_a).all()
    cd, ca = secp_ref.coords(got_d), secp_ref.coords(got_a)
    for i in range(n):
        assert _affine((cd[i], cd[n + i], cd[2 * n + i])) == ecdsa._add(pts[i], pts[i])
        assert _affine((ca[i], ca[n + i], ca[2 * n + i])) == ecdsa._add(pts[i], qts[i])


def test_add_collision_gives_z_zero(rng):
    """p = q and p = -q: the incomplete add comes out with Z == 0 on the
    same lanes as psecp's — the condition GpuEcdsaRecover's escape to the
    host oracle keys on."""
    p = _points(rng, 3)
    q = [p[0], (p[1][0], P - p[1][1]), _points(rng, 1)[0]]
    pd, qd = psecp.pt_pack(p), psecp.pt_pack(q)
    got = secp_ref.add_incomplete(_t(pd), _t(qd)).numpy()
    assert (got == np.asarray(psecp.pl_add(_j(pd), _j(qd)))).all()
    z = secp_ref.coords(got)[6:9]
    assert z[0] == 0 and z[1] == 0 and z[2] != 0


def test_msm_scan_vs_psecp_emulate(rng):
    """4 windows over one table (built by the port's composite; the
    recover_kernel test below holds psecp's build_table); lane 0 has
    all-zero digits (stays flagged), lane 1 leading zero windows, the rest
    random digits."""
    n = 8
    pts = _points(rng, n)
    table = secp.build_table(_t(psecp.pt_pack(pts))).numpy()
    scalars = [rng.randrange(1 << 16) for _ in range(n)]
    scalars[0], scalars[1] = 0, 5
    digits = glv.digits_col(scalars, 4)
    want_acc, want_fl = psecp._msm_emulate(_j(table), _j(digits[:, None, :]))
    acc, fl = secp_ref.msm_scan(_t(table), torch.from_numpy(digits))
    assert (acc.numpy() == np.asarray(want_acc)).all()
    assert (fl.numpy() == np.asarray(want_fl)).all()
    assert bool(fl[0]) and not bool(fl[1])
    c = secp_ref.coords(acc.numpy())
    for i in range(1, n):
        assert _affine((c[i], c[n + i], c[2 * n + i])) == ecdsa._mul(pts[i], scalars[i])


def test_sqrt_vs_psecp(rng):
    xs = [rng.randrange(P) for _ in range(6)] + [1, ecdsa.GX]
    lx = psecp.limbs_from_ints(xs).T
    want = np.asarray(psecp.sqrt_kernel_jit(_j(lx), jnp.asarray(psecp._SQRT_BITS)))
    got = secp_ref.sqrt(_t(lx)).numpy()
    assert (got == want).all()
    for x, y in zip(xs, secp_ref.limbs_to_ints(got)):
        assert y == pow((x**3 + 7) % P, (P + 1) // 4, P)
    assert secp_ref.limbs_to_ints(got)[-1] in (ecdsa.GY, P - ecdsa.GY)


@pytest.fixture(scope="module")
def recover_case():
    """psecp's recover_kernel at 4 windows on 4 signatures' lanes, computed
    once (eager interpret mode takes ~10 s here)."""
    rng = random.Random(0x5EC8)
    rs = _points(rng, 4)
    g = (ecdsa.GX, ecdsa.GY)
    u = [rng.randrange(1 << 16) for _ in range(8)]
    u[2] = 0  # u1 = 0: the R lane stays flagged, Q = u2*G
    u[5] = 0  # u2 = 0: the G lane stays flagged, Q = u1*R
    u[6] = 7  # leading zero windows
    pts = [pt for r in rs for pt in (r, g)]
    lanes = psecp.pt_pack(pts)
    digits = glv.digits_col(u, 4)
    want = np.asarray(psecp.recover_kernel(_j(lanes), _j(digits)))
    return rs, u, lanes, digits, want


def test_recover_kernel_vs_psecp(recover_case):
    rs, u, lanes, digits, want = recover_case
    got = secp.recover_kernel(_t(lanes), torch.from_numpy(digits))
    assert got.shape == (secp_ref.POINT_ROWS + 1, 4)
    assert (got.numpy() == want).all()
    rows, flags = secp.fetch(got)
    qs = secp.pt_unpack_host(rows, flags, True)
    g = (ecdsa.GX, ecdsa.GY)
    for i, q in enumerate(qs):
        want_q = ecdsa._add(ecdsa._mul(rs[i], u[2 * i]), ecdsa._mul(g, u[2 * i + 1]))
        assert _affine(q) == want_q


def test_wrappers_take_plain_version_on_cpu(rng):
    secp.reset_launches()
    x = secp.fe_encode([rng.randrange(P) for _ in range(4)], "cpu")
    assert torch.equal(secp.secp_fp_mul(x, x), secp_ref.fp_mul(x, x))
    assert torch.equal(secp.sqrt(x), secp_ref.sqrt(x))
    pts = secp.pt_pack(_points(rng, 4), "cpu")
    two = secp.secp_dbl(pts)
    assert torch.equal(two, secp_ref.dbl(pts))
    assert torch.equal(secp.secp_add(pts, two), secp_ref.add_incomplete(pts, two))
    table = secp.build_table(pts)
    digits = secp.digits_col([3, 0, 1 << 200, 77], "cpu")[-2:].contiguous()
    acc, fl = secp.msm_scan(table, digits)
    racc, rfl = secp_ref.msm_scan(table, digits)
    assert torch.equal(acc, racc) and torch.equal(fl, rfl)
    assert all(v == 0 for v in secp.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device, or operands on two devices, raise."""
    meta = torch.empty((secp.NL, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        secp.sqrt(meta)
    cpu = torch.zeros((secp_ref.NLIMBS, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        secp.secp_fp_mul(cpu, meta)


def test_montgomery_word_marshal(rng):
    """The card's layout: 8 little-endian 32-bit words, x*R mod p."""
    vals = [rng.randrange(P) for _ in range(6)] + [0, P - 1]
    words = secp._words(vals)
    assert words.shape == (secp.NL, len(vals)) and words.dtype == np.uint32
    assert secp._from_words(words) == vals
    assert secp._R2 == pow(2, 512, P)
