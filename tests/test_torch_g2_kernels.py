"""Plain versions of the G2 kernels vs the JAX package's pg2 kernels.

`lachain_tpu_torch/ops/g2_ref.py` carries pg2's Fp2 arithmetic (44 x 10-bit
limbs per component in 48-row slots) into int64 torch tensors, so on the
same inputs it must give pg2's output limb for limb and the right value on
the curve. pg2 runs as tests/test_pg2.py runs it on the CPU (its
interpret-mode bodies). Inputs come from a seeded `random.Random`; the
tolerance is exact equality. The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py); the scan is in
tests/test_torch_g2_msm.py, the coin-era kernel in
tests/test_torch_ts_era_kernel.py.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import pg2
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import g1, g2, g2_ref

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rng():
    return random.Random(0x6E2B)


def _g2_points(rng, n):
    return [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _unpack(arr, flags=None) -> list:
    """Decode as the pipelines do: one fused buffer (flag row last) through
    `g1.fetch`, then `g2.g2_unpack_host`."""
    if flags is None:
        flags = torch.zeros(arr.shape[-1], dtype=torch.bool)
    rows, fl = g1.fetch(torch.cat([arr, flags.to(arr)[None, :]]))
    return g2.g2_unpack_host(rows, fl, arr.device.type == "cpu")


def test_g2_pack_matches_pg2(rng):
    pts = _g2_points(rng, 3) + [bls.G2_INF]
    packed = g2.g2_pack(pts, "cpu")
    assert packed.dtype == torch.int64 and packed.shape == (288, 4)
    assert (packed.numpy() == pg2.g2_pack(pts)).all()
    back = _unpack(packed)
    assert all(bls.g2_eq(p, q) for p, q in zip(pts, back))
    assert g2.g2_pack(pts[:1], "cpu").is_contiguous()
    flagged = _unpack(packed, torch.tensor([True, False, False, False]))
    assert bls.g2_is_inf(flagged[0]) and bls.g2_eq(flagged[1], pts[1])


def test_dbl_add_vs_pg2(rng):
    n = 8
    pts, qts = _g2_points(rng, n), _g2_points(rng, n)
    pd, qd = pg2.g2_pack(pts), pg2.g2_pack(qts)
    want_d = np.asarray(pg2.pl_dbl2(jnp.asarray(pd)))
    want_a = np.asarray(pg2.pl_add2(jnp.asarray(pd), jnp.asarray(qd)))
    got_d = g2_ref.dbl(_t(pd))
    got_a = g2_ref.add_incomplete(_t(pd), _t(qd))
    assert (got_d.numpy() == want_d).all()
    assert (got_a.numpy() == want_a).all()
    d_pts, a_pts = _unpack(got_d), _unpack(got_a)
    for i in range(n):
        assert jbls.g2_eq(d_pts[i], jbls.g2_dbl(pts[i]))
        assert jbls.g2_eq(a_pts[i], jbls.g2_add(pts[i], qts[i]))


def test_add_collision_gives_z_zero(rng):
    """p = -q (and p = q): the incomplete add comes out with Z == 0 in both
    Fp2 components, as pg2's does; the coin pipeline's host-MSM escape keys
    on it."""
    p = _g2_points(rng, 2)
    q = [bls.g2_neg(p[0]), p[1]]
    pd, qd = pg2.g2_pack(p), pg2.g2_pack(q)
    got = g2_ref.add_incomplete(_t(pd), _t(qd))
    coords = g2.g2_coords(got)
    assert coords[8:12] == [0, 0, 0, 0]  # Z.c0, Z.c1 of both lanes
    assert all(bls.g2_is_inf(r) for r in _unpack(got))
    want = np.asarray(pg2.pl_add2(jnp.asarray(pd), jnp.asarray(qd)))
    assert (got.numpy() == want).all()


def test_build_table2_vs_pg2(rng):
    """build_table2 on CPU tensors (the plain chain of one doubling and 13
    adds that the card's one launch must equal) gives pg2.build_table2 limb
    for limb, an infinity lane (0, 1, 0) included: it keeps Z = 0 in every
    entry, as the incomplete chain does on the TPU."""
    pts = _g2_points(rng, 3) + [bls.G2_INF]
    lanes = pg2.g2_pack(pts)
    want = np.asarray(pg2.build_table2(jnp.asarray(lanes)))
    g2.reset_launches()
    got = g2.build_table2(_t(lanes))
    assert got.shape == (16, 288, 4)
    assert (got.numpy() == want).all()
    assert all(v == 0 for v in g2.LAUNCHES.values())
    for k in range(1, 16):
        coords = g2.g2_coords(got[k])
        assert coords[16 + 3] == coords[20 + 3] == 0  # Z.c0, Z.c1 of lane 3
        assert bls.g2_eq(_unpack(got[k])[0], bls.g2_mul(pts[0], k))


def test_tree_reduce2_k_vs_pg2(rng):
    n = 8
    pts = _g2_points(rng, n)
    flags = np.zeros(n, bool)
    flags[1] = flags[6] = True  # infinity lanes drop out of the sum
    want_acc, want_fl = pg2.tree_reduce2_k(
        jnp.asarray(pg2.g2_pack(pts)), jnp.asarray(flags), 4
    )
    acc, fl = g2.tree_reduce2_k(g2.g2_pack(pts, "cpu"), torch.from_numpy(flags), 4)
    assert (acc.numpy() == np.asarray(want_acc)).all()
    assert (fl.numpy() == np.asarray(want_fl)).all()
    got = _unpack(acc, fl)
    for grp in range(2):
        want = bls.G2_INF
        for i in range(4 * grp, 4 * grp + 4):
            if not flags[i]:
                want = bls.g2_add(want, pts[i])
        assert bls.g2_eq(got[grp], want)


def test_wrappers_take_plain_version_on_cpu(rng):
    pts = g2.g2_pack(_g2_points(rng, 4), "cpu")
    g2.reset_launches()
    two = g2.g2_dbl(pts)
    assert torch.equal(two, g2_ref.dbl(pts))
    assert torch.equal(g2.g2_add(two, pts), g2_ref.add_incomplete(two, pts))
    table = g2.build_table2(pts)
    digits = torch.tensor([[1, 0, 15, 2], [0, 0, 3, 9]], dtype=torch.int32)
    acc, fl = g2.msm2_scan(table, digits)
    racc, rfl = g2_ref.msm_scan(table, digits)
    assert torch.equal(acc, racc) and torch.equal(fl, rfl)
    assert fl.tolist() == [False, True, False, False]
    assert all(v == 0 for v in g2.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device, or operands on two devices, raise."""
    meta = torch.empty((g2.ROWS2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        g2.g2_dbl(meta)
    cpu = torch.zeros((g2_ref.POINT2_ROWS, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        g2.g2_add(cpu, meta)
    with pytest.raises(ValueError):
        g2.msm2_scan(torch.zeros((16, 288, 4), dtype=torch.int64),
                     torch.zeros((2, 4), dtype=torch.int32, device="meta"))


def test_host_decode_of_card_layout(rng):
    """`g1.fetch` hands the card's fused buffers to the host as plain field
    words (12 little-endian uint32 rows per component); the host decoders
    read them back with cpu_layout=False. Built here from the words."""
    pts = _g2_points(rng, 3) + [bls.G2_INF]
    comps = g2_ref.components(pts)
    words = g1._words([c[j] for j in range(6) for c in comps])  # (12, 24)
    rows = words.reshape(g1.NL, 6, 4).transpose(1, 0, 2).reshape(g2.ROWS2, 4)
    flags = np.array([False, False, True, False])
    got = g2.g2_unpack_host(rows.view(np.int32), flags, cpu_layout=False)
    assert bls.g2_eq(got[0], pts[0]) and bls.g2_eq(got[1], pts[1])
    assert bls.g2_is_inf(got[2]) and bls.g2_is_inf(got[3])

    g1_pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(2)]
    xyz = [p[j] for j in range(3) for p in g1_pts]
    g1_rows = g1._words(xyz).reshape(g1.NL, 3, 2).transpose(1, 0, 2).reshape(36, 2)
    back = g1.g1_unpack_host(g1_rows.view(np.int32), np.zeros(2, bool), False)
    assert all(bls.g1_eq(a, b) for a, b in zip(back, g1_pts))


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g2_cu18g2_msm_scan_kernelEPKjPKiPjPhii' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g2_cu18g2_msm_scan_kernelEPKjPKiPjPhii
    952 bytes stack frame, 44 bytes spill stores, 144 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 952 bytes cumulative stack size
ptxas info    : Function properties for _ZN35_INTERNAL_5_g2_cu6g2_addERKNS0_3Pt2ES3_
    0 bytes stack frame, 880 bytes spill stores, 944 bytes spill loads
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__5_g2_cu13g2_dbl_kernelEPKjPji' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__5_g2_cu13g2_dbl_kernelEPKjPji
    288 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 0 barriers, 288 bytes cumulative stack size
"""


def test_inline_probe_reads_ptxas_report():
    """The card-side variant builder (whose fp2inline variants probe inlined
    Fp2 products) reads each kernel's registers, frame and spills, and its
    callees' spills, from ptxas -v."""
    from lachain_tpu_torch.scan_sweep import parse_ptxas

    assert parse_ptxas(_PTXAS) == {
        "g2_msm_scan_kernel": {
            "regs": 255, "stack": 952, "spill_stores": 44, "spill_loads": 144,
            "callees": {"g2_add": [0, 880, 944]},
        },
        "g2_dbl_kernel": {
            "regs": 240, "stack": 288, "spill_stores": 0, "spill_loads": 0,
            "callees": {},
        },
    }
