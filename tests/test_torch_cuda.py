"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel against its plain version (ops/g1_ref.py, ops/g2_ref.py,
ops/secp_ref.py) on the same values, exact equality of coordinates mod p
and of flags; the era pipelines, the backend and its MSM routes, and the
batched ECDSA recovery on the card against the host oracles; the
Reed-Solomon product (rs_matmul8, rs_matmul16) bit for bit against
ops/rs_ref.py and an RBC flush's launch count; an N=16 HoneyBadger era
with a malicious router, a (7, 2) era with two equivocating
validators on both consensus engines, and a (7, 2) native root era
crashed in the middle and restarted from its send journals, on the card
against the plain versions; `g1_msm_batch` at the DKG's shapes and a
(7, 2) DKG fleet against the native host; the storage's transfer blocks
with their senders recovered on the card, and blocks executed by the
port's BlockManager on them with each ingest's senders recovered there. CUDA
kernels have no CPU mode:
on a machine without a card these tests skip, and `python3 chip_smoke.py`
runs the same checks at the N=64 era's shapes on the card.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher, scalar_verdict
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa, hashes, threshold_sig, tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import (
    _build, curve, g1, g1_ref, g2, g2_ref, glv, msm, rs, rs_batch, rs_ref, secp,
    secp_ref, verify,
)
from lachain_tpu_torch.ops.verify import (
    GlvEraPipeline,
    GpuEraPipeline,
    GpuTpkeVerifier,
    HostEraPipeline,
    TsGpuEraPipeline,
    TsHostEraPipeline,
)
from lachain_tpu_torch.parallel.mesh import (
    MeshEraPipeline,
    make_mesh,
    sharded_g1_msm,
    sharded_g2_msm,
)

pytestmark = [pytest.mark.cuda, pytest.mark.kernel]


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


def _points(rng, n):
    p = bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
    step = bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
    out = []
    for _ in range(n):
        out.append(p)
        p = bls.g1_add(p, step)
    return out


def _ref(points, dev):
    return torch.from_numpy(g1_ref.points_to_limbs(points)).to(dev)


def test_kernels_equal_plain_versions(card):
    rng = random.Random(0xC0DA)
    n = 256
    xs = [0, 1, bls.P - 1] + [rng.randrange(bls.P) for _ in range(n - 3)]
    ys = [rng.randrange(bls.P) for _ in range(n)]
    got = g1.fp_decode(g1.fp_mul(g1.fp_encode(xs, card), g1.fp_encode(ys, card)))
    assert got == [x * y % bls.P for x, y in zip(xs, ys)]

    ps, qs = _points(rng, n), _points(rng, n)
    kp, kq = g1.g1_pack(ps, card), g1.g1_pack(qs, card)
    rp, rq = _ref(ps, card), _ref(qs, card)
    assert g1.g1_coords(g1.g1_dbl(kp)) == g1.g1_coords(g1_ref.dbl(rp).cpu())
    assert g1.g1_coords(g1.g1_add(kp, kq)) == g1.g1_coords(
        g1_ref.add_incomplete(rp, rq).cpu()
    )

    table = [[bls.G1_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table.append([bls.g1_add(a, b) for a, b in zip(table[-1], ps)])
    scalars = [rng.randrange(1 << 32) for _ in range(n)]
    scalars[0] = 0
    digits = g1.digits_col(scalars, 8, card)
    acc, fl = g1.msm_scan(torch.stack([g1.g1_pack(r, card) for r in table]), digits)
    racc, rfl = g1_ref.msm_scan(torch.stack([_ref(r, card) for r in table]), digits)
    assert g1.g1_coords(acc) == g1.g1_coords(racc.cpu())
    assert torch.equal(fl.cpu(), rfl.cpu()) and bool(fl[0])


def _scan_case(rng, n, nwin, run, add, mul, inf):
    """Host table rows k*P and scalars for a scan at n lanes. Lane i % 4 is
    0: a random scalar; 1: zero (flagged to the end, beside unflagged lanes
    of the same warp); 2: a short scalar behind leading zero windows; 3: a
    collision, table[2] = 16*P and digits [.., 0, 1, 2], so the add after
    the doublings meets acc == entry and gives Z = 0."""
    pts = run(rng, n)
    table = [[inf] * n, pts]
    for _ in range(glv.TABLE - 2):
        table.append([add(a, b) for a, b in zip(table[-1], pts)])
    scalars = []
    for i in range(n):
        kind = i % 4
        if kind == 3:
            table[2][i] = mul(pts[i], 16)
        scalars.append((rng.randrange(1, 1 << (4 * nwin)), 0,
                        rng.randrange(16, 256), 0x12)[kind])
    return table, scalars


@pytest.mark.parametrize("n", [1, 3, 33, 256])
def test_g1_scan_lanes_and_collisions(card, n):
    rng = random.Random(0x5CA1 + n)
    table, scalars = _scan_case(rng, n, 8, _points, bls.g1_add, bls.g1_mul,
                                bls.G1_INF)
    digits = g1.digits_col(scalars, 8, card)
    acc, fl = g1.msm_scan(torch.stack([g1.g1_pack(r, card) for r in table]), digits)
    racc, rfl = g1_ref.msm_scan(torch.stack([_ref(r, card) for r in table]), digits)
    want = g1.g1_coords(racc.cpu())
    assert g1.g1_coords(acc) == want
    assert torch.equal(fl.cpu(), rfl.cpu())
    assert fl.cpu().tolist() == [i % 4 == 1 for i in range(n)]
    assert all(want[2 * n + i] == 0 for i in range(3, n, 4))


def _era(n, f, slots, seed):
    dealer = tpke.TpkeTrustedKeyGen(n, f, SeededRng(seed))
    lag = [0] * n
    for i, c in zip(range(f + 1), bls.fr_lagrange_coeffs(range(1, f + 2), at=0)):
        lag[i] = c
    jobs, cts, msgs = [], [], []
    for s in range(slots):
        msg = bytes([s + 3]) * 32
        ct = dealer.pub.encrypt(msg, s, SeededRng(seed + s + 1))
        row = [dealer.private_key(i).decrypt_share(ct, check=False).ui for i in range(n)]
        jobs.append(EraSlotJob(row, list(lag), tpke._hash_uv_to_g2(ct.u, ct.v), ct.w))
        cts.append(ct)
        msgs.append(msg)
    return dealer, jobs, cts, msgs


def test_era_pipeline_on_card_equals_host(card):
    dealer, jobs, _, _ = _era(5, 1, 3, seed=41)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    got, got_rlc = GpuEraPipeline(device=card).run_era(slots, y_points, SeededRng(2))
    want, want_rlc = HostEraPipeline().run_era(slots, y_points, SeededRng(2))
    assert got_rlc == want_rlc
    for g_slot, w_slot in zip(got, want):
        assert all(bls.g1_eq(a, b) for a, b in zip(g_slot, w_slot))


def test_backend_on_card_isolates_poisoned_slot(card):
    dealer, jobs, cts, msgs = _era(5, 1, 3, seed=43)
    row = list(jobs[2].u_by_validator)
    row[1] = bls.g1_add(row[1], bls.G1_GEN)
    jobs[2] = EraSlotJob(row, jobs[2].lagrange_row, jobs[2].h, jobs[2].w)
    g1.reset_launches()
    res = GpuBackend().tpke_era_verify_combine(
        jobs, dealer.verification_keys, SeededRng(3)
    )
    # the table build is one launch: no doubling of its own; the
    # conversions and phi's product by beta are g1_mont, not fp_mul; the
    # fixed-base key kernels serve the GLV pipeline only
    off_path = ("g1_dbl", "fp_mul", "g1_fixed_tables", "g1_fixed_scan")
    assert all(g1.LAUNCHES[k] == 0 for k in off_path)
    assert all(v > 0 for k, v in g1.LAUNCHES.items() if k not in off_path)
    assert [ok for ok, _ in res] == [True, True, False]
    for s in (0, 1):
        assert tpke.decrypt_with_combined(cts[s], res[s][1]) == msgs[s]


def _g2_points(rng, n):
    p = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    step = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    out = []
    for _ in range(n):
        out.append(p)
        p = bls.g2_add(p, step)
    return out


def _ref2(points, dev):
    return torch.from_numpy(g2_ref.points_to_limbs(points)).to(dev)


def _unpack(arr, flags=None) -> list:
    """Decode as the pipelines do: one fused buffer (flag row last) through
    `g1.fetch`, then `g2.g2_unpack_host`."""
    if flags is None:
        flags = torch.zeros(arr.shape[-1], dtype=torch.bool)
    rows, fl = g1.fetch(torch.cat([arr, flags.to(arr)[None, :]]))
    return g2.g2_unpack_host(rows, fl, arr.device.type == "cpu")


def test_g2_kernels_equal_plain_versions(card):
    rng = random.Random(0xC0DB)
    n = 128
    ps, qs = _g2_points(rng, n), _g2_points(rng, n)
    kp, kq = g2.g2_pack(ps, card), g2.g2_pack(qs, card)
    rp, rq = _ref2(ps, card), _ref2(qs, card)
    assert g2.g2_coords(g2.g2_dbl(kp)) == g2.g2_coords(g2_ref.dbl(rp).cpu())
    assert g2.g2_coords(g2.g2_add(kp, kq)) == g2.g2_coords(
        g2_ref.add_incomplete(rp, rq).cpu()
    )
    table = g2.build_table2(kp)
    rtable = [torch.zeros_like(rp), rp, g2_ref.dbl(rp)]
    for _ in range(glv.TABLE - 3):
        rtable.append(g2_ref.add_incomplete(rtable[-1], rp))
    scalars = [rng.randrange(1 << 64) for _ in range(n)]
    scalars[0] = 0
    scalars[1] = 3
    digits = g1.digits_col(scalars, 16, card)
    acc, fl = g2.msm2_scan(table, digits)
    racc, rfl = g2_ref.msm_scan(torch.stack(rtable), digits)
    assert g2.g2_coords(acc) == g2.g2_coords(racc.cpu())
    assert torch.equal(fl.cpu(), rfl.cpu()) and bool(fl[0]) and not bool(fl[1])
    got = _unpack(acc, fl)
    assert bls.g2_eq(got[2], bls.g2_mul(ps[2], scalars[2]))


@pytest.mark.parametrize("n", [1, 3, 33, 256])
def test_g2_scan_lanes_and_collisions(card, n):
    rng = random.Random(0x5CA2 + n)
    table, scalars = _scan_case(rng, n, 8, _g2_points, bls.g2_add, bls.g2_mul,
                                bls.G2_INF)
    digits = g1.digits_col(scalars, 8, card)
    acc, fl = g2.msm2_scan(torch.stack([g2.g2_pack(r, card) for r in table]), digits)
    racc, rfl = g2_ref.msm_scan(torch.stack([_ref2(r, card) for r in table]), digits)
    want = g2.g2_coords(racc.cpu())
    assert g2.g2_coords(acc) == want
    assert torch.equal(fl.cpu(), rfl.cpu())
    assert fl.cpu().tolist() == [i % 4 == 1 for i in range(n)]
    assert all(want[4 * n + i] == 0 and want[5 * n + i] == 0 for i in range(3, n, 4))


def test_tpke_era_launches_one_scan(card):
    """The joined era kernel: one table build (one launch), one scan and one
    tree reduce (log2 K adds) per era, no doubling; 4 g1_mont launches (the
    share pack, the key pack of a fresh pipeline, phi's product by beta, the
    fetch) and no fp_mul."""
    dealer, jobs, _, _ = _era(5, 1, 3, seed=47)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    g1.reset_launches()
    got, _ = GpuEraPipeline(device=card).run_era(slots, y_points, SeededRng(4))
    assert (g1.LAUNCHES["g1_msm_scan"], g1.LAUNCHES["g1_table"],
            g1.LAUNCHES["g1_dbl"], g1.LAUNCHES["g1_add"]) == (1, 1, 0, 3)  # K = 5 -> 8 lanes a slot
    assert (g1.LAUNCHES["g1_mont"], g1.LAUNCHES["fp_mul"]) == (4, 0)
    want, _ = HostEraPipeline().run_era(slots, y_points, SeededRng(4))
    for g_slot, w_slot in zip(got, want):
        assert all(bls.g1_eq(a, b) for a, b in zip(g_slot, w_slot))


def test_coin_pipeline_and_msm_routes_on_card(card):
    dealer = threshold_sig.TsTrustedKeyGen(5, 1, SeededRng(61))
    host = HostBackend()
    coins = []
    for c in range(3):
        msg = b"coin %d" % c
        sig = [dealer.private_key_share(i).sign(msg, host).sigma for i in range(5)]
        lag = [0] * 5
        for i, v in zip((0, 1), bls.fr_lagrange_coeffs([1, 2], at=0)):
            lag[i] = v
        coins.append((sig, lag))
    y_points = [k.y for k in dealer.pub_key_set.keys]
    g2.reset_launches()
    got, got_rlc = TsGpuEraPipeline(device=card).run_era(coins, y_points, SeededRng(2))
    # the table build is one launch: no G2 doubling of its own
    assert g2.LAUNCHES["g2_dbl"] == 0
    assert all(v > 0 for k, v in g2.LAUNCHES.items() if k != "g2_dbl")
    want, want_rlc = TsHostEraPipeline().run_era(coins, y_points, SeededRng(2))
    assert got_rlc == want_rlc
    for g, w in zip(got, want):
        assert bls.g2_eq(g[0], w[0]) and bls.g1_eq(g[1], w[1])
        assert bls.g2_eq(g[2], w[2])

    backend = GpuBackend()
    rng = random.Random(5)
    pts = [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) for _ in range(4)]
    scalars = [bls.R - 1, 0, rng.randrange(bls.R), 9]
    assert bls.g2_eq(backend.g2_msm(pts, scalars), host.g2_msm(pts, scalars))
    g1_pts = _points(rng, 5)
    assert bls.g1_eq(backend.g1_msm(g1_pts, scalars + [1]),
                     host.g1_msm(g1_pts, scalars + [1]))


def _secp_points(rng, n):
    return [ecdsa._mul(ecdsa.G, rng.randrange(1, ecdsa.N)) for _ in range(n)]


def test_secp_kernels_equal_plain_versions(card):
    rng = random.Random(0xC0DC)
    n = 256
    P = ecdsa.P
    xs = [0, 1, P - 1] + [rng.randrange(P) for _ in range(n - 3)]
    ys = [rng.randrange(P) for _ in range(n)]
    kx = secp.fe_encode(xs, card)
    got = secp.fe_decode(secp.secp_fp_mul(kx, secp.fe_encode(ys, card)))
    assert got == [x * y % P for x, y in zip(xs, ys)]
    rx = torch.from_numpy(secp_ref.ints_to_limbs(xs)).to(card)
    plain = secp._upload_words(secp._words(xs), card)  # sqrt takes plain words
    assert secp._download_words(secp.sqrt(plain)) == secp_ref.limbs_to_ints(
        secp_ref.sqrt(rx).cpu().numpy())

    ps, qs = _secp_points(rng, n), _secp_points(rng, n)
    qs[0] = ps[0]  # p == q: Z = 0 on both sides
    kp, kq = secp.pt_pack(ps, card), secp.pt_pack(qs, card)
    rp = torch.from_numpy(secp_ref.points_to_limbs(ps)).to(card)
    rq = torch.from_numpy(secp_ref.points_to_limbs(qs)).to(card)
    assert secp.pt_coords(secp.secp_dbl(kp)) == secp_ref.coords(secp_ref.dbl(rp).cpu())
    added = secp.pt_coords(secp.secp_add(kp, kq))
    assert added == secp_ref.coords(secp_ref.add_incomplete(rp, rq).cpu())
    assert added[2 * n] == 0

    table, rtable = secp.build_table(kp), [torch.zeros_like(rp), rp, secp_ref.dbl(rp)]
    for _ in range(glv.TABLE - 3):
        rtable.append(secp_ref.add_incomplete(rtable[-1], rp))
    scalars = [rng.randrange(1 << 64) for _ in range(n)]
    scalars[0], scalars[1] = 0, 3
    digits = g1.digits_col(scalars, 16, card)
    acc, fl = secp.msm_scan(table, digits)
    racc, rfl = secp_ref.msm_scan(torch.stack(rtable), digits)
    assert secp.pt_coords(acc) == secp_ref.coords(racc.cpu())
    assert torch.equal(fl.cpu(), rfl.cpu()) and bool(fl[0]) and not bool(fl[1])


def test_ecdsa_recover_batch_on_card(card):
    rng = random.Random(0xC0DD)
    privs = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(4)]
    hashes = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(8)]
    sigs = [ecdsa._sign_hash_py(privs[i % 4], h) for i, h in enumerate(hashes)]
    sigs[5] = sigs[5][:64] + bytes([4])  # v = 4: invalid
    k, z = 0x1234567, 0x55AA  # u1*R == u2*G: the pairwise add degenerates
    rp = ecdsa._mul(ecdsa.G, k)
    s = (ecdsa.N - z) * pow(k, -1, ecdsa.N) % ecdsa.N
    hashes.append(z.to_bytes(32, "big"))
    sigs.append(rp[0].to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([rp[1] & 1]))
    verify.reset_escapes()
    secp.reset_launches()
    got = ecdsa.recover_hash_batch(hashes, sigs)
    assert got == [ecdsa.recover_hash(h, s) for h, s in zip(hashes, sigs)]
    assert verify.ESCAPES["ecdsa_recover"] == 1
    # the table build is one launch, the conversions are secp_mont
    off_path = ("secp_dbl", "secp_fp_mul")
    assert all(secp.LAUNCHES[k] == 0 for k in off_path)
    assert all(v > 0 for k, v in secp.LAUNCHES.items() if k not in off_path)


def _secp_run(rng, n):
    """n distinct affine points R0 + i*S (chained affine adds)."""
    return glv.point_run(rng, n, ecdsa._mul, ecdsa._add, ecdsa.G, ecdsa.N)


def _secp_scan(card, table, scalars, nwin):
    """The secp scan and its plain version on host-built table rows."""
    digits = g1.digits_col(scalars, nwin, card)
    kt = torch.stack([secp.pt_pack(r, card) for r in table])
    rt = torch.stack([torch.from_numpy(secp_ref.points_to_limbs(r)).to(card)
                      for r in table])
    acc, fl = secp.msm_scan(kt, digits)
    racc, rfl = secp_ref.msm_scan(rt, digits)
    want = secp_ref.coords(racc.cpu())
    assert secp.pt_coords(acc) == want
    assert torch.equal(fl.cpu(), rfl.cpu())
    return want, fl.cpu().tolist()


@pytest.mark.parametrize("n", [1, 5, 8193])
def test_secp_scan_lanes_and_collisions(card, n):
    """The group-field secp scan at lane counts that are not a multiple of
    its block (16 lanes of 4 threads), with flagged lanes beside live ones
    in one warp and a collision lane (Z = 0)."""
    rng = random.Random(0x5CA3 + n)
    table, scalars = _scan_case(rng, n, 8, _secp_run, ecdsa._add, ecdsa._mul, None)
    want, flags = _secp_scan(card, table, scalars, 8)
    assert flags == [i % 4 == 1 for i in range(n)]
    assert all(want[2 * n + i] == 0 for i in range(3, n, 4))


def test_secp_scan_all_flagged_chunk(card):
    """A chunk whose lanes are all flagged (every digit zero): every warp
    skips its doublings and every lane comes back flagged at zero."""
    rng = random.Random(0x5CA4)
    n = 40
    pts = _secp_run(rng, n)
    table = [[None] * n, pts] + [list(pts) for _ in range(glv.TABLE - 2)]
    want, flags = _secp_scan(card, table, [0] * n, 64)
    assert flags == [True] * n and not any(want)


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_g2_table_over_random_and_infinity_lanes(card, n):
    """build_table2 in one launch equals the plain chain (one doubling, 13
    adds) entry for entry, infinity lanes (0, 1, 0) keeping Z = 0."""
    rng = random.Random(0x7AB + n)
    live = iter(_g2_points(rng, n))
    lanes = [bls.G2_INF if i % 3 == 1 else next(live) for i in range(n)]
    g2.reset_launches()
    table = g2.build_table2(g2.g2_pack(lanes, card))
    assert g2.LAUNCHES == dict(g2.LAUNCHES, g2_table=1, g2_dbl=0, g2_add=0)
    rtable = g2_ref.build_table(_ref2(lanes, card))
    for k in range(glv.TABLE):
        want = g2.g2_coords(rtable[k].cpu())
        assert g2.g2_coords(table[k]) == want
        for i in range(1, n, 3):
            assert want[4 * n + i] == want[5 * n + i] == 0
    assert bls.g2_eq(_unpack(table[5])[0], bls.g2_mul(lanes[0], 5))


@pytest.mark.parametrize("n", [1, 5, 4096])
def test_g2_add_on_group_field_with_collisions(card, n):
    """g2_add (4 threads a lane) against the plain add; lane 0 holds p == q
    and lane 1 p == -q: Z = 0 on both sides."""
    rng = random.Random(0xADD2 + n)
    ps, qs = _g2_points(rng, n), _g2_points(rng, n)
    qs[0] = ps[0]
    if n > 1:
        qs[1] = bls.g2_neg(ps[1])
    got = g2.g2_coords(g2.g2_add(g2.g2_pack(ps, card), g2.g2_pack(qs, card)))
    want = g2.g2_coords(g2_ref.add_incomplete(_ref2(ps, card), _ref2(qs, card)).cpu())
    assert got == want
    for i in range(min(n, 2)):
        assert want[4 * n + i] == want[5 * n + i] == 0


def test_coin_path_launch_counts(card):
    """The N=64 coin layout (64 signer lanes a coin, 22 live): one G2 table
    build, one G2 scan, 2 x 6 tree adds and no G2 doubling; the key RLC
    one G1 table build (one launch), scan and tree reduce (6 adds), no G1
    doubling; 3 g1_mont launches (the signature pack, the key pack of a
    fresh pipeline, the fetch) and no fp_mul."""
    rng = random.Random(0xC017)
    k, live = 64, 22
    y_points = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(k)]
    coins, masks = [], []
    for _ in range(2):
        sig = [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) if i < live
               else bls.G2_INF for i in range(k)]
        lag = [rng.randrange(1, bls.R) if i < live else 0 for i in range(k)]
        coins.append((sig, lag))
        masks.append([i < live for i in range(k)])
    g1.reset_launches()
    g2.reset_launches()
    got, _ = TsGpuEraPipeline(device=card).run_era(coins, y_points, SeededRng(7),
                                                   masks=masks)
    assert g2.LAUNCHES == {"g2_dbl": 0, "g2_add": 12, "g2_table": 1, "g2_msm_scan": 1}
    assert (g1.LAUNCHES["g1_msm_scan"], g1.LAUNCHES["g1_table"],
            g1.LAUNCHES["g1_dbl"], g1.LAUNCHES["g1_add"]) == (1, 1, 0, 6)
    assert (g1.LAUNCHES["g1_mont"], g1.LAUNCHES["fp_mul"]) == (3, 0)
    want, _ = TsHostEraPipeline().run_era(coins, y_points, SeededRng(7), masks=masks)
    for g, w in zip(got, want):
        assert bls.g2_eq(g[0], w[0]) and bls.g1_eq(g[1], w[1])
        assert bls.g2_eq(g[2], w[2])


def test_recover_path_launch_counts(card):
    """10,000 signatures (three 4096-signature chunks): one square root and
    per chunk 1 table build, 1 scan, 1 pair add and 2 Montgomery
    conversions (secp_mont; no doubling, no secp_fp_mul); every sender
    recovered."""
    import chip_smoke

    pubs, hashes, sigs, owner = chip_smoke.make_signatures(
        10000, 16, random.Random(0x5EC9))
    secp.reset_launches()
    verify.reset_escapes()
    got = ecdsa.recover_hash_batch(hashes, sigs, device="cuda")
    assert secp.LAUNCHES == {"secp_fp_mul": 0, "secp_dbl": 0, "secp_add": 3,
                             "secp_table": 3, "secp_msm_scan": 3, "secp_sqrt": 1,
                             "secp_mont": 6}
    assert not any(verify.ESCAPES.values())
    assert got == [pubs[o] for o in owner]


@pytest.mark.parametrize("n", [1, 63, 65, 8192])
def test_g1_table_over_random_and_infinity_lanes(card, n):
    """g1.build_table in one launch equals the plain chain (one doubling, 13
    adds) entry for entry, infinity lanes (0, 1, 0) keeping Z = 0; lane
    counts on both sides of a 64-thread block's 16 lanes."""
    rng = random.Random(0x7AB1 + n)
    live = iter(_points(rng, n))
    lanes = [bls.G1_INF if i % 3 == 1 else next(live) for i in range(n)]
    g1.reset_launches()
    table = g1.build_table(g1.g1_pack(lanes, card))
    assert g1.LAUNCHES == dict(g1.LAUNCHES, g1_table=1, g1_dbl=0, g1_add=0)
    rtable = g1_ref.build_table(_ref(lanes, card))
    for k in range(glv.TABLE):
        want = g1.g1_coords(rtable[k].cpu())
        assert g1.g1_coords(table[k]) == want
        assert all(want[2 * n + i] == 0 for i in range(1, n, 3))
    x, y, z = (g1.g1_coords(table[5])[j * n] for j in range(3))
    assert bls.g1_eq((x, y, z), bls.g1_mul(lanes[0], 5))


@pytest.mark.parametrize("n", [1, 63, 65, 8192])
def test_secp_table_over_random_and_infinity_lanes(card, n):
    """secp.build_table in one launch equals the plain chain entry for
    entry, infinity lanes (0, 1, 0) keeping Z = 0."""
    rng = random.Random(0x7AB2 + n)
    live = iter(_secp_run(rng, n))
    lanes = [None if i % 3 == 1 else next(live) for i in range(n)]
    secp.reset_launches()
    table = secp.build_table(secp.pt_pack(lanes, card))
    assert secp.LAUNCHES == dict(secp.LAUNCHES, secp_table=1, secp_dbl=0,
                                 secp_add=0)
    rtable = secp_ref.build_table(
        torch.from_numpy(secp_ref.points_to_limbs(lanes)).to(card))
    for k in range(glv.TABLE):
        want = secp_ref.coords(rtable[k].cpu())
        assert secp.pt_coords(table[k]) == want
        assert all(want[2 * n + i] == 0 for i in range(1, n, 3))
    x, y, z = (secp.pt_coords(table[5])[j * n] for j in range(3))
    zi = pow(z, -1, ecdsa.P)
    assert (x * zi * zi % ecdsa.P, y * zi ** 3 % ecdsa.P) == ecdsa._mul(lanes[0], 5)


@pytest.mark.parametrize("n", [1, 5, 8192])
def test_g1_add_on_group_field_with_collisions(card, n):
    """g1_add (4 threads a lane) against the plain add; lane 0 holds p == q
    and lane 1 p == -q: Z = 0 on both sides."""
    rng = random.Random(0xADD1 + n)
    ps, qs = _points(rng, n), _points(rng, n)
    qs[0] = ps[0]
    if n > 1:
        qs[1] = bls.g1_neg(ps[1])
    got = g1.g1_coords(g1.g1_add(g1.g1_pack(ps, card), g1.g1_pack(qs, card)))
    want = g1.g1_coords(g1_ref.add_incomplete(_ref(ps, card), _ref(qs, card)).cpu())
    assert got == want
    assert [want[2 * n + i] == 0 for i in range(min(n, 3))] == [True, True, False][:n]


@pytest.mark.parametrize("n", [1, 5, 63, 65, 8192])
def test_g1_dbl_on_group_field(card, n):
    """g1_dbl (a lane on one group of 4 threads, 16 lanes a 64-thread
    block) against the plain doubling word for word, on Jacobian points
    with Z != 1 and infinity lanes (0, 1, 0), which keep Z = 0; lane
    counts on both sides of a block's 16 lanes and a partial last group
    and block."""
    rng = random.Random(0xDB1 + n)
    live = iter(glv.point_run(rng, n))
    ps = [bls.G1_INF if i % 3 == 1 else next(live) for i in range(n)]
    attrs = _build.kernel_attrs()["g1_dbl"]
    assert attrs["threads_per_lane"] > 1 and attrs["block"] == 64
    g1.reset_launches()
    got = g1.g1_coords(g1.g1_dbl(g1.g1_pack(ps, card)))
    assert g1.LAUNCHES == dict(g1.LAUNCHES, g1_dbl=1)
    want = g1.g1_coords(g1_ref.dbl(_ref(ps, card)).cpu())
    assert got == want
    assert all(want[2 * n + i] == 0 for i in range(1, n, 3))
    assert bls.g1_eq((got[0], got[n], got[2 * n]), bls.g1_dbl(ps[0]))


@pytest.mark.parametrize("n", [1, 5, 63, 65, 8192])
def test_g2_dbl_on_group_field(card, n):
    """g2_dbl (a lane on one group of 4 threads, its Fp2 products out of
    line) against the plain doubling word for word, on Jacobian points
    with Z != 1 and infinity lanes (0, 1, 0), which keep Z = 0."""
    rng = random.Random(0xDB2 + n)
    live = iter(glv.point_run(rng, n, bls.g2_mul, bls.g2_add, bls.G2_GEN))
    ps = [bls.G2_INF if i % 3 == 1 else next(live) for i in range(n)]
    attrs = _build.kernel_attrs()["g2_dbl"]
    assert attrs["threads_per_lane"] > 1 and attrs["block"] == 64
    g2.reset_launches()
    got = g2.g2_coords(g2.g2_dbl(g2.g2_pack(ps, card)))
    assert g2.LAUNCHES == dict(g2.LAUNCHES, g2_dbl=1)
    want = g2.g2_coords(g2_ref.dbl(_ref2(ps, card)).cpu())
    assert got == want
    assert all(want[4 * n + i] == want[5 * n + i] == 0 for i in range(1, n, 3))
    assert bls.g2_eq(_unpack(g2.g2_dbl(g2.g2_pack(ps[:1], card)))[0],
                     bls.g2_dbl(ps[0]))


@pytest.mark.parametrize("n", [1, 5, 63, 65, 8192])
def test_secp_dbl_on_group_field(card, n):
    """secp_dbl (a lane on one group of 4 threads, 16 lanes a 64-thread
    block) against the plain doubling word for word, on Jacobian points
    with Z != 1 (a first doubling's output) and every third lane from lane
    1 infinity, which keeps Z = 0; lane counts on both sides of a block's
    16 lanes and a partial last group and block."""
    rng = random.Random(0xDB3 + n)
    live = iter(_secp_run(rng, n))
    ps = [None if i % 3 == 1 else next(live) for i in range(n)]
    attrs = _build.kernel_attrs()["secp_dbl"]
    assert attrs["threads_per_lane"] > 1 and attrs["block"] == 64
    rp = secp_ref.dbl(torch.from_numpy(secp_ref.points_to_limbs(ps)).to(card))
    kp = secp.secp_dbl(secp.pt_pack(ps, card))
    assert secp.pt_coords(kp) == secp_ref.coords(rp.cpu())
    secp.reset_launches()
    out = secp.secp_dbl(kp)
    assert secp.LAUNCHES == dict(dict.fromkeys(secp.LAUNCHES, 0), secp_dbl=1)
    got = secp.pt_coords(out)
    want = secp_ref.coords(secp_ref.dbl(rp).cpu())
    assert got == want
    assert all(want[2 * n + i] == 0 for i in range(1, n, 3))
    x, y, z = got[0], got[n], got[2 * n]
    zi = pow(z, -1, ecdsa.P)
    assert (x * zi * zi % ecdsa.P, y * zi ** 3 % ecdsa.P) == ecdsa._mul(ps[0], 4)


@pytest.mark.parametrize("n", [1, 5, 63, 65, 8191, 8192])
def test_fp_mul_on_group_field(card, n):
    """fp_mul (a lane's product on 4 threads) against the plain product and
    Python ints, its Montgomery words word for word, with 0, 1, p - 1 and
    R mod p (R = 2^384) among the operands."""
    P, r = bls.P, 1 << 384
    rng = random.Random(0xF1 + n)
    edge = [0, 1, P - 1, r % P]
    xs = (edge + [rng.randrange(P) for _ in range(n)])[:n]
    ys = (edge[::-1] + [rng.randrange(P) for _ in range(n)])[:n]
    attrs = _build.kernel_attrs()["fp_mul"]
    assert attrs["threads_per_lane"] > 1 and attrs["block"] == 64
    kx, ky = g1.fp_encode(xs, card), g1.fp_encode(ys, card)
    g1.reset_launches()
    prod = g1.fp_mul(kx, ky)
    assert g1.LAUNCHES == dict(dict.fromkeys(g1.LAUNCHES, 0), fp_mul=1)
    assert g1._from_words(prod.cpu().numpy().view(np.uint32)) == [
        x * y * r % P for x, y in zip(xs, ys)]
    ref = lambda v: torch.from_numpy(g1_ref.ints_to_limbs(v)).to(card)  # noqa: E731
    want = g1_ref.limbs_to_ints(g1_ref.fp_mul(ref(xs), ref(ys)).cpu().numpy())
    assert g1.fp_decode(prod) == want == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [1, 5, 63, 65, 8192])
def test_secp_fp_mul_on_group_field(card, n):
    """secp_fp_mul (a lane's product on 4 threads) against the plain product
    and Python ints, its Montgomery words word for word, with 0, 1, p - 1
    and 2^256 mod p among the operands."""
    P, r = ecdsa.P, 1 << 256
    rng = random.Random(0xF3 + n)
    edge = [0, 1, P - 1, r % P]
    xs = (edge + [rng.randrange(P) for _ in range(n)])[:n]
    ys = (edge[::-1] + [rng.randrange(P) for _ in range(n)])[:n]
    attrs = _build.kernel_attrs()["secp_fp_mul"]
    assert attrs["threads_per_lane"] > 1 and attrs["block"] == 64
    kx, ky = secp.fe_encode(xs, card), secp.fe_encode(ys, card)
    secp.reset_launches()
    prod = secp.secp_fp_mul(kx, ky)
    assert secp.LAUNCHES == dict(dict.fromkeys(secp.LAUNCHES, 0), secp_fp_mul=1)
    assert secp._download_words(prod) == [x * y * r % P for x, y in zip(xs, ys)]
    ref = lambda v: torch.from_numpy(secp_ref.ints_to_limbs(v)).to(card)  # noqa: E731
    want = secp_ref.limbs_to_ints(secp_ref.fp_mul(ref(xs), ref(ys)).cpu().numpy())
    assert secp.fe_decode(prod) == want == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [1, 5, 8192])
def test_secp_add_on_group_field_with_collisions(card, n):
    """secp_add (4 threads a lane) against the plain add; lane 0 holds
    p == q and lane 1 p == -q: Z = 0 on both sides."""
    rng = random.Random(0xADD3 + n)
    ps, qs = _secp_run(rng, n), _secp_run(rng, n)
    qs[0] = ps[0]
    if n > 1:
        qs[1] = (ps[1][0], ecdsa.P - ps[1][1])
    ref = lambda pts: torch.from_numpy(secp_ref.points_to_limbs(pts)).to(card)  # noqa: E731
    got = secp.pt_coords(secp.secp_add(secp.pt_pack(ps, card), secp.pt_pack(qs, card)))
    want = secp_ref.coords(secp_ref.add_incomplete(ref(ps), ref(qs)).cpu())
    assert got == want
    assert [want[2 * n + i] == 0 for i in range(min(n, 3))] == [True, True, False][:n]


def _sqrt_xs(rng, n):
    """n x values: G's x, 0, 1, p - 1 and a non-residue first, then random
    (about half of them non-residues)."""
    P = ecdsa.P
    nr = next(x for x in range(2, 100) if pow((x**3 + 7) % P, (P - 1) // 2, P) == P - 1)
    return ([ecdsa.GX, 0, 1, P - 1, nr] + [rng.randrange(P) for _ in range(n)])[:n]


@pytest.mark.parametrize("n", [1, 63, 65, 9980, 16384])
def test_sqrt_on_plain_words(card, n):
    """The group-field square root (the addition chain, its own
    conversions) on plain words equals the plain version mod p on every
    lane, at lane counts that are not a multiple of the block's groups and
    at the recovery's 9,980."""
    xs = _sqrt_xs(random.Random(0x5021 + n), n)
    secp.reset_launches()
    got = secp._download_words(secp.sqrt(secp._upload_words(secp._words(xs), card)))
    assert secp.LAUNCHES == dict(dict.fromkeys(secp.LAUNCHES, 0), secp_sqrt=1)
    rx = torch.from_numpy(secp_ref.ints_to_limbs(xs)).to(card)
    assert got == secp_ref.limbs_to_ints(secp_ref.sqrt(rx).cpu().numpy())
    P = ecdsa.P
    assert got[:4] == [pow((x**3 + 7) % P, (P + 1) // 4, P) for x in xs[:4]]


@pytest.mark.parametrize("n", [1, 63, 65, 8191])
def test_mont_convert_on_card(card, n):
    """secp_mont into and out of Montgomery form equals Python ints (x R
    mod p and back) and the plain version word for word, with 0, 1 and p
    - 1 among the values, and copies a flag row bit for bit."""
    P, r = ecdsa.P, 1 << 256
    rng = random.Random(0x5024 + n)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n)])[: 3 * n]
    words = np.concatenate([secp._words(vals[c * n : (c + 1) * n]) for c in range(3)])
    flags = np.array([rng.randrange(-(1 << 31), 1 << 31) for _ in range(n)], np.int32)
    buf = torch.from_numpy(np.concatenate([words.view(np.int32), flags[None]])).to(card)
    secp.reset_launches()
    into = secp.mont_convert(buf, into=True)
    assert secp._download_words(into[:-1]) == [v * r % P for v in vals]
    assert torch.equal(into[-1], buf[-1])
    assert torch.equal(into, secp_ref.mont_mul_words(buf, secp._R2))
    back = secp.mont_convert(into, into=False)
    assert torch.equal(back, buf)
    assert torch.equal(back, secp_ref.mont_mul_words(into, 1))
    one = secp.mont_convert(buf[: secp.NL].contiguous(), into=False)
    assert secp._download_words(one) == [v * pow(r, -1, P) % P for v in vals[:n]]
    assert secp.LAUNCHES == dict(dict.fromkeys(secp.LAUNCHES, 0), secp_mont=3)


def test_secp_sqrt_and_mont_attrs(card):
    """The conversion and square-root kernels' registers, local bytes,
    threads per lane and block read through lt_secp_kernel_attrs and
    lt_g1_kernel_attrs."""
    from lachain_tpu_torch.ops import _build

    attrs = _build.kernel_attrs()
    for name, scan in (("secp_sqrt", "secp"), ("secp_mont", "secp"),
                       ("g1_mont", "g1")):
        a = attrs[name]
        assert a["regs"] > 0 and a["local_bytes"] >= 0
        assert a["threads_per_lane"] == attrs[f"{scan}_msm_scan"]["threads_per_lane"]
        assert a["block"] == 64


@pytest.mark.parametrize("n", [1, 63, 65, 4096, 16384])
def test_g1_mont_on_card(card, n):
    """g1_mont into and out of Montgomery form and by beta equals the plain
    version bit for bit and Python ints, on (12c, n) and (12c + 1, n)
    buffers (a flag row copied bit for bit) and on a G2 (72, n) buffer,
    with 0, 1, p - 1 among the values and, out of form, words up to
    2^384 - 1."""
    P, r = bls.P, 1 << 384
    r_inv = pow(r, -1, P)
    rng = random.Random(0x6A5 + n)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n)])[: 3 * n]
    words = np.concatenate([g1._words(vals[c * n : (c + 1) * n]) for c in range(3)])
    flags = np.array([rng.randrange(-(1 << 31), 1 << 31) for _ in range(n)], np.int32)
    buf = torch.from_numpy(np.concatenate([words.view(np.int32), flags[None]])).to(card)

    def ints(t):
        return g1._from_words(t.cpu().numpy().view(np.uint32))

    g1.reset_launches()
    into = g1.mont_convert(buf, into=True)
    assert ints(into[:-1]) == [v * r % P for v in vals]
    assert torch.equal(into[-1], buf[-1])
    assert torch.equal(into, g1_ref.mont_mul_words(buf, g1._R2))
    back = g1.mont_convert(into, into=False)
    assert torch.equal(back, buf)
    assert torch.equal(back, g1_ref.mont_mul_words(into, 1))
    plain = g1.mont_convert(into[:-1].contiguous(), into=False)  # 12c rows
    assert torch.equal(plain, buf[:-1])
    beta = g1.mul_beta(into[: g1.NL].contiguous())
    assert ints(beta) == [glv.BETA * v * r % P for v in vals[:n]]
    assert torch.equal(beta, g1_ref.mont_mul_words(into[: g1.NL], g1._BETA_R))
    # out of form reads any 384-bit word: the value / R mod p, canonical
    wild = ([r - 1, P, 9 * P] + [rng.randrange(r) for _ in range(n)])[:n]
    wt = torch.from_numpy(g1._words(wild).view(np.int32)).to(card)
    assert ints(g1.mont_convert(wt, into=False)) == [v * r_inv % P for v in wild]
    # a G2 buffer: six coordinates of 12 rows
    g2vals = [rng.randrange(P) for _ in range(6 * n)]
    g2buf = torch.from_numpy(np.concatenate(
        [g1._words(g2vals[c * n : (c + 1) * n]) for c in range(6)]).view(np.int32)).to(card)
    g2m = g1.mont_convert(g2buf, into=True)
    assert torch.equal(g2m, g1_ref.mont_mul_words(g2buf, g1._R2))
    assert ints(g2m) == [v * r % P for v in g2vals]
    assert g1.LAUNCHES == dict(dict.fromkeys(g1.LAUNCHES, 0), g1_mont=6)
    with pytest.raises(ValueError):
        # a strided view (every other lane of a wider buffer) is refused
        g1.mont_convert(torch.cat([buf, buf], dim=1)[:, ::2], into=True)


@pytest.mark.parametrize("n", [1, 63, 65, 4097])
def test_recover_batch_unpadded_on_card(card, n, monkeypatch):
    """n valid signatures (4097: a full chunk and one more): the square
    root launches over exactly n lanes, every signer's key comes back, and
    a sample equals recover_hash."""
    import chip_smoke

    pubs, hashes, sigs, owner = chip_smoke.make_signatures(n, 8, random.Random(0x5022 + n))
    lanes = []
    real = secp.sqrt

    def counted(x):
        lanes.append(x.shape[-1])
        return real(x)

    monkeypatch.setattr(secp, "sqrt", counted)
    secp.reset_launches()
    got = secp.GpuEcdsaRecover(card).recover_batch(hashes, sigs)
    chunks = -(-n // secp.GpuEcdsaRecover.CHUNK)
    assert lanes == [n]
    assert secp.LAUNCHES["secp_sqrt"] == 1 and secp.LAUNCHES["secp_mont"] == 2 * chunks
    assert got == [pubs[o] for o in owner]
    for i in random.Random(n).sample(range(n), min(n, 16)):
        assert got[i] == ecdsa.recover_hash(hashes[i], sigs[i])


def _rs_case(bits, shapes, seed, zero_lines=False):
    """Groups (rows, k, cols) of random symbols (a fifth of them 0) with
    B's unread rows noise -> (numpy mats, numpy b, widths); zero_lines
    also zeroes a row and a column of each A and every third column of B."""
    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    rng = np.random.default_rng(seed)

    def sym(shape):
        m = rng.integers(1, field.order + 1, size=shape).astype(field.dtype)
        m[rng.random(shape) < 0.2] = 0
        return m

    kmax = max(k for _r, k, _c in shapes)
    mats = [sym((r, k)) for r, k, _c in shapes]
    b = sym((kmax, sum(c for _r, _k, c in shapes)))
    if zero_lines:
        for m in mats:
            if m.size:
                m[rng.integers(m.shape[0])] = 0
                m[:, rng.integers(m.shape[1])] = 0
        b[:, ::3] = 0
    return mats, b, [c for _r, _k, c in shapes]


# the card's launch shapes of the RBC flushes (N=64: encode, decode of 64
# erasure patterns, re-encode; N=256 the same), ragged widths (groups of
# 1-7 columns, C not a multiple of 4), a group of 0 rows and groups of 0
# columns
RS_SHAPES = {
    "unit": (8, [(1, 1, 1)]),
    "n64_encode": (8, [(64, 22, 131)]),
    "n64_decode": (8, [(22, 22, 131)] * 64),
    "n64_reencode": (8, [(64, 22, 8384)]),
    "mixed8": (8, [(5, 3, 33), (9, 7, 0), (2, 7, 20), (64, 4, 1), (13, 22, 700)]),
    "ragged8": (8, [(7, 5, 1), (3, 5, 2), (9, 5, 3), (4, 2, 5), (0, 5, 6), (9, 5, 7),
                    (1, 1, 0), (6, 40, 1)]),
    "unit16": (16, [(3, 2, 7)]),
    "n256_encode": (16, [(256, 86, 5)]),
    "n256_decode": (16, [(86, 86, 5)] * 256),
    "n256_reencode": (16, [(256, 86, 1280)]),
    "mixed16": (16, [(86, 86, 5)] * 16 + [(300, 100, 3), (1, 1, 0)]),
    "ragged16": (16, [(7, 5, 1), (3, 5, 2), (0, 5, 3), (130, 97, 301), (1, 1, 0)]),
}


@pytest.mark.parametrize("case", sorted(RS_SHAPES))
@pytest.mark.parametrize("zero_lines", [False, True])
def test_rs_matmul_equals_plain(card, case, zero_lines):
    """One launch over every group equals the plain version bit for bit
    (groups of their own rows and k, a group of no columns, rows past a
    group's k of B unread, rows past its rows of C zero), and GF.matmul
    on the first groups."""
    bits, shapes = RS_SHAPES[case]
    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    mats, b, widths = _rs_case(bits, shapes, seed=len(shapes) * bits, zero_lines=zero_lines)
    kmats = [torch.from_numpy(rs_batch.operand(bits, m)).to(card) for m in mats]
    kb = torch.from_numpy(b).to(card)
    rs_batch.reset_launches()
    got = rs_batch.rs_matmul(bits, kmats, kb, widths).cpu().numpy()
    assert rs_batch.LAUNCHES == dict(dict.fromkeys(rs_batch.LAUNCHES, 0),
                                     **{f"rs_matmul{bits}": 1})
    want = rs_batch.rs_matmul_plain(bits, kmats, kb, widths).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    off = 0
    for m, w in zip(mats[:8], widths[:8]):
        np.testing.assert_array_equal(got[: m.shape[0], off : off + w],
                                      field.matmul(m, b[: m.shape[1], off : off + w]))
        assert not got[m.shape[0] :, off : off + w].any()
        off += w


@pytest.mark.parametrize("case,tiles", [
    ("n64_reencode", (64, 256, 22)),  # 4096 units: sixteen passes of the block
    ("n64_reencode", (5, 3, 8)),      # k = 22 over three stages
    ("ragged8", (64, 1, 32)),         # k = 40: two stages
    ("n256_reencode", (128, 256, 96)),  # 32,768 units: many passes
    ("n256_decode", (86, 5, 40)),     # k = 86 over three stages
    ("mixed16", (3, 1, 96)),          # k = 100: two stages
    ("ragged16", (128, 7, 13)),
])
def test_rs_matmul_tiles_equal_plain(card, case, tiles):
    """Tiles other than the wrapper's (a tile of more units than a block
    has threads, tiles of a few rows or columns, stages of fewer j than k)
    give the same product."""
    bits, shapes = RS_SHAPES[case]
    mats, b, widths = _rs_case(bits, shapes, seed=7, zero_lines=True)
    kmats = [torch.from_numpy(rs_batch.operand(bits, m)).to(card) for m in mats]
    kb = torch.from_numpy(b).to(card)
    got = rs_batch.launch(_build.library(), bits, rs_batch.group_info(bits, kmats), kb,
                          widths, tiles)
    want = rs_batch.rs_matmul_plain(bits, kmats, kb, widths)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("bits", [8, 16])
def test_rs_matmul_empty_result_launches_nothing(card, bits):
    """A call with no rows (groups of 0 rows), no columns or no groups
    returns its empty result and neither launches a kernel nor counts
    one."""
    mats, b, _widths = _rs_case(bits, [(3, 2, 4)], seed=3)
    form = torch.from_numpy(rs_batch.operand(bits, mats[0])).to(card)
    no_rows = form[:0].contiguous()
    kb = torch.from_numpy(b).to(card)
    rs_batch.reset_launches()
    assert rs_batch.rs_matmul(bits, [no_rows], kb, [4]).shape == (0, 4)
    assert rs_batch.rs_matmul(bits, [form], kb[:, :0].contiguous(), [0]).shape == (3, 0)
    assert rs_batch.rs_matmul(bits, [form, no_rows], kb[:, :0].contiguous(), [0, 0]).shape == (3, 0)
    assert rs_batch.rs_matmul(bits, [], kb[:, :0].contiguous(), []).shape == (0, 0)
    torch.cuda.synchronize()
    assert rs_batch.LAUNCHES == dict.fromkeys(rs_batch.LAUNCHES, 0)


@pytest.mark.parametrize("bits,offset", [(8, 1), (8, 2), (8, 3), (16, 1)])
def test_rs_matmul_on_unaligned_views(card, bits, offset):
    """B a contiguous view `offset` symbols into its buffer (GF(2^8): at
    an address that is not 4-byte aligned, as kb[1:] of an odd C is)
    gives the plain version's product; ragged groups."""
    mats, b, widths = _rs_case(bits, [(22, 22, 131), (5, 3, 7), (9, 22, 2)], seed=11,
                               zero_lines=True)
    buf = np.zeros(offset + b.size, dtype=b.dtype)
    buf[offset:] = b.reshape(-1)
    kb = torch.from_numpy(buf).to(card)[offset:].view(b.shape)
    assert kb.is_contiguous() and (bits == 16 or kb.data_ptr() % 4)
    kmats = [torch.from_numpy(rs_batch.operand(bits, m)).to(card) for m in mats]
    got = rs_batch.rs_matmul(bits, kmats, kb, widths)
    want = rs_batch.rs_matmul_plain(bits, kmats, torch.from_numpy(b).to(card), widths)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_rs_matmul_refuses_unaligned_tables(card):
    """GF(2^8)'s nibble tables are read in 16-byte loads: a form on the
    card at an address that is not 16-byte aligned is refused before any
    launch."""
    mats, b, widths = _rs_case(8, [(4, 3, 5)], seed=5)
    form = rs_batch.operand(8, mats[0])
    buf = np.zeros(1 + form.size, dtype=np.uint8)
    buf[1:] = form.reshape(-1)
    flat = torch.from_numpy(buf).to(card)
    rs_batch.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        rs_batch.rs_matmul(8, [flat[1:].view(form.shape)], torch.from_numpy(b).to(card), widths)
    assert rs_batch.LAUNCHES["rs_matmul8"] == 0


@pytest.mark.parametrize("n,size", [(16, 300), (64, 2871), (260, 40)])
def test_rbc_flush_on_card(card, n, size):
    """An era's flush on the card: 3 launches (encode, decode, re-encode),
    every verdict scalar_verdict's (slot 1 equivocating: None), the encode
    the host codec's."""
    rng = random.Random(n)
    k = n - 2 * ((n - 1) // 3)
    own = rng.randbytes(size)
    evil = rs_batch.encode(rng.randbytes(size), k, n, device="numpy")
    slots = []
    for s in range(8):
        shards = list(rs_batch.encode(rng.randbytes(size), k, n, device="numpy"))
        if s == 1:
            shards[0] = evil[0]
        root = hashes.merkle_root(hashes.keccak256_batch(shards))
        for i in rng.sample(range(n), 0 if s == 1 else rng.randint(0, n - k)):
            shards[i] = None
        slots.append((shards, root))
    batcher = RbcEraBatcher(device="cuda")
    enc, verdicts = [], {}
    batcher.submit_encode(0, own, k, n, enc.append)
    for s, (shards, root) in enumerate(slots):
        batcher.submit_interpolate(0, shards, k, n, root,
                                   lambda v, s=s: verdicts.__setitem__(s, v))
    rs_batch.reset_launches()
    batcher.flush()
    bits = rs_batch.field_for(n).bits
    assert rs_batch.LAUNCHES == dict(dict.fromkeys(rs_batch.LAUNCHES, 0),
                                     **{f"rs_matmul{bits}": 3})
    assert enc == [rs.encode(own, k, n)]
    for s, (shards, root) in enumerate(slots):
        assert verdicts[s] == scalar_verdict(shards, k, root)
    assert verdicts[1] is None and verdicts[0] is not None


def test_rs_attrs(card):
    attrs = _build.kernel_attrs()
    for name, block in (("rs_matmul8", 256), ("rs_matmul16", 1024)):
        assert attrs[name]["block"] == block and attrs[name]["local_bytes"] == 0


def _dispatch_eras(seed):
    """Three 2-slot eras of one N=5 key set, as (slots, y_points)."""
    dealer, jobs, _, _ = _era(5, 1, 6, seed=seed)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    return [slots[0:2], slots[2:4], slots[4:6]], y_points


def _assert_eras_equal(got, want):
    for (g_out, g_rlc), (w_out, w_rlc) in zip(got, want):
        assert g_rlc == w_rlc
        for g_slot, w_slot in zip(g_out, w_out):
            assert all(bls.g1_eq(a, b) for a, b in zip(g_slot, w_slot))


@pytest.mark.parametrize("sleep", [False, True])
def test_two_stream_dispatch_equals_synchronous(card, sleep, monkeypatch):
    """Two eras in flight on the pipeline's two streams, then a third
    after the first finished (refilling pinned buffer 0 and running on
    stream 0 again), equal run_era of the same eras in the same draw order;
    with `sleep`, each dispatch's kernels wait behind a spin kernel on its
    stream, so that the eras overlap on the card."""
    eras, y_points = _dispatch_eras(61)
    rng = SeededRng(8)
    want = [GpuEraPipeline(device=card).run_era(sl, y_points, rng) for sl in eras]
    if sleep:
        fused = g1.era_kernel_fused

        def slow(*args, **kwargs):
            torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz, on the era's stream
            return fused(*args, **kwargs)

        monkeypatch.setattr(g1, "era_kernel_fused", slow)
    verify.reset_escapes()
    pipe = GpuEraPipeline(device=card)
    rng = SeededRng(8)
    first = pipe.dispatch_era(eras[0], y_points, rng)
    second = pipe.dispatch_era(eras[1], y_points, rng)
    assert first._stream is not second._stream
    with pytest.raises(RuntimeError, match="MAX_INFLIGHT"):
        pipe.dispatch_era(eras[2], y_points, rng)
    got = [first()]
    third = pipe.dispatch_era(eras[2], y_points, rng)
    assert third._stream is first._stream
    got += [second(), third()]
    _assert_eras_equal(got, want)
    assert verify.ESCAPES["tpke_combine"] == 0
    assert len(pipe._staging) == 1 and pipe._inflight == 0
    assert all(d.timings["device_s"] > 0 for d in (first, second, third))


def test_dispatch_returns_before_the_previous_era_completes(card, monkeypatch):
    """With era e's kernels held behind a ~0.5 s spin kernel on its stream,
    dispatching era e+1 returns on the host while era e's completion event
    has not fired: no step of a dispatch waits for the card."""
    eras, y_points = _dispatch_eras(67)
    pipe = GpuEraPipeline(device=card)
    for d in [pipe.dispatch_era(sl, y_points, SeededRng(1)) for sl in eras[:2]]:
        d()  # warm: both streams' allocations, the tiled keys, the staging
    fused = g1.era_kernel_fused
    held = []

    def slow(*args, **kwargs):
        if not held:
            torch.cuda._sleep(1_000_000_000)
        held.append(True)
        return fused(*args, **kwargs)

    monkeypatch.setattr(g1, "era_kernel_fused", slow)
    rng = SeededRng(2)
    first = pipe.dispatch_era(eras[0], y_points, rng)
    second = pipe.dispatch_era(eras[1], y_points, rng)
    assert not first.done.query()
    got = [first(), second()]
    assert first.timings["wait_s"] > 0.05
    want_pipe = GpuEraPipeline(device=card)
    rng = SeededRng(2)
    _assert_eras_equal(got, [want_pipe.run_era(sl, y_points, rng) for sl in eras[:2]])


def test_batcher_on_card_equals_synchronous_era(card):
    """TpkeEraBatcher over GpuBackend(): 5 slots, one poisoned, in chunks of
    2 at depth 1 and 2, equal one synchronous era call of the same jobs."""
    from lachain_tpu_torch.consensus.crypto_batcher import TpkeEraBatcher

    dealer, jobs, cts, msgs = _era(5, 1, 5, seed=71)
    row = list(jobs[3].u_by_validator)
    row[0] = bls.g1_add(row[0], bls.G1_GEN)
    jobs[3] = EraSlotJob(row, jobs[3].lagrange_row, jobs[3].h, jobs[3].w)
    vks = dealer.verification_keys
    backend = GpuBackend()
    want = backend.tpke_era_verify_combine(jobs, vks, SeededRng(5))
    assert [ok for ok, _ in want] == [True, True, True, False, True]
    for depth in (1, 2):
        batcher = TpkeEraBatcher(backend, SeededRng(6), max_slots_per_call=2, depth=depth)
        got = []
        for job in jobs:
            batcher.submit([job], vks, got.extend)
        g1.reset_launches()
        assert batcher.flush() == 5
        assert batcher.chunks == 3 and g1.LAUNCHES["g1_msm_scan"] == 3
        assert [ok for ok, _ in got] == [ok for ok, _ in want]
        for (ok, comb), (_, wcomb), ct, msg in zip(got, want, cts, msgs):
            assert (comb is None) if not ok else (
                bls.g1_eq(comb, wcomb) and tpke.decrypt_with_combined(ct, comb) == msg)


def test_warmup_on_card(card):
    from lachain_tpu_torch.crypto.warmup import era_warmup_shapes, warmup_era_kernels

    t = warmup_era_kernels(5, GpuBackend())
    t.join(timeout=300)
    assert not t.is_alive() and t.error is None
    assert t.eras == [("tpke", s) for s in era_warmup_shapes(5)] + [("coin", 1)]


# ---------------------------------------------------------------------------
# the fixed-base key kernels, the GLV era and the bit-serial MSM entries
# ---------------------------------------------------------------------------


def _window_ints(tables, w: int) -> list:
    """Window w of card tables (16, 16, 36, K) or plain ones (16, 16, 132,
    K) -> every coordinate's ints, entry by entry."""
    if tables.dtype == torch.int32:  # the card's Montgomery words
        return g1.fp_decode(tables[w].reshape(16 * 36, tables.shape[-1]))
    k = tables.shape[-1]
    limbs = tables[w].reshape(48, 44, k).permute(1, 0, 2).reshape(44, 48 * k)
    return g1_ref.limbs_to_ints(limbs.cpu().numpy())


@pytest.mark.parametrize("k", [1, 5, 64, 256])
def test_fixed_tables_equal_plain_version(card, k):
    """Every entry of every window word for word against the plain
    version (one doubling chain a key, the tables in log depth), an
    infinity key among the keys; some entries against the host's
    d * 16^(15 - w) * Y_i."""
    rng = random.Random(0xF1 + k)
    keys = _points(rng, k)
    if k > 1:
        keys[k // 2] = bls.G1_INF
    g1.reset_launches()
    kt = g1.fixed_tables(g1.g1_pack(keys, card))
    assert g1.LAUNCHES["g1_fixed_tables"] == 1
    rt = g1_ref.fixed_tables(_ref(keys, card))
    for w in range(glv.W64):
        assert _window_ints(kt, w) == _window_ints(rt, w), w
    for w, d in ((0, 1), (7, 15), (15, 1), (15, 15)):
        co = g1.g1_coords(kt[w, d])
        for i, y in enumerate(keys):
            if y[2]:
                want = bls.g1_mul(y, d * 16 ** (glv.W64 - 1 - w))
                assert bls.g1_eq((co[i], co[k + i], co[2 * k + i]), want)


@pytest.mark.parametrize("k,slots", [(1, 1), (4, 3), (64, 64), (256, 256)])
def test_fixed_scan_equal_plain_version(card, k, slots):
    """The scan word for word against the plain version (a lane's windows
    over 4 sub-lanes, their partials in the same order), at N=64's 4096
    lanes and N=256's 65,536 among others; flags and some lanes against
    the host's rlc * Y."""
    rng = random.Random(0xF5 + k)
    keys = _points(rng, k)
    kt = g1.fixed_tables(g1.g1_pack(keys, card))
    rt = g1_ref.fixed_tables(_ref(keys, card))
    n = k * slots
    rlc = [rng.randrange(1, 1 << 64) for _ in range(n)]
    rlc[0] = 0  # an all-zero lane
    if n > 2:
        rlc[1] = 0xF00000000000000F  # zero digits between nonzero ones
        rlc[2] = 5  # leading zero windows
    digits = g1.digits_col(rlc, glv.W64, card)
    g1.reset_launches()
    acc, fl = g1.fixed_scan(kt, digits, k)
    assert g1.LAUNCHES["g1_fixed_scan"] == 1
    racc, rfl = g1_ref.fixed_scan(rt, digits, k)
    assert g1.g1_coords(acc) == g1.g1_coords(racc.cpu())
    assert fl.cpu().tolist() == rfl.cpu().tolist() == [c == 0 for c in rlc]
    co = g1.g1_coords(acc)
    for j in range(1, min(n, 4)):
        assert bls.g1_eq((co[j], co[n + j], co[2 * n + j]), bls.g1_mul(keys[j % k], rlc[j]))


def test_glv_era_on_card_equals_gpu_pipeline(card):
    """GlvEraPipeline on the card against GpuEraPipeline and the host
    oracle, with its launches: a key set's first era builds the tables
    (g1_fixed_tables 1, g1_mont 4), a warm era does not (g1_mont 3)."""
    dealer, jobs, _, _ = _era(5, 1, 3, seed=53)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    masks = [[True] * 5, [True, False, True, True, True], [True] * 5]
    pipeline = GlvEraPipeline(device=card)
    want, want_rlc = HostEraPipeline().run_era(slots, y_points, SeededRng(8), masks)
    ref, _ = GpuEraPipeline(device=card).run_era(slots, y_points, SeededRng(8), masks)
    warm = {"g1_table": 1, "g1_msm_scan": 1, "g1_fixed_scan": 1, "g1_add": 3,
            "g1_mont": 3, "g1_fixed_tables": 0, "g1_dbl": 0, "fp_mul": 0}
    for first in (True, False):
        g1.reset_launches()
        verify.reset_escapes()
        got, got_rlc = pipeline.run_era(slots, y_points, SeededRng(8), masks)
        assert g1.LAUNCHES == dict(warm, g1_fixed_tables=int(first),
                                   g1_mont=3 + int(first))
        assert not any(verify.ESCAPES.values())
        assert got_rlc == want_rlc
        for g_slot, w_slot, r_slot in zip(got, want, ref):
            assert all(bls.g1_eq(a, b) and bls.g1_eq(a, c)
                       for a, b, c in zip(g_slot, w_slot, r_slot))


def test_backend_on_glv_pipeline_on_card(card):
    dealer, jobs, cts, msgs = _era(5, 1, 3, seed=59)
    row = list(jobs[0].u_by_validator)
    row[4] = bls.g1_add(row[4], bls.G1_GEN)
    jobs[0] = EraSlotJob(row, jobs[0].lagrange_row, jobs[0].h, jobs[0].w)
    backend = GpuBackend(device=card, pipeline=GlvEraPipeline(device=card))
    res = backend.tpke_era_verify_combine(jobs, dealer.verification_keys, SeededRng(9))
    assert [ok for ok, _ in res] == [False, True, True]
    for s in (1, 2):
        assert tpke.decrypt_with_combined(cts[s], res[s][1]) == msgs[s]


def test_glv_kernel_entry_equals_era_kernel(card):
    rng = random.Random(0xE4)
    s, k = 3, 8
    u = g1.g1_pack(_points(rng, s * k), card)
    y = g1.g1_pack(_points(rng, k) * s, card)
    rlc = g1.digits_col([rng.randrange(1 << 64) for _ in range(s * k)], glv.W64, card)
    lag1, lag2 = (g1.digits_col([rng.randrange(1 << 128) for _ in range(s * k)],
                                glv.W128, card) for _ in range(2))
    pts, flags = msm.tpke_era_glv_kernel(u, y, rlc, lag1, lag2, k)
    out_r, ofl_r, out_l, ofl_l = g1.era_kernel(u, y, rlc, lag1, lag2, k)
    want = torch.cat([out_r, out_l], dim=1).reshape(-1, 4, s).transpose(1, 2)
    assert torch.equal(pts, want)
    assert torch.equal(flags, torch.cat([ofl_r, ofl_l]).reshape(4, s).T)


def test_curve_msm_and_verifier_on_card(card):
    """g1_msm / g2_msm at n = 5 (padded to 8) with 256 bits against the host
    MSM, an infinity input among the points; a repeated point gives Z = 0
    with the flag clear; GpuTpkeVerifier against the host, and escaping a
    colliding combine."""
    rng = random.Random(0xC5)
    host = HostBackend()
    pts = _points(rng, 5)
    pts[3] = bls.G1_INF
    q2 = _g2_points(rng, 5)
    sc = [rng.randrange(bls.R) for _ in range(5)]
    bits = torch.from_numpy(curve.scalars_to_bits(sc, 256)).to(card)
    pt, fl = curve.g1_msm(g1.g1_pack(pts, card), bits)
    cpu = card.type == "cpu"
    got = g1.g1_unpack_host(*g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None]), cpu)
    assert bls.g1_eq(got[0], host.g1_msm(pts, sc))
    pt, fl = curve.g2_msm(g2.g2_pack(q2, card), bits)
    rows, fls = g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None])
    assert bls.g2_eq(g2.g2_unpack_host(rows, fls, cpu)[0], host.g2_msm(q2, sc))
    pt, fl = curve.g1_msm(g1.g1_pack([pts[0], pts[0]], card), bits[:1].repeat(2, 1))
    assert not bool(fl) and g1.g1_coords(pt[:, None])[2] == 0

    dealer, jobs, cts, msgs = _era(5, 1, 1, seed=67)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    rlc = [rng.randrange(1, 1 << 64) for _ in range(5)]
    u = list(jobs[0].u_by_validator)
    verify.reset_escapes()
    ok, comb = GpuTpkeVerifier(device=card).verify_and_combine(
        u, y_points, jobs[0].h, jobs[0].w, rlc, jobs[0].lagrange_row)
    assert ok and not any(verify.ESCAPES.values())
    assert tpke.decrypt_with_combined(cts[0], comb) == msgs[0]
    ok, comb = GpuTpkeVerifier(device=card).verify_and_combine(
        [u[0], u[0]], y_points[:2], jobs[0].h, jobs[0].w, rlc[:2], [7, 7])
    assert verify.ESCAPES["tpke_verifier"] == 1
    assert bls.g1_eq(comb, bls.g1_mul(u[0], 14))


# -- the mesh on one card: n copies of cuda:0 (parallel/mesh.py) ------------
# Every shard's kernels launch on the one card; the copies between devices
# are no-ops. The device guard of the kernel wrappers (ops/g1._run: each
# launch on its tensor's own device) cannot be shown wrong on a machine
# with one card: the tests of a mesh over distinct cards (`cards`, below)
# run only where there are several.


@pytest.mark.parametrize("n", [2, 8])
def test_mesh_era_on_card_equals_one_card(card, n):
    """MeshEraPipeline on the 2x1 and 4x2 meshes against GpuEraPipeline on
    the same era and rng (N=5: each slot padded to 8 lanes, 5 slots; a
    masked lane): equal rlc rows and points; the first era's launches those
    of its shards, a warm era one key pack a share block fewer; two eras in
    flight equal run_era's."""
    dealer, jobs, _, _ = _era(5, 1, 5, seed=71)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    masks = [[True] * 5 for _ in slots]
    masks[2][4] = False
    pipe = MeshEraPipeline(devices=[torch.device("cuda", 0)] * n)
    n_slot, n_share = pipe.mesh.devices.shape
    shards = n_slot * n_share
    want = GpuEraPipeline(device=card).run_era(slots, y_points, SeededRng(3), masks)
    for first in (True, False):
        g1.reset_launches()
        verify.reset_escapes()
        got = pipe.run_era(slots, y_points, SeededRng(3), masks)
        _assert_eras_equal([got], [want])
        assert not any(verify.ESCAPES.values())
        assert g1.LAUNCHES == dict(
            dict.fromkeys(g1.LAUNCHES, 0), g1_table=shards, g1_msm_scan=shards,
            g1_add=shards * (8 // n_share).bit_length() - shards
            + n_slot * (n_share.bit_length() - 1),
            g1_mont=2 * shards + 1 + (n_share if first else 0))
    rng = SeededRng(3)
    firsts = [pipe.dispatch_era(slots, y_points, rng, masks) for _ in range(2)]
    rng = SeededRng(3)
    seq = [GpuEraPipeline(device=card).run_era(slots, y_points, rng, masks)
           for _ in range(2)]
    _assert_eras_equal([d() for d in firsts], seq)
    assert pipe.last_timings["device_s"] > 0 and pipe.calls == 4


def test_mesh_backend_on_card(card):
    dealer, jobs, cts, msgs = _era(5, 1, 3, seed=73)
    backend = GpuBackend(device=card, pipeline=MeshEraPipeline(
        devices=[torch.device("cuda", 0)] * 4))
    res = backend.tpke_era_verify_combine(jobs, dealer.verification_keys, SeededRng(9))
    assert all(ok for ok, _ in res)
    for s in range(3):
        assert tpke.decrypt_with_combined(cts[s], res[s][1]) == msgs[s]


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_msms_on_card_equal_one_card(card, shards):
    rng = random.Random(0x5A + shards)
    pts = _points(rng, 37)
    pts[5] = bls.G1_INF
    q2 = _g2_points(rng, 9)
    sc = [rng.randrange(bls.R) for _ in range(37)]
    bits = torch.from_numpy(curve.scalars_to_bits(sc, 256)).to(card)
    mesh = make_mesh([torch.device("cuda", 0)] * shards)
    for (pack, one, sharded, unpack, eq, p) in (
            (g1.g1_pack, curve.g1_msm, sharded_g1_msm, g1.g1_unpack_host, bls.g1_eq, pts),
            (g2.g2_pack, curve.g2_msm, sharded_g2_msm, g2.g2_unpack_host, bls.g2_eq, q2)):
        packed, b = pack(p, card), bits[: len(p)]
        got = [unpack(*g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None]), False)[0]
               for pt, fl in (sharded(mesh)(packed, b), one(packed, b))]
        assert eq(got[0], got[1])


def test_rbc_flush_on_card_mesh_equals_one_card(card):
    """An N=64 era's flush on a 2-shard mesh of the card: 6 launches (a
    block of each product a shard), the one-card flush's verdicts and
    encode."""
    rng = random.Random(64)
    n, k, size = 64, 22, 2871
    own = rng.randbytes(size)
    slots = []
    for s in range(6):
        shards = list(rs_batch.encode(rng.randbytes(size), k, n, device="numpy"))
        root = hashes.merkle_root(hashes.keccak256_batch(shards))
        for i in rng.sample(range(n), rng.randint(0, n - k)):
            shards[i] = None
        slots.append((shards, root))
    out = []
    for mesh in (make_mesh([card]), make_mesh([torch.device("cuda", 0)] * 2)):
        batcher = RbcEraBatcher(device="cuda", mesh=mesh)
        enc, verdicts = [], {}
        batcher.submit_encode(0, own, k, n, enc.append)
        for s, (shards, root) in enumerate(slots):
            batcher.submit_interpolate(0, shards, k, n, root,
                                       lambda v, s=s: verdicts.__setitem__(s, v))
        rs_batch.reset_launches()
        batcher.flush()
        out.append((enc, verdicts, rs_batch.LAUNCHES["rs_matmul8"]))
    assert out[0][:2] == out[1][:2] and (out[0][2], out[1][2]) == (3, 6)
    for s, (shards, root) in enumerate(slots):
        assert out[1][1][s] == scalar_verdict(shards, k, root)


# -- the mesh over distinct cards ---------------------------------------------


@pytest.fixture
def cards():
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more cards: a mesh over distinct cards")
    return [torch.device("cuda", i) for i in range(count)]


def _kernels_by_card(run) -> dict:
    """run() under torch.profiler -> {(kernel, card index): launches} of the
    traced kernels (chip_smoke.kernel_of's names). As in chip_smoke's
    profile_device, run() goes twice under the warm-up steps and once
    under the active step, each padded by idle host time: a trace drops
    launches near the edges of its window."""
    import time

    import chip_smoke
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1),
                 on_trace_ready=lambda p: traced.append(p.events())) as prof:
        for _ in range(3):
            time.sleep(chip_smoke.TRACE_PAD_S)
            run()
            torch.cuda.synchronize()
            time.sleep(chip_smoke.TRACE_PAD_S)
            prof.step()
    out: dict = {}
    for ev in traced[0]:
        name = chip_smoke.kernel_of(ev.name)
        if ev.device_type == torch.autograd.DeviceType.CUDA and name != "torch":
            out[(name, ev.device_index)] = out.get((name, ev.device_index), 0) + 1
    return out


def test_mesh_over_distinct_cards_equals_one_card(cards):
    """MeshEraPipeline over every card (2x1 over two, 2x2 over four ...)
    against GpuEraPipeline on cuda:0 on the same era and rng, once cold and
    once warm, then two eras in flight: equal rlc rows and points, no host
    recompute. Each shard's table build and scan are traced on its own card
    (the kernel wrappers' device guard); the sharded MSMs over the cards and
    an RBC flush over them equal the one-card results, and GpuBackend /
    RbcEraBatcher on the last card default to a mesh over every card that
    starts there."""
    dealer, jobs, _, _ = _era(5, 1, 5, seed=79)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    masks = [[True] * 5 for _ in slots]
    masks[2][4] = False
    pipe = MeshEraPipeline(devices=cards)
    assert pipe.mesh.distinct() == cards
    want = GpuEraPipeline(device=cards[0]).run_era(slots, y_points, SeededRng(5), masks)
    verify.reset_escapes()
    _assert_eras_equal([pipe.run_era(slots, y_points, SeededRng(5), masks)], [want])
    traced = _kernels_by_card(lambda: _assert_eras_equal(
        [pipe.run_era(slots, y_points, SeededRng(5), masks)], [want]))
    for i in range(len(cards)):  # one shard a card
        for kernel in ("msm_scan_kernel", "g1_table_kernel"):
            assert traced.get((kernel, i), 0) >= 1, traced
    rng = SeededRng(6)
    firsts = [pipe.dispatch_era(slots, y_points, rng, masks) for _ in range(2)]
    rng = SeededRng(6)
    seq = [GpuEraPipeline(device=cards[0]).run_era(slots, y_points, rng, masks)
           for _ in range(2)]
    _assert_eras_equal([d() for d in firsts], seq)
    assert not any(verify.ESCAPES.values())

    rng = random.Random(0x5D)
    pts = _points(rng, 37)
    pts[5] = bls.G1_INF
    sc = [rng.randrange(bls.R) for _ in range(37)]
    bits = torch.from_numpy(curve.scalars_to_bits(sc, 256)).to(cards[0])
    packed = g1.g1_pack(pts, cards[0])
    got = [g1.g1_unpack_host(*g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None]),
                             False)[0]
           for pt, fl in (sharded_g1_msm(make_mesh(cards))(packed, bits),
                          curve.g1_msm(packed, bits))]
    assert bls.g1_eq(got[0], got[1])

    last = cards[-1]
    assert GpuBackend(device=last)._pipeline.mesh.distinct() == cards[-1:] + cards[:-1]
    assert RbcEraBatcher(device=last).mesh.shape == {"shares": len(cards)}
    assert list(RbcEraBatcher(device=last).mesh.devices.flat)[0] == last
    k, n = 22, 64
    own = rng.randbytes(2871)
    out = []
    for mesh in (make_mesh(cards[:1]), make_mesh(cards)):
        batcher = RbcEraBatcher(device=cards[0], mesh=mesh)
        enc = []
        batcher.submit_encode(0, own, k, n, enc.append)
        rs_batch.reset_launches()
        batcher.flush()
        out.append((enc, rs_batch.LAUNCHES["rs_matmul8"]))
    assert out[0][0] == out[1][0] == [rs.encode(own, k, n)]
    assert (out[0][1], out[1][1]) == (1, len(cards))


def test_chip_smoke_card_paths(cards):
    """chip_smoke.py's paths over distinct cards (mesh_era_cards,
    rbc_flush_cards), which a one-card machine does not run, with their
    checks, beside the one-card tpke_era backend they are held against."""
    import chip_smoke

    era = chip_smoke.make_era(chip_smoke.N_VALIDATORS, 1)
    backend = chip_smoke.one_card_backend(cards[0])
    backend.tpke_era_verify_combine(era[3], era[0].verification_keys, SeededRng(1))
    launches, warm = chip_smoke.run_mesh_path(1, backend, cards[0], era, cards, cards)
    assert launches["g1_msm_scan"] == len(cards) and warm
    launches, warm = chip_smoke.run_rbc_mesh_path(1, cards[0], cards)
    assert launches["rs_matmul8"] == launches["rs_matmul16"] == 3 * len(cards)


def test_honey_badger_era_on_card_equals_plain_versions(card):
    """chip_smoke.py's root_era_16_check: the N=16, f=5 era (HoneyBadger
    under RootProtocol, 8 signed transfers a validator) in TAKE_RANDOM with
    router 0's decryption shares corrupted, both batchers on, on the card
    and with device="cpu" (the era on the host pipeline, the RBC flush and
    the block recovery on the kernels' plain versions): equal blocks at
    every honest router, equal delivered_count and flush counts, and the
    same evidence (exactly router 0, invalid_share, "dec"); the card's run
    launches the G1 era kernels, rs_matmul8 and the block recovery's secp
    kernels."""
    import chip_smoke

    launches, _warm = chip_smoke.run_root_check_path(1, card)
    for kernel in ("g1_table", "g1_msm_scan", "g1_add", "g1_mont", "rs_matmul8",
                   "secp_sqrt", "secp_table", "secp_msm_scan", "secp_add", "secp_mont"):
        assert launches[kernel] >= 1, launches
    assert not any(verify.ESCAPES.values())


def test_native_honey_badger_era_on_card_equals_plain_versions(card):
    """A HoneyBadger era at (7, 2) through the native consensus engine
    (consensus/native_rt.NativeSimulatedNetwork, TAKE_RANDOM with
    duplicates, both batchers) on the card and with device="cpu" (the
    kernels' plain versions): equal results and delivered_count, every
    slot its proposer's input, no per-message crossing; the card's run
    launches the G1 era kernels and rs_matmul8."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork
    from lachain_tpu_torch.consensus.simulator import DeliveryMode
    from lachain_tpu_torch.consensus.simulator import SeededRng as NetRng

    pub, privs = trusted_key_gen(7, 2, NetRng(0x7002))
    inputs = [b"native|%d|" % i + bytes(48) for i in range(7)]
    pid = M.HoneyBadgerId(era=0)
    outs = []
    verify.reset_escapes()
    for device in (card, "cpu"):
        g1.reset_launches()
        rs_batch.reset_launches()
        net = NativeSimulatedNetwork(pub, privs, seed=19, mode=DeliveryMode.TAKE_RANDOM,
                                     repeat_probability=0.05, use_rbc_batcher=True,
                                     device=device)
        for i, value in enumerate(inputs):
            net.post_request(i, pid, value)
        assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
        results = net.results(pid)
        assert all(pt == inputs[j] for j, pt in results[0].items()) and len(results[0]) >= 5
        c = net.crossings
        assert c["opaque_message"] == c["acs_result"] == c["coin_request"] == 0
        if device is card:
            for kernel in ("g1_table", "g1_msm_scan", "g1_add", "g1_mont"):
                assert g1.LAUNCHES[kernel] >= 1, g1.LAUNCHES
            assert rs_batch.LAUNCHES["rs_matmul8"] >= 1
        outs.append((results, net.delivered_count, net.crypto_batcher.flushes,
                     net.rbc_batcher.flushes))
        net.close()
    assert outs[0] == outs[1]
    assert not any(verify.ESCAPES.values())


@pytest.mark.parametrize("engine", ["python", "native"])
def test_equivocating_era_on_card_equals_plain_versions(card, engine):
    """A HoneyBadger era at (7, 2), TAKE_FIRST, both batchers, with
    validators 1 and 3 equivocating (consensus/adversary.py, installed
    before the first request), on the Python or the native engine, on the
    card and with device="cpu" (the kernels' plain versions): equal
    results, delivered_count, flush counts and evidence; every honest
    router convicts exactly 1 and 3 of equivocation; the card's run
    launches the G1 era kernels and rs_matmul8."""
    from lachain_tpu_torch.consensus import adversary
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork
    from lachain_tpu_torch.consensus.simulator import SeededRng as NetRng
    from lachain_tpu_torch.consensus.simulator import SimulatedNetwork

    pub, privs = trusted_key_gen(7, 2, NetRng(0x7003))
    inputs = [b"equivocate|%d|" % i + bytes(40) for i in range(7)]
    pid = M.HoneyBadgerId(era=0)
    honest = (0, 2, 4, 5, 6)
    cls = NativeSimulatedNetwork if engine == "native" else SimulatedNetwork
    outs = []
    verify.reset_escapes()
    for device in (card, "cpu"):
        g1.reset_launches()
        rs_batch.reset_launches()
        net = cls(pub, privs, seed=23, use_rbc_batcher=True, device=device)
        adversary.install(adversary.AdversaryPlan("equivocate", (1, 3), seed=5), net)
        for i, value in enumerate(inputs):
            net.post_request(i, pid, value)
        assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
        results = net.results(pid)
        assert all(pt == inputs[j] for j, pt in results[0].items()) and len(results[0]) >= 5
        evidence = [net.routers[i].evidence.record_set() for i in honest]
        assert all({(r.kind, r.offender) for r in ev} == {("equivocation", 1),
                                                          ("equivocation", 3)}
                   for ev in evidence)
        if device is card:
            for kernel in ("g1_table", "g1_msm_scan", "g1_add", "g1_mont"):
                assert g1.LAUNCHES[kernel] >= 1, g1.LAUNCHES
            assert rs_batch.LAUNCHES["rs_matmul8"] >= 1
        outs.append((results, net.delivered_count, net.crypto_batcher.flushes,
                     net.rbc_batcher.flushes, evidence))
        if engine == "native":
            net.close()
    assert outs[0] == outs[1]
    assert not any(verify.ESCAPES.values())


def test_native_crash_restart_on_card_equals_plain_versions(card):
    """A (7, 2) root era on the native engine (chip_smoke.py's root eras:
    TAKE_FIRST, both batchers, Root native over RootProducer, 2 signed
    transfers a validator) with a ConsensusJournal on MemoryKV a
    validator, stopped at 1,500 of its ~3,900 messages, then restarted on a
    fresh network of the same seed over the same stores, every router
    re-armed from its journal before its first request, run to the block;
    on the card and with device="cpu" (the kernels' plain versions), the
    engine in chunks of 256 messages: equal blocks, messages, crash points,
    replayed sends and journals, sends replayed at every router."""
    import chip_smoke
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import SeededRng as NetRng
    from lachain_tpu_torch.storage.kv import MemoryKV

    n, f, seed, chunk = 7, 2, 29, 256
    pub, privs = trusted_key_gen(n, f, NetRng(0x7004))
    rng = random.Random(0x7004)
    proposals, _signer = chip_smoke.root_transfers(n, 2, rng)
    parent = rng.randbytes(32)
    pid = M.RootProtocolId(era=0)
    outs = []
    verify.reset_escapes()
    for device in (card, "cpu"):
        chip_smoke.clear_block_memos()
        kvs = [MemoryKV() for _ in range(n)]
        net, _ = chip_smoke.journaled_native_net(pub, privs, proposals, device, parent,
                                                 seed, kvs)
        for i in range(n):
            net.post_request(i, pid, None)
        net.run(lambda: net.delivered_count >= 1500, chunk=chunk)
        assert all(r.result_of(pid) is None for r in net.routers)
        crashed = net.delivered_count
        net.close()
        chip_smoke.clear_block_memos()
        net, journals = chip_smoke.journaled_native_net(pub, privs, proposals, device,
                                                        parent, seed, kvs)
        chip_smoke.rearm(net, journals)
        for i in range(n):
            net.post_request(i, pid, None)
        assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers),
                       chunk=chunk)
        replayed = [r.replayed_sends for r in net.routers]
        assert all(replayed)
        outs.append(([r.result_of(pid).encode() for r in net.routers], net.delivered_count,
                     crashed, replayed, [list(kv.scan_prefix(b"")) for kv in kvs]))
        net.close()
    assert outs[0] == outs[1]
    assert not any(verify.ESCAPES.values())


@pytest.mark.parametrize("groups,size", [(22, 22), (1, 143), (3, 5)])
def test_g1_msm_batch_on_card_equals_plain_version(card, groups, size):
    """GpuBackend.g1_msm_batch at the DKG phase's shapes (a row check's 22
    groups padded to 32 lanes, a value check's 143 distinct coefficients
    padded to 256) and a small ragged one, against the plain
    versions (device="cpu") and the native host group by group: one table
    build, one scan, log2(k) tree adds and 2 g1_mont, no escape. A few
    groups carry an infinity input and zero scalars."""
    from lachain_tpu_torch.crypto.native_backend import NativeBackend

    rng = random.Random(0xD6 + groups)
    native = NativeBackend()
    pts = native.g1_mul_batch([bls.G1_GEN] * size, [rng.randrange(1, bls.R)
                                                    for _ in range(size)])
    point_lists, scalar_lists = [], []
    for g in range(groups):
        lst = pts[g % size:] + pts[:g % size]
        ss = [rng.randrange(bls.R) for _ in range(size)]
        if g % 7 == 1:
            lst = [bls.G1_INF] + lst[1:]
            ss = [ss[0], 0, 0] + ss[3:]
        if g == 2:
            lst = lst[:3]
            ss = ss[:3]
        point_lists.append(lst)
        scalar_lists.append(ss)
    k = 1 << (max(len(p) for p in point_lists) - 1).bit_length()
    verify.reset_escapes()
    g1.reset_launches()
    got = GpuBackend(device=card).g1_msm_batch(point_lists, scalar_lists)
    want = dict(g1_table=1, g1_msm_scan=1, g1_add=k.bit_length() - 1, g1_mont=2,
                g1_dbl=0, fp_mul=0)
    assert {name: g1.LAUNCHES[name] for name in want} == want
    plain = GpuBackend(device="cpu").g1_msm_batch(point_lists, scalar_lists)
    host = native.g1_msm_batch(point_lists, scalar_lists)
    assert len(got) == groups
    assert all(bls.g1_eq(a, b) and bls.g1_eq(a, c) for a, b, c in zip(got, plain, host))
    assert not any(verify.ESCAPES.values())


def test_dkg_fleet_on_card_equals_native_fleet(card):
    """A (7, 2) DKG fleet (consensus/keygen.py) on one GpuBackend on the
    card against the same seeds on NativeBackend: every node's snapshot
    after every dealer's round and every keyring equal, the G1 kernels
    launched, no escape."""
    from lachain_tpu_torch.consensus import keygen as kg
    from lachain_tpu_torch.crypto.native_backend import NativeBackend

    n, f, seed = 7, 2, 42
    rng = SeededRng(seed)
    privs = [ecdsa.generate_private_key(rng) for _ in range(n)]
    pubs = [ecdsa.public_key_bytes(p) for p in privs]
    outs = []
    verify.reset_escapes()
    g1.reset_launches()
    for backend in (GpuBackend(device=card, pipeline=GpuEraPipeline(device=card)),
                    NativeBackend()):
        nodes = [kg.TrustlessKeygen(privs[i], pubs, f, 0, SeededRng(seed + i), backend)
                 for i in range(n)]
        commits = [node.start_keygen() for node in nodes]
        snaps = []
        for dealer, commit in enumerate(commits):
            values = [(i, node.handle_commit(dealer, commit)) for i, node in enumerate(nodes)]
            for sender, vmsg in values:
                for node in nodes:
                    node.handle_send_value(sender, vmsg)
            snaps.append([node.to_bytes() for node in nodes])
        rings = [node.try_get_keys() for node in nodes]
        outs.append((snaps, [(r.public_key_hash, r.tpke_priv.to_bytes()) for r in rings]))
        if isinstance(backend, GpuBackend):
            launched = dict(g1.LAUNCHES)
    assert outs[0] == outs[1]
    assert all(launched[k] for k in ("g1_table", "g1_msm_scan", "g1_add", "g1_mont"))
    assert not any(verify.ESCAPES.values())


def test_state_commit_senders_on_card(card, tmp_path):
    """chip_smoke.py's state_commit harness at 3,000 accounts and two
    blocks of 1,000 transfers: each block's senders recovered on the card
    (exactly recover_launches(1,000) a block, no escape) are the signing
    keys' addresses, and the commits on LsmKV give the roots of the same
    blocks committed on MemoryKV with the senders the host library
    recovers; a quick fsck is clean after each."""
    import chip_smoke
    from lachain_tpu_torch.core import types
    from lachain_tpu_torch.storage.fsck import fsck
    from lachain_tpu_torch.storage.kv import MemoryKV
    from lachain_tpu_torch.storage.lsm import LsmKV
    from lachain_tpu_torch.storage.state import StateManager

    inp = chip_smoke.state_inputs(3, 3000, 64, 2, 1000)
    kv, ref = LsmKV(str(tmp_path / "db")), MemoryKV()
    sm, ref_sm = StateManager(kv), StateManager(ref)
    sm.stream_threshold = 512
    balances, ref_balances = dict(inp["balances"]), dict(inp["balances"])
    block, _ = chip_smoke.commit_block(sm, kv, 0, types.ZERO_HASH, [],
                                       chip_smoke.genesis_writes(balances))
    chip_smoke.commit_block(ref_sm, ref, 0, types.ZERO_HASH, [],
                            chip_smoke.genesis_writes(ref_balances))
    chain = chip_smoke.ROOT_CHAIN_ID
    for height, stxs in enumerate(inp["blocks"], start=1):
        types._SENDER_MEMO.clear()
        secp.reset_launches()
        verify.reset_escapes()
        types.warm_sender_caches(stxs, chain, device=card)
        want = {k: v for k, v in chip_smoke.recover_launches(1000).items() if k in secp.LAUNCHES}
        assert dict(secp.LAUNCHES) == want and not any(verify.ESCAPES.values())
        senders = [stx.sender(chain) for stx in stxs]
        assert senders == [inp["addrs"][(t + (height - 1) * 1000) % 64] for t in range(1000)]
        plain = [types.SignedTransaction.decode(stx.encode()) for stx in stxs]
        types._SENDER_MEMO.clear()
        parent = block.hash()
        block, roots = chip_smoke.commit_block(sm, kv, height, parent, stxs,
                                               chip_smoke.transfer_writes(balances, stxs))
        _, ref_roots = chip_smoke.commit_block(ref_sm, ref, height, parent, plain,
                                               chip_smoke.transfer_writes(ref_balances, plain))
        assert roots == ref_roots and sm.commit_stats["streamed_batches"] > 0
        assert fsck(kv, repair=False).clean
    kv.close()


def test_block_exec_senders_on_card(card, monkeypatch):
    """chip_smoke.py's state_commit_1m and block_exec_1m at 3,000 accounts:
    blocks 3-6 (200 transfers, deploys and system calls, contract calls)
    produced by the port's BlockProducer over a BlockManager on the card:
    every ingest recovers its block's senders on the card in exactly
    recover_launches(n) launches, production launches nothing (the
    path's own checks), and the path's launches are the ingests' sums."""
    import chip_smoke
    from lachain_tpu_torch.storage.state import StateManager

    for name, value in dict(STATE_ACCOUNTS=3000, STATE_SENDERS=64, STATE_TXS=200,
                            STATE_SAMPLES=100, EXEC_TXS=200, EXEC_OVERDRAWN=4,
                            EXEC_TOKEN_CALLS=8, EXEC_VALIDATORS=4, EXEC_COUNTERS=4,
                            EXEC_PROXIED=16, EXEC_SAMPLES=20).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(StateManager, "stream_threshold", 64)
    keep = {}
    try:
        chip_smoke.run_state_path(4, card, keep)
        launches, walls = chip_smoke.run_exec_path(4, card, keep)
    finally:
        import shutil

        shutil.rmtree(keep["dir"], ignore_errors=True)
    sizes = [200, 200, 4 + 1 + 8 + 2 * 4, 64 * 2]
    want = {k: sum(chip_smoke.recover_launches(n)[k] for n in sizes) for k in launches}
    assert launches == want
    assert len(walls) == 4 and not any(verify.ESCAPES.values())
