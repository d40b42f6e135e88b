"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel against its plain version (ops/g1_ref.py, ops/g2_ref.py,
ops/secp_ref.py) on the same values, exact equality of coordinates mod p
and of flags; the era pipelines, the backend and its MSM routes, and the
batched ECDSA recovery on the card against the host oracles. CUDA kernels have no CPU mode:
on a machine without a card these tests skip, and `python3 chip_smoke.py`
runs the same checks at the N=64 era's shapes on the card.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa, threshold_sig, tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import g1, g1_ref, g2, g2_ref, glv, secp, secp_ref, verify
from lachain_tpu_torch.ops.verify import (
    GpuEraPipeline,
    HostEraPipeline,
    TsGpuEraPipeline,
    TsHostEraPipeline,
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
    # the table build is one launch: no doubling of its own
    assert g1.LAUNCHES["g1_dbl"] == 0
    assert all(v > 0 for k, v in g1.LAUNCHES.items() if k != "g1_dbl")
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
    tree reduce (log2 K adds) per era, no doubling."""
    dealer, jobs, _, _ = _era(5, 1, 3, seed=47)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    g1.reset_launches()
    got, _ = GpuEraPipeline(device=card).run_era(slots, y_points, SeededRng(4))
    assert (g1.LAUNCHES["g1_msm_scan"], g1.LAUNCHES["g1_table"],
            g1.LAUNCHES["g1_dbl"], g1.LAUNCHES["g1_add"]) == (1, 1, 0, 3)  # K = 5 -> 8 lanes a slot
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
    assert secp.fe_decode(secp.sqrt(kx)) == secp_ref.limbs_to_ints(
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
    assert secp.LAUNCHES["secp_dbl"] == 0  # the table build is one launch
    assert all(v > 0 for k, v in secp.LAUNCHES.items() if k != "secp_dbl")


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
    doubling."""
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
    want, _ = TsHostEraPipeline().run_era(coins, y_points, SeededRng(7), masks=masks)
    for g, w in zip(got, want):
        assert bls.g2_eq(g[0], w[0]) and bls.g1_eq(g[1], w[1])
        assert bls.g2_eq(g[2], w[2])


def test_recover_path_launch_counts(card):
    """10,000 signatures (three 4096-signature chunks): one square root and
    per chunk 1 table build, 1 scan and 1 pair add (no doubling), 8
    Montgomery conversions; every sender recovered."""
    import chip_smoke

    pubs, hashes, sigs, owner = chip_smoke.make_signatures(
        10000, 16, random.Random(0x5EC9))
    secp.reset_launches()
    verify.reset_escapes()
    got = ecdsa.recover_hash_batch(hashes, sigs, device="cuda")
    assert secp.LAUNCHES == {"secp_fp_mul": 8, "secp_dbl": 0, "secp_add": 3,
                             "secp_table": 3, "secp_msm_scan": 3, "secp_sqrt": 1}
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
