"""The port's CUDA kernels on the card (skipped where there is none).

Each kernel against its plain version (ops/g1_ref.py) on the same values,
exact equality of coordinates mod p and of flags; the era pipeline and the
backend on the card against the host oracle. CUDA kernels have no CPU mode:
on a machine without a card these tests skip, and `python3 chip_smoke.py`
runs the same checks at the N=64 era's shapes on the card.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.ops import g1, g1_ref, glv
from lachain_tpu_torch.ops.verify import GpuEraPipeline, HostEraPipeline

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
    assert all(v > 0 for v in g1.LAUNCHES.values())
    assert [ok for ok, _ in res] == [True, True, False]
    for s in (0, 1):
        assert tpke.decrypt_with_combined(cts[s], res[s][1]) == msgs[s]
