"""The port's async era dispatch vs its synchronous era and the JAX package,
on the CPU.

* `GpuEraPipeline(device="cpu").dispatch_era(...)()` at (n, f) = (5, 1) and
  (7, 2) against `run_era` and the JAX package's `HostEraPipeline`: the
  same rlc lists, and equal points.
* Two dispatches in flight, finished in order, equal the synchronous calls,
  and a recording rng sees the same sequence of draws; a third dispatch
  while two are unfinished raises, and one after a finish is admitted.
* `GpuBackend(device="cpu").tpke_era_verify_combine_async` against the JAX
  package's `TpuBackend(host_backend=PythonBackend())
  .tpke_era_verify_combine_async`, two eras in flight on each side, on eras
  carried across by `lachain_tpu_torch.convert` with one poisoned share.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.crypto.tpu_backend import EraSlotJob as JaxEraSlotJob
from lachain_tpu.crypto.tpu_backend import TpuBackend
from lachain_tpu.ops.verify import HostEraPipeline as JaxHostEraPipeline
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.ops import verify
from lachain_tpu_torch.ops.verify import GpuEraPipeline
from tests.test_torch_era import SeededRng, _jax_era, _lagrange_row, _to_port

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


class RecordingRng(SeededRng):
    """A SeededRng that records every draw."""

    def __init__(self, seed):
        super().__init__(seed)
        self.draws = []

    def randbelow(self, n):
        v = super().randbelow(n)
        self.draws.append(v)
        return v


def _slots(era, n, f, absent=()):
    """(slots, masks) of an era; `absent` lanes of slot 0 are masked."""
    slots, masks = [], []
    for s, (_ct, decs, _msg) in enumerate(era):
        mask = [not (s == 0 and i in absent) for i in range(n)]
        present = [i for i in range(n) if mask[i]]
        row = [d.ui if mask[i] else jbls.G1_INF for i, d in enumerate(decs)]
        slots.append((row, _lagrange_row(n, present[: f + 1])))
        masks.append(mask)
    return slots, masks


@pytest.mark.parametrize("n,f", [(5, 1), (7, 2)])
def test_dispatch_equals_run_era_and_jax_host_pipeline(n, f):
    dealer, era = _jax_era(n, f, 2, seed=13 * n)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots, masks = _slots(era, n, f, absent=(0, n - 1))
    pipe = GpuEraPipeline(device="cpu")
    verify.reset_escapes()
    got, got_rlc = pipe.dispatch_era(slots, y_points, SeededRng(3), masks=masks)()
    assert set(pipe.last_timings) == {"pack_s", "launch_s", "device_s", "wait_s", "fetch_s"}
    ran, ran_rlc = pipe.run_era(slots, y_points, SeededRng(3), masks=masks)
    want, want_rlc = JaxHostEraPipeline(PythonBackend()).run_era(
        slots, y_points, SeededRng(3), masks=masks
    )
    assert verify.ESCAPES["tpke_combine"] == 0
    assert got_rlc == ran_rlc == want_rlc
    assert got_rlc[0][0] == got_rlc[0][n - 1] == 0  # the masked lanes
    for g_slot, r_slot, w_slot in zip(got, ran, want):
        for g, r, w in zip(g_slot, r_slot, w_slot):
            assert bls.g1_eq(g, r) and bls.g1_eq(g, w)
    for s in range(2):
        ct = era[s][0]
        assert tpke.decrypt_with_combined(
            tpke.EncryptedShare(ct.u, ct.v, ct.w, s), got[s][2]) == era[s][2]


def test_two_in_flight_equal_the_synchronous_calls():
    n, f = 4, 1
    dealer, era = _jax_era(n, f, 3, seed=41)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots, masks = _slots(era, n, f, absent=(2,))
    eras = [([slots[0]], [masks[0]]), ([slots[1]], [masks[1]]), ([slots[2]], [masks[2]])]

    sync_rng = RecordingRng(9)
    sync_pipe = GpuEraPipeline(device="cpu")
    want = [sync_pipe.run_era(sl, y_points, sync_rng, masks=m) for sl, m in eras]

    rng = RecordingRng(9)
    pipe = GpuEraPipeline(device="cpu")
    assert pipe.MAX_INFLIGHT == 2
    first = pipe.dispatch_era(eras[0][0], y_points, rng, masks=eras[0][1])
    second = pipe.dispatch_era(eras[1][0], y_points, rng, masks=eras[1][1])
    with pytest.raises(RuntimeError, match="MAX_INFLIGHT"):
        pipe.dispatch_era(eras[2][0], y_points, rng, masks=eras[2][1])
    got = [first()]
    third = pipe.dispatch_era(eras[2][0], y_points, rng, masks=eras[2][1])
    got += [second(), third()]
    assert rng.draws == sync_rng.draws and len(rng.draws) == 3 * n
    assert first() is got[0]  # a finished dispatch returns its result again
    for (g_out, g_rlc), (w_out, w_rlc) in zip(got, want):
        assert g_rlc == w_rlc
        for g, w in zip(g_out[0], w_out[0]):
            assert bls.g1_eq(g, w)
    assert pipe._inflight == 0


def test_backend_async_vs_tpu_backend_async_with_poisoned_share():
    n, f = 4, 1
    dealer, era = _jax_era(n, f, 3, seed=53)
    _pub, vks, _privs, port_era = _to_port(dealer, era)
    bad_slot, bad_lane = 1, 2
    lag = _lagrange_row(n, list(range(f + 1)))
    jax_jobs, port_jobs = [], []
    for s, ((ct, decs, _), (pct, pdecs, _)) in enumerate(zip(era, port_era)):
        jrow = [d.ui for d in decs]
        prow = [d.ui for d in pdecs]
        if s == bad_slot:
            jrow[bad_lane] = jbls.g1_add(jrow[bad_lane], jbls.G1_GEN)
            prow[bad_lane] = bls.g1_add(prow[bad_lane], bls.G1_GEN)
        jax_jobs.append(JaxEraSlotJob(jrow, list(lag), jtpke.ciphertext_h(ct), ct.w))
        port_jobs.append(EraSlotJob(prow, list(lag),
                                    tpke._hash_uv_to_g2(pct.u, pct.v), pct.w))
    # two eras in flight on each side: slots [0, 1], then slot [2]
    cut = [(0, 2), (2, 3)]
    ref = TpuBackend(host_backend=PythonBackend())
    ref_rng = SeededRng(71)
    ref_fins = [ref.tpke_era_verify_combine_async(jax_jobs[a:b], dealer.verification_keys,
                                                  rng=ref_rng) for a, b in cut]
    want = [r for fin in ref_fins for r in fin()]

    backend = GpuBackend(device="cpu")
    assert backend.era_dispatch_depth == 2
    rng = SeededRng(71)
    fins = [backend.tpke_era_verify_combine_async(port_jobs[a:b], vks, rng)
            for a, b in cut]
    assert backend.era_calls == 0  # counted when finished, as the reference
    got = [r for fin in fins for r in fin()]
    assert (backend.era_calls, backend.era_slots_total) == (2, 3)
    assert set(backend.last_timings) == {"pack_s", "launch_s", "device_s", "wait_s",
                                         "fetch_s", "pairing_s"}
    assert backend.tpke_era_verify_combine_async([], vks, rng)() == []

    assert [ok for ok, _ in got] == [ok for ok, _ in want] == [True, False, True]
    for s, ((ok, comb), (_, wcomb)) in enumerate(zip(got, want)):
        if not ok:
            assert comb is None and wcomb is None
            continue
        assert bls.g1_eq(comb, wcomb)
        assert tpke.decrypt_with_combined(port_era[s][0], comb) == era[s][2]

