"""The port's TPKE flush batcher vs the JAX package's, on the CPU.

* `consensus/crypto_batcher.TpkeEraBatcher` over `GpuBackend(device="cpu")`
  against the JAX package's `TpkeEraBatcher` over
  `TpuBackend(host_backend=PythonBackend())` (installed with `set_backend`
  and restored afterwards), on the same submissions of an era carried
  across by `convert`: jobs submitted twice by content, a lazy builder that
  returns None, one that returns work, and a submission tagged with another
  era, at `max_slots_per_call` 512 and 2 and at depth 1 and 2. The
  callback results in order, `flushes`, `slots_flushed`, `pending` and
  `pending_for` must be equal.
* Two key sets in one flush split into chunks at the boundary, each
  verified against its own keys; a re-submission from inside a callback
  joins the next flush; a dispatch that fails on the second chunk at depth
  2 raises out of `flush`, and the batcher flushes cleanly afterwards.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.consensus.crypto_batcher import TpkeEraBatcher as RefBatcher
from lachain_tpu.crypto import provider
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.crypto.tpu_backend import EraSlotJob as JaxEraSlotJob
from lachain_tpu.crypto.tpu_backend import TpuBackend
from lachain_tpu_torch.consensus.crypto_batcher import TpkeEraBatcher
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from tests.test_torch_era import SeededRng, _jax_era, _lagrange_row, _to_port

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

N, F = 4, 1


@pytest.fixture(scope="module")
def carried_era():
    """A 3-slot JAX era at (4, 1) with slot 1 poisoned, as JAX jobs and as
    the port's jobs (carried by `convert`)."""
    dealer, era = _jax_era(N, F, 3, seed=61)
    _pub, vks, _privs, port_era = _to_port(dealer, era)
    lag = _lagrange_row(N, list(range(F + 1)))
    jax_jobs, port_jobs = [], []
    for s, ((ct, decs, _), (pct, pdecs, _)) in enumerate(zip(era, port_era)):
        jrow = [d.ui for d in decs]
        prow = [d.ui for d in pdecs]
        if s == 1:
            jrow[0] = bls.g1_add(jrow[0], bls.G1_GEN)
            prow[0] = bls.g1_add(prow[0], bls.G1_GEN)
        jax_jobs.append(JaxEraSlotJob(jrow, list(lag), jtpke.ciphertext_h(ct), ct.w))
        port_jobs.append(EraSlotJob(prow, list(lag),
                                    tpke._hash_uv_to_g2(pct.u, pct.v), pct.w))
    return dealer.verification_keys, jax_jobs, vks, port_jobs


@pytest.fixture
def reference_backend():
    prev = provider._BACKEND
    provider.set_backend(TpuBackend(host_backend=PythonBackend()))
    try:
        yield
    finally:
        provider.set_backend(prev)


def _copy(job):
    """The same job content in new objects (dedupe is by content)."""
    return type(job)(list(job.u_by_validator), list(job.lagrange_row), job.h, job.w)


def _drive(batcher, jobs, vks):
    """One run of submissions and flushes -> (callback log, counters)."""
    log = []

    def cb(tag):
        return lambda res: log.append((tag, res))

    batcher.submit([jobs[0], jobs[1]], vks, cb("a"))
    batcher.submit([_copy(jobs[0])], vks, cb("dup"))
    batcher.submit([], vks, cb("empty"))  # nothing to queue
    batcher.submit_lazy(lambda: None)
    batcher.submit_lazy(lambda: ([jobs[2], _copy(jobs[1])], vks, cb("lazy")), era=5)
    batcher.submit([jobs[2]], vks, cb("era7"), era=7)
    counts = [batcher.pending, batcher.pending_for(5), batcher.pending_for(7),
              batcher.pending_for(None)]
    counts.append(batcher.flush(5))
    counts += [batcher.pending, batcher.pending_for(5), batcher.pending_for(7),
               batcher.flushes, batcher.slots_flushed]
    counts.append(batcher.flush())
    counts += [batcher.pending, batcher.flushes, batcher.slots_flushed,
               batcher.flush()]
    return log, counts


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("max_slots", [512, 2])
def test_batcher_equals_reference(carried_era, reference_backend, max_slots, depth):
    jax_vks, jax_jobs, vks, port_jobs = carried_era
    want_log, want_counts = _drive(RefBatcher(max_slots_per_call=max_slots),
                                   jax_jobs, jax_vks)
    backend = GpuBackend(device="cpu")
    batcher = TpkeEraBatcher(backend, SeededRng(3), max_slots_per_call=max_slots,
                             depth=depth)
    got_log, got_counts = _drive(batcher, port_jobs, vks)

    assert got_counts == want_counts
    # untagged submissions count for every era; era 5's flush completes 3
    # (the builder with no work completes none)
    assert want_counts[:5] == [5, 4, 4, 5, 3]
    assert [tag for tag, _ in got_log] == [tag for tag, _ in want_log] == [
        "a", "dup", "lazy", "era7"]
    for (_, got), (_, want) in zip(got_log, want_log):
        assert [ok for ok, _ in got] == [ok for ok, _ in want]
        for (ok, comb), (_, wcomb) in zip(got, want):
            assert (comb is None and wcomb is None) if not ok else bls.g1_eq(comb, wcomb)
    assert [ok for ok, _ in got_log[0][1]] == [True, False]
    # era 5's flush: 5 jobs, 3 distinct; then era 7's one job
    assert (batcher.deduped_slots, batcher.slots_flushed) == (2, 4)
    assert batcher.chunks == (2 if max_slots == 512 else 3)
    assert backend.era_calls == batcher.chunks
    chunk_keys = {"pack_s", "launch_s", "device_s", "wait_s", "fetch_s", "pairing_s"}
    assert all(set(c) == chunk_keys for c in batcher.last_timings["chunks"])


def _port_keys(seed, n_slots):
    """A port dealer's verification keys and n_slots (job, ciphertext,
    message) of its era."""
    dealer = tpke.TpkeTrustedKeyGen(N, F, SeededRng(seed))
    lag = _lagrange_row(N, list(range(F + 1)))
    out = []
    for s in range(n_slots):
        msg = bytes([seed + s]) * 32
        ct = dealer.pub.encrypt(msg, s, SeededRng(seed * 100 + s))
        row = [dealer.private_key(i).decrypt_share(ct, check=False).ui for i in range(N)]
        out.append((EraSlotJob(row, list(lag), tpke._hash_uv_to_g2(ct.u, ct.v), ct.w),
                    ct, msg))
    return dealer.verification_keys, out


@pytest.fixture(scope="module")
def two_key_sets():
    return _port_keys(7, 1), _port_keys(9, 1)


def test_two_key_sets_split_into_chunks(two_key_sets):
    (vks_a, [(job_a, ct_a, msg_a)]), (vks_b, [(job_b, ct_b, msg_b)]) = two_key_sets
    backend = GpuBackend(device="cpu")
    batcher = TpkeEraBatcher(backend, SeededRng(4))
    log = []
    batcher.submit([job_a], vks_a, log.append)
    batcher.submit([job_b], vks_b, log.append)
    batcher.submit([_copy(job_b)], vks_a, log.append)  # B's shares, A's keys
    assert batcher.flush() == 3
    # key sets A, B, A in flat order: three chunks, no dedupe across keys
    assert (batcher.chunks, batcher.deduped_slots, backend.era_calls) == (3, 0, 3)
    (ok_a, comb_a), = log[0]
    (ok_b, comb_b), = log[1]
    assert ok_a and ok_b and log[2] == [(False, None)]
    assert tpke.decrypt_with_combined(ct_a, comb_a) == msg_a
    assert tpke.decrypt_with_combined(ct_b, comb_b) == msg_b


def test_resubmission_from_a_callback_joins_the_next_flush(two_key_sets):
    (vks, [(job, ct, msg)]), _ = two_key_sets
    batcher = TpkeEraBatcher(GpuBackend(device="cpu"), SeededRng(5))
    log = []

    def first(res):
        log.append(res)
        batcher.submit([job], vks, log.append)

    batcher.submit([job], vks, first)
    assert batcher.flush() == 1
    assert (len(log), batcher.pending, batcher.flushes) == (1, 1, 1)
    assert batcher.flush() == 1
    assert (len(log), batcher.pending, batcher.flushes) == (2, 0, 2)
    assert log[0][0][0] and log[1][0][0]
    assert tpke.decrypt_with_combined(ct, log[1][0][1]) == msg


def test_failed_second_chunk_raises_and_the_next_flush_is_clean(two_key_sets):
    (vks_a, [(job_a, _, _)]), (vks_b, [(job_b, ct_b, msg_b)]) = two_key_sets
    backend = GpuBackend(device="cpu")
    batcher = TpkeEraBatcher(backend, SeededRng(6), depth=2)
    log = []
    ragged = EraSlotJob(job_b.u_by_validator[:-1], job_b.lagrange_row, job_b.h, job_b.w)
    batcher.submit([job_a], vks_a, log.append)
    batcher.submit([ragged], vks_b, log.append)
    with pytest.raises(ValueError, match="length"):
        batcher.flush()
    # the first chunk was finished before the error left flush: nothing is
    # in flight, nothing pending, no callback ran
    assert backend._pipeline._inflight == 0
    assert (batcher.pending, batcher.flushes, log) == (0, 0, [])
    assert backend.era_calls == 1

    batcher.submit([job_a], vks_a, log.append)
    batcher.submit([job_b], vks_b, log.append)
    assert batcher.flush() == 2
    assert [res[0][0] for res in log] == [True, True]
    assert tpke.decrypt_with_combined(ct_b, log[1][0][1]) == msg_b
    assert (batcher.flushes, batcher.chunks, backend.era_calls) == (1, 2, 3)


def test_depth_must_fit_the_backend():
    backend = GpuBackend(device="cpu")
    assert TpkeEraBatcher(backend, SeededRng(1)).depth == backend.era_dispatch_depth
    for depth in (0, backend.era_dispatch_depth + 1):
        with pytest.raises(ValueError, match="depth"):
            TpkeEraBatcher(backend, SeededRng(1), depth=depth)
    with pytest.raises(ValueError, match="max_slots_per_call"):
        TpkeEraBatcher(backend, SeededRng(1), max_slots_per_call=0)
