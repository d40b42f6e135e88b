"""The port's transaction stage clock (`lachain_tpu_torch/utils/txtrace.py`).

The cases of tests/test_txtrace.py against the port's modules:
deterministic sampling by hash prefix, first-stamp-wins timelines, the
stage sum equal to the end-to-end span, the LRU bound, and the tracing
instant a stamp emits. The RPC case (`la_getTxTrace`) waits for the
port's node RPC. Every case resets the port's registries.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu_torch.utils import metrics, tracing, txtrace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    txtrace.reset_for_tests()
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()
    yield
    txtrace.reset_for_tests()
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()


def _h(i: int) -> bytes:
    return i.to_bytes(4, "big") + bytes(28)


def test_sampling_is_deterministic_and_shift_scaled():
    txtrace.set_sample_shift(2)  # keep 1-in-4
    verdicts = [txtrace.sampled(_h(i)) for i in range(4096)]
    # same hash -> same verdict, and the keep rate is the configured 1/4
    # exactly (the hash prefix IS the counter here)
    assert verdicts == [txtrace.sampled(_h(i)) for i in range(4096)]
    assert sum(verdicts) == 1024
    txtrace.set_sample_shift(0)
    assert all(txtrace.sampled(_h(i)) for i in range(64))


def test_unsampled_tx_never_tracked():
    txtrace.set_sample_shift(8)
    h = _h(1)  # low 8 bits of the first word are 0x...01 -> not sampled
    assert not txtrace.sampled(h)
    txtrace.stamp(h, "submit")
    assert txtrace.timeline(h) is None
    assert txtrace.tracked() == []


def test_timeline_monotonic_and_stage_sum_equals_e2e():
    txtrace.set_sample_shift(0)
    h = _h(7)
    for stage in txtrace.STAGES:
        txtrace.stamp(h, stage, era=3)
    tl = txtrace.timeline(h)
    assert tl is not None and tl["era"] == 3
    assert tl["traceId"] == h[:8].hex()
    assert [s["stage"] for s in tl["stages"]] == list(txtrace.STAGES)
    ats = [s["at_s"] for s in tl["stages"]]
    assert ats == sorted(ats) and ats[0] == 0.0
    # stage durations sum exactly to the end-to-end span (6dp rounding)
    assert sum(s["dur_s"] for s in tl["stages"]) == pytest.approx(
        tl["e2e_s"], abs=1e-5
    )
    # the histograms agree: one e2e observation, six stage observations
    e2e = metrics.histogram_snapshot("tx_e2e_seconds")
    assert e2e["count"] == 1
    total_stage = sum(
        metrics.histogram_snapshot(
            "tx_stage_seconds", labels={"stage": s}
        )["count"]
        for s in txtrace.STAGES
    )
    assert total_stage == len(txtrace.STAGES)


def test_first_stamp_wins_on_restamp():
    txtrace.set_sample_shift(0)
    h = _h(9)
    txtrace.stamp(h, "pool")
    tl1 = txtrace.timeline(h)
    # gossip re-admission / era replay re-stamps the same stage
    txtrace.stamp(h, "pool")
    txtrace.stamp_many([h], "pool")
    tl2 = txtrace.timeline(h)
    assert tl1["stages"] == tl2["stages"]


def test_lru_bound_evicts_oldest(monkeypatch):
    txtrace.set_sample_shift(0)
    monkeypatch.setattr(txtrace, "TRACE_LRU_CAPACITY", 8)
    hashes = [_h(i) for i in range(12)]
    for h in hashes:
        txtrace.stamp(h, "submit")
    assert len(txtrace.tracked()) == 8
    assert txtrace.timeline(hashes[0]) is None  # evicted
    assert txtrace.timeline(hashes[-1]) is not None


def test_stamp_emits_tracing_instant_with_trace_id():
    txtrace.set_sample_shift(0)
    h = _h(5)
    txtrace.stamp(h, "submit", era=2)
    spans = [d for d in tracing.snapshot() if d["name"] == "tx.submit"]
    assert spans and spans[-1]["args"]["trace"] == h[:8].hex()
    assert spans[-1]["cat"] == "tx"
