"""The port's span recorder (`lachain_tpu_torch/utils/tracing.py`), on the CPU.

The cases of tests/test_tracing.py against the port's modules: span
nesting and the open-span stack, annotations and instants, the Chrome
export's lanes, the ring's eviction, and the consensus integration through
the port's `SimulatedNetwork` with `device="cpu"`: protocol lifetimes, the
TPKE flush spans with their slot and pad-waste attributes, a stuck
protocol named in the stall stack, and the era GC closing abandoned spans.

One case more holds the two packages together: the same seeded (4, 1)
TAKE_FIRST HoneyBadger era on each gives the same multiset of finished
spans' (name, cat, era) and the same value of every counter both
packages mint. The port's backend mints the device backend's
`crypto_tpu_*` counters as well, which the JAX package's host backend does
not; they are held to the port's own era-call count instead.

The port's eras run the TPKE era on the host pipeline
(`GpuBackend(device="cpu", pipeline=HostEraPipeline(native))`), as in
tests/test_torch_consensus.py. Every case resets both packages'
registries.
"""
from __future__ import annotations

import json
from collections import Counter

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.utils import metrics as jmetrics
from lachain_tpu.utils import tracing as jtracing
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.utils import metrics, tracing
from tests.test_torch_consensus import drive, jax_net, port_net

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    for m, t in ((metrics, tracing), (jmetrics, jtracing)):
        t.reset_for_tests()
        m.reset_all_for_tests()
    yield
    for m, t in ((metrics, tracing), (jmetrics, jtracing)):
        t.reset_for_tests()
        m.reset_all_for_tests()


def test_span_nesting_and_open_stack():
    sid_era = tracing.begin("era", era=3)
    with tracing.span("HoneyBadger", cat="protocol", era=3):
        assert tracing.open_stack_str() == "era(era=3) > HoneyBadger(era=3)"
        opened = tracing.open_spans()
        assert [s["name"] for s in opened] == ["era", "HoneyBadger"]
        assert all(s["open"] for s in opened)
    assert tracing.open_stack_str() == "era(era=3)"
    tracing.end(sid_era, outcome="consensus")
    assert tracing.open_stack_str() == "<no open spans>"
    # end() is idempotent: a second close must not resurrect or duplicate
    tracing.end(sid_era)
    assert len(tracing.snapshot()) == 2


def test_annotate_and_instant():
    sid = tracing.begin("tpke.flush", cat="crypto")
    tracing.annotate(sid, slots=12)
    tracing.end(sid, pad_waste=0.25)
    tracing.instant("block_persisted", cat="block", height=7)
    spans = tracing.snapshot()
    flush = next(s for s in spans if s["name"] == "tpke.flush")
    assert flush["args"] == {"slots": 12, "pad_waste": 0.25}
    blk = next(s for s in spans if s["name"] == "block_persisted")
    assert blk["args"]["height"] == 7
    assert blk["start"] == blk["end"]


def test_chrome_trace_export_overlapping_lanes():
    a = tracing.begin("era", era=1)
    b = tracing.begin("ReliableBroadcast", cat="protocol", era=1)
    tracing.end(b)
    tracing.end(a)
    out = tracing.to_chrome_trace()
    assert out["displayTimeUnit"] == "ms"
    events = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert len(events) == 2
    for ev in events:
        assert ev["ts"] >= 0 and ev["dur"] >= 0
    era_ev = next(e for e in events if e["name"] == "era")
    rbc_ev = next(e for e in events if e["name"] == "ReliableBroadcast")
    assert era_ev["tid"] != rbc_ev["tid"]
    names = {
        (m["pid"], m["tid"]): m["args"]["name"]
        for m in out["traceEvents"]
        if m["ph"] == "M" and m["name"] == "thread_name"
    }
    assert names[(era_ev["pid"], era_ev["tid"])] == "era"
    assert names[(rbc_ev["pid"], rbc_ev["tid"])] == "protocol"
    json.loads(json.dumps(out))


def test_chrome_trace_nesting_shares_lane_within_category():
    """Parent/child spans of one category stay on one row; overlapping
    siblings that do not nest fan out to numbered lanes."""
    parent = tracing.begin("HoneyBadger", cat="protocol", era=2)
    child = tracing.begin("ReliableBroadcast", cat="protocol", era=2)
    tracing.end(child)
    sibling = tracing.begin("BinaryAgreement", cat="protocol", era=2)
    tracing.end(parent)
    tracing.end(sibling)
    events = [e for e in tracing.to_chrome_trace()["traceEvents"] if e["ph"] == "X"]
    by_name = {e["name"]: e for e in events}
    assert by_name["HoneyBadger"]["tid"] == by_name["ReliableBroadcast"]["tid"]
    assert by_name["BinaryAgreement"]["tid"] != by_name["HoneyBadger"]["tid"]


def test_open_spans_exported_and_summary():
    sid = tracing.begin("era", era=9)
    out = tracing.to_chrome_trace()
    (ev,) = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert ev["args"]["open"] is True
    summ = tracing.summary()
    assert summ["era"]["count"] == 1
    assert summ["era"]["open"] == 1
    tracing.end(sid)


def test_ring_buffer_eviction():
    tracing.set_capacity(16)
    try:
        for i in range(100):
            tracing.instant("tick", i=i)
        spans = tracing.snapshot()
        assert len(spans) == 16
        assert spans[-1]["args"]["i"] == 99  # newest kept
        assert spans[0]["args"]["i"] == 84  # oldest evicted
    finally:
        tracing.set_capacity(tracing.DEFAULT_CAPACITY)


def _hb_inputs(n):
    return [b"payload|%d|" % i + bytes(16) for i in range(n)]


def _run_hb_sim(n=4, f=1, seed=11):
    net = port_net(n, f, seed)
    pid = M.HoneyBadgerId(era=0)
    done = drive(net, pid, _hb_inputs(n), range(n))
    assert done[0]
    return net, pid


def test_simulation_emits_protocol_and_flush_spans():
    """A HoneyBadger era's trace: sub-protocol lifetimes and the TPKE
    flush, with the slot count and the pad waste on each flush span."""
    _run_hb_sim()
    spans = tracing.snapshot()
    names = {s["name"] for s in spans}
    assert {"HoneyBadger", "ReliableBroadcast", "tpke.flush"} <= names
    flushes = [s for s in spans if s["name"] == "tpke.flush"]
    for fl in flushes:
        assert not fl["open"]
        assert fl["args"]["slots"] >= 1
        assert fl["args"]["slots_padded"] >= fl["args"]["slots"]
        assert 0.0 <= fl["args"]["pad_waste"] < 1.0
    hb = [s for s in spans if s["name"] == "HoneyBadger" and not s["open"]]
    assert hb and all(s["args"]["outcome"] == "done" for s in hb)
    assert metrics.histogram_snapshot(
        "consensus_protocol_duration_seconds", labels={"protocol": "HoneyBadger"}
    )["count"] >= 4
    assert metrics.histogram_snapshot("tpke_flush_slots")["count"] >= 1
    out = tracing.to_chrome_trace()
    json.loads(json.dumps(out))
    assert any(e["name"] == "tpke.flush" for e in out["traceEvents"])


def test_watchdog_stack_names_stuck_protocol():
    """A protocol created but never finished keeps its span open, so the
    stall report's open-span stack names it."""
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import SeededRng, SimulatedNetwork
    from tests.test_torch_consensus import host_backend
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.ops.verify import HostEraPipeline

    host = host_backend()
    backend = GpuBackend(device="cpu", host_backend=host, pipeline=HostEraPipeline(host))
    pub, privs = trusted_key_gen(4, 1, SeededRng(3))
    net = SimulatedNetwork(pub, privs, era=1, seed=4, device="cpu", backend=backend)
    pid = M.BinaryAgreementId(era=1, agreement=0)
    net.post_request(0, pid, True)  # one input only: BA cannot decide
    net.run(lambda: False, max_messages=500)
    stack = tracing.open_stack_str()
    assert "BinaryAgreement" in stack
    assert "era=1" in stack


def test_era_gc_closes_abandoned_spans():
    net, _pid = _run_hb_sim()
    before_open = [s["name"] for s in tracing.open_spans()]
    # the GC keeps the last active era's instances; a second advance
    # pushes era 0 past the cutoff
    for r in net.routers:
        r.advance_era(5)
        r.advance_era(6)
    after = tracing.open_spans()
    assert [s for s in after if s["args"].get("era") == 0] == []
    gc_closed = [s for s in tracing.snapshot() if s["args"].get("outcome") == "era_gc"]
    if before_open:
        assert gc_closed


def _span_multiset(t):
    return Counter(
        (s["name"], s["cat"], s["args"].get("era"))
        for s in t.snapshot() if not s["open"]
    )


def _counters(m):
    m.render_text()  # folds MESSAGES_PROCESSED into its counter
    return dict(m._counters)


def test_era_spans_and_counters_equal_jax_package():
    """A seeded (4, 1) TAKE_FIRST HoneyBadger era on each package: the
    same finished spans by (name, cat, era), and the same counters."""
    inputs = _hb_inputs(4)
    jnet = jax_net(4, 1, 11)
    jout = drive(jnet, JM.HoneyBadgerId(era=0), inputs, range(4))
    net, _pid = _run_hb_sim()
    assert jout[0] and jout[1] == net.delivered_count
    spans, jspans = _span_multiset(tracing), _span_multiset(jtracing)
    assert spans and spans == jspans
    assert {"HoneyBadger", "tpke.flush", "wait.crypto_flush", "hb.apply_era_results"} <= {
        name for name, _cat, _era in spans}
    counters, jcounters = _counters(metrics), _counters(jmetrics)
    device = {k: v for k, v in counters.items() if k[0].startswith("crypto_tpu_")}
    assert {k: v for k, v in counters.items() if k not in device} == jcounters
    assert jcounters[("consensus_messages_processed", ())] > 0
    calls = net.backend.era_calls
    assert calls > 0
    assert device[("crypto_tpu_era_kernel_calls_total", ())] == calls
    assert device[("crypto_tpu_era_route_total", (("path", "device"),))] == calls


def _random_intervals(rng, n, kinds):
    out = []
    for _ in range(n):
        s = rng.choice([rng.uniform(-1.0, 11.0), float(rng.randrange(-1, 12))])
        out.append((rng.choice(kinds), s, s + rng.choice([0.0, rng.uniform(0, 4), 1.0])))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_sweeps_and_critical_path_equal_jax_package(seed):
    """The port's one-pass phase and wait sweeps and its critical-path walk
    give the reference's quadratic versions' results on random
    overlapping intervals (shared edges, empty and clipped intervals, an
    unknown wait resource included)."""
    import random

    rng = random.Random(seed)
    waits = list(tracing.WAIT_RESOURCES) + ["other", "misc"]
    for n in (0, 1, 7, 60):
        phase_iv = _random_intervals(rng, n, list(tracing.PHASES))
        wait_iv = _random_intervals(rng, n, waits)
        lo, hi = 0.0, 10.0
        assert tracing._sweep(phase_iv, lo, hi) == jtracing._sweep(phase_iv, lo, hi)
        assert (tracing._sweep_waits(phase_iv, wait_iv, lo, hi)
                == jtracing._sweep_waits(phase_iv, wait_iv, lo, hi))
        mixed = ([("phase", p, s, e) for p, s, e in phase_iv]
                 + [("wait", r, s, e) for r, s, e in wait_iv])
        rng.shuffle(mixed)
        assert tracing._critical_path(mixed, lo, hi) == jtracing._critical_path(mixed, lo, hi)
