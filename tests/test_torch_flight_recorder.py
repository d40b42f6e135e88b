"""The native engines' flight recorders, bound in the port, on the CPU.

The cases of tests/test_flight_recorder.py (:79-:336) against the port's
native consensus engine (`consensus/native_rt.py`) and LsmKV
(`storage/lsm.py`): two identical seeded runs drain the same event
sequence (times apart), the native events fall inside the Python era span
that encloses them (the clock handshake), the merged Chrome export names
the native threads, the era report's phases and waits add up to the era
wall and its critical path tiles it, the starved dispatch loop's wait
records, the rings' drop counters, and the LSM engine's WAL events and
histograms. One case more holds the two packages' engines together: the
same seeded (4, 1) native era drains to the same multiset of decoded
events, times apart, from both.

The port's eras run the TPKE era on the host pipeline, as in
tests/test_torch_native_rt.py, whose private build of the JAX package's
engine (`jax_engine`) the cross-package case uses. Every case resets both
packages' registries.
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
from tests.test_torch_native_rt import jax_engine, jax_native, port_native  # noqa: F401

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


def _inputs(n=4):
    return [b"payload|%d|" % i + bytes(16) for i in range(n)]


def _drive(net, pid_cls, t, era_span, n=4):
    pid = pid_cls(era=0)

    def run():
        for i, value in enumerate(_inputs(n)):
            net.post_request(i, pid, value)
        assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))

    if era_span:
        with t.span("era", era=0):
            run()
    else:
        run()


def _run_native_hb(era_span: bool = True):
    """One seeded HoneyBadger era on the port's engine; the drained native
    events (the network is closed before the return)."""
    net = port_native(4, 1, 11)
    _drive(net, M.HoneyBadgerId, tracing, era_span)
    evs = tracing.native_snapshot()
    net.close()
    return evs


def _signature(evs):
    """Everything but the clock: the cumulative dispatch accumulators keep
    their phase and era but not their ns totals."""
    out = []
    for e in evs:
        args = {k: v for k, v in e["args"].items() if k != "dur_ns"}
        out.append((e["name"], e["cat"], e["tid"], tuple(sorted(args.items()))))
    return out


def test_native_drain_deterministic_across_identical_runs():
    first = _signature(_run_native_hb())
    tracing.reset_for_tests()
    second = _signature(_run_native_hb())
    assert first, "the native ring produced no events"
    assert first == second


def test_native_events_inside_enclosing_era_span():
    """After the clock handshake no native event lands outside the Python
    era span that encloses the whole run."""
    evs = _run_native_hb(era_span=True)
    era = next(s for s in tracing.snapshot() if s["name"] == "era")
    assert not era["open"]
    eps = 5e-3
    consensus = [e for e in evs if e["pid"] == 2]
    assert consensus
    for e in consensus:
        assert e["start"] >= era["start"] - eps, e
        assert e["end"] <= era["end"] + eps, e
        assert e["end"] >= e["start"]


def test_merged_chrome_trace_has_named_native_threads():
    _run_native_hb()
    out = tracing.to_chrome_trace()
    x = [e for e in out["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in out["traceEvents"] if e["ph"] == "M"]
    native = [e for e in x if e["pid"] == 2]
    assert native, "no native events in the merged export"
    assert any(e["pid"] == 1 for e in x), "python host lanes missing"
    procs = {m["pid"]: m["args"]["name"] for m in meta if m["name"] == "process_name"}
    assert procs.get(2) == "native-consensus"
    threads = {(m["pid"], m["tid"]): m["args"]["name"] for m in meta
               if m["name"] == "thread_name"}
    for e in native:
        assert (e["pid"], e["tid"]) in threads
    json.loads(json.dumps(out))


def test_era_report_phases_sum_to_wall_time():
    """Phases + idle add up to the era wall (<= 10% off) and the busy
    phases of a native run are non-zero."""
    _run_native_hb(era_span=True)
    report = tracing.era_report()
    assert [e["era"] for e in report["eras"]] == [0]
    ent = report["eras"][0]
    assert ent["wall_s"] > 0
    total = sum(ent["phases_s"].values()) + ent["idle_s"]
    assert abs(total - ent["wall_s"]) <= 0.10 * ent["wall_s"]
    # the share verification crosses into Python on every native run
    assert ent["phases_s"]["tpke_verify"] > 0
    # and the engine's dispatch accumulators give the rbc / ba split
    assert ent["phases_s"]["rbc"] > 0


def test_era_report_table_renders():
    _run_native_hb(era_span=True)
    lines = tracing.era_report_table().splitlines()
    assert len(lines) >= 3  # header, rule, one era row
    for col in ("era", "wall_s", "rbc", "tpke_verify", "idle_s"):
        assert col in lines[0]


def test_idle_decomposition_sums_to_old_idle():
    """Idle decomposes into named waits + idle_unattributed exactly, the
    whole adds up to the wall (<= 10%), and the recorder explains most of
    the idle."""
    _run_native_hb(era_span=True)
    ent = tracing.era_report()["eras"][0]
    assert set(ent["waits_s"]) == set(tracing.WAIT_RESOURCES)
    wsum = sum(ent["waits_s"].values())
    assert abs(wsum + ent["idle_unattributed_s"] - ent["idle_s"]) < 1e-4
    total = sum(ent["phases_s"].values()) + wsum + ent["idle_unattributed_s"]
    assert abs(total - ent["wall_s"]) <= 0.10 * ent["wall_s"]
    assert ent["idle_unattributed_s"] <= 0.20 * max(ent["idle_s"], 1e-9)
    assert ent["waits_s"]["crypto_flush"] > 0
    assert 0.0 <= ent["idle_unattributed_fraction"] <= 0.20


def _quiesce_net():
    """A seeded native network driven to quiescence: each further run()
    re-enters the starved dispatch loop and records one sched wait."""
    net = port_native(4, 1, 11)
    pid = M.HoneyBadgerId(era=0)
    for i, value in enumerate(_inputs()):
        net.post_request(i, pid, value)
    net.run(lambda: False)
    return net


def test_wait_record_drain_determinism():
    def one_run():
        net = _quiesce_net()
        for _ in range(3):
            net.run(lambda: False)
        evs = tracing.native_snapshot()
        net.close()
        waits = [e for e in evs if e["cat"] == "native.wait"]
        assert len(waits) >= 3
        for e in waits:
            assert e["name"] == "wait:sched"
            assert e["args"]["resource"] == "sched"
            assert e["tname"] == "dispatch"
        return _signature(waits)

    first = one_run()
    tracing.reset_for_tests()
    assert first == one_run()


def test_wait_records_covered_by_drop_counter():
    """Wait records ride the same bounded ring: overflowing it grows the
    native drop counter and never blocks."""
    net = _quiesce_net()
    net.trace_configure(2)
    for _ in range(10):
        net.run(lambda: False)
    tracing.drain_native()
    assert net.trace_dropped() > 0
    assert metrics.counter_value(
        "trace_events_dropped_total", labels={"source": "consensus"}) > 0
    assert any(e["name"] == "wait:sched" for e in tracing.native_snapshot())
    net.close()


def _syn_span(name, start, end, cat="era", **args):
    return {"id": 0, "name": name, "cat": cat, "start": float(start),
            "end": float(end), "open": False, "args": args}


def test_critical_path_on_synthetic_known_chain():
    """era [0, 10] = rbc [0, 4] -> crypto_flush wait [4, 7] -> device wait
    [6.5, 9] -> a 1 s gap: the walk recovers that chain, tiles the window,
    and the decomposition splits the waits at the device-priority overlap."""
    spans = [
        _syn_span("era", 0.0, 10.0, era=0),
        _syn_span("ReliableBroadcast", 0.0, 4.0, cat="protocol", era=0),
        _syn_span("wait.crypto_flush", 4.0, 7.0, cat="wait", resource="crypto_flush"),
        _syn_span("wait.device", 6.5, 9.0, cat="wait", resource="device"),
    ]
    ent = tracing.era_report(spans=spans, native=[])["eras"][0]
    assert ent["wall_s"] == pytest.approx(10.0)
    assert ent["phases_s"]["rbc"] == pytest.approx(4.0)
    assert ent["idle_s"] == pytest.approx(6.0)
    assert ent["waits_s"]["crypto_flush"] == pytest.approx(2.5)
    assert ent["waits_s"]["device"] == pytest.approx(2.5)
    assert ent["idle_unattributed_s"] == pytest.approx(1.0)
    assert ent["idle_unattributed_fraction"] == pytest.approx(1 / 6, abs=1e-3)
    cp = ent["critical_path"]
    assert cp["total_s"] == pytest.approx(ent["wall_s"])
    assert [(s["kind"], s["name"]) for s in cp["segments"]] == [
        ("phase", "rbc"), ("wait", "crypto_flush"), ("wait", "device"),
        ("gap", "unattributed"),
    ]
    assert [s["dur_s"] for s in cp["segments"]] == pytest.approx([4.0, 2.5, 2.5, 1.0])
    table = tracing.critical_path_table({"eras": [ent], "phases": list(tracing.PHASES)})
    assert "wait:crypto_flush" in table and "critical path 10.000s" in table


def test_trace_ring_drop_counter_python_source():
    tracing.set_capacity(8)
    try:
        for i in range(40):
            tracing.instant("tick", i=i)
    finally:
        tracing.set_capacity(tracing.DEFAULT_CAPACITY)
    assert metrics.counter_value(
        "trace_events_dropped_total", labels={"source": "python"}) == 32
    assert tracing.dropped_total() == 32


def test_lsm_flight_recorder_events_and_histograms(tmp_path):
    """The LSM engine's WAL group-commit size and fsync latency histograms,
    the compaction-backlog gauge, and its threads' events in the merged
    trace."""
    from lachain_tpu_torch.storage.lsm import LsmKV

    kv = LsmKV(str(tmp_path / "db"))
    try:
        for i in range(50):
            kv.write_batch([(b"k%04d" % i, b"v" * 64)])
        kv.flush()
        stats = kv.stats()
        assert "compact_backlog" in stats and "trace_dropped" in stats
        evs = tracing.native_snapshot()
        assert {"wal_encode", "wal_fsync", "memtable_seal"} <= {e["name"] for e in evs}
        fsync = next(e for e in evs if e["name"] == "wal_fsync")
        assert fsync["tname"] == "wal-writer"
        assert fsync["pid"] >= 3  # a process lane of its own
        assert metrics.histogram_snapshot("lsm_wal_fsync_seconds")["count"] > 0
        gc = metrics.histogram_snapshot("lsm_wal_group_commit_records")
        assert gc["count"] > 0 and gc["sum"] >= gc["count"]
        assert metrics.gauge_value("lsm_compaction_backlog") is not None
    finally:
        kv.close()
    # close() unregistered the source
    assert all(not s.startswith("lsm-") for s in tracing._native_sources)


def test_native_ring_capacity_and_drop_counter():
    net = port_native(4, 1, 11)
    net.trace_configure(4)  # a tiny ring: events must be dropped
    _drive(net, M.HoneyBadgerId, tracing, era_span=False)
    tracing.drain_native()
    assert net.trace_dropped() > 0
    assert metrics.counter_value(
        "trace_events_dropped_total", labels={"source": "consensus"}) > 0
    net.close()


def test_native_events_equal_jax_engine(jax_engine):  # noqa: F811
    """The same seeded (4, 1) native era drains to the same multiset of
    decoded events, times apart, from both packages' engines."""
    jnet = jax_native(jax_engine, 4, 1, 11)
    _drive(jnet, JM.HoneyBadgerId, jtracing, era_span=True)
    jevs = jtracing.native_snapshot()
    jnet.close()
    evs = _run_native_hb(era_span=True)
    assert evs and Counter(_signature(evs)) == Counter(_signature(jevs))
