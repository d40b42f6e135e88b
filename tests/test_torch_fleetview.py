"""The pure half of the port's fleet merger (`lachain_tpu_torch/utils/fleetview.py`).

The cases of tests/test_fleetview.py against the port's module: the clock
offset by RTT bracketing through the injected `_call`, the pid blocks and
the ts alignment of `merge_traces`, and the cross-validator era report and
table. One case more: without `_call` the probe raises, since the port
has no node RPC to ping.
"""
from __future__ import annotations

import time

import pytest
import torch

from lachain_tpu_torch.utils import fleetview

torch.set_num_threads(1)


def test_probe_offset_recovers_synthetic_clock_shift():
    # a fake node whose trace axis runs 5000us behind the merger's
    SHIFT_US = 5000.0

    def call():
        now = time.monotonic() * 1e6
        return {"traceUs": now - SHIFT_US, "wallUs": time.time() * 1e6}

    res = fleetview.probe_offset("http://unused", samples=7, _call=call)
    # midpoint of the bracket lands within bracket-width of the truth
    assert abs(res["offset_us"] - SHIFT_US) <= max(
        res["uncertainty_us"] * 2, 200.0
    )
    assert res["uncertainty_us"] >= 0.0


def _node(name, pid_events, offset_us=0.0, health_status="ok", era=None):
    """Synthetic scrape_node output. pid_events: {pid: [(name, ts), ...]}."""
    events = []
    for pid, evs in pid_events.items():
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": "python-host" if pid == 1 else f"eng{pid}"},
            }
        )
        for ev_name, ts in evs:
            events.append(
                {
                    "name": ev_name,
                    "ph": "X",
                    "pid": pid,
                    "tid": 1,
                    "ts": ts,
                    "dur": 1.0,
                    "args": {},
                }
            )
    report = None
    if era is not None:
        report = {"eras": [era], "phases": list(era["phases_s"])}
    return {
        "url": f"http://{name}",
        "name": name,
        "offset": {
            "offset_us": offset_us,
            "uncertainty_us": 10.0,
            "wall_skew_us": 0.0,
        },
        "trace": {"traceEvents": events, "displayTimeUnit": "ms"},
        "eraReport": report,
        "health": {"status": health_status},
        "errors": {},
    }


def test_merge_remaps_pids_and_aligns_timestamps():
    a = _node("alpha", {1: [("era", 100.0)], 2: [("kernel", 150.0)]})
    b = _node("beta", {1: [("era", 40.0)]}, offset_us=200.0)
    merged = fleetview.merge_traces([a, b])
    evs = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
    meta = [e for e in merged["traceEvents"] if e.get("ph") == "M"]
    # node 0 owns pids 100+, node 1 owns 200+
    by = {(e["pid"], e["name"]): e for e in evs}
    assert set(by) == {(101, "era"), (102, "kernel"), (201, "era")}
    # beta's event: 40 + 200 offset = 240 on the merged axis; alpha's
    # earliest (100) rebases the fleet to 0
    assert by[(101, "era")]["ts"] == 0.0
    assert by[(102, "kernel")]["ts"] == 50.0
    assert by[(201, "era")]["ts"] == 140.0
    # lane labels carry the node name
    labels = {
        e["pid"]: e["args"]["name"]
        for e in meta
        if e["name"] == "process_name"
    }
    assert labels[101] == "alpha python-host"
    assert labels[201] == "beta python-host"
    # fleet metadata rides along for tooling, viewers ignore it
    fleet = merged["fleet"]["nodes"]
    assert [n["pidBase"] for n in fleet] == [100, 200]
    assert fleet[1]["offsetUs"] == 200.0
    assert fleet[0]["status"] == "ok"


def test_merge_synthesizes_labels_and_survives_failed_parts():
    # node whose offset probe AND trace meta are missing: lane still renders
    bare = {
        "url": "http://gamma",
        "name": "gamma",
        "offset": None,
        "trace": {"traceEvents": [
            {"name": "era", "ph": "X", "pid": 3, "tid": 1, "ts": 7.0,
             "dur": 1.0, "args": {}},
        ]},
        "eraReport": None,
        "health": None,
        "errors": {"offset": "timeout"},
    }
    merged = fleetview.merge_traces([bare])
    meta = [e for e in merged["traceEvents"] if e.get("ph") == "M"]
    assert any(
        e["pid"] == 103 and e["args"]["name"] == "gamma pid3" for e in meta
    )
    assert merged["fleet"]["nodes"][0]["errors"] == {"offset": "timeout"}
    assert merged["fleet"]["nodes"][0]["offsetUs"] == 0.0


def _era_ent(era, wall, rbc, ba):
    return {
        "era": era,
        "wall_s": wall,
        "phases_s": {"rbc": rbc, "ba": ba},
        "idle_s": 0.0,
    }


def test_fleet_era_report_finds_straggler_and_worst_phase():
    a = _node("alpha", {}, era=_era_ent(3, wall=1.0, rbc=0.4, ba=0.2))
    b = _node("beta", {}, era=_era_ent(3, wall=1.5, rbc=0.4, ba=0.9))
    rep = fleetview.fleet_era_report([a, b])
    assert rep["phases"] == ["rbc", "ba"]
    (ent,) = rep["eras"]
    assert ent["era"] == 3
    assert ent["slowest"] == "beta"
    assert ent["wall_skew_s"] == pytest.approx(0.5)
    assert ent["worst_phase"] == "ba"
    assert ent["phase_skew_s"]["ba"] == pytest.approx(0.7)
    assert ent["phase_skew_s"]["rbc"] == pytest.approx(0.0)
    # table renders every node column plus the skew attribution
    table = fleetview.fleet_era_table(rep)
    assert "alpha_wall_s" in table and "beta_wall_s" in table
    assert "ba" in table and "beta" in table


def test_fleet_era_table_empty():
    assert "no completed eras" in fleetview.fleet_era_table({"eras": []})


def test_probe_offset_without_call_raises():
    with pytest.raises(NotImplementedError):
        fleetview.probe_offset("http://unused")
