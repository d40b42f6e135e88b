"""Fleet-wide observability merge: ONE Chrome trace for N nodes.

The port of the pure half of `lachain_tpu/utils/fleetview.py`: the functions
that take what was scraped from the nodes and need no node.
  * `probe_offset`: the microseconds to ADD to a node's Chrome ts axis to
    land on the merger's monotonic axis, by RTT bracketing of a clock
    read (`_call`, the node's `la_time` round trip);
  * `merge_traces`: per-node Chrome traces folded into one, each node in
    its own pid block, shifted by its offset, the fleet re-based to ts=0;
  * `fleet_era_report` / `fleet_era_table`: per-era wall times across the
    validators, the slowest one, and the phase with the largest skew.

The scrape itself (`_rpc`, `scrape_node`, `collect`) needs a node's RPC
server, which the port does not have yet; `probe_offset` without `_call`
raises. Stdlib only.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

# pid namespacing: node i owns [_PID_STRIDE*(i+1), _PID_STRIDE*(i+2)) in
# the merged trace; within the block, the node's original pids (python
# host = 1, native engines = 2+) keep their relative positions
_PID_STRIDE = 100


def probe_offset(
    url: str,
    samples: int = 5,
    timeout: float = 10.0,
    api_key: Optional[str] = None,
    _call=None,
) -> Dict[str, float]:
    """Microseconds to ADD to the node's Chrome ts axis to land on the
    merger's local monotonic axis, found by RTT bracketing: read the
    local clock, ping `la_time`, read again; the node's answer happened
    somewhere inside the bracket, so the tightest bracket's midpoint is
    the best alignment and half its width bounds the error. `_call()`
    makes one la_time round trip and returns its {"traceUs", "wallUs"};
    without it this raises (the port has no node RPC yet)."""
    if _call is None:
        raise NotImplementedError(
            "fleetview: the node RPC (la_time) is not ported; pass _call"
        )
    call = _call
    best_width = None
    best = {"offset_us": 0.0, "uncertainty_us": 0.0, "wall_skew_us": 0.0}
    for _ in range(max(samples, 1)):
        m0 = time.monotonic() * 1e6
        w0 = time.time() * 1e6
        res = call()
        m1 = time.monotonic() * 1e6
        w1 = time.time() * 1e6
        width = m1 - m0
        if best_width is None or width < best_width:
            best_width = width
            best = {
                "offset_us": round((m0 + m1) / 2 - float(res["traceUs"]), 1),
                "uncertainty_us": round(width / 2, 1),
                # wall skew is diagnostic only (NTP drift between hosts);
                # the merge itself never trusts wall clocks
                "wall_skew_us": round(
                    (w0 + w1) / 2 - float(res["wallUs"]), 1
                ),
            }
    return best


def merge_traces(nodes: List[Dict[str, object]]) -> dict:
    """Fold per-node Chrome traces into one. Every event's pid moves into
    its node's pid block, its ts shifts by the node's probed offset onto
    the merger's axis, and the whole fleet is re-based so the earliest
    event sits at ts=0. Nodes whose offset probe failed keep offset 0 —
    their lane renders, visibly mis-aligned, rather than disappearing.

    The returned dict is valid Chrome trace JSON; the extra top-level
    "fleet" key (per-node pid base, offset, uncertainty, health verdict)
    is ignored by viewers and consumed by the era table / CI tooling."""
    events: List[dict] = []
    meta: List[dict] = []
    fleet: List[dict] = []
    for i, node in enumerate(nodes):
        base = _PID_STRIDE * (i + 1)
        offset = node.get("offset") or {}
        off_us = float(offset.get("offset_us", 0.0))
        health = node.get("health") or {}
        fleet.append(
            {
                "name": node["name"],
                "url": node.get("url"),
                "pidBase": base,
                "offsetUs": off_us,
                "uncertaintyUs": offset.get("uncertainty_us"),
                "wallSkewUs": offset.get("wall_skew_us"),
                "status": health.get("status"),
                # WAN posture: worst peer SRTT, the RTT-scaled
                # stall budget actually in force, and the node's wire
                # version — a mixed-version fleet mid-rolling-upgrade is
                # visible here without shelling into nodes
                "rttMaxMs": health.get("rttMaxMs"),
                "stallTimeoutEffective": health.get("stallTimeoutEffective"),
                "wireVersion": health.get("wireVersion"),
                "errors": node.get("errors") or {},
            }
        )
        trace = node.get("trace") or {}
        named_pids = set()
        for ev in trace.get("traceEvents", ()):
            ev = dict(ev)
            ev["pid"] = base + int(ev.get("pid", 0))
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    # lane labels carry the node name: "node2 python-host"
                    args = dict(ev.get("args") or {})
                    args["name"] = f"{node['name']} {args.get('name', '')}"
                    ev["args"] = args
                    named_pids.add(ev["pid"])
                meta.append(ev)
                continue
            ev["ts"] = float(ev.get("ts", 0.0)) + off_us
            events.append(ev)
        # nodes emitting events on a pid with no process_name meta would
        # render as an anonymous lane — synthesize a label
        for pid in sorted(
            {e["pid"] for e in events if base <= e["pid"] < base + _PID_STRIDE}
            - named_pids
        ):
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {
                        "name": f"{node['name']} pid{pid - base}"
                    },
                }
            )
    if events:
        t0 = min(e["ts"] for e in events)
        for ev in events:
            ev["ts"] = round(ev["ts"] - t0, 1)
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "fleet": {"nodes": fleet},
    }


def fleet_era_report(nodes: List[Dict[str, object]]) -> dict:
    """Cross-validator era comparison from the per-node era reports:
    for every era any node completed, the per-node wall time, the
    slowest validator (the straggler consensus waits on), and per-phase
    skew (max−min across the nodes that saw the era — a phase with high
    skew on low mean is one validator's private problem, not a fleet
    regression)."""
    per_era: Dict[int, Dict[str, dict]] = {}
    phases: List[str] = []
    for node in nodes:
        rep = node.get("eraReport") or {}
        for p in rep.get("phases", ()):
            if p not in phases:
                phases.append(p)
        for ent in rep.get("eras", ()):
            per_era.setdefault(int(ent["era"]), {})[
                str(node["name"])
            ] = ent
    eras = []
    for era in sorted(per_era):
        by_node = per_era[era]
        walls = {n: float(e["wall_s"]) for n, e in by_node.items()}
        slowest = max(walls, key=walls.get)  # type: ignore[arg-type]
        phase_skew = {}
        for p in phases:
            vals = [
                float((e.get("phases_s") or {}).get(p, 0.0))
                for e in by_node.values()
            ]
            phase_skew[p] = round(max(vals) - min(vals), 6) if vals else 0.0
        worst_phase = (
            max(phase_skew, key=phase_skew.get) if phase_skew else None
        )
        eras.append(
            {
                "era": era,
                "wall_s": {n: round(w, 6) for n, w in walls.items()},
                "slowest": slowest,
                "wall_skew_s": round(
                    max(walls.values()) - min(walls.values()), 6
                ),
                "phase_skew_s": phase_skew,
                "worst_phase": worst_phase,
            }
        )
    return {"eras": eras, "phases": phases}


def fleet_era_table(report: dict) -> str:
    """Plain-text rendering of fleet_era_report for the CLI."""
    eras = report.get("eras", [])
    if not eras:
        return "<no completed eras reported by any node>"
    names = sorted({n for ent in eras for n in ent["wall_s"]})
    cols = (
        ["era"]
        + [f"{n}_wall_s" for n in names]
        + ["skew_s", "slowest", "worst_phase", "phase_skew_s"]
    )
    rows = [cols]
    for ent in eras:
        wp = ent.get("worst_phase")
        rows.append(
            [str(ent["era"])]
            + [
                f"{ent['wall_s'][n]:.3f}" if n in ent["wall_s"] else "-"
                for n in names
            ]
            + [
                f"{ent['wall_skew_s']:.3f}",
                str(ent["slowest"]),
                str(wp or "-"),
                f"{ent['phase_skew_s'].get(wp, 0.0):.3f}" if wp else "-",
            ]
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = [
        "  ".join(cell.rjust(widths[i]) for i, cell in enumerate(row))
        for row in rows
    ]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)
