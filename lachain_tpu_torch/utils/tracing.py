"""Era-lifecycle span recorder: where inside an era does the time go?

The port of `lachain_tpu/utils/tracing.py`, the same module: the metrics
registry answers "how much / how often", this one "WHEN, nested under
WHAT": era -> sub-protocol lifetimes (RBC/BA/CC/ACS/HB) -> the TPKE flush
and the RS device products -> block execution and commit. Spans go into a
bounded in-process ring (thread-safe); the native engines' flight
recorders (consensus/native_rt.py, storage/lsm.py) register drain
callbacks whose events merge into the same timeline. `to_chrome_trace()`
exports Chrome `trace_event` JSON for chrome://tracing or Perfetto;
`era_report()` attributes each era's wall time to the phases of `PHASES`,
decomposes the rest into named waits (`WAIT_RESOURCES`) and walks the
era's critical path.

Protocol lifetimes are NOT stack-shaped (dozens overlap within one era), so
the primitive is a begin()/end() handle pair; `span()` wraps the scoped
case. `open_stack_str()` names the protocols a stalled node is stuck in.
It imports neither torch nor anything of the port but, lazily, the
evidence module's per-era counters.
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

_lock = threading.Lock()
_ids = itertools.count(1)
# finished spans, oldest evicted first; 8192 spans ≈ a few dozen eras at
# N=16 — enough history to explain a stall without unbounded growth.
# LACHAIN_TRACE_CAPACITY (env) sets the default of this ring and of the
# native-engine rings; set_capacity resizes the merged rings.
DEFAULT_CAPACITY = int(os.environ.get("LACHAIN_TRACE_CAPACITY") or 8192)
_done: deque = deque(maxlen=DEFAULT_CAPACITY)
_open: "Dict[int, _Span]" = {}
# monotonic epoch so exported timestamps are small positive microseconds
_epoch = time.monotonic()

# -- native flight-recorder merge state --------------------------------------
# Sources (the native consensus engine, each native LSM store) register a
# drain callback returning ready-made event dicts: {name, cat, start, end,
# args, pid, tid, tname, [replace_key]}. `start`/`end` are time.monotonic()
# seconds (the source applies its clock-offset handshake before handing
# events over). Events carrying `replace_key` are cumulative snapshots
# (per-era dispatch-phase totals): only the latest per key is kept.
_native_sources: "Dict[str, Callable[[], List[dict]]]" = {}
_native_done: deque = deque(maxlen=DEFAULT_CAPACITY)
_native_acc: Dict[tuple, dict] = {}
# ring evictions (silent truncation made visible)
_py_dropped = 0


def _count_drop(n: int = 1) -> None:
    """Caller holds _lock. Mirrors the drop into the metrics registry."""
    global _py_dropped
    _py_dropped += n
    try:
        from . import metrics

        metrics.inc(
            "trace_events_dropped_total", n, labels={"source": "python"}
        )
    except Exception:  # metrics must never break the recorder
        pass


def dropped_total() -> int:
    """Python-ring evictions since start (native rings report their own)."""
    with _lock:
        return _py_dropped


class _Span:
    __slots__ = ("sid", "name", "cat", "start", "end", "args")

    def __init__(self, sid: int, name: str, cat: str, start: float, args):
        self.sid = sid
        self.name = name
        self.cat = cat
        self.start = start
        self.end: Optional[float] = None
        self.args: Dict[str, Any] = args

    def to_dict(self, now: Optional[float] = None) -> dict:
        end = self.end if self.end is not None else now
        return {
            "id": self.sid,
            "name": self.name,
            "cat": self.cat,
            "start": self.start,
            "end": end,
            "open": self.end is None,
            "args": dict(self.args),
        }


def begin(name: str, cat: str = "era", **args) -> int:
    """Open a span; returns its id (pass to end()/annotate())."""
    sid = next(_ids)
    sp = _Span(sid, name, cat, time.monotonic(), args)
    with _lock:
        _open[sid] = sp
    return sp.sid


def annotate(sid: int, **args) -> None:
    """Merge args into a still-open span (no-op once closed)."""
    with _lock:
        sp = _open.get(sid)
        if sp is not None:
            sp.args.update(args)


def end(sid: int, **args) -> None:
    """Close a span; idempotent (a GC sweep and a normal completion may
    both try to close the same protocol span)."""
    with _lock:
        sp = _open.pop(sid, None)
        if sp is None:
            return
        sp.end = time.monotonic()
        if args:
            sp.args.update(args)
        if _done.maxlen is not None and len(_done) == _done.maxlen:
            _count_drop()
        _done.append(sp)


def instant(name: str, cat: str = "era", **args) -> None:
    """Record a zero-duration event (block persisted, watchdog firing)."""
    sp = _Span(next(_ids), name, cat, time.monotonic(), args)
    sp.end = sp.start
    with _lock:
        if _done.maxlen is not None and len(_done) == _done.maxlen:
            _count_drop()
        _done.append(sp)


@contextmanager
def span(name: str, cat: str = "era", **args):
    """Scoped begin/end; yields the span id for annotate()."""
    sid = begin(name, cat, **args)
    try:
        yield sid
    finally:
        end(sid)


# The named wait buckets era_report() decomposes idle into. Every blocking
# point in an era thread tags itself with the resource it waits on; the
# remainder (time nothing claims) is reported as idle_unattributed.
WAIT_RESOURCES = ("net", "crypto_flush", "device", "fsync", "sched")
# Overlap precedence between wait intervals: specific resources outrank
# the broad ones. `net` is the catch-all (the hub read loop waits for
# nearly all wall time) so it only owns segments nothing else claims;
# `sched` (the native dispatch loop's queue-empty gap) brackets whatever
# host-side work starved it, so the specific cause wins when present.
_WAIT_PRIORITY = {
    "device": 0,
    "fsync": 1,
    "crypto_flush": 2,
    "sched": 3,
    "net": 4,
}


@contextmanager
def wait(resource: str, **args):
    """Scoped wait-state span: wraps a blocking call (queue get, fsync,
    device sync, socket read) so era_report() can attribute the idle it
    causes to `resource`. Also feeds the wait_seconds{resource} histogram."""
    sid = begin(f"wait.{resource}", cat="wait", resource=resource, **args)
    t0 = time.monotonic()
    try:
        yield sid
    finally:
        end(sid)
        try:
            from . import metrics

            metrics.observe_hist(
                "wait_seconds",
                time.monotonic() - t0,
                labels={"resource": resource},
            )
        except Exception:  # metrics must never break the waiter
            pass


def open_spans() -> List[dict]:
    """Snapshot of currently-open spans, oldest first (the watchdog's
    view of what the node is stuck inside)."""
    now = time.monotonic()
    with _lock:
        spans = sorted(_open.values(), key=lambda s: (s.start, s.sid))
        return [s.to_dict(now) for s in spans]


def open_stack_str() -> str:
    """Human one-liner of the open-span stack for stall reports:
    'era(era=7) > HoneyBadger > tpke.flush'."""
    parts = []
    for s in open_spans():
        era = s["args"].get("era")
        parts.append(
            f"{s['name']}(era={era})" if era is not None else s["name"]
        )
    return " > ".join(parts) if parts else "<no open spans>"


def snapshot(limit: Optional[int] = None) -> List[dict]:
    """Finished + open spans as plain dicts, oldest first."""
    now = time.monotonic()
    with _lock:
        done = list(_done)
        live = sorted(_open.values(), key=lambda s: (s.start, s.sid))
        out = [s.to_dict(now) for s in done + live]
    out.sort(key=lambda d: (d["start"], d["id"]))
    if limit is not None and limit > 0:
        out = out[-limit:]
    return out


def chrome_now_us() -> float:
    """'Now' on the exported Chrome ts axis (microseconds since this
    tracer's epoch). The anchor `la_time` serves so a fleet merger can
    align this node's trace axis with its own clock by RTT bracketing —
    the cross-node analogue of clock_offset()."""
    return (time.monotonic() - _epoch) * 1e6


# -- native flight-recorder merge --------------------------------------------


def clock_offset(native_now_ns: Callable[[], int], samples: int = 5) -> float:
    """Seconds to ADD to a native engine's monotonic ns/1e9 so its
    timestamps land on this tracer's time.monotonic axis. Both clocks are
    CLOCK_MONOTONIC on Linux, but the handshake keeps the alignment honest
    where the epochs differ: bracket the native read with two monotonic
    reads and keep the tightest bracket's midpoint."""
    best_width, best_off = None, 0.0
    for _ in range(max(samples, 1)):
        t0 = time.monotonic()
        ns = native_now_ns()
        t1 = time.monotonic()
        if best_width is None or (t1 - t0) < best_width:
            best_width = t1 - t0
            best_off = (t0 + t1) / 2 - ns / 1e9
    return best_off


def register_native_source(name: str, fn: Callable[[], List[dict]]) -> None:
    """Register a drain callback for a native engine's trace ring.

    `fn` returns event dicts with monotonic-aligned `start`/`end` seconds
    (the binding applies its clock-offset handshake), plus `pid`, `tid`,
    `pname`, `tname` lane hints for the Chrome export. Re-registering a
    name replaces the previous callback (engine restart)."""
    with _lock:
        _native_sources[name] = fn


def unregister_native_source(name: str) -> None:
    with _lock:
        _native_sources.pop(name, None)


def drain_native() -> None:
    """Pull pending events out of every registered native ring into the
    merged buffer. Cheap when rings are empty; callers sprinkle this at
    quiescent points (era end, snapshot/export time)."""
    with _lock:
        sources = list(_native_sources.items())
    for name, fn in sources:
        try:
            evs = fn()
        except Exception:
            # a closed engine must not poison the recorder; the owner
            # unregisters on close, this covers teardown races
            continue
        if not evs:
            continue
        with _lock:
            for ev in evs:
                key = ev.get("replace_key")
                if key is not None:
                    # cumulative snapshot (dispatch-phase totals):
                    # latest per key wins, no ring growth
                    _native_acc[key] = ev
                    continue
                if (
                    _native_done.maxlen is not None
                    and len(_native_done) == _native_done.maxlen
                ):
                    _count_drop()
                _native_done.append(ev)


def native_snapshot() -> List[dict]:
    """Drained native events (plus latest cumulative accumulators) as
    plain dicts, oldest first. Triggers a drain."""
    drain_native()
    with _lock:
        out = list(_native_done) + list(_native_acc.values())
    out.sort(key=lambda d: (d.get("start", 0.0), d.get("tid", 0)))
    return [dict(d) for d in out]


PY_PID = 1  # Python host process lane group in the Chrome export


def _assign_lanes(spans: List[dict]) -> List[tuple]:
    """Per-category, nesting-preserving lane assignment.

    Within one category, each lane holds a stack of enclosing span end
    times: a span may join a lane only if the lane is idle at its start
    or the span nests fully inside the lane's innermost open span.
    Overlapping-but-not-nested spans (concurrent protocol instances)
    therefore land on separate rows, while parent/child pairs stay
    stacked on one row so Perfetto renders real nesting.

    Returns [(span_dict, category, lane_index)], input order preserved.
    """
    lanes_by_cat: Dict[str, List[List[float]]] = {}
    out = []
    for d in spans:
        cat = d["cat"] or "default"
        lanes = lanes_by_cat.setdefault(cat, [])
        placed = None
        for idx, stack in enumerate(lanes):
            while stack and stack[-1] <= d["start"]:
                stack.pop()
            if not stack or d["end"] <= stack[-1]:
                stack.append(d["end"])
                placed = idx
                break
        if placed is None:
            placed = len(lanes)
            lanes.append([d["end"]])
        out.append((d, cat, placed))
    return out


def to_chrome_trace(limit: Optional[int] = None) -> dict:
    """Chrome trace_event JSON (load in chrome://tracing / Perfetto).

    Python-host spans render under pid=1 with one labeled thread-row
    group per category (nesting preserved; concurrent instances fan out
    to numbered sibling rows). Drained native-engine events render under
    their own pids with the engine's real thread roles (WAL writer,
    flusher, compactor, per-validator dispatch) as named rows, so one
    export shows the whole cross-language timeline."""
    events: List[dict] = []
    # (pid, tid) -> row label; pid -> process label
    thread_names: Dict[tuple, str] = {}
    proc_names: Dict[int, str] = {PY_PID: "python-host"}

    tid_of: Dict[tuple, int] = {}

    def py_tid(cat: str, lane: int) -> int:
        key = (cat, lane)
        if key not in tid_of:
            tid_of[key] = len(tid_of) + 1
            label = cat if lane == 0 else f"{cat}#{lane}"
            thread_names[(PY_PID, tid_of[key])] = label
        return tid_of[key]

    for d, cat, lane in _assign_lanes(snapshot(limit)):
        args = dict(d["args"])
        if d["open"]:
            args["open"] = True
        events.append(
            {
                "name": d["name"],
                "cat": d["cat"],
                "ph": "X",
                "pid": PY_PID,
                "tid": py_tid(cat, lane),
                "ts": round((d["start"] - _epoch) * 1e6, 1),
                "dur": round(max((d["end"] - d["start"]) * 1e6, 0.0), 1),
                "args": args,
            }
        )

    for ev in native_snapshot():
        pid = int(ev.get("pid", 2))
        tid = int(ev.get("tid", 0))
        if ev.get("pname"):
            proc_names[pid] = ev["pname"]
        if ev.get("tname"):
            thread_names[(pid, tid)] = ev["tname"]
        events.append(
            {
                "name": ev["name"],
                "cat": ev.get("cat", "native"),
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": round((ev["start"] - _epoch) * 1e6, 1),
                "dur": round(
                    max((ev["end"] - ev["start"]) * 1e6, 0.0), 1
                ),
                "args": dict(ev.get("args") or {}),
            }
        )

    meta: List[dict] = []
    for pid, label in sorted(proc_names.items()):
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )
    for (pid, tid), label in sorted(thread_names.items()):
        meta.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": label},
            }
        )
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def summary() -> dict:
    """Per-span-name aggregate: {name: {count, total_ms, max_ms, open}}."""
    agg: Dict[str, dict] = {}
    for d in snapshot():
        ent = agg.setdefault(
            d["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0, "open": 0}
        )
        ms = (d["end"] - d["start"]) * 1e3
        ent["count"] += 1
        ent["total_ms"] = round(ent["total_ms"] + ms, 3)
        ent["max_ms"] = round(max(ent["max_ms"], ms), 3)
        if d["open"]:
            ent["open"] += 1
    return agg


# -- era phase attribution ---------------------------------------------------

# Report columns, and the precedence used when intervals overlap: a span
# counted as TPKE decrypt (device call) wins over the protocol span it is
# nested inside. Idle is derived (wall − attributed), so the table always
# sums to era wall time up to clamp error.
PHASES = (
    "propose",
    "rbc",
    "rbc_device",
    "ba",
    "coin",
    "tpke_verify",
    "tpke_decrypt",
    "exec",
    "merkle",
    "commit",
)
_PHASE_PRIORITY = {
    "tpke_decrypt": 0,
    "tpke_verify": 1,
    # merkle outranks exec: the merkle.freeze span nests inside exec.block,
    # and commit attribution must separate hashing from tx execution.
    # exec outranks commit: the block-execution span nests inside the
    # root_produce commit crossing, and the refactored executor
    # (core/parallel_exec.py) is what the exec column exists to expose
    "merkle": 2,
    "exec": 3,
    "propose": 4,
    "commit": 5,
    "coin": 6,
    "ba": 7,
    "rbc": 8,
    # rs.device spans nest inside the rbc.flush span: the device column must
    # win that overlap so host-vs-device RS time splits cleanly
    "rbc_device": 1.5,
}

# Python span name -> phase. Parent/orchestrator spans (era, HoneyBadger,
# CommonSubset, RootProtocol) are deliberately absent: their time is the
# sum of their children plus idle, so attributing them would double count.
_SPAN_PHASE = {
    "consensus.propose": "propose",
    "ReliableBroadcast": "rbc",
    "rbc.flush": "rbc",
    "rs.device": "rbc_device",
    "BinaryAgreement": "ba",
    "BinaryBroadcast": "ba",
    "CommonCoin": "coin",
    "hb.era_decrypt": "tpke_decrypt",
    "hb.apply_era_results": "tpke_decrypt",
    "exec.block": "exec",
    "merkle.freeze": "merkle",
}

# Native crossing op name -> phase (see consensus/native_hosts.py XO_NAMES).
_CROSS_PHASE = {
    "coin_sign": "coin",
    "coin_combine": "coin",
    "coin_result": "coin",
    "hb_acs": "tpke_verify",
    "hb_queue": "tpke_decrypt",
    "hb_done": "tpke_decrypt",
    "rbc_encode": "rbc",
    "rbc_need": "rbc",
    "root_input": "propose",
    "root_sign": "commit",
    "root_verify": "commit",
    "root_produce": "commit",
}

# Native dispatch-phase accumulator name -> phase (TK_PHASE records;
# exclusive message-dispatch time measured inside the C++ engine).
_DISPATCH_PHASE = {
    "rbc": "rbc",
    "ba": "ba",
    "coin": "coin",
    "tpke": "tpke_decrypt",
    "commit": "commit",
}


def _cut_spans(clipped: List[tuple], cuts: List[float]) -> tuple:
    """For each clipped (key, s, e): the index of its first and of its
    last elementary segment among `cuts`; an interval covers segment i
    (cuts[i], cuts[i + 1]) exactly when first <= i < last."""
    at = {c: i for i, c in enumerate(cuts)}
    starts: Dict[int, List[int]] = {}
    ends: Dict[int, List[int]] = {}
    for j, (_key, s, e) in enumerate(clipped):
        starts.setdefault(at[s], []).append(j)
        ends.setdefault(at[e], []).append(j)
    return starts, ends


def _sweep(intervals: List[tuple], lo: float, hi: float) -> Dict[str, float]:
    """Exclusive per-phase time from possibly-overlapping phase intervals,
    clipped to [lo, hi]; where intervals overlap the highest-priority
    phase owns the time (so nested spans never double count). One pass
    over the sorted cut points with a count of the covering intervals per
    phase (the reference's scan of every interval per segment gives the
    same sums, in quadratic time)."""
    edges = {lo, hi}
    clipped = []
    for phase, s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            clipped.append((phase, s, e))
            edges.add(s)
            edges.add(e)
    cuts = sorted(edges)
    starts, ends = _cut_spans(clipped, cuts)
    by_priority = sorted(PHASES, key=_PHASE_PRIORITY.__getitem__)
    active = {p: 0 for p in PHASES}
    out = {p: 0.0 for p in PHASES}
    for i in range(len(cuts) - 1):
        for j in ends.get(i, ()):
            active[clipped[j][0]] -= 1
        for j in starts.get(i, ()):
            active[clipped[j][0]] += 1
        for phase in by_priority:
            if active[phase]:
                out[phase] += cuts[i + 1] - cuts[i]
                break
    return out


def _sweep_waits(
    phase_iv: List[tuple],
    wait_iv: List[tuple],
    lo: float,
    hi: float,
) -> Dict[str, float]:
    """Exclusive per-resource wait time on the stretches of [lo, hi] that
    NO phase interval covers: any attributed phase time outranks every
    wait (a wait span bracketing real work must not double count), and
    overlapping waits resolve by _WAIT_PRIORITY (equal priorities: the
    covering wait listed first). One pass over the sorted cut points."""
    edges = {lo, hi}
    phases = []
    for _, s, e in phase_iv:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            phases.append((None, s, e))
            edges.add(s)
            edges.add(e)
    waits = []
    for res, s, e in wait_iv:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            waits.append((res, s, e))
            edges.add(s)
            edges.add(e)
    cuts = sorted(edges)
    p_starts, p_ends = _cut_spans(phases, cuts)
    w_starts, w_ends = _cut_spans(waits, cuts)
    covered = 0
    # resource -> heap of the list indices of its covering waits (lazy
    # deletion: `live` holds the indices still covering)
    heaps: Dict[str, List[int]] = {}
    live: set = set()
    out = {r: 0.0 for r in WAIT_RESOURCES}
    for i in range(len(cuts) - 1):
        covered -= len(p_ends.get(i, ()))
        covered += len(p_starts.get(i, ()))
        for j in w_ends.get(i, ()):
            live.discard(j)
        for j in w_starts.get(i, ()):
            live.add(j)
            heapq.heappush(heaps.setdefault(waits[j][0], []), j)
        if covered:
            continue
        best = None
        for res, heap in heaps.items():
            while heap and heap[0] not in live:
                heapq.heappop(heap)
            if heap:
                key = (_WAIT_PRIORITY.get(res, len(_WAIT_PRIORITY)), heap[0])
                if best is None or key < best[0]:
                    best = (key, res)
        if best is not None:
            out.setdefault(best[1], 0.0)
            out[best[1]] += cuts[i + 1] - cuts[i]
    return out


def _critical_path(intervals: List[tuple], lo: float, hi: float) -> dict:
    """Longest blocking chain through one era window.

    `intervals` are (kind, name, start, end) with kind in
    {"phase", "wait"}. Walk BACKWARDS from the era end (the commit): at
    each cursor pick the covering interval that reaches furthest back (the
    first listed among equals) and emit one segment per hop; stretches
    nothing covers become "gap"/"unattributed" segments (native dispatch
    accumulators have no intervals, so engine dispatch time lands here,
    bounded by crossings and wait records on either side). By construction
    the segments tile [lo, hi], so their lengths sum to the era wall. The
    walk visits the intervals by falling end once, keeping the earliest
    start among those that reach the cursor."""
    eps = 1e-9
    iv = [
        (kind, name, max(s, lo), min(e, hi))
        for kind, name, s, e in intervals
        if min(e, hi) > max(s, lo)
    ]
    by_end = sorted(range(len(iv)), key=lambda j: -iv[j][3])
    k = 0  # by_end[:k]: the intervals whose end reaches the cursor
    reach = None  # (start, list index) of the earliest start among them
    segs: List[dict] = []
    cursor = hi
    while cursor - lo > eps:
        while k < len(by_end) and iv[by_end[k]][3] >= cursor - eps:
            j = by_end[k]
            if reach is None or (iv[j][2], j) < reach:
                reach = (iv[j][2], j)
            k += 1
        if reach is not None and reach[0] < cursor - eps:
            kind, name, s, _e = iv[reach[1]]
            start = max(s, lo)
            segs.append(
                {"kind": kind, "name": name, "start": start, "end": cursor}
            )
            cursor = start
        else:
            # the next interval by end ends before the cursor: the latest
            # such end bounds the gap (lo where there is none)
            prev = lo
            if k < len(by_end) and iv[by_end[k]][3] > lo:
                prev = iv[by_end[k]][3]
            segs.append(
                {"kind": "gap", "name": "unattributed",
                 "start": prev, "end": cursor}
            )
            cursor = prev
    segs.reverse()
    merged: List[dict] = []
    for sg in segs:
        if (
            merged
            and merged[-1]["kind"] == sg["kind"]
            and merged[-1]["name"] == sg["name"]
        ):
            merged[-1]["end"] = sg["end"]
        else:
            merged.append(dict(sg))
    out_segs = [
        {
            "kind": sg["kind"],
            "name": sg["name"],
            "start_s": round(sg["start"] - lo, 6),
            "end_s": round(sg["end"] - lo, 6),
            "dur_s": round(sg["end"] - sg["start"], 6),
        }
        for sg in merged
    ]
    top = sorted(out_segs, key=lambda s: -s["dur_s"])[:5]
    return {
        "total_s": round(sum(s["dur_s"] for s in out_segs), 6),
        "segments": out_segs,
        "top": [
            {"kind": s["kind"], "name": s["name"], "dur_s": s["dur_s"]}
            for s in top
        ],
    }


def era_report(
    spans: Optional[List[dict]] = None,
    native: Optional[List[dict]] = None,
) -> dict:
    """Per-era phase attribution: where does era wall time go?

    Combines three sources: Python protocol/crypto spans (interval sweep
    with nesting priority), native crossing events (batched crypto ops,
    from the drained consensus ring), and the engine's per-era exclusive
    dispatch accumulators. Idle = wall − attributed, clamped at 0, then
    DECOMPOSED into named wait buckets (waits_s, from wait.* spans and
    native wait records) plus an idle_unattributed remainder — the
    invariant is buckets + remainder == the old idle value. Each era also
    carries a critical_path block: the longest blocking chain walked
    backwards from the era's end, whose segments tile the era wall. The
    direct input for deciding what to overlap when pipelining eras
    (the pipelined-era window)."""
    if spans is None:
        spans = snapshot()
    if native is None:
        native = native_snapshot()

    # era window = union over every node's "era" span for that era number
    windows: Dict[int, List[float]] = {}
    for d in spans:
        if d["name"] == "era" and d["args"].get("era") is not None:
            era = int(d["args"]["era"])
            w = windows.setdefault(era, [d["start"], d["end"]])
            w[0] = min(w[0], d["start"])
            w[1] = max(w[1], d["end"])

    per_era_iv: Dict[int, List[tuple]] = {e: [] for e in windows}
    for d in spans:
        phase = _SPAN_PHASE.get(d["name"])
        era = d["args"].get("era")
        if phase is None or era is None or int(era) not in per_era_iv:
            continue
        per_era_iv[int(era)].append((phase, d["start"], d["end"]))

    # mesh device-busy windows (parallel/mesh.MeshEraPipeline spans the
    # kernel dispatch -> result-ready interval as "mesh.device"): these are
    # era-agnostic — the pipeline serves every validator's chunks — so they
    # attribute to eras by time overlap with each era window
    mesh_spans = [
        d for d in spans
        if d["name"] == "mesh.device" and d["end"] is not None
    ]

    # wait-state intervals (Python wait.* spans + native wait records):
    # attributed to eras by time overlap — a hub read wait or an LSM
    # fsync wait serves the node, not one era, so clipping is the honest
    # split (same rule as mesh.device above)
    wait_iv_all: List[tuple] = []
    for d in spans:
        if d["cat"] == "wait" and d["end"] is not None:
            res = d["args"].get("resource") or "net"
            wait_iv_all.append((res, d["start"], d["end"]))

    dispatch: Dict[int, Dict[str, float]] = {}
    for ev in native:
        if ev.get("cat") == "native.wait":
            res = (ev.get("args") or {}).get("resource") or "sched"
            wait_iv_all.append((res, ev["start"], ev["end"]))
            continue
        era = (ev.get("args") or {}).get("era")
        if era is None or int(era) not in windows:
            continue
        era = int(era)
        if ev.get("cat") == "native.cross":
            phase = _CROSS_PHASE.get((ev.get("args") or {}).get("op"))
            if phase is not None:
                per_era_iv[era].append((phase, ev["start"], ev["end"]))
        elif ev.get("cat") == "native.phase":
            phase = _DISPATCH_PHASE.get((ev.get("args") or {}).get("phase"))
            if phase is not None:
                acc = dispatch.setdefault(era, {})
                acc[phase] = acc.get(phase, 0.0) + float(
                    (ev.get("args") or {}).get("dur_ns", 0)
                ) / 1e9

    eras = []
    for era in sorted(windows):
        lo, hi = windows[era]
        wall = max(hi - lo, 0.0)
        # pipelining overlap: how much of this era's window was shared
        # with ANY other in-flight era (intersection with the union of the
        # other windows). 0 everywhere means the eras ran sequentially.
        other = sorted(
            (max(s, lo), min(e, hi))
            for o, (s, e) in windows.items()
            if o != era and min(e, hi) > max(s, lo)
        )
        overlap = 0.0
        cur_s = cur_e = None
        for s, e in other:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    overlap += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            overlap += cur_e - cur_s
        phases = _sweep(per_era_iv[era], lo, hi)
        # engine dispatch time is measured OUTSIDE the crossing callbacks
        # (cross time subtracted natively), so it is exclusive of every
        # interval above and adds linearly
        for phase, secs in dispatch.get(era, {}).items():
            phases[phase] += secs
        attributed = sum(phases.values())
        idle = max(wall - attributed, 0.0)
        # idle decomposition: exclusive wait coverage on the un-attributed
        # stretches of the window. The dispatch accumulators above occupy
        # unswept wall time, so raw wait coverage can exceed the idle
        # residual; scale the buckets down proportionally so
        # buckets + remainder always equal the old idle value exactly.
        wait_iv = [
            (res, s, e) for res, s, e in wait_iv_all
            if min(e, hi) > max(s, lo)
        ]
        waits = _sweep_waits(per_era_iv[era], wait_iv, lo, hi)
        wsum = sum(waits.values())
        if wsum > idle and wsum > 0:
            scale = idle / wsum
            waits = {r: v * scale for r, v in waits.items()}
            wsum = idle
        unattr = max(idle - wsum, 0.0)
        cpath = _critical_path(
            [("phase", p, s, e) for p, s, e in per_era_iv[era]]
            + [("wait", res, s, e) for res, s, e in wait_iv],
            lo,
            hi,
        )
        # per-device utilization row: union of mesh.device (dispatch ->
        # ready) windows clipped to this era, all_gather bytes pro-rated by
        # the clipped fraction. busy/wall is an upper bound on device
        # utilization (the ready edge is observed when the caller blocks)
        dev_iv = []
        dev_mb = 0.0
        dev_n = 0
        for d in mesh_spans:
            cs, ce = max(d["start"], lo), min(d["end"], hi)
            if ce <= cs:
                continue
            dev_iv.append((cs, ce))
            dur = d["end"] - d["start"]
            if dur > 0:
                dev_mb += float(
                    d["args"].get("allgather_mb", 0.0)
                ) * (ce - cs) / dur
            dev_n = max(dev_n, int(d["args"].get("devices", 0)))
        dev_iv.sort()
        busy = 0.0
        cur_s = cur_e = None
        for cs, ce in dev_iv:
            if cur_e is None or cs > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = cs, ce
            else:
                cur_e = max(cur_e, ce)
        if cur_e is not None:
            busy += cur_e - cur_s
        eras.append(
            {
                "era": era,
                "wall_s": round(wall, 6),
                "phases_s": {p: round(phases[p], 6) for p in PHASES},
                "idle_s": round(idle, 6),
                "waits_s": {
                    r: round(waits.get(r, 0.0), 6) for r in WAIT_RESOURCES
                },
                "idle_unattributed_s": round(unattr, 6),
                "idle_unattributed_fraction": round(unattr / idle, 4)
                if idle > 0
                else 0.0,
                "critical_path": cpath,
                "overlap_s": round(overlap, 6),
                "attributed_s": round(attributed, 6),
                "coverage": round(
                    (attributed + idle) / wall, 4
                ) if wall > 0 else 1.0,
                "device": {
                    "busy_s": round(busy, 6),
                    "util": round(busy / wall, 4) if wall > 0 else 0.0,
                    "allgather_mb": round(dev_mb, 3),
                    "mesh_devices": dev_n,
                },
            }
        )
    # Byzantine pressure per era (evidence.py per-process registry): how
    # many NEW equivocation / invalid-share records this process minted
    # while the era ran — the report shows attack visibility
    # next to the phase timings it distorts
    try:
        from ..consensus.evidence import era_counts

        by_era = era_counts()
        for ent in eras:
            ent["byzantine"] = dict(
                by_era.get(ent["era"], {"equivocation": 0, "invalid_share": 0})
            )
    except Exception:
        pass  # evidence module must never break the report
    return {"eras": eras, "phases": list(PHASES)}


def era_report_table(report: Optional[dict] = None) -> str:
    """Plain-text per-era phase table."""
    if report is None:
        report = era_report()
    cols = (
        ["era", "wall_s"] + list(PHASES)
        + ["idle_s"] + [f"w:{r}" for r in WAIT_RESOURCES]
        + ["unattr_s", "overlap_s", "dev_util", "equiv", "badshare"]
    )
    rows = [cols]
    for ent in report["eras"]:
        dev = ent.get("device") or {}
        waits = ent.get("waits_s") or {}
        byz = ent.get("byzantine") or {}
        rows.append(
            [str(ent["era"]), f"{ent['wall_s']:.3f}"]
            + [f"{ent['phases_s'][p]:.3f}" for p in PHASES]
            + [f"{ent['idle_s']:.3f}"]
            + [f"{waits.get(r, 0.0):.3f}" for r in WAIT_RESOURCES]
            + [
                f"{ent.get('idle_unattributed_s', 0.0):.3f}",
                f"{ent.get('overlap_s', 0.0):.3f}",
                f"{dev.get('util', 0.0):.3f}",
                str(byz.get("equivocation", 0)),
                str(byz.get("invalid_share", 0)),
            ]
        )
    if len(rows) == 1:
        return "<no completed eras in trace ring>"
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = [
        "  ".join(cell.rjust(widths[i]) for i, cell in enumerate(row))
        for row in rows
    ]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def critical_path_table(report: Optional[dict] = None) -> str:
    """Plain-text per-era critical-path chains: each era's longest blocking chain from start to
    commit, one row per merged segment, offsets relative to era start."""
    if report is None:
        report = era_report()
    lines: List[str] = []
    for ent in report["eras"]:
        cp = ent.get("critical_path") or {}
        lines.append(
            f"era {ent['era']}: critical path "
            f"{cp.get('total_s', 0.0):.3f}s "
            f"(era wall {ent['wall_s']:.3f}s)"
        )
        for sg in cp.get("segments", ()):
            lines.append(
                f"  {sg['start_s']:>10.3f}s -> {sg['end_s']:>10.3f}s  "
                f"{sg['dur_s']:>9.3f}s  {sg['kind']}:{sg['name']}"
            )
    return "\n".join(lines) if lines else "<no completed eras in trace ring>"


def set_capacity(n: int) -> None:
    """Resize the merged span rings (keeps the newest spans). Native
    in-engine ring capacities are configured via their bindings."""
    global _done, _native_done
    with _lock:
        _done = deque(_done, maxlen=max(int(n), 1))
        _native_done = deque(_native_done, maxlen=max(int(n), 1))


def reset_for_tests() -> None:
    global _done, _native_done, _py_dropped
    with _lock:
        _done = deque(maxlen=DEFAULT_CAPACITY)
        _open.clear()
        _native_done = deque(maxlen=DEFAULT_CAPACITY)
        _native_acc.clear()
        _native_sources.clear()
        _py_dropped = 0
