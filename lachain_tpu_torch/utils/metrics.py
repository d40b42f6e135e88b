"""Metrics registry: per-era crypto timers, counters, gauges, histograms.

The port of `lachain_tpu/utils/metrics.py`, the same module with the same
metric names and labels, so that one dashboard reads either package:
  * timers (`measure` / `timed` / `observe`), the per-era crypto operation
    counters of the C# reference's TimeBenchmark, dumped and reset by
    `timer_snapshot`;
  * Prometheus-style counters, gauges and histograms, labeled, rendered in
    the text exposition format by `render_text()`; a metric family admits
    at most `MAX_LABEL_SETS` label sets, past that new ones are counted in
    `metrics_labels_dropped_total` and dropped.

Thread-safe; one process-global registry. It imports neither torch nor
anything of the port: a host-only user of the protocol modules never loads
torch through it.
"""
from __future__ import annotations

import bisect
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

_lock = threading.Lock()
# name -> (count, total_seconds)
_timers: Dict[str, Tuple[int, float]] = {}
# (name, labels) -> value; labels is a sorted tuple of (key, value) pairs,
# () for unlabeled series (the common case; keeps the old flat registry)
_counters: Dict[Tuple[str, tuple], float] = {}
_gauges: Dict[Tuple[str, tuple], float] = {}
# (name, labels) -> Histogram
_histograms: Dict[Tuple[str, tuple], "Histogram"] = {}

# hot-path cell for the per-consensus-message counter: `inc()` takes the
# registry lock per call, which is real overhead at 2M-message eras (N=64
# sim). A bare list-cell `+= 1` is atomic enough under the GIL; render_text
# folds it into the `consensus_messages_processed` counter on exposition.
MESSAGES_PROCESSED = [0]
monotonic = time.monotonic

# Prometheus-ish default latency buckets (seconds): sub-ms crypto ops up to
# multi-second era walls
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


# Cardinality backstop: distinct label sets admitted per metric name (per
# kind). Label values derived from attacker- or workload-controlled input
# (peer ids, method names, stages) must not grow the registry — and the
# scrape payload — without bound. Past the cap, NEW label sets are dropped
# and counted in the unlabeled metrics_labels_dropped_total; existing
# series keep updating.
MAX_LABEL_SETS = 256
_series_counts: Dict[Tuple[str, str], int] = {}  # (kind, name) -> sets
_DROPPED_KEY = ("metrics_labels_dropped_total", ())


def _admit(kind: str, name: str) -> bool:
    """Called under _lock when a labeled series would be CREATED: admit
    while the (kind, name) family is under MAX_LABEL_SETS, else count the
    drop and refuse."""
    k = (kind, name)
    n = _series_counts.get(k, 0)
    if n >= MAX_LABEL_SETS:
        _counters[_DROPPED_KEY] = _counters.get(_DROPPED_KEY, 0.0) + 1.0
        return False
    _series_counts[k] = n + 1
    return True


def _label_key(labels: Optional[dict]) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs
    )
    return "{" + body + "}"


def _fmt_num(v: float) -> str:
    # "1" not "1.0" for bucket bounds; plain repr for everything else
    return "%g" % v


class Histogram:
    """Prometheus histogram with GIL-atomic hot-path cells.

    `observe()` is the MESSAGES_PROCESSED idiom generalized: bucket counts
    and the sum/count live in bare list cells whose `+=` is atomic enough
    under the GIL, so per-frame / per-message call sites never contend on
    the registry lock. A scrape may read sum and count a hair apart —
    the standard trade for lock-free observation."""

    __slots__ = ("name", "labels", "buckets", "_counts", "_sum", "_count")

    def __init__(
        self,
        name: str,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        labels: tuple = (),
    ):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # one cell per finite bucket + the +Inf overflow cell
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = [0.0]
        self._count = [0]

    def observe(self, value: float) -> None:
        # le is "less than or equal": first bucket whose bound >= value
        self._counts[bisect.bisect_left(self.buckets, value)] += 1
        self._sum[0] += value
        self._count[0] += 1

    def snapshot(self) -> dict:
        """{count, sum, buckets: [(le, cumulative), ...]} — cumulative as
        the exposition renders them."""
        cum = 0
        out = []
        for bound, c in zip(self.buckets, self._counts):
            cum += c
            out.append((bound, cum))
        return {
            "count": self._count[0],
            "sum": self._sum[0],
            "buckets": out,
        }


def histogram(
    name: str,
    buckets: Sequence[float] = DEFAULT_BUCKETS,
    labels: Optional[dict] = None,
) -> Histogram:
    """Get-or-create the histogram for (name, labels). Hold the returned
    object on hot paths — `observe()` never takes the registry lock."""
    key = (name, _label_key(labels))
    h = _histograms.get(key)
    if h is None:
        with _lock:
            h = _histograms.get(key)
            if h is None:
                if key[1] and not _admit("histogram", name):
                    # over the cardinality cap: hand back a detached
                    # histogram (observations land nowhere, callers keep
                    # working) instead of registering a new series
                    return Histogram(name, buckets, key[1])
                h = Histogram(name, buckets, key[1])
                _histograms[key] = h
    return h


def observe_hist(
    name: str,
    value: float,
    buckets: Sequence[float] = DEFAULT_BUCKETS,
    labels: Optional[dict] = None,
) -> None:
    """Convenience one-shot observation for warm (non-hot) paths."""
    histogram(name, buckets, labels).observe(value)


def histogram_snapshot(name: str, labels: Optional[dict] = None):
    h = _histograms.get((name, _label_key(labels)))
    return h.snapshot() if h is not None else None


@contextmanager
def measure(name: str):
    """Time one operation under `name` (TimeBenchmark.Measure role)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            cnt, total = _timers.get(name, (0, 0.0))
            _timers[name] = (cnt + 1, total + dt)


def timed(name: str):
    """Decorator form of measure() for instrumenting crypto entry points."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with measure(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def inc(
    name: str, amount: float = 1.0, labels: Optional[dict] = None
) -> None:
    key = (name, _label_key(labels))
    with _lock:
        if (
            key[1]
            and key not in _counters
            and not _admit("counter", name)
        ):
            return
        _counters[key] = _counters.get(key, 0.0) + amount


def set_gauge(
    name: str, value: float, labels: Optional[dict] = None
) -> None:
    key = (name, _label_key(labels))
    with _lock:
        if key[1] and key not in _gauges and not _admit("gauge", name):
            return
        _gauges[key] = value


def counter_value(name: str, labels: Optional[dict] = None) -> float:
    with _lock:
        return _counters.get((name, _label_key(labels)), 0.0)


def gauge_value(name: str, labels: Optional[dict] = None) -> Optional[float]:
    with _lock:
        return _gauges.get((name, _label_key(labels)))


def counters_with_prefix(prefix: str) -> Dict[Tuple[str, tuple], float]:
    """All counter series whose name starts with `prefix`, keyed by
    (name, label_items). The scrape-free way to read a labeled family —
    e.g. the crossings of the native engine
    (consensus_callback_crossings_total{op=...})."""
    with _lock:
        return {
            key: v for key, v in _counters.items()
            if key[0].startswith(prefix)
        }


# Gauges the port publishes:
#   mesh_devices, mesh_pad_waste_fraction   parallel/mesh.MeshEraPipeline:
#                                   devices of the era mesh, and the share
#                                   of the padded kernel grid the last era
#                                   burnt on filler lanes
#   lsm_bloom_hits, lsm_bloom_misses, lsm_cache_hit_ratio, lsm_table_count,
#   lsm_compaction_backlog          storage/lsm.LsmKV.stats()
#   tpke_batcher_queue_depth        submissions queued in the TPKE flush
#                                   batcher (consensus/crypto_batcher)
#   rbc_batcher_queue_depth         the same of the RBC flush batcher
#   consensus_dispatch_queue_depth  undelivered messages in the dispatch
#                                   queue (native engine or simulator) at
#                                   the last pump iteration; 0 = starved
# and the histogram wait_seconds{resource} of blocking waits, one series a
# resource (net / crypto_flush / device / fsync / sched), fed by
# tracing.wait() and the native wait records: the scrapeable twin of the
# era report's idle decomposition.


def observe(name: str, seconds: float) -> None:
    with _lock:
        cnt, total = _timers.get(name, (0, 0.0))
        _timers[name] = (cnt + 1, total + seconds)


def timer_snapshot(
    reset: bool = False, reset_prefix: str = ""
) -> Dict[str, dict]:
    """{name: {count, total_ms, avg_ms}} — the per-era dump. With
    `reset_prefix`, only timers whose name starts with it are cleared (the
    crypto timers reset per era; block summaries survive for scrapes)."""
    with _lock:
        snap = {
            name: {
                "count": cnt,
                "total_ms": round(total * 1e3, 3),
                "avg_ms": round(total * 1e3 / cnt, 4) if cnt else 0.0,
            }
            for name, (cnt, total) in _timers.items()
        }
        if reset:
            if reset_prefix:
                for name in [n for n in _timers if n.startswith(reset_prefix)]:
                    del _timers[name]
            else:
                _timers.clear()
    return snap


def render_text() -> str:
    """Prometheus text exposition of counters, gauges, timers and
    histograms (labeled series grouped under one # TYPE header)."""
    lines = []
    with _lock:
        if MESSAGES_PROCESSED[0]:
            key = ("consensus_messages_processed", ())
            _counters[key] = _counters.get(key, 0.0) + MESSAGES_PROCESSED[0]
            MESSAGES_PROCESSED[0] = 0
        last = None
        for (name, labels), v in sorted(_counters.items()):
            if name != last:
                lines.append(f"# TYPE {name} counter")
                last = name
            lines.append(f"{name}{_fmt_labels(labels)} {v}")
        last = None
        for (name, labels), v in sorted(_gauges.items()):
            if name != last:
                lines.append(f"# TYPE {name} gauge")
                last = name
            lines.append(f"{name}{_fmt_labels(labels)} {v}")
        for name, (cnt, total) in sorted(_timers.items()):
            lines.append(f"# TYPE {name}_seconds summary")
            lines.append(f"{name}_seconds_count {cnt}")
            lines.append(f"{name}_seconds_sum {total}")
        last = None
        for (name, labels), h in sorted(_histograms.items()):
            if name != last:
                lines.append(f"# TYPE {name} histogram")
                last = name
            snap = h.snapshot()
            for bound, cum in snap["buckets"]:
                le = list(labels) + [("le", _fmt_num(bound))]
                lines.append(f"{name}_bucket{_fmt_labels(le)} {cum}")
            inf = list(labels) + [("le", "+Inf")]
            lines.append(f"{name}_bucket{_fmt_labels(inf)} {snap['count']}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} {snap['sum']}")
            lines.append(
                f"{name}_count{_fmt_labels(labels)} {snap['count']}"
            )
    return "\n".join(lines) + "\n"


def reset_all_for_tests() -> None:
    with _lock:
        _timers.clear()
        _counters.clear()
        _gauges.clear()
        _histograms.clear()
        _series_counts.clear()
        MESSAGES_PROCESSED[0] = 0
