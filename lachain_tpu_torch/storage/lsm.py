"""LsmKV: the native LSM storage engine behind the KVStore seam.

The port of `lachain_tpu/storage/lsm.py` over the port's own copy of its
engine, `storage/native/lsm.cpp` (format v2): CRC-framed WAL segments
written and fsynced by a writer thread (group commit; a batch is acked
only after its fsync), an arena skiplist memtable, block-based SSTables
with a bloom filter each and a shared block cache, flushed and compacted
by background threads. A batch survives kill -9 whole or not at all, as
SqliteKV's fsynced batches do. The two packages' engines share the
on-disk format, so either opens a directory the other wrote.

The engine is built by `ops/_build.lsm_library()` (g++, the reference
Makefile's flags, into `lachain_tpu_torch/_build/`) at first use; without
g++, or on a failed build, opening a store raises.

Single puts and deletes are WAL-synced one-op batches; bulk paths use
`write_batch`. `write_batch_async` enqueues a batch on the WAL writer
without waiting for its fsync (`write_barrier` waits), the seam the
streamed trie commit (`state.StateManager.freeze_and_commit`) overlaps
its hashing with.

Crash sites: beyond the generic kv.write_batch.pre / .post, write_batch
visits three engine sites that leave real torn state through the
engine's partial-execution debug entries before dying: lsm.wal.encoded
(a torn record tail in the active WAL segment), lsm.wal.fsynced (a record
durable but never acked or applied) and lsm.compact.mid (the merged SST
renamed into place, the manifest swap lost). The bytes on disk are the
same in raise and SIGKILL modes.

The flight recorder is on from open, sized `tracing.DEFAULT_CAPACITY`
records (`trace_configure` resizes it; 0 switches it off), and registered
with the merged tracer (utils/tracing.py) under a process lane of its own,
its engine threads (caller, wal-writer, flusher, compactor) as rows. A
drain (`_drain_trace`) copies the ring's raw bytes under `_lock`, releases
it, and only then decodes them and feeds the metrics: the WAL fsync
latency `lsm_wal_fsync_seconds`, the group-commit size
`lsm_wal_group_commit_records`, `wait_seconds{resource="fsync"}` of a
caller's durability stall, and the ring's overwrites in
`trace_events_dropped_total{source="lsm"}`. (The reference decodes under
the lock, so a metrics call that re-entered the store would deadlock.)
`stats()` returns the engine's counters and sets the read-path gauges
(`lsm_bloom_hits`, `lsm_cache_hit_ratio`, `lsm_compaction_backlog`, ...).

Differences, by the port's rules: there is no `LACHAIN_LSM_LIB` override
(the reference's sanitizer gate is not ported). No lock is taken on a
path that can run inside another locked section: `close` drains and
unregisters before it takes `_lock` to retire the handle, and there is no
finalizer (the weakly held drain unregisters itself once the store is
gone).
"""
from __future__ import annotations

import ctypes
import itertools
import os
import signal
import struct
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

from . import crashpoints
from .crashpoints import MODE_SIGKILL, InjectedCrash, crash_point
from .kv import KVStore
from ..utils import metrics, tracing

ENGINE_VERSION = 6  # lsm_version() of the engine this binding speaks

# lsm_stats() slot order (Lsm::fill_stats)
_STAT_FIELDS = (
    "bloom_hits",       # filter ruled a table out (saved a block fetch)
    "bloom_misses",     # filter passed; a data block was consulted
    "cache_hits",
    "cache_misses",
    "wal_fsyncs",
    "wal_records",
    "compactions",
    "table_count",
    "memtable_bytes",
    "imm_memtables",
    "compact_backlog",  # tables beyond the compaction trigger point
    "trace_dropped",    # flight-recorder ring evictions
)

# lsm.cpp's trace records: 32 bytes big-endian, the consensus engine's frame
# (u64 ts_ns, u64 dur_ns, u32 kind, u32 tid, u32 a, u32 b)
_TRACE_RECORD = struct.Struct(">QQIIII")
_LK_NAMES = {
    20: "wal_encode",  # a = payload bytes
    21: "wal_fsync",   # a = group-commit records, b = bytes written
    22: "memtable_seal",  # a = bytes, b = new WAL segment
    23: "memtable_flush",  # a = bytes, b = sst seq
    24: "compaction",  # a = input tables, b = output seq
    25: "wait:fsync",  # caller blocked on durability; a = wait resource
}
_LK_WAL_FSYNC, _LK_WAIT = 21, 25
_LT_NAMES = {0: "caller", 1: "wal-writer", 2: "flusher", 3: "compactor"}
# record counts of a group commit are small integers
_GROUP_COMMIT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_next_trace_pid = itertools.count(3)  # pid 1 = python, 2 = consensus

_P = ctypes.c_void_p
_BUF = ctypes.POINTER(ctypes.c_ubyte)
_SIZE = ctypes.c_size_t
_U64 = ctypes.c_uint64
_SIGNATURES = {
    # name: (restype, argtypes)
    "lsm_open2": (_P, [ctypes.c_char_p, _U64, _U64, _U64, _U64]),
    "lsm_close": (None, [_P]),
    "lsm_write_batch": (ctypes.c_int, [_P, ctypes.c_char_p, _SIZE]),
    "lsm_write_batch_async": (_U64, [_P, ctypes.c_char_p, _SIZE]),
    "lsm_write_barrier": (ctypes.c_int, [_P, _U64]),
    "lsm_write_batch_partial": (
        ctypes.c_int, [_P, ctypes.c_char_p, _SIZE, ctypes.c_int]),
    "lsm_get": (ctypes.c_int, [_P, ctypes.c_char_p, _SIZE,
                               ctypes.POINTER(_BUF), ctypes.POINTER(_SIZE)]),
    "lsm_scan_prefix": (ctypes.c_int, [_P, ctypes.c_char_p, _SIZE,
                                       ctypes.POINTER(_BUF),
                                       ctypes.POINTER(_SIZE)]),
    "lsm_scan_from": (ctypes.c_int, [_P, ctypes.c_char_p, _SIZE,
                                     ctypes.c_char_p, _SIZE, _U64,
                                     ctypes.POINTER(_BUF),
                                     ctypes.POINTER(_SIZE)]),
    "lsm_flush": (ctypes.c_int, [_P]),
    "lsm_compact_now": (ctypes.c_int, [_P]),
    "lsm_compact_partial": (ctypes.c_int, [_P]),
    "lsm_wait_compaction": (ctypes.c_int, [_P]),
    "lsm_stats": (None, [_P, ctypes.POINTER(_U64), ctypes.c_int]),
    "lsm_free": (None, [_BUF]),
    "lsm_table_count": (_U64, [_P]),
    "lsm_version": (ctypes.c_int, []),
    "lsm_trace_configure": (None, [_P, _U64]),
    "lsm_trace_dropped": (_U64, [_P]),
    "lsm_trace_drain": (_U64, [_P, _BUF, _U64]),
    "lsm_monotonic_ns": (_U64, []),
}
_LIB: list = []
_LIB_LOCK = threading.Lock()


def _load_lib():
    """The engine, built by `_build.lsm_library()` and typed, once a
    process."""
    with _LIB_LOCK:
        if not _LIB:
            from ..ops import _build

            lib = _build.lsm_library()
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            if lib.lsm_version() != ENGINE_VERSION:
                raise RuntimeError(
                    f"LSM engine version {lib.lsm_version()}, the binding "
                    f"speaks {ENGINE_VERSION}"
                )
            _LIB.append(lib)
    return _LIB[0]


def _encode_batch(
    puts: List[Tuple[bytes, bytes]], deletes: List[bytes]
) -> bytes:
    """The batch's WAL payload: u32 count, then per op a kind byte (0 put,
    1 delete), u32 key length, key, u32 value length, value (lengths
    little-endian)."""
    parts = [(len(puts) + len(deletes)).to_bytes(4, "little")]
    for k, v in puts:
        parts.append(
            b"\x00" + len(k).to_bytes(4, "little") + k
            + len(v).to_bytes(4, "little") + v
        )
    for k in deletes:
        parts.append(
            b"\x01" + len(k).to_bytes(4, "little") + k + b"\x00\x00\x00\x00"
        )
    return b"".join(parts)


def _decode_rows(data: bytes) -> List[Tuple[bytes, bytes]]:
    """A scan's buffer: u32 count, then per row u32 key length, key, u32
    value length, value (little-endian)."""
    out: List[Tuple[bytes, bytes]] = []
    off = 4
    for _ in range(int.from_bytes(data[0:4], "little")):
        klen = int.from_bytes(data[off : off + 4], "little")
        off += 4
        k = data[off : off + klen]
        off += klen
        vlen = int.from_bytes(data[off : off + 4], "little")
        off += 4
        out.append((k, data[off : off + vlen]))
        off += vlen
    return out


class LsmKV(KVStore):
    """Durable KV on the native LSM engine (a drop-in for SqliteKV)."""

    # the WAL runs on its own writer thread, so write_batch_async really
    # overlaps a record's encode and fsync with the caller's next work
    supports_async_batches = True

    def __init__(
        self,
        path: str,
        flush_threshold: int = 8 << 20,
        cache_bytes: int = 0,
        compact_tables: int = 0,
        compact_rate_mbps: int = 0,
    ):
        self._lib = _load_lib()
        self._lock = threading.Lock()
        self._h = self._lib.lsm_open2(
            path.encode(), flush_threshold, cache_bytes,
            compact_tables, compact_rate_mbps,
        )
        if not self._h:
            raise IOError(f"cannot open LSM store at {path!r}")
        # the flight recorder: size the ring, put its clock on
        # time.monotonic's, register it with the merged tracer (a process
        # lane of its own; the engine's threads are its rows)
        self._trace_offset = tracing.clock_offset(self._lib.lsm_monotonic_ns)
        self._trace_dropped_seen = 0
        self._trace_pid = next(_next_trace_pid)
        self._trace_source = f"lsm-{os.path.basename(path) or path}-{id(self):x}"
        self._lib.lsm_trace_configure(self._h, tracing.DEFAULT_CAPACITY)
        ref = weakref.ref(self)
        source = self._trace_source

        def drain() -> List[dict]:
            store = ref()
            if store is None:
                tracing.unregister_native_source(source)
                return []
            return store._drain_trace()

        tracing.register_native_source(source, drain)

    # -- flight recorder -------------------------------------------------------
    def trace_configure(self, capacity: int) -> None:
        """Resize the engine's trace ring (records); 0 switches it off."""
        with self._lock:
            if self._h:
                self._lib.lsm_trace_configure(self._h, max(int(capacity), 0))

    def _decode_trace(self, raw: bytes) -> List[dict]:
        """Raw ring bytes -> the merged tracer's events; feeds the WAL's
        fsync and group-commit histograms and the fsync waits. Called with
        `_lock` released."""
        evs: List[dict] = []
        pname = self._trace_source.rsplit("-", 1)[0]
        for i in range(0, len(raw) - (len(raw) % 32), 32):
            ts, dur, kind, tid, a, b = _TRACE_RECORD.unpack_from(raw, i)
            is_wait = kind == _LK_WAIT  # a caller's durability stall
            evs.append({
                "name": _LK_NAMES.get(kind, str(kind)),
                "cat": "native.wait" if is_wait else "native.lsm",
                "start": ts / 1e9 + self._trace_offset,
                "end": (ts + dur) / 1e9 + self._trace_offset,
                "pid": self._trace_pid,
                "pname": pname,
                "tid": tid,
                "tname": _LT_NAMES.get(tid, str(tid)),
                "args": {"resource": "fsync"} if is_wait else {"a": a, "b": b},
            })
            if is_wait:
                metrics.observe_hist(
                    "wait_seconds", dur / 1e9, labels={"resource": "fsync"}
                )
            if kind == _LK_WAL_FSYNC:
                metrics.observe_hist("lsm_wal_fsync_seconds", dur / 1e9)
                metrics.observe_hist(  # lint-allow: metric-name dimensionless record-count distribution
                    "lsm_wal_group_commit_records", a,
                    buckets=_GROUP_COMMIT_BUCKETS,
                )
        return evs

    def _drain_trace(self) -> List[dict]:
        """Consume the engine's ring -> the merged tracer's events. The raw
        bytes and the drop count are copied under `_lock`; the decode, the
        histograms and the drop counter run after it is released, so that
        no metrics call runs inside the store's lock."""
        raw = b""
        with self._lock:
            if not self._h:
                return []
            for _ in range(4):
                need = self._lib.lsm_trace_drain(self._h, None, 0)
                if need == 0:
                    break
                buf = (ctypes.c_ubyte * (need + 4096))()
                got = self._lib.lsm_trace_drain(self._h, buf, len(buf))
                if got <= len(buf):
                    raw = bytes(buf[:got])
                    break
            dropped = int(self._lib.lsm_trace_dropped(self._h))
        evs = self._decode_trace(raw)
        if dropped > self._trace_dropped_seen:
            metrics.inc(
                "trace_events_dropped_total",
                dropped - self._trace_dropped_seen,
                labels={"source": "lsm"},
            )
            self._trace_dropped_seen = dropped
        return evs

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.POINTER(ctypes.c_ubyte)()
        vlen = ctypes.c_size_t(0)
        r = self._lib.lsm_get(
            self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen)
        )
        if r < 0:
            raise IOError(f"LSM read failed for key {key!r}")
        if r != 1:
            return None
        try:
            return ctypes.string_at(val, vlen.value)
        finally:
            self._lib.lsm_free(val)

    def put(self, key: bytes, value: bytes) -> None:
        self.write_batch([(key, value)])

    def delete(self, key: bytes) -> None:
        self.write_batch([], [key])

    # engine-specific crash sites: leave really torn native state through
    # the partial-execution debug entries, then die the way the armed point
    # asks (InjectedCrash or a real SIGKILL). The disk image is the same in
    # both modes, which is what makes the two modes' verdicts comparable.
    _TORN_SITES = (("lsm.wal.encoded", 0), ("lsm.wal.fsynced", 1))

    def _visit_torn_sites(self, payload: bytes) -> None:
        session = crashpoints.active()
        if session is None:
            return
        for name, stage in self._TORN_SITES:
            point = session.visit(name)
            if point is not None:
                with self._lock:
                    rc = self._lib.lsm_write_batch_partial(
                        self._h, payload, len(payload), stage
                    )
                if rc != 0:
                    raise IOError(f"LSM partial write failed at {name}")
                self._die(point, name)
        point = session.visit("lsm.compact.mid")
        if point is not None:
            with self._lock:
                if self._lib.lsm_compact_partial(self._h) != 0:
                    raise IOError("LSM partial compaction failed")
            self._die(point, "lsm.compact.mid")

    @staticmethod
    def _die(point, name: str) -> None:
        if point.mode == MODE_SIGKILL:
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(name, point.hit)

    def write_batch(
        self, puts: List[Tuple[bytes, bytes]], deletes: List[bytes] = ()
    ) -> None:
        crash_point("kv.write_batch.pre")
        payload = _encode_batch(list(puts), list(deletes))
        self._visit_torn_sites(payload)
        with self._lock:
            if self._lib.lsm_write_batch(self._h, payload, len(payload)) != 0:
                raise IOError("LSM write_batch failed")
        # no .mid point: the batch commits inside one native call — the
        # torn-WAL windows are the lsm.wal.* sites above
        crash_point("kv.write_batch.post")

    def write_batch_async(
        self, puts: List[Tuple[bytes, bytes]], deletes: List[bytes] = ()
    ) -> int:
        """Enqueue an atomic batch onto the WAL writer thread WITHOUT
        waiting for its fsync; returns the WAL seq as the barrier ticket.
        The streamed trie commit pipelines through this: chunk N+1's
        Python-side encode overlaps chunk N's write()+fsync(). A crash
        before the barrier can leave these batches durable but unacked —
        callers must only stream data that is SAFE to persist early
        (content-addressed trie nodes: orphans without a root record,
        fsck-clean, shrink reclaims them).

        Deliberately NOT a crash_point/torn-site surface: the generic
        kv.write_batch.* sites use traversal counts as matrix coordinates,
        and streamed chunks would shift every existing hit number. The
        mid-stream window has its own dedicated point
        (trie.merkle.subtree_streamed) in StateManager."""
        payload = _encode_batch(list(puts), list(deletes))
        with self._lock:
            seq = self._lib.lsm_write_batch_async(
                self._h, payload, len(payload)
            )
        if seq == 0:
            raise IOError("LSM write_batch_async failed")
        return int(seq)

    def write_barrier(self, ticket) -> None:
        """Block until the ticketed async batch's WAL record is fsynced."""
        if not ticket:
            return
        with self._lock:
            if self._lib.lsm_write_barrier(self._h, int(ticket)) != 0:
                raise IOError("LSM write_barrier failed")

    def scan_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        blen = ctypes.c_size_t(0)
        if (
            self._lib.lsm_scan_prefix(
                self._h, prefix, len(prefix),
                ctypes.byref(buf), ctypes.byref(blen),
            )
            != 0
        ):
            raise IOError("LSM scan failed")
        try:
            data = ctypes.string_at(buf, blen.value)
        finally:
            self._lib.lsm_free(buf)
        yield from _decode_rows(data)

    def scan_from(
        self, prefix: bytes, after: bytes, limit: int
    ) -> List[Tuple[bytes, bytes]]:
        """Bounded native cursor page (the fast-sync snapshot primitive):
        the engine seeks its SSTable cursors and memtable skiplists to
        prefix+after and merges forward for `limit` live rows — O(seek +
        page) instead of the O(keyspace) full-prefix materialization the
        KVStore default pays via scan_prefix. Row identity with the
        default and SqliteKV pager is held by the tests."""
        if limit <= 0:
            return []
        buf = ctypes.POINTER(ctypes.c_ubyte)()
        blen = ctypes.c_size_t(0)
        if (
            self._lib.lsm_scan_from(
                self._h, prefix, len(prefix), after, len(after),
                limit, ctypes.byref(buf), ctypes.byref(blen),
            )
            != 0
        ):
            raise IOError("LSM scan_from failed")
        try:
            data = ctypes.string_at(buf, blen.value)
        finally:
            self._lib.lsm_free(buf)
        return _decode_rows(data)

    def flush(self) -> None:
        """Seal the memtable and wait until it is a durable sorted table."""
        with self._lock:
            if self._lib.lsm_flush(self._h) != 0:
                raise IOError("LSM flush failed")

    def ingest(
        self, puts: List[Tuple[bytes, bytes]], chunk: int = 2000
    ) -> None:
        """Bulk-load (snapshot shipping / db import): batched writes, then
        seal the memtable so the imported keyspace is durable sorted
        tables — the verification read pass that follows (root walk,
        fsck) hits bloom-filtered SSTs instead of a giant memtable."""
        super().ingest(puts, chunk)
        if puts:
            self.flush()

    def compact(self) -> None:
        """Flush, then run one full merge to a single table (CLI/db verb)."""
        with self._lock:
            if self._lib.lsm_compact_now(self._h) != 0:
                raise IOError("LSM compaction failed")

    def wait_compaction(self) -> None:
        """Block until no background compaction is scheduled or running."""
        self._lib.lsm_wait_compaction(self._h)

    def table_count(self) -> int:
        return int(self._lib.lsm_table_count(self._h))

    def stats(self) -> Dict[str, int]:
        """The engine's counters (bloom and block-cache hits, WAL fsyncs
        and records, compactions, tables, memtable bytes, backlog, ring
        overwrites); sets the read-path gauges as a side effect."""
        arr = (ctypes.c_uint64 * len(_STAT_FIELDS))()
        self._lib.lsm_stats(self._h, arr, len(_STAT_FIELDS))
        out = dict(zip(_STAT_FIELDS, (int(v) for v in arr)))
        self._publish_metrics(out)
        return out

    @staticmethod
    def _publish_metrics(stats: Dict[str, int]) -> None:
        metrics.set_gauge("lsm_bloom_hits", stats["bloom_hits"])
        metrics.set_gauge("lsm_bloom_misses", stats["bloom_misses"])
        lookups = stats["cache_hits"] + stats["cache_misses"]
        metrics.set_gauge(
            "lsm_cache_hit_ratio",
            stats["cache_hits"] / lookups if lookups else 0.0,
        )
        metrics.set_gauge("lsm_table_count", stats["table_count"])
        metrics.set_gauge("lsm_compactions_total", stats["compactions"])
        metrics.set_gauge("lsm_wal_fsyncs_total", stats["wal_fsyncs"])
        metrics.set_gauge("lsm_wal_records_total", stats["wal_records"])
        # a backlog that stays with compactions flat: a starved compactor
        metrics.set_gauge("lsm_compaction_backlog", stats["compact_backlog"])

    def close(self) -> None:
        """Drain the ring into the merged tracer (its histogram samples
        included), unregister it, and close the engine (idempotent)."""
        if self._h:
            tracing.drain_native()
            tracing.unregister_native_source(self._trace_source)
        with self._lock:
            if self._h:
                self._lib.lsm_close(self._h)
                self._h = None
