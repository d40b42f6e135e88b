"""Key-value storage backends.

The port of `lachain_tpu/storage/kv.py`: one KV store with WAL-synced,
atomic batches, partitioned by 2-byte keyspace prefixes (`EntryPrefix`),
the shape of the C# reference's RocksDB context.

Backends:
  * MemoryKV  dict-backed, for tests and in-process networks;
  * SqliteKV  a durable single file over the standard library's sqlite3
    (WAL mode), whose `write_batch` is fsynced before it returns.

Differences, by the port's rules: the reference's `fsync` wait span is not
carried (the port has no tracing). `LsmKV` and the rest of the reference's
`storage/` (state, trie, fsck) wait for the node (ROADMAP A item 13).
"""
from __future__ import annotations

import enum
import sqlite3
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from .crashpoints import crash_point


class EntryPrefix(enum.IntEnum):
    """2-byte keyspace partition (the reference's EntryPrefix)."""

    BLOCK_BY_HASH = 0x0101
    BLOCK_HASH_BY_HEIGHT = 0x0102
    BLOCK_HEIGHT = 0x0103
    BLOCK_BLOOM = 0x0104
    TRANSACTION_BY_HASH = 0x0201
    ADDRESS_TX = 0x0202
    TRIE_NODE = 0x0301
    SNAPSHOT_INDEX = 0x0401
    POOL_TX = 0x0501
    KEYGEN_STATE = 0x0601
    VALIDATOR_ATTENDANCE = 0x0701
    LOCAL_TRANSACTION = 0x0801
    # the consensus send journal (consensus/journal.py)
    CONSENSUS_STATE = 0x0901
    SHRINK_STATE = 0x0A01
    SHRINK_MARK = 0x0A02
    # fast-sync frontier spill: trie-node hashes discovered but not yet
    # fetched; transient
    FASTSYNC_FRONTIER = 0x0B01
    # Byzantine evidence records (consensus/evidence.py): deduped
    # accusations that must survive a restart
    EVIDENCE = 0x0C01


def prefixed(prefix: EntryPrefix, key: bytes = b"") -> bytes:
    return int(prefix).to_bytes(2, "big") + key


class KVStore:
    """The interface every backend implements."""

    # True where write_batch_async really overlaps the WAL's encode and
    # fsync with the caller's work; the default below runs the batch
    # synchronously, and callers gate streamed commits on this flag
    supports_async_batches = False

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def write_batch(self, puts: List[Tuple[bytes, bytes]], deletes: List[bytes] = ()) -> None:
        """Atomic multi-write: every put and delete, or none."""
        raise NotImplementedError

    def write_batch_async(
        self, puts: List[Tuple[bytes, bytes]], deletes: List[bytes] = ()
    ):
        """Submit an atomic batch without waiting for durability; returns a
        ticket for write_barrier. Default: a synchronous write_batch
        (ticket None)."""
        self.write_batch(puts, deletes)
        return None

    def write_barrier(self, ticket) -> None:
        """Block until the write_batch_async ticket's batch is durable.
        Default: nothing to wait for (batches were synchronous)."""

    def scan_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def scan_from(
        self, prefix: bytes, after: bytes, limit: int
    ) -> List[Tuple[bytes, bytes]]:
        """The first `limit` rows under `prefix` whose key suffix is
        strictly greater than `after` (the cursor of a paged pull);
        `after=b""` starts at the front."""
        out: List[Tuple[bytes, bytes]] = []
        floor = prefix + after
        for k, v in self.scan_prefix(prefix):
            if after and k <= floor:
                continue
            out.append((k, v))
            if len(out) >= limit:
                break
        return out

    def ingest(
        self, puts: List[Tuple[bytes, bytes]], chunk: int = 2000
    ) -> None:
        """Bulk load in atomic batches of `chunk`."""
        for i in range(0, len(puts), chunk):
            self.write_batch(puts[i : i + chunk])

    def close(self) -> None:
        pass


class MemoryKV(KVStore):
    def __init__(self):
        self._d: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        return self._d.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._d[key] = value

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._d.pop(key, None)

    def write_batch(self, puts, deletes=()) -> None:
        with self._lock:
            for k, v in puts:
                self._d[k] = v
            for k in deletes:
                self._d.pop(k, None)

    def scan_prefix(self, prefix: bytes):
        for k in sorted(self._d):
            if k.startswith(prefix):
                yield k, self._d[k]


class SqliteKV(KVStore):
    """Durable KV on sqlite's WAL.

    `write_batch` commits with `synchronous=FULL`: the WAL is fsynced
    before the call returns, so a power failure cannot lose a committed
    batch. Single puts and deletes stay at `synchronous=NORMAL`: under WAL
    a power failure may lose the last few of them but never corrupts the
    file.
    """

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)"
        )
        self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (key,)
            ).fetchone()
        return row[0] if row else None

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value)
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (key,))
            self._conn.commit()

    def write_batch(self, puts, deletes=()) -> None:
        crash_point("kv.write_batch.pre")
        with self._lock:
            self._conn.execute("PRAGMA synchronous=FULL")
            try:
                cur = self._conn.cursor()
                cur.executemany(
                    "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                    list(puts),
                )
                if deletes:
                    cur.executemany(
                        "DELETE FROM kv WHERE k = ?", [(k,) for k in deletes]
                    )
                # after the writes, before the fsynced commit: the window
                # a kill -9 must roll back entirely
                crash_point("kv.write_batch.mid")
                self._conn.commit()
            except BaseException:
                # a half-written batch must not linger in the open implicit
                # transaction, or the next put() would commit it
                self._conn.rollback()
                raise
            finally:
                self._conn.execute("PRAGMA synchronous=NORMAL")
        crash_point("kv.write_batch.post")

    def scan_prefix(self, prefix: bytes):
        hi = prefix + b"\xff" * 8
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k <= ? ORDER BY k",
                (prefix, hi),
            ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), bytes(v)

    def scan_from(self, prefix: bytes, after: bytes, limit: int):
        # an indexed range scan: a page costs O(page), not O(keyspace)
        hi = prefix + b"\xff" * 8
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k > ? AND k <= ? ORDER BY k "
                "LIMIT ?",
                (prefix + after, hi, limit),
            ).fetchall()
        return [
            (bytes(k), bytes(v))
            for k, v in rows
            if bytes(k).startswith(prefix)
        ]

    def close(self) -> None:
        with self._lock:
            self._conn.close()
