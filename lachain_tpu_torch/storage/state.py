"""State snapshots over the content-addressed trie: balances, contracts,
storage, transactions, blocks, events and validators.

The port of `lachain_tpu/storage/state.py`. Because trie roots are
immutable values, a snapshot is a struct of seven root hashes plus a write
buffer: "approve" freezes the buffer into new roots, "commit" persists the
root set under the block height, "rollback" drops the struct. The rows it
writes (trie nodes, the snapshot index, the tip height) equal the JAX
package's, byte for byte.

`StateManager.commit` and `freeze_and_commit` keep the reference's
ordering invariant: trie nodes are never durable later than a root row
that references them. Over an engine with asynchronous batches (`LsmKV`)
a large commit streams its nodes as WAL records that overlap each other's
fsync and writes the root rows last, behind a barrier.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..crypto.hashes import keccak256_host
from ..utils.serialization import Reader, write_u64
from .crashpoints import crash_point
from .kv import EntryPrefix, KVStore, prefixed
from .trie import EMPTY_ROOT, Trie

SUBTREES = (
    "balances",
    "contracts",
    "storage",
    "transactions",
    "blocks",
    "events",
    "validators",
)


@dataclass(frozen=True)
class StateRoots:
    """The 7 sub-roots; the block's state hash commits to all of them
    (reference: BlockchainSnapshot's sub-snapshot hash aggregation)."""

    balances: bytes = EMPTY_ROOT
    contracts: bytes = EMPTY_ROOT
    storage: bytes = EMPTY_ROOT
    transactions: bytes = EMPTY_ROOT
    blocks: bytes = EMPTY_ROOT
    events: bytes = EMPTY_ROOT
    validators: bytes = EMPTY_ROOT

    def state_hash(self) -> bytes:
        return keccak256_host(b"".join(getattr(self, name) for name in SUBTREES))

    def encode(self) -> bytes:
        return b"".join(getattr(self, name) for name in SUBTREES)

    def all_roots(self) -> tuple:
        return tuple(getattr(self, name) for name in SUBTREES)

    @classmethod
    def decode(cls, data: bytes) -> "StateRoots":
        assert len(data) == 32 * len(SUBTREES)
        return cls(**{
            name: data[i * 32 : (i + 1) * 32] for i, name in enumerate(SUBTREES)
        })


class Snapshot:
    """Mutable working snapshot on top of immutable roots.

    Writes buffer in-memory; `freeze()` flushes them into the trie and
    returns new immutable StateRoots. Reads see buffered writes first
    (the reference's Pending tier).
    """

    # sentinel for "key was absent from the buffer" in undo entries —
    # distinct from None, which is the buffered-delete marker
    _ABSENT = object()

    def __init__(self, trie: Trie, roots: StateRoots):
        self._trie = trie
        self.base = roots
        self._writes: Dict[str, Dict[bytes, Optional[bytes]]] = {
            name: {} for name in SUBTREES
        }
        # undo log for delta checkpoints: one (tree, key, prior-buffer-value)
        # entry per buffer mutation; `checkpoint` is a position in this list
        self._undo: List[Tuple[str, bytes, object]] = []

    # -- typed access --------------------------------------------------------
    def get(self, tree: str, key: bytes) -> Optional[bytes]:
        buf = self._writes[tree]
        if key in buf:
            return buf[key]
        return self._trie.get(getattr(self.base, tree), key)

    def put(self, tree: str, key: bytes, value: bytes) -> None:
        buf = self._writes[tree]
        self._undo.append((tree, key, buf.get(key, Snapshot._ABSENT)))
        buf[key] = value

    def delete(self, tree: str, key: bytes) -> None:
        buf = self._writes[tree]
        self._undo.append((tree, key, buf.get(key, Snapshot._ABSENT)))
        buf[key] = None

    def freeze(self, workers: Optional[int] = None, stream=None) -> StateRoots:
        """Flush buffered writes -> new immutable roots (Approve). Bulk
        application: each shared internal node rebuilds once per freeze
        instead of once per key (Trie.apply_many; root bit-identical to
        the sequential replay for any worker count). `stream` forwards
        each completed subtrie's node batch to the caller as it finishes
        (StateManager.freeze_and_commit overlaps the WAL fsync with it)."""
        new_roots = {}
        for name in SUBTREES:
            new_roots[name] = self._trie.apply_many(
                getattr(self.base, name),
                self._writes[name],
                workers=workers,
                stream=stream,
            )
        return StateRoots(**new_roots)

    def discard(self) -> None:
        """Rollback: drop buffered writes (outstanding checkpoints die too)."""
        for name in SUBTREES:
            self._writes[name].clear()
        self._undo.clear()

    def checkpoint(self) -> int:
        """Mark the current buffer state for per-tx rollback (role of the
        reference's per-tx snapshot/approve/rollback loop,
        BlockManager.cs:371-560). O(1): the token is a position in the
        undo log — the old implementation deep-copied every buffered tree
        dict, which at 10k txs/block made per-tx checkpointing quadratic
        in block size. Checkpoints are LIFO: restoring an older token
        invalidates every younger one (both users — the per-tx loop in
        core/execution.py and the per-frame VM rollback in vm/vm.py —
        already nest strictly)."""
        return len(self._undo)

    def restore(self, cp: int) -> None:
        """Rewind the write buffer to a checkpoint token by popping the
        undo log back to its position; cost is O(writes since the
        checkpoint), not O(total buffered state)."""
        undo = self._undo
        writes = self._writes
        while len(undo) > cp:
            tree, key, prior = undo.pop()
            if prior is Snapshot._ABSENT:
                del writes[tree][key]
            else:
                writes[tree][key] = prior


class StateManager:
    """Committed-chain state keeper
    (reference: State/StateManager.cs + SnapshotIndexRepository.cs:1-104)."""

    # streamed-commit knobs: pending buffers smaller than stream_threshold
    # take the classic single-batch path (batch-splitting overhead isn't
    # worth it, and the crash-matrix workloads — which count write_batch
    # traversals as coordinates — stay on exactly one batch per commit);
    # larger ones ship in _STREAM_BATCH-item async WAL records
    stream_threshold = 4096
    _STREAM_BATCH = 4096

    def __init__(self, kv: KVStore):
        self._kv = kv
        self.trie = Trie(kv)
        self._committed: StateRoots = self._load_latest()
        # last commit's profile (streamed batches, fsync-wait seconds) for
        # the bench's commit-phase breakdown
        self.commit_stats: Dict[str, float] = {}

    # -- tiers ---------------------------------------------------------------
    @property
    def committed(self) -> StateRoots:
        return self._committed

    def new_snapshot(self, base: Optional[StateRoots] = None) -> Snapshot:
        return Snapshot(self.trie, base or self._committed)

    def _root_rows(self, height: int, roots: StateRoots) -> list:
        return [
            (
                prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(height)),
                roots.encode(),
            ),
            (prefixed(EntryPrefix.BLOCK_HEIGHT), write_u64(height)),
        ]

    def commit(self, height: int, roots: StateRoots) -> None:
        """Persist roots as the canonical state for `height` (checkpoint —
        every block is a checkpoint).

        Durability ordering invariant (both paths): NODES ARE NEVER
        DURABLE LATER THAN A ROOT RECORD REFERENCING THEM. Small pending
        buffers land in one atomic fsynced batch with the root index.
        Large ones stream as async WAL-record chunks that overlap each
        other's fsync, and the root rows go in a LAST synchronous batch
        after an explicit barrier — a crash mid-stream leaves only
        orphan content-addressed nodes (no root record): fsck-clean,
        replay recommits them, shrink reclaims them."""
        nodes = self.trie.peek_pending()
        root_rows = self._root_rows(height, roots)
        streamed = 0
        t0 = time.perf_counter()
        if (
            getattr(self._kv, "supports_async_batches", False)
            and len(nodes) >= self.stream_threshold
        ):
            ticket = None
            for i in range(0, len(nodes), self._STREAM_BATCH):
                ticket = self._kv.write_batch_async(
                    nodes[i : i + self._STREAM_BATCH]
                )
                streamed += 1
                crash_point("trie.merkle.subtree_streamed")
            # the WAL is append-ordered, so the final batch's ack would
            # already imply these; the explicit barrier keeps the invariant
            # independent of that engine detail
            self._kv.write_barrier(ticket)
            self._kv.write_batch(root_rows)
        else:
            self._kv.write_batch(nodes + root_rows)
        # only after the batch is durable: a failed write_batch must keep
        # the buffer (it holds the only copy of the nodes)
        self.trie.confirm_pending(nodes)
        self._committed = roots
        self.commit_stats = {
            "wal_fsync_s": time.perf_counter() - t0,
            "streamed_batches": streamed,
            "nodes": len(nodes),
        }

    def freeze_and_commit(
        self, height: int, snap: Snapshot, workers: Optional[int] = None
    ) -> StateRoots:
        """Freeze + commit with full fsync overlap: each subtrie's node
        batch is submitted to the WAL writer AS ITS WORKER FINISHES, so
        the disk absorbs completed subtries while the remaining ones are
        still hashing. The root-referencing rows are written LAST, in a
        synchronous batch behind a barrier — same ordering invariant as
        commit(). Engines without async batches just freeze-then-commit."""
        kv = self._kv
        if not (
            getattr(kv, "supports_async_batches", False)
            and sum(len(w) for w in snap._writes.values())
            >= self.stream_threshold
        ):
            roots = snap.freeze(workers=workers)
            self.commit(height, roots)
            return roots

        streamed_keys: set = set()
        tickets: list = []
        fsync_wait = [0.0]

        def stream(items):
            t0 = time.perf_counter()
            tickets.append(kv.write_batch_async(items))
            fsync_wait[0] += time.perf_counter() - t0
            streamed_keys.update(k for k, _ in items)
            crash_point("trie.merkle.subtree_streamed")

        roots = snap.freeze(workers=workers, stream=stream)
        nodes = self.trie.peek_pending()
        remaining = [(k, v) for k, v in nodes if k not in streamed_keys]
        t0 = time.perf_counter()
        if tickets:
            kv.write_barrier(tickets[-1])
        kv.write_batch(remaining + self._root_rows(height, roots))
        self.trie.confirm_pending(nodes)
        self._committed = roots
        self.commit_stats = {
            "wal_fsync_s": fsync_wait[0] + time.perf_counter() - t0,
            "streamed_batches": len(tickets),
            "nodes": len(nodes),
        }
        return roots

    def roots_at(self, height: int) -> Optional[StateRoots]:
        enc = self._kv.get(prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(height)))
        return StateRoots.decode(enc) if enc else None

    def rollback_to(self, height: int) -> StateRoots:
        """Restore an older checkpoint (reference --RollBackTo,
        Application.cs:119-127)."""
        roots = self.roots_at(height)
        if roots is None:
            raise KeyError(f"no snapshot at height {height}")
        self._kv.put(prefixed(EntryPrefix.BLOCK_HEIGHT), write_u64(height))
        self._committed = roots
        return roots

    def committed_height(self) -> Optional[int]:
        enc = self._kv.get(prefixed(EntryPrefix.BLOCK_HEIGHT))
        return Reader(enc).u64() if enc else None

    def _load_latest(self) -> StateRoots:
        h = self.committed_height()
        if h is None:
            return StateRoots()
        roots = self.roots_at(h)
        return roots if roots is not None else StateRoots()
