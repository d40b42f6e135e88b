"""Content-addressed 16-ary Merkle trie: the authenticated state store.

The port of `lachain_tpu/storage/trie.py`, node for node: 16-ary
branching over the nibbles of keccak256(key), nodes stored by the hash of
their canonical encoding (so every root is a free, immutable snapshot and
rollback is dropping a value), an LRU node cache, the deferred
level-batched hashing and the subtrie-sharded workers of `apply_many`. A
root, a node's bytes and the KV rows equal the JAX package's for the same
writes.

Hashing goes through the port's host library: a single key or node in one
`hashes.keccak256_host` call, a batch (the keys of an `apply_many`, each
level of deferred nodes) in one `hashes.keccak256_batch` call, threaded in
C++. Without the library they raise; there is no per-item fallback.

The reference's metrics are minted under its names: the histogram
`trie_keccak_batch_size` (each level's batch), the counter
`trie_nodes_hashed_total` and the gauge `trie_merkle_workers`; the plain
attribute `merkle_stats`, which chip_smoke.py reads, accumulates beside
them.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..crypto.hashes import keccak256_batch, keccak256_host as keccak256
from ..utils import metrics
from ..utils.serialization import Reader, write_bytes, write_u16
from .kv import EntryPrefix, KVStore, prefixed

EMPTY_ROOT = b"\x00" * 32
_NIBBLES = 64  # keccak256 -> 64 nibbles

# batch-size floors for the two merkleization fast paths: below them the
# bookkeeping costs more than the per-node keccak dispatch it saves
MIN_DEFER_OPS = 32    # deferred level-batched hashing
MIN_SHARD_OPS = 512   # subtrie-sharded workers
# the sizes of the keccak batches a level of deferred nodes makes
_KECCAK_BATCH_BUCKETS = (16, 64, 256, 1024, 4096, 16384, 65536)


def resolve_merkle_workers(n: int) -> int:
    """Merkle worker knob -> effective count: 0 = auto (host cores, capped
    at the 16-way subtrie fanout), N pins it. 1 disables sharding but
    keeps deferred batch hashing (the single-core win)."""
    n = int(n)
    if n > 0:
        return min(n, 16)
    return min(os.cpu_count() or 1, 16)


def _nibble(h: bytes, depth: int) -> int:
    byte = h[depth // 2]
    return (byte >> 4) if depth % 2 == 0 else (byte & 0x0F)


def _group_by_nibble(pairs, depth: int) -> Dict[int, list]:
    """Partition (kh, ...) pairs by their nibble at `depth` — the one
    grouping rule both bulk paths share (canonical structure depends on
    the two staying identical)."""
    groups: Dict[int, list] = {}
    for kh, v in pairs:
        groups.setdefault(_nibble(kh, depth), []).append((kh, v))
    return groups


@dataclass(frozen=True)
class LeafNode:
    key_hash: bytes  # full 32-byte hashed key
    value: bytes

    def encode(self) -> bytes:
        return b"L" + self.key_hash + write_bytes(self.value)


@dataclass(frozen=True)
class InternalNode:
    # 16 child hashes (EMPTY_ROOT = no child) — mask+list on the wire like the
    # reference's children-mask encoding (InternalNode.cs)
    children: Tuple[bytes, ...]

    def encode(self) -> bytes:
        mask = 0
        present = []
        for i, c in enumerate(self.children):
            if c != EMPTY_ROOT:
                mask |= 1 << i
                present.append(c)
        return b"I" + write_u16(mask) + b"".join(present)


def _decode(data: bytes):
    if data[0:1] == b"L":
        r = Reader(data[33:])
        return LeafNode(key_hash=data[1:33], value=r.bytes_())
    if data[0:1] == b"I":
        mask = int.from_bytes(data[1:3], "big")
        children = []
        off = 3
        for i in range(16):
            if mask & (1 << i):
                children.append(data[off : off + 32])
                off += 32
            else:
                children.append(EMPTY_ROOT)
        return InternalNode(tuple(children))
    raise ValueError("bad trie node encoding")


class _DeferredHasher:
    """Deferred-hash node sink for bulk merkleization: while armed on a
    Trie, `_store` hands out a 9-byte placeholder token instead of hashing
    the node. `Trie._resolve_deferred` then encodes the accumulated nodes
    level-by-level bottom-up, hashes each level's encodings in ONE native
    batch call (crypto.hashes.keccak256_batch) and patches child
    references — collapsing ~one Python→C keccak crossing per node into
    one per tree level (~6 for a 100k-node block).

    Token contract (what keeps `_bulk`'s no-op short-circuits and the
    collapse rules bit-identical to the immediate-hash path): a token is
    never equal to a real 32-byte hash, to EMPTY_ROOT, or to a different
    token, and tokens are handed out only for genuinely stored nodes — so
    `children == list(node.children)` still means exactly "nothing changed
    under this branch"."""

    __slots__ = ("nodes", "levels", "buckets", "count")
    PREFIX = 0xFE

    def __init__(self):
        self.nodes: Dict[bytes, object] = {}  # token -> node (for _load)
        self.levels: Dict[bytes, int] = {}  # token -> bottom-up level
        # per-level (tokens, nodes) parallel lists — the batch-hash units
        self.buckets: List[Tuple[List[bytes], List[object]]] = []
        self.count = 0

    def store(self, node) -> bytes:
        # HOT: once per stored node. The level is known right here —
        # children are always stored before their parent — so computing
        # it now saves _resolve_deferred a whole extra pass. b"\xfe" ==
        # PREFIX inlined; token child refs are the only 9-byte refs.
        token = b"\xfe" + self.count.to_bytes(8, "big")
        self.count += 1
        lvl = 0
        if type(node) is InternalNode:
            levels = self.levels
            for c in node.children:
                if len(c) == 9:
                    cl = levels[c]
                    if cl >= lvl:
                        lvl = cl + 1
        self.levels[token] = lvl
        self.nodes[token] = node
        buckets = self.buckets
        if lvl >= len(buckets):  # parents are at most one level above
            buckets.append(([], []))
        bt, bn = buckets[lvl]
        bt.append(token)
        bn.append(node)
        return token

    @staticmethod
    def is_token(h: bytes) -> bool:
        # real node hashes are 32 bytes; tokens are 9
        return len(h) == 9 and h[0] == _DeferredHasher.PREFIX


class Trie:
    """Handle over a KV store; every mutation returns a NEW root hash.

    Node writes are WRITE-BACK buffered: _store fills `_pending` instead of
    issuing a kv.put (which on SqliteKV is an fsynced autocommit — ~40us
    PER NODE, 100k nodes per 10k-tx block). StateManager.commit drains the
    buffer into the same atomic write_batch that persists the roots, so
    nodes are never durable later than a root referencing them — strictly
    better crash ordering than the old eager puts (which leaked orphan
    nodes from uncommitted emulations onto disk)."""

    def __init__(self, kv: KVStore, cache_size: int = 65536):
        self._kv = kv
        self._cache: OrderedDict[bytes, object] = OrderedDict()
        self._cache_size = cache_size
        self._pending: Dict[bytes, bytes] = {}  # prefixed key -> encoding
        # read-only view of a parent trie's node cache (see fork()); never
        # mutated through this handle
        self._read_cache: Optional[OrderedDict] = None
        # read-only view of a parent trie's PENDING buffer (_shard_fork):
        # a shard worker starts with an empty buffer of its own, so its
        # new nodes are exactly `_pending` after the run — no diffing
        self._read_pending: Optional[Dict[bytes, bytes]] = None
        # armed deferred-hash sink (apply_many bulk paths only)
        self._defer: Optional[_DeferredHasher] = None
        # merkle worker knob (config execution.merkleWorkers): 0 = auto
        self.merkle_workers: int = 0
        # accumulated apply_many profile (reset_merkle_stats() to zero),
        # for the commit-phase bench breakdown
        self.merkle_stats: Dict[str, float] = {}

    # -- node io -------------------------------------------------------------
    def _store(self, node) -> bytes:
        if self._defer is not None:
            return self._defer.store(node)
        enc = node.encode()
        h = keccak256(enc)
        self._pending[prefixed(EntryPrefix.TRIE_NODE, h)] = enc
        self._cache_put(h, node)
        return h

    def _load(self, h: bytes):
        if self._defer is not None and _DeferredHasher.is_token(h):
            return self._defer.nodes[h]
        node = self._cache.get(h)
        if node is not None:
            self._cache.move_to_end(h)
            return node
        if self._read_cache is not None:
            # forked handle: peek the parent's cache WITHOUT touching its
            # LRU order (move_to_end is what makes the parent cache unsafe
            # to share between threads; a bare get is a single C-level dict
            # read, and the parent thread is quiescent while forks run)
            node = self._read_cache.get(h)
            if node is not None:
                self._cache_put(h, node)
                return node
        key = prefixed(EntryPrefix.TRIE_NODE, h)
        enc = self._pending.get(key)
        if enc is None and self._read_pending is not None:
            enc = self._read_pending.get(key)
        if enc is None:
            enc = self._kv.get(key)
        if enc is None:
            raise KeyError(f"missing trie node {h.hex()}")
        node = _decode(enc)
        self._cache_put(h, node)
        return node

    def peek_pending(self) -> List[Tuple[bytes, bytes]]:
        """The buffered node writes, for the caller's write_batch. Includes
        nodes from discarded emulations (the eager-write design persisted
        those too; shrink reclaims them). The buffer is NOT cleared here —
        call confirm_pending with these items only after the batch is
        durable, so a failed commit keeps the sole copy of the nodes."""
        return list(self._pending.items())

    def confirm_pending(self, items: List[Tuple[bytes, bytes]]) -> None:
        """Drop buffered writes that a successful write_batch persisted."""
        for k, _ in items:
            self._pending.pop(k, None)

    def export_pending(self) -> Dict[bytes, bytes]:
        """Snapshot of the buffered node writes, for replaying into another
        trie over the SAME chain (cross-validator emulation sharing): nodes
        are content-addressed, so absorbing a snapshot taken after an
        identical state transition hands the consumer exactly the nodes its
        own freeze would have buffered."""
        return dict(self._pending)

    def absorb_pending(self, nodes: Dict[bytes, bytes]) -> None:
        """Adopt another trie's exported node buffer (see export_pending).
        Re-absorbing an already-persisted node is harmless — same key, same
        encoding — it just rides the next commit batch again."""
        self._pending.update(nodes)

    def fork(self) -> "Trie":
        """A private handle over the SAME kv for a concurrent reader
        (parallel execution lanes): its own LRU cache and pending buffer
        (seeded with ours — forked roots may reference not-yet-committed
        nodes), plus a read-only peek into our cache so a fork does not
        start cold. The fork is disposable: nodes it stores stay in its
        own pending buffer and are simply dropped with it (lane-local
        speculative state never rides a commit batch)."""
        t = Trie(self._kv, self._cache_size)
        t._pending = dict(self._pending)
        t._read_cache = self._cache
        return t

    def _shard_fork(self) -> "Trie":
        """A worker handle for subtrie-sharded merkleization: like fork(),
        but the pending buffer starts EMPTY and chains read-only over ours
        (copying 100k inherited entries per worker would eat the win). The
        worker's newly stored nodes are exactly its `_pending`, which the
        caller absorbs — unlike lane forks, shard results are canonical."""
        t = Trie(self._kv, self._cache_size)
        t._read_cache = self._cache
        t._read_pending = self._pending
        return t

    def clear_cache(self) -> None:
        self._cache.clear()

    def _cache_put(self, h: bytes, node) -> None:
        self._cache[h] = node
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)

    # -- public api ----------------------------------------------------------
    def get(self, root: bytes, key: bytes) -> Optional[bytes]:
        if root == EMPTY_ROOT:
            return None
        kh = keccak256(key)
        node_hash = root
        depth = 0
        while True:
            node = self._load(node_hash)
            if isinstance(node, LeafNode):
                return node.value if node.key_hash == kh else None
            nxt = node.children[_nibble(kh, depth)]
            if nxt == EMPTY_ROOT:
                return None
            node_hash = nxt
            depth += 1

    def put(self, root: bytes, key: bytes, value: bytes) -> bytes:
        kh = keccak256(key)
        return self._put_hashed(root, kh, value, 0)

    def _put_hashed(self, node_hash: bytes, kh: bytes, value: bytes, depth: int) -> bytes:
        if node_hash == EMPTY_ROOT:
            return self._store(LeafNode(kh, value))
        node = self._load(node_hash)
        if isinstance(node, LeafNode):
            if node.key_hash == kh:
                return self._store(LeafNode(kh, value))
            # split: push the existing leaf down until paths diverge
            children = [EMPTY_ROOT] * 16
            old_nib = _nibble(node.key_hash, depth)
            new_nib = _nibble(kh, depth)
            if old_nib == new_nib:
                sub = self._put_hashed(
                    self._store(node), kh, value, depth + 1
                )
                children[old_nib] = sub
            else:
                children[old_nib] = self._store(node)
                children[new_nib] = self._store(LeafNode(kh, value))
            return self._store(InternalNode(tuple(children)))
        nib = _nibble(kh, depth)
        new_child = self._put_hashed(node.children[nib], kh, value, depth + 1)
        children = list(node.children)
        children[nib] = new_child
        return self._store(InternalNode(tuple(children)))

    def delete(self, root: bytes, key: bytes) -> bytes:
        kh = keccak256(key)
        new_root = self._del_hashed(root, kh, 0)
        return new_root if new_root is not None else root

    def _collapse_or_store(self, children) -> bytes:
        """Store an internal node, applying THE canonical collapse rule
        (single shared copy: the bulk and sequential paths must collapse
        identically or their roots diverge): an empty child set dissolves,
        a single live LEAF child replaces the branch."""
        live = [c for c in children if c != EMPTY_ROOT]
        if not live:
            return EMPTY_ROOT
        if len(live) == 1:
            only = self._load(live[0])
            if isinstance(only, LeafNode):
                return self._store(only)
        return self._store(InternalNode(tuple(children)))

    # -- bulk application ----------------------------------------------------
    # The tree is CANONICAL in its leaf set (inserts create internal chains
    # exactly along shared prefixes; deletes collapse single-leaf branches
    # all the way back up), so applying a batch bottom-up produces the same
    # root as replaying the keys one at a time — while rebuilding each
    # shared internal node ONCE per block instead of once per key. This is
    # the block-commit hot path: at N=64 the per-key replay was ~18% of the
    # whole simulated era.

    def apply_many(
        self,
        root: bytes,
        writes: Dict[bytes, Optional[bytes]],
        workers: Optional[int] = None,
        stream: Optional[Callable[[List[Tuple[bytes, bytes]]], None]] = None,
    ) -> bytes:
        """Apply a {key: value-or-None(delete)} batch; returns the new root
        (bit-identical to sequential put/delete in any order, for any
        worker count).

        Large batches take one of two fast paths, both exact:
          * deferred batch hashing (>= MIN_DEFER_OPS): nodes are encoded
            level-by-level bottom-up and each level is hashed in one
            threaded native keccak call;
          * subtrie sharding (>= MIN_SHARD_OPS and workers > 1): the op
            batch splits by top-level nibble, each subtrie runs on a
            worker over a _shard_fork() handle, and the root is assembled
            from the 16 child hashes on the caller thread.

        `workers` overrides the handle's merkle_workers knob (0 = auto).
        `stream`, when given, receives each completed subtrie's NEW
        (key, encoding) node items as workers finish — the fsync-overlap
        seam StateManager.freeze_and_commit plugs the WAL into."""
        if not writes:
            return root
        entries: Dict[bytes, Optional[bytes]] = dict(
            zip(keccak256_batch(list(writes)), writes.values())
        )
        ops = sorted(entries.items())
        nworkers = resolve_merkle_workers(
            self.merkle_workers if workers is None else workers
        )
        t0 = time.perf_counter()
        if nworkers > 1 and len(ops) >= MIN_SHARD_OPS and root != EMPTY_ROOT:
            node = self._load(root)
            if isinstance(node, InternalNode):
                return self._apply_sharded(
                    root, node, ops, nworkers, stream, t0
                )
        return self._apply_serial(root, ops, nworkers, stream, t0)

    def _apply_serial(self, root, ops, nworkers, stream, t0) -> bytes:
        """Single-walker bulk application; defers hashing into per-level
        native batch calls when the batch is big enough to pay for it."""
        if len(ops) < MIN_DEFER_OPS:
            new_root = self._bulk(root, ops, 0)
            self._set_merkle_stats(t0, 0.0, 0, 1)
            return new_root
        self._defer = _DeferredHasher()
        try:
            out = self._bulk(root, ops, 0)
        finally:
            defer, self._defer = self._defer, None
        resolved, hash_s, items = self._resolve_deferred(defer, nworkers)
        if _DeferredHasher.is_token(out):
            out = resolved[out]
        if stream is not None and items:
            stream(items)
        self._set_merkle_stats(t0, hash_s, len(items), 1)
        return out

    def _apply_sharded(
        self, root_hash, node, ops, nworkers, stream, t0
    ) -> bytes:
        """Subtrie-sharded merkleization over the 16-way top-level fanout.
        Each worker owns an independent subtrie (disjoint key ranges), so
        its node set is canonical regardless of scheduling; the caller
        thread replays the serial path's depth-0 step — per-nibble child
        patch, no-op short-circuit, collapse rule — over the 16 child
        hashes, which is what makes the root bit-identical to `_bulk`."""
        groups = _group_by_nibble(ops, 0)
        children = list(node.children)

        def run(nib: int, group) -> tuple:
            fork = self._shard_fork()
            fork._defer = _DeferredHasher()
            try:
                sub = fork._bulk(children[nib], group, 1)
            finally:
                defer, fork._defer = fork._defer, None
            # per-worker native hashing stays single-threaded: the
            # parallelism budget is already spent on the worker pool
            resolved, hash_s, items = fork._resolve_deferred(defer, 1)
            if _DeferredHasher.is_token(sub):
                sub = resolved[sub]
            return nib, sub, items, hash_s

        results: Dict[int, bytes] = {}
        hash_s = 0.0
        hashed = 0
        with ThreadPoolExecutor(
            max_workers=min(nworkers, len(groups)),
            thread_name_prefix="merkle",
        ) as pool:
            futs = [
                pool.submit(run, nib, group)
                for nib, group in sorted(groups.items())
            ]
            # absorb/stream in COMPLETION order: a finished subtrie's node
            # batch can hit the WAL while its siblings are still hashing
            pending_futs = set(futs)
            while pending_futs:
                done, pending_futs = wait(
                    pending_futs, return_when=FIRST_EXCEPTION
                )
                for fut in done:
                    nib, sub, items, worker_hash_s = fut.result()
                    results[nib] = sub
                    self._pending.update(items)
                    hash_s += worker_hash_s
                    hashed += len(items)
                    if stream is not None and items:
                        stream(items)
        for nib in groups:
            children[nib] = results[nib]
        if children == list(node.children):
            out = root_hash
        else:
            out = self._collapse_or_store(children)
        self._set_merkle_stats(t0, hash_s, hashed, min(nworkers, len(groups)))
        return out

    def _resolve_deferred(
        self, defer: _DeferredHasher, nthreads: int
    ) -> Tuple[Dict[bytes, bytes], float, List[Tuple[bytes, bytes]]]:
        """Hash a deferred sink's nodes level-by-level bottom-up through
        the native batch keccak, patching child tokens with the hashes of
        the level below. Returns (token -> hash, seconds spent hashing,
        new (prefixed key, encoding) items stored).

        HOT PATH: ~one iteration per node per 10k-tx block commit. Token
        tests are inlined as `len(c) == 9` (real child refs are always 32
        bytes) and leaves — the bulk of every batch — skip the patch
        machinery entirely; the Python bookkeeping here must stay well
        under the per-node ctypes crossing it saves, or deferral is a
        net loss at merkle_workers=1."""
        resolved: Dict[bytes, bytes] = {}
        items: List[Tuple[bytes, bytes]] = []
        hash_s = 0.0
        trie_node = int(EntryPrefix.TRIE_NODE).to_bytes(2, "big")
        pending = self._pending
        cache = self._cache
        for tokens, bnodes in defer.buckets:
            patched: List[object] = []
            for n in bnodes:
                if type(n) is InternalNode:
                    ch = n.children
                    for c in ch:
                        if len(c) == 9:
                            n = InternalNode(
                                tuple(
                                    [
                                        resolved[c] if len(c) == 9 else c
                                        for c in ch
                                    ]
                                )
                            )
                            break
                patched.append(n)
            encs = [n.encode() for n in patched]
            h0 = time.perf_counter()
            hashes = keccak256_batch(encs, nthreads)
            hash_s += time.perf_counter() - h0
            metrics.observe_hist(  # lint-allow: metric-name dimensionless batch-size distribution
                "trie_keccak_batch_size",
                len(encs),
                buckets=_KECCAK_BATCH_BUCKETS,
            )
            # bulk C-level stores instead of a per-node interpreted loop
            keys = [trie_node + h for h in hashes]
            pairs = list(zip(keys, encs))
            pending.update(pairs)
            items.extend(pairs)
            resolved.update(zip(tokens, hashes))
            cache.update(zip(hashes, patched))
        # one bulk trim instead of per-put LRU churn (_cache_put does a
        # move_to_end + popitem dance per node; recency inside one batch
        # is meaningless anyway)
        while len(cache) > self._cache_size:
            cache.popitem(last=False)
        return resolved, hash_s, items

    def reset_merkle_stats(self) -> None:
        """Zero the accumulated apply_many profile (bench phase breakdowns
        call this before a timed section so the totals cover exactly it)."""
        self.merkle_stats = {}

    def _set_merkle_stats(
        self, t0: float, hash_s: float, nodes: int, workers: int
    ) -> None:
        # ACCUMULATES across apply_many calls: a Snapshot.freeze applies
        # one batch per subtree, and the commit-phase breakdown wants the
        # whole-freeze totals, not the last subtree's
        wall = time.perf_counter() - t0
        st = self.merkle_stats
        st["wall_s"] = st.get("wall_s", 0.0) + wall
        st["hash_s"] = st.get("hash_s", 0.0) + hash_s
        st["assemble_s"] = st.get("assemble_s", 0.0) + max(wall - hash_s, 0.0)
        st["nodes"] = int(st.get("nodes", 0)) + nodes
        st["workers"] = max(int(st.get("workers", 0)), workers)
        metrics.inc("trie_nodes_hashed_total", nodes)
        metrics.set_gauge("trie_merkle_workers", workers)

    def _bulk(self, node_hash: bytes, ops, depth: int) -> bytes:
        if not ops:
            return node_hash
        if node_hash == EMPTY_ROOT:
            leaves = [(kh, v) for kh, v in ops if v is not None]
            return self._build_subtree(leaves, depth)
        node = self._load(node_hash)
        if isinstance(node, LeafNode):
            merged = dict(ops)
            if node.key_hash not in merged:
                merged[node.key_hash] = node.value
            leaves = sorted(
                (kh, v) for kh, v in merged.items() if v is not None
            )
            if leaves == [(node.key_hash, node.value)]:
                return node_hash  # no-op batch over this leaf
            return self._build_subtree(leaves, depth)
        children = list(node.children)
        groups = _group_by_nibble(ops, depth)
        for nib, group in groups.items():
            children[nib] = self._bulk(children[nib], group, depth + 1)
        if children == list(node.children):
            # nothing changed under us (absent-key deletes / same-value
            # puts): a pure no-op, like sequential delete of a missing key
            return node_hash
        return self._collapse_or_store(children)

    def _build_subtree(self, leaves, depth: int) -> bytes:
        """Canonical subtree for sorted (kh, value) leaves on empty ground."""
        if not leaves:
            return EMPTY_ROOT
        if len(leaves) == 1:
            kh, v = leaves[0]
            return self._store(LeafNode(kh, v))
        children = [EMPTY_ROOT] * 16
        for nib, group in _group_by_nibble(leaves, depth).items():
            children[nib] = self._build_subtree(group, depth + 1)
        return self._store(InternalNode(tuple(children)))

    def _del_hashed(self, node_hash: bytes, kh: bytes, depth: int) -> Optional[bytes]:
        """Returns the new subtree hash, EMPTY_ROOT if emptied, or None if
        the key was absent (no change)."""
        if node_hash == EMPTY_ROOT:
            return None
        node = self._load(node_hash)
        if isinstance(node, LeafNode):
            return EMPTY_ROOT if node.key_hash == kh else None
        nib = _nibble(kh, depth)
        sub = self._del_hashed(node.children[nib], kh, depth + 1)
        if sub is None:
            return None
        children = list(node.children)
        children[nib] = sub
        return self._collapse_or_store(children)

    def iter_items(self, root: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """All (hashed_key, value) pairs under a root (ordered by key hash)."""
        if root == EMPTY_ROOT:
            return
        stack = [root]
        while stack:
            node = self._load(stack.pop())
            if isinstance(node, LeafNode):
                yield node.key_hash, node.value
            else:
                for c in reversed(node.children):
                    if c != EMPTY_ROOT:
                        stack.append(c)

    def node_count(self, root: bytes) -> int:
        if root == EMPTY_ROOT:
            return 0
        seen = set()
        stack = [root]
        while stack:
            h = stack.pop()
            if h in seen:
                continue
            seen.add(h)
            node = self._load(h)
            if isinstance(node, InternalNode):
                stack.extend(c for c in node.children if c != EMPTY_ROOT)
        return len(seen)
