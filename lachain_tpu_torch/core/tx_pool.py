"""Transaction pool (mempool).

The port's copy of `lachain_tpu/core/tx_pool.py`, with the same persisted
rows (`POOL_TX` + tx hash -> the signed transaction):
  * add: signature check + nonce bookkeeping + persistence, with the crash
    point `pool.save.mid` between the admission and the row
  * peek: fee-ordered proposal sampling with per-sender nonce continuity,
    randomized by the caller's seeded rng
  * restore from the persisted rows on startup; sanitize and eviction of
    included or stale transactions

Admission is SHARDED: the pool's maps are split across `_N_SHARDS`
independent lock domains keyed by the sender address, so concurrent
`add()` calls only serialize when two transactions share a sender shard.
The sender recovery runs outside every lock; a node's bulk ingest warms
the senders in one batch on the card first (`precheck`, then
`types.warm_sender_caches`, then `add`), so `add` only reads its cache.

Lock ordering: shard lock -> `_nonce_lock` (state-trie nonce reads; the
trie's LRU cache is not thread-safe). No path acquires two shard locks
at once, so there is no cross-shard ordering to get wrong.

As in the reference, the wait for a shard's lock is the histogram
`txpool_admit_lock_wait_seconds`, and an admitted transaction is stamped
"pool" (utils/txtrace.py) after the lock is released; no result depends
on them.
"""
from __future__ import annotations

import heapq
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..storage.crashpoints import crash_point
from ..storage.kv import EntryPrefix, KVStore, prefixed
from .types import SignedTransaction
from ..utils import metrics, txtrace

# a shard lock's wait: uncontended ~1 us, contended up to a batch's work
_LOCK_WAIT_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)

_N_SHARDS = 16


class _PoolShard:
    """One lock domain: the slice of the pool whose senders hash here."""

    __slots__ = ("lock", "txs", "senders", "by_nonce")

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.txs: Dict[bytes, SignedTransaction] = {}
        self.senders: Dict[bytes, bytes] = {}  # tx hash -> sender
        # (sender, nonce) -> tx hash (reference TransactionHashTrackerByNonce)
        self.by_nonce: Dict[Tuple[bytes, int], bytes] = {}


class TransactionPool:
    def __init__(
        self,
        kv: KVStore,
        chain_id: int,
        account_nonce: Callable[[bytes], int],
        min_gas_price: int = 1,
    ):
        self._kv = kv
        self.chain_id = chain_id
        self._account_nonce_fn = account_nonce
        self.min_gas_price = min_gas_price
        self._shards = [_PoolShard() for _ in range(_N_SHARDS)]
        # state-trie nonce reads go through the trie's LRU cache, which is
        # not safe under concurrent mutation — serialize them
        self._nonce_lock = threading.Lock()

    def _shard(self, sender: bytes) -> _PoolShard:
        return self._shards[sender[0] % _N_SHARDS]

    def _account_nonce(self, sender: bytes) -> int:
        with self._nonce_lock:
            return self._account_nonce_fn(sender)

    def __len__(self) -> int:
        return sum(len(s.txs) for s in self._shards)

    # -- ingress --------------------------------------------------------------
    def precheck(self, stx: SignedTransaction) -> bool:
        """The cheap admission checks only (dedup + gas floor) — no
        signature recovery. Bulk-ingest callers filter through this BEFORE
        paying for batch sender recovery, so re-gossiped duplicates cost a
        hash lookup, not an ECDSA recover. Advisory by design (add()
        re-checks under the shard lock), so the dict probes run lock-free."""
        if stx.tx.gas_price < self.min_gas_price:
            return False
        h = stx.hash()
        return all(h not in s.txs for s in self._shards)

    def add(self, stx: SignedTransaction) -> bool:
        """Verify + admit. Returns False (and drops) on any rule violation."""
        h = stx.hash()
        if stx.tx.gas_price < self.min_gas_price:
            return False
        if any(h in s.txs for s in self._shards):
            return False  # lock-free dedup; re-checked under the shard lock
        # ECDSA recovery is the expensive step — outside every lock
        sender = stx.sender(self.chain_id)
        if sender is None:
            return False
        shard = self._shard(sender)
        t0 = time.perf_counter()
        with shard.lock:
            metrics.observe_hist(
                "txpool_admit_lock_wait_seconds",
                time.perf_counter() - t0,
                buckets=_LOCK_WAIT_BUCKETS,
            )
            if h in shard.txs:
                return False
            current = self._account_nonce(sender)
            if stx.tx.nonce < current:
                return False  # already used
            key = (sender, stx.tx.nonce)
            if key in shard.by_nonce:
                # replacement only for strictly higher fee
                old = shard.txs.get(shard.by_nonce[key])
                if old is not None and stx.tx.gas_price <= old.tx.gas_price:
                    return False
                self._evict_in_shard(shard, shard.by_nonce[key])
            shard.txs[h] = stx
            shard.senders[h] = sender
            shard.by_nonce[key] = h
            # the pool's crash window: admitted to memory, not yet in the
            # crash-restore repository — a kill here loses the tx from the
            # restart (best-effort by design; gossip re-fills)
            crash_point("pool.save.mid")
            self._kv.put(prefixed(EntryPrefix.POOL_TX, h), stx.encode())
        # outside the shard lock: sampled transactions only, and the first
        # stamp wins across re-admissions
        txtrace.stamp(h, "pool")
        return True

    # -- proposal --------------------------------------------------------------
    def next_nonce(self, sender: bytes) -> int:
        """Next usable nonce for `sender`: the account nonce advanced past
        any consecutive pending transactions already in the pool."""
        shard = self._shard(sender)
        with shard.lock:
            nonce = self._account_nonce(sender)
            while (sender, nonce) in shard.by_nonce:
                nonce += 1
            return nonce

    def peek(
        self,
        max_txs: int,
        rng: Optional["random.Random"] = None,
        window_txs: Optional[int] = None,
        exclude: Optional[Set[bytes]] = None,
        nonce_override: Optional[Dict[bytes, int]] = None,
    ) -> List[SignedTransaction]:
        """Fee-ordered proposal with per-sender nonce continuity.

        With `rng`, the proposal is a RANDOM sample from a fee-ordered
        window of up to `window_txs` executable txs (the reference's
        RandomSamplingQueue role, Containers/RandomSamplingQueue.cs):
        HoneyBadger blocks carry the UNION of n proposals, so diversity
        across validators — not identical top-fee picks — is what fills
        blocks. The window must therefore span a whole BLOCK's worth of
        txs, not one proposal's worth: n validators sampling 4*max_txs
        txs can union to at most 4*max_txs distinct entries. Sampling
        keeps per-sender nonce chains contiguous by sampling SENDERS,
        then taking their chain prefixes.

        `exclude` / `nonce_override` are the pipelined-proposal overlay:
        when proposing on top of in-flight (decided but uncommitted) blocks,
        the caller masks txs already claimed by those blocks and advances
        the per-sender chain start past their nonces — state reads still
        see the committed trie, which is exactly the sequential outcome
        once the in-flight blocks land."""
        if rng is not None:
            window = self._peek_ordered_with_senders(
                window_txs if window_txs is not None else 4 * max_txs,
                exclude=exclude,
                nonce_override=nonce_override,
            )
            if len(window) > max_txs:
                by_sender: Dict[bytes, List[SignedTransaction]] = {}
                order: List[bytes] = []
                for s, stx in window:
                    if s not in by_sender:
                        by_sender[s] = []
                        order.append(s)
                    by_sender[s].append(stx)
                rng.shuffle(order)
                picked: List[SignedTransaction] = []
                for s in order:
                    take = min(len(by_sender[s]), max_txs - len(picked))
                    picked.extend(by_sender[s][:take])
                    if len(picked) >= max_txs:
                        break
                return picked
            return [stx for _, stx in window]
        return self._peek_ordered(
            max_txs, exclude=exclude, nonce_override=nonce_override
        )

    def _snapshot(self) -> List[Tuple[bytes, bytes, SignedTransaction]]:
        """(hash, sender, tx) triples — each shard copied under its own
        lock, the union processed lock-free by the caller."""
        out: List[Tuple[bytes, bytes, SignedTransaction]] = []
        for shard in self._shards:
            with shard.lock:
                out.extend(
                    (h, shard.senders[h], stx) for h, stx in shard.txs.items()
                )
        return out

    def _peek_ordered(
        self,
        max_txs: int,
        exclude: Optional[Set[bytes]] = None,
        nonce_override: Optional[Dict[bytes, int]] = None,
    ) -> List[SignedTransaction]:
        return [
            stx
            for _, stx in self._peek_ordered_with_senders(
                max_txs, exclude=exclude, nonce_override=nonce_override
            )
        ]

    def _peek_ordered_with_senders(
        self,
        max_txs: int,
        exclude: Optional[Set[bytes]] = None,
        nonce_override: Optional[Dict[bytes, int]] = None,
    ) -> List[Tuple[bytes, SignedTransaction]]:
        per_sender: Dict[bytes, List[SignedTransaction]] = {}
        for h, sender, stx in self._snapshot():
            if exclude is not None and h in exclude:
                continue  # claimed by an in-flight block
            per_sender.setdefault(sender, []).append(stx)
        # per-sender executable chains, nonce-ascending
        chains: Dict[bytes, List[SignedTransaction]] = {}
        for sender, txs in per_sender.items():
            txs.sort(key=lambda t: t.tx.nonce)
            if nonce_override is not None and sender in nonce_override:
                nonce = nonce_override[sender]
            else:
                nonce = self._account_nonce(sender)
            chain = []
            for t in txs:
                if t.tx.nonce != nonce:
                    break  # gap: later nonces are unexecutable
                chain.append(t)
                nonce += 1
            if chain:
                chains[sender] = chain
        # repeatedly take the highest-fee among the next-executable txs,
        # so a cheap prerequisite nonce never strands an expensive later
        # one (chain heads advance as they are picked). Heap keys are
        # precomputed — one hash per tx, not per comparison.
        def heap_key(stx: SignedTransaction):
            h = stx.hash()
            return (-stx.tx.gas_price, bytes(255 - b for b in h))

        picked: List[Tuple[bytes, SignedTransaction]] = []
        heap = [(heap_key(chain[0]), s, 0) for s, chain in chains.items()]
        heapq.heapify(heap)
        while len(picked) < max_txs and heap:
            _, s, i = heapq.heappop(heap)
            picked.append((s, chains[s][i]))
            if i + 1 < len(chains[s]):
                heapq.heappush(heap, (heap_key(chains[s][i + 1]), s, i + 1))
        return picked

    # -- lifecycle --------------------------------------------------------------
    def remove_included(self, tx_hashes) -> None:
        for h in tx_hashes:
            self._evict(h)

    def sanitize(self) -> int:
        """Drop txs whose nonce is now stale (reference sanitize-on-persist,
        TransactionPool.cs:79-90). Returns number evicted."""
        n = 0
        for shard in self._shards:
            with shard.lock:
                stale = [
                    h
                    for h, stx in shard.txs.items()
                    if stx.tx.nonce < self._account_nonce(shard.senders[h])
                ]
                for h in stale:
                    self._evict_in_shard(shard, h)
                n += len(stale)
        return n

    def restore(self) -> int:
        """Reload persisted pool txs (reference Restore, TransactionPool.cs:98)."""
        count = 0
        for key, enc in self._kv.scan_prefix(prefixed(EntryPrefix.POOL_TX)):
            try:
                stx = SignedTransaction.decode(enc)
            except (ValueError, AssertionError):
                self._kv.delete(key)
                continue
            if self.add(stx):
                count += 1
            else:
                # rejected on re-admission (stale nonce, fee floor, ...):
                # drop the persisted entry or it is re-read every restart
                self._kv.delete(key)
        return count

    def _evict(self, h: bytes) -> None:
        # hash alone does not name the shard — probe each, one lock at a
        # time (never nested, so shard locks stay unordered)
        for shard in self._shards:
            with shard.lock:
                if h in shard.txs:
                    self._evict_in_shard(shard, h)
                    return
        self._kv.delete(prefixed(EntryPrefix.POOL_TX, h))

    def _evict_in_shard(self, shard: _PoolShard, h: bytes) -> None:
        """Caller holds shard.lock."""
        stx = shard.txs.pop(h, None)
        sender = shard.senders.pop(h, None)
        if stx is not None and sender is not None:
            shard.by_nonce.pop((sender, stx.tx.nonce), None)
        self._kv.delete(prefixed(EntryPrefix.POOL_TX, h))

    def tx_hashes(self) -> set:
        """Snapshot of pooled tx hashes (pending-tx filters)."""
        out = set()
        for shard in self._shards:
            with shard.lock:
                out.update(shard.txs)
        return out

    def clear(self) -> None:
        """Drop every pooled tx, memory AND persisted entries (reference
        clearInMemoryPool + repository delete, TransactionPool.cs)."""
        for shard in self._shards:
            with shard.lock:
                for h in list(shard.txs):
                    self._evict_in_shard(shard, h)

    def persisted_hashes(self) -> List[bytes]:
        """Hashes of txs currently saved in the crash-restore repository."""
        plen = len(prefixed(EntryPrefix.POOL_TX))
        return [
            key[plen:]
            for key, _ in self._kv.scan_prefix(prefixed(EntryPrefix.POOL_TX))
        ]

    def clear_persisted(self) -> int:
        """Wipe the crash-restore repository WITHOUT touching the live pool
        (reference deleteTransactionPoolRepository)."""
        n = 0
        for key, _ in list(
            self._kv.scan_prefix(prefixed(EntryPrefix.POOL_TX))
        ):
            self._kv.delete(key)
            n += 1
        return n

    def get(self, h: bytes) -> Optional[SignedTransaction]:
        for shard in self._shards:
            stx = shard.txs.get(h)
            if stx is not None:
                return stx
        return None
