"""Optimistic lane-parallel block execution (the block-STM shape).

The port of `lachain_tpu/core/parallel_exec.py`. The serial executor stays
the semantic oracle; this module adds an optimistic-concurrency path over
it:

  1. PLAN   — partition the canonically-ordered block into lanes by
     touched-account footprint (sender / recipient, union-find over the
     static footprint). Same-sender nonce chains share the sender address
     so they land in one lane by construction; every tx paying one
     recipient, or calling one system contract, coalesces the same way.
  2. RUN    — execute each lane concurrently against its own Snapshot
     over a forked Trie (Trie.fork: shared kv, private cache/pending),
     all based on the SAME immutable base StateRoots. A RecordingSnapshot
     logs, per tx, every externally-observed read (key -> value seen) and
     the tx's surviving write delta.
  3. MERGE  — walk the transactions back in canonical order against one
     merged snapshot on the main trie. A tx whose recorded reads all
     still match the merged state provably executed exactly as the serial
     oracle would have (execution is a deterministic function of the tx
     and its observed reads), so its recorded delta and receipt are taken
     verbatim. Any mismatch makes the tx a STRAGGLER: it re-executes
     serially on the merged snapshot at its canonical position — which IS
     serial execution for that tx.

Bit-identity argument: by induction over canonical index i, the merged
snapshot before tx_i equals the serial executor's state before tx_i.
Validated tx_i observed exactly the values the serial executor would
read, so its writes/receipt are the serial ones; a straggler literally
runs the serial executor. Hence receipts, the final write-set, the frozen
roots AND the trie node set are all bit-identical to the serial pass.
Each tx re-executes at most once, so a forced-100%-conflict workload
degrades to one serial pass plus the (wasted) lane pass.

Differences, by the port's rules: `execute_block_parallel` takes the
`device` its senders are recovered on (`types.warm_sender_caches`). The
reference's metrics are minted under its names (the gauges `exec_lanes`
and `exec_conflict_rate`, the counters `exec_txs_validated_total`,
`exec_txs_straggler_total` and `exec_blocks_parallel_total`); the same
numbers are in the returned `ParallelStats`.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..storage.state import Snapshot, StateManager, StateRoots
from ..utils import metrics
from .execution import TransactionExecuter
from .types import SignedTransaction, TransactionReceipt, warm_sender_caches

# lanes=0 in config means "auto": one lane per core, clamped — beyond 8
# lanes the merge walk and fork setup outweigh extra overlap
_AUTO_LANE_CAP = 8
# blocks smaller than this execute serially even when lanes are enabled:
# fork + merge overhead beats any overlap win on tiny blocks
MIN_PARALLEL_TXS = 32


def resolve_lanes(configured: int) -> int:
    """Map the execution.lanes knob to an effective lane count:
    1 pins serial, N>1 is explicit, 0 = auto (cores, capped)."""
    if configured >= 1:
        return configured
    return max(1, min(_AUTO_LANE_CAP, os.cpu_count() or 1))


class RecordingSnapshot(Snapshot):
    """Snapshot that records, per transaction, the read/write footprint
    the merge phase validates against.

    reads: (tree, key) -> value observed, recorded only when the value
      came from OUTSIDE the tx (base state or earlier same-lane txs) —
      reads of the tx's own live writes carry no external dependency.
    own:   (tree, key) -> live-write count; a count > 0 at end_tx means
      the tx left a net write on the key (rolled-back writes decay to 0
      through the undo hook below), and the key's final buffered value
      joins the delta.
    """

    def __init__(self, trie, roots: StateRoots):
        super().__init__(trie, roots)
        self._reads: Dict[Tuple[str, bytes], Optional[bytes]] = {}
        self._own: Dict[Tuple[str, bytes], int] = {}

    def begin_tx(self) -> None:
        self._reads = {}
        self._own = {}

    def end_tx(self):
        """-> (reads, delta): the validation footprint and the surviving
        buffer writes of the tx just executed."""
        writes = self._writes
        delta = [
            (tree, key, writes[tree][key])
            for (tree, key), live in self._own.items()
            if live > 0
        ]
        return self._reads, delta

    # -- recording overrides -------------------------------------------------
    def get(self, tree: str, key: bytes) -> Optional[bytes]:
        buf = self._writes[tree]
        if key in buf:
            v = buf[key]
        else:
            v = self._trie.get(getattr(self.base, tree), key)
        rk = (tree, key)
        if rk not in self._reads and not self._own.get(rk):
            # first externally-visible observation wins; later reads either
            # repeat it (pre-tx state is immutable during the tx) or see the
            # tx's own writes (no dependency)
            self._reads[rk] = v
        return v

    def put(self, tree: str, key: bytes, value: bytes) -> None:
        super().put(tree, key, value)
        rk = (tree, key)
        self._own[rk] = self._own.get(rk, 0) + 1

    def delete(self, tree: str, key: bytes) -> None:
        super().delete(tree, key)
        rk = (tree, key)
        self._own[rk] = self._own.get(rk, 0) + 1

    def restore(self, cp: int) -> None:
        # rolled-back writes must not count as live own-writes, or a
        # reverted tx would export a no-op delta that could clobber an
        # interleaved lane's write at merge time
        popped = self._undo[cp:]
        super().restore(cp)
        own = self._own
        for tree, key, _prior in popped:
            rk = (tree, key)
            live = own.get(rk, 0) - 1
            if live > 0:
                own[rk] = live
            else:
                own.pop(rk, None)


# -- lane planning ------------------------------------------------------------


def _footprint_groups(
    ordered: Sequence[SignedTransaction], chain_id: int
) -> List[bytes]:
    """Union-find over each tx's static account footprint (sender +
    recipient); returns each tx's resolved group root. Two txs share a
    group iff their footprints are transitively connected — the
    no-false-negative partition for the simple-transfer / system-contract
    surface (wasm cross-contract effects are caught by merge validation,
    not by planning)."""
    parent: Dict[bytes, bytes] = {}

    def find(a: bytes) -> bytes:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    tx_key: List[bytes] = []
    for stx in ordered:
        sender = stx.sender(chain_id)
        keys = [stx.tx.to] if sender is None else [sender, stx.tx.to]
        for k in keys:
            if k not in parent:
                parent[k] = k
        head = find(keys[0])
        for k in keys[1:]:
            r = find(k)
            if r != head:
                parent[r] = head
        tx_key.append(keys[0])
    return [find(k) for k in tx_key]


def plan_lanes(
    ordered: Sequence[SignedTransaction],
    chain_id: int,
    n_lanes: int,
    partition: Optional[Callable[[int, SignedTransaction], int]] = None,
) -> List[List[Tuple[int, SignedTransaction]]]:
    """Deterministic lane assignment for a canonically-ordered block:
    footprint groups packed greedily (largest first, ties by first
    appearance) onto the least-loaded lane; canonical order is preserved
    WITHIN each lane. `partition` overrides the group rule (tests use it
    to force conflicting txs apart)."""
    if n_lanes <= 1:
        return [list(enumerate(ordered))]
    lanes: List[List[Tuple[int, SignedTransaction]]] = [
        [] for _ in range(n_lanes)
    ]
    if partition is not None:
        for i, stx in enumerate(ordered):
            lanes[partition(i, stx) % n_lanes].append((i, stx))
        return lanes
    groups = _footprint_groups(ordered, chain_id)
    sizes: Dict[bytes, int] = {}
    first: Dict[bytes, int] = {}
    for i, g in enumerate(groups):
        sizes[g] = sizes.get(g, 0) + 1
        first.setdefault(g, i)
    load = [0] * n_lanes
    lane_of: Dict[bytes, int] = {}
    for g in sorted(sizes, key=lambda g: (-sizes[g], first[g])):
        lane = min(range(n_lanes), key=lambda l: load[l])
        lane_of[g] = lane
        load[lane] += sizes[g]
    for i, stx in enumerate(ordered):
        lanes[lane_of[groups[i]]].append((i, stx))
    return lanes


# -- execution ----------------------------------------------------------------


@dataclass
class ParallelStats:
    """Per-block parallel-execution report."""

    lanes: int
    txs: int
    validated: int
    stragglers: int
    lane_sizes: List[int] = field(default_factory=list)

    @property
    def conflict_rate(self) -> float:
        return self.stragglers / self.txs if self.txs else 0.0


def execute_block_parallel(
    executer: TransactionExecuter,
    state: StateManager,
    ordered: Sequence[SignedTransaction],
    block_index: int,
    base_roots: StateRoots,
    n_lanes: int,
    partition: Optional[Callable[[int, SignedTransaction], int]] = None,
    device="cuda",
) -> Tuple[Snapshot, List[TransactionReceipt], ParallelStats]:
    """Run an ordered block through the lane/merge pipeline; returns the
    merged (un-frozen) snapshot on the main trie, the receipts in
    canonical order, and the stats. The caller freezes — exactly where
    the serial path freezes — so the two paths share the commit seam.
    The senders are recovered on `device` first (a warm cache launches
    nothing)."""
    chain_id = executer.chain_id
    warm_sender_caches(ordered, chain_id, device=device)
    lanes = [l for l in plan_lanes(ordered, chain_id, n_lanes, partition) if l]

    def run_lane(lane: List[Tuple[int, SignedTransaction]]):
        snap = RecordingSnapshot(state.trie.fork(), base_roots)
        out = []
        for gi, stx in lane:
            snap.begin_tx()
            res = executer.execute(snap, stx, block_index, gi)
            reads, delta = snap.end_tx()
            out.append((gi, res.receipt, reads, delta))
        return out

    if len(lanes) <= 1:
        lane_results = [run_lane(lane) for lane in lanes]
    else:
        with ThreadPoolExecutor(
            max_workers=len(lanes), thread_name_prefix="exec-lane"
        ) as pool:
            lane_results = list(pool.map(run_lane, lanes))

    by_index: Dict[int, tuple] = {}
    for lane_out in lane_results:
        for rec in lane_out:
            by_index[rec[0]] = rec

    # canonical-order merge with read validation; stragglers re-execute
    # serially on the merged snapshot (<= one serial pass in total)
    merged = state.new_snapshot(base_roots)
    merged_writes = merged._writes
    receipts: List[TransactionReceipt] = []
    stragglers = 0
    for i, stx in enumerate(ordered):
        _, receipt, reads, delta = by_index[i]
        ok = True
        for (tree, key), seen in reads.items():
            if merged.get(tree, key) != seen:
                ok = False
                break
        if ok:
            for tree, key, value in delta:
                merged_writes[tree][key] = value
            receipts.append(receipt)
        else:
            stragglers += 1
            res = executer.execute(merged, stx, block_index, i)
            receipts.append(res.receipt)

    stats = ParallelStats(
        lanes=len(lanes),
        txs=len(ordered),
        validated=len(ordered) - stragglers,
        stragglers=stragglers,
        lane_sizes=[len(l) for l in lanes],
    )
    metrics.set_gauge("exec_lanes", stats.lanes)
    metrics.set_gauge("exec_conflict_rate", stats.conflict_rate)
    metrics.inc("exec_txs_validated_total", stats.validated)
    metrics.inc("exec_txs_straggler_total", stats.stragglers)
    metrics.inc("exec_blocks_parallel_total")
    return merged, receipts, stats
