"""Block emulate/execute/commit state machine.

The port of `lachain_tpu/core/block_manager.py`, bytes for bytes in every
row it writes:
  * `emulate` — execute an ordered transaction list and compute the
    resulting state hash WITHOUT committing (functional snapshots make the
    rollback free), serially or through `parallel_exec`'s lanes, with the
    process-wide memo `_EMULATE_MEMO`
  * `execute_block(check_state_hash)` — recover the senders, order,
    emulate (a memo hit after `create_header`), check the header's state
    hash and merkle root, and persist
  * `_persist` — the block, its transactions, the address index
    (`ADDRESS_TX`) and the log bloom (`BLOCK_BLOOM`) in one batch, then
    the state commit, with the crash points `block.persist.pre` / `.mid` /
    `.post` (mid: the block durable, its state not: the torn block fsck
    repairs)
  * the reads, and `build_genesis`

Determinism invariant: emulate and execute run the SAME pure function over
the same base roots, so the state hash a validator signs in its header is
exactly what executing the block produces.

Differences, by the port's rules: `BlockManager(device="cuda")` is where a
block's senders are recovered (`types.warm_sender_caches`, one batch of the
card's secp256k1 kernels; asking for the card where there is none raises
at construction); everything else runs on the host. The reference's
observability is kept: the spans `exec.block` and, inside it,
`merkle.freeze` (the era report's `exec` and `merkle` phases, tagged with
the block index as their era), the `block_execute` timer, the gauge
`chain_height`, the counter `chain_txs_total` and the transactions'
"exec" and "commit" stamps (utils/txtrace.py); no result depends on them.
`last_parallel_stats` keeps the `ParallelStats` of the last emulation
that ran the lanes (None after a serial one), which chip_smoke.py reads.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..storage.kv import EntryPrefix, KVStore, prefixed
from ..storage.state import StateManager, StateRoots
from ..storage.crashpoints import crash_point
from ..utils import bloom, metrics, tracing, txtrace
from ..utils.serialization import write_u32, write_u64
from .execution import TransactionExecuter, set_balance
from .parallel_exec import (
    MIN_PARALLEL_TXS,
    execute_block_parallel,
    resolve_lanes,
)
from .types import (
    Block,
    BlockHeader,
    MultiSig,
    SignedTransaction,
    ZERO_HASH,
    tx_merkle_root,
    warm_sender_caches,
)


@dataclass
class EmulationResult:
    roots: StateRoots
    state_hash: bytes
    receipts: List
    # 20-byte emitting-contract addresses of THIS block's events, captured
    # from the snapshot write buffer before freeze — _persist builds the
    # per-block log bloom from these instead of probing the trie per tx
    event_addrs: Tuple[bytes, ...] = ()


# process-wide emulation memo: key -> (EmulationResult, exported trie node
# buffer); bounded FIFO. See BlockManager.emulate for the sharing argument.
# Lock-guarded: parallel-execution lane workers and the pipelined-era
# scheduler can emulate from different threads concurrently.
_EMULATE_MEMO: Dict[tuple, Tuple[EmulationResult, dict]] = {}
_EMULATE_MEMO_MAX = 8
_EMULATE_MEMO_LOCK = threading.Lock()


class BlockManager:
    def __init__(
        self,
        kv: KVStore,
        state: StateManager,
        executer: TransactionExecuter,
        lanes: int = 1,
        device="cuda",
    ):
        from ..ops.verify import resolve_device

        # where the blocks' senders are recovered (raises without a card)
        self.device = resolve_device(device)
        self.last_parallel_stats = None
        self._kv = kv
        self.state = state
        self.executer = executer
        # lanes: 1 pins the serial oracle (default), N>1 fixes the lane
        # count, 0 = auto (cores, capped). Results are bit-identical either
        # way (core/parallel_exec.py).
        self.lanes = max(int(lanes), 0)
        self.on_block_persisted = []  # callbacks(block)

    # -- ordering (deterministic across validators) ---------------------------
    @staticmethod
    def order_transactions(
        txs: Sequence[SignedTransaction], chain_id: int
    ) -> List[SignedTransaction]:
        """Canonical execution order: (sender, nonce, hash) — every honest
        node derives the identical order from the agreed tx set
        (role of the reference's fee-ordering in BlockProducer.CreateHeader)."""
        return sorted(
            txs,
            key=lambda stx: (
                stx.sender(chain_id) or b"\xff" * 20,
                stx.tx.nonce,
                stx.hash(),
            ),
        )

    # -- emulate --------------------------------------------------------------
    def emulate(
        self,
        txs: Sequence[SignedTransaction],
        block_index: int,
        base: Optional[StateRoots] = None,
    ) -> EmulationResult:
        # emulate is a pure function of (base roots, index, chain id,
        # ordered txs). It runs redundantly in two directions: the reference
        # pays it twice per produced block on ONE node (CreateHeader
        # emulates, Execute emulates again to check the signed state hash,
        # BlockManager.cs:231-267 vs 304-560), and an in-process
        # multi-validator harness additionally makes every node emulate the
        # SAME agreed tx set over identical base roots. A process-wide memo
        # on the exact purity key collapses both. Correctness of sharing
        # across BlockManager instances: the base state hash pins the full
        # chain state, so any two tries with that base hold bit-identical
        # node sets; the producing trie's write-back buffer is exported with
        # the result and absorbed on hit, so the consumer's commit persists
        # exactly the nodes its own freeze would have buffered.
        base_roots = base if base is not None else self.state.committed
        key = (
            base_roots.state_hash(),
            block_index,
            self.executer.chain_id,
            tuple(stx.hash() for stx in txs),
        )
        with _EMULATE_MEMO_LOCK:
            hit = _EMULATE_MEMO.get(key)
        if hit is not None:
            em, nodes = hit
            self.state.trie.absorb_pending(nodes)
            return em
        lanes = resolve_lanes(self.lanes)
        self.last_parallel_stats = None
        with tracing.span("exec.block", cat="exec", era=block_index):
            if lanes > 1 and len(txs) >= MIN_PARALLEL_TXS:
                snap, receipts, self.last_parallel_stats = execute_block_parallel(
                    self.executer,
                    self.state,
                    txs,
                    block_index,
                    base_roots,
                    lanes,
                    device=self.device,
                )
            else:
                snap = self.state.new_snapshot(base_roots)
                receipts = []
                for i, stx in enumerate(txs):
                    res = self.executer.execute(snap, stx, block_index, i)
                    receipts.append(res.receipt)
            event_addrs = tuple(
                v[:20] for v in snap._writes["events"].values() if v
            )
            # merkle nests inside exec.block and outranks it in the era
            # report: the hashing's share splits from the execution's
            with tracing.span("merkle.freeze", cat="merkle", era=block_index):
                roots = snap.freeze()
        em = EmulationResult(
            roots=roots,
            state_hash=roots.state_hash(),
            receipts=receipts,
            event_addrs=event_addrs,
        )
        with _EMULATE_MEMO_LOCK:
            _EMULATE_MEMO[key] = (em, self.state.trie.export_pending())
            while len(_EMULATE_MEMO) > _EMULATE_MEMO_MAX:
                _EMULATE_MEMO.pop(next(iter(_EMULATE_MEMO)))
        return em

    # -- execute + commit ------------------------------------------------------
    def execute_block(
        self,
        header: BlockHeader,
        txs: Sequence[SignedTransaction],
        multisig: MultiSig,
        check_state_hash: bool = True,
    ) -> Block:
        with metrics.measure("block_execute"):
            # recover every sender up front in one batch on the device;
            # ordering + execution then hit warm caches only (a block whose
            # senders the ingest already recovered launches nothing here)
            warm_sender_caches(txs, self.executer.chain_id, device=self.device)
            txs = self.order_transactions(txs, self.executer.chain_id)
            # tx lifecycle: execution reached this block (stamped before
            # emulate, so that a memo hit still marks when THIS node's
            # execute touched it)
            txtrace.stamp_many(
                (stx.hash() for stx in txs), "exec", era=header.index
            )
            em = self.emulate(txs, header.index)
            if check_state_hash and em.state_hash != header.state_hash:
                raise ValueError(
                    f"state hash mismatch at block {header.index}: "
                    f"{em.state_hash.hex()} != {header.state_hash.hex()}"
                )
            if tx_merkle_root([t.hash() for t in txs]) != header.merkle_root:
                raise ValueError("tx merkle root mismatch")
            block = Block(
                header=header,
                tx_hashes=tuple(t.hash() for t in txs),
                multisig=multisig,
            )
            self._persist(block, txs, em)
        metrics.set_gauge("chain_height", block.header.index)
        metrics.inc("chain_txs_total", len(txs))
        return block

    def _persist(self, block: Block, txs, em: EmulationResult) -> None:
        crash_point("block.persist.pre")
        h = block.hash()
        puts = [
            (prefixed(EntryPrefix.BLOCK_BY_HASH, h), block.encode()),
            (
                prefixed(
                    EntryPrefix.BLOCK_HASH_BY_HEIGHT,
                    write_u64(block.header.index),
                ),
                h,
            ),
        ]
        for stx in txs:
            puts.append(
                (
                    prefixed(EntryPrefix.TRANSACTION_BY_HASH, stx.hash()),
                    stx.encode(),
                )
            )
        # address -> tx index (sender and recipient): serves the fe_*
        # account-history RPC family (reference FrontEndService.cs) without
        # chain scans. Key: prefix | address | height | index-in-block.
        for i, stx in enumerate(txs):
            th = stx.hash()
            key_tail = write_u64(block.header.index) + write_u32(i)
            touched = {stx.tx.to}
            sender = stx.sender(self.executer.chain_id)
            if sender is not None:
                touched.add(sender)
            for addr in touched:
                puts.append(
                    (
                        prefixed(EntryPrefix.ADDRESS_TX, addr + key_tail),
                        th,
                    )
                )
        # per-block log bloom over emitting addresses: eth_getLogs and the
        # filter machinery skip non-matching blocks without decoding events
        # (reference: Misc/BloomFilter.cs). The emulation captured the
        # block's emitting addresses from its write buffer, so the bloom
        # costs |events| adds instead of a trie probe per (tx, event index)
        bl = bloom.empty()
        for addr in em.event_addrs:
            bloom.add(bl, addr)
        puts.append(
            (
                prefixed(
                    EntryPrefix.BLOCK_BLOOM, write_u64(block.header.index)
                ),
                bytes(bl),
            )
        )
        self._kv.write_batch(puts)
        # the torn-block window: the block batch is durable but the state
        # commit (trie nodes + snapshot index + tip) is not — a crash here
        # leaves an orphan block above the tip, which fsck must detect
        crash_point("block.persist.mid")
        self.state.commit(block.header.index, em.roots)
        crash_point("block.persist.post")
        # the transactions' last stamp: the block holding them is durable
        # (it closes tx_e2e_seconds of the sampled ones)
        txtrace.stamp_many(block.tx_hashes, "commit", era=block.header.index)
        for cb in list(self.on_block_persisted):
            cb(block)

    # -- reads ----------------------------------------------------------------
    def block_by_height(self, height: int) -> Optional[Block]:
        h = self._kv.get(
            prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(height))
        )
        if h is None:
            return None
        return self.block_by_hash(h)

    def block_by_hash(self, h: bytes) -> Optional[Block]:
        enc = self._kv.get(prefixed(EntryPrefix.BLOCK_BY_HASH, h))
        return Block.decode(enc) if enc else None

    def transaction_by_hash(self, h: bytes) -> Optional[SignedTransaction]:
        enc = self._kv.get(prefixed(EntryPrefix.TRANSACTION_BY_HASH, h))
        return SignedTransaction.decode(enc) if enc else None

    def transactions_by_address(
        self, addr: bytes, limit: int = 100, before_height: Optional[int] = None
    ) -> list:
        """Most-recent-first tx hashes touching `addr` (sender or
        recipient), paginated by height. Requires the KV store to support
        prefix scans (both backends do)."""
        prefix = prefixed(EntryPrefix.ADDRESS_TX, addr)
        out = []
        for key, th in self._kv.scan_prefix(prefix):
            height = int.from_bytes(key[len(prefix) : len(prefix) + 8], "big")
            if before_height is not None and height >= before_height:
                continue
            out.append((height, th))
        out.sort(reverse=True)
        return [(h, th) for h, th in out[:limit]]

    def bloom_by_height(self, height: int) -> Optional[bytes]:
        return self._kv.get(
            prefixed(EntryPrefix.BLOCK_BLOOM, write_u64(height))
        )

    def receipt_by_hash(self, h: bytes) -> Optional[bytes]:
        snap = self.state.new_snapshot()
        return snap.get("transactions", h)

    def current_height(self) -> int:
        h = self.state.committed_height()
        return h if h is not None else -1

    # -- genesis ---------------------------------------------------------------
    def build_genesis(
        self,
        initial_balances: Dict[bytes, int],
        chain_id: int,
        validator_pubs: Optional[List[bytes]] = None,
    ) -> Block:
        """Reference: GenesisBuilder.cs:14-76 — block 0 with funded accounts
        and the genesis validator set registered with the staking contract
        (the attendance-detection electorate)."""
        if self.block_by_height(0) is not None:
            return self.block_by_height(0)
        snap = self.state.new_snapshot(StateRoots())
        for addr, bal in sorted(initial_balances.items()):
            set_balance(snap, addr, bal)
        if validator_pubs:
            from . import system_contracts as _sc

            _sc.register_genesis_validators(snap, list(validator_pubs))
        roots = snap.freeze()
        header = BlockHeader(
            index=0,
            prev_block_hash=ZERO_HASH,
            merkle_root=ZERO_HASH,
            state_hash=roots.state_hash(),
            nonce=0,
        )
        block = Block(header=header, tx_hashes=(), multisig=MultiSig(()))
        em = EmulationResult(roots=roots, state_hash=roots.state_hash(), receipts=[])
        self._persist(block, [], em)
        return block
