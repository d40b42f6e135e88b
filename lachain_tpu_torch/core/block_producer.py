"""Block producer: the proposal's wire form, the proposal, the header and
the block.

The port of `lachain_tpu/core/block_producer.py`, bytes for bytes:
  * `encode_tx_batch` / `decode_tx_batch`, the proposal's wire form, with
    the decoded-proposal memo: an in-process fleet hands the same proposal
    bytes to every validator (N=64: 64 x 64 equal decodes an era), and
    sharing the immutable `SignedTransaction` objects shares their hash
    and sender caches too, so a block's senders are recovered once an
    era, not once a validator;
  * `BlockProducer`: `get_transactions_to_propose` (a seeded sample of
    the pool, txs_per_block / N), `create_header` (order, emulate, the
    state hash), `produce_block` (execute with the state hash checked,
    then drop the included transactions from the pool), and the
    pipelined-proposal overlay (`pipeline_overlay_push` / `clear`).

This object is handed to `consensus/root_protocol.RootProtocol`, which
keeps the consensus layer free of chain-state knowledge. A proposal's
transactions are stamped "propose" (utils/txtrace.py), as in the
reference. Imports no torch.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence

from ..utils import txtrace
from ..utils.serialization import Reader, write_bytes_list
from .block_manager import BlockManager
from .tx_pool import TransactionPool
from .types import (
    Block,
    BlockHeader,
    MultiSig,
    SignedTransaction,
    tx_merkle_root,
)

DEFAULT_TXS_PER_BLOCK = 1000


def encode_tx_batch(txs: Sequence[SignedTransaction]) -> bytes:
    """Wire form of a proposal (the payload fed into HoneyBadger)."""
    return write_bytes_list([t.encode() for t in txs])


# decoded-proposal memo: a bounded FIFO keyed by the raw wire bytes
_DECODE_MEMO: dict = {}
_DECODE_MEMO_MAX = 256


def decode_tx_batch(data: bytes) -> List[SignedTransaction]:
    cached = _DECODE_MEMO.get(data)
    if cached is None:
        r = Reader(data)
        cached = tuple(SignedTransaction.decode(b) for b in r.bytes_list())
        r.assert_eof()
        if len(_DECODE_MEMO) >= _DECODE_MEMO_MAX:
            _DECODE_MEMO.pop(next(iter(_DECODE_MEMO)))
        _DECODE_MEMO[data] = cached
    return list(cached)


class BlockProducer:
    def __init__(
        self,
        block_manager: BlockManager,
        pool: TransactionPool,
        n_validators: int,
        txs_per_block: int = DEFAULT_TXS_PER_BLOCK,
        proposal_seed: int = -1,
    ):
        self.bm = block_manager
        self.pool = pool
        self.n = n_validators
        self.txs_per_block = txs_per_block
        # per-validator randomized proposals (RandomSamplingQueue role):
        # HB blocks carry the union of n proposals, so identical top-fee
        # picks would cap blocks at txs_per_block / n distinct txs
        self.proposal_seed = proposal_seed
        # pipelined-proposal overlay: when era e+1 proposes while era e's
        # block is decided but not yet committed, the proposal must behave
        # as if that block had already landed — same rng height, no tx
        # claimed by an in-flight block, per-sender nonces advanced past
        # the in-flight ones. The window scheduler installs it before the
        # proposal and clears it when the window drains.
        self._ov_height: Optional[int] = None
        self._ov_exclude: set = set()
        self._ov_nonces: dict = {}

    # -- proposal ---------------------------------------------------------------
    def pipeline_overlay_push(
        self, height: int, txs: Sequence[SignedTransaction], chain_id: int
    ) -> None:
        """Extend the overlay with one in-flight block: proposals now build
        on virtual height `height` (the next block index) and skip `txs`.
        Cumulative — called once per decided-but-uncommitted era."""
        self._ov_height = height
        for stx in txs:
            self._ov_exclude.add(stx.hash())
            sender = stx.sender(chain_id)
            if sender is None:
                continue
            nxt = stx.tx.nonce + 1
            if nxt > self._ov_nonces.get(sender, 0):
                self._ov_nonces[sender] = nxt

    def pipeline_overlay_clear(self) -> None:
        self._ov_height = None
        self._ov_exclude = set()
        self._ov_nonces = {}

    def get_transactions_to_propose(self) -> List[SignedTransaction]:
        height = (
            self._ov_height
            if self._ov_height is not None
            else self.bm.current_height()
        )
        rng = (
            random.Random((self.proposal_seed << 20) ^ height)
            if self.proposal_seed >= 0
            else None
        )
        txs = self.pool.peek(
            max(self.txs_per_block // max(self.n, 1), 1),
            rng=rng,
            window_txs=2 * self.txs_per_block,
            exclude=self._ov_exclude if self._ov_exclude else None,
            nonce_override=self._ov_nonces if self._ov_nonces else None,
        )
        # these transactions ride OUR proposal for era height + 1 (sampled
        # only; the first stamp wins across repeated proposals)
        txtrace.stamp_many(
            (stx.hash() for stx in txs), "propose", era=height + 1
        )
        return txs

    # -- header -----------------------------------------------------------------
    def create_header(
        self, index: int, txs: Sequence[SignedTransaction], nonce: int
    ) -> BlockHeader:
        prev = self.bm.block_by_height(index - 1)
        if prev is None:
            raise ValueError(f"no parent block at height {index - 1}")
        ordered = self.bm.order_transactions(txs, self.bm.executer.chain_id)
        em = self.bm.emulate(ordered, index)
        return BlockHeader(
            index=index,
            prev_block_hash=prev.hash(),
            merkle_root=tx_merkle_root([t.hash() for t in ordered]),
            state_hash=em.state_hash,
            nonce=nonce,
        )

    # -- production -------------------------------------------------------------
    def produce_block(
        self,
        header: BlockHeader,
        txs: Sequence[SignedTransaction],
        multisig: MultiSig,
    ) -> Block:
        block = self.bm.execute_block(
            header, txs, multisig, check_state_hash=True
        )
        self.pool.remove_included(block.tx_hashes)
        self.pool.sanitize()
        return block
