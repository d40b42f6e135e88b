"""The wire form of a block proposal: `encode_tx_batch` / `decode_tx_batch`.

The port's copy of `lachain_tpu/core/block_producer.py:32-56`, bytes for
bytes, with its decoded-proposal memo: an in-process fleet hands the same
proposal bytes to every validator (N=64: 64 x 64 equal decodes an era),
and sharing the immutable `SignedTransaction` objects shares their hash
and sender caches too, so the block's senders are recovered once an era,
not once a validator. `BlockProducer` itself (proposal from the pool,
header over the emulated state, execution) waits for the port's block
manager and transaction pool; `RootProtocol` takes any producer of its
shape. Imports no torch.
"""
from __future__ import annotations

from typing import List, Sequence

from ..utils.serialization import Reader, write_bytes_list
from .types import SignedTransaction


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
