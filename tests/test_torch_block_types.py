"""The port's block types and proposal codec vs the JAX package's.

`lachain_tpu_torch/core/types.py` and `core/block_producer.py`'s
`encode_tx_batch` / `decode_tx_batch` are copies of the JAX package's:
on seeded transactions every encoding, decoding and hash must be the
reference's bytes (`Transaction`, `SignedTransaction`, `BlockHeader`,
`MultiSig`, `Block`, `tx_merkle_root`, a proposal batch); malformed bytes
raise where the reference raises; `convert.signed_transactions_from_bytes`
carries the reference's wire transactions across; `sender` and
`warm_sender_caches(device="cpu")` (the plain versions of the card's
recovery) give the reference's senders, None for a bad signature. ~5 s.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.core import block_producer as jbp
from lachain_tpu.core import types as jtypes
from lachain_tpu_torch import convert
from lachain_tpu_torch.core import block_producer as bp
from lachain_tpu_torch.core import types
from lachain_tpu_torch.crypto import ecdsa

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

CHAIN_ID = 41


def seeded_transfers(seed: int, count: int, senders: int = 4):
    """(reference SignedTransactions, their private keys): seeded transfers
    with invocations of a few sizes, one deploy (to the zero address), one
    with a malformed signature (last)."""
    rng = random.Random(seed)
    keys = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(senders)]
    out = []
    for i in range(count):
        tx = jtypes.Transaction(
            to=jtypes.ZERO_ADDRESS if i == 1 else rng.randbytes(20),
            value=rng.randrange(1 << 200), nonce=i // senders,
            gas_price=rng.randrange(1 << 40), gas_limit=rng.randrange(21000, 1 << 30),
            invocation=rng.randbytes(rng.choice((0, 4, 68))))
        out.append(jtypes.sign_transaction(tx, keys[i % senders], CHAIN_ID))
    bad = out[-1]
    out[-1] = jtypes.SignedTransaction(bad.tx, bytes(32) + bad.signature[32:])
    return out, keys


def test_transactions_equal_reference():
    jtxs, keys = seeded_transfers(0xB10C, 9)
    ptxs = convert.signed_transactions_from_bytes([t.encode() for t in jtxs])
    for j, p in zip(jtxs, ptxs):
        assert p.encode() == j.encode()
        assert p.tx.encode() == j.tx.encode()
        assert types.Transaction.decode(j.tx.encode()) == p.tx
        assert p.tx.signing_hash(CHAIN_ID) == j.tx.signing_hash(CHAIN_ID)
        assert p.hash() == j.hash()
        assert p.sender(CHAIN_ID) == j.sender(CHAIN_ID)
    assert ptxs[-1].sender(CHAIN_ID) is None
    # the port's signer gives the reference's signature
    tx = types.Transaction.decode(jtxs[0].tx.encode())
    signed = types.sign_transaction(tx, keys[0], CHAIN_ID)
    assert signed.encode() == jtxs[0].encode()
    assert signed.sender(CHAIN_ID) == ecdsa.address_from_public_key(
        ecdsa.public_key_bytes(keys[0]))


def test_warm_sender_caches_on_the_plain_kernels_equal_reference():
    jtxs, _ = seeded_transfers(0xB10D, 7)
    ptxs = convert.signed_transactions_from_bytes([t.encode() for t in jtxs])
    types._SENDER_MEMO.clear()
    types.warm_sender_caches(ptxs, CHAIN_ID, device="cpu")
    jtypes.warm_sender_caches(jtxs, CHAIN_ID)
    assert [p.__dict__["_sender_cache"] for p in ptxs] == [
        j.__dict__["_sender_cache"] for j in jtxs]
    assert ptxs[-1].__dict__["_sender_cache"] == (CHAIN_ID, None)
    # cached transactions are skipped: nothing is recomputed
    types.warm_sender_caches(ptxs, CHAIN_ID, device="no such device")
    assert [p.sender(CHAIN_ID) for p in ptxs] == [j.sender(CHAIN_ID) for j in jtxs]


def test_block_header_multisig_block_and_merkle_root_equal_reference():
    rng = random.Random(0xB10E)
    jtxs, _ = seeded_transfers(0xB10F, 5)
    hashes = [t.hash() for t in jtxs]
    for k in range(len(hashes) + 1):
        assert types.tx_merkle_root(hashes[:k]) == jtypes.tx_merkle_root(hashes[:k])
    jh = jtypes.BlockHeader(index=rng.randrange(1 << 40), prev_block_hash=rng.randbytes(32),
                            merkle_root=jtypes.tx_merkle_root(hashes),
                            state_hash=rng.randbytes(32), nonce=rng.randrange(1 << 63))
    ph = types.BlockHeader.decode(jh.encode())
    assert ph.encode() == jh.encode() and ph.hash() == jh.hash()
    sigs = tuple((i, rng.randbytes(65)) for i in (0, 2, 3))
    jm = jtypes.MultiSig(signatures=sigs)
    pm = types.MultiSig(signatures=sigs)
    assert pm.encode() == jm.encode() and types.MultiSig.decode(jm.encode()) == pm
    jb = jtypes.Block(header=jh, tx_hashes=tuple(hashes), multisig=jm)
    pb = types.Block.decode(jb.encode())
    assert pb.encode() == jb.encode() and pb.hash() == jb.hash()
    assert pb == types.Block(header=ph, tx_hashes=tuple(hashes), multisig=pm)


def test_tx_batches_equal_reference_and_malformed_bytes_raise():
    jtxs, _ = seeded_transfers(0xB110, 6)
    ptxs = convert.signed_transactions_from_bytes([t.encode() for t in jtxs])
    for k in (0, 1, 6):
        data = bp.encode_tx_batch(ptxs[:k])
        assert data == jbp.encode_tx_batch(jtxs[:k])
        assert [t.encode() for t in bp.decode_tx_batch(data)] == [
            t.encode() for t in jbp.decode_tx_batch(data)]
    data = bp.encode_tx_batch(ptxs)
    # the memo hands every decoder of one proposal the same objects
    assert all(a is b for a, b in zip(bp.decode_tx_batch(data), bp.decode_tx_batch(data)))
    bad = [data[:-1], data + b"\x00", b"\x00\x00\x00\x02" + data[4:],
           b"\xff" * 8, b"", data[:4] + b"\x00\x00\x00\x07" + data[8:]]
    for blob in bad:
        with pytest.raises(ValueError):
            jbp.decode_tx_batch(blob)
        with pytest.raises(ValueError):
            bp.decode_tx_batch(blob)
    with pytest.raises(ValueError):
        convert.signed_transactions_from_bytes([jtxs[0].encode()[:-1]])
