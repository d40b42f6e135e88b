"""Chain data types: transactions, receipts, block headers, multisigs, blocks.

The port's copy of `lachain_tpu/core/types.py` (:31-309), bytes for bytes:
`Transaction`, `SignedTransaction` (its encoding memo, `hash`, and
`sender` with the process-wide `_SENDER_MEMO`), `warm_sender_caches`,
`sign_transaction`, `TransactionReceipt` (the row execution writes under
the transaction's hash), `BlockHeader`, `MultiSig`, `Block` and
`tx_merkle_root`. The wire format is the fixed-width codec of
`utils/serialization.py`; hashes are keccak256 over the canonical
encoding, in one call of the host library each (`hashes.keccak256_host`,
the value of the reference's native `keccak256`), the chain id mixed into
the signing hash (EIP-155 shape).

Differences, by the port's rules: `warm_sender_caches` takes `device` and
sends every pending transaction to `ecdsa.recover_hash_batch` there (the
card by default); a single `sender` recovers in the native host library
(`ecdsa.recover_hash`). Imports no torch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..crypto import ecdsa
from ..crypto.hashes import keccak256_host, merkle_root
from ..utils.serialization import (
    Reader,
    write_bytes,
    write_bytes_list,
    write_u32,
    write_u64,
    write_u256,
)

ADDRESS_BYTES = 20
ZERO_ADDRESS = b"\x00" * ADDRESS_BYTES
ZERO_HASH = b"\x00" * 32


@dataclass(frozen=True)
class Transaction:
    """A transfer / contract call (reference: transaction.proto Transaction)."""

    to: bytes  # 20 bytes; ZERO_ADDRESS + invocation => deploy
    value: int  # wei-style u256
    nonce: int
    gas_price: int
    gas_limit: int
    invocation: bytes = b""  # contract input

    def encode(self) -> bytes:
        return (
            self.to
            + write_u256(self.value)
            + write_u64(self.nonce)
            + write_u256(self.gas_price)
            + write_u64(self.gas_limit)
            + write_bytes(self.invocation)
        )

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        r = Reader(data)
        to = r.raw(ADDRESS_BYTES)
        value = r.u256()
        nonce = r.u64()
        gas_price = r.u256()
        gas_limit = r.u64()
        invocation = r.bytes_()
        r.assert_eof()
        return cls(to, value, nonce, gas_price, gas_limit, invocation)

    def signing_hash(self, chain_id: int) -> bytes:
        """Hash to sign — chain id mixed in (EIP-155 shape,
        reference TransactionUtils.cs)."""
        return keccak256_host(self.encode() + write_u64(chain_id))


# (signing_hash, signature) -> recovered address; _MISS marks a signature
# that failed recovery so invalid txs don't retry the recover either
_MISS = object()
_SENDER_MEMO: dict = {}


@dataclass(frozen=True)
class SignedTransaction:
    tx: Transaction
    signature: bytes  # 65-byte recoverable ECDSA

    def encode(self) -> bytes:
        # immutable value object: ordering, pooling, block assembly and
        # hashing all re-encode the same tx many times per era — memoize
        # (the reference's proto objects keep their serialized form too)
        cached = self.__dict__.get("_enc_cache")
        if cached is None:
            cached = write_bytes(self.tx.encode()) + write_bytes(
                self.signature
            )
            object.__setattr__(self, "_enc_cache", cached)
        return cached

    @classmethod
    def decode(cls, data: bytes) -> "SignedTransaction":
        r = Reader(data)
        tx = Transaction.decode(r.bytes_())
        sig = r.bytes_()
        r.assert_eof()
        out = cls(tx, sig)
        # assert_eof proved `data` IS the canonical encoding — seed the
        # memo so wire-decoded txs never pay the re-encode either
        object.__setattr__(out, "_enc_cache", data)
        return out

    def hash(self) -> bytes:
        cached = self.__dict__.get("_hash_cache")
        if cached is None:
            cached = keccak256_host(self.encode())
            object.__setattr__(self, "_hash_cache", cached)
        return cached

    def sender(self, chain_id: int) -> Optional[bytes]:
        """Recovered 20-byte sender address, or None if invalid. Cached
        per-object AND process-wide: ordering, execution and the pool all
        ask repeatedly, and in-process multi-validator harnesses decode
        the same wire tx into per-validator objects — without the shared
        memo each validator pays the ECDSA recovery again (reference
        caches recoveries in TransactionManager's verify cache,
        TransactionManager.cs:141-171)."""
        cached = self.__dict__.get("_sender_cache")
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        h = self.tx.signing_hash(chain_id)
        key = (h, self.signature)
        addr = _SENDER_MEMO.get(key)
        if addr is _MISS:
            addr = None
        elif addr is None:
            pub = ecdsa.recover_hash(h, self.signature)
            addr = None if pub is None else ecdsa.address_from_public_key(pub)
            if len(_SENDER_MEMO) > 65536:
                _SENDER_MEMO.clear()
            _SENDER_MEMO[key] = addr if addr is not None else _MISS
        object.__setattr__(self, "_sender_cache", (chain_id, addr))
        return addr


def warm_sender_caches(stxs, chain_id: int, device="cuda") -> None:
    """Recover the senders of many transactions at once and fill each
    one's sender cache: every pending transaction goes through
    `ecdsa.recover_hash_batch` on `device` (the card unless the caller
    passes "cpu"), with no size threshold. Already-cached transactions are
    skipped; an invalid signature caches a None sender exactly like the
    scalar path."""
    pending = [
        stx
        for stx in stxs
        if (c := stx.__dict__.get("_sender_cache")) is None
        or c[0] != chain_id
    ]
    if not pending:
        return
    pubs = ecdsa.recover_hash_batch(
        [stx.tx.signing_hash(chain_id) for stx in pending],
        [stx.signature for stx in pending],
        device=device,
    )
    for stx, pub in zip(pending, pubs):
        addr = None if pub is None else ecdsa.address_from_public_key(pub)
        object.__setattr__(stx, "_sender_cache", (chain_id, addr))


def sign_transaction(
    tx: Transaction, priv: bytes, chain_id: int
) -> SignedTransaction:
    return SignedTransaction(
        tx=tx, signature=ecdsa.sign_hash(priv, tx.signing_hash(chain_id))
    )


@dataclass(frozen=True)
class TransactionReceipt:
    """Execution result (reference: TransactionReceipt in transaction.proto +
    event.proto logs)."""

    tx_hash: bytes
    block_index: int
    index_in_block: int
    gas_used: int
    status: int  # 1 success, 0 failed
    sender: bytes = ZERO_ADDRESS
    return_data: bytes = b""

    def encode(self) -> bytes:
        return (
            self.tx_hash
            + write_u64(self.block_index)
            + write_u32(self.index_in_block)
            + write_u64(self.gas_used)
            + write_u32(self.status)
            + self.sender
            + write_bytes(self.return_data)
        )

    @classmethod
    def decode(cls, data: bytes) -> "TransactionReceipt":
        r = Reader(data)
        tx_hash = r.raw(32)
        block_index = r.u64()
        index_in_block = r.u32()
        gas_used = r.u64()
        status = r.u32()
        sender = r.raw(ADDRESS_BYTES)
        return_data = r.bytes_()
        r.assert_eof()
        return cls(
            tx_hash, block_index, index_in_block, gas_used, status,
            sender, return_data,
        )


@dataclass(frozen=True)
class BlockHeader:
    """Reference: block.proto BlockHeader (prev hash, merkle root, state hash,
    index, nonce)."""

    index: int
    prev_block_hash: bytes
    merkle_root: bytes  # over tx hashes
    state_hash: bytes
    nonce: int  # from the era's common coin (RootProtocol.cs:316-322)

    def encode(self) -> bytes:
        return (
            write_u64(self.index)
            + self.prev_block_hash
            + self.merkle_root
            + self.state_hash
            + write_u64(self.nonce)
        )

    @classmethod
    def decode(cls, data: bytes) -> "BlockHeader":
        r = Reader(data)
        index = r.u64()
        prev_h = r.raw(32)
        mroot = r.raw(32)
        shash = r.raw(32)
        nonce = r.u64()
        r.assert_eof()
        return cls(index, prev_h, mroot, shash, nonce)

    def hash(self) -> bytes:
        return keccak256_host(self.encode())


@dataclass(frozen=True)
class MultiSig:
    """Quorum of validator header signatures (reference: multisig.proto)."""

    signatures: Tuple[Tuple[int, bytes], ...]  # (validator index, ecdsa sig)

    def encode(self) -> bytes:
        out = write_u32(len(self.signatures))
        for idx, sig in self.signatures:
            out += write_u32(idx) + write_bytes(sig)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "MultiSig":
        r = Reader(data)
        n = r.u32()
        sigs = tuple((r.u32(), r.bytes_()) for _ in range(n))
        r.assert_eof()
        return cls(sigs)


@dataclass(frozen=True)
class Block:
    header: BlockHeader
    tx_hashes: Tuple[bytes, ...]
    multisig: MultiSig

    def encode(self) -> bytes:
        return (
            write_bytes(self.header.encode())
            + write_bytes_list(list(self.tx_hashes))
            + write_bytes(self.multisig.encode())
        )

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        r = Reader(data)
        header = BlockHeader.decode(r.bytes_())
        tx_hashes = tuple(r.bytes_list())
        multisig = MultiSig.decode(r.bytes_())
        r.assert_eof()
        return cls(header, tx_hashes, multisig)

    def hash(self) -> bytes:
        return self.header.hash()


# header creation and execute_block's header check both derive the merkle
# root over the same tx-hash list a few milliseconds apart; the pairwise
# keccak tree is ~15ms at 10k txs, so memo the last few (FIFO like the
# emulate memo; hashing the key tuple is ~30x cheaper than the tree)
_MERKLE_MEMO: dict = {}
_MERKLE_MEMO_MAX = 8


def tx_merkle_root(tx_hashes: Sequence[bytes]) -> bytes:
    key = tuple(tx_hashes)
    root = _MERKLE_MEMO.get(key)
    if root is None:
        root = merkle_root(list(key)) or ZERO_HASH
        _MERKLE_MEMO[key] = root
        while len(_MERKLE_MEMO) > _MERKLE_MEMO_MAX:
            _MERKLE_MEMO.pop(next(iter(_MERKLE_MEMO)))
    return root
