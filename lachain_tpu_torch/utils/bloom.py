"""2048-bit log bloom filter (Ethereum-shaped).

The port's copy of `lachain_tpu/utils/bloom.py`: a fixed 256-byte filter
per block over the addresses that emitted logs (the `BLOCK_BLOOM` row that
`core/block_manager.py` writes), so log queries skip blocks that cannot
match.

Bit selection follows the Ethereum yellow-paper M3:2048 scheme: keccak256
of the item, three 11-bit indices from byte pairs (0,1), (2,3), (4,5),
bits set big-endian within the 256-byte array.
"""
from __future__ import annotations

from ..crypto.hashes import keccak256_host

BLOOM_BYTES = 256
_MASK = 2047


def empty() -> bytearray:
    return bytearray(BLOOM_BYTES)


def _bits(item: bytes):
    h = keccak256_host(item)
    for i in (0, 2, 4):
        yield ((h[i] << 8) | h[i + 1]) & _MASK


def add(bloom: bytearray, item: bytes) -> None:
    for bit in _bits(item):
        bloom[BLOOM_BYTES - 1 - bit // 8] |= 1 << (bit % 8)


def contains(bloom: bytes, item: bytes) -> bool:
    """False means DEFINITELY absent; True means possibly present."""
    for bit in _bits(item):
        if not bloom[BLOOM_BYTES - 1 - bit // 8] & (1 << (bit % 8)):
            return False
    return True
