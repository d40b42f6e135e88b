"""Fixed-width binary serialization helpers.

The port's copy of `lachain_tpu/utils/serialization.py`: length-prefixed
concatenation of fixed-width big-endian fields, and the `Reader` cursor
that parses them back. The consensus messages (`CoinId.to_bytes`) and the
TPKE wire records use it.
"""
from __future__ import annotations

import struct
from typing import List, Sequence


def write_u16(v: int) -> bytes:
    return struct.pack(">H", v)


def write_u32(v: int) -> bytes:
    return struct.pack(">I", v)


def write_u64(v: int) -> bytes:
    return struct.pack(">Q", v)


def write_i64(v: int) -> bytes:
    return struct.pack(">q", v)


def write_u256(v: int) -> bytes:
    return v.to_bytes(32, "big")


def write_bytes(b: bytes) -> bytes:
    """Length-prefixed byte string (u32 big-endian length)."""
    return write_u32(len(b)) + b


def write_bytes_list(items: Sequence[bytes]) -> bytes:
    return write_u32(len(items)) + b"".join(write_bytes(i) for i in items)


class Reader:
    """Cursor-based reader matching the writers above."""

    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise ValueError("serialization underrun")
        out = self._d[self._o : self._o + n]
        self._o += n
        return out

    def u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u256(self) -> int:
        return int.from_bytes(self._take(32), "big")

    def bytes_(self) -> bytes:
        return self._take(self.u32())

    def bytes_list(self) -> List[bytes]:
        return [self.bytes_() for _ in range(self.u32())]

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def rest(self) -> bytes:
        """Everything remaining (consumes it)."""
        return self._take(len(self._d) - self._o)

    def eof(self) -> bool:
        return self._o == len(self._d)

    def assert_eof(self) -> None:
        if not self.eof():
            raise ValueError("trailing bytes in serialized record")
