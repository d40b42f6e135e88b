"""Contract ABI: 4-byte keccak selector + 32-byte words + dynamic tails.

The port's copy of `lachain_tpu/vm/abi.py`: methods are addressed by
keccak256_host(signature)[:4]; scalar args are fixed 32-byte big-endian words;
`bytes` args are a 32-byte length word followed by the payload padded to a
32-byte boundary (a flat layout: offsets are implicit, arguments are
decoded in order).
"""
from __future__ import annotations

from typing import Sequence, Union

from ..crypto.hashes import keccak256_host

WORD = 32

AbiValue = Union[int, bytes]


def method_selector(signature: str) -> bytes:
    return keccak256_host(signature.encode())[:4]


def _pad_right(data: bytes) -> bytes:
    rem = len(data) % WORD
    return data + b"\x00" * (WORD - rem) if rem else data


def encode_args(args: Sequence[AbiValue]) -> bytes:
    out = b""
    for a in args:
        if isinstance(a, bool):
            out += int(a).to_bytes(WORD, "big")
        elif isinstance(a, int):
            out += (a % (1 << 256)).to_bytes(WORD, "big")
        elif isinstance(a, (bytes, bytearray)):
            if len(a) == 20:  # address: left-pad into one word
                out += b"\x00" * 12 + bytes(a)
            elif len(a) == 32:
                out += bytes(a)
            else:
                out += len(a).to_bytes(WORD, "big") + _pad_right(bytes(a))
        else:
            raise TypeError(f"unsupported ABI value {type(a)}")
    return out


def encode_call(signature: str, *args: AbiValue) -> bytes:
    return method_selector(signature) + encode_args(args)


class AbiReader:
    """Sequential decoder over an ABI-encoded argument blob."""

    def __init__(self, data: bytes, skip_selector: bool = False):
        self.data = data[4:] if skip_selector else data
        self.pos = 0

    def _word(self) -> bytes:
        if self.pos + WORD > len(self.data):
            raise ValueError("ABI: out of data")
        w = self.data[self.pos : self.pos + WORD]
        self.pos += WORD
        return w

    def uint(self) -> int:
        return int.from_bytes(self._word(), "big")

    def address(self) -> bytes:
        return self._word()[12:]

    def word(self) -> bytes:
        return self._word()

    def bytes_(self) -> bytes:
        n = self.uint()
        if n > len(self.data) - self.pos:
            raise ValueError("ABI: bytes length out of range")
        out = self.data[self.pos : self.pos + n]
        padded = (n + WORD - 1) // WORD * WORD
        self.pos += padded
        return out

    def done(self) -> bool:
        return self.pos >= len(self.data)


def selector_of(invocation: bytes) -> bytes:
    return invocation[:4]
