"""Validator attendance bookkeeping.

The port of `lachain_tpu/consensus/attendance.py` (the C# reference's
ValidatorAttendance, ValidatorAttendance.cs:11-127), with its bytes: per
cycle, how many blocks each validator co-signed, persisted so that the
staking contract's attendance-detection phase can penalise absentees. It
keeps a two-cycle window (previous and next) and rotates it when the
cycle advances. Host work only.
"""
from __future__ import annotations

from typing import Dict

from ..utils.serialization import Reader, write_bytes, write_u32, write_u64


class ValidatorAttendance:
    def __init__(
        self,
        previous_cycle: int,
        previous: Dict[bytes, int] = None,
        next_: Dict[bytes, int] = None,
    ):
        self.previous_cycle = previous_cycle
        self.next_cycle = previous_cycle + 1
        self._previous: Dict[bytes, int] = dict(previous or {})
        self._next: Dict[bytes, int] = dict(next_ or {})

    def get(self, public_key: bytes, cycle: int) -> int:
        if cycle == self.previous_cycle:
            return self._previous.get(public_key, 0)
        if cycle == self.next_cycle:
            return self._next.get(public_key, 0)
        return 0

    def counts_for(self, cycle: int) -> Dict[bytes, int]:
        """Every recorded count of `cycle`, keyed by whoever co-signed (not
        by one era's validator set), so that a rotated-out validator's
        attendance still reaches the detection report."""
        if cycle == self.previous_cycle:
            return dict(self._previous)
        if cycle == self.next_cycle:
            return dict(self._next)
        return {}

    def increment(self, public_key: bytes, cycle: int) -> None:
        if cycle == self.previous_cycle:
            self._previous[public_key] = self._previous.get(public_key, 0) + 1
        if cycle == self.next_cycle:
            self._next[public_key] = self._next.get(public_key, 0) + 1

    def to_bytes(self) -> bytes:
        out = [write_u64(self.previous_cycle), write_u32(len(self._previous))]
        out += [write_bytes(pk) + write_u64(c) for pk, c in self._previous.items()]
        out.append(write_u32(len(self._next)))
        out += [write_bytes(pk) + write_u64(c) for pk, c in self._next.items()]
        return b"".join(out)

    @classmethod
    def from_bytes(
        cls, data: bytes, current_cycle: int, current_as_next: bool
    ) -> "ValidatorAttendance":
        """Decode, rotating the window to `current_cycle` (reference
        ValidatorAttendance.FromBytes:82-119)."""
        r = Reader(data)
        previous_cycle = r.u64()
        previous = {r.bytes_(): r.u64() for _ in range(r.u32())}
        next_ = {r.bytes_(): r.u64() for _ in range(r.u32())}
        r.assert_eof()
        if previous_cycle == current_cycle:
            return cls(previous_cycle, previous, next_)
        if previous_cycle == current_cycle - 1 and not current_as_next:
            return cls(previous_cycle, previous, next_)
        if previous_cycle == current_cycle - 1 and current_as_next:
            return cls(current_cycle, next_, {})
        if previous_cycle == current_cycle - 2 and not current_as_next:
            return cls(previous_cycle + 1, next_, {})
        return cls(current_cycle, {}, {})

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ValidatorAttendance)
            and self.previous_cycle == other.previous_cycle
            and self._previous == other._previous
        )
