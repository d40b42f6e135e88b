"""The port's ValidatorAttendance (`lachain_tpu_torch/consensus/attendance.py`)
against the JAX package's (`lachain_tpu/consensus/attendance.py`): the same
counts give the same bytes, and `from_bytes` rotates the window the same way
in each of its five branches (ref attendance.py:63-80), each package
decoding the other's bytes."""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.consensus.attendance import ValidatorAttendance as JaxAttendance
from lachain_tpu_torch.consensus.attendance import ValidatorAttendance

torch.set_num_threads(1)

PK = [bytes([i + 1]) * 33 for i in range(6)]


def filled(cls, previous_cycle: int, seed: int):
    """An attendance of `cls` with seeded counts in both cycles of its
    window (and increments outside it, which are ignored)."""
    rng = random.Random(seed)
    a = cls(previous_cycle)
    for _ in range(40):
        a.increment(rng.choice(PK), previous_cycle + rng.randrange(-1, 3))
    return a


def view(a, cycles) -> tuple:
    """What an attendance answers: its window, every count, its bytes."""
    return (a.previous_cycle, a.next_cycle,
            [a.get(pk, c) for pk in PK for c in cycles],
            [sorted(a.counts_for(c).items()) for c in cycles], a.to_bytes())


def test_increment_and_get():
    a = ValidatorAttendance(previous_cycle=5)
    a.increment(PK[0], 5)
    a.increment(PK[0], 5)
    a.increment(PK[0], 6)
    a.increment(PK[0], 7)  # outside the window: ignored
    assert (a.get(PK[0], 5), a.get(PK[0], 6), a.get(PK[0], 7), a.get(PK[1], 5)) == (2, 1, 0, 0)
    assert a.counts_for(5) == {PK[0]: 2} and a.counts_for(7) == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bytes_equal_the_jax_package(seed):
    port, jax = filled(ValidatorAttendance, 9, seed), filled(JaxAttendance, 9, seed)
    assert view(port, range(7, 12)) == view(jax, range(7, 12))
    assert port == ValidatorAttendance.from_bytes(port.to_bytes(), 9, current_as_next=False)


# (current cycle, current_as_next) against a window starting at cycle 5:
# the same cycle; the next, not as next; the next, as next; two ahead, not
# as next; and the two fall-throughs (two ahead as next, three ahead)
BRANCHES = [(5, False), (5, True), (6, False), (6, True), (7, False), (7, True), (8, False),
            (4, False)]


@pytest.mark.parametrize("current, as_next", BRANCHES)
def test_from_bytes_rotates_as_the_jax_package(current, as_next):
    port, jax = filled(ValidatorAttendance, 5, 7), filled(JaxAttendance, 5, 7)
    raw = port.to_bytes()
    assert raw == jax.to_bytes()
    got = ValidatorAttendance.from_bytes(raw, current, current_as_next=as_next)
    want = JaxAttendance.from_bytes(raw, current, current_as_next=as_next)
    cross = ValidatorAttendance.from_bytes(jax.to_bytes(), current, current_as_next=as_next)
    back = JaxAttendance.from_bytes(port.to_bytes(), current, current_as_next=as_next)
    assert view(got, range(3, 10)) == view(want, range(3, 10)) == view(cross, range(3, 10)) \
        == view(back, range(3, 10))


def test_window_rotation_drops_stale_cycles():
    a = ValidatorAttendance(5)
    a.increment(PK[0], 5)
    a.increment(PK[1], 6)
    raw = a.to_bytes()
    same = ValidatorAttendance.from_bytes(raw, 5, current_as_next=False)
    assert same == a and same.get(PK[1], 6) == 1
    slid = ValidatorAttendance.from_bytes(raw, 6, current_as_next=True)
    assert slid.previous_cycle == 6 and slid.get(PK[1], 6) == 1 and slid.get(PK[0], 5) == 0
    fresh = ValidatorAttendance.from_bytes(raw, 8, current_as_next=False)
    assert fresh.previous_cycle == 8 and fresh.get(PK[0], 8) == 0


def test_trailing_bytes_refused_as_in_the_jax_package():
    raw = filled(ValidatorAttendance, 3, 1).to_bytes() + b"\x00"
    with pytest.raises(Exception):
        ValidatorAttendance.from_bytes(raw, 3, current_as_next=False)
    with pytest.raises(Exception):
        JaxAttendance.from_bytes(raw, 3, current_as_next=False)
