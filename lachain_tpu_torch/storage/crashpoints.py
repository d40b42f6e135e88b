"""Deterministic crash-point injection for the storage and commit paths.

The port of `lachain_tpu/storage/crashpoints.py`. The seeded fault plans
(network/faults.py) provoke loss on the wire; this module provokes the
loss of the process at named points inside multi-write commits, so that
crash recovery (the send journal's replay) can be tested against every
torn state those commits can leave, reproducibly.

A :class:`CrashPlan` is a declarative schedule of :class:`CrashPoint`s:
each names an instrumented site and the 1-based traversal count at which
it fires. The Nth traversal of a named site is the same event in every
run of the same workload, so a plan repeats bit for bit.

Two harnesses execute a plan:

  * in-process (`mode="raise"`): the point raises :class:`InjectedCrash`,
    a BaseException like SystemExit, so that ordinary ``except Exception``
    recovery cannot swallow it (a real SIGKILL cannot be caught either);
  * real subprocess (`mode="sigkill"`): the point sends SIGKILL to its own
    process, so the torn state on disk comes from a real death.

An instrumented site calls :func:`crash_point`, which costs one global
read while no plan is armed. A child process arms from the
``LACHAIN_CRASH_POINTS`` environment variable (comma-separated
``NAME[@HIT][:MODE]`` specs, the JAX package's name and syntax, so one
plan string arms a child of either package) through :func:`arm_from_env`.

Instrumented point names in the port:

  kv.write_batch.pre / .mid / .post   SqliteKV's atomic batch (mid: the
                                      writes made, the fsynced commit not)

The reference's block, shrink, pool, LSM and trie sites wait for those
modules (ROADMAP A item 13).
"""
from __future__ import annotations

import os
import signal
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ENV_VAR = "LACHAIN_CRASH_POINTS"

MODE_RAISE = "raise"
MODE_SIGKILL = "sigkill"


class InjectedCrash(BaseException):
    """In-process stand-in for a process death at a crash point."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point} (hit {hit})")
        self.point = point
        self.hit = hit


@dataclass(frozen=True)
class CrashPoint:
    """Fire at the `hit`-th traversal of the instrumented site `name`."""

    name: str
    hit: int = 1
    mode: str = MODE_RAISE


@dataclass(frozen=True)
class CrashPlan:
    """Deterministic crash schedule: a frozen declarative plan; the live
    state lives in its session."""

    points: Tuple[CrashPoint, ...] = ()

    def session(self) -> "CrashSession":
        return CrashSession(self)

    @staticmethod
    def parse_point(spec: str) -> CrashPoint:
        """"NAME[@HIT][:MODE]", e.g. "kv.write_batch.mid@3:sigkill"."""
        name, _, mode = spec.partition(":")
        mode = mode or MODE_RAISE
        if mode not in (MODE_RAISE, MODE_SIGKILL):
            raise ValueError(
                f"crash point {spec!r}: mode must be "
                f"{MODE_RAISE!r} or {MODE_SIGKILL!r}"
            )
        name, _, hit_s = name.partition("@")
        if not name:
            raise ValueError(f"crash point {spec!r}: empty name")
        return CrashPoint(name=name, hit=int(hit_s) if hit_s else 1, mode=mode)

    @classmethod
    def parse(cls, specs) -> "CrashPlan":
        return cls(points=tuple(cls.parse_point(s) for s in specs if s))

    def encode_env(self) -> str:
        """The ENV_VAR value that re-arms this plan in a child process."""
        return ",".join(
            f"{p.name}@{p.hit}:{p.mode}" for p in self.points
        )


class CrashSession:
    """One armed execution of a CrashPlan: traversal counters and the log
    of the points fired."""

    def __init__(self, plan: CrashPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []
        self._by_name: Dict[str, List[CrashPoint]] = {}
        for p in plan.points:
            self._by_name.setdefault(p.name, []).append(p)

    def visit(self, name: str) -> Optional[CrashPoint]:
        """Count one traversal of `name`; return the point due to fire."""
        with self._lock:
            count = self.hits.get(name, 0) + 1
            self.hits[name] = count
        for p in self._by_name.get(name, ()):
            if p.hit == count:
                self.fired.append((name, count))
                return p
        return None

    @property
    def stats(self) -> Dict[str, object]:
        return {"visited": dict(self.hits), "fired": list(self.fired)}


# -- global arming (one plan a process) ----------------------------------------

_session: Optional[CrashSession] = None


def arm(plan: CrashPlan) -> CrashSession:
    global _session
    _session = plan.session()
    return _session


def disarm() -> Optional[CrashSession]:
    global _session
    s, _session = _session, None
    return s


def active() -> Optional[CrashSession]:
    return _session


@contextmanager
def armed(plan: CrashPlan):
    s = arm(plan)
    try:
        yield s
    finally:
        disarm()


def arm_from_env() -> Optional[CrashSession]:
    """Arm from LACHAIN_CRASH_POINTS (the child process's path); nothing
    when it is unset."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return None
    return arm(CrashPlan.parse(spec.split(",")))


def crash_point(name: str) -> None:
    """Instrumented-site hook: nothing unless a plan is armed and due."""
    s = _session
    if s is None:
        return
    point = s.visit(name)
    if point is None:
        return
    if point.mode == MODE_SIGKILL:
        os.kill(os.getpid(), signal.SIGKILL)
    raise InjectedCrash(name, point.hit)
