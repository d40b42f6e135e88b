"""Deterministic in-process multi-validator simulator with adversarial
delivery.

The port of `lachain_tpu/consensus/simulator.py`, the counterpart of the
C# reference's consensus test harness (DeliveryService, BroadcastSimulator):
  * one EraRouter per validator and one shared delivery queue, drained in
    TAKE_FIRST / TAKE_LAST / TAKE_RANDOM order with seeded duplicate
    injection (`repeat_probability`);
  * muted ("crashed") validators: no outbound and no inbound traffic;
  * a seeded `FaultPlan` (network/faults.py): drop, delay, duplicate and
    reorder faults on every link, crash / restart windows and healing
    partitions, clocked by the delivered-message count (`_vtime`); lost
    messages are repaired as a node repairs them, by replaying each
    router's outbox for the era (`_recover`, the in-process model of the
    message_request exchange), at quiescence after both flushes, at most
    `max_recovery_rounds` times;
  * the era's two flush batchers shared by every router: the TPKE flush
    (consensus/crypto_batcher.TpkeEraBatcher, on by default) runs once
    every queued DecryptedMessage has been delivered (`_maybe_flush`) and
    at quiescence; the RBC flush (consensus/rbc_batcher.RbcEraBatcher, off
    by default so that the seeded schedules stay the reference's) runs at
    quiescence, before the TPKE flush.
Delivery is a single seeded loop: one seed replays one execution. Send
journals (consensus/journal.py) reach the routers through `router_cls`,
as in the reference: `router_cls=lambda **kw: EraRouter(journal=
journals[kw["my_id"]], **kw)`.

Differences, by the port's rules: the crypto runs on `backend`, a
GpuBackend on `device` unless one is given ("cuda" by default: without a
card construction raises), and both batchers run on that device. The
random generators are explicit: the delivery order draws from
random.Random(seed) as in the reference, each router's TPKE encryption
and host RLC weights from `SeededRng(("router", seed, i))` where the
reference draws from `secrets`, and the TPKE batcher's RLC weights from
`SeededRng(("rlc", seed))`. A failed flush raises out of `run`. What a
chip run reads is kept as plain attributes (`delivered_count`, the
batchers' counters, `tpke_phase_s` / `rbc_phase_s`: each batcher's
`last_timings` phases summed over the era's flushes, `coin_s`, the fault
session's `stats`, `recovery_rounds`) in place of the reference's metrics
and tracing: the queue-depth gauge and the `tracing.wait` span around the
recovery are not carried.
"""
from __future__ import annotations

import enum
import heapq
import random
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from . import messages as M
from .era import EraRouter
from .keys import PrivateConsensusKeys, PublicConsensusKeys
from ..crypto.provider import CryptoMemo

TPKE_CHUNK_PHASES = ("pack_s", "launch_s", "device_s", "wait_s", "fetch_s", "pairing_s")


class DeliveryMode(enum.Enum):
    TAKE_FIRST = "first"
    TAKE_LAST = "last"
    TAKE_RANDOM = "random"


class SeededRng:
    """`randbelow` over a random.Random seeded with `seed` (an int, str or
    tuple of them): the rng API the port's crypto takes."""

    def __init__(self, seed):
        self._r = random.Random(repr(seed))

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


class SimulatedNetwork:
    """N validators, one EraRouter each, a shared adversarial delivery queue."""

    def __init__(
        self,
        public_keys: PublicConsensusKeys,
        private_keys: List[PrivateConsensusKeys],
        era: int = 0,
        seed: int = 0,
        mode: DeliveryMode = DeliveryMode.TAKE_FIRST,
        repeat_probability: float = 0.0,
        muted: Optional[Set[int]] = None,
        extra_factories: Optional[Dict[type, Callable]] = None,
        router_cls=EraRouter,
        use_crypto_batcher: bool = True,
        use_rbc_batcher: bool = False,
        device="cuda",
        backend=None,
        fault_plan=None,
        max_recovery_rounds: int = 16,
    ):
        if backend is None:
            from ..crypto.gpu_backend import GpuBackend

            backend = GpuBackend(device)
        self.n = public_keys.n
        self.seed = seed
        self.backend = backend
        self.rng = random.Random(seed)
        self.mode = mode
        self.repeat_probability = repeat_probability
        self.muted = muted or set()
        # the seeded fault schedule, clocked by the delivered-message count
        # so that two runs of one seed replay one fault sequence
        self.fault_plan = fault_plan
        self._vtime = 0.0
        self.faults = (
            fault_plan.session(clock=lambda: self._vtime)
            if fault_plan is not None
            else None
        )
        self.recovery_rounds = 0
        self.max_recovery_rounds = max_recovery_rounds
        # (sender, target, payload). A deque for FIFO/LIFO, a plain list for
        # RANDOM (indexed swap-with-last + pop from the end), so every pop
        # is O(1) at the 2.6M messages of an N=64 era
        self._queue = [] if mode is DeliveryMode.TAKE_RANDOM else deque()
        # time-armed copies (fault delays, shaped latency): a heap of
        # (ready_at, seq, sender, target, payload), surfaced once the virtual
        # clock reaches ready_at; seq keeps the pops deterministic and the
        # payloads out of the comparisons
        self._delayed: List[Tuple[float, int, int, int, Any]] = []
        self._delay_seq = 0
        self.memo = CryptoMemo()
        self.delivered_count = 0
        self._decrypted_in_queue = 0
        self.tpke_phase_s: Dict[str, float] = {}
        self.rbc_phase_s: Dict[str, float] = {}
        self.crypto_batcher = None
        if use_crypto_batcher:
            from .crypto_batcher import TpkeEraBatcher

            self.crypto_batcher = TpkeEraBatcher(backend, SeededRng(("rlc", seed)))
        self.rbc_batcher = None
        if use_rbc_batcher:
            from .rbc_batcher import RbcEraBatcher

            self.rbc_batcher = RbcEraBatcher(backend.device)
        self.routers: List[EraRouter] = [
            self.make_router(i, era, public_keys, private_keys[i],
                             extra_factories, router_cls)
            for i in range(self.n)
        ]

    def make_router(self, i: int, era: int, public_keys, private_keys,
                    extra_factories=None, router_cls=EraRouter):
        """Validator i's router on the network's backend, memo, batchers,
        transport and seeded rng (tests swap in routers of their own
        class)."""
        router = router_cls(
            era=era,
            my_id=i,
            public_keys=public_keys,
            private_keys=private_keys,
            send=self._make_send(i),
            rng=SeededRng(("router", self.seed, i)),
            backend=self.backend,
            extra_factories=extra_factories,
            memo=self.memo,
        )
        router.crypto_batcher = self.crypto_batcher
        router.rbc_batcher = self.rbc_batcher
        return router

    @property
    def coin_s(self) -> float:
        """Seconds every router spent combining coins."""
        return sum(r.coin_s for r in self.routers)

    def _make_send(self, sender: int):
        def send(target: Optional[int], payload) -> None:
            if sender in self.muted:
                return  # crashed player: no outbound traffic
            if self.faults is not None and self.faults.crashed(sender):
                return  # a scheduled crash window: no outbound traffic
            self.inject(sender, target, payload)

        return send

    def inject(self, sender: int, target: Optional[int], payload) -> None:
        """Enqueue a payload as if `sender` sent it, bypassing its router
        (and its crash window: the adversary's transport). target None =
        broadcast. Keeps the DecryptedMessage count that triggers the TPKE
        flush."""
        if type(payload) is M.DecryptedMessage:
            self._decrypted_in_queue += self.n if target is None else 1
        if target is None:
            for t in range(self.n):
                self._queue.append((sender, t, payload))
        else:
            self._queue.append((sender, target, payload))

    # -- adversarial queue ----------------------------------------------------
    def _pop(self) -> Tuple[int, int, Any]:
        if self.mode is DeliveryMode.TAKE_FIRST:
            item = self._queue.popleft()
        elif self.mode is DeliveryMode.TAKE_LAST:
            item = self._queue.pop()
        else:
            # uniform random choice via swap-with-last + list pop: O(1)
            idx = self.rng.randrange(len(self._queue))
            last = self._queue.pop()
            if idx < len(self._queue):
                item = self._queue[idx]
                self._queue[idx] = last
            else:
                item = last
        if self.repeat_probability > 0 and self.rng.random() < self.repeat_probability:
            if type(item[2]) is M.DecryptedMessage:
                self._decrypted_in_queue += 1
            self._queue.append(item)  # duplicate injection
        if self.faults is not None and self._queue and self.faults.reorder_hit():
            # the fault plan's reordering: swap the picked message with a
            # random queued one (composes with any DeliveryMode)
            idx = self.faults.rng.randrange(len(self._queue))
            item, self._queue[idx] = self._queue[idx], item
        return item

    # -- execution ------------------------------------------------------------
    def post_request(self, validator: int, pid, value) -> None:
        """Inject a top-level ProtocolRequest into one validator."""
        self.routers[validator].internal_request(
            M.Request(from_id=None, to_id=pid, input=value)
        )

    def run(
        self,
        done: Callable[[], bool],
        max_messages: int = 1_000_000,
    ) -> bool:
        """Deliver until `done()` or quiescence; True iff done() held. More
        than `max_messages` deliveries raise (a livelock)."""
        while not done():
            if self._delayed and self._delayed[0][0] <= self._vtime:
                # a time-armed copy's moment has come: delivered directly,
                # its link decision was made when it was armed
                if self.delivered_count >= max_messages:
                    raise RuntimeError(
                        f"message cap {max_messages} exceeded — livelock?"
                    )
                _, _, sender, target, payload = heapq.heappop(self._delayed)
                self.delivered_count += 1
                self._vtime += 1.0
                if type(payload) is M.DecryptedMessage:
                    self._decrypted_in_queue -= 1
                if target not in self.muted and not self.faults.crashed(target):
                    self.routers[target].dispatch_external(sender, payload)
                self._maybe_flush()
                continue
            if not self._queue:
                if self._delayed:
                    # everything undelivered is in flight on a delayed link:
                    # the clock jumps to the earliest arrival
                    self._vtime = max(self._vtime, self._delayed[0][0])
                    continue
                # RBC before TPKE: interpolation verdicts unblock the READY
                # and delivery traffic that feeds the ACS, whose completions
                # grow the decryption-share batches
                if self.rbc_batcher is not None and self.rbc_batcher.pending:
                    self._flush_rbc()
                    continue
                if self.crypto_batcher is not None and self.crypto_batcher.pending:
                    self._flush_tpke()
                    continue
                if self.faults is not None and self._recover():
                    continue
                return done()
            if self.delivered_count >= max_messages:
                raise RuntimeError(
                    f"message cap {max_messages} exceeded — livelock?"
                )
            sender, target, payload = self._pop()
            self.delivered_count += 1
            self._vtime += 1.0
            if type(payload) is M.DecryptedMessage:
                self._decrypted_in_queue -= 1
            deliver = True
            if self.faults is not None and sender != target:
                # self-delivery never crosses the network: only link
                # traffic is lost, duplicated, delayed or partitioned
                delays = self.faults.decide(sender, target)
                deliver = bool(delays) and delays[0] <= 0
                for d in delays[1:] if deliver else delays:
                    if type(payload) is M.DecryptedMessage:
                        self._decrypted_in_queue += 1
                    if d <= 0:
                        # a duplicate: a second traversal of the link, its
                        # fate rolled again like any fresh send
                        self._queue.append((sender, target, payload))
                    else:
                        self._delay_seq += 1
                        heapq.heappush(self._delayed, (
                            self._vtime + d, self._delay_seq, sender, target, payload))
            elif self.faults is not None and self.faults.crashed(target):
                deliver = False  # crashed: not even self-delivery
            if deliver and target not in self.muted:
                self.routers[target].dispatch_external(sender, payload)
            self._maybe_flush()
        return True

    def _maybe_flush(self) -> None:
        """Flush the TPKE batcher once every queued DecryptedMessage has
        been delivered: the cross-validator batch is at its largest."""
        b = self.crypto_batcher
        if b is not None and b.pending and self._decrypted_in_queue == 0:
            self._flush_tpke()

    def _flush_tpke(self) -> None:
        flush_tpke(self.crypto_batcher, self.tpke_phase_s)

    def _flush_rbc(self) -> None:
        flush_rbc(self.rbc_batcher, self.rbc_phase_s)

    def _recover(self) -> bool:
        """Quiescent but not done under a fault plan: jump the virtual
        clock to the next schedule boundary (partitions heal and crashed
        nodes restart only as time passes), then replay every live router's
        outbox for its era to every live requester across the links open
        now. True when a message was queued again; after
        `max_recovery_rounds` rounds False, so that an unrecoverable plan
        (f + 1 permanent crashes, a partition that never heals) ends."""
        f = self.faults
        if self.recovery_rounds >= self.max_recovery_rounds:
            return False
        boundary = f.next_boundary(self._vtime)
        if boundary is not None:
            self._vtime = max(self._vtime, boundary)
        self.recovery_rounds += 1
        requeued = 0
        for requester in range(self.n):
            if requester in self.muted or f.crashed(requester):
                continue
            for responder in range(self.n):
                if (
                    responder == requester
                    or responder in self.muted
                    or f.crashed(responder)
                    or f.partitioned(responder, requester)
                ):
                    continue
                router = self.routers[responder]
                requeued += router.replay_outbox(router.era, requester)
        return requeued > 0

    def results(self, pid) -> List[Any]:
        return [r.result_of(pid) for r in self.routers]


def flush_tpke(b, acc: Dict[str, float]) -> None:
    """Flush the TPKE batcher `b` and add its last_timings phases (the
    chunks' summed) to `acc`, unless no lazy submission had a slot ready."""
    flushes = b.flushes
    b.flush()
    if b.flushes == flushes:
        return
    t = b.last_timings
    for k in ("build_s", "dedupe_s", "era_s", "callbacks_s", "wall_s"):
        acc[k] = acc.get(k, 0.0) + t[k]
    for chunk in t["chunks"]:
        for k in TPKE_CHUNK_PHASES:
            acc[k] = acc.get(k, 0.0) + chunk.get(k, 0.0)


def flush_rbc(b, acc: Dict[str, float]) -> None:
    """Flush the RBC batcher `b` and add its last_timings to `acc`."""
    b.flush()
    for k, v in b.last_timings.items():
        acc[k] = acc.get(k, 0.0) + v
