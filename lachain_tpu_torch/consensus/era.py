"""Era router: creates protocol instances on demand and routes envelopes.

The port of `lachain_tpu/consensus/era.py`, with the behavior of the C#
reference's EraBroadcaster:
  * one protocol instance per id, created on first reference
  * external payload -> protocol id routing
  * id validation: the era must match, indices in range
  * terminated protocols drop further traffic
  * Request/Result plumbing between parents and children
  * the per-(sender, slot) first-seen latch (reference :295-333): a later,
    different payload for a slot is equivocation, recorded as evidence
    and dropped
  * the retransmission outbox per era, `advance_era` (drops the protocols,
    outboxes, latches and journal entries of finished eras) and the
    postponed-message window for future eras, bounded per sender.

The router is synchronous and deterministic: the delivery layer
(simulator.py) decides when `dispatch_external` runs, the router only
where an envelope goes; outbound payloads leave through the `send(target,
payload)` callback (target None: every validator, self included).

Differences, by the port's rules: the router carries the crypto `backend`
its protocols use (a GpuBackend on `device` unless one is given: on the
card by default, and without a card that raises), its random generator
`rng` (the TPKE encryption and the host RLC weights) and `memo`
(provider.CryptoMemo, shared by the simulator's routers); the coin's
combine seconds add up in `coin_s`, and the messages the per-sender caps
shed in the plain attribute `shed` (`latch_cap`, `postponed_cap`: what the
reference counts under `consensus_msgs_shed_total`); the sends the journal
substituted count in `replayed_sends` (the reference's
`consensus_journal_replayed_sends_total`).

Durable sends: given a `journal` (journal.ConsensusJournal), every
outbound payload is recorded before it is transmitted, and a payload for a
slot already sent (in this run, or before a crash and re-armed from the
journal by `rearm_sent`) is replaced by the recorded bytes, so that a
restarted validator cannot contradict its pre-crash self. A journal write
that fails raises out of the send, and the payload is not transmitted.

Not ported: the pipelined-era window (`window_floor`, `pipeline_window`,
`open_era`, `commit_era_gc`: ROADMAP A item 11), metrics and tracing.
"""
from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import messages as M
from .binary_agreement import BinaryAgreement
from .binary_broadcast import BinaryBroadcast
from .common_coin import CommonCoin
from .common_subset import CommonSubset
from .evidence import EvidenceStore, describe_slot
from .honey_badger import HoneyBadger
from .journal import send_slot
from .keys import PrivateConsensusKeys, PublicConsensusKeys
from .protocol import Broadcaster, Protocol
from .reliable_broadcast import ReliableBroadcast
from ..crypto.provider import CryptoMemo
from ..network import wire

logger = logging.getLogger("lachain_tpu_torch.consensus.era")


class EraRouter(Broadcaster):
    def __init__(
        self,
        era: int,
        my_id: int,
        public_keys: PublicConsensusKeys,
        private_keys: PrivateConsensusKeys,
        send: Callable[[Optional[int], Any], None],
        rng,
        device="cuda",
        backend=None,
        extra_factories: Optional[Dict[type, Callable]] = None,
        journal=None,
        evidence: Optional[EvidenceStore] = None,
        memo: Optional[CryptoMemo] = None,
    ):
        if backend is None:
            from ..crypto.gpu_backend import GpuBackend

            backend = GpuBackend(device)
        self.era = era
        self._my_id = my_id
        self.public_keys = public_keys
        self.private_keys = private_keys
        self._send = send
        self.rng = rng
        self.backend = backend
        self.memo = memo if memo is not None else CryptoMemo()
        self.evidence = evidence if evidence is not None else EvidenceStore()
        # the era's flush batchers, wired on by the network; None = the
        # protocols call the codec and the era op inline
        self.crypto_batcher = None
        self.rbc_batcher = None
        self.coin_s = 0.0
        # messages dropped by the per-sender caps, by cap
        self.shed = {"latch_cap": 0, "postponed_cap": 0}
        self._protocols: Dict[Any, Protocol] = {}
        self._extra_factories = extra_factories or {}
        self.terminated = False
        # future-era messages buffered until the era advances, bounded PER
        # SENDER so that one byzantine validator cannot starve honest traffic
        self._postponed: list = []
        self._postponed_per_sender: Dict[int, int] = {}
        self._postponed_sender_cap = 256
        # per-(sender, slot) first-seen latch: the first payload a sender
        # ships for a decision slot is pinned; a later different payload
        # for the same slot is equivocation. Bounded per sender.
        self._first_seen: Dict[tuple, Any] = {}
        self._first_seen_per_sender: Dict[int, int] = {}
        self.first_seen_sender_cap = 2048
        # retransmission outbox: every payload this router sent, per era
        # (target None = broadcast), bounded FIFO; a peer's message request
        # for an era is answered from here
        self._outbox: Dict[int, deque] = {}
        self.outbox_cap = 4096  # entries per era; oldest evicted first
        # durable-send latches: (era, slot) -> recorded wire bytes. A slot
        # here was already sent (in this run, or before a crash and re-armed
        # by rearm_sent); a later send for it re-uses the recorded bytes.
        # Pruned with the protocol GC.
        self._journal = journal
        self._sent_slots: Dict[Tuple[int, tuple], bytes] = {}
        self.replayed_sends = 0

    # -- Broadcaster interface ----------------------------------------------
    @property
    def my_id(self) -> int:
        return self._my_id

    @property
    def n_validators(self) -> int:
        return self.public_keys.n

    @property
    def f(self) -> int:
        return self.public_keys.f

    def broadcast(self, payload) -> None:
        payload = self._durable_send(None, payload)
        self._record_outbox(None, payload)
        self._send(None, payload)

    def send_to(self, validator: int, payload) -> None:
        payload = self._durable_send(validator, payload)
        self._record_outbox(validator, payload)
        self._send(validator, payload)

    def _payload_era(self, payload) -> int:
        try:
            return getattr(M.payload_protocol_id(payload), "era", self.era)
        except TypeError:
            return self.era

    # -- durable sends (the crash-recovery journal) ----------------------------
    def _durable_send(self, target: Optional[int], payload):
        """Persist-before-transmit -> the payload to send. The substitution
        happens before the outbox record and before the transport's
        self-delivery, so the validator's own protocol state is rebuilt
        from exactly the bytes its peers saw before the crash."""
        if self._journal is None:
            return payload
        slot = send_slot(payload)
        era = self._payload_era(payload)
        if slot is not None:
            recorded = self._sent_slots.get((era, slot))
            if recorded is not None:
                # the slot was durably sent: the recorded bytes again, never
                # the re-derived value, and no second record
                self.replayed_sends += 1
                return wire.decode_payload(recorded)
        data = wire.encode_payload(payload)
        self._journal.record(era, target, data)
        if slot is not None:
            self._sent_slots[(era, slot)] = data
        return payload

    def rearm_sent(self, era: int, target: Optional[int], data: bytes) -> None:
        """Recovery: re-arm the sent latch and re-seed the outbox from one
        journaled record. It is durable already: not journaled again, and
        not transmitted here (peers pull retransmissions)."""
        try:
            payload = wire.decode_payload(data)
        except ValueError:
            logger.warning("undecodable journal entry for era %d", era)
            return
        slot = send_slot(payload)
        if slot is not None and (era, slot) not in self._sent_slots:
            self._sent_slots[(era, slot)] = data
        q = self._outbox.get(era)
        if q is None:
            q = self._outbox[era] = deque()
        if len(q) < self.outbox_cap:
            q.append((target, payload))

    # -- retransmission outbox ------------------------------------------------
    def _record_outbox(self, target: Optional[int], payload) -> None:
        era = self._payload_era(payload)
        q = self._outbox.get(era)
        if q is None:
            q = self._outbox[era] = deque()
        if len(q) >= self.outbox_cap:
            q.popleft()
        q.append((target, payload))

    def outbox_payloads(self, era: int, requester: int) -> List[Any]:
        """Everything this router sent in `era` that `requester` should
        have seen: broadcasts plus messages addressed to it directly."""
        return [
            payload
            for target, payload in self._outbox.get(era, ())
            if target is None or target == requester
        ]

    def replay_outbox(
        self, era: int, requester: int, limit: Optional[int] = None
    ) -> int:
        """Re-send `era`'s outbox to `requester`, straight through the
        transport (a replay is not recorded again); `limit` caps the
        batch, in send order."""
        payloads = self.outbox_payloads(era, requester)
        if limit is not None:
            payloads = payloads[:limit]
        for payload in payloads:
            self._send(requester, payload)
        return len(payloads)

    def internal_request(self, req: M.Request) -> None:
        proto = self._ensure_protocol(req.to_id)
        if proto is not None:
            proto.receive(req)

    def internal_response(self, res: M.Result) -> None:
        if res.to_id is None:
            return  # top-level protocol: result observed via .result
        proto = self._protocols.get(res.to_id)
        if proto is not None:
            proto.receive(res)

    # -- dispatch ------------------------------------------------------------
    def dispatch_external(self, sender: int, payload) -> None:
        """Route a validator's payload to its protocol (creating it)."""
        if self.terminated:
            return
        try:
            pid = M.payload_protocol_id(payload)
        except TypeError:
            logger.warning("unroutable payload from %d", sender)
            return
        msg_era = getattr(pid, "era", None)
        if msg_era is not None and msg_era != self.era:
            if msg_era > self.era:
                # a faster validator is already in a future era: buffer
                # until we advance
                cnt = self._postponed_per_sender.get(sender, 0)
                if cnt < self._postponed_sender_cap:
                    self._postponed_per_sender[sender] = cnt + 1
                    self._postponed.append((sender, payload))
                else:
                    # the sender's buffer is full: its traffic sheds, the
                    # other senders' buffers are unaffected
                    self.shed["postponed_cap"] += 1
            return
        if not self._validate_id(pid):
            logger.warning("invalid protocol id %s from %d", pid, sender)
            return
        if not self._latch_first_seen(sender, payload):
            return  # equivocation (recorded) or latch budget shed
        proto = self._ensure_protocol(pid)
        if proto is not None:
            proto.receive(M.External(sender=sender, payload=payload))

    def _latch_first_seen(self, sender: int, payload) -> bool:
        """False when the payload must be dropped: it conflicts with the
        sender's first-seen payload for its slot (evidence recorded), or the
        sender exhausted its latch budget. Equal duplicates pass: the
        protocols' own dedupe handles them."""
        slot = send_slot(payload)
        if slot is None:
            return True
        key = (sender, slot)
        prev = self._first_seen.get(key)
        if prev is None:
            cnt = self._first_seen_per_sender.get(sender, 0)
            if cnt >= self.first_seen_sender_cap:
                self.shed["latch_cap"] += 1
                return False
            self._first_seen_per_sender[sender] = cnt + 1
            self._first_seen[key] = payload
            return True
        if prev == payload:
            return True
        proto, index = describe_slot(slot)
        if self.evidence.record_equivocation(
            self._payload_era(payload), sender, proto, index
        ):
            logger.warning(
                "equivocation from %d in slot %s%s: conflicting payloads",
                sender, proto, index,
            )
        return False

    def advance_era(self, new_era: int) -> None:
        """Move forward to a new era and replay the buffered future-era
        messages. Eras never regress: a stale call is a no-op. The
        protocols of eras before the last active one are dropped, with
        their outboxes, latches and journal entries; the last active era
        stays for late result_of queries."""
        if new_era <= self.era:
            return
        cutoff = min(new_era - 1, self.era)
        self.era = new_era
        self._gc_below(cutoff)
        self._replay_postponed()

    def _gc_below(self, cutoff: int) -> None:
        for pid in [p for p in self._protocols if getattr(p, "era", cutoff) < cutoff]:
            del self._protocols[pid]
        for e in [e for e in self._outbox if e < cutoff]:
            del self._outbox[e]
        for key in [k for k in self._sent_slots if k[0] < cutoff]:
            del self._sent_slots[key]
        # slot[1] is the protocol id; its era keys the latch entry
        for key in [
            k for k in self._first_seen if getattr(k[1][1], "era", cutoff) < cutoff
        ]:
            sender = key[0]
            cnt = self._first_seen_per_sender.get(sender, 0)
            if cnt > 1:
                self._first_seen_per_sender[sender] = cnt - 1
            else:
                self._first_seen_per_sender.pop(sender, None)
            del self._first_seen[key]
        if self._journal is not None:
            self._journal.prune_below(cutoff)

    def _replay_postponed(self) -> None:
        pending, self._postponed = self._postponed, []
        self._postponed_per_sender = {}
        for sender, payload in pending:
            self.dispatch_external(sender, payload)

    def result_of(self, pid) -> Any:
        proto = self._protocols.get(pid)
        return proto.result if proto else None

    def protocol(self, pid) -> Optional[Protocol]:
        return self._protocols.get(pid)

    # -- validation ----------------------------------------------------------
    def _validate_id(self, pid) -> bool:
        era = getattr(pid, "era", None)
        if era != self.era:
            return False
        n = self.n_validators
        if isinstance(pid, M.ReliableBroadcastId):
            return 0 <= pid.sender_id < n
        if isinstance(pid, M.BinaryAgreementId):
            return 0 <= pid.agreement < n
        if isinstance(pid, (M.BinaryBroadcastId, M.CoinId)):
            ok = 0 <= pid.agreement < n or pid.agreement == -1
            return ok and pid.epoch >= 0
        return True

    # -- factory -------------------------------------------------------------
    def _ensure_protocol(self, pid) -> Optional[Protocol]:
        proto = self._protocols.get(pid)
        if proto is not None:
            return None if proto.terminated else proto
        if getattr(pid, "era", self.era) < self.era:
            # a dead era's instances are collected on advance: a stale
            # internal request must not resurrect one
            return None
        proto = self._create(pid)
        if proto is None:
            logger.warning("no factory for protocol id %s", pid)
            return None
        self._protocols[pid] = proto
        return proto

    def _create(self, pid) -> Optional[Protocol]:
        if type(pid) in self._extra_factories:
            return self._extra_factories[type(pid)](pid, self)
        if isinstance(pid, M.BinaryBroadcastId):
            return BinaryBroadcast(pid, self)
        if isinstance(pid, M.CoinId):
            return CommonCoin(
                pid,
                self,
                self.private_keys.ts_share,
                self.public_keys.ts_keys,
            )
        if isinstance(pid, M.BinaryAgreementId):
            return BinaryAgreement(pid, self)
        if isinstance(pid, M.ReliableBroadcastId):
            return ReliableBroadcast(pid, self)
        if isinstance(pid, M.CommonSubsetId):
            return CommonSubset(pid, self)
        if isinstance(pid, M.HoneyBadgerId):
            return HoneyBadger(
                pid, self, self.public_keys, self.private_keys
            )
        return None
