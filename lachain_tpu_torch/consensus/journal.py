"""Durable consensus send journal: persist-before-transmit.

The port of `lachain_tpu/consensus/journal.py`. Crash-recovery BFT must
persist what it sent before transmitting it, or a restarted validator can
equivocate against its pre-crash self: BA's AUX and CONF values and the
signed block header depend on the order in which messages arrive, so a
validator that re-runs an era from scratch after a restart can derive a
different value for a slot it already voted on, and two signed values for
one slot is Byzantine behaviour its peers convict.

The journal records every outbound consensus payload (era, target, wire
bytes of network/wire.py) under the `EntryPrefix.CONSENSUS_STATE`
keyspace, through the KV's fsynced `write_batch`, before the payload
reaches the transport. On restart the router replays it
(`EraRouter.rearm_sent`) to re-arm its "already sent" latches, so that
when the re-run era reaches a decision point again the recorded bytes are
sent, never a re-derived value, and to re-seed its retransmission outbox.
Entries are pruned with the protocol GC (`EraRouter.advance_era`).

Key layout: ``CONSENSUS_STATE | era u64 | seq u64`` ->
``i64(target, -1 = broadcast) | bytes(payload wire bytes)``.

The reference's counters are minted under its names,
`consensus_journal_records_total` and `consensus_journal_pruned_total`;
each journal's plain attributes `records` (records written) and `pruned`
(records dropped by prune_below), which the tests read, count beside them.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from . import messages as M
from ..storage.kv import EntryPrefix, KVStore, prefixed
from ..utils import metrics
from ..utils.serialization import Reader, write_bytes, write_i64, write_u64

_PREFIX = prefixed(EntryPrefix.CONSENSUS_STATE)


def send_slot(payload) -> Optional[tuple]:
    """The per-era decision slot a payload occupies: one durable value per
    slot, and a re-send must be byte-identical. The slot key identifies the
    decision point, not the value, except where the protocol legitimately
    sends both values (BVAL: a node may broadcast BVAL(0) and BVAL(1) in
    one epoch after seeing f+1 of the other; that is not equivocation, so
    the value is part of the slot). None for payloads that occupy no slot
    (journaled, never substituted)."""
    if isinstance(payload, M.ValMessage):
        # one VAL per recipient shard (the sender's proposal commitment)
        return ("val", payload.rbc, payload.shard_index)
    if isinstance(payload, M.EchoMessage):
        return ("echo", payload.rbc)
    if isinstance(payload, M.ReadyMessage):
        return ("ready", payload.rbc)
    if isinstance(payload, M.BValMessage):
        return ("bval", payload.bb, payload.value)
    if isinstance(payload, M.AuxMessage):
        return ("aux", payload.bb)
    if isinstance(payload, M.ConfMessage):
        return ("conf", payload.bb)
    if isinstance(payload, M.CoinMessage):
        return ("coin", payload.coin)
    if isinstance(payload, M.DecryptedMessage):
        return ("dec", payload.hb, payload.share_id)
    if isinstance(payload, M.SignedHeaderMessage):
        # the big one: two signed headers for one era is classic equivocation
        return ("hdr", payload.root)
    return None


class ConsensusJournal:
    """Append-only send journal over a KV store.

    A write goes through `write_batch`, the KV's fsynced path, so a record
    is durable before the send it covers leaves the validator. Sequence
    numbers are per era and continue across a reopen (seeded by a prefix
    scan here), so replayed entries keep their send order.
    """

    def __init__(self, kv: KVStore):
        self._kv = kv
        self._next_seq: Dict[int, int] = {}
        self.records = 0
        self.pruned = 0
        for era, seq, _target, _data in self.entries():
            if seq >= self._next_seq.get(era, 0):
                self._next_seq[era] = seq + 1

    def record(self, era: int, target: Optional[int], payload_bytes: bytes) -> None:
        """Durably append one send before it is transmitted; a failed
        write raises to the sender."""
        seq = self._next_seq.get(era, 0)
        key = _PREFIX + write_u64(era) + write_u64(seq)
        value = write_i64(-1 if target is None else target) + write_bytes(
            payload_bytes
        )
        self._kv.write_batch([(key, value)])
        self._next_seq[era] = seq + 1
        self.records += 1
        metrics.inc("consensus_journal_records_total")

    def entries(self) -> Iterator[Tuple[int, int, Optional[int], bytes]]:
        """Yield (era, seq, target, payload_bytes) in (era, seq) order;
        undecodable values are skipped."""
        for key, value in self._kv.scan_prefix(_PREFIX):
            tail = key[len(_PREFIX):]
            if len(tail) != 16:
                continue
            era = int.from_bytes(tail[:8], "big")
            seq = int.from_bytes(tail[8:], "big")
            try:
                r = Reader(value)
                target = r.i64()
                data = r.bytes_()
            except ValueError:
                continue
            yield era, seq, (None if target < 0 else target), data

    def eras(self) -> list:
        """Distinct eras with journaled sends, ascending."""
        return sorted({era for era, _seq, _target, _data in self.entries()})

    def prune_below(self, era_cutoff: int) -> int:
        """Drop the entries of eras < `era_cutoff` in one batched delete
        (settled eras recover by block sync, not replay); returns the
        number dropped."""
        doomed = [
            key
            for key, _ in self._kv.scan_prefix(_PREFIX)
            if len(key) == len(_PREFIX) + 16
            and int.from_bytes(key[len(_PREFIX):len(_PREFIX) + 8], "big")
            < era_cutoff
        ]
        if doomed:
            self._kv.write_batch([], doomed)
            for era in [e for e in self._next_seq if e < era_cutoff]:
                del self._next_seq[era]
            self.pruned += len(doomed)
            metrics.inc("consensus_journal_pruned_total", len(doomed))
        return len(doomed)
