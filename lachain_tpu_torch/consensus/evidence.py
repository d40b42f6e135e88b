"""Byzantine evidence: records of detected misbehavior.

The port of `lachain_tpu/consensus/evidence.py` (:143-257), in memory. Two
detection families feed it:
  * equivocation: one validator sent two different payloads for the same
    per-era decision slot (journal.send_slot is the slot key), caught by
    the router's first-seen latch (era.py);
  * invalid_share: a share that fails its parse or its cryptographic check
    at a combine: TPKE decryption shares (honey_badger.py) and coin
    signature shares (common_coin.py, ThresholdSigner.pruned).
Records are deduplicated, so re-detection cannot grow the store, which is
bounded by `cap` (a record past it is dropped and counted in `dropped`,
the reference's `consensus_evidence_dropped_total`). Given a KV store
(storage/kv.py), a record is persisted under `EntryPrefix.EVIDENCE`
through the KV's fsynced `write_batch` before it is counted, and a store
over the same KV reloads it after a restart: an accusation survives a
crash. `EvidenceRecord.encode` gives the JAX package's bytes. The
reference's metrics and the module-level per-era counters (`era_counts`)
wait for the node's metrics (ROADMAP A item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..storage.kv import EntryPrefix, prefixed
from ..utils.serialization import Reader, write_bytes, write_u64

EQUIVOCATION = "equivocation"
INVALID_SHARE = "invalid_share"

_KIND_CODES = {EQUIVOCATION: 1, INVALID_SHARE: 2}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}
_PREFIX = prefixed(EntryPrefix.EVIDENCE)


@dataclass(frozen=True, order=True)
class EvidenceRecord:
    """One detected offense, normalized to plain ints and strings so that
    records compare across runs and across packages."""

    era: int
    kind: str  # EQUIVOCATION | INVALID_SHARE
    offender: int
    proto: str  # "dec" | "coin" | "hdr" | "aux" | "conf" | "bval" | ...
    index: Tuple[int, ...]  # proto-specific slot coordinates

    def to_dict(self) -> dict:
        return {
            "era": self.era,
            "kind": self.kind,
            "offender": self.offender,
            "proto": self.proto,
            "index": list(self.index),
        }

    def encode(self) -> bytes:
        out = write_u64(self.era)
        out += bytes([_KIND_CODES[self.kind]])
        out += write_u64(self.offender)
        out += write_bytes(self.proto.encode("ascii"))
        out += write_u64(len(self.index))
        for i in self.index:
            # index coordinates are small non-negatives; biased by 1 so that
            # agreement -1 (the nonce coin) round-trips
            out += write_u64(i + 1)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "EvidenceRecord":
        r = Reader(data)
        era = r.u64()
        kind = _KIND_NAMES[r.raw(1)[0]]
        offender = r.u64()
        proto = r.bytes_().decode("ascii")
        count = r.u64()
        index = tuple(r.u64() - 1 for _ in range(count))
        return cls(
            era=era, kind=kind, offender=offender, proto=proto, index=index
        )


def describe_slot(slot: tuple) -> Tuple[str, Tuple[int, ...]]:
    """Normalize a journal.send_slot key, (tag, protocol id, extras...),
    into the flat (proto, index) coordinates an EvidenceRecord carries."""
    tag = slot[0]
    pid = slot[1]
    if tag == "dec":
        return "dec", (int(slot[2]),)
    if tag == "coin":
        return "coin", (int(pid.agreement), int(pid.epoch))
    if tag == "hdr":
        return "hdr", ()
    if tag == "val":
        return "val", (int(pid.sender_id), int(slot[2]))
    if tag in ("echo", "ready"):
        return tag, (int(pid.sender_id),)
    if tag in ("aux", "conf"):
        return tag, (int(pid.agreement), int(pid.epoch))
    if tag == "bval":
        return "bval", (int(pid.agreement), int(pid.epoch), int(slot[2]))
    return tag, ()


class EvidenceStore:
    """Deduplicated store of EvidenceRecords, one per validator (owned by
    its EraRouter), persisted on `kv` when one is given. A record past
    `cap` is dropped and counted in `dropped`."""

    def __init__(self, kv=None, cap: int = 4096):
        self._kv = kv
        self.cap = cap
        self.dropped = 0
        self._records: set = set()
        self._ordered: List[EvidenceRecord] = []
        self._next_seq = 0
        if kv is not None:
            self._load()

    # -- persistence ----------------------------------------------------------
    def _load(self) -> None:
        for key, value in self._kv.scan_prefix(_PREFIX):
            tail = key[len(_PREFIX):]
            if len(tail) != 8:
                continue
            try:
                rec = EvidenceRecord.decode(value)
            except (ValueError, KeyError):
                continue  # an undecodable record is skipped
            self._next_seq = max(self._next_seq, int.from_bytes(tail, "big") + 1)
            if rec not in self._records:
                self._records.add(rec)
                self._ordered.append(rec)

    def _persist(self, rec: EvidenceRecord) -> None:
        if self._kv is None:
            return
        key = _PREFIX + write_u64(self._next_seq)
        self._next_seq += 1
        self._kv.write_batch([(key, rec.encode())])

    # -- recording ------------------------------------------------------------
    def _record(self, rec: EvidenceRecord) -> bool:
        if rec in self._records:
            return False
        if len(self._ordered) >= self.cap:
            self.dropped += 1
            return False
        # durable before it is observable
        self._persist(rec)
        self._records.add(rec)
        self._ordered.append(rec)
        return True

    def record_equivocation(
        self, era: int, offender: int, proto: str, index: Tuple[int, ...]
    ) -> bool:
        return self._record(
            EvidenceRecord(
                era=int(era),
                kind=EQUIVOCATION,
                offender=int(offender),
                proto=proto,
                index=tuple(int(i) for i in index),
            )
        )

    def record_invalid_share(
        self, era: int, offender: int, proto: str, index: Tuple[int, ...]
    ) -> bool:
        return self._record(
            EvidenceRecord(
                era=int(era),
                kind=INVALID_SHARE,
                offender=int(offender),
                proto=proto,
                index=tuple(int(i) for i in index),
            )
        )

    # -- queries --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ordered)

    def records(self, era: Optional[int] = None) -> List[EvidenceRecord]:
        if era is None:
            return list(self._ordered)
        return [r for r in self._ordered if r.era == era]

    def record_set(self, era: Optional[int] = None) -> frozenset:
        """The records as a set: what the engines' verdicts are compared by."""
        return frozenset(self.records(era))

    def snapshot(self, era: Optional[int] = None) -> List[dict]:
        """The records as plain dicts, sorted: what the packages compare."""
        return [r.to_dict() for r in sorted(self.records(era))]

    def counts(self, era: Optional[int] = None) -> Dict[str, int]:
        """Records by kind."""
        out = {EQUIVOCATION: 0, INVALID_SHARE: 0}
        for r in self.records(era):
            out[r.kind] += 1
        return out
