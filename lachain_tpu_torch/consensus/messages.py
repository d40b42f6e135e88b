"""Consensus message and protocol-identifier model.

The port's copy of `lachain_tpu/consensus/messages.py`: the protocol ids
keyed by (era, agreement, epoch), the external payloads (the reference's
ConsensusMessage oneof) as frozen dataclasses, and the envelopes a
protocol receives:
  * External : a validator's ConsensusMessage from the network.
  * Request  : a parent protocol asks a child to start.
  * Result   : a child protocol reports its output.
Every message is hashable and comparable, so that the deterministic
simulator can reorder and deduplicate them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, FrozenSet, Optional, Tuple

# ---------------------------------------------------------------------------
# Protocol identifiers
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class RootProtocolId:
    era: int


@dataclass(frozen=True, order=True)
class HoneyBadgerId:
    era: int


@dataclass(frozen=True, order=True)
class CommonSubsetId:
    era: int


@dataclass(frozen=True, order=True)
class ReliableBroadcastId:
    era: int
    sender_id: int  # the validator whose value is being broadcast


@dataclass(frozen=True, order=True)
class BinaryAgreementId:
    era: int
    agreement: int  # which ACS slot


@dataclass(frozen=True, order=True)
class BinaryBroadcastId:
    era: int
    agreement: int
    epoch: int


@dataclass(frozen=True, order=True)
class CoinId:
    era: int
    agreement: int
    epoch: int

    def to_bytes(self) -> bytes:
        from ..utils.serialization import write_i64

        return b"coin" + write_i64(self.era) + write_i64(self.agreement) + write_i64(self.epoch)


ProtocolId = Any  # union of the id dataclasses above


# ---------------------------------------------------------------------------
# External consensus payloads (the ConsensusMessage oneof)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ValMessage:
    """RBC VAL: sender ships shard i + Merkle branch to validator i
    (reference: ReliableBroadcast.ConstructValMessages)."""

    rbc: ReliableBroadcastId
    root: bytes
    branch: Tuple[bytes, ...]
    shard: bytes
    shard_index: int


@dataclass(frozen=True)
class EchoMessage:
    rbc: ReliableBroadcastId
    root: bytes
    branch: Tuple[bytes, ...]
    shard: bytes
    shard_index: int


@dataclass(frozen=True)
class ReadyMessage:
    rbc: ReliableBroadcastId
    root: bytes


@dataclass(frozen=True)
class BValMessage:
    bb: BinaryBroadcastId
    value: bool


@dataclass(frozen=True)
class AuxMessage:
    bb: BinaryBroadcastId
    value: bool


@dataclass(frozen=True)
class ConfMessage:
    bb: BinaryBroadcastId
    values: FrozenSet[bool]


@dataclass(frozen=True)
class CoinMessage:
    """A threshold-signature share of the coin id bytes."""

    coin: CoinId
    share: bytes  # serialized PartialSignature


@dataclass(frozen=True)
class DecryptedMessage:
    """A TPKE partially-decrypted share for one ACS slot
    (reference: HoneyBadger.CreateDecryptedMessage)."""

    hb: HoneyBadgerId
    share_id: int
    payload: bytes  # serialized PartiallyDecryptedShare


@dataclass(frozen=True)
class SignedHeaderMessage:
    root: RootProtocolId
    header_bytes: bytes
    signature: bytes  # ECDSA over header hash


ConsensusPayload = Any  # union of the payload dataclasses above


def payload_protocol_id(payload) -> ProtocolId:
    """Route an external payload to its protocol id
    (role of EraBroadcaster's message->id mapping, EraBroadcaster.cs:135-194)."""
    if isinstance(payload, (ValMessage, EchoMessage, ReadyMessage)):
        return payload.rbc
    if isinstance(payload, (BValMessage, AuxMessage, ConfMessage)):
        return payload.bb
    if isinstance(payload, CoinMessage):
        return payload.coin
    if isinstance(payload, DecryptedMessage):
        return payload.hb
    if isinstance(payload, SignedHeaderMessage):
        return payload.root
    raise TypeError(f"unroutable payload: {type(payload)}")


# ---------------------------------------------------------------------------
# Envelopes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class External:
    """Validator `sender` (index into the era's validator set) sent `payload`."""

    sender: int
    payload: ConsensusPayload


@dataclass(frozen=True)
class Request:
    """Parent protocol `from_id` requests `to_id` to run with `input`."""

    from_id: Optional[ProtocolId]
    to_id: ProtocolId
    input: Any


@dataclass(frozen=True)
class Result:
    """Protocol `from_id` produced `value` (delivered to `to_id` parent)."""

    from_id: ProtocolId
    to_id: Optional[ProtocolId]
    value: Any


Envelope = Any  # External | Request | Result
