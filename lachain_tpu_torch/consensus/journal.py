"""The per-era decision slot of a consensus payload.

`send_slot`, copied alone from `lachain_tpu/consensus/journal.py:46`: the
key the router's first-seen latch pins a sender's payload to. The durable
send journal around it (persist-before-transmit, crash recovery) is not
ported.
"""
from __future__ import annotations

from typing import Optional

from . import messages as M


def send_slot(payload) -> Optional[tuple]:
    """The per-era decision slot a payload occupies: one value per sender
    and slot. The slot key identifies the decision point, not the value,
    except where the protocol legitimately sends both values (BVAL: a node
    may broadcast BVAL(0) and BVAL(1) in one epoch after seeing f+1 of the
    other; that is not equivocation, so the value is part of the slot).
    None for payloads that occupy no slot."""
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
