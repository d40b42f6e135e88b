"""Network wire format: the consensus payload codec.

The port of the payload codec of `lachain_tpu/network/wire.py` (:26-215):
the tag bytes of the reference's ConsensusMessage oneof and the
fixed-width encoding of its nine payloads (VAL, ECHO, READY, BVAL, AUX,
CONF, COIN, DEC, HDR). Every payload of `consensus/messages.py` encodes to
the JAX package's bytes, byte for byte, so that a send journal written by
either package reads back in the other. The consensus send journal
(consensus/journal.py) records these bytes.

Not in this slice: `NetworkMessage`, `MessageBatch`, the handshake and the
sync messages (reference :216 onward) wait for the node's transport
(ROADMAP A item 13.5).
"""
from __future__ import annotations

from ..consensus import messages as M
from ..utils.serialization import (
    Reader,
    write_bytes,
    write_bytes_list,
    write_i64,
    write_u32,
)

_VAL, _ECHO, _READY, _BVAL, _AUX, _CONF, _COIN, _DEC, _HDR = range(1, 10)


def _enc_rbc(rbc: M.ReliableBroadcastId) -> bytes:
    return write_i64(rbc.era) + write_u32(rbc.sender_id)


def _dec_rbc(r: Reader) -> M.ReliableBroadcastId:
    return M.ReliableBroadcastId(era=r.i64(), sender_id=r.u32())


def _enc_bb(bb: M.BinaryBroadcastId) -> bytes:
    return write_i64(bb.era) + write_i64(bb.agreement) + write_i64(bb.epoch)


def _dec_bb(r: Reader) -> M.BinaryBroadcastId:
    return M.BinaryBroadcastId(era=r.i64(), agreement=r.i64(), epoch=r.i64())


def encode_payload(p) -> bytes:
    if isinstance(p, (M.ValMessage, M.EchoMessage)):
        return (
            bytes([_VAL if isinstance(p, M.ValMessage) else _ECHO])
            + _enc_rbc(p.rbc)
            + write_bytes(p.root)
            + write_bytes_list(list(p.branch))
            + write_bytes(p.shard)
            + write_u32(p.shard_index)
        )
    if isinstance(p, M.ReadyMessage):
        return bytes([_READY]) + _enc_rbc(p.rbc) + write_bytes(p.root)
    if isinstance(p, M.BValMessage):
        return bytes([_BVAL]) + _enc_bb(p.bb) + bytes([1 if p.value else 0])
    if isinstance(p, M.AuxMessage):
        return bytes([_AUX]) + _enc_bb(p.bb) + bytes([1 if p.value else 0])
    if isinstance(p, M.ConfMessage):
        mask = (1 if False in p.values else 0) | (2 if True in p.values else 0)
        return bytes([_CONF]) + _enc_bb(p.bb) + bytes([mask])
    if isinstance(p, M.CoinMessage):
        c = p.coin
        return (
            bytes([_COIN])
            + write_i64(c.era)
            + write_i64(c.agreement)
            + write_i64(c.epoch)
            + write_bytes(p.share)
        )
    if isinstance(p, M.DecryptedMessage):
        return (
            bytes([_DEC])
            + write_i64(p.hb.era)
            + write_u32(p.share_id)
            + write_bytes(p.payload)
        )
    if isinstance(p, M.SignedHeaderMessage):
        return (
            bytes([_HDR])
            + write_i64(p.root.era)
            + write_bytes(p.header_bytes)
            + write_bytes(p.signature)
        )
    raise TypeError(f"unencodable payload {type(p)}")


def decode_payload(data: bytes):
    r = Reader(data)
    tag = r.raw(1)[0]
    if tag in (_VAL, _ECHO):
        rbc = _dec_rbc(r)
        root = r.bytes_()
        branch = tuple(r.bytes_list())
        shard = r.bytes_()
        idx = r.u32()
        cls = M.ValMessage if tag == _VAL else M.EchoMessage
        return cls(rbc=rbc, root=root, branch=branch, shard=shard, shard_index=idx)
    if tag == _READY:
        return M.ReadyMessage(rbc=_dec_rbc(r), root=r.bytes_())
    if tag == _BVAL:
        return M.BValMessage(bb=_dec_bb(r), value=r.raw(1)[0] != 0)
    if tag == _AUX:
        return M.AuxMessage(bb=_dec_bb(r), value=r.raw(1)[0] != 0)
    if tag == _CONF:
        bb = _dec_bb(r)
        mask = r.raw(1)[0]
        vals = frozenset(
            v for v, bit in ((False, 1), (True, 2)) if mask & bit
        )
        return M.ConfMessage(bb=bb, values=vals)
    if tag == _COIN:
        coin = M.CoinId(era=r.i64(), agreement=r.i64(), epoch=r.i64())
        return M.CoinMessage(coin=coin, share=r.bytes_())
    if tag == _DEC:
        hb = M.HoneyBadgerId(era=r.i64())
        return M.DecryptedMessage(hb=hb, share_id=r.u32(), payload=r.bytes_())
    if tag == _HDR:
        root = M.RootProtocolId(era=r.i64())
        return M.SignedHeaderMessage(
            root=root, header_bytes=r.bytes_(), signature=r.bytes_()
        )
    raise ValueError(f"unknown payload tag {tag}")
