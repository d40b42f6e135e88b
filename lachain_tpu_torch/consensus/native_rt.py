"""ctypes binding of the native consensus engine, and the network over it.

The port of `lachain_tpu/consensus/native_rt.py`. `NativeSimulatedNetwork`
takes the place of `simulator.SimulatedNetwork`: the delivery queue and
all seven consensus protocols run inside the C++ engine
(native/consensus_rt.cpp, the port's copy of the JAX package's, built by
`ops/_build.consensus_library()`). The flood protocols (BinaryBroadcast,
BinaryAgreement, ReliableBroadcast, CommonSubset) are hosted whole; of the
crypto-bearing ones (CommonCoin, HoneyBadger, RootProtocol) the engine
owns the MESSAGE state machines and the host shims (native_hosts.py) every
cryptographic operation, reached through BATCHED crossings instead of one
Python round-trip a message. The Python protocols stay the oracle: a
TAKE_FIRST run equals the port's Python engine message for message, and
one seed gives the JAX package's engine's execution in every mode
(tests/test_torch_native_rt.py).

A validator whose `_extra_factories` overrides one of the crypto protocols
(a malicious subclass, or a protocol kept in Python on purpose) keeps that
protocol in Python: its ownership bit stays clear and its messages cross
the engine as opaque payloads through the per-message callbacks. An
override of HoneyBadger or of the coin keeps RootProtocol in Python too.
Native RootProtocol takes its context from `set_root_context`; a
`RootProtocolId` factory keeps it in Python.

Differences, by the port's rules: the network takes the signature of the
port's `SimulatedNetwork` (`device="cuda"`; `backend` None builds a
`GpuBackend` on it, which raises without a card; the TPKE batcher
`TpkeEraBatcher(backend, SeededRng(("rlc", seed)))`, the RBC batcher
`RbcEraBatcher(backend.device)`, each router's `SeededRng(("router", seed,
i))` and one shared `CryptoMemo`). The engine is always the checkout's own
build, with the version-7 RBC host: no prebuilt library, no override, no
version probe. The reference's metrics are minted under its names: every
crossing counts in `consensus_callback_crossings_total{op}`
(`CROSSINGS_METRIC`; the plain dict `crossings`, a count per crossing op,
`XO_NAMES`' names plus the per-message "opaque_message", "acs_result" and
"coin_request", mirrors it for chip_smoke.py), `run` sets the gauges
`consensus_dispatch_queue_depth` and `consensus_native_handled_messages`.
`delivered_count`, `tpke_phase_s`, `rbc_phase_s` and `coin_s` stay plain
attributes that a chip run reads.

The flight recorder is bound as in the reference (native_rt.py:240-252,
:967-1110): the network sizes the engine's ring (`trace_configure`, by
default `tracing.DEFAULT_CAPACITY` records; 0 switches recording and its
clock reads off), aligns its clock with `time.monotonic` once
(`tracing.clock_offset` over `rt_monotonic_ns`) and registers the ring
with the merged tracer; `decode_consensus_trace` turns a drained buffer
into the tracer's events (crossings, posts, stages, era advances, the
dispatch-phase totals and the starved-loop waits), which
`tracing.era_report` reads. Ring overwrites count in
`trace_events_dropped_total{source="consensus"}` (`trace_dropped()`).
`close()` drains the ring and unregisters it; `__del__` only frees the
engine's handle (it takes no lock, the tracer's included).

A `fault_plan` (network/faults.FaultPlan) maps onto the engine's own
knobs as in the reference: duplication raises the repeat probability,
reordering turns TAKE_FIRST into TAKE_RANDOM, a crash that never restarts
mutes its player, and the engine's seed becomes `seed ^ (plan.seed << 1)`;
what the engine cannot express (drop, delay, partitions, a restart, a link
shaper) raises one ValueError that names every such feature. The port's
own rngs (each router's `SeededRng(("router", seed, i))`, the TPKE
batcher's `SeededRng(("rlc", seed))`) keep the caller's `seed`, on the
card and with device="cpu" alike. `_send_opaque` is the adversary's
unicast transport (consensus/adversary.py): any sender, any target.

`journals`, one consensus/journal.ConsensusJournal a validator, makes
every router's sends durable as in EraRouter: the engine's own protocols
(BB, BA, RBC, ACS) send from C++ and are not journaled, but every send of
a host shim (the coin shares, the decryption shares, the signed header)
and of a protocol kept in Python goes through `_native_send`, which
records it before the engine transmits it and hands back the recorded
bytes for a slot sent before (`rearm_sent`, inherited, re-arms a router
from its journal before its first request).

Not in this slice (ROADMAP A): `pipeline_window`, the per-era engines,
`run_front` / `run_tail` and the deferred sign (item 11).
"""
from __future__ import annotations

import ctypes
import struct
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set

from . import messages as M
from .era import EraRouter
from .keys import PrivateConsensusKeys, PublicConsensusKeys
from .native_hosts import (
    RQ_COIN,
    RQ_HB,
    RQ_ROOT,
    XO_COIN_COMBINE,
    XO_COIN_RESULT,
    XO_COIN_SIGN,
    XO_EVIDENCE,
    XO_HB_ACS,
    XO_HB_DONE,
    XO_HB_QUEUE,
    XO_NAMES,
    XO_RBC_ENCODE,
    XO_RBC_NEED,
    XO_ROOT_INPUT,
    XO_ROOT_PRODUCE,
    XO_ROOT_SIGN,
    XO_ROOT_VERIFY,
    CoinHost,
    HoneyBadgerHost,
    RbcHost,
    RootHost,
)
from .simulator import DeliveryMode, SeededRng, flush_rbc, flush_tpke
from ..crypto.provider import CryptoMemo
from ..utils import metrics, tracing

# every crossing into Python, by op: the plain `crossings` dict's twin
CROSSINGS_METRIC = "consensus_callback_crossings_total"

# opaque payload kinds (shared contract with consensus_rt.cpp MT_OPAQUE)
KIND_DECRYPTED = 0
KIND_SIGNED_HEADER = 1
KIND_COIN = 2

# per-validator native-ownership mask (consensus_rt.cpp enum OwnMask)
OWN_HB = 1
OWN_COIN = 2
OWN_ROOT = 4

MAX_N = 512  # rt_new's ceiling: the engine's membership masks are 512-bit

_OPAQUE_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_int32,  # target
    ctypes.c_int32,  # sender
    ctypes.c_int32,  # era
    ctypes.c_int32,  # kind
    ctypes.c_int32,  # agreement
    ctypes.c_int32,  # epoch
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_size_t,
)
_ACS_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_int32,  # target
    ctypes.c_int32,  # era
    ctypes.c_int32,  # nslots
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ctypes.POINTER(ctypes.c_size_t),
)
_COINREQ_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32
)
_CROSS_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_int32,  # target
    ctypes.c_int32,  # era
    ctypes.c_int32,  # op (XO_*)
    ctypes.c_int32,  # a
    ctypes.c_int32,  # b
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_size_t,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SZ = ctypes.c_size_t
_U64 = ctypes.c_uint64
# name -> (restype, argtypes) of every entry the binding calls
_SIGNATURES = {
    "rt_new": (_P, [_I, _I, _I, ctypes.c_uint32, _U64, _I]),
    "rt_free": (None, [_P]),
    "rt_set_callbacks": (None, [_P, _OPAQUE_CB, _ACS_CB, _COINREQ_CB, _CROSS_CB]),
    "rt_set_owned": (None, [_P, _I, _I]),
    "rt_set_coin_need": (None, [_P, _I]),
    "rt_set_rbc_host": (None, [_P, _I]),
    "rt_request": (None, [_P, _I, _I, _I, _I]),
    "rt_post": (None, [_P, _I, _I, _I, _I, ctypes.c_char_p, _SZ]),
    "rt_hb_ready_export": (_SZ, [_P, _I, ctypes.c_char_p, _SZ]),
    "rt_native_handled": (_U64, [_P]),
    "rt_debug_state": (_SZ, [_P, _I, ctypes.c_char_p, _SZ]),
    "rt_mute": (None, [_P, _I]),
    "rt_advance_era": (None, [_P, _I, _I]),
    "rt_post_acs_input": (None, [_P, _I, ctypes.c_char_p, _SZ]),
    "rt_post_coin_result": (None, [_P, _I, _I, _I, _I]),
    "rt_broadcast_opaque": (None, [_P, _I, _I, _I, _I, ctypes.c_char_p, _SZ]),
    "rt_send_opaque": (None, [_P, _I, _I, _I, _I, _I, ctypes.c_char_p, _SZ]),
    "rt_run": (_SZ, [_P, _SZ]),
    "rt_request_stop": (None, [_P]),
    "rt_opaque_pending": (_U64, [_P, _I]),
    "rt_queue_len": (_SZ, [_P]),
    "rt_monotonic_ns": (_U64, []),
    "rt_trace_configure": (None, [_P, _SZ]),
    "rt_trace_dropped": (_U64, [_P]),
    "rt_trace_drain": (_SZ, [_P, ctypes.POINTER(ctypes.c_uint8), _SZ]),
}

_RT: List[Any] = []


def load_rt():
    """The engine library (ops/_build.consensus_library(), built first if
    needed) with every entry of the binding typed."""
    if not _RT:
        from ..ops import _build

        lib = _build.consensus_library()
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _RT.append(lib)
    return _RT[0]


# -- flight recorder ---------------------------------------------------------

# consensus_rt.cpp's trace records: 32 bytes big-endian (u64 ts_ns, u64
# dur_ns, u32 kind, u32 tid, u32 a, u32 b)
_TRACE_RECORD = struct.Struct(">QQIIII")
TK_ERA_ADVANCE, TK_CROSS, TK_POST, TK_STAGE, TK_PHASE, TK_WAIT = 1, 2, 3, 4, 5, 6
# TP_* dispatch-phase buckets -> era-report phase keys (tracing._DISPATCH_PHASE)
TP_NAMES = {1: "rbc", 2: "ba", 3: "coin", 4: "tpke", 5: "commit", 6: "other"}
# WR_* wait resources (TK_WAIT.a) -> era-report wait buckets (tracing.WAIT_RESOURCES)
WR_NAMES = {1: "net", 2: "crypto_flush", 3: "device", 4: "fsync", 5: "sched"}
# the coarse PO_* ops the engine records (per-slot ops are not recorded)
_PO_TRACE_NAMES = {2: "coin_result", 3: "hb_acs_input", 5: "hb_acs_done",
                   12: "root_header"}
_TS_NAMES = {1: "acs_result"}
TRACE_PID_CONSENSUS = 2  # Chrome-export process lane (the Python host is 1)


def decode_consensus_trace(
    raw: bytes, offset: float, source: str = "consensus"
) -> List[dict]:
    """A drained buffer -> the merged tracer's event dicts
    (tracing.register_native_source gives the schema); `offset` is the
    seconds that put the engine's clock on time.monotonic's. A wait record
    also feeds `wait_seconds{resource}`."""
    evs: List[dict] = []
    for i in range(0, len(raw) - (len(raw) % 32), 32):
        ts, dur, kind, tid, a, b = _TRACE_RECORD.unpack_from(raw, i)
        common = dict(
            start=ts / 1e9 + offset,
            end=(ts + dur) / 1e9 + offset,
            pid=TRACE_PID_CONSENSUS,
            pname="native-consensus",
        )
        if kind == TK_CROSS:
            op = XO_NAMES.get(a, str(a))
            evs.append(dict(
                common, name=f"cross:{op}", cat="native.cross", tid=tid,
                tname=f"validator-{tid}", args={"op": op, "era": b, "vid": tid},
            ))
        elif kind == TK_PHASE:
            phase = TP_NAMES.get(a, str(a))
            evs.append(dict(
                common, name=f"dispatch:{phase}", cat="native.phase", tid=0,
                tname="dispatch",
                # cumulative per-(era, phase) totals: the latest wins
                replace_key=(source, b, a),
                args={"phase": phase, "era": b, "dur_ns": dur},
            ))
        elif kind == TK_ERA_ADVANCE:
            evs.append(dict(
                common, name="era_advance", cat="native.consensus", tid=tid,
                tname=f"validator-{tid}",
                args={"vid": tid, "new_era": a, "old_era": b},
            ))
        elif kind == TK_POST:
            op = _PO_TRACE_NAMES.get(a, str(a))
            evs.append(dict(
                common, name=f"post:{op}", cat="native.consensus", tid=tid,
                tname=f"validator-{tid}", args={"op": op, "era": b, "vid": tid},
            ))
        elif kind == TK_STAGE:
            evs.append(dict(
                common, name=f"stage:{_TS_NAMES.get(a, str(a))}",
                cat="native.consensus", tid=tid, tname=f"validator-{tid}",
                args={"stage": a, "era": b, "vid": tid},
            ))
        elif kind == TK_WAIT:
            res = WR_NAMES.get(a, str(a))
            evs.append(dict(
                common, name=f"wait:{res}", cat="native.wait", tid=0,
                tname="dispatch", args={"resource": res, "era": b},
            ))
            metrics.observe_hist(
                "wait_seconds", dur / 1e9, labels={"resource": res}
            )
    return evs


@dataclass(frozen=True)
class NativeCoinParent:
    """Result address of a PYTHON CommonCoin requested by a native
    BinaryAgreement (the coin's ownership bit is clear: an override
    factory): the coin's emit_result routes back into the engine."""

    agreement: int
    epoch: int
    era: int = 0


class _EraHosts:
    """The host shims of one router in one era."""

    __slots__ = ("coins", "hb", "root", "rbc", "py_parents")

    def __init__(self):
        self.coins: Dict[tuple, CoinHost] = {}
        self.hb: Optional[HoneyBadgerHost] = None
        self.root: Optional[RootHost] = None
        self.rbc: Optional[RbcHost] = None
        # parent protocol ids of PYTHON protocols awaiting a native result
        self.py_parents: Dict[Any, Any] = {}


class NativeEraRouter(EraRouter):
    """EraRouter whose protocols live in the native engine.

    Flood protocols are engine-only. Crypto-bearing protocols are
    engine-hosted with the host shims of native_hosts.py unless an
    `_extra_factories` override keeps the Python class: then requests and
    messages route as in EraRouter, crossing the engine as opaque payloads
    through the per-message callbacks.
    """

    def __init__(
        self,
        era: int,
        my_id: int,
        public_keys: PublicConsensusKeys,
        private_keys: PrivateConsensusKeys,
        net: "NativeSimulatedNetwork",
        rng,
        backend,
        extra_factories=None,
        memo: Optional[CryptoMemo] = None,
        journal=None,
    ):
        def _no_send(target, payload):  # pragma: no cover
            raise RuntimeError("a native router transports through the engine")

        super().__init__(
            era,
            my_id,
            public_keys,
            private_keys,
            send=_no_send,
            rng=rng,
            backend=backend,
            extra_factories=extra_factories,
            journal=journal,
            memo=memo,
        )
        self._net = net
        self._acs_parent: Any = None
        self._root_ctx = None  # (producer, ecdsa_priv, ecdsa_pubs)
        self._era_hosts: Dict[int, _EraHosts] = {}
        self._native_results: Dict[Any, Any] = {}

    # -- native ownership ------------------------------------------------------
    def _native_mask(self) -> int:
        """Which crypto protocols THIS validator hosts natively. Computed
        lazily (tests install override factories after construction) and
        synced to the engine before any request enters it."""
        mask = 0
        if M.CoinId not in self._extra_factories:
            mask |= OWN_COIN
        if (
            M.HoneyBadgerId not in self._extra_factories
            and self.crypto_batcher is not None
        ):
            mask |= OWN_HB
        # native Root drives native HB and the native nonce coin; a
        # validator running either of those in Python runs Root in Python
        if (
            self._root_ctx is not None
            and M.RootProtocolId not in self._extra_factories
            and (mask & OWN_HB)
            and (mask & OWN_COIN)
        ):
            mask |= OWN_ROOT
        return mask

    # -- host shims ------------------------------------------------------------
    def _hosts(self, era: int) -> _EraHosts:
        hs = self._era_hosts.get(era)
        if hs is None:
            hs = self._era_hosts[era] = _EraHosts()
        return hs

    def hb_host(self, era: int) -> HoneyBadgerHost:
        hs = self._hosts(era)
        if hs.hb is None:
            hs.hb = HoneyBadgerHost(self, era)
        return hs.hb

    def coin_host(self, era: int, agreement: int, epoch: int) -> CoinHost:
        hs = self._hosts(era)
        key = (agreement, epoch)
        host = hs.coins.get(key)
        if host is None:
            cid = M.CoinId(era=era, agreement=agreement, epoch=epoch)
            host = hs.coins[key] = CoinHost(self, cid)
        return host

    def rbc_host(self, era: int) -> RbcHost:
        hs = self._hosts(era)
        if hs.rbc is None:
            hs.rbc = RbcHost(self, era)
        return hs.rbc

    def root_host(self, era: int) -> RootHost:
        hs = self._hosts(era)
        if hs.root is None:
            producer, priv, pubs = self._root_ctx
            hs.root = RootHost(self, era, producer, priv, pubs)
        return hs.root

    def native_root(self, era: int) -> Optional[RootHost]:
        """The era's native RootHost, None where Root did not run natively."""
        hs = self._era_hosts.get(era)
        return None if hs is None else hs.root

    def _native_send(self, payload):
        """The emission half of broadcast for a payload whose message state
        machine lives in the engine: the durable record (which may hand
        back the recorded bytes of a slot sent before) and the outbox
        record, without the transport; the caller hands the returned
        payload to the engine, which delivers it."""
        payload = self._durable_send(None, payload)
        self._record_outbox(None, payload)
        return payload

    # -- outbound: divert into the engine -------------------------------------
    def internal_request(self, req: M.Request) -> None:
        to = req.to_id
        if isinstance(to, M.CommonSubsetId):
            self._acs_parent = req.from_id
            self._net._post_acs_input(self._my_id, req.input)
            return
        if isinstance(
            to,
            (M.BinaryAgreementId, M.BinaryBroadcastId, M.ReliableBroadcastId),
        ):
            raise RuntimeError(f"natively-owned protocol requested: {to}")
        if getattr(to, "era", None) == self.era:
            mask = self._native_mask()
            if isinstance(to, M.RootProtocolId) and (mask & OWN_ROOT):
                self._net._sync_owner(self._my_id)
                self._net._rt_request(self._my_id, RQ_ROOT, 0, 0)
                return
            if isinstance(to, M.HoneyBadgerId) and (mask & OWN_HB):
                self._net._sync_owner(self._my_id)
                self._hosts(to.era).py_parents["hb"] = req.from_id
                self._net._rt_request(self._my_id, RQ_HB, 0, 0)
                if to in self._native_results:
                    return  # done-replay: the result was routed already
                self.hb_host(to.era).handle_input(req.input)
                return
            if isinstance(to, M.CoinId) and (mask & OWN_COIN):
                self._net._sync_owner(self._my_id)
                self._hosts(to.era).py_parents[
                    ("coin", to.agreement, to.epoch)
                ] = req.from_id
                self._net._rt_request(
                    self._my_id, RQ_COIN, to.agreement, to.epoch
                )
                return
        super().internal_request(req)

    def internal_response(self, res: M.Result) -> None:
        if isinstance(res.to_id, NativeCoinParent):
            self._net._post_coin_result(
                self._my_id, res.to_id.agreement, res.to_id.epoch, res.value
            )
            return
        if res.to_id is None:
            # a top-level protocol completed (Root made its block): break the
            # engine out of its chunk so that run() checks done() at
            # once, as the Python simulator checks it after every message
            self._net._request_stop()
            return
        super().internal_response(res)

    def broadcast(self, payload) -> None:
        # a Python protocol's emission: the outbox record as in
        # EraRouter.broadcast, then the transport through the engine
        payload = self._native_send(payload)
        self._engine_transport(payload)

    def _engine_transport(self, payload) -> None:
        """Hand one payload to the engine for delivery (the transport half
        of broadcast: no outbox record)."""
        if isinstance(payload, M.DecryptedMessage):
            self._net._bcast_opaque(
                self._my_id, KIND_DECRYPTED, payload.share_id, 0,
                payload.payload,
            )
        elif isinstance(payload, M.SignedHeaderMessage):
            data = (
                len(payload.header_bytes).to_bytes(4, "big")
                + payload.header_bytes
                + payload.signature
            )
            self._net._bcast_opaque(self._my_id, KIND_SIGNED_HEADER, 0, 0, data)
        elif isinstance(payload, M.CoinMessage):
            self._net._bcast_opaque(
                self._my_id, KIND_COIN, payload.coin.agreement,
                payload.coin.epoch, payload.share,
            )
        else:
            raise TypeError(f"unexpected python-protocol payload {type(payload)}")

    def replay_outbox(
        self, era: int, requester: int, limit: Optional[int] = None
    ) -> int:
        """Retransmission over the engine transport. The engine only floods
        (its receive paths are idempotent: the per-sender latches drop
        repeated shares), so a replay request is answered with a
        re-broadcast of the recorded payloads of the router's current era;
        `limit` caps the batch, as in EraRouter.replay_outbox."""
        if era != self.era:
            return 0
        payloads = self.outbox_payloads(era, requester)
        if limit is not None:
            payloads = payloads[:limit]
        for payload in payloads:
            self._engine_transport(payload)
        return len(payloads)

    def send_to(self, validator: int, payload) -> None:
        raise TypeError("python-side protocols only broadcast")

    def _create(self, pid):
        if isinstance(
            pid,
            (
                M.BinaryBroadcastId,
                M.BinaryAgreementId,
                M.ReliableBroadcastId,
                M.CommonSubsetId,
            ),
        ):
            raise RuntimeError(f"natively-owned protocol id {pid}")
        if (
            isinstance(pid, M.RootProtocolId)
            and type(pid) not in self._extra_factories
            and self._root_ctx is not None
        ):
            # the Root context was given natively (set_root_context) but this
            # validator cannot own Root (an HB or coin override keeps them in
            # Python): the Python RootProtocol over the same context
            from .root_protocol import RootProtocol

            producer, priv, pubs = self._root_ctx
            return RootProtocol(
                pid, self, producer=producer, ecdsa_priv=priv, ecdsa_pubs=pubs
            )
        return super()._create(pid)

    def result_of(self, pid) -> Any:
        if pid in self._native_results:
            return self._native_results[pid]
        return super().result_of(pid)

    def advance_era(self, new_era: int) -> None:
        if new_era <= self.era:
            return
        # host shims and native results follow the protocols' retention:
        # the last active era stays, older ones go
        cutoff = min(new_era - 1, self.era)
        super().advance_era(new_era)
        for e in [e for e in self._era_hosts if e < cutoff]:
            del self._era_hosts[e]
        for pid in [
            p for p in self._native_results if getattr(p, "era", cutoff) < cutoff
        ]:
            del self._native_results[pid]
        self._net._advance_era(self._my_id, new_era)

    # -- engine callbacks (the per-message path) -------------------------------
    def _on_opaque(
        self, sender: int, era: int, kind: int, agreement: int, epoch: int, data: bytes
    ) -> None:
        if kind == KIND_DECRYPTED:
            payload = M.DecryptedMessage(
                hb=M.HoneyBadgerId(era=era), share_id=agreement, payload=data
            )
        elif kind == KIND_SIGNED_HEADER:
            hlen = int.from_bytes(data[:4], "big")
            payload = M.SignedHeaderMessage(
                root=M.RootProtocolId(era=era),
                header_bytes=data[4 : 4 + hlen],
                signature=data[4 + hlen :],
            )
        elif kind == KIND_COIN:
            payload = M.CoinMessage(
                coin=M.CoinId(era=era, agreement=agreement, epoch=epoch),
                share=data,
            )
        else:  # an unknown kind: dropped (forward compatibility)
            return
        self.dispatch_external(sender, payload)

    def _on_acs_result(self, era: int, result: Dict[int, bytes]) -> None:
        self.internal_response(
            M.Result(
                from_id=M.CommonSubsetId(era=era),
                to_id=self._acs_parent,
                value=result,
            )
        )

    def _on_coin_request(self, era: int, agreement: int, epoch: int) -> None:
        cid = M.CoinId(era=era, agreement=agreement, epoch=epoch)
        super().internal_request(
            M.Request(
                from_id=NativeCoinParent(agreement=agreement, epoch=epoch, era=era),
                to_id=cid,
                input=None,
            )
        )

    # -- engine callbacks (the batched crossings) ------------------------------
    def _on_cross(self, era: int, op: int, a: int, b: int, blob: bytes) -> None:
        if op == XO_COIN_SIGN:
            self.coin_host(era, a, b).sign()
        elif op == XO_COIN_COMBINE:
            self.coin_host(era, a, b).combine(blob)
        elif op == XO_COIN_RESULT:
            # a native coin completed for a PYTHON parent (or a direct request)
            value = bool(blob[0]) if blob else False
            cid = M.CoinId(era=era, agreement=a, epoch=b)
            self._native_results[cid] = value
            parent = self._hosts(era).py_parents.pop(("coin", a, b), None)
            if parent is None:
                self._net._request_stop()
            else:
                super().internal_response(
                    M.Result(from_id=cid, to_id=parent, value=value)
                )
        elif op == XO_HB_ACS:
            self.hb_host(era).on_acs(blob)
        elif op == XO_HB_QUEUE:
            self.hb_host(era).on_queue()
        elif op == XO_HB_DONE:
            result = self.hb_host(era).finish()
            hbid = M.HoneyBadgerId(era=era)
            self._native_results[hbid] = result
            if a:  # the parent is Python-side (or a direct top-level request)
                parent = self._hosts(era).py_parents.pop("hb", None)
                if parent is None:
                    self._net._request_stop()
                else:
                    super().internal_response(
                        M.Result(from_id=hbid, to_id=parent, value=result)
                    )
        elif op == XO_RBC_ENCODE:
            self.rbc_host(era).on_encode(a, blob)
        elif op == XO_RBC_NEED:
            self.rbc_host(era).on_need(a, blob)
        elif op == XO_ROOT_INPUT:
            self.root_host(era).on_input()
        elif op == XO_ROOT_SIGN:
            self.root_host(era).on_sign(a)
        elif op == XO_ROOT_VERIFY:
            self.root_host(era).on_verify(blob)
        elif op == XO_ROOT_PRODUCE:
            self.root_host(era).on_produce()
        elif op == XO_EVIDENCE:
            # the engine's equivocation latch tripped: a = offender, b = the
            # opaque kind, blob = be32(agreement) + be32(epoch); the record
            # era.py::_latch_first_seen would make
            agreement = int.from_bytes(blob[0:4], "big", signed=True)
            epoch = int.from_bytes(blob[4:8], "big", signed=True)
            if b == KIND_DECRYPTED:
                proto, index = "dec", (agreement,)
            elif b == KIND_COIN:
                proto, index = "coin", (agreement, epoch)
            else:
                proto, index = "hdr", ()
            self.evidence.record_equivocation(era, a, proto, index)
        else:  # an unknown op: refused loudly, a silent drop would stall
            raise RuntimeError(f"unknown native crossing op {op}")


class NativeSimulatedNetwork:
    """N validators in the C++ engine: the port's SimulatedNetwork's
    signature and run contract (see the module docstring)."""

    def __init__(
        self,
        public_keys: PublicConsensusKeys,
        private_keys: List[PrivateConsensusKeys],
        era: int = 0,
        seed: int = 0,
        mode: DeliveryMode = DeliveryMode.TAKE_FIRST,
        repeat_probability: float = 0.0,
        muted: Optional[Set[int]] = None,
        extra_factories=None,
        use_crypto_batcher: bool = True,
        use_rbc_batcher: bool = False,
        device="cuda",
        backend=None,
        fault_plan=None,
        journals: Optional[List] = None,
    ):
        self._h = None
        self.n = public_keys.n
        self.seed = seed
        self.muted = set(muted or ())
        self.fault_plan = fault_plan
        engine_seed = seed
        if fault_plan is not None:
            # a chaos run that looks as if it injected loss but did not
            # would certify a recovery path never exercised: refused
            unsupported = [
                name for name, on in (
                    ("drop", fault_plan.drop > 0),
                    ("delay", fault_plan.delay > 0),
                    ("partitions", bool(fault_plan.partitions)),
                    ("crash restart",
                     any(c.restart is not None for c in fault_plan.crashes)),
                    ("link shaper", fault_plan.shaper is not None),
                ) if on
            ]
            if unsupported:
                raise ValueError(
                    "native engine cannot express FaultPlan feature(s): "
                    + ", ".join(unsupported)
                    + " — use the Python simulator for full fault injection"
                )
            if fault_plan.reorder > 0 and mode is DeliveryMode.TAKE_FIRST:
                mode = DeliveryMode.TAKE_RANDOM
            repeat_probability = max(repeat_probability, fault_plan.duplicate)
            engine_seed = seed ^ (fault_plan.seed << 1)
            self.muted |= {c.node for c in fault_plan.crashes}
        self.mode = mode
        if backend is None:
            from ..crypto.gpu_backend import GpuBackend

            backend = GpuBackend(device)
        self.backend = backend
        self._lib = load_rt()
        mode_i = {
            DeliveryMode.TAKE_FIRST: 0,
            DeliveryMode.TAKE_LAST: 1,
            DeliveryMode.TAKE_RANDOM: 2,
        }[mode]
        self._h = self._lib.rt_new(
            self.n,
            public_keys.f,
            mode_i,
            int(repeat_probability * 1_000_000),
            engine_seed & ((1 << 64) - 1),
            era,
        )
        if not self._h:
            raise ValueError(
                f"native engine rejected N={self.n}: rt_new supports "
                f"1 <= N <= {MAX_N} ({MAX_N}-bit membership masks)"
            )
        for v in self.muted:
            self._lib.rt_mute(self._h, v)
        # the native coin's combine trigger: CommonCoin needs t+1 shares
        # before a combine can succeed
        self._lib.rt_set_coin_need(self._h, public_keys.ts_keys.t + 1)
        self.memo = CryptoMemo()
        self.delivered_count = 0
        self.crossings: Dict[str, int] = dict.fromkeys(
            [*XO_NAMES.values(), "opaque_message", "acs_result", "coin_request"], 0
        )
        self.tpke_phase_s: Dict[str, float] = {}
        self.rbc_phase_s: Dict[str, float] = {}
        # the TPKE flush batcher: run() flushes it once every queued
        # decryption share has been delivered, where the cross-validator
        # batch is largest; the RBC batcher at quiescence, first
        self.crypto_batcher = None
        if use_crypto_batcher:
            from .crypto_batcher import TpkeEraBatcher

            self.crypto_batcher = TpkeEraBatcher(backend, SeededRng(("rlc", seed)))
        self.rbc_batcher = None
        if use_rbc_batcher:
            from .rbc_batcher import RbcEraBatcher

            self.rbc_batcher = RbcEraBatcher(backend.device)
            self._lib.rt_set_rbc_host(self._h, 1)
        self.routers: List[NativeEraRouter] = []
        for i in range(self.n):
            router = NativeEraRouter(
                era=era,
                my_id=i,
                public_keys=public_keys,
                private_keys=private_keys[i],
                net=self,
                rng=SeededRng(("router", seed, i)),
                backend=backend,
                extra_factories=extra_factories,
                memo=self.memo,
                journal=journals[i] if journals is not None else None,
            )
            router.crypto_batcher = self.crypto_batcher
            router.rbc_batcher = self.rbc_batcher
            self.routers.append(router)
        # callback exceptions cannot unwind through the engine's frames: they
        # are stashed and re-raised from run() (or the call that posted)
        self._cb_errors: List[BaseException] = []
        # the CFUNCTYPE objects live as long as the engine
        self._cbs = (
            _OPAQUE_CB(self._cb_opaque),
            _ACS_CB(self._cb_acs),
            _COINREQ_CB(self._cb_coinreq),
            _CROSS_CB(self._cb_cross),
        )
        self._lib.rt_set_callbacks(self._h, *self._cbs)
        self._own_masks = [-1] * self.n  # the engine's masks (-1: unset)
        self._sync_ownership()
        # the flight recorder: size the ring, put its clock on
        # time.monotonic's, register it with the merged tracer (through a
        # weak reference: the registry must not keep a dropped network)
        self._trace_offset = tracing.clock_offset(self._lib.rt_monotonic_ns)
        self._trace_dropped_seen = 0
        self._trace_source = f"consensus-{id(self):x}"
        self.trace_configure(tracing.DEFAULT_CAPACITY)
        ref = weakref.ref(self)
        source = self._trace_source

        def drain() -> List[dict]:
            net = ref()
            if net is None:
                tracing.unregister_native_source(source)
                return []
            return net._drain_trace()

        tracing.register_native_source(source, drain)

    # -- flight recorder -------------------------------------------------------
    def trace_configure(self, capacity: int) -> None:
        """Resize the engine's trace ring (records); 0 switches recording,
        and its clock reads on the hot path, off. Buffered records go."""
        self._lib.rt_trace_configure(self._h, max(int(capacity), 0))

    def trace_dropped(self) -> int:
        """Records the ring overwrote before they were drained."""
        return int(self._lib.rt_trace_dropped(self._h)) if self._h is not None else 0

    def _drain_trace(self) -> List[dict]:
        """Consume the engine's ring -> the merged tracer's events, and
        publish the growth of its drop count in
        trace_events_dropped_total{source="consensus"}."""
        if self._h is None:
            return []
        evs: List[dict] = []
        # a size query, then the copying call, which consumes the ring; the
        # slack covers records appended in between, and a ring that still
        # outgrew the buffer (got > len: nothing copied) is asked again
        for _ in range(4):
            need = self._lib.rt_trace_drain(self._h, None, 0)
            if need == 0:
                break
            buf = (ctypes.c_uint8 * (need + 4096))()
            got = self._lib.rt_trace_drain(self._h, buf, len(buf))
            if got <= len(buf):
                evs = decode_consensus_trace(
                    bytes(buf[:got]), self._trace_offset, self._trace_source)
                break
        dropped = self.trace_dropped()
        if dropped > self._trace_dropped_seen:
            metrics.inc(
                "trace_events_dropped_total",
                dropped - self._trace_dropped_seen,
                labels={"source": "consensus"},
            )
            self._trace_dropped_seen = dropped
        return evs

    @property
    def coin_s(self) -> float:
        """Seconds every router spent combining coins."""
        return sum(r.coin_s for r in self.routers)

    def close(self) -> None:
        """Drain the engine's ring into the merged tracer, unregister it
        and free the engine (idempotent)."""
        if self._h is not None:
            tracing.drain_native()
            tracing.unregister_native_source(self._trace_source)
            self._lib.rt_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        # no lock here (a collection can run inside the tracer's): the
        # weakly held drain unregisters itself once this object is gone
        if self._h is not None:
            self._lib.rt_free(self._h)
            self._h = None

    # -- native ownership ------------------------------------------------------
    def _sync_owner(self, vid: int) -> None:
        mask = self.routers[vid]._native_mask()
        if mask != self._own_masks[vid]:
            self._own_masks[vid] = mask
            self._lib.rt_set_owned(self._h, vid, mask)

    def _sync_ownership(self) -> None:
        for vid in range(self.n):
            self._sync_owner(vid)

    def set_root_context(self, vid: int, producer, ecdsa_priv, ecdsa_pubs) -> None:
        """Give validator `vid` its block-production context, so that its
        RootProtocol can run natively (the Python fallback takes the same
        context)."""
        self.routers[vid]._root_ctx = (producer, ecdsa_priv, ecdsa_pubs)
        self._sync_owner(vid)

    # -- engine entry points ---------------------------------------------------
    def _post_acs_input(self, vid: int, data: bytes) -> None:
        self._lib.rt_post_acs_input(self._h, vid, data, len(data))

    def _post_coin_result(self, vid: int, agreement: int, epoch: int, value) -> None:
        self._lib.rt_post_coin_result(self._h, vid, agreement, epoch, 1 if value else 0)

    def _bcast_opaque(
        self, vid: int, kind: int, agreement: int, epoch: int, data: bytes
    ) -> None:
        self._lib.rt_broadcast_opaque(
            self._h, vid, kind, agreement, epoch, data, len(data)
        )

    def _send_opaque(
        self, vid: int, target: int, kind: int, agreement: int, epoch: int, data: bytes
    ) -> None:
        """Unicast opaque injection, the adversary's transport: the caller
        chooses `vid`, so a spoofed sender or a replay is expressible; the
        message takes the sender's era in the engine."""
        self._lib.rt_send_opaque(
            self._h, vid, target, kind, agreement, epoch, data, len(data)
        )

    def _rt_request(self, vid: int, kind: int, a: int, b: int) -> None:
        self._lib.rt_request(self._h, vid, kind, a, b)
        # a request posted outside run() (post_request) can recurse through
        # the engine into host code: its failure surfaces here
        self._raise_cb_error()

    def _rt_post(self, vid: int, op: int, a: int, b: int, data: bytes = b"") -> None:
        self._lib.rt_post(self._h, vid, op, a, b, data, len(data))

    def _rt_hb_export(self, vid: int) -> bytes:
        size = self._lib.rt_hb_ready_export(self._h, vid, None, 0)
        if not size:
            return b""
        buf = ctypes.create_string_buffer(size)
        self._lib.rt_hb_ready_export(self._h, vid, buf, size)
        return buf.raw[:size]

    def native_state_of(self, vid: int) -> str:
        """The engine's state of validator `vid`'s native protocols."""
        size = self._lib.rt_debug_state(self._h, vid, None, 0)
        if not size:
            return ""
        buf = ctypes.create_string_buffer(size)
        self._lib.rt_debug_state(self._h, vid, buf, size)
        return buf.raw[:size].decode("utf-8", "replace")

    def native_handled(self) -> int:
        """Messages the engine consumed natively, each of which would have
        been a per-message Python callback: the crossings removed."""
        return int(self._lib.rt_native_handled(self._h))

    def _advance_era(self, vid: int, era: int) -> None:
        self._lib.rt_advance_era(self._h, vid, era)

    def _request_stop(self) -> None:
        self._lib.rt_request_stop(self._h)

    def mute(self, vid: int) -> None:
        self.muted.add(vid)
        self._lib.rt_mute(self._h, vid)

    # -- callbacks (engine -> Python) ------------------------------------------
    def _raise_cb_error(self) -> None:
        if self._cb_errors:
            raise self._cb_errors.pop(0)

    def _cb_opaque(self, target, sender, era, kind, agreement, epoch, data, length):
        if self._cb_errors:
            return
        try:
            self.crossings["opaque_message"] += 1
            metrics.inc(CROSSINGS_METRIC, labels={"op": "opaque_message"})
            blob = ctypes.string_at(data, length) if length else b""
            self.routers[target]._on_opaque(sender, era, kind, agreement, epoch, blob)
            if (
                kind == KIND_DECRYPTED
                and self.crypto_batcher is not None
                and self.crypto_batcher.pending
                and self._lib.rt_opaque_pending(self._h, KIND_DECRYPTED) == 0
            ):
                # every decryption share delivered: break out so that run()
                # flushes the cross-validator batch before lag-round traffic
                self._lib.rt_request_stop(self._h)
        except BaseException as exc:  # noqa: BLE001 - re-raised from run()
            self._cb_errors.append(exc)

    def _cb_acs(self, target, era, nslots, slots, datas, lens):
        if self._cb_errors:
            return
        try:
            self.crossings["acs_result"] += 1
            metrics.inc(CROSSINGS_METRIC, labels={"op": "acs_result"})
            result = {
                int(slots[i]): (
                    ctypes.string_at(datas[i], lens[i]) if lens[i] else b""
                )
                for i in range(nslots)
            }
            self.routers[target]._on_acs_result(era, result)
        except BaseException as exc:  # noqa: BLE001 - re-raised from run()
            self._cb_errors.append(exc)

    def _cb_coinreq(self, target, era, agreement, epoch):
        if self._cb_errors:
            return
        try:
            self.crossings["coin_request"] += 1
            metrics.inc(CROSSINGS_METRIC, labels={"op": "coin_request"})
            self.routers[target]._on_coin_request(era, agreement, epoch)
        except BaseException as exc:  # noqa: BLE001 - re-raised from run()
            self._cb_errors.append(exc)

    def _cb_cross(self, target, era, op, a, b, data, length):
        if self._cb_errors:
            return
        try:
            name = XO_NAMES.get(op, f"op{op}")
            self.crossings[name] = self.crossings.get(name, 0) + 1
            metrics.inc(CROSSINGS_METRIC, labels={"op": name})
            blob = ctypes.string_at(data, length) if length else b""
            self.routers[target]._on_cross(era, op, a, b, blob)
        except BaseException as exc:  # noqa: BLE001 - re-raised from run()
            self._cb_errors.append(exc)

    # -- execution (SimulatedNetwork.run's contract) ---------------------------
    def post_request(self, validator: int, pid, value) -> None:
        """Inject a top-level request into one validator. The injection
        runs the proposal's encryption and RS encode before the first
        dispatch chunk, outside the engine's phase accumulators: it is the
        era report's `propose` phase (a `consensus.propose` span)."""
        self._sync_ownership()
        with tracing.span("consensus.propose", era=getattr(pid, "era", None)):
            self.routers[validator].internal_request(
                M.Request(from_id=None, to_id=pid, input=value)
            )

    def run(
        self,
        done: Callable[[], bool],
        max_messages: int = 1_000_000,
        chunk: int = 16384,
    ) -> bool:
        """Deliver in chunks of `chunk` messages until `done()` or
        quiescence; True iff done() held. A callback's failure, and a failed
        flush, raise; more than `max_messages` deliveries with traffic left
        raise (a livelock)."""
        try:
            return self._run(done, max_messages, chunk)
        finally:
            if self._h is not None:
                metrics.set_gauge(
                    "consensus_native_handled_messages", self.native_handled()
                )

    def _run(self, done, max_messages: int, chunk: int) -> bool:
        lib, h = self._lib, self._h
        while not done():
            processed = lib.rt_run(h, chunk)
            self.delivered_count += processed
            self._raise_cb_error()
            metrics.set_gauge("consensus_dispatch_queue_depth", lib.rt_queue_len(h))
            # RBC first: interpolations unblock READY / delivery and so the
            # ACS, and draining them before the TPKE flush keeps its batch as
            # large as it can get
            if (
                self.rbc_batcher is not None
                and self.rbc_batcher.pending
                and lib.rt_queue_len(h) == 0
            ):
                flush_rbc(self.rbc_batcher, self.rbc_phase_s)
                self._raise_cb_error()
                continue
            if (
                self.crypto_batcher is not None
                and self.crypto_batcher.pending
                and (
                    lib.rt_queue_len(h) == 0
                    or lib.rt_opaque_pending(h, KIND_DECRYPTED) == 0
                )
            ):
                flush_tpke(self.crypto_batcher, self.tpke_phase_s)
                self._raise_cb_error()
                continue
            if processed == 0:
                return done()
            if (
                self.delivered_count >= max_messages
                and lib.rt_queue_len(h) > 0
                and not done()
            ):
                raise RuntimeError(
                    f"message cap {max_messages} exceeded — livelock?"
                )
        return True

    def results(self, pid) -> List[Any]:
        return [r.result_of(pid) for r in self.routers]
