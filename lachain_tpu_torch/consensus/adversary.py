"""Seeded malicious validators: deterministic misbehaviour from the inside.

The port of `lachain_tpu/consensus/adversary.py`. Where a FaultPlan
(network/faults.py) models an unreliable network, this module models
malicious validators: nodes that hold real key shares and use them to
attack the protocol. Every decision is a pure function of (plan.seed,
traitor id, slot identity), so two runs of one plan are bit-identical and
the same misbehaviour plays out on the Python engine and on the native one
(a traitor's coin and HoneyBadger, and so its RootProtocol, run as Python
protocols on the native engine, so that the wrappers see typed payloads;
honest validators stay native).

Strategies:
  equivocate        broadcast the real TPKE decryption share / coin share,
                    then a conflicting well-formed variant for the same slot
                    (coin: a real threshold signature over an altered
                    message; dec: the real U_i times 1337, with the right
                    trailing ids). Every honest router's first-seen latch
                    records an equivocation and drops the second payload.
  withhold          ship coin and decryption shares to f seeded recipients
                    and the traitor itself only: the threshold-boundary
                    starvation attack; tolerated, no evidence.
  relay             replay a seeded ~1 in `RELAY_RATE` of the coin / dec
                    frames the traitor receives, spoofing the original
                    sender, to a seeded subset. Decisions key on (sender,
                    slot), never on the bytes, because TPKE ciphertexts are
                    randomized. Replayed bytes are identical, so the latches
                    pass them and the protocols' dedupe absorbs them.
  spam              flood `SPAM_SLOTS` distinct well-formed coin slots (junk
                    share bytes, valid length and trailing id) once an era:
                    the per-sender first-seen latch budget sheds the excess
                    (`EraRouter.shed["latch_cap"]`, the engine's
                    opq_latch_cap).
  equivocate_votes  AUX / CONF vote equivocation (the vote flipped, sent
                    twice). Python engine only: the native engine types BB
                    messages itself, so they cannot be overridden.

On the port's crypto: the coin variant is signed by the port's
`crypto/threshold_sig.ThresholdSigner` on the traitor's host backend, the
"dec" variant is `crypto/bls12381.g1_mul(ui, 1337)`, and the spam's junk
has the port's `bls.G2_BYTES`. The native injector takes no era: the
port runs one engine a network, and the engine gives an injected message
its sender's era.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

from . import messages as M

STRATEGIES = (
    "equivocate",
    "withhold",
    "relay",
    "spam",
    "equivocate_votes",
)

SPAM_SLOTS = 2600  # distinct flooded latch slots (> the latch cap 2048)
RELAY_FANOUT = 2  # replay targets per captured frame
RELAY_RATE = 4  # replay 1 in N captured frames


@dataclass(frozen=True)
class AdversaryPlan:
    """A deterministic misbehaviour schedule for a set of traitor ids."""

    strategy: str
    traitors: Tuple[int, ...]
    seed: int = 0

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown adversary strategy {self.strategy!r}; "
                f"expected one of {STRATEGIES}"
            )
        object.__setattr__(self, "traitors", tuple(self.traitors))


def _h(seed: int, *parts) -> int:
    """Stateless seeded decision hash: the same on both engines and in
    every run, because it depends only on the seed and the parts."""
    h = hashlib.blake2b(digest_size=8)
    h.update(str(seed).encode())
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"|")
    return int.from_bytes(h.digest(), "big")


def _subset(seed: int, tag, me: int, n: int, size: int) -> Tuple[int, ...]:
    """Seeded choice of `size` validators out of range(n) minus `me`."""
    others = [t for t in range(n) if t != me]
    others.sort(key=lambda t: _h(seed, tag, t))
    return tuple(sorted(others[:size]))


def _payload_bytes(payload) -> bytes:
    if isinstance(payload, M.CoinMessage):
        return payload.share
    if isinstance(payload, M.DecryptedMessage):
        return payload.payload
    raise TypeError(f"unexpected payload {type(payload)}")


def _payload_era(payload) -> int:
    if isinstance(payload, M.CoinMessage):
        return payload.coin.era
    return payload.hb.era


def conflicting_variant(router, payload):
    """A well-formed payload for the same slot that differs from
    `payload`: the equivocation pair, built from the traitor's real key
    material on its host backend."""
    host = getattr(router.backend, "host", router.backend)
    if isinstance(payload, M.CoinMessage):
        from ..crypto import threshold_sig as ts

        signer = ts.ThresholdSigner(
            payload.coin.to_bytes() + b"/equivocate",
            router.private_keys.ts_share,
            router.public_keys.ts_keys,
            host,
            router.rng,
        )
        return M.CoinMessage(coin=payload.coin, share=signer.sign().to_bytes())
    if isinstance(payload, M.DecryptedMessage):
        from ..crypto import bls12381 as bls
        from ..crypto import tpke

        dec = tpke.PartiallyDecryptedShare.from_bytes(payload.payload, host)
        alt = tpke.PartiallyDecryptedShare(
            ui=bls.g1_mul(dec.ui, 1337),
            decryptor_id=dec.decryptor_id,
            share_id=dec.share_id,
        )
        return M.DecryptedMessage(
            hb=payload.hb, share_id=payload.share_id, payload=alt.to_bytes()
        )
    raise TypeError(f"unexpected payload {type(payload)}")


def _flip_vote(payload):
    if isinstance(payload, M.AuxMessage):
        return M.AuxMessage(bb=payload.bb, value=not payload.value)
    return M.ConfMessage(
        bb=payload.bb,
        values=frozenset({True, False}) - payload.values or frozenset({True}),
    )


# -- transport shims ---------------------------------------------------------


def _is_native(net) -> bool:
    return hasattr(net, "_send_opaque")


def _make_injector(net):
    """inject(sender, target, payload): queue a payload as if `sender` sent
    it (spoofing allowed), bypassing the sender's router and its latch.
    target None = every validator, in target order, the same on both
    engines, so that TAKE_FIRST runs stay aligned."""
    if not _is_native(net):
        return net.inject

    from .native_rt import KIND_COIN, KIND_DECRYPTED

    def inject(sender: int, target: Optional[int], payload) -> None:
        if isinstance(payload, M.CoinMessage):
            kind = KIND_COIN
            agreement, epoch = payload.coin.agreement, payload.coin.epoch
        else:
            kind = KIND_DECRYPTED
            agreement, epoch = payload.share_id, 0
        data = _payload_bytes(payload)
        targets = range(net.n) if target is None else (target,)
        for t in targets:
            net._send_opaque(sender, t, kind, agreement, epoch, data)

    return inject


def _force_python_protocols(router) -> None:
    """A traitor on the native engine runs its coin and HoneyBadger (and
    so its RootProtocol) as Python protocols, crossing the engine as opaque
    payloads: the wrappers below need typed payloads, which the
    engine-hosted path never builds. The router gets a factory dict of its
    own, so that a dict shared with the honest routers stays as it was."""
    from .common_coin import CommonCoin
    from .honey_badger import HoneyBadger

    fac = router._extra_factories = dict(router._extra_factories)
    fac.setdefault(
        M.CoinId,
        lambda pid, r: CommonCoin(pid, r, r.private_keys.ts_share, r.public_keys.ts_keys),
    )
    fac.setdefault(
        M.HoneyBadgerId,
        lambda pid, r: HoneyBadger(pid, r, r.public_keys, r.private_keys),
    )


# -- installation ------------------------------------------------------------


def install(plan: AdversaryPlan, net) -> None:
    """Give each traitor's router the plan's misbehaviour, in place. Call
    after the network is built and before its first request: the native
    network syncs each validator's ownership mask from its factories in
    `post_request`, so the overrides added here reach the engine before
    the traitor's first message."""
    native = _is_native(net)
    if plan.strategy == "equivocate_votes" and native:
        raise ValueError(
            "equivocate_votes needs Python BB protocols; the native engine "
            "types BVAL/AUX/CONF messages internally"
        )
    for v in plan.traitors:
        if not 0 <= v < net.n:
            raise ValueError(f"traitor id {v} out of range for n={net.n}")
        _install_traitor(plan, net, v)


def _install_traitor(plan: AdversaryPlan, net, v: int) -> None:
    router = net.routers[v]
    if _is_native(net):
        _force_python_protocols(router)
    inject = _make_injector(net)
    f = router.public_keys.f
    orig_broadcast = router.broadcast
    spammed_eras = set()

    def broadcast(payload) -> None:
        share_like = isinstance(payload, (M.CoinMessage, M.DecryptedMessage))
        if plan.strategy == "withhold" and share_like:
            # f recipients and the traitor itself (so that its own
            # protocols stay live)
            era = _payload_era(payload)
            proto = type(payload).__name__
            for t in _subset(plan.seed, ("withhold", v, era, proto), v, net.n, f):
                inject(v, t, payload)
            inject(v, v, payload)
            return
        orig_broadcast(payload)
        if plan.strategy == "equivocate" and share_like:
            inject(v, None, conflicting_variant(router, payload))
        elif plan.strategy == "equivocate_votes" and isinstance(
            payload, (M.AuxMessage, M.ConfMessage)
        ):
            net.inject(v, None, _flip_vote(payload))
        elif plan.strategy == "spam" and isinstance(payload, M.CoinMessage):
            era = payload.coin.era
            if era not in spammed_eras:
                spammed_eras.add(era)
                _flood(plan, net, v, era, inject)

    router.broadcast = broadcast

    if plan.strategy == "relay":
        orig_dispatch = router.dispatch_external
        replayed: dict = {}  # era -> the frame keys replayed (once each)

        def dispatch_external(sender: int, payload) -> None:
            orig_dispatch(sender, payload)
            if sender == v or not isinstance(
                payload, (M.CoinMessage, M.DecryptedMessage)
            ):
                return
            era = _payload_era(payload)
            seen = replayed.setdefault(era, set())
            for stale in [e for e in replayed if e < era - 1]:
                del replayed[stale]  # bounded memory across eras
            # the key is the slot, never the bytes: TPKE ciphertexts are
            # randomized, so a byte key would break the two-run and the
            # cross-engine identity
            if isinstance(payload, M.CoinMessage):
                slot = ("coin", era, payload.coin.agreement, payload.coin.epoch)
            else:
                slot = ("dec", era, payload.share_id)
            key = _h(plan.seed, "relay", v, sender, slot)
            # each captured frame at most once: replays of replays (our own
            # frames echoed back among them) must not cascade
            if key % RELAY_RATE == 0 and key not in seen:
                seen.add(key)
                for t in _subset(plan.seed, ("rtgt", v, key), sender, net.n,
                                 RELAY_FANOUT):
                    inject(sender, t, payload)

        router.dispatch_external = dispatch_external


def _flood(plan: AdversaryPlan, net, v: int, era: int, inject) -> None:
    """The spam burst: distinct well-formed coin slots that each claim a
    first-seen latch entry. Length and trailing-id checks pass, so the
    only backstop is the per-sender latch budget."""
    from ..crypto import bls12381 as bls

    for k in range(SPAM_SLOTS):
        cid = M.CoinId(era=era, agreement=v, epoch=100_000 + k)
        junk = (
            hashlib.blake2b(b"%d|spam|%d|%d" % (plan.seed, v, k), digest_size=32).digest()
            * ((bls.G2_BYTES + 31) // 32)
        )[: bls.G2_BYTES] + v.to_bytes(4, "big")
        inject(v, None, M.CoinMessage(coin=cid, share=junk))
