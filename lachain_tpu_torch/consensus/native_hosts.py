"""Host shims for the natively hosted crypto protocols.

The port of `lachain_tpu/consensus/native_hosts.py`. The C++ engine
(native/consensus_rt.cpp) owns the MESSAGE state machines of CommonCoin,
HoneyBadger and RootProtocol (dedupe, thresholds, stashes, result
routing); these shims own every cryptographic operation: BLS threshold
signing and combining, TPKE encrypt / decrypt-share / verify / combine,
the RBC codec, and the header's ECDSA signatures. The two halves talk
through BATCHED crossings (one callback op covers many messages: every
pending coin share, every ready decryption-share slot, every unverified
header signature), which removes the per-message Python callback from the
era's hot path.

Each shim mirrors its oracle in the port (common_coin.py, honey_badger.py,
root_protocol.py, reliable_broadcast.py) statement for statement on the
crypto side and calls the same primitives, so that a TAKE_FIRST native run
equals the port's Python engine (tests/test_torch_native_rt.py).

Differences, by the port's rules: the crypto runs on the router's explicit
backend (its `host` for the host ops, parsing through the router's
`memo`) and draws from the router's `rng`; a HoneyBadger's slots go to the
network's `TpkeEraBatcher` (the era's kernels on the card) and the RBC
codec to its `RbcEraBatcher` (`rs_matmul` on the card); a node's
decryption shares U^{x_i} are one `g1_mul_batch` of the host backend. The
seconds a coin spends combining add up in the router's `coin_s`, and a
RootHost keeps `sign_s` / `verify_s` as RootProtocol does. Not ported: the
reference's tracing spans and instants and its txtrace stamps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..crypto import bls12381 as bls
from ..crypto import ecdsa, hashes, tpke
from ..crypto import threshold_sig as ts
from ..crypto.provider import deserialize_batch_g1, deserialize_batch_g2
from . import messages as M

# --- shared contract with consensus_rt.cpp (enums CrossOp/PostOp/ReqKind) ---

# engine -> Python crossing ops
XO_COIN_SIGN = 1
XO_COIN_COMBINE = 2
XO_COIN_RESULT = 3
XO_HB_ACS = 4
XO_HB_QUEUE = 5
XO_HB_DONE = 6
XO_ROOT_INPUT = 7
XO_ROOT_SIGN = 8
XO_ROOT_VERIFY = 9
XO_ROOT_PRODUCE = 10
XO_EVIDENCE = 11
XO_RBC_ENCODE = 12
XO_RBC_NEED = 13

XO_NAMES = {
    XO_COIN_SIGN: "coin_sign",
    XO_COIN_COMBINE: "coin_combine",
    XO_COIN_RESULT: "coin_result",
    XO_HB_ACS: "hb_acs",
    XO_HB_QUEUE: "hb_queue",
    XO_HB_DONE: "hb_done",
    XO_ROOT_INPUT: "root_input",
    XO_ROOT_SIGN: "root_sign",
    XO_ROOT_VERIFY: "root_verify",
    XO_ROOT_PRODUCE: "root_produce",
    XO_EVIDENCE: "evidence",
    XO_RBC_ENCODE: "rbc_encode",
    XO_RBC_NEED: "rbc_need",
}

# Python -> engine post ops
PO_COIN_SHARE = 1
PO_COIN_RESULT = 2
PO_HB_ACS_INPUT = 3
PO_HB_DECRYPTED = 4
PO_HB_ACS_DONE = 5
PO_HB_RESOLVED = 6
PO_HB_REJECT = 7
PO_HB_SET_INFLIGHT = 8
PO_HB_CLEAR_INFLIGHT = 9
PO_HB_CLEAR_QUEUED = 10
PO_HB_REQUEUE_CHECK = 11
PO_ROOT_HEADER = 12
PO_ROOT_ACCEPT = 13
PO_ROOT_REJECT = 14
PO_RBC_VALS = 15
PO_RBC_RESULT = 16

# rt_request kinds
RQ_HB = 1
RQ_COIN = 2
RQ_ROOT = 3


def iter_pairs(blob: bytes) -> List[Tuple[int, bytes]]:
    """Decode the engine's (u32 id, u32 len, bytes)* big-endian framing."""
    out = []
    off = 0
    end = len(blob)
    while off + 8 <= end:
        ident = int.from_bytes(blob[off : off + 4], "big")
        ln = int.from_bytes(blob[off + 4 : off + 8], "big")
        off += 8
        out.append((ident, blob[off : off + ln]))
        off += ln
    return out


def _host(router):
    """The host backend of the router's crypto backend (Protocol.host)."""
    return getattr(router.backend, "host", router.backend)


class CoinHost:
    """Crypto half of a native CommonCoin (common_coin.py oracle): owns the
    ThresholdSigner; share dedupe, threshold and routing live in the
    engine."""

    def __init__(self, router, cid: M.CoinId):
        self.router = router
        self.cid = cid
        self._signer = ts.ThresholdSigner(
            cid.to_bytes(),
            router.private_keys.ts_share,
            router.public_keys.ts_keys,
            _host(router),
            router.rng,
        )
        self._flagged: set = set()  # senders already reported as evidence

    def sign(self) -> None:
        # common_coin.py::handle_input: the engine broadcasts and records
        # the share and runs its combine check inside the rt_post call
        my_share = self._signer.sign()
        payload = M.CoinMessage(coin=self.cid, share=my_share.to_bytes())
        wire = self.router._native_send(payload)
        self._signer.add_share(my_share, verify=False)
        self.router._net._rt_post(
            self.router.my_id,
            PO_COIN_SHARE,
            self.cid.agreement,
            self.cid.epoch,
            wire.share,
        )

    def combine(self, blob: bytes) -> None:
        # common_coin.py::_try_combine crypto half: one batched G2 parse for
        # every share the engine has not shipped yet, then the combined
        # signature (deferred verification, prune on failure)
        t0 = time.perf_counter()
        pending = iter_pairs(blob)
        if pending:
            pts = deserialize_batch_g2(
                [data[: bls.G2_BYTES] for _, data in pending],
                _host(self.router), self.router.memo,
            )
            for (sender, _), pt in zip(pending, pts):
                if pt is None:
                    self._flag_invalid(sender)
                    continue  # malformed or outside the subgroup: dropped
                self._signer.add_share(
                    ts.PartialSignature(sigma=pt, signer_id=sender),
                    verify=False,
                )
        sig = self._signer.signature
        # shares the signer's batch check pruned are evidence too
        for sender in sorted(self._signer.pruned - self._flagged):
            self._flag_invalid(sender)
        self.router.coin_s += time.perf_counter() - t0
        if sig is not None:
            self.router._net._rt_post(
                self.router.my_id,
                PO_COIN_RESULT,
                self.cid.agreement,
                self.cid.epoch,
                bytes([1 if sig.parity else 0]),
            )

    def _flag_invalid(self, sender: int) -> None:
        if sender in self._flagged:
            return
        self._flagged.add(sender)
        self.router.evidence.record_invalid_share(
            self.cid.era, sender, "coin", (self.cid.agreement, self.cid.epoch)
        )


class HoneyBadgerHost:
    """Crypto half of a native HoneyBadger (honey_badger.py oracle): TPKE
    encrypt / decode / verify / decrypt and the era batcher's build and
    apply. The engine keeps the share candidates; `_cands` is this side's
    copy, refreshed from the engine at every batch build."""

    def __init__(self, router, era: int):
        self.router = router
        self.id = M.HoneyBadgerId(era=era)
        self._pub = router.public_keys
        self._priv = router.private_keys
        self._host = _host(router)
        self.me = router.my_id
        self.n = self._pub.n
        self._ciphertexts: Dict[int, tpke.EncryptedShare] = {}
        self._plaintexts: Dict[int, Optional[bytes]] = {}
        self._parsed: Dict[Tuple[int, int], tpke.PartiallyDecryptedShare] = {}
        self._cands: Dict[int, Dict[int, bytes]] = {}
        self._lag_cache: Dict[Tuple[int, ...], list] = {}
        self.done = False
        self.result: Optional[dict] = None

    def _post(self, op: int, a: int = 0, b: int = 0, data: bytes = b"") -> None:
        self.router._net._rt_post(self.router.my_id, op, a, b, data)

    # -- input ---------------------------------------------------------------
    def handle_input(self, value: bytes) -> None:
        enc = self._pub.tpke_pub.encrypt(
            value, self.me, self.router.rng, self._host
        )
        self._post(PO_HB_ACS_INPUT, data=enc.to_bytes())

    # -- ACS result (XO_HB_ACS) ----------------------------------------------
    def on_acs(self, blob: bytes) -> None:
        # honey_badger.py::handle_child_result crypto half. Slots come in
        # ascending order (the engine's), the oracle's sorted(value)
        items = iter_pairs(blob)
        decoded = tpke.decode_encrypted_shares_batch(
            [d for _, d in items], self._host, self.router.memo
        )
        parsed: Dict[int, tpke.EncryptedShare] = {}
        for (slot, _), share in zip(items, decoded):
            if share is None:
                # proposer shipped garbage through RBC: slot yields nothing
                self._plaintexts[slot] = None
                self._post(PO_HB_RESOLVED, a=slot)
            else:
                parsed[slot] = share
        slots = sorted(parsed)
        oks = tpke.batch_verify_ciphertexts(
            [parsed[s] for s in slots], self._host, self.router.rng,
            self.router.memo,
        )
        valid = []
        for slot, ok in zip(slots, oks):
            if not ok:
                self._plaintexts[slot] = None
                self._post(PO_HB_RESOLVED, a=slot)
                continue
            self._ciphertexts[slot] = parsed[slot]
            valid.append(slot)
        # one g1_mul_batch of the host backend for every U^{x_i} (the same
        # values, in the same emission order, as one decrypt_share a slot)
        decs = tpke.decrypt_shares_batch(
            self._priv.tpke_priv, [parsed[s] for s in valid], self._host
        )
        for slot, dec in zip(valid, decs):
            payload = M.DecryptedMessage(
                hb=self.id, share_id=slot, payload=dec.to_bytes()
            )
            wire = self.router._native_send(payload)
            self._parsed[(slot, self.me)] = dec
            self._post(PO_HB_DECRYPTED, a=slot, data=wire.payload)
        self._post(PO_HB_ACS_DONE)

    # -- batcher protocol (XO_HB_QUEUE -> lazy build -> results cb) ----------
    def on_queue(self) -> None:
        self.router.crypto_batcher.submit_lazy(
            self._build_era_jobs_lazy
        )

    def _refresh_cands(self) -> List[int]:
        """Pull the engine's ready slots and candidate shares; returns the
        ready slots (ascending, the oracle's _ready_slots order)."""
        blob = self.router._net._rt_hb_export(self.router.my_id)
        ready = []
        off = 0
        end = len(blob)
        while off + 8 <= end:
            slot = int.from_bytes(blob[off : off + 4], "big")
            nsenders = int.from_bytes(blob[off + 4 : off + 8], "big")
            off += 8
            cands: Dict[int, bytes] = {}
            for _ in range(nsenders):
                sender = int.from_bytes(blob[off : off + 4], "big")
                ln = int.from_bytes(blob[off + 4 : off + 8], "big")
                off += 8
                cands[sender] = blob[off : off + ln]
                off += ln
            self._cands[slot] = cands
            ready.append(slot)
        return ready

    def _build_era_jobs_lazy(self):
        self._post(PO_HB_CLEAR_QUEUED)
        if self.done:
            return None
        return self._build_era_jobs()

    def _build_era_jobs(self):
        # honey_badger.py::_build_era_jobs, with the ready slots and their
        # candidates exported from the engine
        from ..crypto.gpu_backend import EraSlotJob

        need = self._pub.f + 1
        while True:
            ready = self._refresh_cands()
            if not ready:
                return None
            chosen_by_slot = {
                s: sorted(self._cands[s])[:need] for s in ready
            }
            wanted = [(s, i) for s in ready for i in chosen_by_slot[s]]
            if self._parse_shares(wanted) == 0:
                break
        jobs = []
        for slot in ready:
            ct = self._ciphertexts[slot]
            chosen = chosen_by_slot[slot]
            key = tuple(chosen)
            cs = self._lag_cache.get(key)
            if cs is None:
                cs = bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)
                self._lag_cache[key] = cs
            lag_row = [0] * self.n
            u_row = [None] * self.n
            for i, c in zip(chosen, cs):
                lag_row[i] = c
                u_row[i] = self._parsed[(slot, i)].ui
            jobs.append(
                EraSlotJob(
                    u_by_validator=u_row,
                    lagrange_row=lag_row,
                    h=tpke.ciphertext_h(ct, self._host),
                    w=ct.w,
                )
            )
        for slot in ready:
            self._post(PO_HB_SET_INFLIGHT, a=slot)
        return (
            jobs,
            self._pub.tpke_verification_keys,
            lambda results, _ready=tuple(ready): self._era_results_cb(
                _ready, results
            ),
        )

    def _era_results_cb(self, ready, results) -> None:
        for slot in ready:
            self._post(PO_HB_CLEAR_INFLIGHT, a=slot)
        if self.done:
            return
        for slot, (ok, combined) in zip(ready, results):
            if ok:
                self._resolve(
                    slot,
                    tpke.decrypt_with_combined(self._ciphertexts[slot], combined),
                )
            else:
                self._try_decrypt(slot)
        self._post(PO_HB_REQUEUE_CHECK)

    def _resolve(self, slot: int, plaintext: Optional[bytes]) -> None:
        self._plaintexts[slot] = plaintext
        self._post(PO_HB_RESOLVED, a=slot)

    def _parse_shares(self, wanted) -> int:
        # honey_badger.py::_parse_shares over the candidates; a failure is
        # pruned on both sides (the engine's reject and this copy)
        missing = [k for k in wanted if k not in self._parsed]
        if not missing:
            return 0
        datas = [
            self._cands[slot][sender][: bls.G1_BYTES]
            for slot, sender in missing
        ]
        pts = deserialize_batch_g1(datas, self._host, self.router.memo)
        failures = 0
        for (slot, sender), pt in zip(missing, pts):
            if pt is None:
                failures += 1
                del self._cands[slot][sender]
                self._post(PO_HB_REJECT, a=slot, b=sender)
                self._flag_invalid(sender, slot)
            else:
                self._parsed[(slot, sender)] = tpke.PartiallyDecryptedShare(
                    ui=pt, decryptor_id=sender, share_id=slot
                )
        return failures

    def _try_decrypt(self, slot: int) -> None:
        # honey_badger.py::_try_decrypt (the per-slot host path)
        if slot in self._plaintexts:
            return
        need = self._pub.f + 1
        slot_shares = self._cands.get(slot, {})
        if len(slot_shares) < need:
            return
        self._parse_shares([(slot, i) for i in sorted(slot_shares)])
        if len(slot_shares) < need:
            return  # parse failures shrank the candidate set
        ct = self._ciphertexts[slot]
        decryptors = sorted(slot_shares)
        decs = [self._parsed[(slot, i)] for i in decryptors]
        vks = [self._pub.tpke_verification_keys[i] for i in decryptors]
        oks = self._pub.tpke_pub.batch_verify_shares(
            vks, decs, ct, self.router.rng, self._host
        )
        valid = [d for d, ok in zip(decs, oks) if ok]
        for d, ok in zip(decs, oks):
            if not ok:
                del slot_shares[d.decryptor_id]
                self._post(PO_HB_REJECT, a=slot, b=d.decryptor_id)
                self._flag_invalid(d.decryptor_id, slot)
        if len(valid) < need:
            return  # byzantine shares pruned; wait for more
        self._resolve(slot, self._pub.tpke_pub.full_decrypt(ct, valid, self._host))

    def _flag_invalid(self, sender: int, slot: int) -> None:
        # honey_badger.py::_flag_invalid (the same record coordinates)
        self.router.evidence.record_invalid_share(
            self.id.era, sender, "dec", (slot,)
        )

    # -- completion (XO_HB_DONE) ----------------------------------------------
    def finish(self) -> dict:
        self.done = True
        self.result = {
            slot: pt
            for slot, pt in sorted(self._plaintexts.items())
            if pt is not None
        }
        return self.result


class RootHost:
    """Crypto half of a native RootProtocol (root_protocol.py oracle): the
    proposal, the header built and ECDSA-signed, the peers' signatures
    verified, the block produced. `sign_s` / `verify_s`: seconds in the
    native sign_hash / verify_hash."""

    def __init__(self, router, era: int, producer, ecdsa_priv, ecdsa_pubs):
        self.router = router
        self.id = M.RootProtocolId(era=era)
        self._producer = producer
        self._priv = ecdsa_priv
        self._pubs = ecdsa_pubs
        self._header = None
        self._header_hash = None
        self._txs = None
        self._signatures: Dict[int, bytes] = {}
        self.sign_s = 0.0
        self.verify_s = 0.0

    # XO_ROOT_INPUT: root_protocol.py::handle_input's HoneyBadger half (the
    # engine requests the nonce coin right after this crossing returns)
    def on_input(self) -> None:
        from ..core.block_producer import encode_tx_batch

        proposal = self._producer.get_transactions_to_propose()
        self.router.hb_host(self.id.era).handle_input(
            encode_tx_batch(proposal)
        )

    # XO_ROOT_SIGN: root_protocol.py::_try_sign_header
    def on_sign(self, parity: int) -> None:
        from ..core.block_producer import decode_tx_batch

        hb_result = self.router.hb_host(self.id.era).result or {}
        nonce = (self.id.era << 1) | (1 if parity else 0)
        seen = set()
        txs = []
        for slot in sorted(hb_result):
            try:
                batch = decode_tx_batch(hb_result[slot])
            except (ValueError, AssertionError):
                continue  # malformed proposal: skip the slot
            for stx in batch:
                h = stx.hash()
                if h not in seen:
                    seen.add(h)
                    txs.append(stx)
        self._txs = txs
        self._header = self._producer.create_header(self.id.era, txs, nonce)
        self._header_hash = self._header.hash()
        t0 = time.perf_counter()
        sig = ecdsa.sign_hash(self._priv, self._header_hash)
        self.sign_s += time.perf_counter() - t0
        payload = M.SignedHeaderMessage(
            root=self.id, header_bytes=self._header.encode(), signature=sig
        )
        wire = self.router._native_send(payload)
        self._signatures[self.router.my_id] = sig
        # two segments: the fresh bytes drive header matching (the oracle
        # compares with self._header.encode()), the wire bytes (the
        # journal's recorded ones after a restart) are what broadcasts
        own = (
            len(payload.header_bytes).to_bytes(4, "big")
            + payload.header_bytes
            + payload.signature
        )
        bcast = (
            len(wire.header_bytes).to_bytes(4, "big")
            + wire.header_bytes
            + wire.signature
        )
        self.router._net._rt_post(
            self.router.my_id,
            PO_ROOT_HEADER,
            0,
            0,
            len(own).to_bytes(4, "big") + own + bcast,
        )

    # XO_ROOT_VERIFY: root_protocol.py::_on_signed_header's signature checks
    def on_verify(self, blob: bytes) -> None:
        me = self.router.my_id
        era = self.id.era
        for sender, sig in iter_pairs(blob):
            t0 = time.perf_counter()
            ok = ecdsa.verify_hash(self._pubs[sender], self._header_hash, sig)
            self.verify_s += time.perf_counter() - t0
            if ok:
                self._signatures[sender] = sig
                self.router._net._rt_post(me, PO_ROOT_ACCEPT, sender, 0)
            else:
                self.router._net._rt_post(me, PO_ROOT_REJECT, sender, 0)
                self.router.evidence.record_invalid_share(era, sender, "hdr", ())

    # XO_ROOT_PRODUCE: root_protocol.py::_try_produce
    def on_produce(self) -> None:
        from ..core.types import MultiSig

        multisig = MultiSig(
            signatures=tuple(sorted(self._signatures.items()))
        )
        block = self._producer.produce_block(self._header, self._txs, multisig)
        self.router._native_results[self.id] = block
        # top-level completion: break the engine out of its chunk, as
        # internal_response(to_id=None) does for Python protocols
        self.router._net._request_stop()


class RbcHost:
    """RS + Merkle half of the native ReliableBroadcast (the version-7
    boundary). The engine keeps Bracha's message state machine (VAL / ECHO /
    READY dedupe, thresholds, delivery) and crosses out only the codec:
    XO_RBC_ENCODE for the sender's shards, XO_RBC_NEED for the interpolate,
    re-encode and root recheck. The engine sends these crossings only where
    the network turned its RBC host on, which it does with an RBC batcher:
    every validator's codec work of an era fuses into one batched product on
    the batcher's device, and its per-(root, k, n) verdict memo answers the
    N in-process validators' equal interpolations once. (The reference's
    inline branches for a host without a batcher serve no call here.)"""

    def __init__(self, router, era: int):
        self.router = router
        self.era = era
        self.me = router.my_id
        self.n = router.n_validators
        self.f = router.f
        self.k = max(self.n - 2 * self.f, 1)

    # XO_RBC_ENCODE: reliable_broadcast.py::handle_input's codec half
    def on_encode(self, slot: int, value: bytes) -> None:
        self.router.rbc_batcher.submit_encode(
            self.era,
            value,
            self.k,
            self.n,
            lambda shards, _slot=slot: self._post_vals(_slot, shards),
        )

    def _post_vals(self, slot: int, shards) -> None:
        leaves = hashes.keccak256_batch(shards)
        root = hashes.merkle_root(leaves)
        blob = bytearray(self.era.to_bytes(4, "big"))
        blob += root
        blob += self.n.to_bytes(4, "big")
        for i, branch in enumerate(hashes.merkle_proofs(leaves)):
            blob += len(branch).to_bytes(4, "big")
            for h in branch:
                blob += len(h).to_bytes(4, "big")
                blob += h
            blob += len(shards[i]).to_bytes(4, "big")
            blob += shards[i]
        self.router._net._rt_post(self.me, PO_RBC_VALS, slot, 0, bytes(blob))

    # XO_RBC_NEED: reliable_broadcast.py::_try_interpolate's codec half
    def on_need(self, slot: int, blob: bytes) -> None:
        root = blob[:32]
        full = [None] * self.n
        for idx, shard in iter_pairs(blob[32:]):
            if 0 <= idx < self.n:
                full[idx] = shard
        self.router.rbc_batcher.submit_interpolate(
            self.era,
            full,
            self.k,
            self.n,
            root,
            lambda payload, _slot=slot, _root=root: self._post_result(
                _slot, _root, payload
            ),
        )

    def _post_result(self, slot: int, root: bytes, payload) -> None:
        ok = 1 if payload is not None else 0
        blob = self.era.to_bytes(4, "big") + root + (payload or b"")
        self.router._net._rt_post(self.me, PO_RBC_RESULT, slot, ok, blob)
