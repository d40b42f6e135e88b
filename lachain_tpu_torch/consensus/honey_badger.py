"""HoneyBadger: ACS orchestration + threshold decryption of the agreed set.

The port of `lachain_tpu/consensus/honey_badger.py`, with the behavior of
the C# reference's HoneyBadger.cs:
  * input: TPKE-encrypt my tx batch, feed ACS
  * on the ACS result: decrypt every accepted slot's ciphertext and
    broadcast the partial decryption
  * incoming decryption shares: stash until ACS completes, dedupe per
    (decryptor, slot), then verify
  * at F+1 valid shares for a slot: full-decrypt; result = {slot: plaintext}

Shares accumulate per slot and are verified and combined in batch: each
ready slot becomes an `EraSlotJob` (its first F+1 shares by decryptor id,
their Lagrange row, H(U, V) and W). With the router's `crypto_batcher`
(consensus/crypto_batcher.TpkeEraBatcher) the jobs are built at its flush
(`submit_lazy`), which fuses every validator's slots into the backend's
era calls on the card; without one they go to
`router.backend.tpke_era_verify_combine` at once. A slot that fails the
era's check falls to the per-slot host path (`batch_verify_shares`, which
prunes and reports the bad shares, then `full_decrypt`).

Differences, by the port's rules: the ciphertext's randomness and every
RLC weight come from the router's `rng`; the host ops run on the
router's host backend (`Protocol.host`) and parse through its `memo`;
an era call that fails raises (the reference logs and falls back to the
host per slot); no tracing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..crypto import bls12381 as bls
from ..crypto import tpke
from ..crypto.provider import deserialize_batch_g1
from . import messages as M
from .keys import PrivateConsensusKeys, PublicConsensusKeys
from .protocol import Broadcaster, Protocol


class HoneyBadger(Protocol):
    def __init__(
        self,
        pid: M.HoneyBadgerId,
        broadcaster: Broadcaster,
        public_keys: PublicConsensusKeys,
        private_keys: PrivateConsensusKeys,
    ):
        super().__init__(pid, broadcaster)
        self._pub = public_keys
        self._priv = private_keys
        self._ciphertexts: Optional[Dict[int, tpke.EncryptedShare]] = None
        # per-slot: decryptor -> RAW share bytes (candidates, unverified).
        # Points are parsed lazily — only the t+1 shares actually chosen for
        # a combination ever pay the G1 parse + subgroup check (the ingest
        # path peeks the ids straight from the wire bytes)
        self._shares: Dict[int, Dict[int, bytes]] = {}
        self._parsed: Dict[Tuple[int, int], tpke.PartiallyDecryptedShare] = {}
        self._rejected: Dict[int, set] = {}
        self._plaintexts: Dict[int, Optional[bytes]] = {}
        # pre-ACS stash, deduped by (sender, slot) and bounded: a byzantine
        # validator may send at most one candidate per (sender, slot) pair
        self._stashed: Dict[Tuple[int, int], M.DecryptedMessage] = {}
        # slots whose jobs sit in a router-level crypto batcher awaiting flush
        self._inflight: set = set()
        self._batcher_queued = False
        self._lag_cache: Dict[Tuple[int, ...], list] = {}
        self._done = False

    # -- input ---------------------------------------------------------------
    def handle_input(self, value: bytes) -> None:
        enc = self._pub.tpke_pub.encrypt(
            value, self.me, self.broadcaster.rng, self.host
        )
        self.request(M.CommonSubsetId(era=self.id.era), enc.to_bytes())

    # -- ACS result ----------------------------------------------------------
    def handle_child_result(self, child_id, value) -> None:
        if not isinstance(child_id, M.CommonSubsetId) or self._ciphertexts is not None:
            return
        self._ciphertexts = {}
        parsed: Dict[int, tpke.EncryptedShare] = {}
        in_slots = sorted(value)
        decoded = tpke.decode_encrypted_shares_batch(
            [value[s] for s in in_slots], self.host, self.broadcaster.memo
        )
        for slot, share in zip(in_slots, decoded):
            if share is None:
                # proposer shipped garbage through RBC: slot yields nothing
                self._plaintexts[slot] = None
            else:
                parsed[slot] = share
        # ciphertext validity for ALL accepted slots in one RLC multi-pairing
        # (2 pairings per slot in the reference, TPKE/PrivateKey.cs:21-27)
        slots = sorted(parsed)
        oks = tpke.batch_verify_ciphertexts(
            [parsed[s] for s in slots], self.host, self.broadcaster.rng,
            self.broadcaster.memo,
        )
        for slot, ok in zip(slots, oks):
            if not ok:
                # invalid ciphertext (fails the pairing validity check)
                self._plaintexts[slot] = None
                continue
            share = parsed[slot]
            self._ciphertexts[slot] = share
            dec = self._priv.tpke_priv.decrypt_share(
                share, check=False, backend=self.host
            )
            self.broadcaster.broadcast(
                M.DecryptedMessage(
                    hb=self.id, share_id=slot, payload=dec.to_bytes()
                )
            )
            self._shares.setdefault(slot, {})[self.me] = dec.to_bytes()
            self._parsed[(slot, self.me)] = dec
        stashed, self._stashed = self._stashed, {}
        for (sender, _slot), msg in stashed.items():
            self._on_decrypted(sender, msg, defer_decrypt=True)
        # era-tick aggregation point: by the time ACS completes, most slots
        # already hold their F+1 shares (they arrived during agreement and
        # were stashed) — decrypt them all in ONE batched call. This is the
        # S x K kernel shape BASELINE.md measures.
        self._try_decrypt_ready()
        self._try_complete()

    # -- externals -----------------------------------------------------------
    def handle_external(self, sender: int, payload) -> None:
        if not isinstance(payload, M.DecryptedMessage):
            raise TypeError(f"unexpected payload {type(payload)}")
        if self._ciphertexts is None:
            key = (sender, payload.share_id)
            if key not in self._stashed and 0 <= payload.share_id < self.n:
                self._stashed[key] = payload
            return
        self._on_decrypted(sender, payload)

    def _on_decrypted(
        self, sender: int, msg: M.DecryptedMessage, defer_decrypt: bool = False
    ) -> None:
        slot = msg.share_id
        if slot not in (self._ciphertexts or {}):
            return  # unknown/rejected slot
        if slot in self._plaintexts:
            return  # already decrypted
        # id checks straight off the wire bytes — the expensive point parse
        # is deferred until this share is chosen for a combination
        # (HoneyBadger.cs:196-217 dedup/decryptor-id checks)
        ids = tpke.peek_decrypted_share_ids(msg.payload)
        if ids is None or ids[0] != sender or ids[1] != slot:
            return
        slot_shares = self._shares.setdefault(slot, {})
        if sender in slot_shares or sender in self._rejected.get(slot, set()):
            return
        slot_shares[sender] = msg.payload
        if defer_decrypt:
            return
        batcher = getattr(self.broadcaster, "crypto_batcher", None)
        if batcher is not None:
            # O(1) hot path: note once that ready work exists; the expensive
            # per-slot preparation happens exactly once, at flush time
            if (
                not self._batcher_queued
                and slot not in self._inflight
                and len(slot_shares) >= self._pub.f + 1
            ):
                self._batcher_queued = True
                batcher.submit_lazy(self._build_era_jobs_lazy)
        else:
            self._try_decrypt_ready()
            self._try_complete()

    # -- batched verify + combine --------------------------------------------
    def _ready_slots(self) -> List[int]:
        need = self._pub.f + 1
        return [
            s
            for s in (self._ciphertexts or {})
            if s not in self._plaintexts
            and s not in self._inflight
            and len(self._shares.get(s, {})) >= need
        ]

    def _try_decrypt_ready(self) -> None:
        """Decrypt every slot holding >= F+1 candidate shares, batching all
        of them through the backend's era call (a backend without one takes
        the per-slot host path)."""
        era_fn = getattr(self.broadcaster.backend, "tpke_era_verify_combine", None)
        if era_fn is None:
            for slot in self._ready_slots():
                self._try_decrypt(slot)
            return
        batcher = getattr(self.broadcaster, "crypto_batcher", None)
        if batcher is not None:
            # router-level flush batcher: the delivery loop flushes at
            # quiescence, fusing every validator's pending slots into ONE
            # backend call (one kernel launch on the TPU backend)
            if not self._batcher_queued and self._ready_slots():
                self._batcher_queued = True
                batcher.submit_lazy(self._build_era_jobs_lazy)
            return
        built = self._build_era_jobs()
        if built is None:
            return
        jobs, vks, cb = built
        cb(era_fn(jobs, vks, self.broadcaster.rng))

    def _build_era_jobs_lazy(self):
        """Batcher flush hook: build jobs for everything ready RIGHT NOW."""
        self._batcher_queued = False
        if self.terminated or self._done:
            return None
        return self._build_era_jobs()

    def _build_era_jobs(self):
        """Choose + lazily parse the combination shares for every ready slot
        and return (jobs, verification_keys, callback), or None when nothing
        is ready. A share failing the parse/subgroup check is dropped, its
        sender rejected, and the slot's choice recomputed from the survivors
        (the loop terminates: every retry removes at least one share)."""
        # the card backend's module (and torch) load only where jobs are made
        from ..crypto.gpu_backend import EraSlotJob

        need = self._pub.f + 1
        while True:
            ready = self._ready_slots()
            if not ready:
                return None
            chosen_by_slot = {
                s: sorted(self._shares[s])[:need] for s in ready
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
                # most slots choose the same first-F+1 decryptor set, so the
                # Lagrange coefficients memoize extremely well per era
                cs = bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)
                self._lag_cache[key] = cs
            lag_row = [0] * self.n
            u_row = [None] * self.n
            # only the chosen F+1 lanes go live: they are exactly the
            # shares the combine consumes, so a byzantine validator's
            # extra bad share (never combined) cannot fail the grand check
            # and send the slot to the per-slot host path every era
            for i, c in zip(chosen, cs):
                lag_row[i] = c
                u_row[i] = self._parsed[(slot, i)].ui
            jobs.append(
                EraSlotJob(
                    u_by_validator=u_row,
                    lagrange_row=lag_row,
                    h=tpke.ciphertext_h(ct, self.host),
                    w=ct.w,
                )
            )
        self._inflight.update(ready)
        return (
            jobs,
            self._pub.tpke_verification_keys,
            lambda results, _ready=tuple(ready): self._era_results_cb(
                _ready, results
            ),
        )

    def _era_results_cb(self, ready, results) -> None:
        """Era call / batcher flush callback: per-job (ok, combined)."""
        self._inflight.difference_update(ready)
        if self.terminated or self._done:
            return
        self._apply_era_results(ready, results)
        # slots whose batch failed may have pruned a share but still hold
        # (or later regain) a quorum: re-queue whatever remains ready
        self._try_decrypt_ready()
        self._try_complete()

    def _apply_era_results(self, ready, results) -> None:
        for slot, (ok, combined) in zip(ready, results):
            if ok:
                self._plaintexts[slot] = tpke.decrypt_with_combined(
                    self._ciphertexts[slot], combined
                )
            else:
                # a byzantine share poisoned the slot batch: the host path
                # isolates + prunes it (and may still decrypt from the
                # surviving valid shares)
                self._try_decrypt(slot)

    def _parse_shares(self, wanted) -> int:
        """Parse raw share bytes into `self._parsed` for the given
        (slot, sender) pairs — one batched deserialize+subgroup check for
        everything missing. Failing shares are dropped and their senders
        rejected for that slot. Returns the number of failures."""
        missing = [k for k in wanted if k not in self._parsed]
        if not missing:
            return 0
        datas = [
            self._shares[slot][sender][: bls.G1_BYTES]
            for slot, sender in missing
        ]
        pts = deserialize_batch_g1(datas, self.host, self.broadcaster.memo)
        failures = 0
        for (slot, sender), pt in zip(missing, pts):
            if pt is None:
                failures += 1
                del self._shares[slot][sender]
                self._rejected.setdefault(slot, set()).add(sender)
                self._flag_invalid(sender, slot)
            else:
                self._parsed[(slot, sender)] = tpke.PartiallyDecryptedShare(
                    ui=pt, decryptor_id=sender, share_id=slot
                )
        return failures

    def _try_decrypt(self, slot: int) -> None:
        if slot in self._plaintexts or self._ciphertexts is None:
            return
        need = self._pub.f + 1
        slot_shares = self._shares.get(slot, {})
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
            vks, decs, ct, self.broadcaster.rng, self.host
        )
        valid = [d for d, ok in zip(decs, oks) if ok]
        for d, ok in zip(decs, oks):
            if not ok:
                del slot_shares[d.decryptor_id]
                self._rejected.setdefault(slot, set()).add(d.decryptor_id)
                self._flag_invalid(d.decryptor_id, slot)
        if len(valid) < need:
            return  # byzantine shares pruned; wait for more
        self._plaintexts[slot] = self._pub.tpke_pub.full_decrypt(
            ct, valid, self.host
        )

    def _flag_invalid(self, sender: int, slot: int) -> None:
        """A decryption share failed its parse or pairing check: record
        the offense (evidence.py) on the router's store."""
        self.broadcaster.evidence.record_invalid_share(
            self.id.era, sender, "dec", (slot,)
        )

    def _try_complete(self) -> None:
        if self._done or self._ciphertexts is None:
            return
        # every ACS slot must be resolved (decrypted or rejected-as-garbage)
        if any(s not in self._plaintexts for s in self._ciphertexts):
            return
        self._done = True
        result = {
            slot: pt
            for slot, pt in sorted(self._plaintexts.items())
            if pt is not None
        }
        self.emit_result(result)
