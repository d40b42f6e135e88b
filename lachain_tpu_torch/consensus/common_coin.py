"""CommonCoin: threshold signature of the coin id; coin = signature parity.

The port of `lachain_tpu/consensus/common_coin.py`, with the behavior of
the C# reference's CommonCoin.cs:
  * on request: sign the CoinId bytes with my TS share, broadcast
  * collect shares; combine at t+1
  * coin bit = combined signature parity

Shares are parsed lazily, once t+1 candidates exist, in one
provider.deserialize_batch_g2 call (memoized across the process's
validators by the router's `memo`), and go to a ThresholdSigner with
deferred verification: the combined signature is checked with 2
pairings, and only a failure runs the RLC batch check that prunes the bad
shares, which are recorded as evidence. The coin runs on the host
backend (`Protocol.host`), as the reference's does under its TPU backend
(coin MSMs are far below its device threshold). The seconds spent
combining are added to the router's `coin_s`.
"""
from __future__ import annotations

import time

from ..crypto import bls12381 as bls
from ..crypto import threshold_sig as ts
from ..crypto.provider import deserialize_batch_g2
from . import messages as M
from .protocol import Broadcaster, Protocol


class CommonCoin(Protocol):
    def __init__(
        self,
        pid: M.CoinId,
        broadcaster: Broadcaster,
        key_share: ts.TsPrivateKeyShare,
        pub_key_set: ts.TsPublicKeySet,
    ):
        super().__init__(pid, broadcaster)
        self._signer = ts.ThresholdSigner(
            pid.to_bytes(), key_share, pub_key_set, self.host, broadcaster.rng
        )
        self._requested = False
        self._done = False
        # raw share bytes per sender, parsed lazily: only once t+1
        # candidates exist does anyone pay the G2 parse
        self._raw: dict = {}
        self._parsed: set = set()
        self._flagged: set = set()  # senders already reported as evidence

    def handle_input(self, value) -> None:
        if self._requested:
            return
        self._requested = True
        my_share = self._signer.sign()
        self.broadcaster.broadcast(
            M.CoinMessage(coin=self.id, share=my_share.to_bytes())
        )
        # my own share counts immediately (no parse needed: it is ours)
        self._raw[self.me] = my_share.to_bytes()
        self._parsed.add(self.me)
        self._signer.add_share(my_share, verify=False)
        self._try_combine()

    def handle_external(self, sender: int, payload) -> None:
        if not isinstance(payload, M.CoinMessage):
            raise TypeError(f"unexpected payload {type(payload)}")
        if self._done or sender in self._raw:
            return
        data = payload.share
        # length and id checks straight off the wire; the share must be the
        # sender's own; the point parse waits for the combine
        if len(data) != bls.G2_BYTES + 4:
            return
        if int.from_bytes(data[bls.G2_BYTES :], "big") != sender:
            return
        self._raw[sender] = data
        self._try_combine()

    def _try_combine(self) -> None:
        if self._done:
            return
        need = self._signer.pub_key_set.t + 1
        if len(self._raw) < need:
            return
        t0 = time.perf_counter()
        pending = [s for s in sorted(self._raw) if s not in self._parsed]
        if pending:
            pts = deserialize_batch_g2(
                [self._raw[s][: bls.G2_BYTES] for s in pending],
                self.host, self.broadcaster.memo,
            )
            for s, pt in zip(pending, pts):
                self._parsed.add(s)
                if pt is None:
                    self._flag_invalid(s)
                    continue  # malformed or outside the subgroup: dropped
                self._signer.add_share(
                    ts.PartialSignature(sigma=pt, signer_id=s), verify=False
                )
        sig = self._signer.signature
        # shares the signer's batch check pruned (well-formed points that
        # sign another message) are evidence too
        for s in sorted(self._signer.pruned - self._flagged):
            self._flag_invalid(s)
        self.broadcaster.coin_s += time.perf_counter() - t0
        if sig is not None:
            self._done = True
            self.emit_result(sig.parity)

    def _flag_invalid(self, sender: int) -> None:
        if sender in self._flagged:
            return
        self._flagged.add(sender)
        self.broadcaster.evidence.record_invalid_share(
            self.id.era, sender, "coin", (self.id.agreement, self.id.epoch)
        )
