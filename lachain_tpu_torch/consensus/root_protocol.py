"""RootProtocol: an era from its proposals to the signed block.

The port of the JAX package's `lachain_tpu.consensus.root_protocol`,
event for event:
  * on input: the producer's proposal goes to HoneyBadger
    (`encode_tx_batch`), and the era nonce's coin is requested
    (`NONCE_AGREEMENT`);
  * once HoneyBadger and the coin have both answered: the slots' batches
    are decoded in slot order (a malformed batch skips its slot), the
    transactions deduplicated by hash, the header made by the producer,
    ECDSA-signed (`ecdsa.sign_hash`, the native host library) and
    broadcast as a SignedHeaderMessage;
  * headers that arrive before ours are stashed, one per sender;
  * a matching header whose signature does not verify
    (`ecdsa.verify_hash`) is recorded as evidence ("hdr") and dropped; a
    disagreeing header is dropped;
  * at N - f signatures (ours included) the producer makes the block with
    the MultiSig of the signatures in validator order.

The producer is a seam (`get_transactions_to_propose`, `create_header`,
`produce_block`: the shape of the reference's BlockProducer), filled by a
node, a test or `chip_smoke.py`; the router creates the protocol through
its `extra_factories`. The era's transactions are stamped "decide"
(utils/txtrace.py) as in the reference; the seconds spent signing and
verifying headers add up in the plain attributes `sign_s` and `verify_s`,
which a chip run reads. Imports no torch.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set

from ..crypto import ecdsa
from . import messages as M
from .protocol import Broadcaster, Protocol
from ..utils import txtrace

NONCE_AGREEMENT = -1  # dedicated coin slot for the block nonce


class RootProtocol(Protocol):
    def __init__(
        self,
        pid: M.RootProtocolId,
        broadcaster: Broadcaster,
        producer,  # BlockProducer seam
        ecdsa_priv: bytes,
        ecdsa_pubs: List[bytes],
    ):
        super().__init__(pid, broadcaster)
        self._producer = producer
        self._priv = ecdsa_priv
        self._pubs = ecdsa_pubs
        self._hb_result: Optional[dict] = None
        self._nonce: Optional[int] = None
        self._header = None
        self._txs = None
        self._signatures: Dict[int, bytes] = {}
        self._early_headers: Dict[int, M.SignedHeaderMessage] = {}
        self._produced = False
        self.sign_s = 0.0
        self.verify_s = 0.0

    # -- era start -------------------------------------------------------------
    def handle_input(self, value) -> None:
        from ..core.block_producer import encode_tx_batch

        proposal = self._producer.get_transactions_to_propose()
        self.request(
            M.HoneyBadgerId(era=self.id.era), encode_tx_batch(proposal)
        )
        self.request(
            M.CoinId(era=self.id.era, agreement=NONCE_AGREEMENT, epoch=0), None
        )

    # -- children ---------------------------------------------------------------
    def handle_child_result(self, child_id, value) -> None:
        if isinstance(child_id, M.HoneyBadgerId):
            if self._hb_result is None:
                self._hb_result = value
        elif isinstance(child_id, M.CoinId):
            if self._nonce is None:
                # fold coin into a u64 nonce (reference XOR-folds the combined
                # signature, RootProtocol.cs:316-322)
                self._nonce = (self.id.era << 1) | (1 if value else 0)
        self._try_sign_header()

    # -- header signing ----------------------------------------------------------
    def _try_sign_header(self) -> None:
        if self._header is not None or self._hb_result is None or self._nonce is None:
            return
        from ..core.block_producer import decode_tx_batch

        seen: Set[bytes] = set()
        txs = []
        for slot in sorted(self._hb_result):
            try:
                batch = decode_tx_batch(self._hb_result[slot])
            except (ValueError, AssertionError):
                continue  # malformed proposal: skip the slot
            for stx in batch:
                h = stx.hash()
                if h not in seen:
                    seen.add(h)
                    txs.append(stx)
        self._txs = txs
        # tx lifecycle: consensus agreed on the era's tx union (the decide
        # point: every honest node derives the same set here)
        txtrace.stamp_many(
            (stx.hash() for stx in txs), "decide", era=self.id.era
        )
        self._header = self._producer.create_header(
            self.id.era, txs, self._nonce
        )
        t0 = time.perf_counter()
        sig = ecdsa.sign_hash(self._priv, self._header.hash())
        self.sign_s += time.perf_counter() - t0
        self.broadcaster.broadcast(
            M.SignedHeaderMessage(
                root=self.id,
                header_bytes=self._header.encode(),
                signature=sig,
            )
        )
        self._signatures[self.me] = sig
        # headers that arrived before ours was built
        early, self._early_headers = self._early_headers, {}
        for sender, msg in early.items():
            self._on_signed_header(sender, msg)
        self._try_produce()

    # -- externals ----------------------------------------------------------------
    def handle_external(self, sender: int, payload) -> None:
        if not isinstance(payload, M.SignedHeaderMessage):
            raise TypeError(f"unexpected payload {type(payload)}")
        if self._header is None:
            # one stashed header per sender: a byzantine flooder can only
            # displace its own earlier message, never an honest validator's
            self._early_headers[sender] = payload
            return
        self._on_signed_header(sender, payload)

    def _on_signed_header(self, sender: int, msg: M.SignedHeaderMessage) -> None:
        if sender in self._signatures:
            return
        if msg.header_bytes != self._header.encode():
            return  # disagreeing header (reference logs mismatch, 264-314)
        t0 = time.perf_counter()
        ok = ecdsa.verify_hash(self._pubs[sender], self._header.hash(), msg.signature)
        self.verify_s += time.perf_counter() - t0
        if not ok:
            ev = getattr(self.broadcaster, "evidence", None)
            if ev is not None:
                ev.record_invalid_share(self.id.era, sender, "hdr", ())
            return
        self._signatures[sender] = msg.signature
        self._try_produce()

    # -- production -----------------------------------------------------------------
    def _try_produce(self) -> None:
        if self._produced or self._header is None:
            return
        if len(self._signatures) < self.n - self.f:
            return
        from ..core.types import MultiSig

        multisig = MultiSig(
            signatures=tuple(sorted(self._signatures.items()))
        )
        block = self._producer.produce_block(self._header, self._txs, multisig)
        self._produced = True
        self.emit_result(block)
