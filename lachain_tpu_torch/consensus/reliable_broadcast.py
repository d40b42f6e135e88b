"""Reliable broadcast (Bracha + Reed-Solomon shards + Merkle commitments).

The port of `lachain_tpu/consensus/reliable_broadcast.py`, with the
behavior of the C# reference's ReliableBroadcast.cs:
  * the sender RS-encodes the payload into N shards over a Merkle root and
    ships VAL_i to validator i
  * VAL accepted only from the slot's sender
  * each validator ECHOes its own shard; at N-2F echoes, interpolate the
    payload, re-encode, recheck the root
  * READY on successful interpolation; READY amplification at F+1
  * deliver at 2F+1 READY + successful reconstruction

Shard count: K = N - 2F data shards (tolerates F missing + F wrong).

Inline, the codec is the port's host codec (`ops/rs.py`, numpy); with the
router's `rbc_batcher` (consensus/rbc_batcher.RbcEraBatcher) the encodes
and interpolations queue for the era's batched flush on its device
(reference :49-68, :151-200). Leaves and Merkle branches hash in the host
library (`hashes.keccak256_batch`, `keccak256_host`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..crypto import hashes
from ..ops import rs
from . import messages as M
from .protocol import Broadcaster, Protocol


class ReliableBroadcast(Protocol):
    def __init__(self, pid: M.ReliableBroadcastId, broadcaster: Broadcaster):
        super().__init__(pid, broadcaster)
        self._echo: Dict[bytes, Dict[int, Tuple[bytes, Tuple[bytes, ...]]]] = {}
        self._ready: Dict[bytes, Set[int]] = {}
        self._echo_sent = False
        self._ready_sent = False
        # per-root reconstruction (an equivocating sender can make different
        # honest nodes interpolate different roots first; delivery must follow
        # whichever root reaches READY quorum, so track payloads per root)
        self._payloads: Dict[bytes, bytes] = {}
        self._bad_roots: Set[bytes] = set()
        self._delivered = False
        self._val_seen = False
        # roots with an interpolation submitted to the era RBC batcher and
        # not yet resolved — suppresses duplicate submissions while further
        # echoes for the same root keep arriving
        self._interp_inflight: Set[bytes] = set()

    @property
    def _k(self) -> int:
        return max(self.n - 2 * self.f, 1)

    @property
    def _batcher(self):
        """The era RBC flush batcher, when the network wired one onto the
        router (rbc_batcher.py); None means every codec call runs inline."""
        return getattr(self.broadcaster, "rbc_batcher", None)

    # -- sender input --------------------------------------------------------
    def handle_input(self, value: Optional[bytes]) -> None:
        if value is None:
            return  # participant-only instance
        if self.id.sender_id != self.me:
            raise ValueError("only the slot's sender may input a payload")
        batcher = self._batcher
        if batcher is not None:
            # eager-encode: the proposal is queued before the era front so
            # the first flush codes every validator's proposal in one call
            batcher.submit_encode(
                self.id.era, value, self._k, self.n, self._send_vals
            )
            return
        self._send_vals(rs.encode(value, self._k, self.n))

    def _send_vals(self, shards: List[bytes]) -> None:
        leaves = hashes.keccak256_batch(shards)
        root = hashes.merkle_root(leaves)
        branches = hashes.merkle_proofs(leaves)
        for i in range(self.n):
            branch = tuple(branches[i])
            self.broadcaster.send_to(
                i,
                M.ValMessage(
                    rbc=self.id,
                    root=root,
                    branch=branch,
                    shard=shards[i],
                    shard_index=i,
                ),
            )

    # -- externals -----------------------------------------------------------
    def handle_external(self, sender: int, payload) -> None:
        if isinstance(payload, M.ValMessage):
            self._on_val(sender, payload)
        elif isinstance(payload, M.EchoMessage):
            self._on_echo(sender, payload)
        elif isinstance(payload, M.ReadyMessage):
            self._on_ready(sender, payload)
        else:
            raise TypeError(f"unexpected payload {type(payload)}")

    def _on_val(self, sender: int, msg: M.ValMessage) -> None:
        # VAL must come from the slot's sender, once, addressed to me
        if sender != self.id.sender_id or self._val_seen:
            return
        if msg.shard_index != self.me:
            return
        if not self._check_branch(msg.root, msg.branch, msg.shard, msg.shard_index):
            return
        self._val_seen = True
        if not self._echo_sent:
            self._echo_sent = True
            self.broadcaster.broadcast(
                M.EchoMessage(
                    rbc=self.id,
                    root=msg.root,
                    branch=msg.branch,
                    shard=msg.shard,
                    shard_index=msg.shard_index,
                )
            )

    def _on_echo(self, sender: int, msg: M.EchoMessage) -> None:
        # each validator echoes exactly its own shard
        if msg.shard_index != sender:
            return
        # duplicate check BEFORE the branch proof: a re-delivered echo must
        # not pay keccak + Merkle verification again (the .get keeps bogus
        # roots from allocating state pre-verification)
        seen = self._echo.get(msg.root)
        if seen is not None and sender in seen:
            return
        if not self._check_branch(msg.root, msg.branch, msg.shard, msg.shard_index):
            return
        slot = self._echo.setdefault(msg.root, {})
        slot[sender] = (msg.shard, msg.branch)
        self._try_interpolate(msg.root)
        self._try_deliver()

    def _on_ready(self, sender: int, msg: M.ReadyMessage) -> None:
        peers = self._ready.setdefault(msg.root, set())
        if sender in peers:
            return
        peers.add(sender)
        if len(peers) >= self.f + 1 and not self._ready_sent:
            self._ready_sent = True
            self.broadcaster.broadcast(
                M.ReadyMessage(rbc=self.id, root=msg.root)
            )
        self._try_deliver()

    # -- reconstruction ------------------------------------------------------
    def _check_branch(
        self, root: bytes, branch, shard: bytes, index: int
    ) -> bool:
        leaf = hashes.keccak256_host(shard)
        return hashes.merkle_verify(leaf, index, branch, root)

    def _try_interpolate(self, root: bytes) -> None:
        if root in self._payloads or root in self._bad_roots:
            return
        slot = self._echo.get(root, {})
        if len(slot) < self.n - 2 * self.f:
            return
        full: List[Optional[bytes]] = [None] * self.n
        for idx, (shard, _branch) in slot.items():
            full[idx] = shard
        batcher = self._batcher
        if batcher is not None:
            if root in self._interp_inflight:
                return  # already queued; later echoes cannot change the verdict
            self._interp_inflight.add(root)
            batcher.submit_interpolate(
                self.id.era,
                full,
                self._k,
                self.n,
                root,
                lambda payload, _root=root: self._apply_interpolation(
                    _root, payload
                ),
            )
            return
        reencoded = rs.reencode(full, self._k)
        if reencoded is None:
            self._apply_interpolation(root, None)
            return
        # malicious-sender check: recomputed Merkle root must match
        if hashes.merkle_root(hashes.keccak256_batch(reencoded)) != root:
            self._apply_interpolation(root, None)  # equivocated shards
            return
        self._apply_interpolation(root, rs.decode(full, self._k))

    def _apply_interpolation(
        self, root: bytes, payload: Optional[bytes]
    ) -> None:
        """Settle one interpolation verdict (inline or batcher callback):
        None marks the root bad forever; a payload arms READY + delivery."""
        self._interp_inflight.discard(root)
        if root in self._payloads or root in self._bad_roots:
            return
        if payload is None:
            self._bad_roots.add(root)
            return
        self._payloads[root] = payload
        if not self._ready_sent:
            self._ready_sent = True
            self.broadcaster.broadcast(M.ReadyMessage(rbc=self.id, root=root))
        self._try_deliver()

    def _try_deliver(self) -> None:
        if self._delivered:
            return
        for root, payload in self._payloads.items():
            if len(self._ready.get(root, set())) >= 2 * self.f + 1:
                self._delivered = True
                self.emit_result(payload)
                return
