"""KeyGenManager: drives the on-chain DKG from the system contracts' events.

The port of `lachain_tpu/core/keygen_manager.py` (the C# reference's
KeyGenManager.cs:77-260), its transactions, events and persisted
`KEYGEN_STATE` row byte for byte the JAX package's. It watches executed
blocks for staking and governance events and answers with the next keygen
transaction:

  lottery_done       -> if elected, a new TrustlessKeygen and its COMMIT
  keygen_commit      -> handle_commit -> SEND_VALUE
  keygen_value       -> handle_send_value; once finished, CONFIRM with the
                        derived public key set
  validators_changed -> hand the keyring's shares to `on_keys` for the
                        next cycle's eras (the node's era-keyed wallet)

and offers FinishCycle after block D-2 of a cycle with a pending set. The
full DKG state is persisted after every step, so that a validator that
restarts mid-keygen rejoins the cycle (the reference's KeyGenRepository,
TrustlessKeygen.cs:195-261). `send_tx(to, invocation)` is the node's: it
builds, signs, pools and gossips the transaction.

Device work: the keygen's commitment checks are G1 MSMs on `backend`, a
`GpuBackend` on `device` ("cuda" by default; no card raises) unless the
caller hands one in (`consensus/keygen.py`). Differences, by the port's
rules: the `rng` (the polynomial, then ECIES; `secrets` in production) is
an explicit argument and a restored keygen draws from it too, where the
reference draws from `secrets`.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..consensus.keygen import CommitMessage, ThresholdKeyring, TrustlessKeygen, ValueMessage
from ..crypto import ecdsa
from ..storage.kv import EntryPrefix, prefixed
from ..storage.state import Snapshot
from ..utils.serialization import Reader, write_bytes, write_bytes_list, write_u32, write_u64, \
    write_u256
from . import system_contracts as sc
from .types import Block

logger = logging.getLogger(__name__)

_NO_CYCLE = (1 << 64) - 1


class KeyGenManager:
    def __init__(
        self,
        ecdsa_priv: bytes,
        send_tx: Callable[[bytes, bytes], None],
        *,
        rng,
        device="cuda",
        backend=None,
        cycle_duration: Optional[int] = None,
        on_keys: Optional[Callable[[int, ThresholdKeyring, List[bytes]], None]] = None,
        kv=None,
    ):
        if backend is None:
            from ..crypto.gpu_backend import GpuBackend

            backend = GpuBackend(device=device)
        self.backend = backend
        self._priv = ecdsa_priv
        self.public_key = ecdsa.public_key_bytes(ecdsa_priv)
        self.address = ecdsa.address_from_public_key(self.public_key)
        self._send_tx = send_tx
        self._cycle_duration = cycle_duration or sc.CYCLE_DURATION
        self._on_keys = on_keys  # (first_era, keyring, participant public keys)
        self._rng = rng
        self.keygen: Optional[TrustlessKeygen] = None
        self._participants: List[bytes] = []
        self._addr_to_idx: Dict[bytes, int] = {}
        self._keyring: Optional[ThresholdKeyring] = None
        self._cycle: Optional[int] = None
        self._installed_cycles: set = set()
        self._kv = kv
        if kv is not None:
            self._load_state()

    _STATE_KEY = prefixed(EntryPrefix.KEYGEN_STATE)

    def state_bytes(self) -> bytes:
        """The persisted row: cycle, participants, the keygen's snapshot,
        the installed cycles."""
        return b"".join([
            write_u64(self._cycle if self._cycle is not None else _NO_CYCLE),
            write_bytes_list(list(self._participants)),
            write_bytes(self.keygen.to_bytes() if self.keygen else b""),
            write_u32(len(self._installed_cycles)),
            *(write_u64(c) for c in sorted(self._installed_cycles)),
        ])

    def _persist_state(self) -> None:
        if self._kv is not None:
            self._kv.put(self._STATE_KEY, self.state_bytes())

    def _load_state(self) -> None:
        raw = self._kv.get(self._STATE_KEY)
        if raw is None:
            return
        try:
            r = Reader(raw)
            cycle = r.u64()
            self._cycle = None if cycle == _NO_CYCLE else cycle
            self._participants = r.bytes_list()
            blob = r.bytes_()
            self._installed_cycles = {r.u64() for _ in range(r.u32())}
            r.assert_eof()
            self._addr_to_idx = {
                ecdsa.address_from_public_key(pk): i for i, pk in enumerate(self._participants)
            }
            if blob:
                self.keygen = TrustlessKeygen.from_bytes(blob, self._priv, self._rng,
                                                         self.backend)
                self._keyring = self.keygen.try_get_keys()
            logger.info("keygen state restored (cycle %s, in progress: %s)",
                        self._cycle, self.keygen is not None)
        except Exception:
            logger.exception("corrupt keygen state ignored")
            # reset every restored field: a partly restored cycle,
            # participant list or installed cycle could silently skip the
            # next key installation
            self.keygen = None
            self._keyring = None
            self._cycle = None
            self._participants = []
            self._addr_to_idx = {}
            self._installed_cycles = set()

    # -- block hook -------------------------------------------------------------

    def on_block_persisted(self, block: Block, snap: Snapshot) -> None:
        """React to the block's executed events (reference
        BlockManagerOnSystemContractInvoked, KeyGenManager.cs:77-107)."""
        for tx_hash in block.tx_hashes:
            i = 0
            while True:
                raw = snap.get("events", tx_hash + write_u32(i))
                if raw is None:
                    break
                i += 1
                try:
                    self._handle_event(raw[:20], raw[20:], block, snap)
                except Exception:
                    logger.exception("keygen event handling failed")
        self._maybe_finish_cycle(block, snap)

    def _maybe_finish_cycle(self, block: Block, snap: Snapshot) -> None:
        """With a confirmed rotation pending, offer FinishCycle after block
        D-2 persists, so that it executes in block D-1, the one height the
        contract accepts (the reference injects it as a cycle-boundary
        system transaction, BlockProducer.cs:126-146). One block index a
        cycle meets the trigger, so the chain state is the dedupe; a
        restart or a missed boundary heals at the next cycle's window."""
        if (block.header.index + 2) % self._cycle_duration != 0:
            return
        if self._storage(snap, sc.GOVERNANCE_ADDRESS, b"pending_validators") is None:
            return
        self._send_tx(sc.GOVERNANCE_ADDRESS, sc.SEL_FINISH_CYCLE)

    def _handle_event(self, contract: bytes, payload: bytes, block: Block,
                      snap: Snapshot) -> None:
        if contract == sc.STAKING_ADDRESS and payload.startswith(b"lottery_done"):
            self._on_lottery_done(block, snap)
        elif contract == sc.GOVERNANCE_ADDRESS and payload.startswith(b"keygen_commit"):
            rest = payload[len(b"keygen_commit"):]
            self._on_commit(rest[:20], rest[20:])
        elif contract == sc.GOVERNANCE_ADDRESS and payload.startswith(b"keygen_value"):
            rest = payload[len(b"keygen_value"):]
            self._on_value(rest[:20], rest[20:])
        elif contract == sc.GOVERNANCE_ADDRESS and payload.startswith(b"validators_changed"):
            self._on_validators_changed()

    # -- steps --------------------------------------------------------------------

    @staticmethod
    def _storage(snap: Snapshot, contract: bytes, key: bytes):
        return snap.get("storage", contract + key)

    def _on_lottery_done(self, block: Block, snap: Snapshot) -> None:
        raw = self._storage(snap, sc.STAKING_ADDRESS, b"next_validators")
        if raw is None:
            return
        participants = Reader(raw).bytes_list()
        if self.public_key not in participants:
            self.keygen = None
            self._persist_state()
            return
        cycle = block.header.index // self._cycle_duration
        if self._cycle == cycle and self.keygen is not None:
            return  # already running
        self._cycle = cycle
        self._participants = participants
        self._addr_to_idx = {
            ecdsa.address_from_public_key(pk): i for i, pk in enumerate(participants)
        }
        f = (len(participants) - 1) // 3
        self.keygen = TrustlessKeygen(self._priv, participants, f, cycle, self._rng,
                                      self.backend)
        self._keyring = None
        commit = self.keygen.start_keygen()
        self._persist_state()
        logger.info("elected for cycle %d: sending keygen commit", cycle)
        self._send_tx(sc.GOVERNANCE_ADDRESS,
                      sc.SEL_KEYGEN_COMMIT + write_bytes(commit.to_bytes()))

    def _on_commit(self, sender_addr: bytes, blob: bytes) -> None:
        if self.keygen is None:
            return
        dealer = self._addr_to_idx.get(sender_addr)
        if dealer is None:
            return
        try:
            vmsg = self.keygen.handle_commit(dealer, CommitMessage.from_bytes(blob, self.backend))
        except ValueError:
            logger.warning("faulty commit from dealer %d ignored", dealer)
            return
        self._persist_state()
        self._send_tx(sc.GOVERNANCE_ADDRESS, sc.SEL_KEYGEN_SEND_VALUE + write_u256(dealer)
                      + write_bytes(vmsg.to_bytes()))

    def _on_value(self, sender_addr: bytes, blob: bytes) -> None:
        if self.keygen is None:
            return
        sender = self._addr_to_idx.get(sender_addr)
        if sender is None:
            return
        try:
            should_confirm = self.keygen.handle_send_value(sender, ValueMessage.from_bytes(blob))
        except ValueError:
            logger.warning("faulty value from sender %d ignored", sender)
            return
        self._persist_state()
        if not should_confirm:
            return
        keyring = self.keygen.try_get_keys()
        if keyring is None:
            return
        self._keyring = keyring
        pub = keyring.public_keys(self.keygen.f, self._participants)
        self._send_tx(sc.GOVERNANCE_ADDRESS, sc.SEL_KEYGEN_CONFIRM + write_bytes(pub.encode()))

    def _on_validators_changed(self) -> None:
        if self._keyring is None or self._cycle is None:
            return
        if self._cycle in self._installed_cycles:
            return
        self._installed_cycles.add(self._cycle)
        self._persist_state()
        first_era = (self._cycle + 1) * self._cycle_duration
        logger.info("keygen finished: keys installed from era %d", first_era)
        if self._on_keys is not None:
            self._on_keys(first_era, self._keyring, list(self._participants))
