"""ValidatorStatusManager: the stake -> VRF -> submit loop.

The port of `lachain_tpu/core/validator_status.py` (the C# reference's
ValidatorStatusManager.cs:104, 219-266, 343-360, 432-440), whose
transactions it sends byte for byte: once the node's address holds stake,
in each cycle's VRF submission phase it evaluates the lottery
(`crypto/vrf.evaluate` over seed || cycle, the stake-weighted winner
check) and submits a SubmitVrf transaction; it offers the lottery's close
once the phase is over, drives the attendance-detection phase from the
node's recorded co-signatures, and the two-phase stake withdrawal. Driven
by block persistence, not by a polling thread. Host work only: the VRF
runs on the host, as in the reference.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from ..crypto import ecdsa, vrf
from ..storage.state import Snapshot
from ..utils.serialization import Reader, write_bytes, write_u32, write_u64, write_u256
from . import system_contracts as sc
from .types import Block

logger = logging.getLogger(__name__)


class ValidatorStatusManager:
    def __init__(
        self,
        ecdsa_priv: bytes,
        send_tx: Callable[[bytes, bytes], None],
        *,
        cycle_duration: Optional[int] = None,
        vrf_phase: Optional[int] = None,
        attendance_reader: Optional[Callable[[int], dict]] = None,
    ):
        self._priv = ecdsa_priv
        self.public_key = ecdsa.public_key_bytes(ecdsa_priv)
        self.address = ecdsa.address_from_public_key(self.public_key)
        self._send_tx = send_tx
        self._cycle_duration = cycle_duration or sc.CYCLE_DURATION
        self._vrf_phase = vrf_phase or sc.VRF_SUBMISSION_PHASE
        # attendance_reader(cycle) -> {validator public key: blocks co-signed}
        # (the node's durable ValidatorAttendance counts)
        self._attendance_reader = attendance_reader
        self._submitted_cycles: set = set()
        self.withdraw_requested = False

    def _storage(self, snap: Snapshot, key: bytes) -> Optional[bytes]:
        return snap.get("storage", sc.STAKING_ADDRESS + key)

    def stake_of(self, snap: Snapshot) -> int:
        raw = self._storage(snap, b"stake:" + self.address)
        return int.from_bytes(raw, "big") if raw else 0

    # -- block hook -----------------------------------------------------------

    def on_block_persisted(self, block: Block, snap: Snapshot) -> None:
        height = block.header.index
        cycle = height // self._cycle_duration
        self._attendance_detection(height, cycle, snap)
        if height % self._cycle_duration >= self._vrf_phase:
            # the submission phase is over: every validator offers the
            # lottery's close until it lands and the contract dedupes (the
            # reference injects it as a system transaction at the phase
            # boundary, BlockProducer.cs:126-146)
            self._maybe_finish_lottery(cycle, snap)
            return
        if cycle in self._submitted_cycles:
            return
        stake = self.stake_of(snap)
        if stake == 0:
            return
        total_raw = self._storage(snap, b"total")
        total = int.from_bytes(total_raw, "big") if total_raw else 0
        if total == 0:
            return
        seed = self._storage(snap, b"seed") or b"genesis-seed"
        proof, beta = vrf.evaluate(self._priv, seed + write_u64(cycle))
        expected = int.from_bytes(
            self._storage(snap, b"validators_count") or write_u32(7), "big"
        )
        self._submitted_cycles.add(cycle)
        if not vrf.is_winner(beta, stake, total, expected):
            logger.debug("cycle %d: not a lottery winner", cycle)
            return
        logger.info("cycle %d: winning VRF roll, submitting", cycle)
        self._send_tx(
            sc.STAKING_ADDRESS,
            sc.SEL_SUBMIT_VRF + write_bytes(self.public_key) + write_bytes(proof),
        )

    def _attendance_detection(self, height: int, cycle: int, snap: Snapshot) -> None:
        """The attendance-detection phase (reference
        StakingContract.SubmitAttendanceDetection, cs:538-634): inside the
        detection window of a cycle >= 1, submit the previous cycle's
        recorded co-signing counts for every member of the electorate,
        again each block until the on-chain check-in of this key appears;
        after the window, offer the close until its done flag appears (the
        contract dedupes)."""
        if cycle == 0 or self._attendance_reader is None:
            return
        cyc = write_u64(cycle)
        if height % self._cycle_duration < sc.ATTENDANCE_DETECTION_DURATION:
            raw = self._storage(snap, b"att_checkin:" + cyc)
            if raw is not None and self.public_key in Reader(raw).bytes_list():
                return  # checked in on-chain
            prev_raw = self._storage(snap, b"prev_pubs")
            prev_pubs = Reader(prev_raw).bytes_list() if prev_raw else []
            if self.public_key not in prev_pubs:
                return  # not in the electorate
            counts = self._attendance_reader(cycle - 1)
            entries = [
                write_bytes(pub + min(counts.get(pub, 0), self._cycle_duration).to_bytes(4, "big"))
                for pub in prev_pubs
            ]
            logger.info("cycle %d: submitting attendance detection", cycle)
            self._send_tx(
                sc.STAKING_ADDRESS,
                sc.SEL_SUBMIT_ATTENDANCE + write_u32(len(entries)) + b"".join(entries),
            )
        else:
            if self._storage(snap, b"att_done:" + cyc) is not None:
                return
            if self._storage(snap, b"prev_pubs") is None:
                return
            logger.info("cycle %d: closing attendance detection", cycle)
            self._send_tx(sc.STAKING_ADDRESS, sc.SEL_FINISH_ATTENDANCE)

    def _maybe_finish_lottery(self, cycle: int, snap: Snapshot) -> None:
        # offered every block until the on-chain lottery_done flag appears:
        # a lost or mistimed close must not skip the cycle's rotation (the
        # chain state, not a local latch, is the dedupe)
        winners = self._storage(snap, b"winners:" + write_u64(cycle))
        done = self._storage(snap, b"lottery_done:" + write_u64(cycle))
        if winners is None or done is not None:
            return
        logger.info("cycle %d: closing the VRF lottery", cycle)
        self._send_tx(sc.STAKING_ADDRESS, sc.SEL_FINISH_LOTTERY)

    # -- stake lifecycle -------------------------------------------------------

    def become_staker(self, amount: int) -> None:
        self._send_tx(
            sc.STAKING_ADDRESS,
            sc.SEL_BECOME_STAKER + write_bytes(self.public_key) + write_u256(amount),
        )

    def request_withdrawal(self) -> None:
        self.withdraw_requested = True
        self._send_tx(sc.STAKING_ADDRESS, sc.SEL_REQUEST_WITHDRAW)

    def withdraw(self) -> None:
        self._send_tx(sc.STAKING_ADDRESS, sc.SEL_WITHDRAW)
