"""Asynchronous Common Subset (ACS): N reliable broadcasts + N binary
agreements.

The port's copy of `lachain_tpu/consensus/common_subset.py`, with the
behavior of the C# reference's CommonSubset.cs:
  * input fans out to my RBC slot; BAs vote on which RBCs completed
  * once N-F BAs output 1, input 0 to all remaining BAs
  * complete when ALL N BAs have output and every accepted slot's RBC value
    arrived; result = {slot: payload for slots with BA == 1}
"""
from __future__ import annotations

from typing import Dict

from . import messages as M
from .protocol import Broadcaster, Protocol


class CommonSubset(Protocol):
    def __init__(self, pid: M.CommonSubsetId, broadcaster: Broadcaster):
        super().__init__(pid, broadcaster)
        self._rbc_results: Dict[int, bytes] = {}
        self._ba_results: Dict[int, bool] = {}
        self._ba_inputs: set = set()
        self._filled_zeros = False
        self._done = False

    def handle_input(self, value: bytes) -> None:
        # my own slot's RBC gets the payload; the others are participant-only
        for j in range(self.n):
            rbc = M.ReliableBroadcastId(era=self.id.era, sender_id=j)
            self.request(rbc, value if j == self.me else None)

    def handle_external(self, sender: int, payload) -> None:
        raise TypeError(f"unexpected payload {type(payload)}")

    def handle_child_result(self, child_id, value) -> None:
        if isinstance(child_id, M.ReliableBroadcastId):
            j = child_id.sender_id
            if j in self._rbc_results:
                return
            self._rbc_results[j] = value
            # RBC j delivered -> vote yes on slot j (unless already voted)
            self._vote(j, True)
        elif isinstance(child_id, M.BinaryAgreementId):
            j = child_id.agreement
            if j in self._ba_results:
                return
            self._ba_results[j] = bool(value)
            ones = sum(1 for v in self._ba_results.values() if v)
            if ones >= self.n - self.f and not self._filled_zeros:
                # enough slots accepted: refuse the stragglers
                self._filled_zeros = True
                for k in range(self.n):
                    if k not in self._ba_results:
                        self._vote(k, False)
        self._try_complete()

    def _vote(self, j: int, value: bool) -> None:
        if j in self._ba_inputs:
            return
        self._ba_inputs.add(j)
        ba = M.BinaryAgreementId(era=self.id.era, agreement=j)
        self.request(ba, value)

    def _try_complete(self) -> None:
        if self._done or len(self._ba_results) < self.n:
            return
        accepted = [j for j, v in self._ba_results.items() if v]
        if any(j not in self._rbc_results for j in accepted):
            return  # BA said yes but the RBC value hasn't arrived yet
        self._done = True
        self.emit_result({j: self._rbc_results[j] for j in sorted(accepted)})
