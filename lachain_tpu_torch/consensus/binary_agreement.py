"""Binary agreement (Mostéfaoui et al.) with the reference's coin schedule.

The port's copy of `lachain_tpu/consensus/binary_agreement.py`, with the
behavior of the C# reference's BinaryAgreement.cs:
  * even epochs run BinaryBroadcast(est), odd epochs produce a coin
  * the coin cycles deterministic False / True / real threshold coin every
    three rounds (CoinToss.cs): the deterministic prefix bounds
    convergence within 3 rounds once all honest estimates agree
  * F == 0: a constant coin
  * decide when bin_values == {b} and b == coin; else est <- coin

After deciding, the instance keeps participating for EXTRA_ROUNDS more
rounds so that laggards can finish, then terminates quietly.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional

from . import messages as M
from .protocol import Broadcaster, Protocol

EXTRA_ROUNDS = 3  # deterministic coin cycle length


def coin_schedule(epoch: int):
    """For odd epoch, return False/True for deterministic rounds or None when
    a real threshold coin is required (reference CoinToss.cs:3-33)."""
    assert epoch % 2 == 1
    k = (epoch // 2) % 3
    if k == 0:
        return False
    if k == 1:
        return True
    return None


class BinaryAgreement(Protocol):
    def __init__(self, pid: M.BinaryAgreementId, broadcaster: Broadcaster):
        super().__init__(pid, broadcaster)
        self._epoch = 0
        self._est: Optional[bool] = None
        self._started = False
        self._bin_values: Dict[int, FrozenSet[bool]] = {}  # per even epoch
        self._coins: Dict[int, bool] = {}  # per odd epoch
        self._decided: Optional[bool] = None
        self._decide_epoch: Optional[int] = None
        self._requested_bb: set = set()
        self._requested_coin: set = set()

    # -- input ---------------------------------------------------------------
    def handle_input(self, value: bool) -> None:
        if self._started:
            return
        self._started = True
        self._est = bool(value)
        self._advance()

    # -- child results -------------------------------------------------------
    def handle_child_result(self, child_id, value) -> None:
        if isinstance(child_id, M.BinaryBroadcastId):
            if child_id.epoch not in self._bin_values:
                self._bin_values[child_id.epoch] = value
                self._advance()
        elif isinstance(child_id, M.CoinId):
            if child_id.epoch not in self._coins:
                self._coins[child_id.epoch] = bool(value)
                self._advance()

    def handle_external(self, sender: int, payload) -> None:
        # BA itself has no external messages; children receive theirs directly.
        raise TypeError(f"unexpected payload {type(payload)}")

    # -- round machine -------------------------------------------------------
    def _advance(self) -> None:
        while not self.terminated:
            if self._epoch % 2 == 0:
                bb_id = M.BinaryBroadcastId(
                    self.id.era, self.id.agreement, self._epoch
                )
                if self._epoch not in self._requested_bb:
                    self._requested_bb.add(self._epoch)
                    self.request(bb_id, self._est)
                if self._epoch not in self._bin_values:
                    return  # waiting on BB result
                self._epoch += 1
            else:
                sched = coin_schedule(self._epoch)
                if self.f == 0:
                    # single-validator regime: constant coin suffices
                    coin = True if sched is None else sched
                elif sched is not None:
                    coin = sched
                else:
                    coin_id = M.CoinId(
                        self.id.era, self.id.agreement, self._epoch
                    )
                    if self._epoch not in self._requested_coin:
                        self._requested_coin.add(self._epoch)
                        self.request(coin_id, None)
                    if self._epoch not in self._coins:
                        return  # waiting on coin
                    coin = self._coins[self._epoch]
                self._finish_round(coin)

    def _finish_round(self, coin: bool) -> None:
        w = self._bin_values[self._epoch - 1]
        if len(w) == 1:
            (b,) = w
            self._est = b
            if b == coin and self._decided is None:
                self._decided = b
                self._decide_epoch = self._epoch
                self.emit_result(b)
        else:
            self._est = coin
        self._epoch += 1
        if (
            self._decide_epoch is not None
            and self._epoch > self._decide_epoch + 2 * EXTRA_ROUNDS
        ):
            self.terminated = True
