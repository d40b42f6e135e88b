"""BV-broadcast + AUX + CONF ("BinaryBroadcast").

The port's copy of `lachain_tpu/consensus/binary_broadcast.py`, with the
behavior of the C# reference's BinaryBroadcast.cs:
  * BVAL relay at F+1 distinct senders, accept into bin_values at 2F+1
  * AUX broadcast when bin_values first becomes non-empty
  * CONF of the current bin_values after N-F AUX arrive
  * result = bin_values once N-F CONF subsets observed
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Set

from . import messages as M
from .protocol import Broadcaster, Protocol


class BinaryBroadcast(Protocol):
    def __init__(self, pid: M.BinaryBroadcastId, broadcaster: Broadcaster):
        super().__init__(pid, broadcaster)
        self._bval_recv: Dict[bool, Set[int]] = {False: set(), True: set()}
        self._bval_sent: Set[bool] = set()
        self._bin_values: Set[bool] = set()
        self._aux_recv: Dict[int, bool] = {}
        self._conf_recv: Dict[int, FrozenSet[bool]] = {}
        self._aux_broadcast = False
        self._conf_broadcast = False
        self._done = False

    # -- input: my estimate --------------------------------------------------
    def handle_input(self, value: bool) -> None:
        value = bool(value)
        if value not in self._bval_sent:
            self._bval_sent.add(value)
            self.broadcaster.broadcast(M.BValMessage(bb=self.id, value=value))

    # -- externals -----------------------------------------------------------
    def handle_external(self, sender: int, payload) -> None:
        if isinstance(payload, M.BValMessage):
            self._on_bval(sender, bool(payload.value))
        elif isinstance(payload, M.AuxMessage):
            self._on_aux(sender, bool(payload.value))
        elif isinstance(payload, M.ConfMessage):
            self._on_conf(sender, frozenset(payload.values))
        else:
            raise TypeError(f"unexpected payload {type(payload)}")

    def _on_bval(self, sender: int, v: bool) -> None:
        self._bval_recv[v].add(sender)
        cnt = len(self._bval_recv[v])
        if cnt >= self.f + 1 and v not in self._bval_sent:
            # relay: enough honest support to echo the value
            self._bval_sent.add(v)
            self.broadcaster.broadcast(M.BValMessage(bb=self.id, value=v))
        if cnt >= 2 * self.f + 1 and v not in self._bin_values:
            self._bin_values.add(v)
            if not self._aux_broadcast:
                self._aux_broadcast = True
                self.broadcaster.broadcast(M.AuxMessage(bb=self.id, value=v))
            self._progress()

    def _on_aux(self, sender: int, v: bool) -> None:
        if sender not in self._aux_recv:
            self._aux_recv[sender] = v
            self._progress()

    def _on_conf(self, sender: int, values: FrozenSet[bool]) -> None:
        if sender not in self._conf_recv:
            self._conf_recv[sender] = values
            self._progress()

    # -- state machine -------------------------------------------------------
    def _progress(self) -> None:
        if self._done:
            return
        if not self._bin_values:
            return
        if not self._conf_broadcast:
            aux_ok = sum(
                1 for v in self._aux_recv.values() if v in self._bin_values
            )
            if aux_ok >= self.n - self.f:
                self._conf_broadcast = True
                self.broadcaster.broadcast(
                    M.ConfMessage(bb=self.id, values=frozenset(self._bin_values))
                )
        if self._conf_broadcast:
            conf_ok = sum(
                1
                for vals in self._conf_recv.values()
                if vals <= self._bin_values
            )
            if conf_ok >= self.n - self.f:
                self._done = True
                self.emit_result(frozenset(self._bin_values))
