"""Transaction execution over state snapshots.

The port's copy of `lachain_tpu/core/execution.py`, bytes for bytes in
every row it writes: per-transaction signature, nonce and balance checks,
native transfers, system-contract dispatch, WASM contract calls through
`vm/vm.py`, and the receipt (`types.TransactionReceipt`) into the
`transactions` subtree under the transaction's hash; a contract's events
go into `events` under tx hash + u32(i).

A failed transaction discards its buffered writes back to its checkpoint,
then keeps the consumed nonce and the fee (for a WASM call, the gas it
spent, clamped to the transaction's gas limit). Runs on the host: the
senders it reads are recovered before, by `types.warm_sender_caches`.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..storage.state import Snapshot
from ..utils.serialization import write_u32, write_u64, write_u256
from .types import (
    SignedTransaction,
    TransactionReceipt,
    ZERO_ADDRESS,
)

GAS_PER_TX = 21000  # base transfer cost (reference GasMetering.cs)

_BALANCE = b"b:"
_NONCE = b"n:"


def get_balance(snap: Snapshot, addr: bytes) -> int:
    raw = snap.get("balances", _BALANCE + addr)
    return int.from_bytes(raw, "big") if raw else 0


def set_balance(snap: Snapshot, addr: bytes, value: int) -> None:
    snap.put("balances", _BALANCE + addr, write_u256(value))


def get_nonce(snap: Snapshot, addr: bytes) -> int:
    raw = snap.get("balances", _NONCE + addr)
    return int.from_bytes(raw, "big") if raw else 0


def set_nonce(snap: Snapshot, addr: bytes, value: int) -> None:
    snap.put("balances", _NONCE + addr, write_u64(value))


@dataclass
class ExecutionResult:
    receipt: TransactionReceipt
    ok: bool


class TransactionExecuter:
    """Executes one signed transaction against a snapshot."""

    def __init__(self, chain_id: int, system_contracts=None):
        self.chain_id = chain_id
        # address -> callable(snap, sender, tx, block_index) -> (status, ret)
        self.system_contracts = system_contracts or {}

    def execute(
        self,
        snap: Snapshot,
        stx: SignedTransaction,
        block_index: int,
        index_in_block: int,
    ) -> ExecutionResult:
        tx_hash = stx.hash()

        def receipt(
            status: int, sender: bytes, ret: bytes = b"", gas: int = GAS_PER_TX
        ) -> ExecutionResult:
            r = TransactionReceipt(
                tx_hash=tx_hash,
                block_index=block_index,
                index_in_block=index_in_block,
                gas_used=gas,
                status=status,
                sender=sender,
                return_data=ret,
            )
            snap.put("transactions", tx_hash, r.encode())
            return ExecutionResult(receipt=r, ok=status == 1)

        sender = stx.sender(self.chain_id)
        if sender is None:
            return receipt(0, ZERO_ADDRESS)
        tx = stx.tx
        if get_nonce(snap, sender) != tx.nonce:
            return receipt(0, sender)
        fee = GAS_PER_TX * tx.gas_price
        bal = get_balance(snap, sender)
        if bal < tx.value + fee:
            return receipt(0, sender)
        # effects; a failed call rolls back everything except the consumed
        # nonce and fee (reference per-tx snapshot/rollback loop,
        # BlockManager.cs:371-560)
        cp = snap.checkpoint()
        set_nonce(snap, sender, tx.nonce + 1)
        set_balance(snap, sender, bal - tx.value - fee)
        if tx.to in self.system_contracts:
            handler = self.system_contracts[tx.to]
            try:
                status, ret = handler(
                    snap, sender, tx, block_index, tx_hash=tx_hash
                )
            except Exception:
                status, ret = 0, b""
            if status != 1:
                snap.restore(cp)
                set_nonce(snap, sender, tx.nonce + 1)
                set_balance(snap, sender, bal - fee)
                return receipt(0, sender, ret)
            set_balance(snap, tx.to, get_balance(snap, tx.to) + tx.value)
            return receipt(status, sender, ret)
        # deployed WASM contract call (reference TransactionExecuter.cs ->
        # ContractInvoker.Invoke -> VirtualMachine.InvokeWasmContract)
        from ..vm import vm as wasm_vm

        if tx.invocation and wasm_vm.get_code(snap, tx.to) is not None:
            # the full gas limit must be payable up front: metered work is
            # charged even when the call reverts (reference gas accounting —
            # BlockManager._Execute collects gas on failed receipts too)
            if bal < tx.value + tx.gas_limit * tx.gas_price:
                snap.restore(cp)
                set_nonce(snap, sender, tx.nonce + 1)
                set_balance(snap, sender, bal - fee)
                return receipt(0, sender)
            set_balance(snap, tx.to, get_balance(snap, tx.to) + tx.value)
            machine = wasm_vm.VirtualMachine(
                snap,
                block_index=block_index,
                origin=sender,
                gas_price=tx.gas_price,
                chain_id=self.chain_id,
            )
            res = machine.invoke_contract(
                contract=tx.to,
                sender=sender,
                value=tx.value,
                input=tx.invocation,
                gas_limit=max(0, tx.gas_limit - GAS_PER_TX),
            )
            # never bill beyond the up-front-verified gas limit: the meter
            # clamps spent to its limit, and this min() guards against any
            # residual overshoot so the sender balance cannot go negative
            gas_total = min(GAS_PER_TX + res.gas_used, tx.gas_limit)
            if res.status != 1:
                snap.restore(cp)
                set_nonce(snap, sender, tx.nonce + 1)
                set_balance(snap, sender, bal - gas_total * tx.gas_price)
                return receipt(0, sender, res.return_data, gas=gas_total)
            set_balance(
                snap,
                sender,
                get_balance(snap, sender) - res.gas_used * tx.gas_price,
            )
            for i, (contract, data) in enumerate(res.events):
                snap.put("events", tx_hash + write_u32(i), contract + data)
            return receipt(1, sender, res.return_data, gas=gas_total)
        set_balance(snap, tx.to, get_balance(snap, tx.to) + tx.value)
        return receipt(1, sender)
