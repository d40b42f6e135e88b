"""VirtualMachine facade: contract invocation with a frame stack.

The port's copy of `lachain_tpu/vm/vm.py`: the contract entry point is the
exported `start` function; call data and results flow through the `env`
host-import table (external.py). The decoded-module cache `_MODULE_CACHE`
(by code hash) is process-wide, like the JAX package's; each decoded
function carries its translated tier (`interpreter.Instance._compiled_for`),
so tests that compare tiers or packages clear it between cases.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..crypto.hashes import keccak256_host
from ..storage.state import Snapshot
from . import gas as G
from .external import build_env
from .interpreter import (
    INSTRUCTION_GAS,
    INTERP_INSTRUCTION_GAS,
    GasMeter,
    Instance,
    OutOfGas,
)
from .wasm import WasmDecodeError, decode_module

MAX_FRAME_DEPTH = 16

CODE_PREFIX = b"c:"  # 'contracts' subtree: code by address

# decoded-module cache: Module objects are immutable after decode, so
# repeated/nested invocations skip the binary re-parse (keyed by code hash).
# Lock-guarded: parallel execution lanes (core/parallel_exec.py) decode
# concurrently, and an unguarded move_to_end can race a sibling's eviction
_MODULE_CACHE: "OrderedDict[bytes, object]" = None  # type: ignore[assignment]
_MODULE_CACHE_MAX = 64
_MODULE_CACHE_LOCK = threading.Lock()


def _decode_cached(code: bytes):
    global _MODULE_CACHE
    key = keccak256_host(code)
    with _MODULE_CACHE_LOCK:
        if _MODULE_CACHE is None:
            from collections import OrderedDict

            _MODULE_CACHE = OrderedDict()
        mod = _MODULE_CACHE.get(key)
        if mod is not None:
            _MODULE_CACHE.move_to_end(key)
            return mod
    # decode outside the lock (the expensive part); a racing duplicate
    # decode yields an equivalent immutable Module — last store wins
    mod = decode_module(code)
    with _MODULE_CACHE_LOCK:
        _MODULE_CACHE[key] = mod
        if len(_MODULE_CACHE) > _MODULE_CACHE_MAX:
            _MODULE_CACHE.popitem(last=False)
    return mod


class HaltException(Exception):
    def __init__(self, code: int):
        super().__init__(f"halt({code})")
        self.code = code


@dataclass
class InvocationResult:
    status: int  # 1 ok, 0 failed
    gas_used: int
    return_data: bytes = b""
    events: List[Tuple[bytes, bytes]] = field(default_factory=list)


def get_code(snap: Snapshot, address: bytes) -> Optional[bytes]:
    return snap.get("contracts", CODE_PREFIX + address)


def set_code(snap: Snapshot, address: bytes, code: bytes) -> None:
    snap.put("contracts", CODE_PREFIX + address, code)


def contract_address(sender: bytes, nonce: int) -> bytes:
    """Deterministic deploy address (reference DeployContract.cs builds it
    from sender+nonce)."""
    return keccak256_host(sender + nonce.to_bytes(8, "big"))[12:]


def create2_address(sender: bytes, salt: bytes, code: bytes) -> bytes:
    return keccak256_host(b"\xff" + sender + salt + keccak256_host(code))[12:]


class ExecutionFrame:
    """One contract activation (reference ExecutionFrame/WasmExecutionFrame.cs)."""

    def __init__(
        self,
        *,
        contract: bytes,
        storage_owner: bytes,
        sender: bytes,
        value: int,
        input: bytes,
        static: bool,
    ):
        self.contract = contract
        self.storage_owner = storage_owner  # differs under delegatecall
        self.sender = sender
        self.value = value
        self.input = input
        self.static = static
        self.return_data = b""
        self.child_return = b""
        self.halted = False
        self.instance: Optional[Instance] = None


class VirtualMachine:
    """Per-invocation VM context: snapshot, tx metadata, frame stack, meter."""

    def __init__(
        self,
        snap: Snapshot,
        *,
        block_index: int,
        origin: bytes,
        gas_price: int,
        chain_id: int,
        block_gas_limit: int = G.DEFAULT_BLOCK_GAS_LIMIT,
    ):
        self.snap = snap
        self.block_index = block_index
        self.origin = origin
        self.gas_price = gas_price
        self.chain_id = chain_id
        self.block_gas_limit = block_gas_limit
        self.frames: List[ExecutionFrame] = []
        self.events: List[Tuple[bytes, bytes]] = []
        self.gas: Optional[GasMeter] = None

    @property
    def frame(self) -> ExecutionFrame:
        return self.frames[-1]

    def invoke_contract(
        self,
        *,
        contract: bytes,
        sender: bytes,
        value: int,
        input: bytes,
        gas_limit: int,
        static: bool = False,
        code: Optional[bytes] = None,
        storage_owner: Optional[bytes] = None,
        value_from: Optional[bytes] = None,
    ) -> InvocationResult:
        """Run the `start` export of the contract at `contract`.

        `value_from`: debit/credit the call value inside this frame's
        checkpoint, so a failed call reverts the transfer too (the
        reference's per-frame snapshot/rollback gives the same guarantee).
        """
        if len(self.frames) >= MAX_FRAME_DEPTH:
            return InvocationResult(status=0, gas_used=0, return_data=b"")
        code = code if code is not None else get_code(self.snap, contract)
        if code is None:
            return InvocationResult(status=0, gas_used=0)
        top_level = not self.frames
        if top_level:
            self.gas = GasMeter(min(gas_limit, self.block_gas_limit))
            self.events = []
        meter = self.gas
        assert meter is not None
        # a nested call's gas limit bounds the CHILD's spend only: the
        # parent's limit is restored afterwards, so a child OutOfGas does
        # not poison the parent's meter
        outer_limit = meter.limit
        if not top_level and gas_limit:
            meter.limit = min(outer_limit, meter.spent + gas_limit)
        frame = ExecutionFrame(
            contract=contract,
            storage_owner=storage_owner or contract,
            sender=sender,
            value=value,
            input=input,
            static=static or (self.frames[-1].static if self.frames else False),
        )
        self.frames.append(frame)
        cp = self.snap.checkpoint()
        n_events = len(self.events)
        start_gas = meter.spent
        try:
            status = 1
            if value and value_from is not None:
                from ..core import execution

                bal = execution.get_balance(self.snap, value_from)
                if bal < value:
                    status = 0
                else:
                    execution.set_balance(self.snap, value_from, bal - value)
                    execution.set_balance(
                        self.snap,
                        contract,
                        execution.get_balance(self.snap, contract) + value,
                    )
            if status == 1:
                meter.charge(len(input) * G.INPUT_DATA_GAS_PER_BYTE)
                module = _decode_cached(code)
                frame.instance = Instance(
                    module, host=build_env(self, frame), gas=meter
                )
                from ..core import hardforks

                if not hardforks.is_active(
                    "fast_wasm_gas", self.block_index
                ):
                    # pre-fork schedule: translatable code bills the
                    # round-2 interpreter rate (2000/op) too
                    frame.instance.tgas_scale = (
                        INTERP_INSTRUCTION_GAS // INSTRUCTION_GAS
                    )
                frame.instance.invoke("start", [])
        except HaltException as e:
            status = 1 if e.code == 0 else 0
        except OutOfGas:
            status = 0
        except Exception:
            # any interpreter/host fault (including malformed-but-decodable
            # bytecode hitting IndexError/TypeError/struct.error) is a
            # deterministic trap, never a node crash
            status = 0
        finally:
            self.frames.pop()
            meter.limit = outer_limit
        gas_used = meter.spent - start_gas
        if status != 1:
            self.snap.restore(cp)
            del self.events[n_events:]
            return InvocationResult(status=0, gas_used=gas_used)
        result = InvocationResult(
            status=1, gas_used=gas_used, return_data=frame.return_data
        )
        if top_level:
            result.events = list(self.events)
        return result


def deploy_code(
    snap: Snapshot, sender: bytes, nonce: int, code: bytes
) -> Tuple[int, bytes]:
    """Validate + store contract code; returns (status, address).

    Parity: DeployContract.cs:1-213 — the code must be a decodable WASM
    module exporting `start`."""
    try:
        module = decode_module(code)
    except WasmDecodeError:
        return 0, b""
    exp = module.export_map().get("start")
    if exp is None or exp.kind != 0:
        return 0, b""
    addr = contract_address(sender, nonce)
    if get_code(snap, addr) is not None:
        return 0, b""
    set_code(snap, addr, code)
    return 1, addr
