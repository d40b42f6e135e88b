"""The `env` host-import table for contracts.

The port's copy of `lachain_tpu/vm/external.py`: call data, storage,
crypto, transfers, nested invocation, events, halt, over the port's
`crypto/ecdsa` (the native host library) and `hashes.keccak256_host`.
Names are the snake_case forms of the reference's Handler_Env_* entries;
gas costs follow `vm/gas.py`.

Conventions: addresses are 20 bytes, storage keys/values and u256 scalars
are 32-byte big-endian; block number / gas / sizes are i64/i32 return
values.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

from ..crypto import ecdsa
from ..crypto.hashes import keccak256_host
from . import gas as G
from .interpreter import WasmTrap

HostTable = Dict[Tuple[str, str], object]

ADDR = 20
WORD = 32


def build_env(vm, frame) -> HostTable:
    """Host functions close over the VM context and the current frame."""
    from ..core import execution  # late import: core.execution calls back in

    inst = lambda: frame.instance  # bound after Instance construction
    charge = lambda n: vm.gas.charge(n)

    def read(off: int, n: int) -> bytes:
        charge(n * G.COPY_FROM_MEMORY_GAS_PER_BYTE)
        return inst().mem_read(off, n)

    def write(off: int, data: bytes) -> None:
        charge(len(data) * G.COPY_TO_MEMORY_GAS_PER_BYTE)
        inst().mem_write(off, data)

    def require_mutable() -> None:
        if frame.static:
            raise WasmTrap("state mutation in static call")

    # ---- call data -------------------------------------------------------
    def get_call_size() -> int:
        charge(G.GET_CALL_SIZE_GAS)
        return len(frame.input)

    def copy_call_value(frm: int, to: int, offset: int) -> None:
        charge(G.GET_CALL_VALUE_GAS)
        if not (0 <= frm <= to <= len(frame.input)):
            raise WasmTrap("copy_call_value out of range")
        write(offset, frame.input[frm:to])

    def set_return(offset: int, length: int) -> None:
        frame.return_data = read(offset, length)

    def get_return_size() -> int:
        charge(G.GET_RETURN_SIZE_GAS)
        return len(frame.child_return)

    def copy_return_value(result_off: int, data_off: int, length: int) -> None:
        charge(G.GET_RETURN_VALUE_GAS)
        if data_off + length > len(frame.child_return):
            raise WasmTrap("copy_return_value out of range")
        write(result_off, frame.child_return[data_off : data_off + length])

    # ---- identity / environment -----------------------------------------
    def get_sender(off: int) -> None:
        write(off, frame.sender)

    def get_address(off: int) -> None:
        write(off, frame.contract)

    def get_msg_value(off: int) -> None:
        charge(G.GET_CALL_VALUE_GAS)
        write(off, frame.value.to_bytes(WORD, "big"))

    def get_tx_origin(off: int) -> None:
        write(off, vm.origin)

    def get_tx_gas_price(off: int) -> None:
        write(off, vm.gas_price.to_bytes(WORD, "big"))

    def get_block_number() -> int:
        charge(G.BLOCK_NUMBER_GAS)
        return vm.block_index

    def get_block_gas_limit() -> int:
        charge(G.BLOCK_NUMBER_GAS)
        return vm.block_gas_limit

    def get_chain_id() -> int:
        charge(G.BLOCK_NUMBER_GAS)
        return vm.chain_id

    def get_gas_left() -> int:
        return vm.gas.remaining

    def get_block_hash(height: int, off: int) -> None:
        charge(G.LOAD_STORAGE_GAS)
        raw = vm.snap.get("blocks", b"h:" + int(height).to_bytes(8, "big"))
        write(off, raw if raw and len(raw) == WORD else b"\x00" * WORD)

    def get_external_balance(addr_off: int, result_off: int) -> None:
        charge(G.LOAD_STORAGE_GAS)
        addr = read(addr_off, ADDR)
        bal = execution.get_balance(vm.snap, addr)
        write(result_off, bal.to_bytes(WORD, "big"))

    # ---- storage ---------------------------------------------------------
    def skey(key: bytes) -> bytes:
        return frame.storage_owner + key

    def load_storage(key_off: int, value_off: int) -> None:
        charge(G.LOAD_STORAGE_GAS)
        key = read(key_off, WORD)
        raw = vm.snap.get("storage", skey(key))
        write(value_off, raw if raw and len(raw) == WORD else b"\x00" * WORD)

    def save_storage(key_off: int, value_off: int) -> None:
        require_mutable()
        charge(G.SAVE_STORAGE_GAS)
        key = read(key_off, WORD)
        vm.snap.put("storage", skey(key), read(value_off, WORD))

    def kill_storage(key_off: int) -> None:
        require_mutable()
        charge(G.KILL_STORAGE_GAS)
        vm.snap.delete("storage", skey(read(key_off, WORD)))

    # ---- crypto ----------------------------------------------------------
    def crypto_keccak256(off: int, length: int, result_off: int) -> None:
        charge(length * G.KECCAK256_GAS_PER_BYTE)
        write(result_off, keccak256_host(read(off, length)))

    def crypto_sha256(off: int, length: int, result_off: int) -> None:
        charge(length * G.SHA256_GAS_PER_BYTE)
        write(result_off, hashlib.sha256(read(off, length)).digest())

    def crypto_ripemd160(off: int, length: int, result_off: int) -> None:
        charge(length * G.RIPEMD160_GAS_PER_BYTE)
        try:
            h = hashlib.new("ripemd160", read(off, length)).digest()
        except ValueError:  # OpenSSL without legacy provider
            raise WasmTrap("ripemd160 unavailable")
        write(result_off, h)

    def crypto_recover(hash_off: int, sig_off: int, result_off: int) -> int:
        charge(G.RECOVER_GAS)
        pub = ecdsa.recover_hash(read(hash_off, WORD), read(sig_off, 65))
        if pub is None:
            return 0
        write(result_off, ecdsa.address_from_public_key(pub))
        return 1

    def crypto_verify(
        hash_off: int, sig_off: int, pub_off: int
    ) -> int:
        charge(G.VERIFY_GAS)
        ok = ecdsa.verify_hash(
            read(pub_off, 33), read(hash_off, WORD), read(sig_off, 65)
        )
        return 1 if ok else 0

    # ---- value transfer / nested calls ----------------------------------
    def transfer(to_off: int, value_off: int) -> int:
        require_mutable()
        charge(G.TRANSFER_FUNDS_GAS)
        to = read(to_off, ADDR)
        value = int.from_bytes(read(value_off, WORD), "big")
        bal = execution.get_balance(vm.snap, frame.contract)
        if bal < value:
            return 0
        execution.set_balance(vm.snap, frame.contract, bal - value)
        execution.set_balance(
            vm.snap, to, execution.get_balance(vm.snap, to) + value
        )
        return 1

    def _invoke(addr_off, input_off, input_len, value_off, gas_limit, *, static, delegate) -> int:
        charge(G.INVOKE_CONTRACT_GAS)
        to = read(addr_off, ADDR)
        data = read(input_off, input_len)
        value = int.from_bytes(read(value_off, WORD), "big")
        if value and static:
            raise WasmTrap("value transfer in static call")
        if value:
            require_mutable()
        # the value moves inside the child frame's checkpoint (value_from),
        # so a failed call reverts the transfer with everything else
        res = vm.invoke_contract(
            contract=to,
            sender=frame.contract if not delegate else frame.sender,
            value=value,
            input=data,
            gas_limit=gas_limit if gas_limit else 0,
            static=static,
            storage_owner=frame.storage_owner if delegate else None,
            value_from=frame.contract if value else None,
        )
        frame.child_return = res.return_data
        return res.status

    def invoke_contract(addr_off, input_off, input_len, value_off, gas_limit) -> int:
        require_mutable()
        return _invoke(addr_off, input_off, input_len, value_off, gas_limit,
                       static=False, delegate=False)

    def invoke_static_contract(addr_off, input_off, input_len, value_off, gas_limit) -> int:
        return _invoke(addr_off, input_off, input_len, value_off, gas_limit,
                       static=True, delegate=False)

    def invoke_delegate_contract(addr_off, input_off, input_len, value_off, gas_limit) -> int:
        require_mutable()
        return _invoke(addr_off, input_off, input_len, value_off, gas_limit,
                       static=False, delegate=True)

    def create(value_off: int, code_off: int, code_len: int, result_off: int) -> int:
        require_mutable()
        from .vm import deploy_code  # local import: vm.py imports this module

        charge(G.DEPLOY_GAS + code_len * G.DEPLOY_GAS_PER_BYTE)
        code = read(code_off, code_len)
        # endowment must be payable BEFORE any state is written, so a
        # failed create leaves neither code nor a half-made transfer
        value = int.from_bytes(read(value_off, WORD), "big")
        bal = execution.get_balance(vm.snap, frame.contract)
        if bal < value:
            return 0
        nonce = execution.get_nonce(vm.snap, frame.contract)
        execution.set_nonce(vm.snap, frame.contract, nonce + 1)
        status, addr = deploy_code(vm.snap, frame.contract, nonce, code)
        if status != 1:
            return 0  # nonce is consumed, as in the account-create rules
        if value:
            execution.set_balance(vm.snap, frame.contract, bal - value)
            execution.set_balance(vm.snap, addr, value)
        write(result_off, addr)
        return 1

    def create2(value_off: int, code_off: int, code_len: int, salt_off: int, result_off: int) -> int:
        require_mutable()
        from .vm import create2_address, decode_module, get_code, set_code
        from .wasm import WasmDecodeError

        charge(G.DEPLOY_GAS + code_len * G.DEPLOY_GAS_PER_BYTE)
        code = read(code_off, code_len)
        salt = read(salt_off, WORD)
        value = int.from_bytes(read(value_off, WORD), "big")
        bal = execution.get_balance(vm.snap, frame.contract)
        if bal < value:
            return 0
        try:
            module = decode_module(code)
        except WasmDecodeError:
            return 0
        if module.export_map().get("start") is None:
            return 0
        addr = create2_address(frame.contract, salt, code)
        if get_code(vm.snap, addr) is not None:
            return 0
        set_code(vm.snap, addr, code)
        if value:
            execution.set_balance(vm.snap, frame.contract, bal - value)
            execution.set_balance(vm.snap, addr, value)
        write(result_off, addr)
        return 1

    # ---- code introspection ---------------------------------------------
    def get_code_size() -> int:
        from .vm import get_code

        charge(G.GET_CODE_SIZE_GAS)
        code = get_code(vm.snap, frame.contract)
        return len(code) if code else 0

    def copy_code_value(result_off: int, data_off: int, length: int) -> None:
        from .vm import get_code

        charge(G.COPY_CODE_VALUE_GAS)
        code = get_code(vm.snap, frame.contract) or b""
        if data_off + length > len(code):
            raise WasmTrap("copy_code_value out of range")
        write(result_off, code[data_off : data_off + length])

    # ---- events / halt ---------------------------------------------------
    def write_event(data_off: int, data_len: int) -> None:
        require_mutable()
        charge(data_len * G.WRITE_EVENT_PER_BYTE_GAS)
        vm.events.append((frame.contract, read(data_off, data_len)))

    def system_halt(code: int) -> None:
        from .vm import HaltException

        raise HaltException(code)

    env = {
        "get_call_size": get_call_size,
        "copy_call_value": copy_call_value,
        "set_return": set_return,
        "get_return_size": get_return_size,
        "copy_return_value": copy_return_value,
        "get_sender": get_sender,
        "get_address": get_address,
        "get_msgvalue": get_msg_value,
        "get_tx_origin": get_tx_origin,
        "get_tx_gas_price": get_tx_gas_price,
        "get_block_number": get_block_number,
        "get_block_gas_limit": get_block_gas_limit,
        "get_chain_id": get_chain_id,
        "get_gas_left": get_gas_left,
        "get_block_hash": get_block_hash,
        "get_external_balance": get_external_balance,
        "load_storage": load_storage,
        "save_storage": save_storage,
        "kill_storage": kill_storage,
        "crypto_keccak256": crypto_keccak256,
        "crypto_sha256": crypto_sha256,
        "crypto_ripemd160": crypto_ripemd160,
        "crypto_recover": crypto_recover,
        "crypto_verify": crypto_verify,
        "transfer": transfer,
        "invoke_contract": invoke_contract,
        "invoke_static_contract": invoke_static_contract,
        "invoke_delegate_contract": invoke_delegate_contract,
        "create": create,
        "create2": create2,
        "get_code_size": get_code_size,
        "copy_code_value": copy_code_value,
        "write_event": write_event,
        "system_halt": system_halt,
    }
    return {("env", name): fn for name, fn in env.items()}
