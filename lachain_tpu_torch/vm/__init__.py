"""Gas-metered WASM contract VM.

The port of `lachain_tpu/vm/`: the decoder (`wasm.py`), the interpreter
and its gas meter (`interpreter.py`), the WASM -> Python translator
(`translate.py`), the module assembler (`builder.py`), the ABI
(`abi.py`), the `env` host imports (`external.py`) and the
`VirtualMachine` with its frame stack (`vm.py`), bytes for bytes and gas
for gas. The engine is an MVP-spec interpreter of the package's own, so
the port carries no external WASM dependency. All of it runs on the host:
no part of contract execution goes to the card. Imports no torch.
"""
from .wasm import Module, WasmDecodeError, decode_module
from .interpreter import Instance, WasmTrap, OutOfGas, GasMeter
from .vm import VirtualMachine, HaltException, InvocationResult

__all__ = [
    "Module",
    "WasmDecodeError",
    "decode_module",
    "Instance",
    "WasmTrap",
    "OutOfGas",
    "GasMeter",
    "VirtualMachine",
    "HaltException",
    "InvocationResult",
]
