"""WASM MVP interpreter with per-instruction gas metering.

The port's copy of `lachain_tpu/vm/interpreter.py`: the engine behind
`VirtualMachine`. Gas is charged per executed instruction plus host-call
costs, at the rate the bytecode's translatability fixes (`INSTRUCTION_GAS`
for functions `translate.py` compiles, `INTERP_INSTRUCTION_GAS` for the
rest), whichever tier runs it. `LACHAIN_TPU_WASM=interp` pins execution to
this interpreter: the JAX package reads the same variable at the same
place, so one setting pins both packages to one tier.

Values: i32/i64 are canonical unsigned Python ints; f32/f64 Python floats
(f32 results rounded through single precision).

Float determinism rule: every NaN entering the value domain (loads,
reinterprets, f32 rounding) is canonicalized to the positive quiet NaN with
zero payload, so NaN bit patterns observable by contracts are identical on
every node regardless of host FP hardware.
"""
from __future__ import annotations

import math
import os as _os_module
import struct

_ENV_GET = _os_module.environ.get
from typing import Callable, Dict, List, Optional, Tuple

from .wasm import (
    BLOCK_EMPTY,
    FuncType,
    Function,
    I32,
    I64,
    Module,
    PAGE_SIZE,
    WasmDecodeError,
)

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF
MAX_CALL_DEPTH = 512
MAX_MEMORY_PAGES = 1024  # 64 MiB hard cap for contracts
MAX_TABLE_SIZE = 65_536  # funcref table cap at instantiation

# Gas schedule. The reference meters compiled WASM where one instruction is
# ~ns scale. Round 2 set 2_000 gas/op because the interpreter dispatches at
# ~2e6 ops/s; the round-3 translator tier (vm/translate.py) executes at
# >3e7 ops/s, so the schedule drops 10x: 200 gas/op bounds a full block
# (1e11 gas) to ~5e8 translated steps — the same seconds-scale wall-clock
# budget as before, with 10x the contract compute per block. The
# interpreter remains the fallback tier for untranslatable functions and
# the differential-testing oracle.
INSTRUCTION_GAS = 200
# untranslatable functions execute on the interpreter at ~1/16 the speed;
# they are billed at the round-2 rate so deliberately untranslatable
# bytecode cannot stretch a block's wall-clock budget. The rate is a pure
# function of the bytecode (translatability), NOT of the tier a node
# happens to execute — a node forced onto the interpreter by
# LACHAIN_TPU_WASM=interp still bills translatable code at the fast rate.
INTERP_INSTRUCTION_GAS = 2_000
MEMORY_GROW_GAS_PER_PAGE = 1_000_000  # priced near storage, not near free
BULK_MEMORY_GAS_PER_BYTE = 10


class WasmTrap(Exception):
    pass


class OutOfGas(WasmTrap):
    pass


class GasMeter:
    __slots__ = ("limit", "spent")

    def __init__(self, limit: int):
        self.limit = limit
        self.spent = 0

    def charge(self, amount: int) -> None:
        self.spent += amount
        if self.spent > self.limit:
            # clamp so callers can never observe (and bill) more gas than the
            # tx's up-front-verified limit, even when a host import charges a
            # large attacker-controlled amount in one step
            self.spent = self.limit
            raise OutOfGas(f"out of gas (limit {self.limit})")

    @property
    def remaining(self) -> int:
        return max(0, self.limit - self.spent)


def _s32(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def _s64(v: int) -> int:
    return v - (1 << 64) if v & 0x8000000000000000 else v


_CANON_NAN = struct.unpack("<d", b"\x00\x00\x00\x00\x00\x00\xf8\x7f")[0]


def _canon(v: float) -> float:
    """Consensus determinism rule: every NaN that enters the value domain is
    replaced by the positive quiet NaN with zero payload. NaN payload
    propagation through host FP hardware is platform-dependent; contracts
    could otherwise observe differing bit patterns via reinterpret/store and
    diverge the state hash across nodes."""
    return _CANON_NAN if v != v else v


def _f32(v: float) -> float:
    """Round through single precision (canonicalizing NaNs)."""
    if v != v:
        return _CANON_NAN
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _clz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return bits - v.bit_length()


def _ctz(v: int, bits: int) -> int:
    if v == 0:
        return bits
    return (v & -v).bit_length() - 1


def _rotl(v: int, n: int, bits: int) -> int:
    n %= bits
    mask = (1 << bits) - 1
    return ((v << n) | (v >> (bits - n))) & mask


def _trunc(f: float, lo: int, hi: int, signed: bool, bits: int) -> int:
    if math.isnan(f) or math.isinf(f):
        raise WasmTrap("invalid conversion to integer")
    t = math.trunc(f)
    if t < lo or t > hi:
        raise WasmTrap("integer overflow in truncation")
    return t & ((1 << bits) - 1)


def _trunc_sat(f: float, lo: int, hi: int, bits: int) -> int:
    if math.isnan(f):
        return 0
    t = math.trunc(max(lo, min(hi, f))) if not math.isinf(f) else (lo if f < 0 else hi)
    return t & ((1 << bits) - 1)


def _nearest(f: float) -> float:
    """Round-to-nearest, ties to even."""
    if math.isnan(f) or math.isinf(f):
        return f
    fl = math.floor(f)
    diff = f - fl
    if diff < 0.5:
        return float(fl)
    if diff > 0.5:
        return float(fl + 1)
    return float(fl if fl % 2 == 0 else fl + 1)


def _build_sidetable(body: List[tuple]) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Map each block/loop/if pc -> matching end pc (and if pc -> else pc)."""
    end_of: Dict[int, int] = {}
    else_of: Dict[int, int] = {}
    stack: List[int] = []
    for pc, ins in enumerate(body):
        op = ins[0]
        if op in (0x02, 0x03, 0x04):
            stack.append(pc)
        elif op == 0x05:
            if not stack:
                raise WasmDecodeError("else outside if")
            else_of[stack[-1]] = pc
        elif op == 0x0B:
            if stack:
                end_of[stack.pop()] = pc
            # else: the function's closing end
    if stack:
        raise WasmDecodeError("unbalanced blocks")
    return end_of, else_of


HostFunc = Callable[..., object]


class Instance:
    """An instantiated module: memory, globals, tables, host imports."""

    def __init__(
        self,
        module: Module,
        host: Optional[Dict[Tuple[str, str], HostFunc]] = None,
        gas: Optional[GasMeter] = None,
    ):
        self.module = module
        self.gas = gas or GasMeter(1 << 62)
        # per-instruction gas multiplier for TRANSLATABLE code: 1 once the
        # fast_wasm_gas hardfork is active, 10 below its height (the
        # round-2 schedule). Set by the VM from the block height; bulk/
        # memory/input gas is unaffected (those prices never changed).
        self.tgas_scale = 1
        self.host = host or {}
        self._imported_funcs: List[Tuple[FuncType, HostFunc]] = []
        for im in module.imports:
            if im.kind == 0:
                fn = self.host.get((im.module, im.name))
                if fn is None:
                    raise WasmTrap(f"unresolved import {im.module}.{im.name}")
                self._imported_funcs.append((module.types[im.type_idx], fn))
            elif im.kind in (1, 2, 3):
                raise WasmTrap("only function imports are supported")
        # memory
        self.memory = bytearray()
        self.mem_pages = 0
        self.mem_max = MAX_MEMORY_PAGES
        if module.mem_limits is not None:
            lo, hi = module.mem_limits
            if lo > MAX_MEMORY_PAGES:
                raise WasmTrap("initial memory too large")
            self.mem_pages = lo
            self.memory = bytearray(lo * PAGE_SIZE)
            if hi is not None:
                self.mem_max = min(hi, MAX_MEMORY_PAGES)
        # globals
        self.globals: List[object] = [
            self._eval_const(g.init) for g in module.globals
        ]
        # tables
        self.table: List[Optional[int]] = []
        if module.tables:
            lo, hi = module.tables[0]
            if lo > MAX_TABLE_SIZE:
                raise WasmTrap("table too large")
            self.table = [None] * lo
        for seg in module.elements:
            off = self._eval_const(seg.offset_expr)
            if not isinstance(off, int):
                raise WasmTrap("bad element offset")
            if off + len(seg.func_indices) > MAX_TABLE_SIZE:
                raise WasmTrap("element segment exceeds table cap")
            if off + len(seg.func_indices) > len(self.table):
                self.table.extend(
                    [None] * (off + len(seg.func_indices) - len(self.table))
                )
            for i, fi in enumerate(seg.func_indices):
                self.table[off + i] = fi
        # data segments
        for seg in module.data:
            off = self._eval_const(seg.offset_expr)
            if not isinstance(off, int):
                raise WasmTrap("bad data offset")
            if off + len(seg.data) > len(self.memory):
                raise WasmTrap("data segment out of bounds")
            self.memory[off : off + len(seg.data)] = seg.data
        self._depth = 0
        if module.start is not None:
            self.call_index(module.start, [])

    def _eval_const(self, expr: List[tuple]):
        """Init expressions: single const or global.get followed by end."""
        if not expr or expr[-1][0] != 0x0B:
            raise WasmTrap("bad init expression")
        ins = expr[0]
        op = ins[0]
        if op == 0x41:
            return ins[1] & MASK32
        if op == 0x42:
            return ins[1] & MASK64
        if op == 0x43:
            return _canon(struct.unpack("<f", ins[1])[0])
        if op == 0x44:
            return _canon(struct.unpack("<d", ins[1])[0])
        if op == 0x23:
            return self.globals[ins[1]]
        raise WasmTrap("unsupported init expression")

    # -- public API ---------------------------------------------------------

    def invoke(self, export_name: str, args: List[object]) -> Optional[object]:
        exp = self.module.export_map().get(export_name)
        if exp is None or exp.kind != 0:
            raise WasmTrap(f"no exported function {export_name!r}")
        return self.call_index(exp.index, args)

    def call_index(self, func_idx: int, args: List[object]) -> Optional[object]:
        n_imp = self.module.num_imported_funcs
        if func_idx < n_imp:
            ftype, fn = self._imported_funcs[func_idx]
            res = fn(*args)
            if ftype.results and res is None:
                raise WasmTrap("host function returned no value")
            return res if ftype.results else None
        fn_def = self.module.functions[func_idx - n_imp]
        ftype = self.module.types[fn_def.type_idx]
        if len(args) != len(ftype.params):
            raise WasmTrap("argument count mismatch")
        self._depth += 1
        if self._depth > MAX_CALL_DEPTH:
            self._depth -= 1
            raise WasmTrap("call stack exhausted")
        try:
            compiled = self._compiled_for(fn_def, ftype)
            if compiled is not False:
                res = compiled(self, *args)
                return res if ftype.results else None
            return self._exec(fn_def, ftype, list(args))
        finally:
            self._depth -= 1

    def _compiled_for(self, fn_def, ftype):
        """Translated tier for a function, cached on the decoded Function
        (modules are cached per code hash in vm.py, so translation runs
        once per contract per process). False = interpreter tier. Both the
        tier AND the gas rate are pure functions of the bytecode: the
        LACHAIN_TPU_WASM=interp override changes which engine RUNS, never
        what is billed — translation is still attempted to classify."""
        tier = getattr(fn_def, "_tier", None)
        if tier is None:
            from .translate import translate_function

            compiled = translate_function(self.module, fn_def, ftype)
            fn_def._gas_rate = (
                INSTRUCTION_GAS if compiled else INTERP_INSTRUCTION_GAS
            )
            tier = compiled or False
            fn_def._tier = tier
        if _ENV_GET("LACHAIN_TPU_WASM") == "interp":
            return False
        return tier

    def m_grow(self, delta: int) -> int:
        """memory.grow semantics shared by both execution tiers."""
        old = self.mem_pages
        if old + delta > self.mem_max:
            return MASK32  # -1
        self.gas.charge(MEMORY_GROW_GAS_PER_PAGE * delta)
        self.mem_pages = old + delta
        self.memory.extend(bytes(delta * PAGE_SIZE))
        return old

    # -- memory helpers -----------------------------------------------------

    def _mem_read(self, addr: int, n: int) -> bytes:
        if addr < 0 or addr + n > len(self.memory):
            raise WasmTrap("out of bounds memory access")
        return bytes(self.memory[addr : addr + n])

    def _mem_write(self, addr: int, data: bytes) -> None:
        if addr < 0 or addr + len(data) > len(self.memory):
            raise WasmTrap("out of bounds memory access")
        self.memory[addr : addr + len(data)] = data

    def mem_read(self, addr: int, n: int) -> bytes:
        """Host-side accessor (bounds-checked)."""
        return self._mem_read(addr, n)

    def mem_write(self, addr: int, data: bytes) -> None:
        self._mem_write(addr, data)

    # -- the interpreter loop ----------------------------------------------

    def _exec(
        self, fn: Function, ftype: FuncType, args: List[object]
    ) -> Optional[object]:
        body = fn.body
        # sidetable cached on the Function itself: shared across Instances
        # (modules are cached per code hash in vm.py)
        tables = getattr(fn, "_sidetable", None)
        if tables is None:
            tables = _build_sidetable(body)
            fn._sidetable = tables
        end_of, else_of = tables

        locals_: List[object] = args
        for vt in fn.locals:
            locals_.append(0 if vt in (I32, I64) else 0.0)

        stack: List[object] = []
        # control: (branch_target_pc, stack_height, arity, keep_on_branch)
        ctrl: List[Tuple[int, int, int]] = []
        pc = 0
        charge = self.gas.charge
        n_body = len(body)
        rate = getattr(fn, "_gas_rate", INTERP_INSTRUCTION_GAS)
        if rate == INSTRUCTION_GAS and self.tgas_scale != 1:
            rate *= self.tgas_scale  # pre-fast_wasm_gas schedule

        while pc < n_body:
            ins = body[pc]
            op = ins[0]
            charge(rate)

            # ---- control ----
            if op == 0x0B:  # end
                if ctrl:
                    ctrl.pop()
                pc += 1
                continue
            if op <= 0x11 or op == 0x1A or op == 0x1B:
                if op == 0x01:  # nop
                    pc += 1
                elif op == 0x00:  # unreachable
                    raise WasmTrap("unreachable")
                elif op == 0x02:  # block
                    arity = 0 if ins[1] == BLOCK_EMPTY else 1
                    ctrl.append((end_of[pc], len(stack), arity))
                    pc += 1
                elif op == 0x03:  # loop
                    ctrl.append((pc + 1, len(stack), 0))
                    pc += 1
                elif op == 0x04:  # if
                    cond = stack.pop()
                    arity = 0 if ins[1] == BLOCK_EMPTY else 1
                    if cond:
                        ctrl.append((end_of[pc], len(stack), arity))
                        pc += 1
                    else:
                        ep = else_of.get(pc)
                        if ep is not None:
                            ctrl.append((end_of[pc], len(stack), arity))
                            pc = ep + 1
                        else:
                            pc = end_of[pc] + 1
                elif op == 0x05:  # else: end of true arm
                    tgt, _, _ = ctrl[-1]
                    pc = tgt  # jump to the matching end (pops the label)
                elif op == 0x0C:  # br
                    if ins[1] == len(ctrl):
                        break  # function-label branch = return
                    pc = self._branch(ins[1], stack, ctrl)
                elif op == 0x0D:  # br_if
                    if stack.pop():
                        if ins[1] == len(ctrl):
                            break
                        pc = self._branch(ins[1], stack, ctrl)
                    else:
                        pc += 1
                elif op == 0x0E:  # br_table
                    idx = stack.pop()
                    targets, default = ins[1], ins[2]
                    depth = targets[idx] if idx < len(targets) else default
                    if depth == len(ctrl):
                        break
                    pc = self._branch(depth, stack, ctrl)
                elif op == 0x0F:  # return
                    break
                elif op == 0x10:  # call
                    callee = ins[1]
                    ct = self.module.func_type(callee)
                    n = len(ct.params)
                    call_args = stack[len(stack) - n :] if n else []
                    del stack[len(stack) - n :]
                    res = self.call_index(callee, call_args)
                    if ct.results:
                        stack.append(res)
                    pc += 1
                elif op == 0x11:  # call_indirect
                    elem = stack.pop()
                    if elem >= len(self.table) or self.table[elem] is None:
                        raise WasmTrap("undefined table element")
                    callee = self.table[elem]
                    ct = self.module.func_type(callee)
                    want = self.module.types[ins[1]]
                    if ct != want:
                        raise WasmTrap("indirect call type mismatch")
                    n = len(ct.params)
                    call_args = stack[len(stack) - n :] if n else []
                    del stack[len(stack) - n :]
                    res = self.call_index(callee, call_args)
                    if ct.results:
                        stack.append(res)
                    pc += 1
                elif op == 0x1A:  # drop
                    stack.pop()
                    pc += 1
                else:  # 0x1b select
                    c = stack.pop()
                    b = stack.pop()
                    a = stack.pop()
                    stack.append(a if c else b)
                    pc += 1
                continue

            # ---- variables ----
            if 0x20 <= op <= 0x24:
                idx = ins[1]
                if op == 0x20:
                    stack.append(locals_[idx])
                elif op == 0x21:
                    locals_[idx] = stack.pop()
                elif op == 0x22:
                    locals_[idx] = stack[-1]
                elif op == 0x23:
                    stack.append(self.globals[idx])
                else:
                    g = self.module.globals[idx]
                    if not g.mutable:
                        raise WasmTrap("assignment to immutable global")
                    self.globals[idx] = stack.pop()
                pc += 1
                continue

            # ---- memory ----
            if 0x28 <= op <= 0x3E:
                offset = ins[2]
                if op <= 0x35:  # loads
                    addr = stack.pop() + offset
                    if op == 0x28:
                        stack.append(int.from_bytes(self._mem_read(addr, 4), "little"))
                    elif op == 0x29:
                        stack.append(int.from_bytes(self._mem_read(addr, 8), "little"))
                    elif op == 0x2A:
                        stack.append(_canon(struct.unpack("<f", self._mem_read(addr, 4))[0]))
                    elif op == 0x2B:
                        stack.append(_canon(struct.unpack("<d", self._mem_read(addr, 8))[0]))
                    elif op == 0x2C:  # i32.load8_s
                        v = self._mem_read(addr, 1)[0]
                        stack.append((v - 256 if v & 0x80 else v) & MASK32)
                    elif op == 0x2D:
                        stack.append(self._mem_read(addr, 1)[0])
                    elif op == 0x2E:
                        v = int.from_bytes(self._mem_read(addr, 2), "little")
                        stack.append((v - 65536 if v & 0x8000 else v) & MASK32)
                    elif op == 0x2F:
                        stack.append(int.from_bytes(self._mem_read(addr, 2), "little"))
                    elif op == 0x30:
                        v = self._mem_read(addr, 1)[0]
                        stack.append((v - 256 if v & 0x80 else v) & MASK64)
                    elif op == 0x31:
                        stack.append(self._mem_read(addr, 1)[0])
                    elif op == 0x32:
                        v = int.from_bytes(self._mem_read(addr, 2), "little")
                        stack.append((v - 65536 if v & 0x8000 else v) & MASK64)
                    elif op == 0x33:
                        stack.append(int.from_bytes(self._mem_read(addr, 2), "little"))
                    elif op == 0x34:
                        v = int.from_bytes(self._mem_read(addr, 4), "little")
                        stack.append((v - (1 << 32) if v & 0x80000000 else v) & MASK64)
                    else:  # 0x35
                        stack.append(int.from_bytes(self._mem_read(addr, 4), "little"))
                else:  # stores
                    val = stack.pop()
                    addr = stack.pop() + offset
                    if op == 0x36:
                        self._mem_write(addr, (val & MASK32).to_bytes(4, "little"))
                    elif op == 0x37:
                        self._mem_write(addr, (val & MASK64).to_bytes(8, "little"))
                    elif op == 0x38:
                        self._mem_write(addr, struct.pack("<f", val))
                    elif op == 0x39:
                        self._mem_write(addr, struct.pack("<d", val))
                    elif op == 0x3A:
                        self._mem_write(addr, bytes([val & 0xFF]))
                    elif op == 0x3B:
                        self._mem_write(addr, (val & 0xFFFF).to_bytes(2, "little"))
                    elif op == 0x3C:
                        self._mem_write(addr, bytes([val & 0xFF]))
                    elif op == 0x3D:
                        self._mem_write(addr, (val & 0xFFFF).to_bytes(2, "little"))
                    else:  # 0x3e i64.store32
                        self._mem_write(addr, (val & MASK32).to_bytes(4, "little"))
                pc += 1
                continue

            if op == 0x3F:  # memory.size
                stack.append(self.mem_pages)
                pc += 1
                continue
            if op == 0x40:  # memory.grow
                stack.append(self.m_grow(stack.pop()))
                pc += 1
                continue

            # ---- constants ----
            if op == 0x41:
                stack.append(ins[1] & MASK32)
                pc += 1
                continue
            if op == 0x42:
                stack.append(ins[1] & MASK64)
                pc += 1
                continue
            if op == 0x43:
                stack.append(_canon(struct.unpack("<f", ins[1])[0]))
                pc += 1
                continue
            if op == 0x44:
                stack.append(_canon(struct.unpack("<d", ins[1])[0]))
                pc += 1
                continue

            # ---- numeric ----
            self._numeric(op, ins, stack)
            pc += 1

        return stack[-1] if ftype.results else None

    def _branch(
        self,
        depth: int,
        stack: List[object],
        ctrl: List[Tuple[int, int, int]],
    ) -> int:
        """Unwind `depth` labels; return new pc."""
        if depth >= len(ctrl):
            raise WasmTrap("branch depth out of range")
        # the label being branched to stays; everything above it is discarded
        target_idx = len(ctrl) - 1 - depth
        tgt, height, arity = ctrl[target_idx]
        vals = stack[len(stack) - arity :] if arity else []
        del stack[height:]
        stack.extend(vals)
        del ctrl[target_idx + 1 :]
        # for blocks the target is the `end` pc — executing it pops the label;
        # for loops the target is the first instruction and the label persists
        return tgt

    def _numeric(self, op: int, ins: tuple, stack: List[object]) -> None:
        push = stack.append
        pop = stack.pop
        if op == 0x45:
            push(1 if pop() == 0 else 0)
        elif op == 0x46 or op == 0x51:
            push(1 if pop() == pop() else 0)
        elif op == 0x47 or op == 0x52:
            push(1 if pop() != pop() else 0)
        elif op == 0x48:
            b, a = pop(), pop()
            push(1 if _s32(a) < _s32(b) else 0)
        elif op == 0x49 or op == 0x54:
            b, a = pop(), pop()
            push(1 if a < b else 0)
        elif op == 0x4A:
            b, a = pop(), pop()
            push(1 if _s32(a) > _s32(b) else 0)
        elif op == 0x4B or op == 0x56:
            b, a = pop(), pop()
            push(1 if a > b else 0)
        elif op == 0x4C:
            b, a = pop(), pop()
            push(1 if _s32(a) <= _s32(b) else 0)
        elif op == 0x4D or op == 0x58:
            b, a = pop(), pop()
            push(1 if a <= b else 0)
        elif op == 0x4E:
            b, a = pop(), pop()
            push(1 if _s32(a) >= _s32(b) else 0)
        elif op == 0x4F or op == 0x5A:
            b, a = pop(), pop()
            push(1 if a >= b else 0)
        elif op == 0x50:
            push(1 if pop() == 0 else 0)
        elif op == 0x53:
            b, a = pop(), pop()
            push(1 if _s64(a) < _s64(b) else 0)
        elif op == 0x55:
            b, a = pop(), pop()
            push(1 if _s64(a) > _s64(b) else 0)
        elif op == 0x57:
            b, a = pop(), pop()
            push(1 if _s64(a) <= _s64(b) else 0)
        elif op == 0x59:
            b, a = pop(), pop()
            push(1 if _s64(a) >= _s64(b) else 0)
        elif 0x5B <= op <= 0x66:  # float comparisons
            b, a = pop(), pop()
            rel = (op - 0x5B) % 6
            if rel == 0:
                push(1 if a == b else 0)
            elif rel == 1:
                push(1 if a != b else 0)
            elif rel == 2:
                push(1 if a < b else 0)
            elif rel == 3:
                push(1 if a > b else 0)
            elif rel == 4:
                push(1 if a <= b else 0)
            else:
                push(1 if a >= b else 0)
        elif op == 0x67:
            push(_clz(pop(), 32))
        elif op == 0x68:
            push(_ctz(pop(), 32))
        elif op == 0x69:
            push(bin(pop()).count("1"))
        elif op == 0x6A:
            b, a = pop(), pop()
            push((a + b) & MASK32)
        elif op == 0x6B:
            b, a = pop(), pop()
            push((a - b) & MASK32)
        elif op == 0x6C:
            b, a = pop(), pop()
            push((a * b) & MASK32)
        elif op == 0x6D:
            b, a = _s32(pop()), _s32(pop())
            if b == 0:
                raise WasmTrap("integer divide by zero")
            q = abs(a) // abs(b)
            if (a < 0) != (b < 0):
                q = -q
            if q == 1 << 31:
                raise WasmTrap("integer overflow")
            push(q & MASK32)
        elif op == 0x6E:
            b, a = pop(), pop()
            if b == 0:
                raise WasmTrap("integer divide by zero")
            push(a // b)
        elif op == 0x6F:
            b, a = _s32(pop()), _s32(pop())
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = abs(a) % abs(b)
            push((r if a >= 0 else -r) & MASK32)
        elif op == 0x70:
            b, a = pop(), pop()
            if b == 0:
                raise WasmTrap("integer divide by zero")
            push(a % b)
        elif op == 0x71:
            push(pop() & pop())
        elif op == 0x72:
            push(pop() | pop())
        elif op == 0x73:
            push(pop() ^ pop())
        elif op == 0x74:
            b, a = pop(), pop()
            push((a << (b % 32)) & MASK32)
        elif op == 0x75:
            b, a = pop(), pop()
            push((_s32(a) >> (b % 32)) & MASK32)
        elif op == 0x76:
            b, a = pop(), pop()
            push(a >> (b % 32))
        elif op == 0x77:
            b, a = pop(), pop()
            push(_rotl(a, b, 32))
        elif op == 0x78:
            b, a = pop(), pop()
            push(_rotl(a, 32 - (b % 32), 32))
        elif op == 0x79:
            push(_clz(pop(), 64))
        elif op == 0x7A:
            push(_ctz(pop(), 64))
        elif op == 0x7B:
            push(bin(pop()).count("1"))
        elif op == 0x7C:
            b, a = pop(), pop()
            push((a + b) & MASK64)
        elif op == 0x7D:
            b, a = pop(), pop()
            push((a - b) & MASK64)
        elif op == 0x7E:
            b, a = pop(), pop()
            push((a * b) & MASK64)
        elif op == 0x7F:
            b, a = _s64(pop()), _s64(pop())
            if b == 0:
                raise WasmTrap("integer divide by zero")
            q = abs(a) // abs(b)
            if (a < 0) != (b < 0):
                q = -q
            if q == 1 << 63:
                raise WasmTrap("integer overflow")
            push(q & MASK64)
        elif op == 0x80:
            b, a = pop(), pop()
            if b == 0:
                raise WasmTrap("integer divide by zero")
            push(a // b)
        elif op == 0x81:
            b, a = _s64(pop()), _s64(pop())
            if b == 0:
                raise WasmTrap("integer divide by zero")
            r = abs(a) % abs(b)
            push((r if a >= 0 else -r) & MASK64)
        elif op == 0x82:
            b, a = pop(), pop()
            if b == 0:
                raise WasmTrap("integer divide by zero")
            push(a % b)
        elif op == 0x83:
            push(pop() & pop())
        elif op == 0x84:
            push(pop() | pop())
        elif op == 0x85:
            push(pop() ^ pop())
        elif op == 0x86:
            b, a = pop(), pop()
            push((a << (b % 64)) & MASK64)
        elif op == 0x87:
            b, a = pop(), pop()
            push((_s64(a) >> (b % 64)) & MASK64)
        elif op == 0x88:
            b, a = pop(), pop()
            push(a >> (b % 64))
        elif op == 0x89:
            b, a = pop(), pop()
            push(_rotl(a, b, 64))
        elif op == 0x8A:
            b, a = pop(), pop()
            push(_rotl(a, 64 - (b % 64), 64))
        elif 0x8B <= op <= 0x98:  # f32 unary/binary
            self._float_op(op - 0x8B, stack, True)
        elif 0x99 <= op <= 0xA6:  # f64
            self._float_op(op - 0x99, stack, False)
        elif op == 0xA7:  # i32.wrap_i64
            push(pop() & MASK32)
        elif op == 0xA8:
            push(_trunc(pop(), -(1 << 31), (1 << 31) - 1, True, 32))
        elif op == 0xA9:
            push(_trunc(pop(), 0, MASK32, False, 32))
        elif op == 0xAA:
            push(_trunc(pop(), -(1 << 31), (1 << 31) - 1, True, 32))
        elif op == 0xAB:
            push(_trunc(pop(), 0, MASK32, False, 32))
        elif op == 0xAC:  # i64.extend_i32_s
            push(_s32(pop()) & MASK64)
        elif op == 0xAD:
            push(pop() & MASK32)
        elif op == 0xAE:
            push(_trunc(pop(), -(1 << 63), (1 << 63) - 1, True, 64))
        elif op == 0xAF:
            push(_trunc(pop(), 0, MASK64, False, 64))
        elif op == 0xB0:
            push(_trunc(pop(), -(1 << 63), (1 << 63) - 1, True, 64))
        elif op == 0xB1:
            push(_trunc(pop(), 0, MASK64, False, 64))
        elif op == 0xB2:
            push(_f32(float(_s32(pop()))))
        elif op == 0xB3:
            push(_f32(float(pop())))
        elif op == 0xB4:
            push(_f32(float(_s64(pop()))))
        elif op == 0xB5:
            push(_f32(float(pop())))
        elif op == 0xB6:  # f32.demote_f64
            push(_f32(pop()))
        elif op == 0xB7:
            push(float(_s32(pop())))
        elif op == 0xB8:
            push(float(pop()))
        elif op == 0xB9:
            push(float(_s64(pop())))
        elif op == 0xBA:
            push(float(pop()))
        elif op == 0xBB:  # f64.promote_f32
            push(float(pop()))
        elif op == 0xBC:
            push(int.from_bytes(struct.pack("<f", pop()), "little"))
        elif op == 0xBD:
            push(int.from_bytes(struct.pack("<d", pop()), "little"))
        elif op == 0xBE:
            push(_canon(struct.unpack("<f", (pop() & MASK32).to_bytes(4, "little"))[0]))
        elif op == 0xBF:
            push(_canon(struct.unpack("<d", (pop() & MASK64).to_bytes(8, "little"))[0]))
        elif op == 0xC0:  # i32.extend8_s
            v = pop() & 0xFF
            push((v - 256 if v & 0x80 else v) & MASK32)
        elif op == 0xC1:
            v = pop() & 0xFFFF
            push((v - 65536 if v & 0x8000 else v) & MASK32)
        elif op == 0xC2:
            v = pop() & 0xFF
            push((v - 256 if v & 0x80 else v) & MASK64)
        elif op == 0xC3:
            v = pop() & 0xFFFF
            push((v - 65536 if v & 0x8000 else v) & MASK64)
        elif op == 0xC4:
            v = pop() & MASK32
            push((v - (1 << 32) if v & 0x80000000 else v) & MASK64)
        elif op == 0xFC:
            sub = ins[1]
            if sub == 0:
                push(_trunc_sat(pop(), -(1 << 31), (1 << 31) - 1, 32))
            elif sub == 1:
                push(_trunc_sat(pop(), 0, MASK32, 32))
            elif sub == 2:
                push(_trunc_sat(pop(), -(1 << 31), (1 << 31) - 1, 32))
            elif sub == 3:
                push(_trunc_sat(pop(), 0, MASK32, 32))
            elif sub == 4:
                push(_trunc_sat(pop(), -(1 << 63), (1 << 63) - 1, 64))
            elif sub == 5:
                push(_trunc_sat(pop(), 0, MASK64, 64))
            elif sub == 6:
                push(_trunc_sat(pop(), -(1 << 63), (1 << 63) - 1, 64))
            elif sub == 7:
                push(_trunc_sat(pop(), 0, MASK64, 64))
            elif sub == 10:  # memory.copy
                n, s, d = pop(), pop(), pop()
                self.gas.charge(BULK_MEMORY_GAS_PER_BYTE * n)
                data = self._mem_read(s, n)
                self._mem_write(d, data)
            elif sub == 11:  # memory.fill
                n, v, d = pop(), pop(), pop()
                self.gas.charge(BULK_MEMORY_GAS_PER_BYTE * n)
                self._mem_write(d, bytes([v & 0xFF]) * n)
            else:
                raise WasmTrap(f"unsupported 0xfc:{sub}")
        else:
            raise WasmTrap(f"unsupported opcode 0x{op:02x}")

    def _float_op(self, rel: int, stack: List[object], single: bool) -> None:
        push = stack.append
        pop = stack.pop
        # _canon for f64: arithmetic on doubles must never expose the host
        # FPU's NaN (x86 produces a negative qNaN for inf-inf; ARM a positive
        # one) — all results funnel through the canonical quiet NaN
        rnd = _f32 if single else _canon
        if rel == 0:
            push(rnd(abs(pop())))
        elif rel == 1:
            push(rnd(-pop()))
        elif rel == 2:
            v = pop()
            push(v if math.isnan(v) or math.isinf(v) else rnd(float(math.ceil(v))))
        elif rel == 3:
            v = pop()
            push(v if math.isnan(v) or math.isinf(v) else rnd(float(math.floor(v))))
        elif rel == 4:
            v = pop()
            push(v if math.isnan(v) or math.isinf(v) else rnd(float(math.trunc(v))))
        elif rel == 5:
            push(rnd(_nearest(pop())))
        elif rel == 6:
            v = pop()
            if v < 0:
                push(float("nan"))
            else:
                push(rnd(math.sqrt(v)))
        elif rel == 7:
            b, a = pop(), pop()
            push(rnd(a + b))
        elif rel == 8:
            b, a = pop(), pop()
            push(rnd(a - b))
        elif rel == 9:
            b, a = pop(), pop()
            push(rnd(a * b))
        elif rel == 10:
            b, a = pop(), pop()
            if b == 0:
                # 0/0 and NaN/0 are NaN; finite/0 is signed infinity
                push(
                    float("nan")
                    if a == 0 or a != a
                    else math.copysign(float("inf"), a) * math.copysign(1.0, b)
                )
            else:
                push(rnd(a / b))
        elif rel == 11:
            b, a = pop(), pop()
            push(rnd(min(a, b)) if a == a and b == b else float("nan"))
        elif rel == 12:
            b, a = pop(), pop()
            push(rnd(max(a, b)) if a == a and b == b else float("nan"))
        else:  # 13 copysign
            b, a = pop(), pop()
            push(rnd(math.copysign(a, b)))
