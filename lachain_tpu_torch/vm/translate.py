"""WASM -> Python source translator: the execution tier above the interpreter.

The port's copy of `lachain_tpu/vm/translate.py`. The interpreter
dispatches decoded tuples in a Python loop at ~1e6 ops/s; this module
translates each function ONCE into straight-line Python source
(exec-compiled to CPython bytecode), which removes the dispatch loop,
tuple indexing, per-instruction gas calls and control-flow re-walking, on
the same deterministic gas schedule.

Design:
  * stack slots become named locals: slot i is always variable `s{i}`.
    Wasm validation fixes the stack height at every program point, so
    naming by height makes control-flow joins line up without phi moves;
    branches carrying results emit explicit `s{dst} = s{src}` moves.
  * structured control flow maps to real Python control flow:
      block/if (branch-targeted) -> `while True: ... break`
      loop                       -> `while True:` (fallthrough breaks,
                                    `br` continues)
    Multi-level branches unwind with a `_br` counter that counts WRAPPED
    labels only (untargeted blocks emit no loop, so a single Python
    `break` already skips them). The check after every wrapped label:
        if _br:
            _br -= 1
            if _br == 0 and <enclosing wrapped label is a loop>: continue
            break    # _br==0 block target: exit its while; else unwind on
  * only branch-targeted labels get wrapper loops: CPython rejects >20
    statically nested loops and most blocks are not targets. A function
    that still exceeds the nesting budget (or any SyntaxError) falls back
    to the interpreter — a deterministic property of the bytecode, so
    every node makes the same engine choice for the same code.
  * gas: accumulated in a LOCAL (`_g`) per basic block and settled into
    the meter at control boundaries plus a function-level try/finally.
    Before every trap-capable op (loads/stores, div/conversion shims,
    calls, unreachable) the pending block cost folds into `_g`, so a trap
    bills exactly the instructions the interpreter would have billed —
    the two tiers agree on gas for EVERY execution, including traps.
    (Within a pure-arithmetic run the limit is only checked at the next
    boundary; the extra ops a nearly-exhausted frame executes are
    side-effect-free and the frame fails with gas_used clamped to the
    limit either way.)
  * semantics single-sourced: only the hottest ~40 ops (integer
    arithmetic/compares, locals, constants, loads/stores) are inlined as
    source templates; div/rem/rotl/popcnt/converts and ALL float
    arithmetic call back into the interpreter's own `_numeric` /
    `_float_op` switches through 2-line shims, so NaN canonicalization
    and trap edge cases cannot diverge. tests/test_torch_vm.py runs both
    engines of both packages differentially.
"""
from __future__ import annotations

import struct as _struct
from typing import List, Optional

from .interpreter import (
    BLOCK_EMPTY,
    BULK_MEMORY_GAS_PER_BYTE,
    INSTRUCTION_GAS,
    MASK32,
    MASK64,
    Instance,
    WasmTrap,
    _canon,
    _clz,
    _ctz,
    _s32,
    _s64,
)

# generated code keeps <= 17 nested Python loops (CPython caps statically
# nested blocks at 20, and the gas-settlement try/finally takes one);
# deeper functions stay interpreted
MAX_LOOP_NESTING = 17


def _num_shim(op: int, *vals):
    """Non-inlined integer/conversion ops through the interpreter's own
    switch (`self` is unused there for these opcode ranges)."""
    st = list(vals)
    Instance._numeric(None, op, (op,), st)
    return st[-1]


def _num_shim_fc(sub: int, a):
    st = [a]
    Instance._numeric(None, 0xFC, (0xFC, sub), st)
    return st[-1]


def _f1(rel: int, single: bool, a):
    st = [a]
    Instance._float_op(None, rel, st, single)
    return st[-1]


def _f2(rel: int, single: bool, a, b):
    st = [a, b]
    Instance._float_op(None, rel, st, single)
    return st[-1]


_ENV = {
    "M32": MASK32,
    "M64": MASK64,
    "_s32": _s32,
    "_s64": _s64,
    "_clz": _clz,
    "_ctz": _ctz,
    "_canon": _canon,
    "_num": _num_shim,
    "_numfc": _num_shim_fc,
    "_f1": _f1,
    "_f2": _f2,
    "WasmTrap": WasmTrap,
    "struct": _struct,
    "BULK_GAS": BULK_MEMORY_GAS_PER_BYTE,
}

# hot binary ops inlined as source (pops b then a, pushes the expression)
_BIN = {
    0x6A: "({a} + {b}) & M32",
    0x6B: "({a} - {b}) & M32",
    0x6C: "({a} * {b}) & M32",
    0x71: "{a} & {b}",
    0x72: "{a} | {b}",
    0x73: "{a} ^ {b}",
    0x74: "({a} << ({b} % 32)) & M32",
    0x75: "(_s32({a}) >> ({b} % 32)) & M32",
    0x76: "{a} >> ({b} % 32)",
    0x7C: "({a} + {b}) & M64",
    0x7D: "({a} - {b}) & M64",
    0x7E: "({a} * {b}) & M64",
    0x83: "{a} & {b}",
    0x84: "{a} | {b}",
    0x85: "{a} ^ {b}",
    0x86: "({a} << ({b} % 64)) & M64",
    0x87: "(_s64({a}) >> ({b} % 64)) & M64",
    0x88: "{a} >> ({b} % 64)",
    0x46: "1 if {a} == {b} else 0",
    0x47: "1 if {a} != {b} else 0",
    0x48: "1 if _s32({a}) < _s32({b}) else 0",
    0x49: "1 if {a} < {b} else 0",
    0x4A: "1 if _s32({a}) > _s32({b}) else 0",
    0x4B: "1 if {a} > {b} else 0",
    0x4C: "1 if _s32({a}) <= _s32({b}) else 0",
    0x4D: "1 if {a} <= {b} else 0",
    0x4E: "1 if _s32({a}) >= _s32({b}) else 0",
    0x4F: "1 if {a} >= {b} else 0",
    0x51: "1 if {a} == {b} else 0",
    0x52: "1 if {a} != {b} else 0",
    0x53: "1 if _s64({a}) < _s64({b}) else 0",
    0x54: "1 if {a} < {b} else 0",
    0x55: "1 if _s64({a}) > _s64({b}) else 0",
    0x56: "1 if {a} > {b} else 0",
    0x57: "1 if _s64({a}) <= _s64({b}) else 0",
    0x58: "1 if {a} <= {b} else 0",
    0x59: "1 if _s64({a}) >= _s64({b}) else 0",
    0x5A: "1 if {a} >= {b} else 0",
}
for _op, _tpl in {  # float comparisons (plain IEEE semantics on floats)
    0x5B: "1 if {a} == {b} else 0",
    0x5C: "1 if {a} != {b} else 0",
    0x5D: "1 if {a} < {b} else 0",
    0x5E: "1 if {a} > {b} else 0",
    0x5F: "1 if {a} <= {b} else 0",
    0x60: "1 if {a} >= {b} else 0",
    0x61: "1 if {a} == {b} else 0",
    0x62: "1 if {a} != {b} else 0",
    0x63: "1 if {a} < {b} else 0",
    0x64: "1 if {a} > {b} else 0",
    0x65: "1 if {a} <= {b} else 0",
    0x66: "1 if {a} >= {b} else 0",
}.items():
    _BIN[_op] = _tpl

_UN = {
    0x45: "1 if {a} == 0 else 0",
    0x50: "1 if {a} == 0 else 0",
    0x67: "_clz({a}, 32)",
    0x68: "_ctz({a}, 32)",
    0x79: "_clz({a}, 64)",
    0x7A: "_ctz({a}, 64)",
    0xA7: "{a} & M32",
    0xAC: "_s32({a}) & M64",
    0xAD: "{a} & M32",
}

# shimmed ops (single-sourced through the interpreter switch)
_SHIM1 = {0x69, 0x7B, 0xA8, 0xA9, 0xAA, 0xAB, 0xAE, 0xAF, 0xB0, 0xB1,
          0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xBB,
          0xBC, 0xBD, 0xBE, 0xBF, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4}
_SHIM2 = {0x6D, 0x6E, 0x6F, 0x70, 0x77, 0x78, 0x7F, 0x80, 0x81, 0x82,
          0x89, 0x8A}

_LOADS = {
    0x28: (4, 'int.from_bytes({r}, "little")'),
    0x29: (8, 'int.from_bytes({r}, "little")'),
    0x2A: (4, '_canon(struct.unpack("<f", {r})[0])'),
    0x2B: (8, '_canon(struct.unpack("<d", {r})[0])'),
    0x2C: (1, "(({r}[0] - 256) & M32) if {r}[0] & 0x80 else {r}[0]"),
    0x2D: (1, "{r}[0]"),
    0x2E: (2, '((int.from_bytes({r}, "little") - 65536) & M32) '
              'if {r}[1] & 0x80 else int.from_bytes({r}, "little")'),
    0x2F: (2, 'int.from_bytes({r}, "little")'),
    0x30: (1, "(({r}[0] - 256) & M64) if {r}[0] & 0x80 else {r}[0]"),
    0x31: (1, "{r}[0]"),
    0x32: (2, '((int.from_bytes({r}, "little") - 65536) & M64) '
              'if {r}[1] & 0x80 else int.from_bytes({r}, "little")'),
    0x33: (2, 'int.from_bytes({r}, "little")'),
    0x34: (4, '((int.from_bytes({r}, "little") - (1 << 32)) & M64) '
              'if {r}[3] & 0x80 else int.from_bytes({r}, "little")'),
    0x35: (4, 'int.from_bytes({r}, "little")'),
}

_STORES = {
    0x36: '({v} & M32).to_bytes(4, "little")',
    0x37: '({v} & M64).to_bytes(8, "little")',
    0x38: 'struct.pack("<f", {v})',
    0x39: 'struct.pack("<d", {v})',
    0x3A: "bytes(({v} & 0xFF,))",
    0x3B: '({v} & 0xFFFF).to_bytes(2, "little")',
    0x3C: "bytes(({v} & 0xFF,))",
    0x3D: '({v} & 0xFFFF).to_bytes(2, "little")',
    0x3E: '({v} & M32).to_bytes(4, "little")',
}


class _Unsupported(Exception):
    """Function shape the translator does not handle -> interpreter."""


class _Label:
    __slots__ = (
        "kind", "height", "arity", "targeted", "wrapped", "dead",
        "has_if", "in_else", "synthetic",
    )

    def __init__(self, kind, height, arity, targeted):
        self.kind = kind  # "block" | "loop" | "if" | "func"
        self.height = height
        self.arity = arity
        self.targeted = targeted
        self.wrapped = False
        self.dead = False
        self.has_if = False
        self.in_else = False
        self.synthetic = False  # opened inside dead code


def _find_targets(body) -> set:
    """pcs of structured ops some br targets (-1 = the function label)."""
    stack: List[int] = []
    targets = set()
    for pc, ins in enumerate(body):
        op = ins[0]
        if op in (0x02, 0x03, 0x04):
            stack.append(pc)
        elif op == 0x0B and stack:
            stack.pop()
        elif op in (0x0C, 0x0D):
            d = ins[1]
            targets.add(stack[-1 - d] if d < len(stack) else -1)
        elif op == 0x0E:
            for d in list(ins[1]) + [ins[2]]:
                targets.add(stack[-1 - d] if d < len(stack) else -1)
    return targets


class _Compiler:
    def __init__(self, module, fn, ftype):
        self.module = module
        self.fn = fn
        self.ftype = ftype
        self.lines: List[str] = []
        self.indent = 1
        self.pending_gas = 0
        self.loop_depth = 0

    # -- low-level emission ------------------------------------------------

    def emit(self, line: str) -> None:
        self.lines.append("    " * self.indent + line)

    def dedent(self) -> None:
        """Close a suite, inserting `pass` if it would be empty."""
        if self.lines and self.lines[-1].endswith(":"):
            self.emit("pass")
        self.indent -= 1

    def flush_gas(self) -> None:
        """Hard settlement: fold pending + _g into the meter (control
        boundaries, calls, host ops — places where side effects or
        control transfers require the limit check to be current)."""
        if self.pending_gas:
            self.emit(f"_g += {self.pending_gas}")
            self.pending_gas = 0
        # inline settle: on an OutOfGas raise _g stays set and the finally
        # re-charges it — harmless, the meter clamps spent to the limit
        self.emit("inst.gas.charge(_g * inst.tgas_scale)")
        self.emit("_g = 0")

    def soft_gas(self) -> None:
        """Fold pending into the local accumulator WITHOUT a meter call —
        emitted before trap-capable ops so a trap's finally-settlement
        bills exactly the instructions executed so far."""
        if self.pending_gas:
            self.emit(f"_g += {self.pending_gas}")
            self.pending_gas = 0

    # -- unwind plumbing ---------------------------------------------------

    def nearest_wrapped(self, labels) -> Optional[_Label]:
        for lb in reversed(labels):
            if lb.wrapped:
                return lb
        return None

    def emit_unwind_check(self, labels) -> None:
        """After an inner wrapped label's while, inside the current label
        chain: propagate an in-flight multi-level branch."""
        parent = self.nearest_wrapped(labels)
        if parent is None:
            return  # no outer while: no deep br can be in flight here
        self.emit("if _br:")
        self.indent += 1
        self.emit("_br -= 1")
        if parent.kind == "loop":
            self.emit("if _br == 0: continue")
        self.emit("break")
        self.indent -= 1

    def emit_br(self, labels, depth: int, height: int) -> None:
        if depth >= len(labels):
            raise _Unsupported("branch depth out of range")
        t = len(labels) - 1 - depth
        target = labels[t]
        self.flush_gas()
        if target.kind == "func":
            self.emit_return(height)
            return
        if target.kind != "loop" and target.arity:
            r = target.arity
            for j in range(r):
                src, dst = height - r + j, target.height + j
                if src != dst:
                    self.emit(f"s{dst} = s{src}")
        if not target.wrapped:
            raise _Unsupported("br to unwrapped label")  # cannot happen
        w = sum(1 for lb in labels[t + 1 :] if lb.wrapped)
        if w == 0:
            self.emit("continue" if target.kind == "loop" else "break")
        else:
            self.emit(f"_br = {w}")
            self.emit("break")

    def emit_return(self, height: int) -> None:
        self.flush_gas()
        if self.ftype.results:
            self.emit(f"return s{height - 1}")
        else:
            self.emit("return None")

    # -- main --------------------------------------------------------------

    def compile(self) -> str:
        fn, ftype, module = self.fn, self.ftype, self.module
        body = fn.body
        targets = _find_targets(body)
        nparams = len(ftype.params)
        args = ", ".join(f"l{i}" for i in range(nparams))
        self.lines.append(
            f"def _wfn(inst{', ' + args if args else ''}):"
        )
        self.emit("_br = 0")
        self.emit("_g = 0")
        self.emit("try:")
        self.indent += 1
        from .wasm import I32, I64

        for i, vt in enumerate(fn.locals):
            init = "0" if vt in (I32, I64) else "0.0"
            self.emit(f"l{nparams + i} = {init}")
        labels = [_Label("func", 0, len(ftype.results), False)]
        h = 0

        for pc, ins in enumerate(body):
            op = ins[0]
            lb = labels[-1]
            if h < 0:
                # invalid-but-decodable bytecode (e.g. drop on an empty
                # stack): the interpreter traps at RUNTIME only if the bad
                # path executes — exact parity means falling back to it
                raise _Unsupported("static stack underflow")

            # ---- dead code: skip, but keep structure ---------------------
            if lb.dead:
                if op in (0x02, 0x03, 0x04):
                    dead_lb = _Label("block", 0, 0, False)
                    dead_lb.dead = True
                    dead_lb.synthetic = True
                    labels.append(dead_lb)
                    continue
                if op == 0x05 and not lb.synthetic:
                    # true arm ended dead: else arm starts live again
                    self.dedent()
                    self.emit("else:")
                    self.indent += 1
                    lb.dead = False
                    lb.in_else = True
                    h = lb.height
                    continue
                if op == 0x0B:
                    labels.pop()
                    if not labels:
                        break
                    if lb.synthetic:
                        continue
                    # live-opened label whose body ended dead: close its
                    # emitted structure; the unwind check must still land
                    # right after its while (breaks with _br in flight exit
                    # through here)
                    if lb.has_if:
                        self.dedent()
                    if lb.wrapped:
                        self.dedent()
                        self.loop_depth -= 1
                        self.emit_unwind_check(labels)
                    live_after = (lb.targeted and lb.kind != "loop") or (
                        # an if whose true arm ended dead but which has NO
                        # else: the false path falls through the end
                        lb.has_if
                        and not lb.in_else
                    )
                    if live_after:
                        labels[-1].dead = False
                        h = lb.height + lb.arity
                        # arrivals here execute the end opcode
                        self.pending_gas += INSTRUCTION_GAS
                    else:
                        labels[-1].dead = True
                    continue
                continue

            if op != 0x0B:
                self.pending_gas += INSTRUCTION_GAS

            # ---- control -------------------------------------------------
            if op in (0x02, 0x03, 0x04):
                kind = {0x02: "block", 0x03: "loop", 0x04: "if"}[op]
                arity = 0 if ins[1] == BLOCK_EMPTY else 1
                if op == 0x04:
                    h -= 1  # condition
                new = _Label(kind, h, arity, pc in targets)
                labels.append(new)
                self.flush_gas()
                if new.targeted or kind == "loop":
                    self.loop_depth += 1
                    if self.loop_depth > MAX_LOOP_NESTING:
                        raise _Unsupported("nesting exceeds CPython limit")
                    self.emit("while True:")
                    self.indent += 1
                    new.wrapped = True
                if op == 0x04:
                    self.emit(f"if s{h}:")
                    self.indent += 1
                    new.has_if = True
                continue
            if op == 0x05:  # else (live true arm)
                self.flush_gas()
                self.dedent()
                self.emit("else:")
                self.indent += 1
                lb.in_else = True
                h = lb.height
                continue
            if op == 0x0B:  # end
                labels.pop()
                self.flush_gas()
                if not labels:
                    if lb.wrapped:
                        self.emit("break")
                        self.dedent()
                        self.loop_depth -= 1
                    self.pending_gas += INSTRUCTION_GAS  # the end itself
                    self.emit_return(h)
                    break
                if lb.has_if:
                    self.dedent()
                if lb.wrapped:
                    self.emit("break")
                    self.dedent()
                    self.loop_depth -= 1
                    self.emit_unwind_check(labels)
                # the end instruction's gas lands in the PARENT segment:
                # every arrival at this point (fallthrough, either if arm,
                # br-to-end) passes it, exactly like the interpreter
                # executing the end opcode
                self.pending_gas += INSTRUCTION_GAS
                h = lb.height + lb.arity
                continue
            if op == 0x0C:
                self.emit_br(labels, ins[1], h)
                lb.dead = True
                continue
            if op == 0x0D:
                h -= 1
                self.flush_gas()
                self.emit(f"if s{h}:")
                self.indent += 1
                self.emit_br(labels, ins[1], h)
                self.dedent()
                continue
            if op == 0x0E:  # br_table
                h -= 1
                self.flush_gas()
                tbl, default = list(ins[1]), ins[2]
                if tbl:
                    self.emit(f"_t = s{h}")
                    for k, d in enumerate(tbl):
                        self.emit(f"{'if' if k == 0 else 'elif'} _t == {k}:")
                        self.indent += 1
                        self.emit_br(labels, d, h)
                        self.dedent()
                    self.emit("else:")
                    self.indent += 1
                    self.emit_br(labels, default, h)
                    self.dedent()
                else:
                    self.emit_br(labels, default, h)
                lb.dead = True
                continue
            if op == 0x0F:
                self.emit_return(h)
                lb.dead = True
                continue
            if op == 0x00:
                self.soft_gas()
                self.emit('raise WasmTrap("unreachable")')
                lb.dead = True
                continue
            if op == 0x01:
                continue
            if op == 0x10:  # call
                callee = ins[1]
                try:
                    ct = module.func_type(callee)
                except Exception:
                    raise _Unsupported("call index out of range")
                n = len(ct.params)
                self.flush_gas()
                argl = ", ".join(f"s{h - n + j}" for j in range(n))
                h -= n
                if ct.results:
                    self.emit(f"s{h} = inst.call_index({callee}, [{argl}])")
                    h += 1
                else:
                    self.emit(f"inst.call_index({callee}, [{argl}])")
                continue
            if op == 0x11:  # call_indirect
                type_idx = ins[1]
                if type_idx >= len(module.types):
                    raise _Unsupported("type index out of range")
                want = module.types[type_idx]
                n = len(want.params)
                self.flush_gas()
                h -= 1
                self.emit(f"_t = s{h}")
                self.emit(
                    "if _t >= len(inst.table) or inst.table[_t] is None: "
                    'raise WasmTrap("undefined table element")'
                )
                self.emit("_c = inst.table[_t]")
                self.emit(
                    f"if inst.module.func_type(_c) != "
                    f"inst.module.types[{type_idx}]: "
                    'raise WasmTrap("indirect call type mismatch")'
                )
                argl = ", ".join(f"s{h - n + j}" for j in range(n))
                h -= n
                if want.results:
                    self.emit(f"s{h} = inst.call_index(_c, [{argl}])")
                    h += 1
                else:
                    self.emit(f"inst.call_index(_c, [{argl}])")
                continue
            if op == 0x1A:
                h -= 1
                continue
            if op == 0x1B:
                h -= 3
                self.emit(f"s{h} = s{h} if s{h + 2} else s{h + 1}")
                h += 1
                continue

            # ---- variables ----------------------------------------------
            if op == 0x20:
                self.emit(f"s{h} = l{ins[1]}")
                h += 1
                continue
            if op == 0x21:
                h -= 1
                self.emit(f"l{ins[1]} = s{h}")
                continue
            if op == 0x22:
                self.emit(f"l{ins[1]} = s{h - 1}")
                continue
            if op == 0x23:
                self.emit(f"s{h} = inst.globals[{ins[1]}]")
                h += 1
                continue
            if op == 0x24:
                if ins[1] >= len(module.globals):
                    raise _Unsupported("global index out of range")
                g = module.globals[ins[1]]
                if not g.mutable:
                    # trap only if EXECUTED: the interpreter tier gives
                    # that runtime behavior exactly
                    raise _Unsupported("assignment to immutable global")
                h -= 1
                self.emit(f"inst.globals[{ins[1]}] = s{h}")
                continue

            # ---- memory -------------------------------------------------
            if 0x28 <= op <= 0x35:
                nb, tpl = _LOADS[op]
                off = ins[2]
                a = f"s{h - 1}"
                addr = f"{a} + {off}" if off else a
                self.soft_gas()  # OOB load traps: bill executed ops first
                self.emit(f"_m = inst._mem_read({addr}, {nb})")
                self.emit(f"s{h - 1} = " + tpl.format(r="_m"))
                continue
            if 0x36 <= op <= 0x3E:
                off = ins[2]
                h -= 2
                addr = f"s{h} + {off}" if off else f"s{h}"
                self.soft_gas()  # OOB store traps
                self.emit(
                    f"inst._mem_write({addr}, "
                    + _STORES[op].format(v=f"s{h + 1}")
                    + ")"
                )
                continue
            if op == 0x3F:
                self.emit(f"s{h} = inst.mem_pages")
                h += 1
                continue
            if op == 0x40:
                self.flush_gas()
                self.emit(f"s{h - 1} = inst.m_grow(s{h - 1})")
                continue

            # ---- constants ----------------------------------------------
            if op == 0x41:
                self.emit(f"s{h} = {ins[1] & MASK32}")
                h += 1
                continue
            if op == 0x42:
                self.emit(f"s{h} = {ins[1] & MASK64}")
                h += 1
                continue
            if op in (0x43, 0x44):
                fmt = "<f" if op == 0x43 else "<d"
                v = _canon(_struct.unpack(fmt, ins[1])[0])
                if v != v:
                    self.emit(f"s{h} = _canon(float('nan'))")
                elif v == float("inf"):
                    self.emit(f"s{h} = float('inf')")
                elif v == float("-inf"):
                    self.emit(f"s{h} = float('-inf')")
                else:
                    self.emit(f"s{h} = {v!r}")
                h += 1
                continue

            # ---- numeric ------------------------------------------------
            if op in _BIN:
                h -= 2
                self.emit(
                    f"s{h} = " + _BIN[op].format(a=f"s{h}", b=f"s{h + 1}")
                )
                h += 1
                continue
            if op in _UN:
                self.emit(
                    f"s{h - 1} = " + _UN[op].format(a=f"s{h - 1}")
                )
                continue
            if 0x8B <= op <= 0xA6:  # float arithmetic via interpreter shim
                single = op <= 0x98
                rel = op - (0x8B if single else 0x99)
                flag = "True" if single else "False"
                if rel >= 7:
                    h -= 2
                    self.emit(
                        f"s{h} = _f2({rel}, {flag}, s{h}, s{h + 1})"
                    )
                    h += 1
                else:
                    self.emit(
                        f"s{h - 1} = _f1({rel}, {flag}, s{h - 1})"
                    )
                continue
            if op == 0xFC:
                sub = ins[1]
                if sub <= 7:
                    self.soft_gas()  # trunc traps on NaN/overflow
                    self.emit(f"s{h - 1} = _numfc({sub}, s{h - 1})")
                    continue
                if sub in (10, 11):
                    self.flush_gas()
                    h -= 3
                    d, x, n = f"s{h}", f"s{h + 1}", f"s{h + 2}"
                    self.emit(f"inst.gas.charge(BULK_GAS * {n})")
                    if sub == 10:
                        self.emit(
                            f"inst._mem_write({d}, inst._mem_read({x}, {n}))"
                        )
                    else:
                        self.emit(
                            f"inst._mem_write({d}, bytes(({x} & 0xFF,)) * {n})"
                        )
                    continue
                raise _Unsupported(f"0xfc:{sub}")
            if op in _SHIM1:
                self.soft_gas()  # conversions can trap
                self.emit(f"s{h - 1} = _num({op}, s{h - 1})")
                continue
            if op in _SHIM2:
                h -= 2
                self.soft_gas()  # div/rem trap on zero/overflow
                self.emit(f"s{h} = _num({op}, s{h}, s{h + 1})")
                h += 1
                continue
            raise _Unsupported(f"opcode 0x{op:02x}")

        # settle whatever the last executed segment accumulated — on
        # normal return AND on traps (exact interpreter gas parity)
        self.indent = 1
        self.emit("finally:")
        self.indent += 1
        self.emit("inst.gas.charge(_g * inst.tgas_scale)")
        return "\n".join(self.lines) + "\n"


def translate_function(module, fn, ftype):
    """Compile one decoded function to a Python callable, or None when the
    shape is unsupported (caller falls back to the interpreter)."""
    try:
        src = _Compiler(module, fn, ftype).compile()
        ns = dict(_ENV)
        exec(compile(src, "<wasm>", "exec"), ns)  # noqa: S102
        out = ns["_wfn"]
        out._src = src  # for tests/debugging
        return out
    except Exception:
        # ANY translation failure (unsupported shapes, malformed-but-
        # decodable indices, future compiler bugs) deterministically lands
        # on the interpreter tier, which is always semantically correct
        return None
