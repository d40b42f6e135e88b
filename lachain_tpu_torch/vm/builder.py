"""Programmatic WASM module assembler.

The port's copy of `lachain_tpu/vm/builder.py`, byte for byte in what it
emits: the package ships no external WASM toolchain, so the contracts of
the tests and of `chip_smoke.py` are assembled with this builder.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

# F32/F64/I32/I64 are re-exported: tests and contract builders import
# the valtype constants from here alongside ModuleBuilder
from .wasm import F32, F64, I32, I64, WASM_MAGIC, WASM_VERSION  # noqa: F401

Body = Union[bytes, Sequence[Union[int, bytes]]]


def uleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def sleb(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if (v == 0 and not b & 0x40) or (v == -1 and b & 0x40):
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _flatten(body: Body) -> bytes:
    if isinstance(body, (bytes, bytearray)):
        return bytes(body)
    out = bytearray()
    for item in body:
        if isinstance(item, int):
            out.append(item)
        else:
            out.extend(item)
    return bytes(out)


class Op:
    """Instruction emitters (immediates LEB-encoded)."""

    unreachable = b"\x00"
    nop = b"\x01"
    else_ = b"\x05"
    end = b"\x0b"
    return_ = b"\x0f"
    drop = b"\x1a"
    select = b"\x1b"
    memory_size = b"\x3f\x00"
    memory_grow = b"\x40\x00"

    @staticmethod
    def block(result_type: Optional[int] = None) -> bytes:
        return bytes([0x02, result_type if result_type else 0x40])

    @staticmethod
    def loop(result_type: Optional[int] = None) -> bytes:
        return bytes([0x03, result_type if result_type else 0x40])

    @staticmethod
    def if_(result_type: Optional[int] = None) -> bytes:
        return bytes([0x04, result_type if result_type else 0x40])

    @staticmethod
    def br(depth: int) -> bytes:
        return b"\x0c" + uleb(depth)

    @staticmethod
    def br_if(depth: int) -> bytes:
        return b"\x0d" + uleb(depth)

    @staticmethod
    def br_table(targets: Sequence[int], default: int) -> bytes:
        out = b"\x0e" + uleb(len(targets))
        for t in targets:
            out += uleb(t)
        return out + uleb(default)

    @staticmethod
    def call(func_idx: int) -> bytes:
        return b"\x10" + uleb(func_idx)

    @staticmethod
    def call_indirect(type_idx: int) -> bytes:
        return b"\x11" + uleb(type_idx) + b"\x00"

    @staticmethod
    def local_get(i: int) -> bytes:
        return b"\x20" + uleb(i)

    @staticmethod
    def local_set(i: int) -> bytes:
        return b"\x21" + uleb(i)

    @staticmethod
    def local_tee(i: int) -> bytes:
        return b"\x22" + uleb(i)

    @staticmethod
    def global_get(i: int) -> bytes:
        return b"\x23" + uleb(i)

    @staticmethod
    def global_set(i: int) -> bytes:
        return b"\x24" + uleb(i)

    @staticmethod
    def i32_load(offset: int = 0, align: int = 2) -> bytes:
        return b"\x28" + uleb(align) + uleb(offset)

    @staticmethod
    def i64_load(offset: int = 0, align: int = 3) -> bytes:
        return b"\x29" + uleb(align) + uleb(offset)

    @staticmethod
    def i32_load8_u(offset: int = 0) -> bytes:
        return b"\x2d\x00" + uleb(offset)

    @staticmethod
    def i32_store(offset: int = 0, align: int = 2) -> bytes:
        return b"\x36" + uleb(align) + uleb(offset)

    @staticmethod
    def i64_store(offset: int = 0, align: int = 3) -> bytes:
        return b"\x37" + uleb(align) + uleb(offset)

    @staticmethod
    def i32_store8(offset: int = 0) -> bytes:
        return b"\x3a\x00" + uleb(offset)

    @staticmethod
    def i32_const(v: int) -> bytes:
        return b"\x41" + sleb(v)

    @staticmethod
    def i64_const(v: int) -> bytes:
        return b"\x42" + sleb(v)

    # common numeric shorthands
    i32_eqz = b"\x45"
    i32_eq = b"\x46"
    i32_ne = b"\x47"
    i32_lt_s = b"\x48"
    i32_lt_u = b"\x49"
    i32_gt_u = b"\x4b"
    i32_ge_u = b"\x4f"
    i32_add = b"\x6a"
    i32_sub = b"\x6b"
    i32_mul = b"\x6c"
    i32_div_u = b"\x6e"
    i32_rem_u = b"\x70"
    i32_and = b"\x71"
    i32_or = b"\x72"
    i32_xor = b"\x73"
    i32_shl = b"\x74"
    i32_shr_u = b"\x76"
    i64_add = b"\x7c"
    i64_sub = b"\x7d"
    i64_mul = b"\x7e"
    i64_eq = b"\x51"
    i64_lt_u = b"\x54"
    i64_ge_u = b"\x5a"
    i32_wrap_i64 = b"\xa7"
    i64_extend_i32_u = b"\xad"


class ModuleBuilder:
    def __init__(self):
        self.types: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = []
        self.imports: List[Tuple[str, str, int]] = []  # (mod, name, type_idx)
        self.funcs: List[Tuple[int, List[int], bytes]] = []
        self.exports: List[Tuple[str, int, int]] = []
        self.mem: Optional[Tuple[int, Optional[int]]] = None
        self.globals: List[Tuple[int, bool, bytes]] = []
        self.data: List[Tuple[int, bytes]] = []
        self.table_elems: List[int] = []
        self.start: Optional[int] = None

    def type_idx(self, params: Sequence[int], results: Sequence[int]) -> int:
        key = (tuple(params), tuple(results))
        if key in self.types:
            return self.types.index(key)
        self.types.append(key)
        return len(self.types) - 1

    def add_import(
        self, module: str, name: str, params: Sequence[int], results: Sequence[int]
    ) -> int:
        if self.funcs:
            raise ValueError("imports must be added before functions")
        ti = self.type_idx(params, results)
        self.imports.append((module, name, ti))
        return len(self.imports) - 1

    def add_function(
        self,
        params: Sequence[int],
        results: Sequence[int],
        locals_: Sequence[int],
        body: Body,
        export: Optional[str] = None,
    ) -> int:
        """Body must NOT include the trailing `end` — it is appended."""
        ti = self.type_idx(params, results)
        idx = len(self.imports) + len(self.funcs)
        self.funcs.append((ti, list(locals_), _flatten(body) + Op.end))
        if export:
            self.exports.append((export, 0, idx))
        return idx

    def add_memory(self, min_pages: int, max_pages: Optional[int] = None) -> None:
        self.mem = (min_pages, max_pages)

    def add_global(self, valtype: int, mutable: bool, init: Body) -> int:
        self.globals.append((valtype, mutable, _flatten(init) + Op.end))
        return len(self.globals) - 1

    def add_data(self, offset: int, data: bytes) -> None:
        self.data.append((offset, data))

    def add_table_funcs(self, func_indices: Sequence[int]) -> None:
        self.table_elems.extend(func_indices)

    def build(self) -> bytes:
        def section(sid: int, payload: bytes) -> bytes:
            return bytes([sid]) + uleb(len(payload)) + payload

        out = WASM_MAGIC + WASM_VERSION
        # types
        p = uleb(len(self.types))
        for params, results in self.types:
            p += b"\x60" + uleb(len(params)) + bytes(params)
            p += uleb(len(results)) + bytes(results)
        out += section(1, p)
        # imports
        if self.imports:
            p = uleb(len(self.imports))
            for mod, name, ti in self.imports:
                mb, nb = mod.encode(), name.encode()
                p += uleb(len(mb)) + mb + uleb(len(nb)) + nb + b"\x00" + uleb(ti)
            out += section(2, p)
        # functions
        p = uleb(len(self.funcs))
        for ti, _, _ in self.funcs:
            p += uleb(ti)
        out += section(3, p)
        # table
        if self.table_elems:
            out += section(4, uleb(1) + b"\x70\x00" + uleb(len(self.table_elems)))
        # memory
        if self.mem is not None:
            lo, hi = self.mem
            p = uleb(1) + (b"\x01" + uleb(lo) + uleb(hi) if hi is not None else b"\x00" + uleb(lo))
            out += section(5, p)
        # globals
        if self.globals:
            p = uleb(len(self.globals))
            for vt, mut, init in self.globals:
                p += bytes([vt, 1 if mut else 0]) + init
            out += section(6, p)
        # exports
        if self.exports:
            p = uleb(len(self.exports))
            for name, kind, idx in self.exports:
                nb = name.encode()
                p += uleb(len(nb)) + nb + bytes([kind]) + uleb(idx)
            out += section(7, p)
        # start
        if self.start is not None:
            out += section(8, uleb(self.start))
        # elements
        if self.table_elems:
            p = uleb(1) + uleb(0) + Op.i32_const(0) + Op.end
            p += uleb(len(self.table_elems))
            for fi in self.table_elems:
                p += uleb(fi)
            out += section(9, p)
        # code
        p = uleb(len(self.funcs))
        for _, locals_, body in self.funcs:
            # group consecutive equal local types
            groups: List[Tuple[int, int]] = []
            for vt in locals_:
                if groups and groups[-1][1] == vt:
                    groups[-1] = (groups[-1][0] + 1, vt)
                else:
                    groups.append((1, vt))
            lp = uleb(len(groups))
            for cnt, vt in groups:
                lp += uleb(cnt) + bytes([vt])
            fb = lp + body
            p += uleb(len(fb)) + fb
        out += section(10, p)
        # data
        if self.data:
            p = uleb(len(self.data))
            for off, d in self.data:
                p += uleb(0) + Op.i32_const(off) + Op.end + uleb(len(d)) + d
            out += section(11, p)
        return out
