"""WASM binary format decoder (MVP + sign-extension + saturating truncation).

The port's copy of `lachain_tpu/vm/wasm.py`: decodes a `.wasm` module into
plain dataclasses the interpreter executes; the binary layout follows the
public WebAssembly 1.0 spec.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WASM_MAGIC = b"\x00asm"
WASM_VERSION = b"\x01\x00\x00\x00"

# value types
I32, I64, F32, F64 = 0x7F, 0x7E, 0x7D, 0x7C
FUNCREF = 0x70
VALTYPES = {I32, I64, F32, F64}
BLOCK_EMPTY = 0x40

SEC_CUSTOM = 0
SEC_TYPE = 1
SEC_IMPORT = 2
SEC_FUNCTION = 3
SEC_TABLE = 4
SEC_MEMORY = 5
SEC_GLOBAL = 6
SEC_EXPORT = 7
SEC_START = 8
SEC_ELEMENT = 9
SEC_CODE = 10
SEC_DATA = 11

PAGE_SIZE = 65536


class WasmDecodeError(Exception):
    pass


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise WasmDecodeError("unexpected end of module")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise WasmDecodeError("unexpected end of module")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        """Unsigned LEB128, max 5 bytes."""
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 32:
                raise WasmDecodeError("u32 LEB128 overflow")
        return result & 0xFFFFFFFF

    def s_leb(self, bits: int) -> int:
        """Signed LEB128."""
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                if shift < bits and (b & 0x40):
                    result |= -(1 << shift)
                break
            if shift > bits + 7:
                raise WasmDecodeError("signed LEB128 overflow")
        return result

    def i32(self) -> int:
        return self.s_leb(32)

    def i64(self) -> int:
        return self.s_leb(64)

    def f32(self) -> bytes:
        return self.raw(4)

    def f64(self) -> bytes:
        return self.raw(8)

    def name(self) -> str:
        n = self.u32()
        return self.raw(n).decode("utf-8")


@dataclass(frozen=True)
class FuncType:
    params: Tuple[int, ...]
    results: Tuple[int, ...]


@dataclass
class Import:
    module: str
    name: str
    kind: int  # 0 func, 1 table, 2 mem, 3 global
    type_idx: int = 0  # for funcs
    desc: tuple = ()


@dataclass
class Export:
    name: str
    kind: int
    index: int


@dataclass
class Global:
    valtype: int
    mutable: bool
    init: List[tuple]  # decoded init expression


@dataclass
class Function:
    type_idx: int
    locals: List[int] = field(default_factory=list)  # flattened local valtypes
    body: List[tuple] = field(default_factory=list)  # decoded instructions


@dataclass
class DataSegment:
    mem_idx: int
    offset_expr: List[tuple]
    data: bytes


@dataclass
class ElementSegment:
    table_idx: int
    offset_expr: List[tuple]
    func_indices: List[int]


@dataclass
class Module:
    types: List[FuncType] = field(default_factory=list)
    imports: List[Import] = field(default_factory=list)
    functions: List[Function] = field(default_factory=list)  # local funcs only
    func_type_indices: List[int] = field(default_factory=list)
    tables: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    mem_limits: Optional[Tuple[int, Optional[int]]] = None
    globals: List[Global] = field(default_factory=list)
    exports: List[Export] = field(default_factory=list)
    start: Optional[int] = None
    elements: List[ElementSegment] = field(default_factory=list)
    data: List[DataSegment] = field(default_factory=list)

    @property
    def num_imported_funcs(self) -> int:
        return sum(1 for im in self.imports if im.kind == 0)

    def export_map(self) -> Dict[str, Export]:
        return {e.name: e for e in self.exports}

    def func_type(self, func_idx: int) -> FuncType:
        n_imp = self.num_imported_funcs
        if func_idx < n_imp:
            imps = [im for im in self.imports if im.kind == 0]
            return self.types[imps[func_idx].type_idx]
        return self.types[self.functions[func_idx - n_imp].type_idx]


# ---------------------------------------------------------------------------
# instruction decoding
# ---------------------------------------------------------------------------

# opcodes with no immediates — everything in 0x45..0xc4 plus misc
_NO_IMM = set(range(0x45, 0xC5)) | {0x00, 0x01, 0x05, 0x0B, 0x0F, 0x1A, 0x1B}


def _decode_expr(r: _Reader) -> List[tuple]:
    """Decode an instruction sequence up to (and including) the matching
    `end` of the implicit outer block. Control-flow instructions get their
    branch targets resolved in a second pass (interpreter-side sidetable).
    Each instruction is a tuple (opcode, *immediates)."""
    out: List[tuple] = []
    depth = 1
    while depth > 0:
        op = r.byte()
        if op in _NO_IMM:
            if op == 0x0B:
                depth -= 1
            elif op == 0x05:
                pass  # else — handled structurally later
            out.append((op,))
        elif op in (0x02, 0x03, 0x04):  # block / loop / if
            bt = r.byte()
            if bt != BLOCK_EMPTY and bt not in VALTYPES:
                raise WasmDecodeError(f"bad blocktype 0x{bt:02x}")
            depth += 1
            out.append((op, bt))
        elif op in (0x0C, 0x0D):  # br / br_if
            out.append((op, r.u32()))
        elif op == 0x0E:  # br_table
            n = r.u32()
            targets = tuple(r.u32() for _ in range(n))
            default = r.u32()
            out.append((op, targets, default))
        elif op == 0x10:  # call
            out.append((op, r.u32()))
        elif op == 0x11:  # call_indirect
            type_idx = r.u32()
            table_idx = r.u32()
            out.append((op, type_idx, table_idx))
        elif op in (0x20, 0x21, 0x22, 0x23, 0x24):  # local/global
            out.append((op, r.u32()))
        elif 0x28 <= op <= 0x3E:  # loads/stores: align + offset
            align = r.u32()
            offset = r.u32()
            out.append((op, align, offset))
        elif op in (0x3F, 0x40):  # memory.size / memory.grow
            r.byte()  # reserved 0x00
            out.append((op,))
        elif op == 0x41:
            out.append((op, r.i32()))
        elif op == 0x42:
            out.append((op, r.i64()))
        elif op == 0x43:
            out.append((op, r.f32()))
        elif op == 0x44:
            out.append((op, r.f64()))
        elif op == 0xFC:  # saturating truncations / bulk memory subset
            sub = r.u32()
            if sub <= 7:
                out.append((op, sub))
            elif sub == 10:  # memory.copy
                r.byte()
                r.byte()
                out.append((op, sub))
            elif sub == 11:  # memory.fill
                r.byte()
                out.append((op, sub))
            else:
                raise WasmDecodeError(f"unsupported 0xfc subopcode {sub}")
        else:
            raise WasmDecodeError(f"unsupported opcode 0x{op:02x}")
    return out


def _decode_limits(r: _Reader) -> Tuple[int, Optional[int]]:
    flag = r.byte()
    lo = r.u32()
    hi = r.u32() if flag & 1 else None
    return lo, hi


def decode_module(data: bytes) -> Module:
    if data[:4] != WASM_MAGIC:
        raise WasmDecodeError("bad magic")
    if data[4:8] != WASM_VERSION:
        raise WasmDecodeError("unsupported version")
    r = _Reader(data, 8)
    m = Module()
    last_sec = -1
    while not r.eof():
        sec = r.byte()
        size = r.u32()
        body = _Reader(r.raw(size))
        if sec != SEC_CUSTOM:
            if sec <= last_sec:
                raise WasmDecodeError(f"section {sec} out of order")
            last_sec = sec
        if sec == SEC_CUSTOM:
            continue
        elif sec == SEC_TYPE:
            for _ in range(body.u32()):
                if body.byte() != 0x60:
                    raise WasmDecodeError("bad functype tag")
                params = tuple(body.byte() for _ in range(body.u32()))
                results = tuple(body.byte() for _ in range(body.u32()))
                if len(results) > 1:
                    raise WasmDecodeError("multi-value not supported")
                m.types.append(FuncType(params, results))
        elif sec == SEC_IMPORT:
            for _ in range(body.u32()):
                mod = body.name()
                name = body.name()
                kind = body.byte()
                if kind == 0:
                    m.imports.append(Import(mod, name, 0, body.u32()))
                elif kind == 1:
                    if body.byte() != FUNCREF:
                        raise WasmDecodeError("bad table elemtype")
                    m.imports.append(Import(mod, name, 1, desc=_decode_limits(body)))
                elif kind == 2:
                    m.imports.append(Import(mod, name, 2, desc=_decode_limits(body)))
                elif kind == 3:
                    vt = body.byte()
                    mut = body.byte()
                    m.imports.append(Import(mod, name, 3, desc=(vt, mut)))
                else:
                    raise WasmDecodeError("bad import kind")
        elif sec == SEC_FUNCTION:
            m.func_type_indices = [body.u32() for _ in range(body.u32())]
        elif sec == SEC_TABLE:
            for _ in range(body.u32()):
                if body.byte() != FUNCREF:
                    raise WasmDecodeError("bad table elemtype")
                m.tables.append(_decode_limits(body))
        elif sec == SEC_MEMORY:
            n = body.u32()
            if n > 1:
                raise WasmDecodeError("multiple memories")
            if n:
                m.mem_limits = _decode_limits(body)
        elif sec == SEC_GLOBAL:
            for _ in range(body.u32()):
                vt = body.byte()
                mut = body.byte() == 1
                init = _decode_expr(body)
                m.globals.append(Global(vt, mut, init))
        elif sec == SEC_EXPORT:
            for _ in range(body.u32()):
                name = body.name()
                kind = body.byte()
                m.exports.append(Export(name, kind, body.u32()))
        elif sec == SEC_START:
            m.start = body.u32()
        elif sec == SEC_ELEMENT:
            for _ in range(body.u32()):
                tbl = body.u32()
                off = _decode_expr(body)
                funcs = [body.u32() for _ in range(body.u32())]
                m.elements.append(ElementSegment(tbl, off, funcs))
        elif sec == SEC_CODE:
            n = body.u32()
            if n != len(m.func_type_indices):
                raise WasmDecodeError("code/function count mismatch")
            for i in range(n):
                fsize = body.u32()
                fr = _Reader(body.raw(fsize))
                locals_: List[int] = []
                for _ in range(fr.u32()):
                    cnt = fr.u32()
                    vt = fr.byte()
                    if vt not in VALTYPES:
                        raise WasmDecodeError("bad local type")
                    # total cap per function, not per declaration group — a
                    # tiny module can otherwise declare ~10^11 locals via
                    # repeated groups and exhaust memory at decode time
                    if cnt + len(locals_) > 50_000:
                        raise WasmDecodeError("too many locals")
                    locals_.extend([vt] * cnt)
                fn = Function(m.func_type_indices[i], locals_, _decode_expr(fr))
                m.functions.append(fn)
        elif sec == SEC_DATA:
            for _ in range(body.u32()):
                mem = body.u32()
                off = _decode_expr(body)
                seg = body.raw(body.u32())
                m.data.append(DataSegment(mem, off, seg))
        else:
            raise WasmDecodeError(f"unknown section {sec}")
    if m.func_type_indices and len(m.functions) != len(m.func_type_indices):
        raise WasmDecodeError("missing code section")
    return m
