"""The port's WASM VM (lachain_tpu_torch/vm/) against the JAX package's, on
the CPU.

The modules of the JAX package's tests/test_vm.py, each assembled by both
packages' `vm/builder.py` (the bytes must be equal), run in both packages'
`Instance` on both tiers (the translator, and the interpreter pinned by
`LACHAIN_TPU_WASM=interp` under monkeypatch): every call's result or trap,
the gas spent after it, the memory, the globals and the host calls must
be equal across the four runs. The contract cases (deploy, counter, proxy,
bad selector, out of gas, static calls, malformed bytecode, value and gas
caps of nested calls) run through both packages' executer or
`VirtualMachine` on a MemoryKV state: receipts, invocation results and the
committed rows must be equal. Then the hardfork gas cases of the JAX
package's tests/test_hardforks_gas.py, and the decoder's and the meter's
guards. ~10 s on one core.
"""
from __future__ import annotations

import hashlib

import pytest
import torch

from lachain_tpu_torch.vm.interpreter import INSTRUCTION_GAS
from tests.torch_exec_common import (
    CHAIN,
    JAX,
    PKGS,
    PORT,
    account,
    counter_contract,
    proxy_contract,
    reset_module_state,
    signed,
)

torch.set_num_threads(1)

TIERS = ("translate", "interp")


@pytest.fixture(autouse=True)
def _reset():
    reset_module_state()
    yield
    reset_module_state()


def _tier(monkeypatch, tier):
    if tier == "interp":
        monkeypatch.setenv("LACHAIN_TPU_WASM", "interp")
    else:
        monkeypatch.delenv("LACHAIN_TPU_WASM", raising=False)


# -- the interpreter-level modules of tests/test_vm.py -------------------------
# each case: (pkg) -> (ModuleBuilder, [(export, args)], host import names, gas)


def m_add(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_function([I32, I32], [I32], [], [Op.local_get(0), Op.local_get(1), Op.i32_add],
                   export="add")
    return b, [("add", [2, 3]), ("add", [0xFFFFFFFF, 1])]


def m_loop_sum(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    body = [
        Op.block(), Op.loop(),
        Op.local_get(0), Op.i32_eqz, Op.br_if(1),
        Op.local_get(1), Op.local_get(0), Op.i32_add, Op.local_set(1),
        Op.local_get(0), Op.i32_const(1), Op.i32_sub, Op.local_set(0),
        Op.br(0),
        Op.end, Op.end,
        Op.local_get(1),
    ]
    b.add_function([I32], [I32], [I32], body, export="sum")
    return b, [("sum", [10]), ("sum", [0]), ("sum", [1000])]


def m_if_select(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_function([I32], [I32], [], [Op.local_get(0), Op.if_(I32), Op.i32_const(111),
                                      Op.else_, Op.i32_const(222), Op.end], export="pick")
    b.add_function([I32], [I32], [], [Op.i32_const(7), Op.i32_const(9), Op.local_get(0),
                                      Op.select], export="sel")
    return b, [("pick", [1]), ("pick", [0]), ("sel", [1]), ("sel", [0])]


def m_br_table(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    body = [
        Op.block(), Op.block(), Op.block(),
        Op.local_get(0), Op.br_table([0, 1], 2),
        Op.end, Op.i32_const(100), Op.return_,
        Op.end, Op.i32_const(200), Op.return_,
        Op.end, Op.i32_const(300),
    ]
    b.add_function([I32], [I32], [], body, export="route")
    return b, [("route", [a]) for a in (0, 1, 2, 99)]


def m_memory(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_memory(1)
    b.add_data(16, b"\x2a\x00\x00\x00")
    b.add_function([I32], [I32], [], [Op.local_get(0), Op.i32_load()], export="peek")
    b.add_function([I32, I32], [], [], [Op.local_get(0), Op.local_get(1), Op.i32_store()],
                   export="poke")
    return b, [("peek", [16]), ("poke", [100, 0xDEADBEEF]), ("peek", [100]),
               ("peek", [65536])]


def m_memory_grow(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_memory(1, 4)
    b.add_function([], [I32], [], [Op.memory_size], export="size")
    b.add_function([I32], [I32], [], [Op.local_get(0), Op.memory_grow], export="grow")
    return b, [("size", []), ("grow", [2]), ("size", []), ("grow", [5])]


def m_call_indirect(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    dbl = b.add_function([I32], [I32], [], [Op.local_get(0), Op.i32_const(2), Op.i32_mul])
    tri = b.add_function([I32], [I32], [], [Op.local_get(0), Op.i32_const(3), Op.i32_mul])
    b.add_function([I32], [I32], [], [Op.local_get(0), Op.call(dbl)], export="twice")
    ti = b.type_idx([I32], [I32])
    b.add_function([I32, I32], [I32], [],
                   [Op.local_get(0), Op.local_get(1), Op.call_indirect(ti)], export="apply")
    b.add_table_funcs([dbl, tri])
    return b, [("twice", [21]), ("apply", [10, 0]), ("apply", [10, 1]), ("apply", [10, 7])]


def m_globals(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    g = b.add_global(I32, True, [Op.i32_const(5)])
    b.add_function([], [I32], [], [Op.global_get(g)], export="get")
    b.add_function([I32], [], [], [Op.local_get(0), Op.global_set(g)], export="set")
    return b, [("get", []), ("set", [77]), ("get", [])]


def m_i64_bits(p):
    B, Op, I32, I64 = p.builder, p.builder.Op, p.builder.I32, p.builder.I64
    b = B.ModuleBuilder()
    b.add_function([I64, I64], [I64], [], [Op.local_get(0), Op.local_get(1), Op.i64_mul],
                   export="mul64")
    b.add_function([I32], [I32], [], [Op.local_get(0), b"\x69"], export="popcnt")
    b.add_function([I32], [I32], [], [Op.local_get(0), b"\x67"], export="clz")
    b.add_function([I32, I32], [I32], [], [Op.local_get(0), Op.local_get(1), b"\x77"],
                   export="rotl")
    return b, [("mul64", [1 << 40, 1 << 30]), ("popcnt", [0b1011]), ("clz", [1]),
               ("clz", [0]), ("rotl", [0x80000001, 1])]


def m_div_traps(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_function([I32, I32], [I32], [], [Op.local_get(0), Op.local_get(1), b"\x6d"],
                   export="div")
    return b, [("div", [7, 2]), ("div", [0xFFFFFFF9, 2]), ("div", [1, 0]),
               ("div", [0x80000000, 0xFFFFFFFF])]


def m_unreachable(p):
    B, Op = p.builder, p.builder.Op
    b = B.ModuleBuilder()
    b.add_function([], [], [], [Op.unreachable], export="boom")
    return b, [("boom", [])]


def m_gas_exhaustion(p):
    B, Op = p.builder, p.builder.Op
    b = B.ModuleBuilder()
    b.add_function([], [], [], [Op.loop(), Op.br(0), Op.end], export="spin")
    return b, [("spin", [])], (), 10_000


def m_host_import(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    fi = b.add_import("env", "note", [I32], [])
    b.add_function([I32], [], [], [Op.local_get(0), Op.call(fi), Op.i32_const(99),
                                   Op.call(fi)], export="run")
    return b, [("run", [5])], ("note",)


def m_float_nan(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_memory(1)
    body = [Op.i32_const(0), Op.i32_const(0x7FA0BEEF - (1 << 32)), Op.i32_store(),
            Op.i32_const(0), bytes([0x2A, 0x02, 0x00]), bytes([0xBC])]
    b.add_function([], [I32], [], body, export="f")
    return b, [("f", [])]


def m_diff_nested(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    body = [
        Op.block(), Op.block(), Op.block(),
        Op.local_get(0), Op.br_table([0, 1], 2),
        Op.end, Op.i32_const(100), Op.return_,
        Op.end, Op.i32_const(200), Op.return_,
        Op.end, Op.i32_const(77), Op.local_get(1), Op.i32_div_u,
    ]
    b.add_function([I32, I32], [I32], [], body, export="f")
    return b, [("f", [0, 1]), ("f", [1, 1]), ("f", [2, 7]), ("f", [9, 0])]


def m_diff_i64_loop(p):
    B, Op, I32, I64 = p.builder, p.builder.Op, p.builder.I32, p.builder.I64
    b = B.ModuleBuilder()
    body = [
        Op.block(), Op.loop(),
        Op.local_get(0), Op.i32_eqz, Op.br_if(1),
        Op.local_get(1), Op.local_get(0), Op.i64_extend_i32_u, Op.i64_add, Op.local_set(1),
        Op.local_get(0), Op.i32_const(1), Op.i32_sub, Op.local_set(0),
        Op.br(0),
        Op.end, Op.end,
        Op.local_get(1),
    ]
    b.add_function([I32], [I64], [I64], body, export="f")
    return b, [("f", [100]), ("f", [0])]


def m_diff_if_return(p):
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    b.add_function([I32], [I32], [], [Op.local_get(0), Op.if_(), Op.i32_const(1), Op.return_,
                                      Op.end, Op.i32_const(2)], export="f")
    return b, [("f", [1]), ("f", [0])]


def m_squares_loop(p):
    """The translator speed test's loop, at a small n."""
    B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
    b = B.ModuleBuilder()
    body = [
        Op.block(), Op.loop(),
        Op.local_get(0), Op.i32_eqz, Op.br_if(1),
        Op.local_get(1), Op.local_get(0), Op.local_get(0), Op.i32_mul, Op.i32_add,
        Op.local_set(1),
        Op.local_get(0), Op.i32_const(1), Op.i32_sub, Op.local_set(0),
        Op.br(0),
        Op.end, Op.end,
        Op.local_get(1),
    ]
    b.add_function([I32], [I32], [I32], body, export="f")
    return b, [("f", [2000])], (), 10**9


MODULE_CASES = [m_add, m_loop_sum, m_if_select, m_br_table, m_memory, m_memory_grow,
                m_call_indirect, m_globals, m_i64_bits, m_div_traps, m_unreachable,
                m_gas_exhaustion, m_host_import, m_float_nan, m_diff_nested,
                m_diff_i64_loop, m_diff_if_return, m_squares_loop]


def run_module(p, case):
    """One package's run of a case -> (module bytes, [observations])."""
    out = case(p)
    b, calls = out[0], out[1]
    imports = out[2] if len(out) > 2 else ()
    limit = out[3] if len(out) > 3 else None
    code = b.build()
    log = []
    host = {("env", name): (lambda *a, name=name: log.append((name, a))) for name in imports}
    gas = p.interpreter.GasMeter(limit) if limit is not None else None
    inst = p.interpreter.Instance(p.wasm.decode_module(code), host=host, gas=gas)
    seen = []
    for export, args in calls:
        try:
            res = ("ok", inst.invoke(export, list(args)))
        except p.interpreter.WasmTrap as e:
            res = ("trap", type(e).__name__, str(e))
        seen.append((res, inst.gas.spent))
    seen.append(("memory", hashlib.sha256(bytes(inst.memory)).hexdigest(), inst.mem_pages,
                 list(inst.globals), list(log)))
    return code, seen


# The JAX package's interpreter jumps past the `end` of an `if` without
# `else` when the condition is false, and so bills one instruction less
# there than its translator does: a fault of the reference (ROADMAP C),
# which the port keeps, tier for tier, so that both packages bill alike.
TIER_GAS_GAP = {"m_diff_if_return": [0, INSTRUCTION_GAS]}


@pytest.mark.parametrize("case", MODULE_CASES, ids=lambda c: c.__name__[2:])
def test_modules_equal_across_packages_and_tiers(monkeypatch, case):
    runs = {}
    for tier in TIERS:
        _tier(monkeypatch, tier)
        for p in PKGS:
            runs[(p.name, tier)] = run_module(p, case)
    codes = {k: v[0] for k, v in runs.items()}
    assert len(set(codes.values())) == 1, "the builders' bytes differ"
    for tier in TIERS:
        assert runs[("port", tier)][1] == runs[("jax", tier)][1], tier
    fast, interp = runs[("port", "translate")][1], runs[("port", "interp")][1]
    assert [r for r, _ in fast[:-1]] == [r for r, _ in interp[:-1]]
    assert fast[-1] == interp[-1]
    gaps = [a - b for (_, a), (_, b) in zip(fast[:-1], interp[:-1])]
    steps = [gaps[0]] + [b - a for a, b in zip(gaps, gaps[1:])]
    assert steps == TIER_GAS_GAP.get(case.__name__, [0] * len(steps))


def test_module_expected_values():
    """A few of tests/test_vm.py's values, on the port's translator."""
    assert [r for r, _ in run_module(PORT, m_loop_sum)[1][:3]] == [
        ("ok", 55), ("ok", 0), ("ok", 500500)]
    assert run_module(PORT, m_float_nan)[1][0][0] == ("ok", 0x7FC00000)
    assert run_module(PORT, m_memory_grow)[1][3][0] == ("ok", 0xFFFFFFFF)
    spin = run_module(PORT, m_gas_exhaustion)[1][0]
    assert spin == (("trap", "OutOfGas", "out of gas (limit 10000)"), 10_000)


def test_translated_and_interpreted_tiers_differ_only_in_engine(monkeypatch):
    """The translator compiles the loop; the interpreter runs the same
    decoded function when pinned, at the same gas."""
    mod = PORT.wasm.decode_module(m_squares_loop(PORT)[0].build())
    compiled = PORT.translate.translate_function(mod, mod.functions[0], mod.types[0])
    assert compiled is not None and "while True" in compiled._src
    monkeypatch.setenv("LACHAIN_TPU_WASM", "interp")
    inst = PORT.interpreter.Instance(mod)
    assert inst._compiled_for(mod.functions[0], mod.types[0]) is False
    assert mod.functions[0]._gas_rate == PORT.interpreter.INSTRUCTION_GAS


# -- the decoder's and the meter's guards ------------------------------------------


def test_gas_meter_clamps_spent_to_limit():
    for p in PKGS:
        g = p.interpreter.GasMeter(1000)
        g.charge(900)
        with pytest.raises(p.interpreter.OutOfGas):
            g.charge(10**12)
        assert g.spent == 1000 and g.remaining == 0


def _many_locals(p) -> bytes:
    B, Op = p.builder, p.builder.Op
    b = B.ModuleBuilder()
    b.add_function([], [], [], [Op.end], export="f")
    raw = bytearray(b.build())
    groups = 200
    body = B.uleb(groups) + (B.uleb(40_000) + bytes([0x7F])) * groups + b"\x0b"
    code_sec = B.uleb(1) + B.uleb(len(body)) + body
    i, out = 8, bytearray(raw[:8])
    while i < len(raw):
        sec_id, j, size, shift = raw[i], i + 1, 0, 0
        while True:
            byte = raw[j]
            j += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if sec_id == 10:
            out += bytes([10]) + B.uleb(len(code_sec)) + code_sec
        else:
            out += raw[i:j + size]
        i = j + size
    return bytes(out)


def test_locals_total_cap_is_per_function():
    blobs = [_many_locals(p) for p in PKGS]
    assert blobs[0] == blobs[1]
    for p in PKGS:
        with pytest.raises(p.wasm.WasmDecodeError, match="too many locals"):
            p.wasm.decode_module(blobs[0])


def test_element_segment_table_cap():
    for p in PKGS:
        B, Op, I32 = p.builder, p.builder.Op, p.builder.I32
        b = B.ModuleBuilder()
        b.add_function([], [I32], [], [Op.i32_const(7)], export="f")
        m = p.wasm.decode_module(b.build())
        m.tables = [(1, None)]
        m.elements = [p.wasm.ElementSegment(
            0, [(0x41, p.interpreter.MAX_TABLE_SIZE + 5), (0x0B,)], [0])]
        with pytest.raises(p.interpreter.WasmTrap, match="table cap"):
            p.interpreter.Instance(m)


@pytest.mark.parametrize("blob", [b"", b"\x00asm", b"\x00asm\x02\x00\x00\x00", b"not wasm",
                                  b"\x00asm\x01\x00\x00\x00\x01\x04\x01\x61\x00\x00",
                                  b"\x00asm\x01\x00\x00\x00\x0c\x01\x00"])
def test_decoder_errors_equal(blob):
    errs = []
    for p in PKGS:
        try:
            p.wasm.decode_module(blob)
            errs.append(None)
        except (p.wasm.WasmDecodeError, IndexError) as e:
            errs.append((type(e).__name__, str(e)))
    assert errs[0] == errs[1]


def test_abi_roundtrip_equal():
    blobs = [p.abi.encode_call("foo(address,uint256,bytes)", b"\x11" * 20, 42, b"xyz")
             for p in PKGS]
    assert blobs[0] == blobs[1]
    r = PORT.abi.AbiReader(blobs[1], skip_selector=True)
    assert (r.address(), r.uint(), r.bytes_(), r.done()) == (b"\x11" * 20, 42, b"xyz", True)
    assert PORT.abi.method_selector("inc()") == JAX.abi.method_selector("inc()")


# -- the contract cases of tests/test_vm.py ------------------------------------------

DEPLOYER = account(7)


class Chain:
    """A MemoryKV state with the deployer funded, its snapshot, the
    executer, and the log of what every step returned."""

    def __init__(self, p):
        self.p = p
        self.kv = p.kv.MemoryKV()
        self.state = p.state.StateManager(self.kv)
        self.snap = self.state.new_snapshot()
        self.priv, self.addr = DEPLOYER
        p.execution.set_balance(self.snap, self.addr, 10**24)
        self.executer = p.system_contracts.make_executer(CHAIN)
        self.nonce = 0
        self.log = []

    def tx(self, to, invocation, gas_limit=10**12, value=0, block=1):
        stx = signed(self.p, self.priv, to, value, self.nonce, gas_limit=gas_limit,
                     invocation=invocation)
        self.nonce += 1
        res = self.executer.execute(self.snap, stx, block, 0)
        self.log.append(("tx", res.ok, res.receipt.encode()))
        return res

    def deploy(self, code):
        sc = self.p.system_contracts
        from_ser = self.p.serialization.write_bytes
        return self.tx(sc.DEPLOY_ADDRESS, sc.SEL_DEPLOY + from_ser(code))

    def vm_call(self, contract, inp, gas_limit=10**12, static=False):
        machine = self.p.vm.VirtualMachine(self.snap, block_index=1, origin=self.addr,
                                           gas_price=1, chain_id=CHAIN)
        res = machine.invoke_contract(contract=contract, sender=self.addr, value=0,
                                      input=inp, gas_limit=gas_limit, static=static)
        self.log.append(("vm", res.status, res.gas_used, res.return_data, res.events))
        return res

    def finish(self):
        roots = self.snap.freeze()
        self.state.commit(1, roots)
        return self.log, roots.state_hash(), sorted(self.kv.scan_prefix(b""))


def c_counter(c):
    sel_inc, sel_get = c.p.abi.method_selector("inc()"), c.p.abi.method_selector("get()")
    caddr = c.deploy(counter_contract(c.p)).receipt.return_data
    assert c.p.vm.get_code(c.snap, caddr) == counter_contract(c.p)
    for i in range(3):
        assert int.from_bytes(c.tx(caddr, sel_inc).receipt.return_data, "little") == i + 1
    res = c.tx(caddr, sel_get)
    assert int.from_bytes(res.receipt.return_data, "little") == 3
    assert res.receipt.gas_used > c.p.execution.GAS_PER_TX


def c_proxy(c):
    sel_inc, sel_get = c.p.abi.method_selector("inc()"), c.p.abi.method_selector("get()")
    counter = c.deploy(counter_contract(c.p)).receipt.return_data
    proxy = c.deploy(proxy_contract(c.p)).receipt.return_data
    assert int.from_bytes(c.tx(proxy, counter + sel_inc).receipt.return_data, "little") == 1
    assert int.from_bytes(c.tx(counter, sel_get).receipt.return_data, "little") == 1
    # a child trap (bad selector) traps the proxy: status 0, nonce and gas paid
    assert not c.tx(proxy, counter + b"\xde\xad\xbe\xef").ok


def c_bad_selector(c):
    caddr = c.deploy(counter_contract(c.p)).receipt.return_data
    assert not c.tx(caddr, b"\xde\xad\xbe\xef").ok
    assert c.p.execution.get_nonce(c.snap, c.addr) == 2
    res = c.tx(caddr, c.p.abi.method_selector("get()"))
    assert int.from_bytes(res.receipt.return_data, "little") == 0


def c_out_of_gas(c):
    caddr = c.deploy(counter_contract(c.p)).receipt.return_data
    res = c.tx(caddr, c.p.abi.method_selector("inc()"),
               gas_limit=c.p.execution.GAS_PER_TX + 50_000)
    assert not res.ok and res.receipt.gas_used == c.p.execution.GAS_PER_TX + 50_000


def c_non_wasm(c):
    assert not c.deploy(b"not wasm").ok


def c_static(c):
    status, caddr = c.p.vm.deploy_code(c.snap, c.addr, 0, counter_contract(c.p))
    assert status == 1
    assert c.vm_call(caddr, c.p.abi.method_selector("inc()"), static=True).status == 0
    assert c.vm_call(caddr, c.p.abi.method_selector("get()"), static=True).status == 1


def c_malformed(c):
    B, Op = c.p.builder, c.p.builder.Op
    b = B.ModuleBuilder()
    b.add_function([], [], [], [Op.drop], export="start")
    res = c.deploy(b.build())
    assert res.ok
    assert not c.tx(res.receipt.return_data, b"\x00" * 4).ok


def _caller(p, child, gas, tail):
    B, Op, I32, I64 = p.builder, p.builder.Op, p.builder.I32, p.builder.I64
    pb = B.ModuleBuilder()
    invoke = pb.add_import("env", "invoke_contract", [I32, I32, I32, I32, I64], [I32])
    set_ret = pb.add_import("env", "set_return", [I32, I32], [])
    pb.add_memory(1)
    pb.add_data(0, child)
    if tail == "value":
        pb.add_data(63, b"\x64")
        body = [Op.i32_const(128),
                Op.i32_const(0), Op.i32_const(512), Op.i32_const(0), Op.i32_const(32),
                Op.i64_const(gas), Op.call(invoke),
                Op.i32_store(),
                Op.i32_const(128), Op.i32_const(4), Op.call(set_ret)]
    else:
        body = [Op.i32_const(0), Op.i32_const(512), Op.i32_const(0), Op.i32_const(32),
                Op.i64_const(gas), Op.call(invoke), Op.drop,
                Op.i32_const(128), Op.i32_const(42), Op.i32_store(),
                Op.i32_const(128), Op.i32_const(4), Op.call(set_ret)]
    pb.add_function([], [], [], body, export="start")
    return pb.build()


def c_nested_value_reverts(c):
    B, Op = c.p.builder, c.p.builder.Op
    cb = B.ModuleBuilder()
    cb.add_function([], [], [], [Op.unreachable], export="start")
    _, child = c.p.vm.deploy_code(c.snap, c.addr, 0, cb.build())
    _, parent = c.p.vm.deploy_code(c.snap, c.addr, 1, _caller(c.p, child, 0, "value"))
    c.p.execution.set_balance(c.snap, parent, 1000)
    res = c.vm_call(parent, b"\x00" * 4)
    assert res.status == 1 and int.from_bytes(res.return_data, "little") == 0
    assert c.p.execution.get_balance(c.snap, parent) == 1000
    assert c.p.execution.get_balance(c.snap, child) == 0


def c_nested_gas_cap(c):
    B, Op = c.p.builder, c.p.builder.Op
    cb = B.ModuleBuilder()
    cb.add_function([], [], [], [Op.loop(), Op.br(0), Op.end], export="start")
    _, child = c.p.vm.deploy_code(c.snap, c.addr, 0, cb.build())
    _, parent = c.p.vm.deploy_code(c.snap, c.addr, 1, _caller(c.p, child, 50_000, "gas"))
    res = c.vm_call(parent, b"\x00" * 4, gas_limit=10**9)
    assert res.status == 1 and int.from_bytes(res.return_data, "little") == 42


CONTRACT_CASES = [c_counter, c_proxy, c_bad_selector, c_out_of_gas, c_non_wasm, c_static,
                  c_malformed, c_nested_value_reverts, c_nested_gas_cap]


@pytest.mark.parametrize("case", CONTRACT_CASES, ids=lambda c: c.__name__[2:])
def test_contracts_equal_across_packages_and_tiers(monkeypatch, case):
    runs = {}
    for tier in TIERS:
        _tier(monkeypatch, tier)
        for p in PKGS:
            reset_module_state()
            c = Chain(p)
            case(c)
            runs[(p.name, tier)] = c.finish()
    # tier for tier (the tiers' bills differ where a contract takes the
    # false branch of an `if` without `else`: TIER_GAS_GAP)
    for tier in TIERS:
        ref, got = runs[("jax", tier)], runs[("port", tier)]
        assert got[0] == ref[0], tier  # receipts and invocation results
        assert got[1] == ref[1], tier  # state hash
        assert got[2] == ref[2], tier  # every committed row


# -- the hardfork gas cases of tests/test_hardforks_gas.py ------------------------------


def _invoke_gas(p, block_index):
    c = Chain(p)
    sel_inc = p.abi.method_selector("inc()")
    caddr = c.deploy(counter_contract(p)).receipt.return_data
    assert c.tx(caddr, sel_inc).ok
    res = c.tx(caddr, sel_inc, block=block_index)
    assert res.ok
    return res.receipt.gas_used


@pytest.mark.parametrize("tier", TIERS)
def test_hardfork_boundary_gas_equal(monkeypatch, tier):
    _tier(monkeypatch, tier)
    got = {}
    for p in PKGS:
        p.hardforks.set_hardfork_heights({"fast_wasm_gas": 100})
        got[p.name] = [_invoke_gas(p, h) for h in (99, 100, 101)]
    assert got["port"] == got["jax"]
    pre, at, post = got["port"]
    assert at == post and pre > at
    factor = PORT.interpreter.INTERP_INSTRUCTION_GAS // PORT.interpreter.INSTRUCTION_GAS
    step = (factor - 1) * PORT.interpreter.INSTRUCTION_GAS
    assert (pre - at) % step == 0 and (pre - at) // step > 10


def test_hardfork_billing_engine_invariant(monkeypatch):
    PORT.hardforks.set_hardfork_heights({"fast_wasm_gas": 100})
    monkeypatch.delenv("LACHAIN_TPU_WASM", raising=False)
    fast = [_invoke_gas(PORT, h) for h in (99, 101)]
    monkeypatch.setenv("LACHAIN_TPU_WASM", "interp")
    assert [_invoke_gas(PORT, h) for h in (99, 101)] == fast


def test_hardfork_defaults_and_one_shot():
    for p in PKGS:
        assert p.hardforks.is_active("fast_wasm_gas", 0)
        assert p.hardforks.activation_height("fast_wasm_gas") == 0
        p.hardforks.set_hardfork_heights({"boundary_finish_cycle": 5})
        with pytest.raises(RuntimeError):
            p.hardforks.set_hardfork_heights({"fast_wasm_gas": 1})
        with pytest.raises(ValueError):
            p.hardforks.set_hardfork_heights({"nope": 1}, force=True)
        assert not p.hardforks.is_active("boundary_finish_cycle", 4)
