"""Shared helpers of the execution tests (tests/test_torch_vm.py,
test_torch_execution.py, test_torch_block_manager.py,
test_torch_exec_crash.py): the two packages' execution modules side by
side, seeded accounts and transactions made in either package, the
process-wide state both packages keep (hardfork heights, cycle
parameters, the emulate memo, the decoded-module cache) reset between
cases, and a store's rows for row-by-row comparison.

The port's block managers run with `device="cpu"`; the transactions of a
block are warmed on the host first (`stx.sender`, the native library),
so that no test pays the plain kernels' recovery unless it asks for it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import random
from types import SimpleNamespace

import chip_smoke

_MODULES = {
    "types": "core.types",
    "execution": "core.execution",
    "system_contracts": "core.system_contracts",
    "hardforks": "core.hardforks",
    "parallel_exec": "core.parallel_exec",
    "block_manager": "core.block_manager",
    "tx_pool": "core.tx_pool",
    "block_producer": "core.block_producer",
    "ecdsa": "crypto.ecdsa",
    "kv": "storage.kv",
    "state": "storage.state",
    "fsck": "storage.fsck",
    "crashpoints": "storage.crashpoints",
    "crash_workload": "storage.crash_workload",
    "serialization": "utils.serialization",
    "bloom": "utils.bloom",
    "wasm": "vm.wasm",
    "interpreter": "vm.interpreter",
    "translate": "vm.translate",
    "builder": "vm.builder",
    "abi": "vm.abi",
    "vm": "vm.vm",
}


def _package(root: str, name: str) -> SimpleNamespace:
    ns = SimpleNamespace(name=name, root=root)
    for attr, mod in _MODULES.items():
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX = _package("lachain_tpu", "jax")
PORT = _package("lachain_tpu_torch", "port")
PKGS = (JAX, PORT)

CHAIN = 225


def reset_module_state() -> None:
    """Set back what both packages keep process-wide."""
    for p in PKGS:
        p.hardforks.reset_for_tests()
        p.system_contracts.set_cycle_params(1000, 500, 100)
        p.block_manager._EMULATE_MEMO.clear()
        p.vm._MODULE_CACHE = None
        p.crashpoints.disarm()


class Rng:
    """The `randbelow` object both packages' key generation draws from."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def account(seed: int):
    """(private key, address) of a seeded key: the same in both packages."""
    priv = PORT.ecdsa.generate_private_key(Rng(seed))
    addr = PORT.ecdsa.address_from_public_key(PORT.ecdsa.public_key_bytes(priv))
    return priv, addr


def signed(pkg, priv, to, value, nonce, gas_price=1, gas_limit=100_000,
           invocation=b"", chain=CHAIN):
    tx = pkg.types.Transaction(to=to, value=value, nonce=nonce, gas_price=gas_price,
                               gas_limit=gas_limit, invocation=invocation)
    return pkg.types.sign_transaction(tx, priv, chain)


def warm(txs, chain=CHAIN) -> None:
    """Recover every sender on the host (the native library): the caches
    the node's bulk ingest would have filled."""
    for stx in txs:
        stx.sender(chain)


def block_manager(pkg, kv, state, executer, lanes=1):
    if pkg is PORT:
        return pkg.block_manager.BlockManager(kv, state, executer, lanes=lanes, device="cpu")
    return pkg.block_manager.BlockManager(kv, state, executer, lanes=lanes)


def rows(kv) -> list:
    return sorted(kv.scan_prefix(b""))


def counter_contract(pkg) -> bytes:
    """chip_smoke.py's counter (the JAX package's tests/test_vm.py:269),
    assembled by `pkg`'s builder."""
    return chip_smoke.counter_contract(pkg.builder, pkg.abi)


def proxy_contract(pkg) -> bytes:
    """chip_smoke.py's proxy (the JAX package's tests/test_vm.py:309)."""
    return chip_smoke.proxy_contract(pkg.builder)


@contextlib.contextmanager
def gc_held():
    """Collect garbage, then hold the collector off while the JAX
    package's LsmKV is open: a collection inside its locked section can
    finalize an object (a native runtime an earlier test file of the same
    worker left in a cycle) whose close drains that LsmKV's trace and
    waits on the lock its own thread holds (ROADMAP C, `_drain_trace`)."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
