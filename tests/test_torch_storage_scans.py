"""The deep fsck (`storage/fsck.py` `_deep_trie_check`) and DbShrink
(`storage/shrink.py`) read the trie nodes and the mark rows by prefix
scans, not by one `get` a node as the JAX package does: held to the JAX
package's reports, stats and rows through a KV that counts its calls, on
the port's MemoryKV and LsmKV (the JAX package's on its MemoryKV), over a
clean store and over one with an interior trie node missing."""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from lachain_tpu.storage import fsck as jfsck
from lachain_tpu.storage import kv as jkv
from lachain_tpu.storage import shrink as jshrink
from lachain_tpu.storage import state as jstate
from lachain_tpu_torch.core import types
from lachain_tpu_torch.storage.fsck import fsck
from lachain_tpu_torch.storage.kv import EntryPrefix, MemoryKV, prefixed
from lachain_tpu_torch.storage.lsm import LsmKV
from lachain_tpu_torch.storage.shrink import DbShrink
from lachain_tpu_torch.storage.state import StateManager
from lachain_tpu_torch.storage.trie import EMPTY_ROOT, InternalNode, _decode

torch.set_num_threads(1)

TIP = 3
NODE = prefixed(EntryPrefix.TRIE_NODE)


class Counting:
    """A KV whose get and scan_prefix calls are counted."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gets = self.scans = 0

    def get(self, key):
        self.gets += 1
        return super().get(key)

    def scan_prefix(self, prefix):
        self.scans += 1
        return super().scan_prefix(prefix)


class CountingMemoryKV(Counting, MemoryKV):
    pass


class CountingLsmKV(Counting, LsmKV):
    pass


class CountingJaxKV(Counting, jkv.MemoryKV):
    pass


@pytest.fixture(scope="module")
def chain_rows():
    """A 4-height chain of the state_commit harness (300 accounts, 40
    transfers a block)."""
    inp = chip_smoke.state_inputs(5, 300, 8, TIP, 40)
    kv = MemoryKV()
    sm = StateManager(kv)
    balances = dict(inp["balances"])
    block, _ = chip_smoke.commit_block(sm, kv, 0, types.ZERO_HASH, [],
                                       chip_smoke.genesis_writes(balances))
    for height, stxs in enumerate(inp["blocks"], start=1):
        writes = chip_smoke.transfer_writes(balances, stxs)
        block, _ = chip_smoke.commit_block(sm, kv, height, block.hash(), stxs, writes)
    return list(kv.scan_prefix(b""))


def interior_hole(rows) -> bytes:
    """The key of an internal node below the tip's first state root."""
    kv = MemoryKV()
    kv.write_batch(list(rows))
    root = next(r for r in StateManager(kv).roots_at(TIP).all_roots() if r != EMPTY_ROOT)
    node = _decode(kv.get(NODE + root))
    assert isinstance(node, InternalNode)
    child = next(c for c in node.children if c != EMPTY_ROOT)
    return NODE + child


def stores(kind, rows, tmp_path, hole):
    port = CountingLsmKV(str(tmp_path / "lsm")) if kind == "lsm" else CountingMemoryKV()
    jax = CountingJaxKV()
    for kv in (port, jax):
        kv.write_batch(list(rows))
        if hole:
            kv.delete(interior_hole(rows))
        kv.gets = kv.scans = 0
    return port, jax


def nodes(rows) -> int:
    return sum(k.startswith(NODE) for k, _ in rows)


@pytest.mark.parametrize("hole", [False, True], ids=["clean", "interior-hole"])
@pytest.mark.parametrize("kind", ["memory", "lsm"])
def test_deep_fsck_by_one_scan(chain_rows, tmp_path, kind, hole):
    port, jax = stores(kind, chain_rows, tmp_path, hole)
    report = fsck(port, repair=False, deep=True).to_dict()
    assert report == jfsck.fsck(jax, repair=False, deep=True).to_dict()
    assert report["clean"] != hole
    n = nodes(chain_rows)
    assert n > 300 and jax.gets > n // 2  # the JAX package reads one get a node
    assert port.gets < 40 and port.scans >= 1, (port.gets, port.scans)
    if kind == "lsm":
        port.close()


@pytest.mark.parametrize("kind", ["memory", "lsm"])
def test_shrink_by_scans(chain_rows, tmp_path, kind):
    port, jax = stores(kind, chain_rows, tmp_path, False)
    stats = DbShrink(StateManager(port), port).shrink(retain_depth=1)
    port_gets = port.gets
    jstats = jshrink.DbShrink(jstate.StateManager(jax), jax).shrink(retain_depth=1)
    assert stats == jstats and stats["swept"] > 0 and stats["cutoff"] == TIP - 1
    assert list(port.scan_prefix(b"")) == list(jax.scan_prefix(b""))
    n = nodes(chain_rows)
    assert jax.gets > n and port_gets < 40, (port_gets, jax.gets)
    report = fsck(port, repair=False, deep=True).to_dict()
    assert report["clean"] and report == jfsck.fsck(jax, repair=False, deep=True).to_dict()
    if kind == "lsm":
        port.close()


def test_shrink_marks_a_node_the_scan_lacks(chain_rows):
    """A node missing from the store is still loaded through the trie's
    cache, as the JAX package's walk loads it, and the marks are the same."""
    port, jax = stores("memory", chain_rows, None, False)
    sm, jsm = StateManager(port), jstate.StateManager(jax)
    hole = interior_hole(chain_rows)
    for manager in (sm, jsm):
        manager.trie._load(hole[len(NODE):])  # in the trie's cache now
    for kv in (port, jax):
        kv.delete(hole)
    stats = DbShrink(sm, port).shrink(retain_depth=1)
    assert stats == jshrink.DbShrink(jsm, jax).shrink(retain_depth=1)
    assert list(port.scan_prefix(b"")) == list(jax.scan_prefix(b""))
