"""The port's state snapshots (lachain_tpu_torch/storage/state.py) against
the JAX package's, on the CPU.

`StateRoots` bytes and state hash; a snapshot's reads, checkpoints,
restores and discard; `commit` and the streamed `freeze_and_commit`
(stream_threshold lowered) write the JAX package's KV rows, byte for byte,
on MemoryKV, SqliteKV and LsmKV; `roots_at`, `rollback_to` and
`committed_height` read them back. Then chip_smoke.py's state_commit_1m
harness (state_inputs, genesis_writes, transfer_writes, commit_block) at
2,000 accounts and two blocks of 200 transfers, the senders recovered on
the CPU (24 by warm_sender_caches on the plain kernels, the others by the
host library): both packages' StateManager over their own LsmKV give the
same roots and rows.
"""
from __future__ import annotations

import random

import pytest
import torch

import chip_smoke
from lachain_tpu.storage import kv as jkv
from lachain_tpu.storage import state as jstate
from lachain_tpu_torch.core import types
from lachain_tpu_torch.storage.fsck import fsck
from lachain_tpu_torch.storage.kv import MemoryKV, SqliteKV
from lachain_tpu_torch.storage.lsm import LsmKV
from lachain_tpu_torch.storage.state import (
    SUBTREES,
    Snapshot,
    StateManager,
    StateRoots,
)
from lachain_tpu_torch.storage.trie import EMPTY_ROOT
from tests.test_torch_lsm import jax_lsm  # noqa: F401  (a fixture)

torch.set_num_threads(1)

BACKENDS = ["memory", "sqlite", "lsm"]


def open_pair(backend, tmp_path, jax_lsm_cls):
    """(port store, JAX store) of one kind."""
    if backend == "memory":
        return MemoryKV(), jkv.MemoryKV()
    if backend == "sqlite":
        return SqliteKV(str(tmp_path / "p.db")), jkv.SqliteKV(str(tmp_path / "j.db"))
    return LsmKV(str(tmp_path / "p")), jax_lsm_cls(str(tmp_path / "j"))


def rows(kv) -> list:
    return list(kv.scan_prefix(b""))


def random_writes(rng, n, pool=None):
    """{tree: {key: value or None}} over every subtree."""
    out = {name: {} for name in SUBTREES}
    for _ in range(n):
        name = rng.choice(SUBTREES)
        key = rng.choice(pool) if pool else rng.randbytes(rng.randrange(1, 20))
        out[name][key] = None if rng.random() < 0.2 else rng.randbytes(rng.randrange(0, 40))
    return out


def apply(snap, writes) -> None:
    for name, rows_ in writes.items():
        for k, v in rows_.items():
            if v is None:
                snap.delete(name, k)
            else:
                snap.put(name, k, v)


def test_state_roots_bytes_and_hash():
    rng = random.Random(1)
    for _ in range(20):
        fields = {name: rng.choice([EMPTY_ROOT, rng.randbytes(32)]) for name in SUBTREES}
        roots, jroots = StateRoots(**fields), jstate.StateRoots(**fields)
        assert roots.encode() == jroots.encode() and len(roots.encode()) == 32 * len(SUBTREES)
        assert roots.state_hash() == jroots.state_hash()
        assert roots.all_roots() == jroots.all_roots()
        assert StateRoots.decode(jroots.encode()) == roots
    assert StateRoots().state_hash() == jstate.StateRoots().state_hash()


def test_snapshot_checkpoint_restore_discard():
    """Buffered reads, nested checkpoints restored in LIFO order and a
    discard, step for step with the JAX package's Snapshot."""
    rng = random.Random(2)
    pool = [rng.randbytes(6) for _ in range(30)]
    sm, jsm = StateManager(MemoryKV()), jstate.StateManager(jkv.MemoryKV())
    base = sm.new_snapshot()
    jbase = jsm.new_snapshot()
    w = random_writes(rng, 60, pool)
    apply(base, w)
    apply(jbase, w)
    roots = base.freeze()
    assert roots == StateRoots.decode(jbase.freeze().encode())
    snap, jsnap = Snapshot(sm.trie, roots), jsm.new_snapshot(jstate.StateRoots.decode(roots.encode()))
    marks = []
    for step in range(6):
        marks.append((snap.checkpoint(), jsnap.checkpoint()))
        w = random_writes(rng, 15, pool)
        apply(snap, w)
        apply(jsnap, w)
        for name in SUBTREES:
            for k in pool[:10]:
                assert snap.get(name, k) == jsnap.get(name, k)
    for cp, jcp in reversed(marks[2:]):
        snap.restore(cp)
        jsnap.restore(jcp)
        assert snap.freeze().encode() == jsnap.freeze().encode()
    snap.discard()
    jsnap.discard()
    assert snap.freeze() == roots and snap._writes == {n: {} for n in SUBTREES}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("streamed", [False, True], ids=["one_batch", "streamed"])
def test_commits_write_the_jax_rows(tmp_path, jax_lsm, backend, streamed):  # noqa: F811
    """Four heights of seeded writes through freeze_and_commit (and one
    through freeze + commit) give the JAX package's rows, byte for byte;
    the heights' roots, the tip, rollback_to and a reopened manager read
    them back."""
    kv, jkv_ = open_pair(backend, tmp_path, jax_lsm)
    sm, jsm = StateManager(kv), jstate.StateManager(jkv_)
    if streamed:  # small enough that every commit streams over LsmKV
        sm.stream_threshold = jsm.stream_threshold = 16
        sm._STREAM_BATCH = jsm._STREAM_BATCH = 32
    rng = random.Random(11)
    pool = [rng.randbytes(8) for _ in range(200)]
    want = []
    for height in range(4):
        w = random_writes(rng, 400, pool)  # ~57 a subtree: the deferred path
        snap, jsnap = sm.new_snapshot(), jsm.new_snapshot()
        apply(snap, w)
        apply(jsnap, w)
        if height == 2:
            roots = snap.freeze()
            sm.commit(height, roots)
            jsm.commit(height, jsnap.freeze())
        else:
            roots = sm.freeze_and_commit(height, snap)
            jsm.freeze_and_commit(height, jsnap)
        want.append(roots)
        assert rows(kv) == rows(jkv_), height
        stats = sm.commit_stats
        assert stats["nodes"] > 0 and (stats["streamed_batches"] > 0) == (
            streamed and backend == "lsm"), stats
    assert sm.committed_height() == jsm.committed_height() == 3
    assert [sm.roots_at(h) for h in range(4)] == want and sm.roots_at(9) is None
    assert StateManager(kv).committed == want[-1]
    assert sm.rollback_to(1) == want[1]
    jsm.rollback_to(1)
    assert rows(kv) == rows(jkv_) and StateManager(kv).committed == want[1]
    with pytest.raises(KeyError):
        sm.rollback_to(7)
    for store in (kv, jkv_):
        store.close()


def test_state_commit_harness_equals_jax(tmp_path, jax_lsm):  # noqa: F811
    """chip_smoke.py's state_commit_1m harness at 2,000 accounts and two
    blocks of 200 transfers (the senders recovered on the CPU): the port's
    StateManager over LsmKV and the JAX package's over its LsmKV give the
    same roots and rows after every block, a quick fsck is clean after
    each, and the block rows decode to the blocks."""
    from lachain_tpu_torch.storage.kv import EntryPrefix, prefixed
    from lachain_tpu_torch.utils.serialization import write_u64

    inp = chip_smoke.state_inputs(5, 2000, 32, 2, 200)
    kv, jkv_ = LsmKV(str(tmp_path / "p")), jax_lsm(str(tmp_path / "j"))
    sm, jsm = StateManager(kv), jstate.StateManager(jkv_)
    sm.stream_threshold = jsm.stream_threshold = 256
    balances = dict(inp["balances"])
    writes = chip_smoke.genesis_writes(balances)
    block, roots = chip_smoke.commit_block(sm, kv, 0, types.ZERO_HASH, [], writes)
    jblock, jroots = chip_smoke.commit_block(jsm, jkv_, 0, types.ZERO_HASH, [], writes)
    assert block == jblock and roots.encode() == jroots.encode()
    assert rows(kv) == rows(jkv_) and fsck(kv, repair=False).clean
    for height, stxs in enumerate(inp["blocks"], start=1):
        types._SENDER_MEMO.clear()
        if height == 1:  # the card's route on its plain kernels (~0.15 s a signature)
            types.warm_sender_caches(stxs[:24], chip_smoke.ROOT_CHAIN_ID, device="cpu")
        # the others by the host library's scalar recovery
        assert [stx.sender(chip_smoke.ROOT_CHAIN_ID) for stx in stxs] == [
            inp["addrs"][(t + (height - 1) * 200) % 32] for t in range(200)]
        writes = chip_smoke.transfer_writes(balances, stxs)
        assert len(writes["transactions"]) == 200
        parent = block.hash()
        block, roots = chip_smoke.commit_block(sm, kv, height, parent, stxs, writes)
        jblock, jroots = chip_smoke.commit_block(jsm, jkv_, height, parent, stxs, writes)
        assert block == jblock and roots.encode() == jroots.encode()
        assert sm.commit_stats["streamed_batches"] > 0
        assert rows(kv) == rows(jkv_) and fsck(kv, repair=False).clean
        h = kv.get(prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(height)))
        assert types.Block.decode(kv.get(prefixed(EntryPrefix.BLOCK_BY_HASH, h))) == block
        assert block.header.state_hash == roots.state_hash()
    snap = sm.new_snapshot()
    for a in random.Random(6).sample(inp["accounts"], 50):
        assert snap.get("balances", chip_smoke.BALANCE_ROW + a) == balances[a].to_bytes(32, "big")
    kv.close()
    jkv_.close()
