"""The port's trie (lachain_tpu_torch/storage/trie.py) against the JAX
package's, on the CPU.

Seeded put / delete / apply_many runs through both packages' `Trie` over
their own MemoryKV give the same roots, the same node bytes (each
package's pending buffer, key for key), the same `iter_items` and the
same node counts: serially (one merkle worker, deferred batch hashing),
subtrie-sharded, and key by key. The fast-path thresholds are lowered by
monkeypatch in both packages, as the JAX package's
tests/test_trie_parallel.py does, so that small batches take the sharded
and deferred paths; one case keeps the real thresholds. The leaf-collapse,
leaf-split and no-op cases are that file's, held against the JAX package.
"""
from __future__ import annotations

import os
import random

import pytest
import torch

import lachain_tpu.storage.trie as jtrie
import lachain_tpu_torch.storage.trie as trie_mod
from lachain_tpu.storage.kv import MemoryKV as JMemoryKV
from lachain_tpu_torch.crypto.hashes import keccak256_host
from lachain_tpu_torch.storage.kv import MemoryKV
from lachain_tpu_torch.storage.trie import (
    EMPTY_ROOT,
    InternalNode,
    LeafNode,
    Trie,
    _decode,
    resolve_merkle_workers,
)

torch.set_num_threads(1)


@pytest.fixture
def low_thresholds(monkeypatch):
    """Small fast-path floors in both packages: small batches take the
    sharded and deferred paths."""
    for mod in (trie_mod, jtrie):
        monkeypatch.setattr(mod, "MIN_DEFER_OPS", 4)
        monkeypatch.setattr(mod, "MIN_SHARD_OPS", 8)


def random_batch(rng, pool, n_ops, delete_frac):
    writes = {}
    for _ in range(n_ops):
        k = rng.choice(pool)
        writes[k] = None if rng.random() < delete_frac else rng.randbytes(rng.randrange(1, 40))
    return writes


def serial_oracle(t, root, writes):
    """One walker, a hash a node (no deferral, no shards)."""
    ops = sorted({keccak256_host(k): v for k, v in writes.items()}.items())
    return t._bulk(root, ops, 0)


def key_with_first_nibble(nib: int, tag: int) -> bytes:
    """A key whose keccak256 starts with nibble `nib` (its top-level
    subtrie)."""
    i = 0
    while True:
        k = b"%d:%d:%d" % (nib, tag, i)
        if keccak256_host(k)[0] >> 4 == nib:
            return k
        i += 1


@pytest.mark.parametrize("seed_base", [0, 25])
def test_apply_many_equals_jax(low_thresholds, seed_base):
    """25 seeds a case, 3 batches each: the port's oracle walk, deferred
    (one worker) and sharded roots and node buffers equal the JAX
    package's deferred and sharded ones; iter_items and node_count too."""
    for seed in range(seed_base, seed_base + 25):
        rng = random.Random(seed)
        pool = [rng.randbytes(rng.randrange(1, 24)) for _ in range(60)]
        ports = [Trie(MemoryKV()) for _ in range(3)]
        jaxes = [jtrie.Trie(JMemoryKV()) for _ in range(2)]
        workers = rng.choice((2, 3, 4, 8, 16))
        roots = [EMPTY_ROOT] * 5
        for step in range(3):
            writes = random_batch(rng, pool, rng.randrange(8, 80), rng.choice((0.2, 0.5, 0.8)))
            roots = [
                serial_oracle(ports[0], roots[0], dict(writes)),
                ports[1].apply_many(roots[1], dict(writes), workers=1),
                ports[2].apply_many(roots[2], dict(writes), workers=workers),
                jaxes[0].apply_many(roots[3], dict(writes), workers=1),
                jaxes[1].apply_many(roots[4], dict(writes), workers=workers),
            ]
            assert len(set(roots)) == 1, (seed, step)
            buffers = [dict(t._pending) for t in ports + jaxes]
            assert all(b == buffers[0] for b in buffers), (seed, step)
        if roots[0] != EMPTY_ROOT:
            assert list(ports[2].iter_items(roots[0])) == list(jaxes[1].iter_items(roots[0]))
            assert ports[2].node_count(roots[0]) == jaxes[1].node_count(roots[0])


def test_put_delete_key_by_key_equals_jax():
    """Sequential put / delete / get through both packages: the same
    roots after every step, the same values read back, and apply_many of
    the net batch gives the sequential root."""
    rng = random.Random(7)
    pool = [rng.randbytes(rng.randrange(1, 16)) for _ in range(40)]
    t, jt = Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    root = jroot = EMPTY_ROOT
    net = {}
    for _ in range(300):
        k = rng.choice(pool)
        if rng.random() < 0.3:
            root, jroot = t.delete(root, k), jt.delete(jroot, k)
            net[k] = None
        else:
            v = rng.randbytes(rng.randrange(0, 30))
            root, jroot = t.put(root, k, v), jt.put(jroot, k, v)
            net[k] = v
        assert root == jroot
        probe = rng.choice(pool)
        assert t.get(root, probe) == jt.get(jroot, probe) == net.get(probe)
    assert Trie(MemoryKV()).apply_many(EMPTY_ROOT, {k: v for k, v in net.items()}) == root
    assert t.delete(root, b"never written") == root


def test_node_bytes_decode_both_ways():
    """Every node the port stores decodes in the JAX package to the same
    node and back to the same bytes, and the reverse."""
    rng = random.Random(3)
    t, jt = Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    writes = {rng.randbytes(6): rng.randbytes(rng.randrange(0, 50)) for _ in range(200)}
    root = t.apply_many(EMPTY_ROOT, dict(writes))
    assert jt.apply_many(EMPTY_ROOT, dict(writes)) == root
    kinds = set()
    for key, enc in t._pending.items():
        node, jnode = _decode(enc), jtrie._decode(enc)
        kinds.add(type(node))
        assert node.encode() == jnode.encode() == enc
        assert keccak256_host(enc) == key[2:]
    assert kinds == {LeafNode, InternalNode}
    with pytest.raises(ValueError):
        _decode(b"Xjunk")
    with pytest.raises(KeyError):
        Trie(MemoryKV()).get(b"\x11" * 32, b"k")


@pytest.mark.parametrize("survivor", [0, 7, 15])
def test_single_leaf_collapse_across_subtrie_boundary(low_thresholds, survivor):
    """One batch deletes every top-level subtrie but one: 15 workers give
    EMPTY_ROOT and the caller collapses the branch to the survivor's leaf,
    as the JAX package and the serial walk do."""
    keys = [key_with_first_nibble(n, 0) for n in range(16)]
    t_o, t_s, jt = Trie(MemoryKV()), Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    base = {k: b"v%d" % i for i, k in enumerate(keys)}
    root = serial_oracle(t_o, EMPTY_ROOT, dict(base))
    assert t_s.apply_many(EMPTY_ROOT, dict(base), workers=1) == root
    assert jt.apply_many(EMPTY_ROOT, dict(base), workers=1) == root
    deletes = {k: None for i, k in enumerate(keys) if i != survivor}
    root_o = serial_oracle(t_o, root, dict(deletes))
    root_s = t_s.apply_many(root, dict(deletes), workers=16)
    assert root_o == root_s == jt.apply_many(root, dict(deletes), workers=16)
    assert dict(t_o._pending) == dict(t_s._pending) == dict(jt._pending)
    assert t_s.get(root_s, keys[survivor]) == b"v%d" % survivor
    assert [v for _, v in t_s.iter_items(root_s)] == [b"v%d" % survivor]


def test_leaf_split_inside_shard(low_thresholds):
    """Two keys of one top-level nibble split a leaf at depth >= 1 inside
    one worker: the port's sharded walk equals the serial walk and the
    JAX package's."""
    a, b = key_with_first_nibble(5, 1), key_with_first_nibble(5, 2)
    c = key_with_first_nibble(9, 3)
    t_o, t_s, jt = Trie(MemoryKV()), Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    root = serial_oracle(t_o, EMPTY_ROOT, {a: b"1", c: b"3"})
    assert t_s.apply_many(EMPTY_ROOT, {a: b"1", c: b"3"}, workers=1) == root
    assert jt.apply_many(EMPTY_ROOT, {a: b"1", c: b"3"}, workers=1) == root
    batch = {b: b"2", c: None}
    root_o = serial_oracle(t_o, root, dict(batch))
    assert t_s.apply_many(root, dict(batch), workers=16) == root_o
    assert jt.apply_many(root, dict(batch), workers=16) == root_o
    assert dict(t_o._pending) == dict(t_s._pending) == dict(jt._pending)


def test_noop_batch_preserves_root(low_thresholds):
    """Same-value puts and absent-key deletes return the old root on both
    fast paths and store no new node, as in the JAX package."""
    rng = random.Random(99)
    writes = {rng.randbytes(8): rng.randbytes(8) for _ in range(40)}
    t, jt = Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    root = t.apply_many(EMPTY_ROOT, dict(writes), workers=1)
    assert jt.apply_many(EMPTY_ROOT, dict(writes), workers=1) == root
    before = dict(t._pending)
    noop = dict(writes)
    noop.update({rng.randbytes(9): None for _ in range(20)})
    for workers in (1, 16):
        assert t.apply_many(root, dict(noop), workers=workers) == root
        assert jt.apply_many(root, dict(noop), workers=workers) == root
    assert dict(t._pending) == before == dict(jt._pending)
    assert t.apply_many(root, {}) == root


def test_stream_covers_pending_and_stats(low_thresholds):
    """The streamed subtrie batches plus the caller's depth-0 nodes are the
    whole pending buffer; merkle_stats accumulates over calls until
    reset_merkle_stats; confirm_pending drops what a batch persisted;
    fork and _shard_fork read their parent's nodes."""
    rng = random.Random(5)
    t = Trie(MemoryKV())
    root = t.apply_many(EMPTY_ROOT, {rng.randbytes(8): rng.randbytes(8) for _ in range(64)},
                        workers=1)
    first = dict(t.merkle_stats)
    assert first["workers"] == 1 and first["nodes"] == len(t._pending)
    t.confirm_pending(t.peek_pending())
    assert not t._pending
    streamed = []
    batch = {rng.randbytes(8): rng.randbytes(8) for _ in range(64)}
    root2 = t.apply_many(root, dict(batch), workers=8, stream=streamed.append)
    skeys = {k for items in streamed for k, _ in items}
    assert skeys <= set(t._pending) and len(set(t._pending) - skeys) <= 2
    assert t.merkle_stats["workers"] == 8
    assert t.merkle_stats["nodes"] == first["nodes"] + len(skeys)
    t.reset_merkle_stats()
    assert t.merkle_stats == {}
    # forks over the same kv see the uncommitted nodes
    for fork in (t.fork(), t._shard_fork()):
        assert all(fork.get(root2, k) == v for k, v in batch.items())
    exported = t.export_pending()
    other = Trie(t._kv)
    other.absorb_pending(exported)
    assert all(other.get(root2, k) == v for k, v in batch.items())


def test_real_thresholds_equal_jax():
    """At the real thresholds, big batches through every path agree with
    the JAX package."""
    rng = random.Random(123)
    pool = [rng.randbytes(10) for _ in range(1200)]
    t_d, t_s, jt = Trie(MemoryKV()), Trie(MemoryKV()), jtrie.Trie(JMemoryKV())
    root_d = root_s = root_j = EMPTY_ROOT
    for step in range(2):
        writes = random_batch(rng, pool, 900, 0.25)
        root_d = t_d.apply_many(root_d, dict(writes), workers=1)
        root_s = t_s.apply_many(root_s, dict(writes), workers=8)
        root_j = jt.apply_many(root_j, dict(writes), workers=8)
        assert root_d == root_s == root_j, step
        assert dict(t_d._pending) == dict(t_s._pending) == dict(jt._pending)


def test_resolve_merkle_workers():
    assert resolve_merkle_workers(1) == 1
    assert resolve_merkle_workers(4) == 4
    assert resolve_merkle_workers(64) == 16
    assert resolve_merkle_workers(0) == min(os.cpu_count() or 1, 16)
    for n in (0, 1, 3, 40):
        assert resolve_merkle_workers(n) == jtrie.resolve_merkle_workers(n)
    assert (trie_mod.MIN_DEFER_OPS, trie_mod.MIN_SHARD_OPS) == (
        jtrie.MIN_DEFER_OPS, jtrie.MIN_SHARD_OPS)
