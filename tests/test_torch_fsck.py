"""The port's fsck (lachain_tpu_torch/storage/fsck.py) against the JAX
package's, on the CPU.

A small chain (chip_smoke.py's state_commit harness: a genesis of 300
accounts and two blocks of 40 signed transfers) is written once through
the port; each case copies its rows into a MemoryKV of each package,
damages both the same way and runs both packages' fsck: the reports'
`to_dict()` are equal, and so are the rows after a repair. Cases: a clean
chain; a missing tip root row, tip block and root node (fatal); an
interior trie hole, which only the deep walk finds; an orphan block above
the tip (repaired, or fatal without repair); and, on the send journals
and evidence store of a (7, 2) Root era run by
tests/test_torch_crash_recovery.py's harness, stale and undecodable
journal entries and bad evidence rows (repaired), beside pool, fast-sync
frontier and shrink rows. `verify_imported_state` gives the JAX package's
verdicts.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from lachain_tpu.storage import fsck as jfsck
from lachain_tpu.storage import kv as jkv
from lachain_tpu_torch.consensus.evidence import EvidenceStore
from lachain_tpu_torch.consensus.journal import ConsensusJournal
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from lachain_tpu_torch.core import types
from lachain_tpu_torch.storage.fsck import FsckError, FsckReport, fsck, verify_imported_state
from lachain_tpu_torch.storage.kv import EntryPrefix, MemoryKV, prefixed
from lachain_tpu_torch.storage.state import StateManager
from lachain_tpu_torch.storage.trie import EMPTY_ROOT, InternalNode, _decode
from lachain_tpu_torch.utils.serialization import write_u64
from tests.test_torch_crash_recovery import (
    CRASH_SEED,
    align_encryption,
    journaled_era,
    python_sides,
)

torch.set_num_threads(1)

TIP = 2


@pytest.fixture(scope="module")
def chain_rows():
    """The rows of a 3-height chain written by the state_commit harness
    (senders recovered by the host library)."""
    inp = chip_smoke.state_inputs(9, 300, 8, TIP, 40)
    kv = MemoryKV()
    sm = StateManager(kv)
    balances = dict(inp["balances"])
    block, _ = chip_smoke.commit_block(sm, kv, 0, types.ZERO_HASH, [],
                                       chip_smoke.genesis_writes(balances))
    for height, stxs in enumerate(inp["blocks"], start=1):
        writes = chip_smoke.transfer_writes(balances, stxs)
        block, _ = chip_smoke.commit_block(sm, kv, height, block.hash(), stxs, writes)
    return list(kv.scan_prefix(b""))


@pytest.fixture(scope="module")
def era_journal_rows():
    """Validator 0's journal rows after a journaled (7, 2) Root era on the
    port's Python engine."""
    mp = pytest.MonkeyPatch()
    try:
        align_encryption(mp, CRASH_SEED)
        port, _jax = python_sides(7, 2, CRASH_SEED, DeliveryMode.TAKE_FIRST)
        (ok, _count, _blocks), kvs, _journals = journaled_era(port, 7)
    finally:
        mp.undo()
    assert ok
    return list(kvs[0].scan_prefix(b""))


def pair(rows):
    """A MemoryKV of each package holding `rows`."""
    kv, j = MemoryKV(), jkv.MemoryKV()
    for store in (kv, j):
        store.write_batch(list(rows))
    return kv, j


def both(kv, j, **kw) -> dict:
    """Both packages' fsck on their store: equal reports, equal rows
    after."""
    report = fsck(kv, **kw)
    jreport = jfsck.fsck(j, **kw)
    assert report.to_dict() == jreport.to_dict()
    assert list(kv.scan_prefix(b"")) == list(j.scan_prefix(b""))
    return report.to_dict()


def tip_roots(kv):
    return StateManager(kv).roots_at(TIP)


def drop(kv, j, key) -> None:
    assert kv.get(key) is not None
    kv.delete(key)
    j.delete(key)


def codes(report: dict) -> set:
    return {i["code"] for i in report["issues"]}


@pytest.mark.parametrize("deep", [False, True], ids=["quick", "deep"])
def test_clean_chain(chain_rows, deep):
    kv, j = pair(chain_rows)
    report = both(kv, j, deep=deep)
    assert report["clean"] and report["deep"] == deep and len(report["checked"]) == 9


@pytest.mark.parametrize("damage", ["tip-roots", "tip-block", "root-nodes"])
def test_fatal_states(chain_rows, damage):
    """A missing tip root row, tip block or root node: the same fatal
    report in both packages, with or without repair; FsckError names it."""
    kv, j = pair(chain_rows)
    if damage == "tip-roots":
        drop(kv, j, prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(TIP)))
    elif damage == "tip-block":
        h = kv.get(prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(TIP)))
        drop(kv, j, prefixed(EntryPrefix.BLOCK_BY_HASH, h))
    else:
        root = next(r for r in tip_roots(kv).all_roots() if r != EMPTY_ROOT)
        drop(kv, j, prefixed(EntryPrefix.TRIE_NODE, root))
    for repair in (True, False):
        report = both(kv, j, repair=repair)
        assert report["fatal"] and codes(report) == {damage}
    err = FsckError(fsck(kv))
    assert damage in str(err) and isinstance(err.report, FsckReport)


def test_interior_trie_hole_found_deep(chain_rows):
    kv, j = pair(chain_rows)
    victim = None
    for r in tip_roots(kv).all_roots():
        if r != EMPTY_ROOT:
            node = _decode(kv.get(prefixed(EntryPrefix.TRIE_NODE, r)))
            if isinstance(node, InternalNode):
                victim = next(c for c in node.children if c != EMPTY_ROOT)
                break
    drop(kv, j, prefixed(EntryPrefix.TRIE_NODE, victim))
    assert not both(kv, j, repair=False)["fatal"]
    deep = both(kv, j, repair=False, deep=True)
    assert deep["fatal"] and codes(deep) == {"root-nodes"}
    assert victim.hex() in deep["issues"][0]["detail"]


@pytest.mark.parametrize("deep", [False, True], ids=["quick", "deep"])
def test_orphan_block_repaired(chain_rows, deep):
    """The tip block's rows copied to tip + 1 (with its transactions'
    rows), as a crash between the block batch and the state commit leaves
    them: fatal without repair; repaired, every row of it is gone."""
    kv, j = pair(chain_rows)
    h = kv.get(prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(TIP)))
    block = types.Block.decode(kv.get(prefixed(EntryPrefix.BLOCK_BY_HASH, h)))
    orphan = types.Block(header=types.BlockHeader(
        index=TIP + 1, prev_block_hash=h, merkle_root=block.header.merkle_root,
        state_hash=block.header.state_hash, nonce=7), tx_hashes=block.tx_hashes,
        multisig=block.multisig)
    oh = orphan.hash()
    rows = [(prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(TIP + 1)), oh),
            (prefixed(EntryPrefix.BLOCK_BY_HASH, oh), orphan.encode()),
            (prefixed(EntryPrefix.BLOCK_BLOOM, write_u64(TIP + 1)), b"\x00" * 8)]
    rows += [(prefixed(EntryPrefix.TRANSACTION_BY_HASH, th), b"tx") for th in orphan.tx_hashes]
    for store in (kv, j):
        store.write_batch(rows)
    report = both(kv, j, repair=False, deep=deep)
    assert report["fatal"] and codes(report) == {"orphan-block"}
    report = both(kv, j, repair=True, deep=deep)
    assert not report["fatal"] and codes(report) == {"orphan-block"}
    assert all(kv.get(k) is None for k, _ in rows)
    assert both(kv, j)["clean"]


def test_journal_evidence_pool_and_bookkeeping_rows(chain_rows, era_journal_rows):
    """A Root era's send journal (era 0 <= the tip: stale), an in-flight
    era's entry, undecodable journal entries, evidence rows good and bad,
    an undecodable pool entry, fast-sync frontier rows and shrink marks:
    the same reports as the JAX package's without repair (fatal) and with
    it (repaired), the same rows after, then clean; live entries stay."""
    assert era_journal_rows
    kv, j = pair(chain_rows + era_journal_rows)
    ConsensusJournal(kv).record(TIP + 1, None, b"in-flight send")
    store = EvidenceStore(kv=kv)
    store.record_equivocation(TIP + 1, 3, "coin", (-1, 0))
    store.record_invalid_share(TIP + 1, 5, "dec", (2,))
    ev = prefixed(EntryPrefix.EVIDENCE)
    bad = [
        (prefixed(EntryPrefix.CONSENSUS_STATE) + b"\x01", b"short key"),
        (prefixed(EntryPrefix.CONSENSUS_STATE, write_u64(TIP + 2) + write_u64(0)), b"\x00"),
        (ev + b"\x01", b"short key"),
        (ev + write_u64(99), b"\xff undecodable"),
        (prefixed(EntryPrefix.POOL_TX, b"\x01" * 32), b"not a transaction"),
        (prefixed(EntryPrefix.FASTSYNC_FRONTIER, b"\x02" * 32), b""),
        (prefixed(EntryPrefix.SHRINK_MARK, b"\xaa" * 32), b"\x01"),
    ]
    kv.write_batch(bad)
    for k, v in kv.scan_prefix(b""):
        if j.get(k) != v:
            j.put(k, v)
    report = both(kv, j, repair=False)
    assert report["fatal"] and codes(report) == {
        "journal-decode", "journal-stale", "evidence-decode", "pool-decode",
        "fastsync-frontier", "shrink-marks"}
    report = both(kv, j, repair=True)
    assert not report["fatal"] and len(report["issues"]) == 6
    assert [e[0] for e in ConsensusJournal(kv).entries()] == [TIP + 1]
    assert len(EvidenceStore(kv=kv)) == 2
    assert both(kv, j)["clean"]
    # an interrupted shrink is a note, and its marks stay
    for store in (kv, j):
        store.write_batch([(prefixed(EntryPrefix.SHRINK_STATE), b"{}"),
                           (prefixed(EntryPrefix.SHRINK_MARK, b"\xbb" * 32), b"\x01")])
    report = both(kv, j)
    assert codes(report) == {"shrink-resume"} and not report["fatal"]


def test_verify_imported_state(chain_rows):
    kv, j = pair(chain_rows)
    good = tip_roots(kv).state_hash()
    for expect in (good, None, b"\x01" * 32):
        assert verify_imported_state(kv, expect) == jfsck.verify_imported_state(j, expect)
    assert verify_imported_state(kv, good) is None
    root = next(r for r in tip_roots(kv).all_roots() if r != EMPTY_ROOT)
    drop(kv, j, prefixed(EntryPrefix.TRIE_NODE, root))
    assert verify_imported_state(kv, good) == jfsck.verify_imported_state(j, good)
    assert "incomplete" in verify_imported_state(kv, good)
    empty = MemoryKV()
    assert verify_imported_state(empty, good) == jfsck.verify_imported_state(jkv.MemoryKV(), good)
