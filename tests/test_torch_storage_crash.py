"""The storage's crash sites in the port against the JAX package, on the
CPU.

A small chain on LsmKV (five heights of seeded balance rows committed by
StateManager.freeze_and_commit with a lowered stream threshold, each
followed by its block rows through chip_smoke.commit_block) runs in each
package under the same crash plan; each package arms its own
storage/crashpoints module. After the crash each store is closed and
reopened: fsck's report and the committed state (height, roots, every
row) equal the JAX package's. Sites: lsm.wal.encoded, lsm.wal.fsynced,
lsm.compact.mid (the engine's torn states) and trie.merkle.subtree_streamed
in raise mode; lsm.wal.fsynced once more under SIGKILL in a child process
of the port, whose store then equals the raise mode's. Then DbShrink
crashed at each of its checkpoints (shrink.mark.height, shrink.sweep.pre,
shrink.clean.pre) resumes to the uninterrupted pass's store, in both
packages, as the JAX package's tests/test_crashpoints.py:523 does.
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

import chip_smoke
from lachain_tpu.storage import crashpoints as jcrashpoints
from lachain_tpu.storage import fsck as jfsck
from lachain_tpu.storage import shrink as jshrink
from lachain_tpu.storage import state as jstate
from lachain_tpu_torch.core import types
from lachain_tpu_torch.storage import crashpoints, fsck, shrink, state
from lachain_tpu_torch.storage.kv import EntryPrefix, prefixed
from lachain_tpu_torch.storage.lsm import LsmKV
from tests.test_torch_lsm import jax_lsm  # noqa: F401  (a fixture)

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHTS = 5
FLUSH = 4096  # small memtables: tables to compact
# (state module, crashpoints module, fsck module, shrink module) a package
PORT = (state, crashpoints, fsck, shrink)
JAX = (jstate, jcrashpoints, jfsck, jshrink)


def workload(state_mod, kv, heights: int = HEIGHTS):
    """Seeded heights committed through freeze_and_commit, streamed (150
    balance rows a height, the stream threshold 64), each followed by its
    block rows -> the StateManager."""
    sm = state_mod.StateManager(kv)
    sm.stream_threshold = 64
    sm._STREAM_BATCH = 64
    rng = random.Random(21)
    parent = types.ZERO_HASH
    for height in range(heights):
        writes = {"balances": {rng.randbytes(8): rng.randbytes(32) for _ in range(150)}}
        block, _ = chip_smoke.commit_block(sm, kv, height, parent, [], writes)
        parent = block.hash()
    return sm


def rows(kv) -> list:
    return list(kv.scan_prefix(b""))


def crashed_run(pkg, make_kv, path, plan_spec):
    """The workload under `plan_spec` in raise mode, the store closed at
    the crash and reopened -> (fsck report, height, roots bytes, rows)."""
    state_mod, cp, fsck_mod, _ = pkg
    kv = make_kv(path, flush_threshold=FLUSH)
    plan = cp.CrashPlan.parse([plan_spec])
    with cp.armed(plan) as session:
        with pytest.raises(cp.InjectedCrash):
            workload(state_mod, kv)
    assert [name for name, _hit in session.fired] == [plan_spec.split("@")[0]]
    kv.close()
    return reopened(pkg, make_kv, path)


def reopened(pkg, make_kv, path):
    state_mod, _, fsck_mod, _ = pkg
    kv = make_kv(path, flush_threshold=FLUSH)
    try:
        report = fsck_mod.fsck(kv, repair=False, deep=True).to_dict()
        sm = state_mod.StateManager(kv)
        return report, sm.committed_height(), sm.committed.encode(), rows(kv)
    finally:
        kv.close()


@pytest.mark.parametrize("spec", [
    "lsm.wal.encoded@3", "lsm.wal.fsynced@3", "lsm.wal.fsynced@4", "lsm.compact.mid@5",
    "trie.merkle.subtree_streamed@2", "kv.write_batch.post@5"])
def test_crash_site_equals_jax(tmp_path, jax_lsm, spec):  # noqa: F811
    """Each site fires in both packages at the same traversal; the torn
    stores reopen to the same fsck verdict, state and rows."""
    port = crashed_run(PORT, LsmKV, str(tmp_path / "port"), spec)
    jax = crashed_run(JAX, jax_lsm, str(tmp_path / "jax"), spec)
    assert port == jax
    report, height, _roots, _rows = port
    if spec.startswith("lsm.wal.encoded"):
        # the third batch (height 1's roots) was torn before its fsync
        assert height == 0 and report["clean"]
    if spec == "lsm.wal.fsynced@3":
        # durable, never acked: height 1 replayed without its block rows
        assert height == 1 and report["fatal"]
        assert {i["code"] for i in report["issues"]} == {"tip-block"}
    if spec.startswith("trie.merkle") or spec.startswith("lsm.compact"):
        # a state commit lost whole (orphan nodes at most): the tip before
        assert report["clean"] and height == (0 if spec.startswith("trie") else 1)


_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[2])
    from lachain_tpu_torch.storage import crashpoints, state
    from lachain_tpu_torch.storage.lsm import LsmKV
    from tests.test_torch_storage_crash import FLUSH, workload
    assert crashpoints.arm_from_env() is not None
    workload(state, LsmKV(sys.argv[1], flush_threshold=FLUSH))
    print("NOT KILLED")
""")


def test_wal_fsynced_under_sigkill(tmp_path, jax_lsm):  # noqa: F811
    """lsm.wal.fsynced@3 under a real SIGKILL in a child of the port: the
    store it leaves reopens to the raise mode's verdict, state and rows,
    the port's and the JAX package's."""
    LsmKV(str(tmp_path / "warm")).close()  # the engine built before the child
    path = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH=_REPO)
    env[crashpoints.ENV_VAR] = "lsm.wal.fsynced@3:sigkill"
    child = subprocess.run([sys.executable, "-c", _CHILD, path, _REPO], env=env,
                           capture_output=True, timeout=120)
    assert child.returncode == -signal.SIGKILL, child.stderr.decode()[-2000:]
    killed = reopened(PORT, LsmKV, path)
    raised = crashed_run(PORT, LsmKV, str(tmp_path / "raised"), "lsm.wal.fsynced@3")
    jax = crashed_run(JAX, jax_lsm, str(tmp_path / "jax"), "lsm.wal.fsynced@3")
    assert killed == raised == jax and killed[1] == 1


def trie_keys(kv) -> set:
    return {k for k, _ in kv.scan_prefix(prefixed(EntryPrefix.TRIE_NODE))}


@pytest.mark.parametrize("point", [
    ("shrink.mark.height", 1), ("shrink.mark.height", 3), ("shrink.sweep.pre", 1),
    ("shrink.clean.pre", 1)], ids=lambda p: f"{p[0]}@{p[1]}")
def test_shrink_resumes_after_crash(tmp_path, jax_lsm, point):  # noqa: F811
    """DbShrink(retain_depth=2) crashed at a checkpoint leaves its resume
    row (fsck notes it); the next run resumes and converges to the
    uninterrupted pass's store. The JAX package's shrink does the same on
    its store, row for row."""
    name, hit = point
    want = None
    results = []
    for pkg, make_kv, tag in ((PORT, LsmKV, "port"), (JAX, jax_lsm, "jax")):
        state_mod, cp, fsck_mod, shrink_mod = pkg
        ref = make_kv(str(tmp_path / f"{tag}-ref"))
        sm = workload(state_mod, ref)
        stats = shrink_mod.DbShrink(sm, ref).shrink(2)
        assert stats["cutoff"] == HEIGHTS - 1 - 2 and stats["swept"] > 0
        if want is None:
            want = (trie_keys(ref), rows(ref))
        assert (trie_keys(ref), rows(ref)) == want
        ref.close()

        kv = make_kv(str(tmp_path / tag))
        sm = workload(state_mod, kv)
        with cp.armed(cp.CrashPlan(points=(cp.CrashPoint(name=name, hit=hit),))):
            with pytest.raises(cp.InjectedCrash):
                shrink_mod.DbShrink(sm, kv).shrink(2)
        assert kv.get(prefixed(EntryPrefix.SHRINK_STATE)) is not None
        report = fsck_mod.fsck(kv, repair=False).to_dict()
        assert [i["code"] for i in report["issues"]] == ["shrink-resume"]
        torn = rows(kv)
        stats = shrink_mod.DbShrink(sm, kv).shrink(2)
        assert kv.get(prefixed(EntryPrefix.SHRINK_STATE)) is None
        assert stats["cutoff"] == HEIGHTS - 1 - 2
        assert (trie_keys(kv), rows(kv)) == want, f"{tag}: {name}@{hit} diverged"
        assert fsck_mod.fsck(kv, repair=False, deep=True).to_dict()["clean"]
        results.append((report, torn))
        kv.close()
    assert results[0] == results[1]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_shrink_resumed_by_the_other_package(tmp_path, jax_lsm, first):  # noqa: F811
    """A shrink crashed at its first mark checkpoint in one package is
    resumed by the other's DbShrink on the same directory, to the store of
    an uninterrupted pass."""
    pkgs = {"port": (PORT, LsmKV), "jax": (JAX, jax_lsm)}
    (state_mod, cp, _, shrink_mod), make_kv = pkgs[first]
    ref = LsmKV(str(tmp_path / "ref"))
    shrink.DbShrink(workload(state, ref), ref).shrink(2)
    want = rows(ref)
    ref.close()
    path = str(tmp_path / "db")
    kv = make_kv(path)
    sm = workload(state_mod, kv)
    with cp.armed(cp.CrashPlan(points=(cp.CrashPoint(name="shrink.mark.height", hit=1),))):
        with pytest.raises(cp.InjectedCrash):
            shrink_mod.DbShrink(sm, kv).shrink(2)
    kv.close()
    (state_mod, _, _, shrink_mod), make_kv = pkgs["jax" if first == "port" else "port"]
    kv = make_kv(path)
    stats = shrink_mod.DbShrink(state_mod.StateManager(kv), kv).shrink(2)
    assert stats["cutoff"] == HEIGHTS - 1 - 2 and rows(kv) == want
    kv.close()
