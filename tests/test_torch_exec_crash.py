"""The port's crash workload (lachain_tpu_torch/storage/crash_workload.py)
against the JAX package's, on the CPU.

The crash matrix of the JAX package's tests/test_crashpoints.py (:36-47)
on SqliteKV and LsmKV in raise mode: under the same plan both packages'
workloads die at the same point, leave the same rows, get the same fsck
verdict and repair, and resume to the same store. Then, in the port only:
a block torn by a real SIGKILL in a child process on each engine
(`python -m lachain_tpu_torch.storage.crash_workload DB ENGINE`), the
streamed commit's midstream crash (whose resumed root must equal the
JAX package's uninterrupted one), and the pool's crash-restore round
trip. ~25 s on one core.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys

import pytest
import torch

from tests.test_torch_lsm import jax_lsm  # noqa: F401  (a fixture)
from tests.torch_exec_common import JAX, PKGS, PORT, gc_held, reset_module_state, rows

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MATRIX = [
    ("kv.write_batch.pre", 3, "clean"),
    ("kv.write_batch.mid", 3, "clean"),
    ("kv.write_batch.post", 3, "orphan-block"),
    ("block.persist.pre", 2, "clean"),
    ("block.persist.mid", 2, "orphan-block"),
    ("block.persist.post", 2, "clean"),
    ("pool.save.mid", 2, "clean"),
    ("shrink.mark.height", 2, "shrink-resume"),
    ("shrink.sweep.pre", 1, "shrink-resume"),
    ("shrink.clean.pre", 1, "shrink-resume"),
]


@pytest.fixture(autouse=True)
def _reset():
    reset_module_state()
    with gc_held():
        yield
    reset_module_state()


def open_kv(p, db, engine):
    return p.crash_workload.open_kv(db, engine)


def crashed_matrix_run(p, db, engine, name, hit):
    """Crash the workload at (name, hit), then reopen, fsck with repair,
    re-check and resume -> what each step saw."""
    cp = p.crashpoints
    kv = open_kv(p, db, engine)
    try:
        with cp.armed(cp.CrashPlan(points=(cp.CrashPoint(name=name, hit=hit),))) as session:
            with pytest.raises(cp.InjectedCrash):
                p.crash_workload.run_workload(kv)
        assert session.fired == [(name, hit)]
    finally:
        kv.close()
    reset_module_state()  # what a restart drops: the emulate memo among it
    kv = open_kv(p, db, engine)
    try:
        torn = rows(kv)
        report = p.fsck.fsck(kv, repair=True)
        verdict = (report.clean, report.fatal, sorted(i.code for i in report.issues))
        repaired = rows(kv)
        recheck = p.fsck.fsck(kv, repair=False)
        stats = p.crash_workload.run_workload(kv)
        return dict(torn=torn, verdict=verdict, repaired=repaired,
                    recheck=sorted(i.code for i in recheck.issues),
                    stats=stats, resumed=rows(kv))
    finally:
        kv.close()


# LsmKV's batch is one native call: it has no kv.write_batch.mid window
CASES = [(e, *row) for e in ("sqlite", "lsm") for row in MATRIX
         if (e, row[0]) != ("lsm", "kv.write_batch.mid")]


@pytest.mark.parametrize("engine,name,hit,expect", CASES)
def test_crash_matrix_equals_jax(tmp_path, jax_lsm, engine, name, hit, expect):
    if engine == "lsm" and name == "kv.write_batch.post":
        hit = 4  # LsmKV.put rides write_batch: block 1's batch is one later
    got = {p.name: crashed_matrix_run(p, str(tmp_path / f"{p.name}.db"), engine, name, hit)
           for p in PKGS}
    assert got["port"] == got["jax"]
    clean, fatal, codes = got["port"]["verdict"]
    assert not fatal
    assert clean if expect == "clean" else expect in codes
    assert set(got["port"]["recheck"]) <= {"shrink-resume"}
    assert got["port"]["stats"]["height"] == 6


def _child(args, plan, timeout=120):
    env = dict(os.environ)
    env[PORT.crashpoints.ENV_VAR] = plan.encode_env()
    env["PYTHONPATH"] = _REPO
    return subprocess.run([sys.executable, "-m", "lachain_tpu_torch.storage.crash_workload",
                           *args], env=env, capture_output=True, timeout=timeout)


@pytest.mark.parametrize("engine", ["sqlite", "lsm"])
def test_sigkill_torn_block(tmp_path, engine):
    cp = PORT.crashpoints
    db = str(tmp_path / "kill.db")
    child = _child([db, engine], cp.CrashPlan(points=(cp.CrashPoint("block.persist.mid", 3,
                                                                    "sigkill"),)))
    assert child.returncode == -signal.SIGKILL, child.stderr.decode()
    kv = open_kv(PORT, db, engine)
    try:
        report = PORT.fsck.fsck(kv, repair=True)
        assert not report.fatal
        assert "orphan-block" in {i.code for i in report.issues}
        assert PORT.crash_workload.run_workload(kv)["height"] == 6
    finally:
        kv.close()


def test_child_runs_to_its_end(tmp_path):
    db = str(tmp_path / "ok.db")
    child = _child([db, "sqlite", "3"], PORT.crashpoints.CrashPlan(points=()))
    assert child.returncode == 0, child.stderr.decode()
    assert b'"height": 3' in child.stdout


@pytest.mark.parametrize("hit", [1, 2])
def test_streamed_commit_midstream_crash(tmp_path, jax_lsm, hit):
    """Die between block 2's streamed trie batches and its root rows: the
    store reopens at the old tip with only the repairable orphan block,
    and the resumed run commits the JAX package's uninterrupted root."""
    kv = open_kv(JAX, str(tmp_path / "oracle.lsm"), "lsm")
    oracle = JAX.crash_workload.run_stream_workload(kv)["root"]
    kv.close()
    cp = PORT.crashpoints
    db = str(tmp_path / "stream.lsm")
    kv = open_kv(PORT, db, "lsm")
    try:
        base = PORT.crash_workload.run_stream_workload(kv, blocks=1)
        assert base["height"] == 1 and base["streamed"] >= 2
        plan = cp.CrashPlan(points=(cp.CrashPoint("trie.merkle.subtree_streamed", hit),))
        with cp.armed(plan) as session:
            with pytest.raises(cp.InjectedCrash):
                PORT.crash_workload.run_stream_workload(kv, blocks=2)
        assert session.fired == [("trie.merkle.subtree_streamed", hit)]
    finally:
        kv.close()
    reset_module_state()
    kv = open_kv(PORT, db, "lsm")
    try:
        report = PORT.fsck.fsck(kv, repair=True)
        assert not report.fatal and {i.code for i in report.issues} <= {"orphan-block"}
        assert PORT.state.StateManager(kv).committed_height() == 1
        again = PORT.crash_workload.run_stream_workload(kv, blocks=2)
        assert again["height"] == 2 and again["root"] == oracle
    finally:
        kv.close()


def test_pool_crash_restore_roundtrip(tmp_path):
    cp = PORT.crashpoints
    db = str(tmp_path / "pool.db")
    child = _child([db, "sqlite"], cp.CrashPlan(points=(cp.CrashPoint("pool.save.mid", 4,
                                                                      "sigkill"),)))
    assert child.returncode == -signal.SIGKILL, child.stderr.decode()
    kv = open_kv(PORT, db, "sqlite")
    try:
        state = PORT.state.StateManager(kv)

        def pool():
            return PORT.tx_pool.TransactionPool(
                kv, 225,
                account_nonce=lambda a: PORT.execution.get_nonce(state.new_snapshot(), a))

        p = pool()
        assert len(p) == 0
        assert p.restore() == len(p)
        assert set(p.persisted_hashes()) == p.tx_hashes()
        p.clear()
        assert len(p) == 0 and p.persisted_hashes() == []
        assert pool().restore() == 0
    finally:
        kv.close()


def test_crash_plan_repeats_bit_for_bit(tmp_path):
    tips = []
    for run in ("a", "b"):
        db = str(tmp_path / f"{run}.db")
        got = crashed_matrix_run(PORT, db, "sqlite", "block.persist.mid", 2)
        tips.append(got["resumed"])
    assert tips[0] == tips[1]
