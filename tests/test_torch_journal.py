"""The port's storage, crash points, payload codec, send journal and
evidence persistence vs the JAX package's, on the CPU.

* KV: the JAX package's round-trip and persistence cases
  (tests/test_storage.py) on the port's `MemoryKV` and `SqliteKV`; a batch
  that dies between its writes and its commit leaves nothing behind.
* Crash points: the JAX package's parse and encode cases
  (tests/test_crashpoints.py); the encoded plan string equals the JAX
  package's; `InjectedCrash` escapes ``except Exception``.
* Codec: seeded payloads of every type (VAL, ECHO, READY, BVAL, AUX, CONF
  with each mask, COIN with the nonce coin's agreement -1, DEC, HDR)
  encode to the JAX package's bytes, and each package decodes the other's.
* Journal: one sequence of `record` / `prune_below` calls with reopens in
  between leaves both packages' KVs with equal keys and values, and equal
  `entries`, `eras` and continued sequence numbers.
* Evidence: the JAX package's persist-and-reload case
  (tests/test_consensus_adversary.py) on the port; `EvidenceRecord.encode`
  gives the JAX package's bytes.
* A real death: a child process journals through `SqliteKV` under the
  plan `kv.write_batch.mid@K:sigkill` and dies by SIGKILL; the file then
  holds exactly the first K - 1 records, and a new journal continues at
  sequence K - 1.
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys

import pytest
import torch

from lachain_tpu.consensus import evidence as jevidence
from lachain_tpu.consensus import journal as jjournal
from lachain_tpu.consensus import messages as JM
from lachain_tpu.network import wire as jwire
from lachain_tpu.storage import crashpoints as jcrashpoints
from lachain_tpu.storage import kv as jkv
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.evidence import EvidenceRecord, EvidenceStore
from lachain_tpu_torch.consensus.journal import ConsensusJournal
from lachain_tpu_torch.network import wire
from lachain_tpu_torch.storage import crashpoints
from lachain_tpu_torch.storage.crashpoints import CrashPlan, CrashPoint, InjectedCrash
from lachain_tpu_torch.storage.kv import EntryPrefix, MemoryKV, SqliteKV, prefixed

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- KV ------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["memory", "sqlite", "sqlite_reopened"])
def test_kv_roundtrip(backend, tmp_path):
    """tests/test_storage.py's round trip on both backends; a SqliteKV
    reopened over its file reads back what the first one wrote."""
    path = str(tmp_path / "kv.db")
    kv = MemoryKV() if backend == "memory" else SqliteKV(path)
    kv.put(b"a", b"1")
    kv.put(b"ab", b"2")
    kv.put(b"b", b"3")
    assert kv.get(b"a") == b"1"
    assert kv.get(b"missing") is None
    assert list(kv.scan_prefix(b"a")) == [(b"a", b"1"), (b"ab", b"2")]
    kv.write_batch([(b"c", b"4"), (b"a", b"9")], deletes=[b"b"])
    assert kv.get(b"a") == b"9" and kv.get(b"b") is None and kv.get(b"c") == b"4"
    assert kv.scan_from(b"", b"a", 2) == [(b"ab", b"2"), (b"c", b"4")]
    kv.write_barrier(kv.write_batch_async([(b"d", b"5")], deletes=[b"c"]))
    kv.ingest([(b"e%d" % i, b"%d" % i) for i in range(5)], chunk=2)
    assert [k for k, _ in kv.scan_prefix(b"")] == [b"a", b"ab", b"d", b"e0", b"e1", b"e2",
                                                   b"e3", b"e4"]
    if backend == "sqlite_reopened":
        kv.close()
        kv = SqliteKV(path)
        assert len(list(kv.scan_prefix(b""))) == 8 and kv.get(b"e4") == b"4"
    kv.close()


@pytest.mark.parametrize("point", ["kv.write_batch.pre", "kv.write_batch.mid"])
def test_sqlite_batch_that_dies_leaves_nothing(point, tmp_path):
    """A batch that dies before its writes or between them and its commit
    leaves nothing behind, even after a later put commits and the file is
    reopened; a death after the commit (.post) keeps the batch."""
    path = str(tmp_path / "kv.db")
    kv = SqliteKV(path)
    kv.put(b"a", b"0")
    with crashpoints.armed(CrashPlan(points=(CrashPoint(point),))):
        with pytest.raises(InjectedCrash):
            kv.write_batch([(b"x", b"1"), (b"y", b"2")], deletes=[b"a"])
    kv.put(b"z", b"3")
    kv.close()
    kv = SqliteKV(path)
    assert list(kv.scan_prefix(b"")) == [(b"a", b"0"), (b"z", b"3")]
    with crashpoints.armed(CrashPlan(points=(CrashPoint("kv.write_batch.post"),))):
        with pytest.raises(InjectedCrash):
            kv.write_batch([(b"x", b"1")])
    assert kv.get(b"x") == b"1"
    kv.close()


# -- crash points ---------------------------------------------------------------


def test_crash_point_modes_parse_and_encode():
    """tests/test_crashpoints.py's cases; the plan string is the JAX
    package's for the same plan."""
    specs = ["block.persist.mid@3:sigkill", "pool.save.mid", "kv.write_batch.mid@7"]
    plan = CrashPlan.parse(specs)
    assert plan.points[0] == CrashPoint("block.persist.mid", 3, "sigkill")
    assert plan.points[1] == CrashPoint("pool.save.mid", 1, "raise")
    assert plan.encode_env() == (
        "block.persist.mid@3:sigkill,pool.save.mid@1:raise,kv.write_batch.mid@7:raise")
    assert plan.encode_env() == jcrashpoints.CrashPlan.parse(specs).encode_env()
    assert CrashPlan.parse(plan.encode_env().split(",")) == plan
    assert crashpoints.ENV_VAR == jcrashpoints.ENV_VAR
    with pytest.raises(ValueError):
        CrashPlan.parse_point("x@1:explode")
    with pytest.raises(ValueError):
        CrashPlan.parse_point("@2")


def test_injected_crash_not_swallowed_by_except_exception():
    with crashpoints.armed(CrashPlan(points=(CrashPoint("kv.write_batch.pre", 2),))) as s:
        crashpoints.crash_point("kv.write_batch.pre")  # hit 1: not due
        with pytest.raises(InjectedCrash) as info:
            try:
                crashpoints.crash_point("kv.write_batch.pre")
            except Exception:  # noqa: BLE001 - the point of the test
                pytest.fail("InjectedCrash caught by `except Exception`")
        assert (info.value.point, info.value.hit) == ("kv.write_batch.pre", 2)
        assert s.stats == {"visited": {"kv.write_batch.pre": 2},
                           "fired": [("kv.write_batch.pre", 2)]}
    assert crashpoints.active() is None
    crashpoints.crash_point("kv.write_batch.pre")  # disarmed: nothing


def test_arm_from_env(monkeypatch):
    monkeypatch.delenv(crashpoints.ENV_VAR, raising=False)
    assert crashpoints.arm_from_env() is None
    monkeypatch.setenv(crashpoints.ENV_VAR, "kv.write_batch.mid@4:sigkill")
    try:
        s = crashpoints.arm_from_env()
        assert s is crashpoints.active()
        assert s.plan.points == (CrashPoint("kv.write_batch.mid", 4, "sigkill"),)
    finally:
        crashpoints.disarm()


# -- codec ----------------------------------------------------------------------


def payload_pairs(seed: int):
    """Seeded payloads of every type -> [(JAX payload, port payload)]."""
    rng = random.Random(seed)

    def both(name, **fields):
        def conv(pkg, v):
            if isinstance(v, tuple) and v and isinstance(v[0], str):
                return getattr(pkg, v[0])(**{k: conv(pkg, x) for k, x in v[1].items()})
            return v
        return (getattr(JM, name)(**{k: conv(JM, v) for k, v in fields.items()}),
                getattr(M, name)(**{k: conv(M, v) for k, v in fields.items()}))

    def rbc():
        return ("ReliableBroadcastId", {"era": rng.randrange(1 << 40),
                                        "sender_id": rng.randrange(64)})

    def bb():
        return ("BinaryBroadcastId", {"era": rng.randrange(1 << 40),
                                      "agreement": rng.randrange(-1, 64),
                                      "epoch": rng.randrange(1 << 20)})

    def blob(lo=0, hi=300):
        return rng.randbytes(rng.randrange(lo, hi))

    out = []
    for cls in ("ValMessage", "EchoMessage"):
        for depth in (0, 1, 6):
            out.append(both(cls, rbc=rbc(), root=blob(32, 33),
                            branch=tuple(blob(32, 33) for _ in range(depth)),
                            shard=blob(), shard_index=rng.randrange(256)))
    out.append(both("ReadyMessage", rbc=rbc(), root=blob(32, 33)))
    for cls in ("BValMessage", "AuxMessage"):
        for value in (False, True):
            out.append(both(cls, bb=bb(), value=value))
    for values in ((), (False,), (True,), (False, True)):
        out.append(both("ConfMessage", bb=bb(), values=frozenset(values)))
    for agreement in (-1, 0, 63):
        coin = ("CoinId", {"era": rng.randrange(1 << 40), "agreement": agreement,
                           "epoch": rng.randrange(100)})
        out.append(both("CoinMessage", coin=coin, share=blob(96, 97)))
    out.append(both("DecryptedMessage", hb=("HoneyBadgerId", {"era": rng.randrange(1 << 40)}),
                    share_id=rng.randrange(64), payload=blob(100, 101)))
    out.append(both("SignedHeaderMessage",
                    root=("RootProtocolId", {"era": rng.randrange(1 << 40)}),
                    header_bytes=blob(150, 200), signature=blob(65, 66)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_codec_equals_jax_package(seed):
    pairs = payload_pairs(seed)
    assert {type(p).__name__ for _, p in pairs} == {
        "ValMessage", "EchoMessage", "ReadyMessage", "BValMessage", "AuxMessage",
        "ConfMessage", "CoinMessage", "DecryptedMessage", "SignedHeaderMessage"}
    for jp, pp in pairs:
        data = wire.encode_payload(pp)
        assert data == jwire.encode_payload(jp), type(pp).__name__
        assert wire.decode_payload(data) == pp
        assert jwire.decode_payload(data) == jp
    with pytest.raises(ValueError):
        wire.decode_payload(b"\x0a")  # unknown tag
    with pytest.raises(ValueError):
        wire.decode_payload(wire.encode_payload(pairs[0][1])[:-1])  # torn
    with pytest.raises(TypeError):
        wire.encode_payload(M.HoneyBadgerId(era=0))


# -- journal --------------------------------------------------------------------


def _journal_steps(journal_cls, kv):
    """One sequence of records, reopens and prunes -> what each step
    read back (entries, eras, the seq the next record of era 0 takes)."""
    seen = []
    j = journal_cls(kv)
    j.record(0, None, b"a")
    j.record(0, 3, b"bb")
    j.record(1, None, b"")
    j.record(2, 1, bytes(range(100)))
    j = journal_cls(kv)  # a reopen continues every era's sequence
    j.record(0, 2, b"after reopen")
    j.record(1, None, b"x" * 70)
    seen.append((list(j.entries()), j.eras()))
    assert j.prune_below(1) == 3
    assert j.prune_below(1) == 0
    j = journal_cls(kv)
    j.record(0, None, b"era 0 again")
    j.record(2, None, b"era 2")
    seen.append((list(j.entries()), j.eras()))
    return seen


def test_journal_equals_jax_package():
    kv, jax_kv = MemoryKV(), jkv.MemoryKV()
    seen = _journal_steps(ConsensusJournal, kv)
    assert seen == _journal_steps(jjournal.ConsensusJournal, jax_kv)
    assert list(kv.scan_prefix(b"")) == list(jax_kv.scan_prefix(b""))
    entries, eras = seen[0]
    assert [(e, s) for e, s, _t, _d in entries] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)]
    assert eras == [0, 1, 2]
    assert entries[2][2:] == (2, b"after reopen") and entries[0][2] is None
    # the pruned era 0 starts again at seq 0, era 2 continues at 1
    assert [(e, s) for e, s, _t, _d in seen[1][0]] == [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1)]
    assert all(k.startswith(prefixed(EntryPrefix.CONSENSUS_STATE)) and len(k) == 18
               for k, _ in kv.scan_prefix(b""))


def test_journal_counts_and_skips_torn_entries():
    kv = MemoryKV()
    j = ConsensusJournal(kv)
    j.record(5, None, b"ok")
    j.record(5, 2, b"ok too")
    kv.put(prefixed(EntryPrefix.CONSENSUS_STATE, bytes(16)), b"\x00\x01")  # torn value
    kv.put(prefixed(EntryPrefix.CONSENSUS_STATE, b"short"), b"")  # a key of no layout
    assert [d for _e, _s, _t, d in ConsensusJournal(kv).entries()] == [b"ok", b"ok too"]
    assert (j.records, j.pruned) == (2, 0)
    # the torn record lies in era 0: pruned with the rest, by its key
    assert j.prune_below(6) == 3 and j.pruned == 3
    assert [k for k, _ in kv.scan_prefix(b"")] == [prefixed(EntryPrefix.CONSENSUS_STATE, b"short")]


# -- evidence -------------------------------------------------------------------


def test_evidence_store_persists_and_reloads(tmp_path):
    """tests/test_consensus_adversary.py's case on the port's store."""
    kv = SqliteKV(str(tmp_path / "ev.db"))
    try:
        s1 = EvidenceStore(kv)
        assert s1.record_equivocation(1, 3, "coin", (0, 2))
        assert s1.record_equivocation(1, 3, "coin", (-1, 0))  # nonce coin
        assert s1.record_invalid_share(2, 5, "dec", (4,))
        assert not s1.record_equivocation(1, 3, "coin", (0, 2))
        assert len(s1) == 3
        s2 = EvidenceStore(kv)
        assert s2.record_set() == s1.record_set()
        assert s2.record_set(era=1) == s1.record_set(era=1)
        assert not s2.record_equivocation(1, 3, "coin", (0, 2))
        assert len(s2) == 3
        assert any(rec["index"] == [-1, 0] for rec in s2.snapshot(era=1))
        # the sequence continues: a new record after the reload is the 4th
        assert s2.record_equivocation(3, 1, "hdr", ())
        keys = [k for k, _ in kv.scan_prefix(prefixed(EntryPrefix.EVIDENCE))]
        assert [int.from_bytes(k[2:], "big") for k in keys] == [0, 1, 2, 3]
        assert EvidenceStore(kv).record_set() == s2.record_set()
    finally:
        kv.close()


def test_evidence_cap_counts_drops():
    s = EvidenceStore(MemoryKV(), cap=2)
    assert s.record_equivocation(0, 1, "aux", (0, 0))
    assert s.record_equivocation(0, 2, "aux", (0, 0))
    assert not s.record_equivocation(0, 3, "aux", (0, 0))
    assert (len(s), s.dropped) == (2, 1)


def test_evidence_records_encode_as_jax_package():
    rng = random.Random(11)
    store, jax_store = EvidenceStore(MemoryKV()), jevidence.EvidenceStore(jkv.MemoryKV())
    for _ in range(40):
        era, who = rng.randrange(1 << 40), rng.randrange(64)
        proto, index = rng.choice([("coin", (rng.randrange(-1, 64), rng.randrange(9))),
                                   ("dec", (rng.randrange(64),)), ("hdr", ()),
                                   ("bval", (3, 1, rng.randrange(2)))])
        kind = rng.choice(["record_equivocation", "record_invalid_share"])
        assert getattr(store, kind)(era, who, proto, index) == getattr(
            jax_store, kind)(era, who, proto, index)
    for rec, jrec in zip(store.records(), jax_store.records()):
        assert rec.encode() == jrec.encode()
        assert EvidenceRecord.decode(jrec.encode()) == rec
    assert list(store._kv.scan_prefix(b"")) == list(jax_store._kv.scan_prefix(b""))


# -- a real death ---------------------------------------------------------------

_CHILD = """
import sys
from lachain_tpu_torch.consensus.journal import ConsensusJournal
from lachain_tpu_torch.storage import crashpoints
from lachain_tpu_torch.storage.kv import SqliteKV
assert crashpoints.arm_from_env() is not None
journal = ConsensusJournal(SqliteKV(sys.argv[1]))
for i in range(int(sys.argv[2])):
    journal.record(0, i % 3 - 1 if i % 3 else None, b"record %d " % i + bytes(i))
print("survived")
"""


@pytest.mark.parametrize("k", [1, 5])
def test_sigkill_mid_batch_keeps_the_first_k_minus_1_records(k, tmp_path):
    path = str(tmp_path / "journal.db")
    plan = CrashPlan(points=(CrashPoint("kv.write_batch.mid", k, "sigkill"),))
    env = dict(os.environ, PYTHONPATH=_ROOT, **{crashpoints.ENV_VAR: plan.encode_env()})
    child = subprocess.run([sys.executable, "-c", _CHILD, path, str(2 * k + 3)], cwd=_ROOT,
                           env=env, capture_output=True, text=True, timeout=60)
    assert child.returncode == -signal.SIGKILL, child.stderr
    assert "survived" not in child.stdout
    kv = SqliteKV(path)
    try:
        journal = ConsensusJournal(kv)
        entries = list(journal.entries())
        assert [(e, s) for e, s, _t, _d in entries] == [(0, i) for i in range(k - 1)]
        assert [d for _e, _s, _t, d in entries] == [
            b"record %d " % i + bytes(i) for i in range(k - 1)]
        assert len(list(kv.scan_prefix(b""))) == k - 1  # no torn row
        journal.record(0, None, b"after the restart")
        assert list(journal.entries())[-1][:2] == (0, k - 1)
    finally:
        kv.close()
