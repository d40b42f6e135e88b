"""The port's LSM engine (lachain_tpu_torch/storage/lsm.py over its copy of
native/lsm.cpp, built by ops/_build.lsm_library()) on the CPU.

Modelled on the JAX package's tests/test_lsm.py: a seeded differential
against MemoryKV with restarts and compaction, empty values, a torn WAL
tail, a legacy v1 store and a corrupt sealed segment refused, tombstones
dropped by compaction, a mid-compaction orphan recovered, `scan_from`
pages equal to SqliteKV's, the engine's counters, kill -9 atomicity in a
child process. Then the two packages' engines open each other's
directories with the same rows: they share the on-disk format.

The JAX engine is a private g++ build of the JAX package's lsm.cpp, made
under `tmp_path_factory` and loaded through `LACHAIN_LSM_LIB` before this
worker's first JAX LsmKV: the JAX package's own loader runs `make` on its
gitignored library, which tests/test_lsm.py on another worker may be
running at the same moment. The other storage test files import the
`jax_lsm` fixture from here.
"""
from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from lachain_tpu.storage import lsm as jlsm_mod
from lachain_tpu_torch.storage.kv import MemoryKV, SqliteKV
from lachain_tpu_torch.storage.lsm import LsmKV

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_ENGINE = os.path.join(_REPO, "lachain_tpu", "storage", "native", "lsm.cpp")


@pytest.fixture(scope="session")
def jax_lsm(tmp_path_factory):
    """The JAX package's LsmKV class over a private build of its engine,
    unless this worker loaded one already."""
    if jlsm_mod._lib_cache[0] is None:
        so = tmp_path_factory.mktemp("jax_lsm") / "libllsm.so"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", str(so),
                        _JAX_ENGINE], check=True, capture_output=True)
        old = os.environ.get("LACHAIN_LSM_LIB")
        os.environ["LACHAIN_LSM_LIB"] = str(so)
        try:
            jlsm_mod._load_lib()
        finally:
            if old is None:
                del os.environ["LACHAIN_LSM_LIB"]
            else:
                os.environ["LACHAIN_LSM_LIB"] = old
    return jlsm_mod.LsmKV


def rand_kv(r, kspace=200):
    k = f"k{r.randrange(kspace):05d}".encode() + bytes([r.randrange(4)])
    v = bytes(r.randrange(256) for _ in range(r.randrange(0, 300)))
    return k, v


def rows(kv) -> list:
    return list(kv.scan_prefix(b""))


def test_differential_with_restarts_and_compaction(tmp_path):
    r = random.Random(42)
    path = str(tmp_path / "db")
    db = LsmKV(path, flush_threshold=4096)
    ref = MemoryKV()
    for step in range(400):
        op = r.randrange(10)
        if op < 6:
            puts = [rand_kv(r) for _ in range(r.randrange(1, 8))]
            dels = [rand_kv(r)[0] for _ in range(r.randrange(0, 3))]
            db.write_batch(puts, dels)
            ref.write_batch(puts, dels)
        elif op < 8:
            k, v = rand_kv(r)
            db.put(k, v)
            ref.put(k, v)
        elif op == 8:
            k, _ = rand_kv(r)
            db.delete(k)
            ref.delete(k)
        else:  # a restart: WAL replay and manifest load
            db.close()
            db = LsmKV(path, flush_threshold=4096)
        if step % 50 == 7:
            for _ in range(20):
                k, _ = rand_kv(r)
                assert db.get(k) == ref.get(k), k
            assert dict(db.scan_prefix(b"k0")) == dict(ref.scan_prefix(b"k0"))
    db.flush()
    db.wait_compaction()
    assert db.table_count() <= 7
    db.close()
    db = LsmKV(path, flush_threshold=4096)
    assert rows(db) == sorted(ref.scan_prefix(b""))
    db.close()


def test_empty_values_and_missing_keys(tmp_path):
    db = LsmKV(str(tmp_path / "db"))
    db.put(b"empty", b"")
    assert db.get(b"empty") == b""
    assert db.get(b"missing") is None
    db.delete(b"empty")
    assert db.get(b"empty") is None
    db.flush()
    assert db.get(b"empty") is None
    db.close()


_CRASH_PROG = textwrap.dedent("""
    import sys
    from lachain_tpu_torch.storage.lsm import LsmKV
    db = LsmKV(sys.argv[1], flush_threshold=2048)
    i = 0
    print("READY", flush=True)
    while True:
        db.write_batch([
            (b"marker", str(i).encode()),
            (f"data{i:06d}".encode(), bytes([i % 256]) * 64),
        ])
        i += 1
""")


def test_kill9_crash_atomicity(tmp_path):
    """kill -9 in a write storm: the reopened store holds the data of
    every batch whose marker it holds, and takes new writes."""
    path = str(tmp_path / "db")
    LsmKV(path).close()  # the engine built before the child starts
    env = dict(os.environ, PYTHONPATH=_REPO)
    p = subprocess.Popen([sys.executable, "-c", _CRASH_PROG, path], stdout=subprocess.PIPE,
                         env=env)
    assert p.stdout.readline().strip() == b"READY"
    time.sleep(1.5)
    p.send_signal(signal.SIGKILL)
    p.wait()
    db = LsmKV(path, flush_threshold=2048)
    marker = db.get(b"marker")
    assert marker is not None
    i = int(marker)
    assert i > 10, f"only {i} batches before the kill"
    assert db.get(f"data{i:06d}".encode()) == bytes([i % 256]) * 64
    for j in range(0, i, max(1, i // 17)):
        assert db.get(f"data{j:06d}".encode()) == bytes([j % 256]) * 64
    db.put(b"after", b"crash")
    db.close()
    db = LsmKV(path)
    assert db.get(b"after") == b"crash"
    db.close()


def test_torn_wal_tail_truncated_on_open(tmp_path):
    """A torn tail of the active WAL segment is cut off at open, so that
    records appended later stay reachable to every replay."""
    path = str(tmp_path / "db")
    db = LsmKV(path)
    db.put(b"a", b"1")
    db.close()
    active = sorted(f for f in os.listdir(path) if f.startswith("wal_") and f.endswith(".log"))[-1]
    with open(os.path.join(path, active), "ab") as fh:
        fh.write(b"\xde\xad\xbe\xef garbage torn record")
    db = LsmKV(path)
    assert db.get(b"a") == b"1"
    db.put(b"b", b"2")
    db.close()
    db = LsmKV(path)
    assert (db.get(b"a"), db.get(b"b")) == (b"1", b"2")
    db.close()


def test_legacy_v1_store_refused(tmp_path):
    path = str(tmp_path / "db")
    os.makedirs(path)
    with open(os.path.join(path, "wal.log"), "wb") as fh:
        fh.write(b"v1 records the v2 engine cannot decode")
    with pytest.raises(IOError):
        LsmKV(path)


def test_corrupt_sealed_segment_refused(tmp_path):
    """A bad record in a sealed (not the last) segment is corruption: the
    engine refuses the store."""
    path = str(tmp_path / "db")
    db = LsmKV(path)
    db.put(b"a", b"1")
    db.close()
    first = os.path.join(path, "wal_000001.log")
    assert os.path.exists(first)
    with open(os.path.join(path, "wal_000002.log"), "wb") as fh:
        fh.write(b"")
    with open(first, "r+b") as fh:
        fh.seek(4)
        b0 = fh.read(1)
        fh.seek(4)
        fh.write(bytes([b0[0] ^ 0xFF]))
    with pytest.raises(IOError):
        LsmKV(path)


def test_read_path_stats(tmp_path):
    """Bloom filters and the block cache serve the point reads; stats()
    counts them, the WAL's fsyncs and records; the flight recorder is
    off."""
    db = LsmKV(str(tmp_path / "db"), flush_threshold=4096)
    for i in range(300):
        db.put(f"aa{i:04d}".encode(), bytes(40))
    db.flush()
    db.wait_compaction()
    assert db.table_count() >= 1
    for i in range(0, 300, 7):
        assert db.get(f"aa{i:04d}".encode()) == bytes(40)
    for i in range(300):
        db.get(f"aa{i:04d}x".encode())
    s = db.stats()
    assert s["bloom_hits"] > 0 and s["bloom_misses"] > 0 and s["cache_hits"] > 0, s
    assert s["wal_fsyncs"] > 0 and s["wal_records"] >= 300, s
    assert s["table_count"] == db.table_count() and s["trace_dropped"] == 0, s
    db.close()


def test_compaction_merges_and_drops_tombstones(tmp_path):
    path = str(tmp_path / "db")
    db = LsmKV(path, flush_threshold=1024)
    for i in range(50):
        db.put(f"k{i:03d}".encode(), b"v" * 100)
    db.flush()
    for i in range(0, 50, 2):
        db.delete(f"k{i:03d}".encode())
    db.flush()
    db.compact()
    assert db.table_count() == 1
    assert db.get(b"k000") is None and db.get(b"k001") == b"v" * 100
    db.close()
    db = LsmKV(path)
    assert db.get(b"k000") is None and db.get(b"k001") == b"v" * 100
    assert len(rows(db)) == 25
    db.close()


def test_mid_compaction_orphan_recovered(tmp_path):
    """The merged SST renamed into place but the manifest swap lost: open()
    removes the orphan and serves the old table set."""
    path = str(tmp_path / "db")
    db = LsmKV(path, flush_threshold=1024)
    for i in range(60):
        db.put(f"k{i:03d}".encode(), bytes([i]) * 80)
    db.flush()
    db.wait_compaction()
    before = db.table_count()
    assert db._lib.lsm_compact_partial(db._h) == 0
    db.close()
    ssts = [f for f in os.listdir(path) if f.startswith("sst_")]
    with open(os.path.join(path, "MANIFEST")) as fh:
        manifest = set(fh.read().split())
    orphans = [f for f in ssts if f not in manifest]
    assert orphans
    db = LsmKV(path, flush_threshold=1024)
    assert db.table_count() == before
    assert not any(os.path.exists(os.path.join(path, f)) for f in orphans)
    for i in range(60):
        assert db.get(f"k{i:03d}".encode()) == bytes([i]) * 80
    db.close()


def test_scan_from_pages_equal_sqlite(tmp_path):
    """The engine's cursor pages equal SqliteKV's over a keyspace spread
    over the memtable and sealed tables, with overwrites and tombstones;
    paging to the end visits each live row once, in order."""
    r = random.Random(9)
    lsm = LsmKV(str(tmp_path / "lsm"), flush_threshold=2048)
    sq = SqliteKV(str(tmp_path / "sq.db"))
    live = {}
    for step in range(900):
        k = b"T" + r.randrange(300).to_bytes(4, "big")
        if r.randrange(10) == 0 and live:
            k = r.choice(sorted(live))
            del live[k]
            lsm.delete(k)
            sq.delete(k)
        else:
            v = bytes([r.randrange(256)]) * r.randrange(1, 48)
            live[k] = v
            lsm.put(k, v)
            sq.put(k, v)
        if step == 450:
            lsm.flush()
    for kv in (lsm, sq):
        kv.put(b"S" + b"\xff" * 4, b"below")
        kv.put(b"U" + b"\x00" * 4, b"above")
    assert lsm.table_count() >= 1
    for limit in (1, 7, 64, 10_000):
        cursor, pages = b"", []
        while True:
            page = lsm.scan_from(b"T", cursor, limit)
            assert page == sq.scan_from(b"T", cursor, limit), (limit, cursor)
            if not page:
                break
            pages.extend(page)
            cursor = page[-1][0][1:]
        assert dict(pages) == live and [k for k, _ in pages] == sorted(live)
    assert lsm.scan_from(b"T", b"", 0) == []
    lsm.close()
    sq.close()


def test_async_batches_barrier_and_ingest(tmp_path):
    """write_batch_async returns increasing tickets; after write_barrier
    of the last every batch is durable across a reopen; ingest loads in
    batches and seals the memtable into a table."""
    path = str(tmp_path / "db")
    db = LsmKV(path)
    assert db.supports_async_batches
    tickets = [db.write_batch_async([(b"a%03d" % i, bytes([i]))]) for i in range(50)]
    assert tickets == sorted(tickets) and len(set(tickets)) == 50
    db.write_barrier(tickets[-1])
    db.write_barrier(None)
    db.ingest([(b"i%05d" % i, b"x" * 20) for i in range(5000)], chunk=700)
    assert db.table_count() >= 1
    db.close()
    db = LsmKV(path)
    assert all(db.get(b"a%03d" % i) == bytes([i]) for i in range(50))
    assert len(list(db.scan_prefix(b"i"))) == 5000
    db.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_open_in_the_other_package(tmp_path, jax_lsm, writer):
    """A store written by one package's LsmKV (puts, deletes, overwrites,
    flushed tables, a compaction and a WAL tail) opens in the other's with
    the same rows, and takes its writes; each package then reopens it."""
    make = {"jax": jax_lsm, "port": LsmKV}
    other = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "db")
    r = random.Random(17)
    ref = MemoryKV()
    db = make[writer](path, flush_threshold=2048)
    for step in range(300):
        puts = [rand_kv(r) for _ in range(r.randrange(1, 5))]
        dels = [rand_kv(r)[0] for _ in range(r.randrange(0, 2))]
        db.write_batch(puts, dels)
        ref.write_batch(puts, dels)
        if step == 150:
            db.flush()
            db.compact()
    db.close()
    want = sorted(ref.scan_prefix(b""))
    db = make[other](path, flush_threshold=2048)
    assert rows(db) == want
    assert db.scan_from(b"k", b"", 10) == want[:10]
    db.put(b"zz-" + other.encode(), b"written")
    db.close()
    for name in (writer, other):
        db = make[name](path)
        assert db.get(b"zz-" + other.encode()) == b"written"
        assert rows(db)[:-1] == want
        db.close()
