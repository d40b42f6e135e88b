"""The port's observability hooks at their call sites, on the CPU.

After a seeded (4, 1) era on each engine, and after a small block through
`BlockManager(device="cpu")`:
  * every plain attribute that stays beside a metric equals it: the
    routers' `shed`, `replayed_sends`, the journals' `records` /
    `pruned`, `EvidenceStore.dropped` and its kind counters,
    `FaultSession.stats`, the native network's `crossings`, the trie's
    `merkle_stats`, `ParallelStats` and `LsmKV.stats()`;
  * `consensus_messages_processed` relates to `delivered_count` as the
    engines make it: on the Python engine every delivery is one envelope
    at one live protocol (the internal requests and results on top), on
    the native engine no message reaches a Python protocol;
  * a traced era's blocks and `delivered_count` equal an untraced era's
    on both engines (the Python engine's tracer replaced by no-ops; the
    native engine's recorder at capacity 0);
  * a block's spans, chain metrics and transaction stamps (pool ->
    propose -> exec -> commit, the stages summing to the end-to-end span);
  * `LsmKV._drain_trace` feeds the metrics with the store's lock released:
    a patched `metrics.observe_hist` that re-enters the store finishes
    (with the lock held it would wait forever).

The eras run the TPKE era on the host pipeline, as in
tests/test_torch_consensus.py. Every case resets the port's registries.
"""
from __future__ import annotations

import threading
from collections import Counter

import pytest
import torch

from lachain_tpu_torch.consensus import evidence
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.root_protocol import RootProtocol
from lachain_tpu_torch.utils import metrics, tracing, txtrace
from tests.test_torch_consensus import carried_keys, drive, port_net
from tests.test_torch_native_rt import port_native, run_native_root
from tests.test_torch_root_protocol import PortProducer, factories, proposals, run_root
from tests.torch_exec_common import CHAIN, PORT, account, reset_module_state, signed, warm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()
    txtrace.reset_for_tests()
    evidence.reset_era_counts()
    yield
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()
    txtrace.reset_for_tests()
    evidence.reset_era_counts()


def _processed() -> float:
    return metrics.MESSAGES_PROCESSED[0] + metrics.counter_value("consensus_messages_processed")


def _hb(n=4):
    return [b"payload|%d|" % i + bytes(16) for i in range(n)]


def _python_root(seed=31, **kw):
    pub, privs = carried_keys(4, 1)[1]
    net = port_net(4, 1, seed, extra_factories={M.RootProtocolId: factories(
        RootProtocol, [PortProducer(t) for t in proposals(4)[1]], pub, privs, None)}, **kw)
    return net, run_root(net, M.RootProtocolId(era=0), range(4))


def _native_root(seed=31, capacity=None, **kw):
    pub, privs = carried_keys(4, 1)[1]
    net = port_native(4, 1, seed, use_rbc_batcher=True, **kw)
    if capacity is not None:
        net.trace_configure(capacity)
    out = run_native_root(net, M.RootProtocolId(era=0),
                          [PortProducer(t) for t in proposals(4)[1]], pub, privs, range(4))
    return net, out


def _blocks(out):
    done, delivered, blocks = out
    assert done
    return delivered, [b.encode() for b in blocks]


def test_python_engine_attributes_equal_metrics():
    """A (4, 1) HoneyBadger era on the Python engine, router 3's latch cap
    low enough to shed: `shed` equals consensus_msgs_shed_total by reason,
    and every delivery reached a protocol."""
    net = port_net(4, 1, 11)
    net.routers[3].first_seen_sender_cap = 20
    out = drive(net, M.HoneyBadgerId(era=0), _hb(), range(3))
    assert out[0]
    for reason in ("latch_cap", "postponed_cap"):
        assert metrics.counter_value("consensus_msgs_shed_total", {"reason": reason}) == sum(
            r.shed[reason] for r in net.routers)
    assert net.routers[3].shed["latch_cap"] > 0
    assert _processed() >= net.delivered_count > 0
    calls = metrics.counter_value("crypto_tpu_era_kernel_calls_total")
    assert calls == net.backend.era_calls > 0
    assert net.crypto_batcher.flushes == metrics.histogram_snapshot("tpke_flush_slots")["count"]


def test_native_engine_attributes_equal_metrics():
    """A (4, 1) root era on the native engine: `crossings` equals
    consensus_callback_crossings_total op for op and the drained cross:*
    events count the same; no message reached a Python protocol."""
    net, out = _native_root()
    assert out[0]
    series = metrics.counters_with_prefix("consensus_callback_crossings_total")
    by_op = {dict(labels)["op"]: v for (_name, labels), v in series.items()}
    assert by_op == {op: c for op, c in net.crossings.items() if c}
    crossed = Counter(e["args"]["op"] for e in tracing.native_snapshot()
                      if e["cat"] == "native.cross")
    from lachain_tpu_torch.consensus.native_hosts import XO_NAMES

    assert crossed == Counter({op: net.crossings[op] for op in XO_NAMES.values()
                               if net.crossings[op]})
    assert _processed() == 0 and net.crossings["opaque_message"] == 0
    assert metrics.gauge_value("consensus_native_handled_messages") == net.native_handled()
    net.close()


def test_traced_era_equals_untraced_python_engine(monkeypatch):
    """The Python engine's root era with its tracer and metrics replaced by
    no-ops gives the traced era's blocks and delivered_count."""
    traced = _blocks(_python_root()[1])
    assert tracing.snapshot()
    tracing.reset_for_tests()

    class _Null:
        def __enter__(self):
            return 0

        def __exit__(self, *exc):
            return False

    for name in ("begin", "instant", "end", "annotate"):
        monkeypatch.setattr(tracing, name, lambda *a, **k: 0)
    monkeypatch.setattr(tracing, "span", lambda *a, **k: _Null())
    monkeypatch.setattr(tracing, "wait", lambda *a, **k: _Null())
    for name in ("inc", "set_gauge", "observe_hist", "observe"):
        monkeypatch.setattr(metrics, name, lambda *a, **k: None)
    assert _blocks(_python_root()[1]) == traced
    assert tracing.snapshot() == []


def test_traced_era_equals_untraced_native_engine():
    """The native root era with the engine's recorder at capacity 0 gives
    the traced era's blocks and delivered_count; it records nothing."""
    net, out = _native_root()
    traced = _blocks(out)
    assert [e for e in tracing.native_snapshot() if e["cat"] == "native.cross"]
    net.close()
    tracing.reset_for_tests()
    net, out = _native_root(capacity=0)
    assert _blocks(out) == traced
    assert [e for e in tracing.native_snapshot() if e.get("replace_key") is None] == []
    net.close()


def test_faults_journal_and_evidence_attributes_equal_metrics(tmp_path):
    from lachain_tpu_torch.consensus.journal import ConsensusJournal
    from lachain_tpu_torch.network.faults import FaultPlan
    from lachain_tpu_torch.storage.kv import MemoryKV

    plan = FaultPlan(seed=3, drop=0.05, duplicate=0.05, delay=0.05)
    net = port_net(4, 1, 11, fault_plan=plan)
    assert drive(net, M.HoneyBadgerId(era=0), _hb(), range(4))[0]
    stats = net.faults.stats
    for stat, action in (("dropped", "drop"), ("duplicated", "dup"), ("delayed", "delay"),
                         ("blocked", "blocked"), ("reordered", "reorder")):
        assert metrics.counter_value("fault_injected_total", {"action": action}) == stats[stat]
    assert stats["dropped"] and stats["duplicated"] and stats["delayed"]

    journal = ConsensusJournal(MemoryKV())
    for era in range(3):
        for seq in range(4):
            journal.record(era, None if seq % 2 else seq, b"send|%d|%d" % (era, seq))
    journal.prune_below(2)
    assert metrics.counter_value("consensus_journal_records_total") == journal.records == 12
    assert metrics.counter_value("consensus_journal_pruned_total") == journal.pruned == 8

    store = evidence.EvidenceStore(kv=MemoryKV(), cap=2)
    assert store.record_equivocation(5, 1, "aux", (0, 1))
    assert not store.record_equivocation(5, 1, "aux", (0, 1))  # deduped
    assert store.record_invalid_share(5, 2, "dec", (3,))
    assert not store.record_invalid_share(6, 2, "dec", (4,))  # past the cap
    assert metrics.counter_value("consensus_evidence_dropped_total") == store.dropped == 1
    assert metrics.counter_value("consensus_equivocations_total", {"proto": "aux"}) == 1
    assert metrics.counter_value("consensus_invalid_shares_total", {"proto": "dec"}) == 1
    assert evidence.era_counts() == {5: {"equivocation": 1, "invalid_share": 1}}


def test_journal_replayed_sends_equal_metric():
    """A router re-armed from its journal substitutes the recorded bytes for
    a slot it sends again: `replayed_sends` equals the counter."""
    from lachain_tpu_torch.consensus.journal import ConsensusJournal
    from lachain_tpu_torch.consensus.era import EraRouter
    from lachain_tpu_torch.storage.kv import MemoryKV

    journals = [ConsensusJournal(MemoryKV()) for _ in range(4)]
    net = port_net(4, 1, 11, router_cls=lambda **kw: EraRouter(
        journal=journals[kw["my_id"]], **kw))
    assert drive(net, M.HoneyBadgerId(era=0), _hb(), range(4))[0]
    again = port_net(4, 1, 11, router_cls=lambda **kw: EraRouter(
        journal=journals[kw["my_id"]], **kw))
    for router, journal in zip(again.routers, journals):
        for era, _seq, target, data in journal.entries():
            router.rearm_sent(era, target, data)
    assert drive(again, M.HoneyBadgerId(era=0), _hb(), range(4))[0]
    replayed = sum(r.replayed_sends for r in again.routers)
    assert replayed > 0
    assert metrics.counter_value("consensus_journal_replayed_sends_total") == replayed


def test_block_hooks_and_timelines(tmp_path):
    """32 transfers through the pool, a proposal and a block on an LsmKV:
    the block's spans, chain metrics and every transfer's timeline (pool
    -> propose -> exec -> commit, stages summing to the end-to-end span);
    merkle_stats, the parallel lanes' stats and LsmKV.stats() equal their
    metrics."""
    from lachain_tpu_torch.storage.lsm import LsmKV

    reset_module_state()
    txtrace.set_sample_shift(0)
    kv = LsmKV(str(tmp_path / "db"))
    try:
        state = PORT.state.StateManager(kv)
        bm = PORT.block_manager.BlockManager(
            kv, state, PORT.system_contracts.make_executer(CHAIN), lanes=2, device="cpu")
        accounts = [account(4100 + i) for i in range(8)]
        bm.build_genesis({a: 10**18 for _, a in accounts}, CHAIN)
        pool = PORT.tx_pool.TransactionPool(kv, CHAIN, account_nonce=lambda a: 0)
        producer = PORT.block_producer.BlockProducer(bm, pool, 1, txs_per_block=64)
        # 32 transfers, four a sender: enough for the lanes' parallel path
        txs = [signed(PORT, accounts[i % 8][0], accounts[(i + 1) % 8][1], 7, i // 8)
               for i in range(32)]
        warm(txs)
        assert all(pool.add(t) for t in txs)
        proposal = producer.get_transactions_to_propose()
        assert len(proposal) == 32
        header = producer.create_header(1, proposal, 0)
        merkle0 = metrics.counter_value("trie_nodes_hashed_total")
        nodes0 = state.trie.merkle_stats.get("nodes", 0)
        bm.execute_block(header, proposal, PORT.types.MultiSig(()))
        assert metrics.gauge_value("chain_height") == 1
        assert metrics.counter_value("chain_txs_total") == 32
        assert metrics.timer_snapshot()["block_execute"]["count"] == 1
        names = {(s["name"], s["args"].get("era")) for s in tracing.snapshot()}
        assert {("exec.block", 1), ("merkle.freeze", 1)} <= names
        assert (metrics.counter_value("trie_nodes_hashed_total") - merkle0
                == state.trie.merkle_stats["nodes"] - nodes0)
        ps = bm.last_parallel_stats  # create_header's run; execute_block hit the memo
        assert ps is not None and metrics.counter_value("exec_blocks_parallel_total") == 1
        assert metrics.counter_value("exec_txs_validated_total") == ps.validated
        assert metrics.counter_value("exec_txs_straggler_total") == ps.stragglers
        assert metrics.gauge_value("exec_lanes") == ps.lanes
        for t in txs:
            tl = txtrace.timeline(t.hash())
            assert [s["stage"] for s in tl["stages"]] == ["pool", "propose", "exec", "commit"]
            assert sum(s["dur_s"] for s in tl["stages"]) == pytest.approx(tl["e2e_s"], abs=1e-5)
        assert metrics.histogram_snapshot("tx_e2e_seconds")["count"] == 32
        assert metrics.histogram_snapshot("txpool_admit_lock_wait_seconds")["count"] == 32
        st = kv.stats()
        assert metrics.gauge_value("lsm_wal_fsyncs_total") == st["wal_fsyncs"] > 0
        assert metrics.gauge_value("lsm_compaction_backlog") == st["compact_backlog"]
    finally:
        kv.close()
        reset_module_state()


def test_lsm_drain_feeds_metrics_outside_the_store_lock(tmp_path, monkeypatch):
    """A metrics call made from inside LsmKV._drain_trace re-enters the
    store (a write_batch, which takes `_lock`): it finishes within a few
    seconds because the drain released the lock before feeding the
    metrics."""
    from lachain_tpu_torch.storage import lsm

    store = lsm.LsmKV(str(tmp_path / "db"))
    hung = True
    try:
        store.write_batch([(b"k", b"v")])
        real = metrics.observe_hist
        reentered = []

        def reenter(name, value, *a, **k):
            if not reentered:
                reentered.append(name)
                store.write_batch([(b"again", b"v")])
            return real(name, value, *a, **k)

        monkeypatch.setattr(lsm.metrics, "observe_hist", reenter)
        worker = threading.Thread(target=store._drain_trace, daemon=True)
        worker.start()
        worker.join(timeout=10)
        hung = worker.is_alive()
    finally:
        monkeypatch.undo()
    if hung:
        # the lock stays taken: leave the store open, and out of the tracer
        tracing.unregister_native_source(store._trace_source)
    else:
        store.close()
    assert not hung, "the drain fed the metrics under the store's lock"
    assert reentered
