"""The port's metrics registry (`lachain_tpu_torch/utils/metrics.py`), on the CPU.

The cases of tests/test_metrics.py against the port's modules: timers and
their per-era snapshot, the crypto ops' timers, the text exposition,
histograms and their buckets, labeled series, the label-cardinality cap
per family and kind, and the protocols' watchdog breadcrumbs through the
port's simulator. One case more holds the two packages' registries
together: the same sequence of registry calls renders the same
`render_text()` in both.

Every case resets the port's registry itself (and the JAX package's where
it uses it).
"""
from __future__ import annotations

import time

import pytest
import torch

from lachain_tpu.utils import metrics as jmetrics
from lachain_tpu_torch.utils import metrics, tracing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()
    yield
    metrics.reset_all_for_tests()
    tracing.reset_for_tests()


def test_measure_and_snapshot_reset():
    with metrics.measure("crypto_test_op"):
        time.sleep(0.01)
    with metrics.measure("crypto_test_op"):
        pass
    snap = metrics.timer_snapshot(reset=True)
    assert snap["crypto_test_op"]["count"] == 2
    assert snap["crypto_test_op"]["total_ms"] >= 10
    assert metrics.timer_snapshot() == {}


def test_crypto_ops_are_instrumented():
    from lachain_tpu_torch.consensus.simulator import SeededRng
    from lachain_tpu_torch.crypto import ecdsa

    priv = ecdsa.generate_private_key(SeededRng(1))
    sig = ecdsa.sign_hash(priv, b"\x01" * 32)
    assert ecdsa.verify_hash(ecdsa.public_key_bytes(priv), b"\x01" * 32, sig)
    snap = metrics.timer_snapshot()
    assert snap["crypto_ec_sign"]["count"] == 1
    assert snap["crypto_ec_verify"]["count"] == 1


def test_render_text_exposition():
    metrics.inc("consensus_messages_processed", 3)
    metrics.set_gauge("chain_height", 7)
    metrics.observe("block_execute", 0.5)
    text = metrics.render_text()
    assert "consensus_messages_processed 3.0" in text
    assert "chain_height 7" in text
    assert "block_execute_seconds_count 1" in text


def test_histogram_buckets_and_exposition():
    h = metrics.histogram("req_latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    snap = h.snapshot()
    assert snap["count"] == 3
    assert abs(snap["sum"] - 5.55) < 1e-9
    # cumulative le semantics: 0.05 <= 0.1; 0.5 lands in the 1.0 bucket
    assert snap["buckets"] == [(0.1, 1), (1.0, 2)]
    text = metrics.render_text()
    assert "# TYPE req_latency histogram" in text
    assert 'req_latency_bucket{le="0.1"} 1' in text
    assert 'req_latency_bucket{le="1"} 2' in text
    assert 'req_latency_bucket{le="+Inf"} 3' in text
    assert "req_latency_count 3" in text
    assert "req_latency_sum 5.55" in text


def test_labeled_counters_and_histograms():
    metrics.inc("rpc_calls", labels={"method": "eth_call"})
    metrics.inc("rpc_calls", 2, labels={"method": "eth_send"})
    assert metrics.counter_value("rpc_calls", labels={"method": "eth_call"}) == 1.0
    assert metrics.counter_value("rpc_calls", labels={"method": "eth_send"}) == 2.0
    metrics.observe_hist("proto_duration", 0.2, buckets=(0.1, 1.0), labels={"proto": "BA"})
    metrics.observe_hist("proto_duration", 0.05, buckets=(0.1, 1.0), labels={"proto": "RBC"})
    text = metrics.render_text()
    assert 'rpc_calls{method="eth_call"} 1.0' in text
    assert 'rpc_calls{method="eth_send"} 2.0' in text
    # one TYPE header covers every labeled series of the name
    assert text.count("# TYPE rpc_calls counter") == 1
    assert text.count("# TYPE proto_duration histogram") == 1
    # the label comes before le in bucket lines
    assert 'proto_duration_bucket{proto="BA",le="1"} 1' in text
    assert 'proto_duration_bucket{proto="RBC",le="0.1"} 1' in text
    assert 'proto_duration_count{proto="BA"} 1' in text
    # the unlabeled series is untouched by labeled writes
    assert metrics.counter_value("rpc_calls") == 0.0


def test_histogram_object_is_stable_and_unlabeled_back_compat():
    h1 = metrics.histogram("hot_path", buckets=(1.0,))
    h2 = metrics.histogram("hot_path", buckets=(1.0,))
    assert h1 is h2  # hot paths hold the cell, never look it up again
    h1.observe(0.5)
    assert metrics.histogram_snapshot("hot_path")["count"] == 1
    assert metrics.histogram_snapshot("missing") is None
    metrics.inc("consensus_messages_processed", 3)
    metrics.set_gauge("chain_height", 7)
    text = metrics.render_text()
    assert "consensus_messages_processed 3.0" in text
    assert "chain_height 7" in text


def test_protocol_breadcrumbs():
    """A BinaryAgreement through the port's simulator leaves the watchdog's
    breadcrumbs on its instance and counts every envelope."""
    from lachain_tpu_torch.consensus import messages as M
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import SeededRng, SimulatedNetwork
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.crypto.native_backend import NativeBackend
    from lachain_tpu_torch.ops.verify import HostEraPipeline

    host = NativeBackend()
    backend = GpuBackend(device="cpu", host_backend=host, pipeline=HostEraPipeline(host))
    pub, privs = trusted_key_gen(4, 1, SeededRng(3))
    net = SimulatedNetwork(pub, privs, era=1, seed=4, device="cpu", backend=backend)
    pid = M.BinaryAgreementId(era=1, agreement=0)
    for i in range(4):
        net.post_request(i, pid, i % 2 == 0)
    assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
    proto = net.routers[0].protocol(pid)
    assert proto.last_message != "<created>"
    assert proto.last_activity >= proto.started_at
    assert "consensus_messages_processed" in metrics.render_text()


def test_label_cardinality_cap():
    """A label value an attacker drives must not grow a family without
    bound: past MAX_LABEL_SETS new label sets are dropped and counted,
    the admitted series keep updating."""
    cap = metrics.MAX_LABEL_SETS
    for i in range(cap + 50):
        metrics.inc("evil_counter_total", labels={"peer": f"p{i}"})
    assert metrics.counter_value("evil_counter_total", {"peer": "p0"}) == 1.0
    assert metrics.counter_value("evil_counter_total", {"peer": f"p{cap + 10}"}) == 0.0
    assert metrics.counter_value("metrics_labels_dropped_total") == 50.0
    metrics.inc("evil_counter_total", labels={"peer": "p0"})
    assert metrics.counter_value("evil_counter_total", {"peer": "p0"}) == 2.0
    text = metrics.render_text()
    assert text.count("evil_counter_total{") == cap
    assert "metrics_labels_dropped_total 50" in text


def test_label_cap_per_family_and_kinds_independent():
    cap = metrics.MAX_LABEL_SETS
    for i in range(cap):
        metrics.inc("family_a_total", labels={"x": str(i)})
    # family_a is full; family_b and gauges / histograms admit fresh sets
    metrics.inc("family_b_total", labels={"x": "new"})
    assert metrics.counter_value("family_b_total", {"x": "new"}) == 1.0
    metrics.set_gauge("family_a_depth", 3.0, labels={"x": "g"})
    assert ("family_a_depth", (("x", "g"),)) in metrics._gauges
    # an over-cap histogram label set gets a DETACHED histogram: callers
    # keep observing, nothing registers
    for i in range(cap):
        metrics.observe_hist("family_h_seconds", 0.1, labels={"x": str(i)})
    before = len(metrics._histograms)
    h = metrics.histogram("family_h_seconds", labels={"x": "overflow"})
    h.observe(0.5)
    assert len(metrics._histograms) == before
    assert metrics.histogram_snapshot("family_h_seconds", {"x": "overflow"}) is None
    # unlabeled series are never capped
    metrics.inc("family_a_total")
    assert metrics.counter_value("family_a_total") == 1.0
    # the reset clears the admission ledger too
    metrics.reset_all_for_tests()
    metrics.inc("family_a_total", labels={"x": "fresh"})
    assert metrics.counter_value("family_a_total", {"x": "fresh"}) == 1.0


def _registry_calls(m) -> str:
    """One sequence of registry calls on module `m`; its exposition text."""
    m.reset_all_for_tests()
    m.inc("consensus_msgs_shed_total", labels={"reason": "latch_cap"})
    m.inc("consensus_msgs_shed_total", 2, labels={"reason": "postponed_cap"})
    m.inc("crypto_tpu_era_kernel_calls_total")
    m.set_gauge("tpke_batcher_queue_depth", 3)
    m.set_gauge("lsm_cache_hit_ratio", 0.25, labels={"store": 'a"b'})
    m.observe("block_execute", 0.125)
    m.observe_hist("wait_seconds", 0.002, labels={"resource": "fsync"})
    m.observe_hist("wait_seconds", 7.5, labels={"resource": "net"})
    m.observe_hist("tpke_flush_slots", 12, buckets=(1, 2, 4, 8, 16))
    m.MESSAGES_PROCESSED[0] += 5
    for i in range(m.MAX_LABEL_SETS + 3):
        m.inc("fault_injected_total", labels={"action": f"a{i}"})
    text = m.render_text()
    m.reset_all_for_tests()
    return text


def test_render_text_equals_jax_package():
    """The same calls render the same exposition in both packages: one
    dashboard reads either."""
    assert _registry_calls(metrics) == _registry_calls(jmetrics)
