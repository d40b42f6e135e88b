"""The port's native consensus engine vs the JAX package's, and vs the
port's Python engine, on the CPU.

`lachain_tpu_torch.consensus.native_rt.NativeSimulatedNetwork` runs the
port's copy of the engine (consensus/native/consensus_rt.cpp, built by
`ops/_build.consensus_library()`) under the port's host shims. The same
C++ with the same seed makes the same delivery schedule, so against the
JAX package's `NativeSimulatedNetwork` every case must give the same
results and `delivered_count` in every mode; against the port's Python
`SimulatedNetwork` only TAKE_FIRST is comparable (the two engines draw
TAKE_RANDOM's order from different generators).

Cases, at (n, f) = (4, 1) and (7, 2): a HoneyBadger era in TAKE_FIRST and
in TAKE_RANDOM with duplicate injection, with the RBC batcher off and on;
a muted validator; router 0's HoneyBadger malicious through
`_extra_factories` (equal evidence: every honest router convicts exactly
router 0); RootProtocol hosted natively through `set_root_context` over
the fake producers of tests/test_torch_root_protocol.py (equal header
bytes, multisig encoding and transaction hashes), whose era crosses into
Python only through the batched ops. Also: one era on the plain versions
of the card's kernels, the engine's N ceiling, and a callback's or a
flush's failure raising out of `run`.

The port's eras run on the host pipeline, as in
tests/test_torch_consensus.py. The JAX engine is a private g++ build of
the JAX package's `consensus_rt.cpp`, made under `tmp_path_factory` and
loaded through `LACHAIN_CONSENSUS_LIB` before this worker's first
`load_rt`: the JAX package's own loader runs `make` on its gitignored
library, which tests/test_native_rt.py on another worker may be running
at the same moment.
"""
from __future__ import annotations

import os
import subprocess
import types as pytypes

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus import native_rt as jax_rt
from lachain_tpu.consensus.simulator import DeliveryMode as JMode
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.evidence import INVALID_SHARE
from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork, load_rt
from lachain_tpu_torch.consensus.root_protocol import RootProtocol
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.ops.verify import HostEraPipeline
from tests.test_consensus_byzantine import MaliciousHoneyBadger as JMaliciousHoneyBadger
from tests.test_torch_consensus import (
    MaliciousHoneyBadger,
    carried_keys,
    drive,
    host_backend,
    port_net,
)
from tests.test_torch_root_protocol import JaxProducer, PortProducer, check_blocks, proposals

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

SIZES = [(4, 1), (7, 2)]
MODES = [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM]
_JAX_ENGINE = os.path.join(os.path.dirname(jax_rt.__file__), "native", "consensus_rt.cpp")


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX package's native_rt, its engine loaded from a private build
    unless this worker loaded one already."""
    if jax_rt._lib_cache[0] is None:
        so = tmp_path_factory.mktemp("jax_engine") / "libconsensus_rt.so"
        subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", str(so),
                        _JAX_ENGINE], check=True, capture_output=True)
        old = os.environ.get("LACHAIN_CONSENSUS_LIB")
        os.environ["LACHAIN_CONSENSUS_LIB"] = str(so)
        try:
            jax_rt.load_rt()
        finally:
            if old is None:
                del os.environ["LACHAIN_CONSENSUS_LIB"]
            else:
                os.environ["LACHAIN_CONSENSUS_LIB"] = old
    return jax_rt


def port_native(n, f, seed, mode=DeliveryMode.TAKE_FIRST, plain=False, **kw):
    """The port's native network on the CPU: the era on the host pipeline,
    or on the plain kernels with `plain`."""
    host = host_backend()
    pipeline = None if plain else HostEraPipeline(host)
    backend = GpuBackend(device="cpu", host_backend=host, pipeline=pipeline)
    pub, privs = carried_keys(n, f)[1]
    return NativeSimulatedNetwork(pub, privs, seed=seed, mode=mode, device="cpu",
                                  backend=backend, **kw)


def jax_native(engine, n, f, seed, mode=DeliveryMode.TAKE_FIRST, **kw):
    pub, privs = carried_keys(n, f)[0]
    return engine.NativeSimulatedNetwork(pub, privs, seed=seed, mode=JMode[mode.name], **kw)


def hb_inputs(n):
    return [b"txbatch|%d|" % i + bytes(32) for i in range(n)]


def check_crossings(net, n, root=False):
    """The era crossed into Python only through the batched ops: no
    per-message opaque, ACS or coin-request callback."""
    c = net.crossings
    assert c["opaque_message"] == c["acs_result"] == c["coin_request"] == 0, c
    assert c["hb_acs"] == n and c["hb_done"] == n
    if root:
        assert c["root_produce"] == n
    assert net.native_handled() > 0


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
@pytest.mark.parametrize("rbc", [False, True], ids=["engine_rs", "rbc_batcher"])
def test_honey_badger_equals_jax_engine(jax_engine, n, f, mode, rbc):
    """One HoneyBadger era: equal results and delivered_count on both
    engines (TAKE_RANDOM with 5% duplicates); in TAKE_FIRST also equal to
    the port's Python engine."""
    kw = dict(use_rbc_batcher=rbc)
    if mode is DeliveryMode.TAKE_RANDOM:
        kw["repeat_probability"] = 0.05
    inputs = hb_inputs(n)
    jnet = jax_native(jax_engine, n, f, 5, mode, **kw)
    jax_out = drive(jnet, JM.HoneyBadgerId(era=0), inputs, range(n))
    jnet.close()
    net = port_native(n, f, 5, mode, **kw)
    port_out = drive(net, M.HoneyBadgerId(era=0), inputs, range(n))
    assert jax_out[0] and port_out == jax_out
    assert all(pt == inputs[j] for j, pt in port_out[2][0].items())
    assert len(port_out[2][0]) >= n - f
    check_crossings(net, n)
    if rbc:
        assert net.rbc_batcher.flushes >= 1 and net.crossings["rbc_need"] > 0
    else:
        assert net.crossings["rbc_encode"] == net.crossings["rbc_need"] == 0
    assert net.crypto_batcher.flushes >= 1
    if mode is DeliveryMode.TAKE_FIRST:
        assert drive(port_net(n, f, 5, mode, **kw), M.HoneyBadgerId(era=0), inputs,
                     range(n)) == port_out


@pytest.mark.parametrize("n,f", SIZES)
def test_honey_badger_with_a_muted_validator(jax_engine, n, f):
    """Validator 0 sends and receives nothing; the others agree, on both
    engines and on the port's Python engine (TAKE_FIRST)."""
    live = range(1, n)
    inputs = hb_inputs(n)
    jax_out = drive(jax_native(jax_engine, n, f, 9, muted={0}), JM.HoneyBadgerId(era=0),
                    inputs, live)
    port_out = drive(port_native(n, f, 9, muted={0}), M.HoneyBadgerId(era=0), inputs, live)
    assert jax_out[0] and port_out == jax_out
    assert len(port_out[2][0]) >= n - f and 0 not in port_out[2][0]
    assert drive(port_net(n, f, 9, muted={0}), M.HoneyBadgerId(era=0), inputs,
                 live) == port_out


@pytest.mark.parametrize("n,f", SIZES)
def test_malicious_honey_badger_override(jax_engine, n, f):
    """Router 0's HoneyBadger, kept in Python by an `_extra_factories`
    override (its messages cross the engine as opaque payloads), broadcasts
    corrupted decryption shares (TAKE_RANDOM): equal results,
    delivered_count and evidence on both engines; every honest router
    convicts exactly router 0 (invalid_share, "dec")."""
    honest = range(1, n)
    inputs = [b"byz-%d" % i for i in range(n)]
    jnet = jax_native(jax_engine, n, f, 13, DeliveryMode.TAKE_RANDOM)
    jnet.routers[0]._extra_factories = {JM.HoneyBadgerId: lambda pid, r: JMaliciousHoneyBadger(
        pid, r, r.public_keys, r.private_keys)}
    jax_out = drive(jnet, JM.HoneyBadgerId(era=0), inputs, honest)
    net = port_native(n, f, 13, DeliveryMode.TAKE_RANDOM)
    net.routers[0]._extra_factories = {M.HoneyBadgerId: lambda pid, r: MaliciousHoneyBadger(
        pid, r, r.public_keys, r.private_keys)}
    port_out = drive(net, M.HoneyBadgerId(era=0), inputs, honest)
    assert jax_out[0] and port_out == jax_out
    assert all(pt == inputs[j] for j, pt in port_out[2][0].items())
    assert net.crossings["opaque_message"] > 0  # router 0's shares, per message
    for i in honest:
        ev = net.routers[i].evidence
        assert ev.snapshot(0) == jnet.routers[i].evidence.snapshot(0)
        assert {(r.kind, r.offender, r.proto) for r in ev.records(era=0)} == {
            (INVALID_SHARE, 0, "dec")}
    jnet.close()


def run_native_root(net, pid, producers, pub, privs, live):
    """Every validator's Root context, then its request for `pid`."""
    for i in range(net.n):
        net.set_root_context(i, producers[i], privs[i].ecdsa_priv, pub.ecdsa_pub_keys)
    return drive(net, pid, [None] * net.n, live)


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_native_root_protocol_equals_jax_engine(jax_engine, n, f, mode):
    """RootProtocol hosted natively (set_root_context, no factory): equal
    blocks (header bytes, multisig encoding, transaction hashes) and
    delivered_count on both engines, with the RBC batcher on; the era
    crosses only through the batched ops; in TAKE_FIRST the block and
    delivered_count equal the port's Python engine's (RootProtocol through
    extra_factories)."""
    (jpub, jprivs), (pub, privs) = carried_keys(n, f)
    jprop, pprop = proposals(n)
    live = list(range(n))
    jnet = jax_native(jax_engine, n, f, 31, mode, use_rbc_batcher=True)
    jout = run_native_root(jnet, JM.RootProtocolId(era=0), [JaxProducer(t) for t in jprop], jpub, jprivs, live)
    jnet.close()
    net = port_native(n, f, 31, mode, use_rbc_batcher=True)
    pout = run_native_root(net, M.RootProtocolId(era=0), [PortProducer(t) for t in pprop], pub, privs, live)
    check_blocks(jout, pout, pub, n, f, live)
    check_crossings(net, n, root=True)
    assert net.crossings["root_sign"] == n and net.crossings["root_verify"] > 0
    roots = [r.native_root(0) for r in net.routers]
    assert all(h is not None and h.sign_s > 0 for h in roots)
    assert all(r.protocol(M.RootProtocolId(era=0)) is None for r in net.routers)
    assert not any(r.evidence.records() for r in net.routers)
    if mode is DeliveryMode.TAKE_FIRST:
        def make(pid, router):
            i = router.my_id
            return RootProtocol(pid, router, producer=PortProducer(pprop[i]),
                                ecdsa_priv=privs[i].ecdsa_priv,
                                ecdsa_pubs=pub.ecdsa_pub_keys)

        pynet = port_net(n, f, 31, mode, use_rbc_batcher=True,
                         extra_factories={M.RootProtocolId: make})
        py_out = drive(pynet, M.RootProtocolId(era=0), [None] * n, live)
        assert py_out[1] == pout[1]
        assert [b.encode() for b in py_out[2]] == [b.encode() for b in pout[2]]


def test_honey_badger_on_the_plain_kernels(jax_engine):
    """One (4, 1) era with both batchers on the plain versions of the
    card's kernels (the TPKE flush through GpuEraPipeline on the CPU, the
    RBC flushes through rs_batch's plain product): equal to the JAX
    engine's."""
    inputs = [b"tx|%d" % i + bytes(64) for i in range(4)]
    kw = dict(use_rbc_batcher=True)
    jax_out = drive(jax_native(jax_engine, 4, 1, 3, DeliveryMode.TAKE_RANDOM, **kw),
                    JM.HoneyBadgerId(era=0), inputs, range(4))
    net = port_native(4, 1, 3, DeliveryMode.TAKE_RANDOM, plain=True, **kw)
    port_out = drive(net, M.HoneyBadgerId(era=0), inputs, range(4))
    assert jax_out[0] and port_out == jax_out
    assert all(pt == inputs[j] for j, pt in port_out[2][0].items())
    assert net.tpke_phase_s["era_s"] > 0 and net.rbc_phase_s


def test_engine_limits():
    """rt_new refuses N > 512 and N < 1 (512-bit membership masks), as
    tests/test_native_rt.py checks the JAX package's; the network raises
    ValueError for it."""
    lib = load_rt()
    assert not lib.rt_new(513, 170, 0, 0, 0, 0)
    assert not lib.rt_new(0, 0, 0, 0, 0, 0)
    h = lib.rt_new(512, 170, 0, 0, 0, 0)
    assert h
    lib.rt_free(h)
    too_many = pytypes.SimpleNamespace(n=513, f=170)
    with pytest.raises(ValueError, match="513"):
        NativeSimulatedNetwork(too_many, [], device="cpu", backend=GpuBackend(
            device="cpu", host_backend=host_backend(), pipeline=HostEraPipeline(host_backend())))


class _Boom(RuntimeError):
    pass


def test_callback_failure_raises_from_run():
    """A host shim that raises inside an engine callback (the producer's
    header) surfaces from run(), not lost in the C++ frames."""
    (_, _), (pub, privs) = carried_keys(4, 1)
    pprop = proposals(4)[1]

    class BadProducer(PortProducer):
        def create_header(self, index, txs, nonce):
            raise _Boom("header")

    net = port_native(4, 1, 31)
    for i in range(4):
        net.set_root_context(i, BadProducer(pprop[i]), privs[i].ecdsa_priv, pub.ecdsa_pub_keys)
        net.post_request(i, M.RootProtocolId(era=0), None)
    with pytest.raises(_Boom, match="header"):
        net.run(lambda: False)


def test_failed_flush_raises_from_run():
    """A TPKE flush whose era call fails raises out of run()."""
    net = port_native(4, 1, 5)

    def fail(*_args, **_kw):
        raise _Boom("era call")

    net.crypto_batcher.backend = pytypes.SimpleNamespace(
        tpke_era_verify_combine_async=fail, last_timings={})
    for i, value in enumerate(hb_inputs(4)):
        net.post_request(i, M.HoneyBadgerId(era=0), value)
    with pytest.raises(_Boom, match="era call"):
        net.run(lambda: False)
    net.close()
    net.close()  # idempotent


def test_native_router_outbox_replays_through_the_engine():
    """A native router records what its host shims send (the outbox, no
    transport) and answers a replay request of its current era by handing
    the recorded payloads back to the engine; other eras replay nothing;
    advance_era drops the finished era's shims and native results beyond
    the last active era."""
    net = port_native(4, 1, 5)
    pid = M.HoneyBadgerId(era=0)
    for i, value in enumerate(hb_inputs(4)):
        net.post_request(i, pid, value)
    assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
    router = net.routers[1]
    sent = router.outbox_payloads(0, 2)
    assert sent and {type(p) for p in sent} == {M.DecryptedMessage}
    queued = net._lib.rt_queue_len(net._h)
    assert router.replay_outbox(0, 2, limit=2) == 2
    assert net._lib.rt_queue_len(net._h) == queued + 2 * 4  # a broadcast each
    assert router.replay_outbox(1, 2) == 0
    assert "hb{" in net.native_state_of(1)
    router.advance_era(1)
    assert router.result_of(pid) is not None  # the last active era stays
    router.advance_era(3)
    assert router.result_of(pid) is None and not router._era_hosts
    net.close()
