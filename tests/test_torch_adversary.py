"""The port's seeded malicious validators vs the JAX package's, on the CPU.

RootProtocol eras at (7, 2) (the fake producers of
tests/test_torch_root_protocol.py, TAKE_FIRST, seed 9) with traitors 1
and 3 under each strategy of `lachain_tpu_torch/consensus/adversary.py`,
installed after the network is built and before its first request:
  * on the Python engine, each of the five strategies gives the JAX
    package's blocks, `delivered_count` and evidence at every honest
    router;
  * on the native engine (the JAX engine a private g++ build, the
    `jax_engine` fixture of tests/test_torch_native_rt.py), each of the
    four strategies it can express gives the JAX engine's; the traitors'
    coin, HoneyBadger and Root run in Python, their messages crossing the
    engine as opaque payloads;
  * the port's two engines agree on every block hash and on the evidence
    (the reference's dual-engine verdict identity);
  * `equivocate` convicts exactly the traitors at every honest router
    (kind equivocation, "dec" and "coin"); `withhold`, `relay` and `spam`
    leave no evidence; `spam` sheds past the per-sender latch cap (and
    the postponed window sheds past its own cap, counted in `shed`);
    `equivocate_votes` convicts its traitor on the Python engine, and the
    native engine refuses it;
  * two runs of one plan are bit-identical; the plan validates itself.
The native engine's fault mapping equals the JAX engine's under the same
expressible plan (duplication, reordering, a crash that never restarts),
and every inexpressible feature raises. Evidence is compared across the
packages as `snapshot()` (the record classes differ), within the port as
`record_set()`. The port's eras run on the host pipeline, as in
tests/test_torch_consensus.py.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.consensus import adversary as jadv
from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.root_protocol import RootProtocol as JRootProtocol
from lachain_tpu.network import faults as jf
from lachain_tpu_torch.consensus import adversary as adv
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.evidence import EQUIVOCATION
from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork
from lachain_tpu_torch.consensus.root_protocol import RootProtocol
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from lachain_tpu_torch.network import faults as pf
from tests.test_torch_consensus import carried_keys, drive, jax_net, port_net
from tests.test_torch_native_rt import hb_inputs, jax_engine, jax_native, port_native  # noqa: F401
from tests.test_torch_root_protocol import JaxProducer, PortProducer, factories, proposals

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

N, F, SEED, ADV_SEED = 7, 2, 9, 5
TRAITORS = (1, 3)
HONEST = [i for i in range(N) if i not in TRAITORS]
DUAL_ENGINE = ("equivocate", "withhold", "relay", "spam")
_PORT_PY: dict = {}


def root_run(net, pid):
    """Every validator's Root request; run to every router's block ->
    (done, delivered_count, the blocks' encodings, their header hashes,
    the honest routers' evidence snapshots)."""
    done, delivered, blocks = drive(net, pid, [None] * N, range(N))
    return (done, delivered, [b.encode() for b in blocks],
            [b.header.hash() for b in blocks],
            [net.routers[i].evidence.snapshot() for i in HONEST])


def jax_python(strategy):
    (jpub, jprivs), _ = carried_keys(N, F)
    jprop = proposals(N)[0]
    net = jax_net(N, F, SEED, extra_factories={JM.RootProtocolId: factories(
        JRootProtocol, [JaxProducer(t) for t in jprop], jpub, jprivs, None)})
    jadv.install(jadv.AdversaryPlan(strategy, TRAITORS, seed=ADV_SEED), net)
    return net, root_run(net, JM.RootProtocolId(era=0))


def port_python(strategy):
    """The port's Python-engine era under `strategy` (computed once a
    strategy: the native tests compare with it too)."""
    if strategy not in _PORT_PY:
        _, (pub, privs) = carried_keys(N, F)
        pprop = proposals(N)[1]
        net = port_net(N, F, SEED, extra_factories={M.RootProtocolId: factories(
            RootProtocol, [PortProducer(t) for t in pprop], pub, privs, None)})
        adv.install(adv.AdversaryPlan(strategy, TRAITORS, seed=ADV_SEED), net)
        _PORT_PY[strategy] = net, root_run(net, M.RootProtocolId(era=0))
    return _PORT_PY[strategy]


def jax_native_root(engine, strategy):
    (jpub, jprivs), _ = carried_keys(N, F)
    jprop = proposals(N)[0]
    net = jax_native(engine, N, F, SEED)
    for i in range(N):
        net.set_root_context(i, JaxProducer(jprop[i]), jprivs[i].ecdsa_priv,
                             jpub.ecdsa_pub_keys)
    jadv.install(jadv.AdversaryPlan(strategy, TRAITORS, seed=ADV_SEED), net)
    out = root_run(net, JM.RootProtocolId(era=0))
    net.close()
    return out


def port_native_root(strategy):
    _, (pub, privs) = carried_keys(N, F)
    pprop = proposals(N)[1]
    net = port_native(N, F, SEED)
    for i in range(N):
        net.set_root_context(i, PortProducer(pprop[i]), privs[i].ecdsa_priv,
                             pub.ecdsa_pub_keys)
    adv.install(adv.AdversaryPlan(strategy, TRAITORS, seed=ADV_SEED), net)
    return net, root_run(net, M.RootProtocolId(era=0))


def check_verdict(strategy, net):
    """equivocate: every honest router convicts exactly the traitors, of
    equivocation in "dec" and "coin"; the others: no evidence."""
    for i in HONEST:
        recs = net.routers[i].evidence.record_set()
        if strategy in ("equivocate", "equivocate_votes"):
            assert {r.offender for r in recs} == set(TRAITORS), (strategy, i)
            assert {r.kind for r in recs} == {EQUIVOCATION}
        else:
            assert recs == frozenset(), (strategy, i)
    if strategy == "equivocate":
        for i in HONEST:
            recs = net.routers[i].evidence.record_set()
            assert {r.proto for r in recs} == {"dec", "coin"}
            assert {r.offender for r in recs if r.proto == "dec"} == set(TRAITORS)


@pytest.mark.parametrize("strategy", adv.STRATEGIES)
def test_python_engine_equals_reference(strategy):
    jnet, jout = jax_python(strategy)
    net, out = port_python(strategy)
    assert jout[0] and out == jout
    assert len(set(out[3])) == 1  # one block
    check_verdict(strategy, net)
    if strategy == "equivocate_votes":
        assert {r.proto for r in net.routers[HONEST[0]].evidence.record_set()} <= {
            "aux", "conf"}


@pytest.mark.parametrize("strategy", DUAL_ENGINE)
def test_native_engine_equals_reference(jax_engine, strategy):
    jout = jax_native_root(jax_engine, strategy)
    net, out = port_native_root(strategy)
    assert jout[0] and out == jout
    check_verdict(strategy, net)
    assert net.crossings["opaque_message"] > 0  # the traitors' Python protocols
    traitor_masks = {net._own_masks[v] for v in TRAITORS}
    assert traitor_masks == {0} and net._own_masks[HONEST[0]] == 7
    net.close()


@pytest.mark.parametrize("strategy", DUAL_ENGINE)
def test_port_engines_agree(strategy):
    """The port's Python and native engines, one plan in TAKE_FIRST: the
    same block hashes and evidence sets at every honest router."""
    pynet, pyout = port_python(strategy)
    net, out = port_native_root(strategy)
    assert out[0] and out[3] == pyout[3] and len(set(out[3])) == 1
    assert [net.routers[i].evidence.record_set() for i in HONEST] == [
        pynet.routers[i].evidence.record_set() for i in HONEST]
    net.close()


def test_spam_is_shed_not_buffered():
    """The flood hits the per-sender latch cap at every honest router (shed
    and counted); no sender holds more latch entries than the cap; the
    chain stays live and no evidence is filed."""
    net, out = port_python("spam")
    assert out[0]
    for i in HONEST:
        router = net.routers[i]
        assert router.shed["latch_cap"] > 0 and router.shed["postponed_cap"] == 0
        cap = router.first_seen_sender_cap
        assert all(c <= cap for c in router._first_seen_per_sender.values())
        assert {s for s, c in router._first_seen_per_sender.items() if c == cap} == set(
            TRAITORS)
        assert len(router.evidence) == 0


def test_postponed_window_sheds_past_its_cap():
    """A sender's future-era messages past the postponed window's
    per-sender cap are shed and counted; another sender's buffer is
    unaffected."""
    router = port_net(4, 1, 6).routers[0]
    cap = router._postponed_sender_cap
    for k in range(cap + 3):
        router.dispatch_external(1, M.AuxMessage(bb=M.BinaryBroadcastId(1, 0, k), value=True))
    router.dispatch_external(2, M.AuxMessage(bb=M.BinaryBroadcastId(1, 0, 0), value=True))
    assert router.shed == {"latch_cap": 0, "postponed_cap": 3}
    assert len(router._postponed) == cap + 1


@pytest.mark.parametrize("strategy", ("equivocate", "relay"))
def test_two_runs_bit_identical(strategy):
    """One plan, two runs: the same blocks, delivered_count and evidence."""
    first = port_python(strategy)[1]
    _PORT_PY.pop(strategy)
    assert port_python(strategy)[1] == first


def test_equivocate_votes_is_python_only():
    """Vote equivocation runs on the Python engine (above); the native
    engine types BB messages itself and refuses it by name."""
    net = port_native(4, 1, 3)
    with pytest.raises(ValueError, match="equivocate_votes"):
        adv.install(adv.AdversaryPlan("equivocate_votes", (1,)), net)
    with pytest.raises(ValueError, match="out of range"):
        adv.install(adv.AdversaryPlan("spam", (4,)), net)
    net.close()


def test_plan_validation():
    assert set(DUAL_ENGINE) < set(adv.STRATEGIES)
    assert adv.STRATEGIES == jadv.STRATEGIES
    with pytest.raises(ValueError):
        adv.AdversaryPlan(strategy="nope", traitors=(0,))
    plan = adv.AdversaryPlan(strategy="spam", traitors=[2])
    assert plan.traitors == (2,)
    ref = jadv.AdversaryPlan(strategy="spam", traitors=[2])
    assert (adv.SPAM_SLOTS, adv.RELAY_FANOUT, adv.RELAY_RATE) == (
        ref.spam_slots, ref.relay_fanout, ref.relay_rate)


def test_equivocation_variants_equal_reference():
    """conflicting_variant builds the reference's bytes: the coin's
    threshold signature over the altered message, U_i times 1337."""
    jnet, _ = jax_python("equivocate")
    net, _ = port_python("equivocate")
    coin = M.CoinMessage(coin=M.CoinId(0, 2, 1), share=b"")
    jcoin = JM.CoinMessage(coin=JM.CoinId(0, 2, 1), share=b"")
    assert (adv.conflicting_variant(net.routers[1], coin).share
            == jadv.conflicting_variant(jnet.routers[1], jcoin).share)
    dec = next(p for p in net.routers[1].outbox_payloads(0, 0)
               if isinstance(p, M.DecryptedMessage))
    jdec = JM.DecryptedMessage(hb=JM.HoneyBadgerId(era=0), share_id=dec.share_id,
                               payload=dec.payload)
    assert (adv.conflicting_variant(net.routers[1], dec).payload
            == jadv.conflicting_variant(jnet.routers[1], jdec).payload)
    assert adv._subset(5, ("withhold", 1, 0, "x"), 1, 7, 2) == jadv._subset(
        5, ("withhold", 1, 0, "x"), 1, 7, 2)


EXPRESSIBLE = dict(seed=3, duplicate=0.05, reorder=0.5)


@pytest.mark.parametrize("n,f", [(4, 1), (7, 2)])
def test_native_fault_mapping_equals_reference(jax_engine, n, f):
    """An expressible plan (duplicates, reordering, validator n - 1 crashed
    for good) maps as in the JAX engine: TAKE_RANDOM, the crashed validator
    muted, the engine seeded with seed ^ (plan.seed << 1); equal results
    and delivered_count."""
    live = range(n - 1)
    inputs = hb_inputs(n)
    jnet = jax_native(jax_engine, n, f, 5, fault_plan=jf.FaultPlan(
        crashes=(jf.Crash(n - 1, 0),), **EXPRESSIBLE))
    jout = drive(jnet, JM.HoneyBadgerId(era=0), inputs, live)
    jnet.close()
    net = port_native(n, f, 5, fault_plan=pf.FaultPlan(
        crashes=(pf.Crash(n - 1, 0),), **EXPRESSIBLE))
    assert net.mode is DeliveryMode.TAKE_RANDOM and net.muted == {n - 1}
    out = drive(net, M.HoneyBadgerId(era=0), inputs, live)
    assert jout[0] and out == jout
    assert n - 1 not in out[2][0]
    net.close()


@pytest.mark.parametrize("feature,plan", [
    ("drop", pf.FaultPlan(drop=0.1)),
    ("delay", pf.FaultPlan(delay=0.1)),
    ("partitions", pf.FaultPlan(partitions=(
        pf.Partition(frozenset({0}), frozenset({1}), 0, 5),))),
    ("crash restart", pf.FaultPlan(crashes=(pf.Crash(1, 0, 9),))),
    ("link shaper", pf.FaultPlan(shaper=pf.LinkShaper.parse("regions=a,b;default=3"))),
    ("drop, link shaper", pf.FaultPlan(
        drop=0.1, shaper=pf.LinkShaper.parse("regions=a,b;default=3"))),
])
def test_native_refuses_inexpressible_plans(feature, plan):
    """One ValueError naming every feature the engine cannot express."""
    _, (pub, privs) = carried_keys(4, 1)
    with pytest.raises(ValueError, match=feature):
        NativeSimulatedNetwork(pub, privs, device="cpu", fault_plan=plan)
