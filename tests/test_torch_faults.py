"""The port's fault plans vs the JAX package's, decision for decision and era
for era, on the CPU.

`lachain_tpu_torch/network/faults.py` must decide as
`lachain_tpu/network/faults.py` does, draw for draw: for one seed and salt,
with and without a `LinkShaper` (jitter, a burst rate, a bandwidth cap),
10,000 `decide` / `reorder_hit` calls under a moving clock give the same
lists, the same `stats` and the same pacer state. The spec parsers and the
schedule queries equal the reference's on its own examples
(tests/test_consensus_chaos.py, tests/test_wan.py).

Both packages' `SimulatedNetwork`s then run one HoneyBadger era under one
plan, at (4, 1) and (7, 2), with the same seed, keys and inputs, and must
give the same results, `delivered_count`, `faults.stats` and
`recovery_rounds`: the cases of tests/test_consensus_chaos.py (a lossy
plan, delay only, a crash with a restart, f permanent crashes, a healed
partition, loss with a crash and a partition, a shaper plan, and a
partition that never heals, where `run` returns False after
`max_recovery_rounds` rounds). The schedule's times are in delivered
messages, scaled by the size (the unfaulted (4, 1) era delivers 652,
the (7, 2) era 3,472). Two runs of one plan are bit-identical. The port's
era runs on the host pipeline, as in tests/test_torch_consensus.py.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.network import faults as jf
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.network import faults as pf
from tests.test_torch_consensus import drive, jax_net, port_net

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

SIZES = [(4, 1), (7, 2)]
SHAPER = "regions=us,eu,ap;default=3/2@4;us-eu=1/0.5;intra=0.5/0.25@8;burst=0.1x5"


def both(make):
    """One plan built by `make(faults_module)` in each package."""
    return make(jf), make(pf)


def run_decisions(plan, salt: int, calls: int = 10_000):
    """`calls` decisions under a clock that moves 0.25 a call -> (the
    decisions, stats, pacer state, the rng's next draw)."""
    t = [0.0]
    s = plan.session(clock=lambda: t[0], salt=salt)
    out = []
    for i in range(calls):
        t[0] += 0.25
        src, dst = i % 5, (i * 7 + 3) % 6
        if i % 3 == 0:
            out.append(s.reorder_hit())
        else:
            out.append(s.decide(src if i % 11 else None, dst, size=1 + i % 4))
    return out, dict(s.stats), dict(s._link_free), s.rng.random()


@pytest.mark.parametrize("shaped", [False, True], ids=["flat", "shaper"])
@pytest.mark.parametrize("salt", [0, 0x12345])
def test_decisions_draw_for_draw(shaped, salt):
    def make(F):
        return F.FaultPlan(
            seed=29, drop=0.1, duplicate=0.07, delay=0.08, reorder=0.2,
            delay_span=(2.0, 9.0),
            crashes=(F.Crash(2, 500.0, 900.0),),
            partitions=(F.Partition(frozenset({0, 1}), frozenset({4}), 100.0, 300.0),),
            shaper=F.LinkShaper.parse(SHAPER) if shaped else None)

    jplan, pplan = both(make)
    want, got = run_decisions(jplan, salt), run_decisions(pplan, salt)
    assert got == want
    stats = got[1]
    assert stats["dropped"] and stats["duplicated"] and stats["delayed"]
    assert stats["reordered"] and stats["blocked"]
    assert bool(stats["shaped"] and stats["bursts"] and got[2]) == shaped


def test_parse_specs_equal_reference():
    for spec in ("1@400:1200", "2@300", "0@0"):
        assert pf.FaultPlan.parse_crash(spec).__dict__ == jf.FaultPlan.parse_crash(spec).__dict__
    for spec in ("0,1|2,3@300:900", "0|1@5", "4,5,6|0@0:1"):
        assert (pf.FaultPlan.parse_partition(spec).__dict__
                == jf.FaultPlan.parse_partition(spec).__dict__)
    c = pf.FaultPlan.parse_crash("1@400:1200")
    assert c == pf.Crash(node=1, at=400.0, restart=1200.0)
    for bad in ("nope",):
        with pytest.raises(ValueError):
            pf.FaultPlan.parse_crash(bad)
    for bad in ("0,1@300", "0,1|2,3"):
        with pytest.raises(ValueError):
            pf.FaultPlan.parse_partition(bad)
    for spec in (SHAPER, "regions=us,eu,ap,sa;default=80ms/8ms@4mbps;us-eu=35ms;"
                 "intra=2ms;burst=0.01x8", "regions=a,b;default=3", "default=1.5s@512kbps",
                 "regions=a;intra=7@100bps;burst=0.3"):
        js, ps = jf.LinkShaper.parse(spec), pf.LinkShaper.parse(spec)
        assert (ps.regions, ps.jitter_burst, ps.burst_multiplier) == (
            js.regions, js.jitter_burst, js.burst_multiplier)
        assert {k: v.__dict__ for k, v in ps.links.items()} == {
            k: v.__dict__ for k, v in js.links.items()}
        assert ps.default.__dict__ == js.default.__dict__
        assert (ps.intra and ps.intra.__dict__) == (js.intra and js.intra.__dict__)
        assert [ps.link(a, b).__dict__ if ps.link(a, b) else None
                for a in range(5) for b in range(5)] == [
            js.link(a, b).__dict__ if js.link(a, b) else None
            for a in range(5) for b in range(5)]
    for bad in ("nonsense", "bogus=1"):
        with pytest.raises(ValueError):
            pf.LinkShaper.parse(bad)


def test_schedule_queries_equal_reference():
    def make(F):
        return F.FaultPlan(
            crashes=(F.Crash(node=1, at=10, restart=20), F.Crash(node=3, at=15)),
            partitions=(F.Partition(frozenset({0}), frozenset({2}), at=5, heal=15),
                        F.Partition(frozenset({4}), frozenset({1, 2}), at=12)))

    jplan, pplan = both(make)
    times = [0, 4.9, 5, 9.99, 10, 12, 14.9, 15, 19.9, 20, 25, 1e9]
    for now in times:
        for a in range(5):
            assert pplan.crashed(a, now) == jplan.crashed(a, now)
            for b in range(5):
                assert pplan.partitioned(a, b, now) == jplan.partitioned(a, b, now)
        assert pplan.next_boundary(now) == jplan.next_boundary(now)
    assert pplan.crashed(1, 10) and pplan.crashed(1, 19.9) and not pplan.crashed(1, 20)
    assert pplan.partitioned(2, 0, 14) and not pplan.partitioned(0, 2, 15)
    assert [pplan.next_boundary(t) for t in (0, 10, 15, 20)] == [5, 12, 20, None]
    s = pplan.session(clock=lambda: 16.0)
    assert s.link_blocked(1, 0) and s.link_blocked(0, 3) and not s.link_blocked(0, 2)
    assert not s.partitioned(None, 2) and not s.crashed(None)


def _scale(n):
    return 1 if n == 4 else 4


def _far(n):
    """The far side of the partitions: the last two validators."""
    return frozenset({n - 2, n - 1})


PLANS = {
    "lossy": lambda F, n, f: F.FaultPlan(seed=7, drop=0.10, duplicate=0.05, reorder=0.05),
    "delay": lambda F, n, f: F.FaultPlan(seed=9, delay=0.10, delay_span=(1.0, 64.0)),
    "crash_restart": lambda F, n, f: F.FaultPlan(
        seed=11, crashes=(F.Crash(node=n - 1, at=50 * _scale(n), restart=400 * _scale(n)),)),
    "healed_partition": lambda F, n, f: F.FaultPlan(seed=13, partitions=(F.Partition(
        frozenset(range(n // 2)), frozenset(range(n // 2, n)), at=30 * _scale(n),
        heal=500 * _scale(n)),)),
    "loss_crash_partition": lambda F, n, f: F.FaultPlan(
        seed=21, drop=0.05, duplicate=0.03, reorder=0.03, delay=0.02,
        crashes=(F.Crash(node=1, at=80 * _scale(n), restart=600 * _scale(n)),),
        partitions=(F.Partition(frozenset({0}), _far(n), at=40 * _scale(n),
                                heal=700 * _scale(n)),)),
    "shaper": lambda F, n, f: F.FaultPlan(seed=5, drop=0.02,
                                          shaper=F.LinkShaper.parse(SHAPER)),
    # f validators crash at 0 and never restart
    "f_crashes": lambda F, n, f: F.FaultPlan(
        seed=12, crashes=tuple(F.Crash(node=c, at=0) for c in range(n - f, n))),
    # a split with no quorum on either side, never healed
    "unhealed": lambda F, n, f: F.FaultPlan(seed=14, partitions=(F.Partition(
        frozenset(range(n // 2)), frozenset(range(n // 2, n)), at=0),)),
}
DECIDING = ("lossy", "delay", "crash_restart", "healed_partition", "loss_crash_partition",
            "shaper")


def era_both(n, f, plan_name, live=None, inputs=None, seed=5, **kw):
    """One HoneyBadger era under plan `plan_name` in each package -> (jax
    net, jax outcome, port net, port outcome)."""
    live = list(range(n)) if live is None else live
    inputs = inputs or [b"chaos|%d|" % i + bytes(24) for i in range(n)]
    jplan, pplan = (PLANS[plan_name](F, n, f) for F in (jf, pf))
    jnet = jax_net(n, f, seed, fault_plan=jplan, **kw)
    jout = drive(jnet, JM.HoneyBadgerId(era=0), inputs, live)
    pnet = port_net(n, f, seed, fault_plan=pplan, **kw)
    pout = drive(pnet, M.HoneyBadgerId(era=0), inputs, live)
    return jnet, jout, pnet, pout


def check_equal(jnet, jout, pnet, pout):
    assert pout == jout
    assert pnet.faults.stats == jnet.faults.stats
    assert pnet.recovery_rounds == jnet.recovery_rounds
    assert pnet._vtime == jnet._vtime


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("plan", DECIDING)
def test_faulted_era_equals_reference(n, f, plan):
    jnet, jout, pnet, pout = era_both(n, f, plan)
    check_equal(jnet, jout, pnet, pout)
    done, _, results = pout
    assert done and len({tuple(sorted(r.items())) for r in results}) == 1
    assert len(results[0]) >= n - f
    stats = pnet.faults.stats
    fired = {"lossy": ("dropped", "duplicated", "reordered"), "delay": ("delayed",),
             "crash_restart": ("blocked",), "healed_partition": ("blocked",),
             "loss_crash_partition": ("dropped", "blocked", "delayed"),
             "shaper": ("shaped", "bursts", "dropped")}[plan]
    assert all(stats[k] > 0 for k in fired), stats
    if plan in ("lossy", "crash_restart", "healed_partition"):
        assert pnet.recovery_rounds > 0  # repaired by outbox replay, not luck


@pytest.mark.parametrize("n,f", SIZES)
def test_f_permanent_crashes_still_decide(n, f):
    """f validators crash at 0 and never restart: the other n - f decide
    without them; the crashed ones decide nothing."""
    crashed = list(range(n - f, n))
    live = [i for i in range(n) if i not in crashed]
    jnet, jout, pnet, pout = era_both(n, f, "f_crashes", live=live)
    check_equal(jnet, jout, pnet, pout)
    assert pout[0] and all(pnet.routers[c].result_of(M.HoneyBadgerId(era=0)) is None
                           for c in crashed)
    assert all(c not in pout[2][0] for c in crashed)


@pytest.mark.parametrize("n,f", SIZES)
def test_unhealed_partition_does_not_livelock(n, f):
    """A split that never heals leaves no quorum on either side: run
    returns False after max_recovery_rounds rounds, in both packages."""
    jnet, jout, pnet, pout = era_both(n, f, "unhealed", max_recovery_rounds=4)
    check_equal(jnet, jout, pnet, pout)
    assert pout[0] is False and pnet.recovery_rounds == 4
    assert pnet.faults.stats["blocked"] > 0


def test_two_runs_are_bit_identical():
    """One plan, two runs: the same results, delivered_count, fault tally
    and recovery rounds."""
    runs = []
    for _ in range(2):
        pnet = port_net(4, 1, 17, fault_plan=PLANS["loss_crash_partition"](pf, 4, 1))
        out = drive(pnet, M.HoneyBadgerId(era=0), [b"twice|%d" % i for i in range(4)],
                    range(4))
        runs.append((out, dict(pnet.faults.stats), pnet.recovery_rounds))
    assert runs[0] == runs[1]
    assert runs[0][1]["dropped"] and runs[0][1]["blocked"]


def test_crash_window_drops_sends_but_not_injections():
    """A crashed router's own sends are dropped at the transport; the
    adversary's `inject` in its name is not (it bypasses the router, as in
    the reference)."""
    pnet = port_net(4, 1, 3, fault_plan=pf.FaultPlan(crashes=(pf.Crash(node=2, at=0),)))
    router = pnet.routers[2]
    coin = M.CoinId(0, 0, 1)
    pnet.post_request(2, coin, None)
    assert router.outbox_payloads(0, 1) and not pnet._queue
    pnet.inject(2, None, router.outbox_payloads(0, 1)[0])
    assert len(pnet._queue) == 4
