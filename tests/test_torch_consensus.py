"""The port's consensus protocols vs the JAX package's, era for era, on the CPU.

Both packages' `SimulatedNetwork`s run one protocol with the same seed, the
same inputs and the same keys (the JAX dealer's, carried into the port by
`convert.consensus_keys_from_numpy`), and must give the same result at every
validator and the same `delivered_count`:
  * BinaryBroadcast, CommonCoin, BinaryAgreement, ReliableBroadcast (inline
    and with the RBC batcher, with duplicate injection), CommonSubset and
    HoneyBadger (the slot set and its plaintexts) at (n, f) = (4, 1) and
    (7, 2), in TAKE_FIRST and TAKE_RANDOM (ReliableBroadcast in TAKE_LAST
    too);
  * cases that mirror the JAX package's own tests: a muted validator,
    determinism over two runs of one seed, and malicious decryption shares,
    whose evidence (every honest router convicts exactly the malicious
    ones, kind invalid_share, proto "dec") must be equal.

The two packages draw a ciphertext's randomness and the RLC weights from
different generators (the JAX package from `secrets`, the port from its
seeded routers), which changes no message and no delivery, so
`delivered_count` is compared everywhere.

The JAX side runs on its default host backend (the native library). The
port runs on `GpuBackend(device="cpu", pipeline=HostEraPipeline(native))`:
the era's MSMs on the host, so that a HoneyBadger era at (7, 2) costs a
second, not the ~20 s a flush of the plain kernels' era takes on one core;
`test_honey_badger_on_the_plain_kernels` runs one era through the plain
versions of the card's kernels (`GpuBackend(device="cpu")`, both batchers).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.simulator import DeliveryMode as JMode
from lachain_tpu.consensus.simulator import SimulatedNetwork as JNet
from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu_torch import convert
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.era import EraRouter
from lachain_tpu_torch.consensus.evidence import INVALID_SHARE
from lachain_tpu_torch.consensus.honey_badger import HoneyBadger
from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend
from lachain_tpu_torch.ops.verify import HostEraPipeline
from tests.test_consensus import keys_for
from tests.test_consensus_byzantine import _run_with_malicious

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

SIZES = [(4, 1), (7, 2)]
MODES = [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM]
_PORT_KEYS: dict = {}


def carried_keys(n, f):
    """The JAX dealer's (n, f) key set (tests/test_consensus.keys_for) and
    the port's copy of it, carried as numpy arrays and bytes."""
    pub, privs = keys_for(n, f)
    if (n, f) not in _PORT_KEYS:
        def rows(points, enc):
            return np.stack([np.frombuffer(enc(p), dtype=np.uint8) for p in points])

        _PORT_KEYS[(n, f)] = convert.consensus_keys_from_numpy(
            f,
            np.frombuffer(jbls.g1_to_bytes(pub.tpke_pub.y), dtype=np.uint8),
            rows([vk.y_i for vk in pub.tpke_verification_keys], jbls.g1_to_bytes),
            rows([p.tpke_priv.x_i for p in privs], jbls.fr_to_bytes),
            rows([k.y for k in pub.ts_keys.keys], jbls.g1_to_bytes),
            rows([p.ts_share.x_i for p in privs], jbls.fr_to_bytes),
            pub.ecdsa_pub_keys,
            [p.ecdsa_priv for p in privs],
        )
    return (pub, privs), _PORT_KEYS[(n, f)]


_HOST = []


def host_backend():
    if not _HOST:
        _HOST.append(NativeBackend())
    return _HOST[0]


def port_net(n, f, seed, mode=DeliveryMode.TAKE_FIRST, plain=False, **kw):
    """The port's network on the CPU: the era on the host pipeline, or on
    the plain kernels with `plain`."""
    host = host_backend()
    pipeline = None if plain else HostEraPipeline(host)
    backend = GpuBackend(device="cpu", host_backend=host, pipeline=pipeline)
    pub, privs = carried_keys(n, f)[1]
    return SimulatedNetwork(pub, privs, seed=seed, mode=mode, device="cpu",
                            backend=backend, **kw)


def jax_net(n, f, seed, mode=DeliveryMode.TAKE_FIRST, **kw):
    pub, privs = carried_keys(n, f)[0]
    return JNet(pub, privs, seed=seed, mode=JMode[mode.name], **kw)


def drive(net, pid, inputs, live):
    """Post every validator's input, run to every live router's result;
    -> (done, delivered_count, live results)."""
    for i, value in enumerate(inputs):
        net.post_request(i, pid, value)
    done = net.run(lambda: all(net.routers[i].result_of(pid) is not None for i in live))
    return done, net.delivered_count, [net.routers[i].result_of(pid) for i in live]


def run_both(n, f, seed, mode, pid_name, pid_args, inputs, muted=(), plain=False, **kw):
    """The same protocol instance through both packages -> (jax, port)
    outcomes of `drive`."""
    live = [i for i in range(n) if i not in muted]
    jax_out = drive(jax_net(n, f, seed, mode, muted=set(muted), **kw),
                    getattr(JM, pid_name)(*pid_args), inputs, live)
    port_out = drive(port_net(n, f, seed, mode, plain=plain, muted=set(muted), **kw),
                     getattr(M, pid_name)(*pid_args), inputs, live)
    return jax_out, port_out


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_binary_broadcast(n, f, mode):
    jax_out, port_out = run_both(n, f, 42, mode, "BinaryBroadcastId", (0, 0, 0),
                                 [i % 2 == 0 for i in range(n)])
    assert jax_out[0] and port_out == jax_out


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_common_coin(n, f, mode):
    jax_out, port_out = run_both(n, f, 7, mode, "CoinId", (0, 1, 5), [None] * n)
    assert jax_out[0] and port_out == jax_out
    assert len(set(port_out[2])) == 1


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_binary_agreement(n, f, mode):
    jax_out, port_out = run_both(n, f, 10, mode, "BinaryAgreementId", (0, 0),
                                 [i % 2 == 0 for i in range(n)])
    assert jax_out[0] and port_out == jax_out
    assert len(set(port_out[2])) == 1


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES + [DeliveryMode.TAKE_LAST], ids=lambda m: m.name)
@pytest.mark.parametrize("batcher", [False, True], ids=["inline", "rbc_batcher"])
def test_reliable_broadcast(n, f, mode, batcher):
    payload = b"proposal from validator 2" * 10
    jax_out, port_out = run_both(
        n, f, 11, mode, "ReliableBroadcastId", (0, 2),
        [payload if i == 2 else None for i in range(n)],
        repeat_probability=0.1, use_rbc_batcher=batcher)
    assert jax_out[0] and port_out == jax_out
    assert port_out[2] == [payload] * n


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_common_subset(n, f, mode):
    jax_out, port_out = run_both(n, f, 13, mode, "CommonSubsetId", (0,),
                                 [b"input-%d" % i for i in range(n)])
    assert jax_out[0] and port_out == jax_out
    assert len(port_out[2][0]) >= n - f


@pytest.mark.parametrize("n,f", SIZES)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_honey_badger(n, f, mode):
    inputs = [b"txbatch|%d|" % i + bytes(32) for i in range(n)]
    jax_out, port_out = run_both(n, f, 14, mode, "HoneyBadgerId", (0,), inputs)
    assert jax_out[0] and port_out == jax_out
    result = port_out[2][0]
    assert len(result) >= n - f
    assert all(pt == inputs[j] for j, pt in result.items())


def test_honey_badger_on_the_plain_kernels():
    """One era with both batchers on the plain versions of the card's
    kernels: the TPKE flush through GpuEraPipeline on the CPU, the RBC
    flushes through rs_batch's plain product."""
    inputs = [b"tx|%d" % i + bytes(64) for i in range(4)]
    jax_out, port_out = run_both(4, 1, 3, DeliveryMode.TAKE_RANDOM, "HoneyBadgerId", (0,),
                                 inputs, plain=True, use_rbc_batcher=True)
    assert jax_out[0] and port_out == jax_out
    assert all(pt == inputs[j] for j, pt in port_out[2][0].items())


def test_honey_badger_with_a_muted_validator():
    """tests/test_consensus.py::test_honey_badger_with_crash: validator 0
    sends and receives nothing; the other three agree."""
    jax_out, port_out = run_both(4, 1, 15, DeliveryMode.TAKE_FIRST, "HoneyBadgerId", (0,),
                                 [b"tx-%d" % i for i in range(4)], muted=(0,))
    assert jax_out[0] and port_out == jax_out
    assert len(port_out[2][0]) >= 3


def test_common_coin_with_a_muted_validator():
    jax_out, port_out = run_both(4, 1, 8, DeliveryMode.TAKE_FIRST, "CoinId", (0, 0, 1),
                                 [None] * 4, muted=(3,))
    assert jax_out[0] and port_out == jax_out


def test_determinism_same_seed():
    """tests/test_consensus.py::test_determinism_same_seed: two runs of one
    seed replay one execution, the JAX package's."""
    outs = []
    for _ in range(2):
        net = port_net(4, 1, 77, DeliveryMode.TAKE_RANDOM)
        outs.append(drive(net, M.HoneyBadgerId(era=0), [b"d-%d" % i for i in range(4)],
                          range(4)))
    want = drive(jax_net(4, 1, 77, DeliveryMode.TAKE_RANDOM), JM.HoneyBadgerId(era=0),
                 [b"d-%d" % i for i in range(4)], range(4))
    assert outs[0] == outs[1] == want


class MaliciousHoneyBadger(HoneyBadger):
    """Broadcasts corrupted decryption shares (a wrong point) for every
    slot, as tests/test_consensus_byzantine.MaliciousHoneyBadger does."""

    def handle_child_result(self, child_id, value):
        if isinstance(child_id, M.CommonSubsetId) and self._ciphertexts is None:
            self._ciphertexts = {}
            for slot, blob in value.items():
                try:
                    share = tpke.EncryptedShare.from_bytes(blob, self.host)
                except (ValueError, AssertionError):
                    self._plaintexts[slot] = None
                    continue
                self._ciphertexts[slot] = share
                dec = self._priv.tpke_priv.decrypt_share(share, backend=self.host)
                corrupted = tpke.PartiallyDecryptedShare(
                    ui=bls.g1_mul(dec.ui, 1337),  # wrong point
                    decryptor_id=dec.decryptor_id,
                    share_id=dec.share_id,
                )
                self.broadcaster.broadcast(
                    M.DecryptedMessage(hb=self.id, share_id=slot, payload=corrupted.to_bytes())
                )
            return
        super().handle_child_result(child_id, value)


class MaliciousRouter(EraRouter):
    def _create(self, pid):
        if isinstance(pid, M.HoneyBadgerId):
            return MaliciousHoneyBadger(pid, self, self.public_keys, self.private_keys)
        return super()._create(pid)


def run_malicious(net, pub, privs, n_malicious, inputs):
    """The first n_malicious routers swapped for MaliciousRouters, with no
    TPKE batcher, as tests/test_consensus_byzantine._run_with_malicious
    leaves its replacements; run to every honest router's result."""
    for i in range(n_malicious):
        net.routers[i] = net.make_router(i, 0, pub, privs[i], router_cls=MaliciousRouter)
        net.routers[i].crypto_batcher = None
    return drive(net, M.HoneyBadgerId(era=0), inputs, range(n_malicious, len(inputs)))


@pytest.mark.parametrize("n,f,bad", [(4, 1, 1), (7, 2, 2)])
def test_malicious_decryption_shares(n, f, bad):
    """tests/test_consensus_byzantine.py::test_honey_badger_malicious_shares
    on both packages: equal results, delivered_count and evidence."""
    jax_net_, jax_results = _run_with_malicious(n, f, bad, seed=21)
    pub, privs = carried_keys(n, f)[1]
    net = port_net(n, f, 21, DeliveryMode.TAKE_RANDOM)
    done, delivered, results = run_malicious(net, pub, privs, bad,
                                             [b"tx|%d" % i for i in range(n)])
    assert done and delivered == jax_net_.delivered_count
    assert results == jax_results
    assert all(pt == b"tx|%d" % j for j, pt in results[0].items())
    for i in range(bad, n):
        ev = net.routers[i].evidence
        assert {r.offender for r in ev.records(era=0)} == set(range(bad))
        assert all(r.kind == INVALID_SHARE and r.proto == "dec" for r in ev.records(era=0))
        assert ev.snapshot(0) == jax_net_.routers[i].evidence.snapshot(0)


def test_equivocating_payloads_are_evidence():
    """A sender's second, different payload for one slot is dropped by the
    router's first-seen latch and recorded as equivocation, as in the JAX
    package's router."""
    pub, privs = carried_keys(4, 1)[1]
    net = port_net(4, 1, 5)
    bb = M.BinaryBroadcastId(0, 0, 0)
    net.inject(1, 0, M.AuxMessage(bb=bb, value=True))
    net.inject(1, 0, M.AuxMessage(bb=bb, value=False))
    net.inject(1, 0, M.AuxMessage(bb=bb, value=True))
    net.run(lambda: False)
    ev = net.routers[0].evidence
    assert ev.snapshot(0) == [{"era": 0, "kind": "equivocation", "offender": 1,
                               "proto": "aux", "index": [0, 0]}]


def test_future_era_messages_wait_for_advance():
    """A payload of a later era is postponed and replayed by advance_era;
    the finished era's protocols and outbox are dropped beyond the last
    active era; the outbox replays an era's sends to a requester."""
    net = port_net(4, 1, 6)
    router = net.routers[0]
    coin1 = M.CoinId(1, 0, 1)
    router.dispatch_external(1, M.AuxMessage(bb=M.BinaryBroadcastId(1, 0, 0), value=True))
    assert router.protocol(M.BinaryBroadcastId(1, 0, 0)) is None
    net.post_request(0, M.CoinId(0, 0, 1), None)
    sent = router.outbox_payloads(0, 2)
    assert [type(p) for p in sent] == [M.CoinMessage]
    queued = len(net._queue)
    assert router.replay_outbox(0, 2) == 1 and len(net._queue) == queued + 1
    router.advance_era(1)
    assert router.protocol(M.BinaryBroadcastId(1, 0, 0)) is not None
    assert router.protocol(M.CoinId(0, 0, 1)) is not None  # the last active era stays
    router.advance_era(3)
    assert router.protocol(M.CoinId(0, 0, 1)) is None
    assert router.outbox_payloads(0, 2) == []
    router.internal_request(M.Request(from_id=None, to_id=coin1, input=None))
    assert router.protocol(coin1) is None  # a dead era is not resurrected
