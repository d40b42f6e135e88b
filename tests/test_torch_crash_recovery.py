"""The port's durable sends on its Python engine vs the JAX package's, on
the CPU.

The danger of a restart is self-equivocation: AUX, CONF and coin values
and the signed header depend on the order in which messages arrive, so a
validator that re-derives them after a restart can send a value that
contradicts what it sent before. The send journal (consensus/journal.py)
records every send before it is transmitted, and a restarted router
re-sends the recorded bytes (`EraRouter._durable_send`, `rearm_sent`).

* (4, 1), a HoneyBadger era in TAKE_RANDOM: the JAX package's
  `test_journal_replay_no_equivocation` (tests/test_crash_recovery.py) on
  the port; the journals after the era equal the JAX package's, key for
  key and byte for byte.
* (7, 2), a Root era crashed at about half its messages: a fresh network
  over the same journals and seed, every router re-armed from its journal
  before its first request, runs to the block. The JAX package runs the
  same procedure. Both give the uncrashed era's block at every router,
  equal journals (the restart journals no slot twice and continues every
  sequence), in TAKE_FIRST and TAKE_RANDOM.
* A journaled era gives the un-journaled era's blocks and
  `delivered_count`: the journal adds no draw.
* `advance_era` prunes the journal and the sent latches below its cutoff,
  as the JAX package's router does; a journal write that fails raises out
  of the send, which transmits nothing.

tests/test_torch_crash_recovery_native.py holds the native engine to the
same cases. The JAX package draws a ciphertext's randomness from
`secrets`, the port from each router's `SeededRng(("router", seed, i))`;
`align_encryption` hands the JAX package's `TpkePublicKey.encrypt` the
port's generator, so that both packages send the same bytes.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.era import EraRouter as JEraRouter
from lachain_tpu.consensus.journal import ConsensusJournal as JConsensusJournal
from lachain_tpu.consensus.root_protocol import RootProtocol as JRootProtocol
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.storage import kv as jkv
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.era import EraRouter
from lachain_tpu_torch.consensus.journal import ConsensusJournal, send_slot
from lachain_tpu_torch.consensus.root_protocol import RootProtocol
from lachain_tpu_torch.consensus.simulator import DeliveryMode, SeededRng
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.network import wire
from lachain_tpu_torch.ops.verify import HostEraPipeline
from lachain_tpu_torch.storage import crashpoints
from lachain_tpu_torch.storage.crashpoints import CrashPlan, CrashPoint, InjectedCrash
from lachain_tpu_torch.storage.kv import MemoryKV, SqliteKV
from tests.test_torch_consensus import carried_keys, host_backend, jax_net, port_net
from tests.test_torch_root_protocol import (
    JaxProducer,
    PortProducer,
    factories,
    proposals,
)

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

MODES = [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM]
CRASH_SEED = 41


def align_encryption(monkeypatch, seed: int) -> None:
    """The JAX package's ciphertexts take their randomness from the port's
    router generators: a validator's first draw, on a fresh network of
    `seed`, is its encryption's."""
    orig = jtpke.TpkePublicKey.encrypt

    def encrypt(self, msg, share_id, rng=None):
        return orig(self, msg, share_id, rng=SeededRng(("router", seed, share_id)))

    monkeypatch.setattr(jtpke.TpkePublicKey, "encrypt", encrypt)


def kv_rows(kv) -> list:
    return list(kv.scan_prefix(b""))


def slot_map(journal) -> dict:
    """{(era, slot): wire bytes} of a journal; no slot journaled twice."""
    out = {}
    for era, _seq, _target, data in journal.entries():
        slot = send_slot(wire.decode_payload(data))
        assert slot is not None and (era, slot) not in out, f"slot {slot} journaled twice"
        out[(era, slot)] = data
    return out


def cpu_backend():
    host = host_backend()
    return GpuBackend(device="cpu", host_backend=host, pipeline=HostEraPipeline(host))


@dataclass
class Side:
    """One package's engine for the Root era: `net(journals)` builds a
    network (journals None: none), with its journal and KV classes."""

    net: Callable
    journal: type
    kv: type
    root: object
    run_kw: dict = field(default_factory=dict)


def python_sides(n, f, seed, mode):
    """(port, JAX) Root eras on the Python engines, RootProtocol through
    extra_factories over tests/test_torch_root_protocol.py's producers."""
    (jpub, jprivs), (pub, privs) = carried_keys(n, f)
    jprop, pprop = proposals(n)

    def port(journals):
        make = factories(RootProtocol, [PortProducer(t) for t in pprop], pub, privs, None)
        rc = EraRouter if journals is None else (
            lambda **kw: EraRouter(journal=journals[kw["my_id"]], **kw))
        return port_net(n, f, seed, mode, router_cls=rc,
                        extra_factories={M.RootProtocolId: make})

    def jax(journals):
        make = factories(JRootProtocol, [JaxProducer(t) for t in jprop], jpub, jprivs, None)
        rc = JEraRouter if journals is None else (
            lambda **kw: JEraRouter(journal=journals[kw["my_id"]], **kw))
        return jax_net(n, f, seed, mode, router_cls=rc,
                       extra_factories={JM.RootProtocolId: make})

    return (Side(port, ConsensusJournal, MemoryKV, M.RootProtocolId(era=0)),
            Side(jax, JConsensusJournal, jkv.MemoryKV, JM.RootProtocolId(era=0)))


def run_era(side, net, done=None):
    """Every validator's Root request, then run to `done` (every block)."""
    for i in range(net.n):
        net.post_request(i, side.root, None)
    ok = net.run(done or (lambda: all(r.result_of(side.root) is not None
                                      for r in net.routers)), **side.run_kw)
    return ok, net.delivered_count, [r.result_of(side.root) for r in net.routers]


def closed(net):
    getattr(net, "close", lambda: None)()
    return net


def journaled_era(side, n):
    """An uncrashed journaled era -> (outcome, KVs, journals)."""
    kvs = [side.kv() for _ in range(n)]
    journals = [side.journal(kv) for kv in kvs]
    net = side.net(journals)
    out = run_era(side, net)
    closed(net)
    return out, kvs, journals


def crash_and_restart(side, n, crash_at):
    """The journaled era stopped once `crash_at` messages are delivered;
    then a fresh network over journals reopened on the same KVs, every
    router re-armed from its journal before its first request, run to
    every block -> (outcome, restarted net, KVs, records before the crash,
    messages delivered before the crash)."""
    kvs = [side.kv() for _ in range(n)]
    net = side.net([side.journal(kv) for kv in kvs])
    run_era(side, net, lambda: net.delivered_count >= crash_at)
    crashed = closed(net).delivered_count
    pre = [len(list(side.journal(kv).entries())) for kv in kvs]
    journals = [side.journal(kv) for kv in kvs]
    net = side.net(journals)
    for router, journal in zip(net.routers, journals):
        for era, _seq, target, data in journal.entries():
            router.rearm_sent(era, target, data)
    out = run_era(side, net)
    closed(net)
    return out, net, kvs, pre, crashed


def check_crash_restart(port, jax, n, mode_name):
    """Both packages' crash and restart at about half the era's messages:
    the uncrashed era's blocks, journals equal to it and to each other."""
    net = port.net(None)
    base = run_era(port, net)
    closed(net)
    (a_ok, a_count, a_blocks), a_kvs, a_journals = journaled_era(port, n)
    assert a_ok and a_count == base[1]
    assert [b.encode() for b in a_blocks] == [b.encode() for b in base[2]]  # no draw added
    out, net, kvs, pre, crashed = crash_and_restart(port, n, a_count // 2)
    assert a_count // 2 <= crashed < a_count
    assert out[0] and [b.encode() for b in out[2]] == [b.encode() for b in a_blocks]
    assert out[1] == a_count  # the restart re-ran the whole era's schedule
    replayed = [r.replayed_sends for r in net.routers]
    assert sum(replayed) > 0 and all(0 < r <= p for r, p in zip(replayed, pre)), (replayed, pre)
    for kv, a_journal, a_kv in zip(kvs, a_journals, a_kvs):
        assert slot_map(ConsensusJournal(kv)) == slot_map(a_journal)
        # the restart journaled its new sends once each, in run A's order
        assert kv_rows(kv) == kv_rows(a_kv)
    jout, _jnet, jkvs, jpre, jcrashed = crash_and_restart(jax, n, a_count // 2)
    assert (jcrashed, jpre) == (crashed, pre), mode_name
    assert jout[1] == out[1] and [b.encode() for b in jout[2]] == [b.encode() for b in out[2]]
    assert [kv_rows(kv) for kv in jkvs] == [kv_rows(kv) for kv in kvs]


def test_journal_replay_no_equivocation(monkeypatch):
    """The JAX package's router-level case on the port: a validator
    restarted from its journal, fed its run-1 inbox in a different order
    and a different top-level input, re-sends every latched slot
    byte-identically; its outbox is re-seeded. After run 1 the journals
    equal the JAX package's."""
    n, f, seed = 4, 1, 5
    align_encryption(monkeypatch, seed)
    (jpub, jprivs), (pub, privs) = carried_keys(n, f)
    journals = [ConsensusJournal(MemoryKV()) for _ in range(n)]
    jax_journals = [JConsensusJournal(jkv.MemoryKV()) for _ in range(n)]
    inboxes = [[] for _ in range(n)]

    class RecordingRouter(EraRouter):
        def dispatch_external(self, sender, payload):
            inboxes[self.my_id].append((sender, payload))
            super().dispatch_external(sender, payload)

    pid = M.HoneyBadgerId(era=0)
    net = port_net(n, f, seed, DeliveryMode.TAKE_RANDOM, router_cls=lambda **kw: (
        RecordingRouter(journal=journals[kw["my_id"]], **kw)))
    jnet = jax_net(n, f, seed, DeliveryMode.TAKE_RANDOM, router_cls=lambda **kw: (
        JEraRouter(journal=jax_journals[kw["my_id"]], **kw)))
    for i in range(n):
        net.post_request(i, pid, b"tx-%d|" % i + bytes(16))
        jnet.post_request(i, JM.HoneyBadgerId(era=0), b"tx-%d|" % i + bytes(16))
    assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
    assert jnet.run(lambda: all(r.result_of(JM.HoneyBadgerId(era=0)) is not None
                                for r in jnet.routers))
    assert net.delivered_count == jnet.delivered_count
    assert [kv_rows(j._kv) for j in journals] == [kv_rows(j._kv) for j in jax_journals]
    assert sum(j.records for j in journals) == sum(len(kv_rows(j._kv)) for j in journals)

    recorded = slot_map(journals[0])
    assert len(recorded) >= 10, "era produced too few latched sends"
    resent = []
    r2 = EraRouter(era=0, my_id=0, public_keys=pub, private_keys=privs[0],
                   send=lambda t, p: resent.append(p), rng=SeededRng(("restart", 0)),
                   backend=cpu_backend(), journal=journals[0])
    for era, _seq, target, data in journals[0].entries():
        r2.rearm_sent(era, target, data)
    assert r2.replay_outbox(0, 1) > 0  # peers asking for replay get the history
    r2.internal_request(M.Request(from_id=None, to_id=pid, input=b"DIFFERENT-BATCH"))
    inbox = list(inboxes[0])
    random.Random(99).shuffle(inbox)
    for sender, payload in inbox:
        r2.dispatch_external(sender, payload)
    checked = 0
    for payload in resent:
        key = (r2._payload_era(payload), send_slot(payload))
        if key in recorded:
            assert wire.encode_payload(payload) == recorded[key], f"self-equivocation on {key}"
            checked += 1
    assert checked >= 5, "replay never exercised the latches"
    assert r2.replayed_sends > 0, "no send was substituted from the journal"
    latched = dict(r2._sent_slots)
    r2.rearm_sent(0, None, b"\x63junk")  # undecodable: logged and skipped
    assert r2._sent_slots == latched


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_mid_era_crash_and_restart(monkeypatch, mode):
    n, f = 7, 2
    align_encryption(monkeypatch, CRASH_SEED)
    port, jax = python_sides(n, f, CRASH_SEED, mode)
    check_crash_restart(port, jax, n, mode.name)


def _era_payloads(era: int, rng: random.Random):
    """(JAX, port) payloads of one era: a coin share, an AUX, a decryption
    share."""
    share, dec = rng.randbytes(96), rng.randbytes(100)
    return [
        (JM.CoinMessage(coin=JM.CoinId(era=era, agreement=2, epoch=1), share=share),
         M.CoinMessage(coin=M.CoinId(era=era, agreement=2, epoch=1), share=share)),
        (JM.AuxMessage(bb=JM.BinaryBroadcastId(era=era, agreement=0, epoch=0), value=True),
         M.AuxMessage(bb=M.BinaryBroadcastId(era=era, agreement=0, epoch=0), value=True)),
        (JM.DecryptedMessage(hb=JM.HoneyBadgerId(era=era), share_id=3, payload=dec),
         M.DecryptedMessage(hb=M.HoneyBadgerId(era=era), share_id=3, payload=dec)),
    ]


def test_advance_era_prunes_journal_and_latches():
    """Sends of eras 0-3 through both packages' routers; after each
    advance_era both hold the same journal rows and sent latches (eras
    below min(new - 1, old) pruned). A second, different send for a slot
    re-sends the recorded bytes and is not journaled again."""
    (jpub, jprivs), (pub, privs) = carried_keys(4, 1)
    sent, jsent = [], []
    kv, jax_kv = MemoryKV(), jkv.MemoryKV()
    r = EraRouter(era=0, my_id=0, public_keys=pub, private_keys=privs[0],
                  send=lambda t, p: sent.append(p), rng=SeededRng(0), backend=cpu_backend(),
                  journal=ConsensusJournal(kv))
    jr = JEraRouter(era=0, my_id=0, public_keys=jpub, private_keys=jprivs[0],
                    send=lambda t, p: jsent.append(p), journal=JConsensusJournal(jax_kv))
    rng = random.Random(3)
    for era in range(4):
        for jp, pp in _era_payloads(era, rng):
            jr.broadcast(jp)
            r.broadcast(pp)
    flipped = M.AuxMessage(bb=M.BinaryBroadcastId(era=1, agreement=0, epoch=0), value=False)
    r.broadcast(flipped)
    jr.broadcast(JM.AuxMessage(bb=JM.BinaryBroadcastId(era=1, agreement=0, epoch=0),
                               value=False))
    assert sent[-1].value is True and r.replayed_sends == 1 and r._journal.records == 12
    assert [wire.encode_payload(p) for p in sent] == [
        wire.encode_payload(jr_p) for jr_p in _as_port(jsent)]

    def state(router, store):
        return (sorted((e, data) for (e, _slot), data in router._sent_slots.items()),
                kv_rows(store), sorted(router._outbox))

    assert state(r, kv) == state(jr, jax_kv)
    for new in (1, 2, 3, 5):
        r.advance_era(new)
        jr.advance_era(new)
        assert state(r, kv) == state(jr, jax_kv), new
    assert {e for e, _ in state(r, kv)[0]} == {3}
    assert r._journal.eras() == [3] and r._journal.pruned == 9


def _as_port(payloads):
    """JAX payloads -> port payloads, through the JAX package's codec."""
    from lachain_tpu.network import wire as jwire

    return [wire.decode_payload(jwire.encode_payload(p)) for p in payloads]


def test_failed_journal_write_raises_and_sends_nothing(tmp_path):
    """Persist-before-transmit: a journal write that dies raises out of the
    send; nothing is transmitted, recorded in the outbox or latched."""
    (_, _), (pub, privs) = carried_keys(4, 1)
    sent = []
    kv = SqliteKV(str(tmp_path / "j.db"))
    r = EraRouter(era=0, my_id=0, public_keys=pub, private_keys=privs[0],
                  send=lambda t, p: sent.append(p), rng=SeededRng(0), backend=cpu_backend(),
                  journal=ConsensusJournal(kv))
    payload = M.CoinMessage(coin=M.CoinId(era=0, agreement=-1, epoch=0), share=bytes(96))
    for point in ("kv.write_batch.pre", "kv.write_batch.mid"):
        with crashpoints.armed(CrashPlan(points=(CrashPoint(point),))):
            with pytest.raises(InjectedCrash):
                r.broadcast(payload)
        assert not sent and not r._outbox and not r._sent_slots
        assert not list(ConsensusJournal(kv).entries())
    r.broadcast(payload)
    assert sent == [payload] and len(list(ConsensusJournal(kv).entries())) == 1
    kv.close()
