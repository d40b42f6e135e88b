"""The port's durable sends on its native engine vs the JAX package's, on
the CPU.

The engine's own protocols (BB, BA, RBC, ACS) send from C++ and are not
journaled; the host shims' sends (coin shares, decryption shares, the
signed header) go through `NativeEraRouter._native_send`, which records
them before the engine transmits them and substitutes the recorded bytes
for a slot sent before.

* (4, 1), a HoneyBadger era in TAKE_RANDOM: the JAX package's
  `test_native_journal_replay_for_native_protocols`
  (tests/test_native_rt.py) on the port: coin and decryption shares are
  journaled, equal to the JAX engine's journals byte for byte; a fresh
  network's router re-armed from its journal replays its outbox through
  the engine, and a re-derived payload with zeroed bytes for a journaled
  slot comes back as the recorded bytes.
* (7, 2), a Root era (RootProtocol native through `set_root_context`)
  crashed at about half its messages and restarted from its journals, as
  in tests/test_torch_crash_recovery.py, on both packages' engines, in
  TAKE_FIRST and TAKE_RANDOM; the engine runs in chunks of CHUNK messages
  so that the crash lands mid-era, the same chunks in every run.
* A journaled era gives the un-journaled era's blocks and
  `delivered_count`.

The JAX engine is tests/test_torch_native_rt.py's `jax_engine` fixture.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.journal import ConsensusJournal as JConsensusJournal
from lachain_tpu.storage import kv as jkv
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.journal import ConsensusJournal
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from lachain_tpu_torch.network import wire
from lachain_tpu_torch.storage.kv import MemoryKV
from tests.test_torch_consensus import carried_keys
from tests.test_torch_crash_recovery import (
    CRASH_SEED,
    MODES,
    Side,
    align_encryption,
    check_crash_restart,
    kv_rows,
    slot_map,
)
from tests.test_torch_native_rt import (  # noqa: F401 - jax_engine is a fixture
    hb_inputs,
    jax_engine,
    jax_native,
    port_native,
)
from tests.test_torch_root_protocol import JaxProducer, PortProducer, proposals

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

CHUNK = 512


def native_sides(engine, n, f, seed, mode):
    """(port, JAX) Root eras on the native engines, both batchers, Root
    hosted natively over tests/test_torch_root_protocol.py's producers."""
    (jpub, jprivs), (pub, privs) = carried_keys(n, f)
    jprop, pprop = proposals(n)

    def port(journals):
        net = port_native(n, f, seed, mode, use_rbc_batcher=True, journals=journals)
        for i in range(n):
            net.set_root_context(i, PortProducer(pprop[i]), privs[i].ecdsa_priv,
                                 pub.ecdsa_pub_keys)
        return net

    def jax(journals):
        net = jax_native(engine, n, f, seed, mode, use_rbc_batcher=True, journals=journals)
        for i in range(n):
            net.set_root_context(i, JaxProducer(jprop[i]), jprivs[i].ecdsa_priv,
                                 jpub.ecdsa_pub_keys)
        return net

    kw = {"chunk": CHUNK}
    return (Side(port, ConsensusJournal, MemoryKV, M.RootProtocolId(era=0), kw),
            Side(jax, JConsensusJournal, jkv.MemoryKV, JM.RootProtocolId(era=0), kw))


def test_native_journal_replay_for_native_protocols(jax_engine, monkeypatch):
    n, f, seed = 4, 1, 5
    align_encryption(monkeypatch, seed)
    pid, jpid = M.HoneyBadgerId(era=0), JM.HoneyBadgerId(era=0)
    journals = [ConsensusJournal(MemoryKV()) for _ in range(n)]
    jax_journals = [JConsensusJournal(jkv.MemoryKV()) for _ in range(n)]
    # TAKE_RANDOM: under TAKE_FIRST BA decides unanimously without a coin
    net = port_native(n, f, seed, DeliveryMode.TAKE_RANDOM, journals=journals)
    jnet = jax_native(jax_engine, n, f, seed, DeliveryMode.TAKE_RANDOM,
                      journals=jax_journals)
    for i, value in enumerate(hb_inputs(n)):
        net.post_request(i, pid, value)
        jnet.post_request(i, jpid, value)
    assert net.run(lambda: all(r.result_of(pid) is not None for r in net.routers))
    assert jnet.run(lambda: all(r.result_of(jpid) is not None for r in jnet.routers))
    assert net.delivered_count == jnet.delivered_count
    net.close()
    jnet.close()
    assert [kv_rows(j._kv) for j in journals] == [kv_rows(j._kv) for j in jax_journals]

    recorded = slot_map(journals[0])
    kinds = {type(wire.decode_payload(d)).__name__ for d in recorded.values()}
    assert kinds == {"CoinMessage", "DecryptedMessage"}, kinds

    net2 = port_native(n, f, 6, DeliveryMode.TAKE_RANDOM, journals=journals)
    r0 = net2.routers[0]
    for era, _seq, target, data in journals[0].entries():
        r0.rearm_sent(era, target, data)
    assert {k: r0._sent_slots.get(k) for k in recorded} == recorded
    # retransmission goes through the engine (a native router has no
    # transport of its own), for the current era only
    bcasts = []
    orig = r0._net._bcast_opaque

    def count(vid, kind, a, b, data):
        bcasts.append(kind)
        return orig(vid, kind, a, b, data)

    r0._net._bcast_opaque = count
    assert r0.replay_outbox(0, 1) == len(list(journals[0].entries())) == len(bcasts)
    assert r0.replay_outbox(99, 1) == 0
    # re-derived payloads with other bytes for journaled slots: the
    # recorded bytes come back, and nothing is journaled again
    records = journals[0].records
    checked = 0
    for (era, _slot), data in recorded.items():
        stale = wire.decode_payload(data)
        if isinstance(stale, M.CoinMessage):
            fresh = M.CoinMessage(coin=stale.coin, share=bytes(len(stale.share)))
        else:
            fresh = M.DecryptedMessage(hb=stale.hb, share_id=stale.share_id,
                                       payload=bytes(len(stale.payload)))
        assert wire.encode_payload(r0._native_send(fresh)) == data
        checked += 1
    assert checked == len(recorded) == r0.replayed_sends
    assert journals[0].records == records
    net2.close()


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_native_mid_era_crash_and_restart(jax_engine, monkeypatch, mode):
    n, f = 7, 2
    align_encryption(monkeypatch, CRASH_SEED)
    port, jax = native_sides(jax_engine, n, f, CRASH_SEED, mode)
    check_crash_restart(port, jax, n, mode.name)
