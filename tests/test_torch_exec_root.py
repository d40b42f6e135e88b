"""A Root era whose producers are the port's BlockProducers, against the
JAX package's, on the CPU.

Both packages run one (4, 1) era of RootProtocol (through the routers'
`extra_factories`) with the same seed and keys, each validator's producer
a `BlockProducer` over its own `BlockManager` and `TransactionPool` on
MemoryKV, wired as the JAX package's core/devnet.py:148-159 wires them
(genesis with the funded senders and the validators' keys, the pool fed
every transaction as the devnet's gossip feeds it, proposal seed i). The
port's producers recover the senders with `device="cpu"`. Every router
must commit the JAX package's block bytes, state hash, receipts and
rows, in TAKE_FIRST and TAKE_RANDOM. ~5 s on one core.
"""
from __future__ import annotations

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.root_protocol import RootProtocol as JRootProtocol
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.root_protocol import RootProtocol
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from tests.test_torch_consensus import carried_keys, jax_net, port_net
from tests.torch_exec_common import (
    CHAIN,
    JAX,
    PORT,
    account,
    block_manager,
    reset_module_state,
    rows,
    signed,
)

torch.set_num_threads(1)

N, F = 4, 1
SENDERS = [account(5000 + i) for i in range(5)]


@pytest.fixture(autouse=True)
def _reset():
    reset_module_state()
    yield
    reset_module_state()


class Node:
    def __init__(self, p, i, pubs):
        self.kv = p.kv.MemoryKV()
        self.state = p.state.StateManager(self.kv)
        self.bm = block_manager(p, self.kv, self.state, p.system_contracts.make_executer(CHAIN))
        self.bm.build_genesis({a: 10**20 for _, a in SENDERS}, CHAIN, validator_pubs=pubs)
        state = self.state
        self.pool = p.tx_pool.TransactionPool(
            self.kv, CHAIN,
            account_nonce=lambda a: p.execution.get_nonce(state.new_snapshot(), a))
        self.producer = p.block_producer.BlockProducer(self.bm, self.pool, N, 8,
                                                       proposal_seed=i)


def run_era(p, mode, seed):
    (jpub, jprivs), (ppub, pprivs) = carried_keys(N, F)
    pub, privs = (jpub, jprivs) if p is JAX else (ppub, pprivs)
    nodes = [Node(p, i, list(pub.ecdsa_pub_keys)) for i in range(N)]
    for j in range(12):
        priv, _ = SENDERS[j % len(SENDERS)]
        stx = signed(p, priv, SENDERS[(j + 1) % len(SENDERS)][1], 1000 + j, j // len(SENDERS),
                     gas_price=1 + j % 3)
        for node in nodes:
            node.pool.add(stx)

    def factory(pid, router):
        i = router.my_id
        cls = JRootProtocol if p is JAX else RootProtocol
        return cls(pid, router, producer=nodes[i].producer, ecdsa_priv=privs[i].ecdsa_priv,
                   ecdsa_pubs=pub.ecdsa_pub_keys)

    if p is JAX:
        net = jax_net(N, F, seed, mode, era=1, extra_factories={JM.RootProtocolId: factory})
        rid = JM.RootProtocolId(era=1)
    else:
        net = port_net(N, F, seed, mode, era=1, extra_factories={M.RootProtocolId: factory})
        rid = M.RootProtocolId(era=1)
    for i in range(N):
        net.post_request(i, rid, None)
    assert net.run(lambda: all(r.result_of(rid) is not None for r in net.routers))
    blocks = [r.result_of(rid) for r in net.routers]
    return dict(
        delivered=net.delivered_count,
        blocks=[b.encode() for b in blocks],
        roots=[n.state.committed.state_hash() for n in nodes],
        receipts=[[n.bm.receipt_by_hash(t) for t in blocks[i].tx_hashes]
                  for i, n in enumerate(nodes)],
        rows=[rows(n.kv) for n in nodes],
        pooled=[len(n.pool) for n in nodes],
    )


@pytest.mark.parametrize("mode", [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM],
                         ids=lambda m: m.name)
def test_root_era_with_block_producers_equals_jax(mode):
    jax = run_era(JAX, mode, 41)
    reset_module_state()
    port = run_era(PORT, mode, 41)
    assert port == jax
    blocks = [PORT.types.Block.decode(b) for b in port["blocks"]]
    block = blocks[0]
    # one header and one transaction list; each router its own N - f signatures
    assert {(b.header, b.tx_hashes) for b in blocks} == {(block.header, block.tx_hashes)}
    assert all(len(b.multisig.signatures) >= N - F for b in blocks)
    assert len(set(port["roots"])) == 1
    assert block.header.index == 1 and block.tx_hashes
    assert block.header.state_hash == port["roots"][0]
    assert all(PORT.types.TransactionReceipt.decode(r).status == 1 for r in port["receipts"][0])
