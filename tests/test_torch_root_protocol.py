"""The port's RootProtocol vs the JAX package's, block for block, on the CPU.

Both packages' `SimulatedNetwork`s run one era's `RootProtocol` (through
the routers' `extra_factories`, as the JAX package's devnet wires it) with
the same seed, keys (the JAX dealer's, carried by `convert`) and seeded
signed transfers (the JAX package's, carried by
`convert.signed_transactions_from_bytes`). The producer is a seam each
package fills with the same fake design: it proposes a validator's
transfers, and its header and block recover the senders in one batch
(`warm_sender_caches`; the port's on the plain versions of the card's
recovery, device="cpu"), order the transactions as the JAX package's block
manager does, and build the header over a seeded parent hash, a fixed
state hash, the Merkle root of the ordered hashes and the coin's nonce.

At (n, f) = (4, 1) and (7, 2), in TAKE_FIRST and TAKE_RANDOM, with a muted
validator and with one that signs its header with a wrong key, every live
router's block (header bytes, multisig encoding, transaction hashes), the
`delivered_count` and every honest router's evidence (the wrong signer's
"hdr" record) must be equal, and each block carries at least N - f
signatures that verify. The port's era runs on the host pipeline
(`HostEraPipeline` behind `GpuBackend(device="cpu")`), as in
tests/test_torch_consensus.py. ~25 s on one core.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.consensus import messages as JM
from lachain_tpu.consensus.root_protocol import RootProtocol as JRootProtocol
from lachain_tpu.core import types as jtypes
from lachain_tpu.core.block_manager import BlockManager as JBlockManager
from lachain_tpu_torch import convert
from lachain_tpu_torch.consensus import messages as M
from lachain_tpu_torch.consensus.evidence import INVALID_SHARE
from lachain_tpu_torch.consensus.root_protocol import NONCE_AGREEMENT, RootProtocol
from lachain_tpu_torch.consensus.simulator import DeliveryMode
from lachain_tpu_torch.core import types
from lachain_tpu_torch.crypto import ecdsa
from tests.test_torch_block_types import CHAIN_ID, seeded_transfers
from tests.test_torch_consensus import carried_keys, jax_net, port_net

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

PARENT = random.Random(0x9007).randbytes(32)
STATE = b"\x5a" * 32
PER_VALIDATOR = 3


def _order(txs, chain_id):
    """The JAX package's block-manager order (sender, nonce, hash)."""
    return sorted(txs, key=lambda stx: (stx.sender(chain_id) or b"\xff" * 20,
                                        stx.tx.nonce, stx.hash()))


class PortProducer:
    """The producer seam: a validator's transfers; senders recovered in one
    batch on the plain kernels before the order is taken."""

    def __init__(self, txs):
        self._txs = txs

    def get_transactions_to_propose(self):
        return list(self._txs)

    def create_header(self, index, txs, nonce):
        types.warm_sender_caches(txs, CHAIN_ID, device="cpu")
        ordered = _order(txs, CHAIN_ID)
        return types.BlockHeader(
            index=index, prev_block_hash=PARENT,
            merkle_root=types.tx_merkle_root([t.hash() for t in ordered]),
            state_hash=STATE, nonce=nonce)

    def produce_block(self, header, txs, multisig):
        types.warm_sender_caches(txs, CHAIN_ID, device="cpu")
        ordered = _order(txs, CHAIN_ID)
        return types.Block(header=header, tx_hashes=tuple(t.hash() for t in ordered),
                           multisig=multisig)


class JaxProducer:
    """The same design over the JAX package's types."""

    def __init__(self, txs):
        self._txs = txs

    def get_transactions_to_propose(self):
        return list(self._txs)

    def create_header(self, index, txs, nonce):
        jtypes.warm_sender_caches(txs, CHAIN_ID)
        ordered = JBlockManager.order_transactions(txs, CHAIN_ID)
        return jtypes.BlockHeader(
            index=index, prev_block_hash=PARENT,
            merkle_root=jtypes.tx_merkle_root([t.hash() for t in ordered]),
            state_hash=STATE, nonce=nonce)

    def produce_block(self, header, txs, multisig):
        jtypes.warm_sender_caches(txs, CHAIN_ID)
        ordered = JBlockManager.order_transactions(txs, CHAIN_ID)
        return jtypes.Block(header=header, tx_hashes=tuple(t.hash() for t in ordered),
                            multisig=multisig)


def proposals(n):
    """Each package's per-validator transfers: validator i proposes
    PER_VALIDATOR of them, overlapping its neighbour's by one (the header
    deduplicates), one of them with a malformed signature."""
    jtxs, _ = seeded_transfers(0x7007 + n, n * (PER_VALIDATOR - 1) + 1, senders=5)
    ptxs = convert.signed_transactions_from_bytes([t.encode() for t in jtxs])
    step = PER_VALIDATOR - 1
    return ([jtxs[i * step:i * step + PER_VALIDATOR] for i in range(n)],
            [ptxs[i * step:i * step + PER_VALIDATOR] for i in range(n)])


def factories(cls, producers, pub, privs, wrong_signer):
    wrong = random.Random(0xBAD).randrange(1, ecdsa.N).to_bytes(32, "big")

    def make(pid, router):
        i = router.my_id
        priv = wrong if i == wrong_signer else privs[i].ecdsa_priv
        return cls(pid, router, producer=producers[i], ecdsa_priv=priv,
                   ecdsa_pubs=pub.ecdsa_pub_keys)
    return make


def run_root(net, root_id, live):
    for i in range(net.n):
        net.post_request(i, root_id, None)
    done = net.run(lambda: all(net.routers[i].result_of(root_id) is not None for i in live))
    return done, net.delivered_count, [net.routers[i].result_of(root_id) for i in live]


def run_both(n, f, seed, mode, muted=(), wrong_signer=None):
    (jpub, jprivs), (pub, privs) = carried_keys(n, f)
    jprop, pprop = proposals(n)
    live = [i for i in range(n) if i not in muted]
    jnet = jax_net(n, f, seed, mode, muted=set(muted), extra_factories={
        JM.RootProtocolId: factories(JRootProtocol, [JaxProducer(t) for t in jprop],
                                     jpub, jprivs, wrong_signer)})
    pnet = port_net(n, f, seed, mode, muted=set(muted), extra_factories={
        M.RootProtocolId: factories(RootProtocol, [PortProducer(t) for t in pprop],
                                    pub, privs, wrong_signer)})
    jout = run_root(jnet, JM.RootProtocolId(era=0), live)
    pout = run_root(pnet, M.RootProtocolId(era=0), live)
    return (jnet, jout), (pnet, pout), live, pub


def check_blocks(jout, pout, pub, n, f, honest):
    assert jout[0] and pout[0]
    assert pout[1] == jout[1]  # delivered_count
    jblocks, pblocks = jout[2], pout[2]
    assert [b.encode() for b in pblocks] == [b.encode() for b in jblocks]
    assert [(b.header.encode(), b.multisig.encode(), b.tx_hashes) for b in pblocks] == [
        (b.header.encode(), b.multisig.encode(), b.tx_hashes) for b in jblocks]
    ref = pblocks[honest[0]]
    h = ref.header.hash()
    for b in (pblocks[i] for i in honest):
        assert b.header == ref.header and b.tx_hashes == ref.tx_hashes
        valid = [i for i, sig in b.multisig.signatures
                 if ecdsa.verify_hash(pub.ecdsa_pub_keys[i], h, sig)]
        assert len(valid) >= n - f
    return ref


@pytest.mark.parametrize("n,f", [(4, 1), (7, 2)])
@pytest.mark.parametrize("mode", [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM],
                         ids=lambda m: m.name)
def test_root_protocol_blocks_equal_reference(n, f, mode):
    (jnet, jout), (pnet, pout), live, pub = run_both(n, f, 31, mode)
    block = check_blocks(jout, pout, pub, n, f, list(range(n)))
    # the union of the agreed slots' transfers, deduplicated, each sender
    # its signer's address (the malformed signature's None sorts last)
    txs = {t.hash(): t for t in proposals(n)[1][0] + [
        t for batch in proposals(n)[1] for t in batch]}
    assert set(block.tx_hashes) <= set(txs) and len(block.tx_hashes) == len(set(block.tx_hashes))
    senders = [txs[h].sender(CHAIN_ID) for h in block.tx_hashes]
    assert senders == sorted(senders, key=lambda s: s or b"\xff" * 20)
    assert block.header.nonce >> 1 == 0  # era 0, the coin's bit below
    assert not any(r.evidence.records() for r in pnet.routers)


@pytest.mark.parametrize("n,f", [(4, 1), (7, 2)])
def test_root_protocol_with_a_muted_validator(n, f):
    (_, jout), (_, pout), live, pub = run_both(n, f, 33, DeliveryMode.TAKE_RANDOM,
                                               muted=(0,))
    check_blocks(jout, pout, pub, n, f, list(range(len(live))))
    assert all(0 not in dict(b.multisig.signatures) for b in pout[2])


@pytest.mark.parametrize("n,f", [(4, 1), (7, 2)])
@pytest.mark.parametrize("mode", [DeliveryMode.TAKE_FIRST, DeliveryMode.TAKE_RANDOM],
                         ids=lambda m: m.name)
def test_root_protocol_with_a_wrong_header_signature(n, f, mode):
    """Validator 0 signs its header with a key that is not its own: an
    honest router that checks it records it once as an invalid "hdr" share,
    and no honest block holds its signature. In TAKE_FIRST every honest
    router has its N - f signatures, and terminates, before validator 0's
    header reaches it, so the evidence is empty in both packages; in
    TAKE_RANDOM (seed 35) routers record it."""
    (jnet, jout), (pnet, pout), live, pub = run_both(n, f, 35, mode, wrong_signer=0)
    check_blocks(jout, pout, pub, n, f, list(range(1, n)))
    for i in range(1, n):
        ev = pnet.routers[i].evidence
        assert ev.snapshot(0) == jnet.routers[i].evidence.snapshot(0)
        got = {(r.kind, r.offender, r.proto) for r in ev.records(era=0)}
        assert got <= {(INVALID_SHARE, 0, "hdr")}
        assert 0 not in dict(pout[2][i].multisig.signatures)
    recorded = any(pnet.routers[i].evidence.records(era=0) for i in range(1, n))
    assert recorded == (mode is DeliveryMode.TAKE_RANDOM)


def test_nonce_agreement_is_the_reference_slot():
    assert NONCE_AGREEMENT == -1
