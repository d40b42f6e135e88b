"""The port's executer and system contracts (lachain_tpu_torch/core/
execution.py, system_contracts.py) against the JAX package's, on the CPU.

Seeded mixes of signed transactions go through both packages'
`system_contracts.make_executer` from the same state on MemoryKV: plain
transfers with nonce, balance and signature failures; WASM deploys, calls
and nested proxy calls with child traps and out-of-gas (the gas clamp of a
failed call); the native token; a staking cycle at a short cycle length
(`set_cycle_params`): becomeStaker, submitVrf, finishVrfLottery, the
keygen message board and its confirm quorum, finishCycle's rotation
(the key set decoded by each package's `PublicConsensusKeys`), the
attendance check-ins and their settlement, and the withdrawal. Every
receipt's bytes, the state hash and every committed row must be equal.
Then the cases of the JAX package's tests/test_core.py:53-100 on the port.
~10 s on one core.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu_torch.consensus import keys as port_keys
from lachain_tpu_torch.crypto import vrf
from lachain_tpu_torch.utils.serialization import (
    write_bytes,
    write_bytes_list,
    write_u32,
    write_u64,
    write_u256,
)
from tests.torch_exec_common import (
    CHAIN,
    JAX,
    PKGS,
    PORT,
    Rng,
    account,
    block_manager,
    counter_contract,
    proxy_contract,
    reset_module_state,
    rows,
    signed,
    warm,
)

torch.set_num_threads(1)

ACCOUNTS = [account(3000 + i) for i in range(6)]
VALIDATORS = [account(3100 + i) for i in range(4)]


@pytest.fixture(autouse=True)
def _reset():
    reset_module_state()
    yield
    reset_module_state()


def pubkey(priv):
    return PORT.ecdsa.public_key_bytes(priv)


def run_steps(p, steps, balances, validators=(), height=1, probe=None):
    """Execute `steps` [(block index, spec)] in package `p` over a state
    funded with `balances` (and `validators` registered as the genesis
    electorate); `probe(snapshot)` reads the state before the commit ->
    (receipt bytes, state hash, rows after the commit)."""
    kv = p.kv.MemoryKV()
    state = p.state.StateManager(kv)
    snap = state.new_snapshot()
    for addr, bal in sorted(balances.items()):
        p.execution.set_balance(snap, addr, bal)
    if validators:
        p.system_contracts.register_genesis_validators(snap, list(validators))
    executer = p.system_contracts.make_executer(CHAIN)
    out = []
    for i, (block, spec) in enumerate(steps):
        stx = spec(p) if callable(spec) else signed(p, *spec[:4], **spec[4])
        res = executer.execute(snap, stx, block, i)
        assert res.ok == (res.receipt.status == 1)
        out.append(res.receipt.encode())
    if probe is not None:
        probe(p, snap)
    roots = snap.freeze()
    state.commit(height, roots)
    return out, roots.state_hash(), rows(kv)


def run_both(steps, balances, validators=(), probe=None):
    jax = run_steps(JAX, steps, balances, validators, probe=probe)
    port = run_steps(PORT, steps, balances, validators, probe=probe)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert port[2] == jax[2]
    return [PORT.types.TransactionReceipt.decode(r) for r in port[0]]


def statuses(receipts):
    return [r.status for r in receipts]


# -- transfers --------------------------------------------------------------------


def bad_signature(kind):
    priv, _ = ACCOUNTS[0]

    def make(p):
        stx = signed(p, priv, ACCOUNTS[1][1], 5, 0)
        sig = stx.signature
        sig = b"\x00" * 65 if kind == "zero" else sig[:64] + bytes([sig[64] ^ 1])
        return p.types.SignedTransaction(tx=stx.tx, signature=sig)
    return make


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_transfers_with_failures(seed):
    rng = random.Random(seed)
    balances = {a: rng.randrange(10**6, 10**12) for _, a in ACCOUNTS}
    nonces = {a: 0 for _, a in ACCOUNTS}
    steps = []
    for _ in range(60):
        priv, a = rng.choice(ACCOUNTS)
        to = rng.choice(ACCOUNTS)[1] if rng.random() < 0.8 else rng.randbytes(20)
        kind = rng.random()
        nonce = nonces[a]
        value = rng.randrange(1, 10**5)
        if kind < 0.1:
            nonce += rng.choice([1, 5])  # a gap: status 0, nothing consumed
        elif kind < 0.15:
            nonce = max(0, nonce - 1) if nonce else nonce + 3  # stale
        elif kind < 0.22:
            value = 10**13  # more than the sender holds
        else:
            nonces[a] += 1
        steps.append((1, (priv, to, value, nonce,
                          dict(gas_price=rng.randrange(1, 50)))))
    steps.insert(7, (1, bad_signature("zero")))
    steps.insert(19, (1, bad_signature("flip")))
    receipts = run_both(steps, balances)
    st = statuses(receipts)
    assert 0 < sum(st) < len(st)
    assert receipts[7].sender == PORT.types.ZERO_ADDRESS and receipts[7].status == 0


def test_transfer_exact_balance_and_fee():
    (pa, a), (_, b) = ACCOUNTS[0], ACCOUNTS[1]
    fee = PORT.execution.GAS_PER_TX * 3
    steps = [(1, (pa, b, 10**6 - fee, 0, dict(gas_price=3))),
             (1, (pa, b, 1, 1, dict(gas_price=3)))]
    receipts = run_both(steps, {a: 10**6})
    assert statuses(receipts) == [1, 0]


# -- WASM contracts ------------------------------------------------------------------


def deploy(priv, nonce, code_of):
    def make(p):
        sc = p.system_contracts
        return signed(p, priv, sc.DEPLOY_ADDRESS, 0, nonce, gas_limit=10**12,
                      invocation=sc.SEL_DEPLOY + write_bytes(code_of(p)))
    return make


def test_contract_mix_with_traps_and_gas():
    priv, a = ACCOUNTS[0]
    counter = PORT.vm.contract_address(a, 0)
    proxy = PORT.vm.contract_address(a, 1)
    sel_inc = PORT.abi.method_selector("inc()")
    sel_get = PORT.abi.method_selector("get()")
    calls = [
        (counter, sel_inc, 10**12, 0),
        (proxy, counter + sel_inc, 10**12, 0),
        (proxy, counter + b"\xba\xad\xf0\x0d", 10**12, 0),  # child trap
        (counter, sel_inc, PORT.execution.GAS_PER_TX + 50_000, 0),  # out of gas
        (counter, sel_inc, PORT.execution.GAS_PER_TX - 1, 0),  # under the base cost
        (counter, sel_get, 10**12, 0),
        (counter, sel_inc, 10**12, 777),  # value to the contract
        (proxy, counter + sel_get, 10**12, 0),
        (counter, b"", 10**12, 5),  # no invocation: a plain transfer
        (counter, sel_inc, 2**62, 0),  # gas limit beyond the balance
    ]
    steps = [(1, deploy(priv, 0, counter_contract)), (1, deploy(priv, 1, proxy_contract)),
             (1, deploy(priv, 2, lambda p: b"\x00asm junk"))]
    steps += [(1, (priv, to, value, 3 + i, dict(gas_limit=gas, invocation=inv)))
              for i, (to, inv, gas, value) in enumerate(calls)]
    receipts = run_both(steps, {a: 10**18})
    assert statuses(receipts) == [1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0]
    assert receipts[0].return_data == counter and receipts[1].return_data == proxy
    oog = receipts[6]
    assert oog.gas_used == PORT.execution.GAS_PER_TX + 50_000  # clamped to the limit


# -- the native token --------------------------------------------------------------


def test_native_token_calls():
    (pa, a), (pb, b) = ACCOUNTS[0], ACCOUNTS[1]
    sc = PORT.system_contracts
    token = sc.NATIVE_TOKEN_ADDRESS
    steps = [
        (1, (pa, token, 0, 0, dict(invocation=sc.SEL_TRANSFER + b + write_u256(500)))),
        (1, (pa, token, 0, 1, dict(invocation=sc.SEL_TRANSFER + b + write_u256(10**30)))),
        (1, (pb, token, 0, 0, dict(invocation=sc.SEL_BALANCE_OF + a))),
        (1, (pb, token, 0, 1, dict(invocation=sc.SEL_TOTAL_SUPPLY))),
        (1, (pb, token, 0, 2, dict(invocation=b"\x01\x02"))),  # no selector
        (1, (pb, token, 0, 3, dict(invocation=b"\xff" * 4))),  # unknown selector
        (1, (pb, token, 9, 4, dict(invocation=sc.SEL_TRANSFER + a + write_u256(1)))),
    ]
    receipts = run_both(steps, {a: 10**12, b: 10**12})
    assert statuses(receipts) == [1, 0, 1, 1, 0, 0, 1]


# -- staking, governance and attendance over a short cycle ---------------------------

CYCLE, VRF_PHASE, ATTENDANCE = 10, 5, 3
STAKE = 10**20


def staking_steps(blob):
    sc = PORT.system_contracts
    st, gov = sc.STAKING_ADDRESS, sc.GOVERNANCE_ADDRESS
    nonce = {a: 0 for _, a in VALIDATORS}

    def step(block, v, to, inv, value=0):
        priv, a = VALIDATORS[v]
        nonce[a] += 1
        return (block, (priv, to, value, nonce[a] - 1, dict(invocation=inv)))

    def vrf_call(v):
        priv, _ = VALIDATORS[v]
        alpha = b"genesis-seed" + write_u64(0)
        proof, _beta = vrf.evaluate(priv, alpha)
        return sc.SEL_SUBMIT_VRF + write_bytes(pubkey(priv)) + write_bytes(proof)

    pubs = [pubkey(priv) for priv, _ in VALIDATORS]
    steps = [step(1, v, st, sc.SEL_BECOME_STAKER + write_bytes(pubs[v]) + write_u256(STAKE))
             for v in range(4)]
    steps.append(step(1, 0, st, sc.SEL_BECOME_STAKER + write_bytes(b"\x02" * 5)
                      + write_u256(1)))  # a bad key
    steps.append(step(1, 1, st, sc.SEL_GET_STAKE + VALIDATORS[0][1]))
    steps += [step(2, v, st, vrf_call(v)) for v in range(4)]
    steps.append(step(2, 0, st, vrf_call(0)))  # a duplicate submission
    steps.append(step(3, 1, st, sc.SEL_FINISH_LOTTERY))  # inside the phase: refused
    steps.append(step(6, 1, st, sc.SEL_FINISH_LOTTERY))
    steps.append(step(6, 2, st, sc.SEL_FINISH_LOTTERY))  # once a cycle
    steps += [step(7, v, gov, sc.SEL_KEYGEN_COMMIT + write_bytes(b"commit%d" % v))
              for v in range(4)]
    steps.append(step(7, 0, gov, sc.SEL_KEYGEN_SEND_VALUE + write_u256(1)
                      + write_bytes(b"value")))
    steps += [step(7, v, gov, sc.SEL_KEYGEN_CONFIRM + write_bytes(blob)) for v in range(4)]
    steps.append(step(8, 3, gov, sc.SEL_CHANGE_VALIDATORS + write_bytes(blob)))
    steps.append(step(8, 3, gov, sc.SEL_FINISH_CYCLE))  # not the cycle's last block
    steps.append(step(9, 3, gov, sc.SEL_FINISH_CYCLE))
    entries = [pubs[v] + write_u32(8 - v) for v in range(4)]
    steps += [step(11, v, st, sc.SEL_SUBMIT_ATTENDANCE + write_bytes_list(entries))
              for v in range(3)]  # validator 3 never checks in
    steps.append(step(11, 0, st, sc.SEL_SUBMIT_ATTENDANCE + write_bytes_list(entries)))
    steps.append(step(12, 1, st, sc.SEL_FINISH_ATTENDANCE))  # window still open
    steps.append(step(14, 1, st, sc.SEL_FINISH_ATTENDANCE))
    steps.append(step(14, 3, st, sc.SEL_GET_PENALTY + VALIDATORS[3][1]))
    steps.append(step(15, 3, st, sc.SEL_REQUEST_WITHDRAW))
    steps.append(step(15, 3, st, sc.SEL_WITHDRAW))
    steps.append(step(15, 2, st, sc.SEL_WITHDRAW))  # nothing requested
    return steps


def test_staking_cycle_governance_and_attendance():
    key_set, _ = port_keys.trusted_key_gen(4, 1, Rng(41))
    blob = key_set.encode()
    for p in PKGS:
        p.system_contracts.set_cycle_params(CYCLE, VRF_PHASE, ATTENDANCE)
    balances = {a: 10**22 for _, a in VALIDATORS}
    rotated = []

    def probe(p, snap):
        # the rotation decoded the key set: its members' keys registered
        sc = p.system_contracts
        rotated.append(all(
            snap.get("storage", sc.STAKING_ADDRESS + b"pub:"
                     + PORT.ecdsa.address_from_public_key(k)) == k
            for k in key_set.ecdsa_pub_keys)
            and snap.get("validators", b"current") == blob)

    receipts = run_both(staking_steps(blob), balances,
                        validators=[pubkey(priv) for priv, _ in VALIDATORS], probe=probe)
    assert rotated == [True, True]
    assert statuses(receipts) == [
        1, 1, 1, 1, 0, 1,  # stakes, a bad key, getStake
        1, 1, 1, 1, 0,  # four winning VRF proofs, a duplicate
        0, 1, 0,  # the lottery: inside the phase, closed, closed again
        1, 1, 1, 1, 1, 1, 1, 1, 1,  # commits, a value, the confirm quorum
        0, 0, 1,  # changeValidators refused; FinishCycle off the boundary, on it
        1, 1, 1, 0,  # three check-ins, a second one refused
        0, 1,  # the attendance close: window open, then settled
        1, 1, 1, 0,  # getPenalty, the withdrawal, nothing requested
    ]


def test_register_genesis_validators_rows():
    pubs = [pubkey(priv) for priv, _ in VALIDATORS]
    out = []
    for p in PKGS:
        kv = p.kv.MemoryKV()
        state = p.state.StateManager(kv)
        snap = state.new_snapshot()
        p.system_contracts.register_genesis_validators(snap, pubs)
        state.commit(0, snap.freeze())
        out.append(rows(kv))
    assert out[0] == out[1]


def test_selectors_equal():
    names = [n for n in dir(JAX.system_contracts) if n.startswith("SEL_")]
    assert names and all(getattr(JAX.system_contracts, n) == getattr(PORT.system_contracts, n)
                         for n in names)


# -- tests/test_core.py:53-100 on the port -------------------------------------------


def test_transaction_wire_roundtrip():
    priv, addr = ACCOUNTS[2]
    stx = signed(PORT, priv, b"\x02" * 20, 123, 0)
    back = PORT.types.SignedTransaction.decode(stx.encode())
    assert back == stx and back.sender(CHAIN) == addr
    assert back.sender(CHAIN + 1) != addr
    rec = PORT.types.TransactionReceipt(stx.hash(), 3, 4, 21000, 1, addr, b"ret")
    assert PORT.types.TransactionReceipt.decode(rec.encode()) == rec
    assert rec.encode() == JAX.types.TransactionReceipt(
        stx.hash(), 3, 4, 21000, 1, addr, b"ret").encode()


def _fresh_chain(p, balances):
    kv = p.kv.MemoryKV()
    state = p.state.StateManager(kv)
    bm = block_manager(p, kv, state, p.execution.TransactionExecuter(CHAIN))
    bm.build_genesis(balances, CHAIN)
    return kv, state, bm


def test_emulate_transfer_and_failures():
    (pa, a), (_, b) = ACCOUNTS[2], ACCOUNTS[3]
    specs = [(pa, b, 1000, 0), (pa, b, 2000, 1), (pa, b, 5000, 5), (pa, b, 10**19, 2)]
    ems = []
    for p in PKGS:
        kv, state, bm = _fresh_chain(p, {a: 10**18})
        txs = [signed(p, *s) for s in specs]
        warm(txs)
        em = bm.emulate(txs, 1)
        ems.append((em.state_hash, [r.encode() for r in em.receipts]))
        if p is PORT:
            assert [r.status for r in em.receipts] == [1, 1, 0, 0]
            snap = state.new_snapshot(em.roots)
            assert p.execution.get_balance(snap, b) == 3000
            assert p.execution.get_balance(snap, a) == 10**18 - 3000 - 2 * 21000
            assert p.execution.get_nonce(snap, a) == 2
            before = state.committed.state_hash()
            assert before != em.state_hash  # emulate did not commit
    assert ems[0] == ems[1]
