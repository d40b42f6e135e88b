"""The port's BlockManager, TransactionPool and BlockProducer (lachain_tpu_
torch/core/block_manager.py, tx_pool.py, block_producer.py) and its
lane-parallel execution (parallel_exec.py) against the JAX package's, on
the CPU.

A chain of five blocks of seeded transfers, contract calls and native
token calls, each block produced as a node produces it (the pool's
admission, `get_transactions_to_propose` from a seeded sample,
`create_header`, `produce_block` with the state hash checked), on
MemoryKV, SqliteKV and LsmKV in both packages: every block's bytes and
every row of the store (blocks, transactions, the address index, the
blooms, the pool's rows, the trie and the roots) must be equal, at lanes
1 and 4. A wrong state hash or merkle root is refused. The pool's order,
nonce continuity, replacement, restore and concurrent admission; the
lanes against the serial oracle and the JAX package (receipts, roots and
trie node sets bit for bit), the planner, `RecordingSnapshot` and the
checkpoint model of the JAX package's tests/test_parallel_exec.py:168-423.
~15 s on one core.
"""
from __future__ import annotations

import copy
import random
import threading

import pytest
import torch

from lachain_tpu_torch.utils.serialization import write_bytes, write_u256
from tests.test_torch_lsm import jax_lsm  # noqa: F401  (a fixture)
from tests.torch_exec_common import (
    CHAIN,
    JAX,
    PKGS,
    PORT,
    account,
    block_manager,
    counter_contract,
    gc_held,
    reset_module_state,
    rows,
    signed,
    warm,
)

torch.set_num_threads(1)

ACCOUNTS = [account(4000 + i) for i in range(6)]
BACKENDS = ["memory", "sqlite", "lsm"]


@pytest.fixture(autouse=True)
def _reset():
    reset_module_state()
    yield
    reset_module_state()


def open_store(p, backend, path, jax_lsm_cls):
    if backend == "memory":
        return p.kv.MemoryKV()
    if backend == "sqlite":
        return p.kv.SqliteKV(str(path))
    if p is JAX:
        return jax_lsm_cls(str(path))
    from lachain_tpu_torch.storage.lsm import LsmKV

    return LsmKV(str(path))


def block_specs(height, rng, nonces, counter):
    """Block `height`'s transactions as specs: transfers between the
    accounts (a few with nonce gaps, which stay in the pool), native
    token transfers (a few overdrawn: status 0), and from height 2 calls
    of the counter deployed at height 1 by account 0."""
    sc = PORT.system_contracts
    specs = []
    if height == 1:
        priv, a = ACCOUNTS[0]
        specs.append((priv, sc.DEPLOY_ADDRESS, 0, nonces[a],
                      dict(gas_limit=10**12,
                           invocation=sc.SEL_DEPLOY + write_bytes(counter_contract(PORT)))))
        nonces[a] += 1
    for _ in range(14):
        priv, a = rng.choice(ACCOUNTS)
        kind = rng.random()
        to = rng.choice(ACCOUNTS)[1]
        if kind < 0.1:
            specs.append((priv, to, 1, nonces[a] + 40, dict(gas_price=2)))  # a gap
            continue
        if kind < 0.3:
            amount = rng.randrange(1, 99) if kind < 0.25 else 10**30  # or an overdraw
            spec = (priv, sc.NATIVE_TOKEN_ADDRESS, 0, nonces[a],
                    dict(invocation=sc.SEL_TRANSFER + to + write_u256(amount)))
        elif kind < 0.5 and height > 1:
            spec = (priv, counter, 0, nonces[a],
                    dict(gas_limit=10**10, invocation=PORT.abi.method_selector("inc()")))
        else:
            spec = (priv, to, rng.randrange(1, 10**6), nonces[a],
                    dict(gas_price=rng.randrange(1, 9)))
        specs.append(spec)
        nonces[a] += 1
    return specs


def run_chain(p, kv, lanes, blocks=5, seed=5):
    """Five blocks produced through the pool and the producer -> (block
    bytes, receipts of each block, the pool's size)."""
    state = p.state.StateManager(kv)
    bm = block_manager(p, kv, state, p.system_contracts.make_executer(CHAIN), lanes=lanes)
    bm.build_genesis({a: 10**20 for _, a in ACCOUNTS}, CHAIN,
                     validator_pubs=[p.ecdsa.public_key_bytes(ACCOUNTS[0][0])])
    pool = p.tx_pool.TransactionPool(
        kv, CHAIN, account_nonce=lambda a: p.execution.get_nonce(state.new_snapshot(), a))
    producer = p.block_producer.BlockProducer(bm, pool, n_validators=1, txs_per_block=24,
                                              proposal_seed=3)
    rng = random.Random(seed)
    nonces = {a: 0 for _, a in ACCOUNTS}
    counter = PORT.vm.contract_address(ACCOUNTS[0][1], 0)
    out, receipts = [], []
    for h in range(1, blocks + 1):
        for spec in block_specs(h, rng, nonces, counter):
            stx = signed(p, *spec[:4], **spec[4])
            if pool.precheck(stx):
                pool.add(stx)
        txs = producer.get_transactions_to_propose()
        header = producer.create_header(h, txs, nonce=h * 7)
        block = producer.produce_block(header, txs, p.types.MultiSig(()))
        out.append(block.encode())
        receipts.append([bm.receipt_by_hash(t) for t in block.tx_hashes])
    assert bm.current_height() == blocks
    return out, receipts, len(pool)


@pytest.mark.parametrize("backend", BACKENDS)
def test_chain_rows_equal_jax(tmp_path, jax_lsm, backend):
    got = {}
    for p in PKGS:
        for lanes in (1, 4):
            reset_module_state()
            with gc_held():
                kv = open_store(p, backend, tmp_path / f"{p.name}{lanes}.db", jax_lsm)
                res = run_chain(p, kv, lanes)
                got[(p.name, lanes)] = res + (rows(kv),)
                kv.close()
    ref = got[("jax", 1)]
    for key, res in got.items():
        assert res[0] == ref[0], key  # blocks
        assert res[1] == ref[1], key  # receipts
        assert res[2] == ref[2], key  # what stays in the pool
        assert res[3] == ref[3], key  # every row of the store
    blocks = [PORT.types.Block.decode(b) for b in ref[0]]
    assert sum(len(b.tx_hashes) for b in blocks) > 40
    assert ref[2] > 0
    statuses = [PORT.types.TransactionReceipt.decode(r).status for rs in ref[1] for r in rs]
    assert 0 in statuses and 1 in statuses


def test_reads_and_reopen(tmp_path):
    kv = PORT.kv.SqliteKV(str(tmp_path / "c.db"))
    blocks, receipts, _ = run_chain(PORT, kv, 1, blocks=3)
    kv.close()
    kv = PORT.kv.SqliteKV(str(tmp_path / "c.db"))
    state = PORT.state.StateManager(kv)
    bm = block_manager(PORT, kv, state, PORT.system_contracts.make_executer(CHAIN))
    assert bm.current_height() == 3
    for h, enc in enumerate(blocks, start=1):
        block = bm.block_by_height(h)
        assert block.encode() == enc
        assert bm.block_by_hash(block.hash()) == block
        assert len(bm.bloom_by_height(h)) == PORT.bloom.BLOOM_BYTES
        for th, rec in zip(block.tx_hashes, receipts[h - 1]):
            assert bm.transaction_by_hash(th).hash() == th
            assert PORT.types.TransactionReceipt.decode(rec).tx_hash == th
    # the counter's deploy emitted an event: block 1's bloom holds the deployer
    assert PORT.bloom.contains(bm.bloom_by_height(1), PORT.system_contracts.DEPLOY_ADDRESS)
    hist = bm.transactions_by_address(ACCOUNTS[0][1], limit=1000)
    assert hist and hist == sorted(hist, reverse=True)
    assert all(h <= 3 for h, _ in hist)
    assert bm.transactions_by_address(ACCOUNTS[0][1], before_height=2) == [
        x for x in hist if x[0] < 2]
    assert PORT.fsck.fsck(kv, repair=False).clean
    kv.close()


# -- the header checks (tests/test_core.py:140) -------------------------------------


def _fresh(p, balances=None, lanes=1):
    kv = p.kv.MemoryKV()
    state = p.state.StateManager(kv)
    bm = block_manager(p, kv, state, p.system_contracts.make_executer(CHAIN), lanes=lanes)
    bm.build_genesis(balances or {a: 10**18 for _, a in ACCOUNTS}, CHAIN)
    return kv, state, bm


@pytest.mark.parametrize("wrong", ["state_hash", "merkle_root"])
def test_execute_block_rejects_a_wrong_header(wrong):
    for p in PKGS:
        kv, state, bm = _fresh(p)
        (pa, _), (_, b) = ACCOUNTS[0], ACCOUNTS[1]
        txs = [signed(p, pa, b, 5, 0)]
        warm(txs)
        em = bm.emulate(txs, 1)
        header = p.types.BlockHeader(
            index=1, prev_block_hash=bm.block_by_height(0).hash(),
            merkle_root=b"\x00" * 32 if wrong == "merkle_root"
            else p.types.tx_merkle_root([t.hash() for t in txs]),
            state_hash=b"\x11" * 32 if wrong == "state_hash" else em.state_hash, nonce=0)
        with pytest.raises(ValueError, match=wrong.replace("_", " ")):
            bm.execute_block(header, txs, p.types.MultiSig(()))
        assert bm.current_height() == 0


def test_execute_block_recovers_senders_on_its_device():
    """A block whose senders no ingest recovered: execute_block recovers
    them in one batch on its device (the plain kernels, device="cpu") and
    commits the JAX package's block and rows."""
    specs = [(ACCOUNTS[i][0], ACCOUNTS[i + 1][1], 9, 0) for i in range(3)]
    out = []
    for p in PKGS:
        kv, state, bm = _fresh(p)
        probe = [signed(p, *s) for s in specs]
        warm(probe)
        ordered = bm.order_transactions(probe, CHAIN)
        header = p.types.BlockHeader(
            index=1, prev_block_hash=bm.block_by_height(0).hash(),
            merkle_root=p.types.tx_merkle_root([t.hash() for t in ordered]),
            state_hash=bm.emulate(ordered, 1).state_hash, nonce=0)
        fresh = [signed(p, *s) for s in specs]
        assert all("_sender_cache" not in t.__dict__ for t in fresh)
        block = bm.execute_block(header, fresh, p.types.MultiSig(()))
        assert [t.__dict__["_sender_cache"] for t in fresh] == [
            (CHAIN, ACCOUNTS[i][1]) for i in range(3)]
        out.append((block.encode(), rows(kv)))
    assert out[0] == out[1]


# -- the pool (tests/test_core.py:101-128, tests/test_parallel_exec.py:460-520) ------


def _pool(p, kv=None, nonce=lambda a: 0):
    return p.tx_pool.TransactionPool(kv or p.kv.MemoryKV(), CHAIN, account_nonce=nonce)


def test_pool_ordering_and_nonce_continuity():
    picks = []
    for p in PKGS:
        (pa, a), (pb, b) = ACCOUNTS[0], ACCOUNTS[1]
        pool = _pool(p)
        assert pool.add(signed(p, pa, b, 1, 0, gas_price=5))
        assert pool.add(signed(p, pa, b, 1, 1, gas_price=5))
        assert pool.add(signed(p, pa, b, 1, 3, gas_price=9))  # a gap: not executable
        assert pool.add(signed(p, pb, a, 1, 0, gas_price=7))
        picked = pool.peek(10)
        assert [t.tx.nonce for t in picked if t.sender(CHAIN) == a] == [0, 1]
        assert picked[0].sender(CHAIN) == b
        assert not pool.add(signed(p, pb, a, 1, 0, gas_price=7))  # duplicate
        assert not pool.add(signed(p, pb, a, 1, 0, gas_price=6))  # cheaper replacement
        assert pool.add(signed(p, pb, a, 1, 0, gas_price=8))
        sampled = pool.peek(2, rng=random.Random(9), window_txs=10)
        picks.append(([t.encode() for t in picked], [t.encode() for t in sampled],
                      sorted(pool.persisted_hashes()), pool.next_nonce(a)))
    assert picks[0] == picks[1]


def test_pool_restore_and_clear(tmp_path):
    out = []
    for p in PKGS:
        kv = p.kv.SqliteKV(str(tmp_path / f"{p.name}.db"))
        (pa, _), (_, b) = ACCOUNTS[0], ACCOUNTS[1]
        pool = _pool(p, kv)
        for n in range(4):
            pool.add(signed(p, pa, b, 1, n))
        pool2 = _pool(p, kv, nonce=lambda a: 2)  # two of them executed meanwhile
        assert pool2.restore() == 2 and len(pool2) == 2
        out.append(rows(kv))
        pool2.clear()
        assert len(pool2) == 0 and pool2.persisted_hashes() == []
        kv.close()
    assert out[0] == out[1]


def test_pool_concurrent_add_all_admitted():
    n_threads, per_thread = 8, 12
    privs = [account(4100 + i)[0] for i in range(n_threads)]
    batches = [[signed(PORT, priv, ACCOUNTS[0][1], 1, n) for n in range(per_thread)]
               for priv in privs]
    pool = _pool(PORT)
    results = [None] * n_threads

    def work(ti):
        results[ti] = [pool.add(stx) for stx in batches[ti]]

    threads = [threading.Thread(target=work, args=(ti,)) for ti in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(all(r) for r in results)
    assert len(pool) == n_threads * per_thread
    assert len(pool.peek(10**6)) == n_threads * per_thread
    assert len(pool.persisted_hashes()) == n_threads * per_thread


def test_pool_sharded_semantics():
    pool = _pool(PORT)
    priv, sender = ACCOUNTS[1]
    stx = signed(PORT, priv, ACCOUNTS[2][1], 1, 0, gas_price=2)
    assert pool.add(stx) and not pool.add(stx) and not pool.precheck(stx)
    assert not pool.add(signed(PORT, priv, ACCOUNTS[2][1], 2, 0, gas_price=2))
    richer = signed(PORT, priv, ACCOUNTS[2][1], 3, 0, gas_price=5)
    assert pool.add(richer)
    assert pool.get(stx.hash()) is None and pool.get(richer.hash()) is richer
    assert len(pool) == 1 and pool.next_nonce(sender) == 1
    pool.remove_included([richer.hash()])
    assert len(pool) == 0 and pool.persisted_hashes() == []
    assert pool.add(stx)
    pool._account_nonce_fn = lambda addr: 99
    assert pool.sanitize() == 1 and len(pool) == 0
    assert not pool.add(signed(PORT, priv, ACCOUNTS[2][1], 3, 0, gas_price=0))


def test_producer_overlay_skips_in_flight_blocks():
    got = []
    for p in PKGS:
        kv, state, bm = _fresh(p)
        pool = p.tx_pool.TransactionPool(
            kv, CHAIN, account_nonce=lambda a: p.execution.get_nonce(state.new_snapshot(), a))
        prod = p.block_producer.BlockProducer(bm, pool, 1, txs_per_block=4, proposal_seed=1)
        (pa, _), (_, b) = ACCOUNTS[0], ACCOUNTS[1]
        txs = [signed(p, pa, b, 1, n) for n in range(6)]
        for t in txs:
            pool.add(t)
        first = prod.get_transactions_to_propose()
        prod.pipeline_overlay_push(1, first, CHAIN)
        second = prod.get_transactions_to_propose()
        prod.pipeline_overlay_clear()
        again = prod.get_transactions_to_propose()
        assert [t.tx.nonce for t in first] == [0, 1, 2, 3]
        assert [t.tx.nonce for t in second] == [4, 5]
        assert again == first
        got.append([t.encode() for t in first + second])
    assert got[0] == got[1]


# -- lanes (tests/test_parallel_exec.py:168-423) ----------------------------------------


def _lane_chain(p):
    """Every account funded and a counter deployed, committed at height 0."""
    kv = p.kv.MemoryKV()
    state = p.state.StateManager(kv)
    snap = state.new_snapshot()
    for _, addr in ACCOUNTS:
        p.execution.set_balance(snap, addr, 10**18)
    status, caddr = p.vm.deploy_code(snap, ACCOUNTS[0][1], 0, counter_contract(p))
    assert status == 1
    roots = snap.freeze()
    state.commit(0, roots)
    return state, p.system_contracts.make_executer(CHAIN), roots, caddr


def random_specs(rng, caddr, lo=24, hi=40):
    """The JAX package's random block: transfers, bad nonces, native token
    calls and calls of one counter (the engineered conflict)."""
    sc = PORT.system_contracts
    ids = rng.sample(range(len(ACCOUNTS)), rng.randint(1, 4))
    nonces = {i: 0 for i in ids}
    specs = []
    for _ in range(rng.randint(lo, hi)):
        si = rng.choice(ids)
        priv = ACCOUNTS[si][0]
        kind = rng.random()
        to = ACCOUNTS[rng.randrange(len(ACCOUNTS))][1]
        if kind < 0.5:
            specs.append((priv, to, rng.randint(1, 1000), nonces[si], {}))
        elif kind < 0.65:
            specs.append((priv, ACCOUNTS[0][1], 1, nonces[si] + 7, {}))
            continue
        elif kind < 0.82:
            specs.append((priv, sc.NATIVE_TOKEN_ADDRESS, 0, nonces[si],
                          dict(invocation=sc.SEL_TRANSFER + to + write_u256(rng.randint(1, 100)))))
        else:
            specs.append((priv, caddr, 0, nonces[si],
                          dict(gas_limit=10**9, invocation=PORT.abi.method_selector("inc()"))))
        nonces[si] += 1
    rng.shuffle(specs)
    return specs


def ordered_txs(p, specs):
    txs = [signed(p, *s[:4], **s[4]) for s in specs]
    warm(txs)
    return p.block_manager.BlockManager.order_transactions(txs, CHAIN)


def run_serial(p, ordered):
    state, executer, base, _ = _lane_chain(p)
    snap = state.new_snapshot(base)
    receipts = [executer.execute(snap, stx, 1, i).receipt.encode()
                for i, stx in enumerate(ordered)]
    roots = snap.freeze()
    return receipts, roots.encode(), {k for k, _ in state.trie.peek_pending()}


def run_lanes(p, ordered, n_lanes, partition=None):
    state, executer, base, _ = _lane_chain(p)
    kw = dict(device="cpu") if p is PORT else {}
    merged, receipts, stats = p.parallel_exec.execute_block_parallel(
        executer, state, ordered, 1, base, n_lanes, partition=partition, **kw)
    roots = merged.freeze()
    return ([r.encode() for r in receipts], roots.encode(),
            {k for k, _ in state.trie.peek_pending()}, stats)


@pytest.mark.parametrize("seeds", [range(0, 8), range(8, 16)], ids=["a", "b"])
def test_lanes_equal_serial_and_jax(seeds):
    validated = stragglers = 0
    caddr = _lane_chain(PORT)[3]
    for seed in seeds:
        rng = random.Random(seed)
        specs = random_specs(rng, caddr)
        serial = run_serial(JAX, ordered_txs(JAX, specs))
        assert run_serial(PORT, ordered_txs(PORT, specs)) == serial
        partition = (lambda i, stx: i) if seed % 3 == 0 else None
        lanes = rng.randint(2, 4)
        got = run_lanes(PORT, ordered_txs(PORT, specs), lanes, partition)
        assert got[:3] == serial, seed
        jgot = run_lanes(JAX, ordered_txs(JAX, specs), lanes, partition)
        assert (got[3].validated, got[3].stragglers) == (jgot[3].validated, jgot[3].stragglers)
        validated += got[3].validated
        stragglers += got[3].stragglers
    assert validated > 0 and stragglers > 0


def test_forced_full_conflict_degrades_to_one_serial_pass():
    priv, to = ACCOUNTS[1][0], ACCOUNTS[2][1]
    ordered = ordered_txs(PORT, [(priv, to, 10 + i, i, {}) for i in range(40)])
    serial = run_serial(PORT, ordered)
    got = run_lanes(PORT, ordered, 4, partition=lambda i, stx: i)
    assert got[:3] == serial
    assert got[3].validated == 1 and got[3].stragglers == len(ordered) - 1


def test_block_manager_lanes_bit_identical():
    """lanes=4 through emulate: the parallel path runs (the memo cleared
    between runs) and gives the serial result and the JAX package's."""
    n = PORT.parallel_exec.MIN_PARALLEL_TXS + 8
    (pa, a), (pb, b) = ACCOUNTS[1], ACCOUNTS[2]
    specs = [(pa, b, 5, i, {}) for i in range(n // 2)] + [
        (pb, a, 7, i, {}) for i in range(n - n // 2)]
    results = {}
    for p in PKGS:
        for lanes in (1, 4):
            state, executer, _, _ = _lane_chain(p)
            bm = block_manager(p, state._kv, state, executer, lanes=lanes)
            p.block_manager._EMULATE_MEMO.clear()
            em = bm.emulate(ordered_txs(p, specs), 1)
            if p is PORT:
                assert (bm.last_parallel_stats is not None) == (lanes > 1)
            results[(p.name, lanes)] = (em.state_hash, em.roots.encode(),
                                        [r.encode() for r in em.receipts], em.event_addrs)
    assert len(set(map(repr, results.values()))) == 1


def test_emulate_memo_returns_the_first_result():
    state, executer, _, _ = _lane_chain(PORT)
    bm = block_manager(PORT, state._kv, state, executer)
    txs = ordered_txs(PORT, [(ACCOUNTS[1][0], ACCOUNTS[2][1], 5, 0, {})])
    first = bm.emulate(txs, 1)
    assert bm.emulate(list(txs), 1) is first
    PORT.block_manager._EMULATE_MEMO.clear()
    again = bm.emulate(txs, 1)
    assert again is not first and again.state_hash == first.state_hash


def test_plan_lanes():
    pe = PORT.parallel_exec
    priv = ACCOUNTS[1][0]
    one = ordered_txs(PORT, [(priv, ACCOUNTS[2][1], 1, i, {}) for i in range(10)])
    populated = [lane for lane in pe.plan_lanes(one, CHAIN, 4) if lane]
    assert len(populated) == 1 and [i for i, _ in populated[0]] == list(range(10))
    (pa, _), (pb, _), (pc, _) = ACCOUNTS[1], ACCOUNTS[2], ACCOUNTS[3]
    x, y = ACCOUNTS[4][1], ACCOUNTS[5][1]
    chain = [signed(PORT, pa, x, 1, 0), signed(PORT, pb, x, 1, 0), signed(PORT, pb, y, 1, 1),
             signed(PORT, pc, y, 1, 0)]
    assert len([lane for lane in pe.plan_lanes(chain, CHAIN, 4) if lane]) == 1
    apart = [signed(PORT, pa, x, 1, 0), signed(PORT, pc, y, 1, 0)]
    assert all(len(lane) == 1 for lane in pe.plan_lanes(apart, CHAIN, 2))
    caddr = _lane_chain(PORT)[3]
    specs = random_specs(random.Random(42), caddr)
    for p in PKGS:
        ordered = ordered_txs(p, specs)
        lanes = p.parallel_exec.plan_lanes(ordered, CHAIN, 3)
        assert lanes == p.parallel_exec.plan_lanes(ordered, CHAIN, 3)
        assert sorted(i for lane in lanes for i, _ in lane) == list(range(len(ordered)))
    assert ([[i for i, _ in lane] for lane in pe.plan_lanes(ordered_txs(PORT, specs), CHAIN, 3)]
            == [[i for i, _ in lane]
                for lane in JAX.parallel_exec.plan_lanes(ordered_txs(JAX, specs), CHAIN, 3)])
    assert pe.resolve_lanes(1) == 1 and pe.resolve_lanes(3) == 3 and pe.resolve_lanes(0) >= 1


def _recording_snap():
    state, _, base, _ = _lane_chain(PORT)
    return PORT.parallel_exec.RecordingSnapshot(state.trie.fork(), base)


def test_recording_snapshot():
    snap = _recording_snap()
    a = ACCOUNTS[1][1]
    snap.begin_tx()
    bal = PORT.execution.get_balance(snap, a)
    PORT.execution.set_balance(snap, a, bal - 1)
    PORT.execution.get_balance(snap, a)
    reads, delta = snap.end_tx()
    assert list(reads) == [("balances", b"b:" + a)]
    assert [(t, k) for t, k, _ in delta] == [("balances", b"b:" + a)]
    snap.begin_tx()
    cp = snap.checkpoint()
    snap.put("storage", b"k1", b"v1")
    snap.put("storage", b"k1", b"v2")
    snap.restore(cp)
    assert snap.end_tx()[1] == []
    snap.begin_tx()
    assert snap.get("storage", b"k1") is None
    assert ("storage", b"k1") in snap.end_tx()[0]
    snap.begin_tx()
    snap.put("storage", b"k", b"keep")
    cp = snap.checkpoint()
    snap.put("storage", b"k", b"drop")
    snap.restore(cp)
    assert snap.end_tx()[1] == [("storage", b"k", b"keep")]


def test_checkpoint_restore_against_a_model():
    state, _, base, _ = _lane_chain(PORT)
    rng = random.Random(7)
    for _round in range(10):
        snap = state.new_snapshot(base)
        model = {t: {} for t in snap._writes}
        stack = []
        for _ in range(300):
            op = rng.random()
            t = rng.choice(("balances", "storage", "events"))
            k = bytes([rng.randrange(8)])
            if op < 0.55:
                v = bytes([rng.randrange(256)])
                snap.put(t, k, v)
                model[t][k] = v
            elif op < 0.70:
                snap.delete(t, k)
                model[t][k] = None
            elif op < 0.85:
                stack.append((snap.checkpoint(), copy.deepcopy(model)))
            elif stack:
                cp, model = stack.pop()
                snap.restore(cp)
        assert snap._writes == model


def test_order_transactions_total():
    caddr = _lane_chain(PORT)[3]
    specs = random_specs(random.Random(11), caddr)
    txs = [signed(PORT, *s[:4], **s[4]) for s in specs]
    bad = PORT.types.SignedTransaction(
        tx=PORT.types.Transaction(to=caddr, value=1, nonce=0, gas_price=1, gas_limit=100000),
        signature=b"\x00" * 65)
    assert bad.sender(CHAIN) is None
    txs.append(bad)
    order = PORT.block_manager.BlockManager.order_transactions
    baseline = order(txs, CHAIN)
    for seed in range(5):
        shuffled = list(txs)
        random.Random(seed).shuffle(shuffled)
        assert order(shuffled, CHAIN) == baseline
    assert baseline[-1] is bad
    jtxs = [JAX.types.SignedTransaction.decode(t.encode()) for t in txs]
    assert [t.encode() for t in JAX.block_manager.BlockManager.order_transactions(
        jtxs, CHAIN)] == [t.encode() for t in baseline]
