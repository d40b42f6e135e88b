"""Deterministic storage workload for the crash-point harnesses.

The port of `lachain_tpu/storage/crash_workload.py`: it drives every
instrumented commit path (crashpoints.py's list) over a real on-disk
store: pool admission (`pool.save.mid`), block persistence
(`block.persist.*` riding `kv.write_batch.*`), and a shrink pass
(`shrink.*`). The workload is deterministic (fixed key seeds, fixed
transaction schedule) and resumes from the committed tip of a database a
previous run died in, so a crash plan repeats into the identical store;
under one plan the port's store equals the JAX package's, row for row.

Used two ways:

  * in-process: tests arm a CrashPlan (mode "raise") around run_workload()
    and catch InjectedCrash where a real process would have died;
  * child process: ``python -m lachain_tpu_torch.storage.crash_workload DB
    ENGINE [stream|BLOCKS]`` with ``LACHAIN_CRASH_POINTS`` set (mode
    "sigkill"): the process really dies at the point, leaving the torn
    state on disk for fsck.

Senders are recovered on the host (`device="cpu"` for the block manager):
the crash harnesses run where there is no card.
"""
from __future__ import annotations

import json
import random
import sys

DEFAULT_CHAIN_ID = 225
DEFAULT_BLOCKS = 6
SHRINK_RETAIN = 2


class _Rng:
    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def open_kv(db_path: str, engine: str = "sqlite"):
    if engine == "lsm":
        from .lsm import LsmKV

        return LsmKV(db_path)
    from .kv import SqliteKV

    return SqliteKV(db_path)


def run_workload(
    kv,
    blocks: int = DEFAULT_BLOCKS,
    chain_id: int = DEFAULT_CHAIN_ID,
    shrink: bool = True,
) -> dict:
    """Build (or extend) a chain of `blocks` blocks with one transfer each,
    then run a shrink pass. Returns {height, pooled, shrink} stats."""
    from ..core import execution
    from ..core.block_manager import BlockManager
    from ..core.tx_pool import TransactionPool
    from ..core.types import (
        BlockHeader,
        MultiSig,
        Transaction,
        sign_transaction,
        tx_merkle_root,
    )
    from ..crypto import ecdsa
    from .shrink import DbShrink
    from .state import StateManager

    priv = ecdsa.generate_private_key(_Rng(7))
    sender = ecdsa.address_from_public_key(ecdsa.public_key_bytes(priv))
    recipient = b"\x42" * 20

    state = StateManager(kv)
    bm = BlockManager(
        kv, state, execution.TransactionExecuter(chain_id), device="cpu"
    )
    bm.build_genesis({sender: 10**18}, chain_id)
    pool = TransactionPool(
        kv,
        chain_id,
        account_nonce=lambda a: execution.get_nonce(state.new_snapshot(), a),
    )
    pool.restore()

    start = bm.current_height() + 1
    for height in range(start, blocks + 1):
        stx = sign_transaction(
            Transaction(
                to=recipient,
                value=height,
                nonce=height - 1,
                gas_price=1,
                gas_limit=100_000,
            ),
            priv,
            chain_id,
        )
        pool.add(stx)
        txs = [stx]
        em = bm.emulate(txs, height)
        prev = bm.block_by_height(height - 1)
        header = BlockHeader(
            index=height,
            prev_block_hash=prev.hash(),
            merkle_root=tx_merkle_root([t.hash() for t in txs]),
            state_hash=em.state_hash,
            nonce=0,
        )
        bm.execute_block(header, txs, MultiSig(()))

    shrink_stats = None
    if shrink:
        shrink_stats = DbShrink(state, kv).shrink(SHRINK_RETAIN)
    return {
        "height": bm.current_height(),
        "pooled": len(pool),
        "shrink": shrink_stats,
    }


STREAM_BLOCKS = 2
STREAM_TXS = 120


def run_stream_workload(
    kv, blocks: int = STREAM_BLOCKS, chain_id: int = DEFAULT_CHAIN_ID
) -> dict:
    """Streamed-commit variant for the trie.merkle.subtree_streamed crash
    window: many-tx blocks over a LOWERED stream threshold, so every block
    commit ships its trie nodes as multiple async WAL batches before the
    root record (the fsync-overlap path). Deterministic and
    resume-friendly like run_workload; kept separate so its extra batch
    traffic never shifts the classic matrix's traversal counts."""
    from ..core import execution
    from ..core.block_manager import BlockManager
    from ..core.types import (
        BlockHeader,
        MultiSig,
        Transaction,
        sign_transaction,
        tx_merkle_root,
    )
    from ..crypto import ecdsa
    from .state import StateManager

    priv = ecdsa.generate_private_key(_Rng(7))
    sender = ecdsa.address_from_public_key(ecdsa.public_key_bytes(priv))

    state = StateManager(kv)
    state.stream_threshold = 64
    state._STREAM_BATCH = 100
    state.trie.merkle_workers = 4
    bm = BlockManager(
        kv, state, execution.TransactionExecuter(chain_id), device="cpu"
    )
    bm.build_genesis({sender: 10**18}, chain_id)

    start = bm.current_height() + 1
    for height in range(start, blocks + 1):
        txs = [
            sign_transaction(
                Transaction(
                    to=b"\x37" * 12 + i.to_bytes(8, "big"),
                    value=height,
                    nonce=(height - 1) * STREAM_TXS + i,
                    gas_price=1,
                    gas_limit=100_000,
                ),
                priv,
                chain_id,
            )
            for i in range(STREAM_TXS)
        ]
        em = bm.emulate(txs, height)
        prev = bm.block_by_height(height - 1)
        header = BlockHeader(
            index=height,
            prev_block_hash=prev.hash(),
            merkle_root=tx_merkle_root([t.hash() for t in txs]),
            state_hash=em.state_hash,
            nonce=0,
        )
        bm.execute_block(header, txs, MultiSig(()))
    return {
        "height": bm.current_height(),
        "root": state.committed.state_hash().hex(),
        "streamed": state.commit_stats.get("streamed_batches", 0),
    }


def main(argv) -> int:
    """Subprocess entry: arm from LACHAIN_CRASH_POINTS, run, print stats.
    A sigkill plan never reaches the print — the parent observes -SIGKILL
    and inspects the torn database. `DB ENGINE stream` runs the streamed-
    commit workload instead of the classic matrix one."""
    from . import crashpoints

    db_path = argv[0]
    engine = argv[1] if len(argv) > 1 else "sqlite"
    stream = len(argv) > 2 and argv[2] == "stream"
    blocks = (
        int(argv[2]) if len(argv) > 2 and not stream else DEFAULT_BLOCKS
    )
    crashpoints.arm_from_env()
    kv = open_kv(db_path, engine)
    try:
        if stream:
            stats = run_stream_workload(kv)
        else:
            stats = run_workload(kv, blocks=blocks)
    finally:
        kv.close()
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
