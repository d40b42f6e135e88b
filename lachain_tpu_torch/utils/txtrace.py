"""Per-transaction lifecycle stage clock.

The port of `lachain_tpu/utils/txtrace.py`, the same module. Where does a
transaction's latency go, from submit to commit? It pins the six
lifecycle stages of ONE transaction to monotonic stamps:

    submit   the node's ingress accepted the tx
    pool     pool admission succeeded (core/tx_pool.TransactionPool.add)
    propose  the tx rode a local proposal (core/block_producer)
    decide   consensus agreed on a tx set containing it (the RootProtocol
             era tail, consensus/root_protocol.py)
    exec     block execution reached the tx's block (core/block_manager)
    commit   the block holding the tx persisted (BlockManager._persist)

  * Deterministic sampling by tx-hash prefix: every node samples the SAME
    transactions. shift=s keeps 1/2^s of txs (0 = all).
  * Bounded memory: stamps live in a locked LRU of TRACE_LRU_CAPACITY
    entries.
  * First stamp wins: re-admission, proposal overlap between validators
    and replayed eras re-visit stages; the timeline keeps the FIRST.
  * Stage sum == e2e by construction: `tx_stage_seconds{stage=S}` observes
    the delta from the PREVIOUS recorded stamp, so a tx's stage
    observations sum exactly to its commit-minus-first span
    (`tx_e2e_seconds`).

Every stamp also emits `tracing.instant("tx.<stage>", cat="tx",
trace=<8-byte hash prefix hex>)`, the same on every node.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from . import metrics, tracing

# lifecycle order; timeline() reports stages in this order and the stage
# histogram's label set is bounded by it
STAGES = ("submit", "pool", "propose", "decide", "exec", "commit")
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}

# sampled timelines kept in memory (LRU, oldest evicted)
TRACE_LRU_CAPACITY = 4096

# default: sample 1/16 of txs (set_sample_shift overrides)
DEFAULT_SAMPLE_SHIFT = 4

_lock = threading.Lock()
# tx hash -> {"stages": {stage: monotonic_s}, "era": int|None}
_timelines: "OrderedDict[bytes, dict]" = OrderedDict()
_sample_shift = [DEFAULT_SAMPLE_SHIFT]

# sub-ms pool hops up to multi-minute stalls
_STAGE_BUCKETS = (
    0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0,
)
_E2E_BUCKETS = (
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def set_sample_shift(shift: int) -> None:
    """Keep 1/2^shift of txs (0 = every tx). Deterministic across nodes:
    the decision reads the tx hash, so every validator samples the same
    set regardless of local configuration ORDER — but the SHIFT itself
    must match fleet-wide for cross-node timelines to align."""
    _sample_shift[0] = max(int(shift), 0)


def sample_shift() -> int:
    return _sample_shift[0]


def sampled(tx_hash: bytes) -> bool:
    """Deterministic hash-prefix sampling: same tx → same verdict on every
    node. keccak output is uniform, so the low bits of the first word are
    an unbiased 1/2^shift coin."""
    shift = _sample_shift[0]
    if shift <= 0:
        return True
    mask = (1 << shift) - 1
    return int.from_bytes(tx_hash[:4], "big") & mask == 0


def trace_id(tx_hash: bytes) -> str:
    """The cross-node correlation key for a tx: its hash prefix. Globally
    identical on every node by construction (the hash is the identity)."""
    return tx_hash[:8].hex()


def stamp(tx_hash: bytes, stage: str, era: Optional[int] = None) -> None:
    """Record stage `stage` for `tx_hash` now (first stamp per stage wins).
    No-op for unsampled txs — callers stamp unconditionally and this guard
    keeps the hot path to one int compare for the 15/16 unsampled."""
    if stage not in _STAGE_INDEX or not sampled(tx_hash):
        return
    now = time.monotonic()
    with _lock:
        ent = _timelines.get(tx_hash)
        if ent is None:
            ent = {"stages": {}, "era": None}
            _timelines[tx_hash] = ent
            while len(_timelines) > TRACE_LRU_CAPACITY:
                _timelines.popitem(last=False)
        else:
            _timelines.move_to_end(tx_hash)
        if stage in ent["stages"]:
            return  # first observation wins (re-gossip / era replay)
        ent["stages"][stage] = now
        if era is not None and ent["era"] is None:
            ent["era"] = int(era)
        # delta from the previous recorded stamp: stage observations for
        # one tx sum EXACTLY to its first→commit span (no overlap, no gap)
        prev = max(
            (t for s, t in ent["stages"].items() if s != stage),
            default=None,
        )
        first = min(ent["stages"].values())
    metrics.observe_hist(
        "tx_stage_seconds",
        now - prev if prev is not None else 0.0,
        buckets=_STAGE_BUCKETS,
        labels={"stage": stage},
    )
    if stage == "commit":
        metrics.observe_hist(
            "tx_e2e_seconds", now - first, buckets=_E2E_BUCKETS
        )
    tracing.instant(
        "tx." + stage,
        cat="tx",
        trace=trace_id(tx_hash),
        era=era,
    )


def stamp_many(
    tx_hashes, stage: str, era: Optional[int] = None
) -> None:
    """Batch stamp for block-granularity stages (propose/decide/exec/
    commit visit whole tx sets)."""
    for h in tx_hashes:
        stamp(h, stage, era=era)


def timeline(tx_hash: bytes) -> Optional[dict]:
    """The stamped timeline for a sampled tx, stages in lifecycle order:
    {"hash", "traceId", "era", "stages": [{"stage", "at_s", "dur_s"}...],
    "e2e_s"}. `at_s` is seconds since the FIRST stamp; `dur_s` is the
    delta from the previous stage (sums to e2e_s). None when the tx was
    never stamped (unsampled, or evicted from the LRU)."""
    with _lock:
        ent = _timelines.get(tx_hash)
        if ent is None:
            return None
        stages = dict(ent["stages"])
        era = ent["era"]
    ordered = sorted(stages.items(), key=lambda kv: (kv[1], _STAGE_INDEX[kv[0]]))
    first = ordered[0][1]
    out = []
    prev = first
    for name, at in ordered:
        out.append(
            {
                "stage": name,
                "at_s": round(at - first, 6),
                "dur_s": round(at - prev, 6),
            }
        )
        prev = at
    return {
        "hash": "0x" + tx_hash.hex(),
        "traceId": trace_id(tx_hash),
        "era": era,
        "stages": out,
        "e2e_s": round(ordered[-1][1] - first, 6),
    }


def tracked() -> List[bytes]:
    """Hashes currently held in the LRU, oldest first."""
    with _lock:
        return list(_timelines.keys())


def reset_for_tests() -> None:
    with _lock:
        _timelines.clear()
    _sample_shift[0] = DEFAULT_SAMPLE_SHIFT
