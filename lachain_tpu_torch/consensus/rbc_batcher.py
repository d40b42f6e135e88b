"""Era-scoped ReliableBroadcast flush batcher on the card.

The port of `lachain_tpu/consensus/rbc_batcher.py`. Every pending sender
encode and every pending interpolate/re-encode/Merkle-recheck of an era
flushes as batched matrix products in `ops/rs_batch.py`: one launch for
the encodes, one for the decodes of every erasure pattern, one for the
re-encodes (per field), then one `keccak256_batch` over every re-encoded
shard and the Merkle roots level by level.

Cross-validator dedupe, as in the reference: a Merkle root pins all n
committed shards, so the post-recheck verdict is a function of (root, k,
n). The batcher memoizes it per era and fans it out; memos of eras older
than era - 2 are dropped at the next flush.

Nothing falls back: where the reference replays the scalar sequence after
any batch-path failure (rbc_batcher.py:179-181, :215-221), a failure here
raises out of `flush`. The reference's metrics and spans are kept under its
names: an `rbc.flush` span an era's flush (the era report's `rbc` phase;
the RS products inside it are `rs.device` spans, ops/rs_batch.py, the
`rbc_device` phase), `rbc_flush_total`, `rbc_flush_memo_hits_total`,
`rbc_flush_deduped_total`, the histogram `rbc_batch_size` and the gauge
`rbc_batcher_queue_depth`; the plain counters `memo_hits`, `deduped`,
`items` stay beside them for chip_smoke.py. `scalar_verdict` is the host
oracle that the tests and `chip_smoke.py` hold the batcher to.

Callback contract: `cb(payload_or_None)` for interpolations (None = bad
root), `cb(shards_list)` for encodes; encodes first, then the
interpolations in submission order. Callbacks run inside flush and may
enqueue further protocol traffic.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from ..crypto import hashes
from ..ops import rs, rs_batch
from ..parallel import mesh_by_default
from ..parallel.mesh import cards_from, make_mesh
from ..utils import metrics, tracing

PHASES = ("inverse_s", "pack_s", "device_s", "fetch_s", "recheck_s")
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def scalar_verdict(shards, k: int, root: bytes) -> Optional[bytes]:
    """The inline interpolation sequence: reconstruct, re-encode, recheck
    the Merkle commitment. Returns the payload, or None for any failure
    (the caller marks the root bad). Its leaves are hashed in one
    keccak256_batch call, the values of the reference's per-leaf keccak256."""
    reencoded = rs.reencode(shards, k)
    if reencoded is None:
        return None
    if hashes.merkle_root(hashes.keccak256_batch(reencoded)) != root:
        return None
    return rs.decode(shards, k)


class RbcEraBatcher:
    """Collects pending RBC encodes/interpolations; flush() runs each era's
    backlog through batched RS matrix products on `device` ("cuda" by
    default; no card raises) and fans results out. `mesh`, a 1-D mesh
    (parallel/mesh.make_mesh), cuts every product's columns into a block a
    device in place of `device`; on the card with none given, one over
    every visible card where there are two or more (`mesh_by_default`).
    `last_timings` holds the phases of the last flush in seconds (`PHASES`
    and `wall_s`)."""

    def __init__(self, device="cuda", mesh=None):
        dev = rs_batch.resolve(device)
        if mesh is None and dev is not None and dev.type == "cuda" and mesh_by_default(
                torch.cuda.device_count()):
            mesh = make_mesh(cards_from(dev))
        self.device = device
        self.mesh = mesh
        # era -> [(value, k, n, cb)]
        self._enc: Dict[int, List[tuple]] = {}
        # era -> [(key, shards, k, root, cb)]; key = (root, k, n)
        self._interp: Dict[int, List[tuple]] = {}
        # era -> {key: verdict}; the post-Merkle-recheck payload (or None)
        self._memo: Dict[int, Dict[tuple, Optional[bytes]]] = {}
        self.flushes = 0
        self.items = 0  # encodes and interpolations flushed
        self.memo_hits = 0
        self.deduped = 0
        self.last_timings: dict = {}

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._enc.values()) + sum(
            len(v) for v in self._interp.values()
        )

    def pending_for(self, era: Optional[int]) -> int:
        if era is None:
            return self.pending
        return len(self._enc.get(era, ())) + len(self._interp.get(era, ()))

    def submit_encode(
        self, era: int, value: bytes, k: int, n: int, cb: Callable
    ) -> None:
        """Queue a sender-side encode; `cb(shards)` at the next flush."""
        self._enc.setdefault(era, []).append((value, k, n, cb))
        metrics.set_gauge("rbc_batcher_queue_depth", self.pending)

    def submit_interpolate(
        self,
        era: int,
        shards,
        k: int,
        n: int,
        root: bytes,
        cb: Callable,
    ) -> None:
        """Queue an interpolate+recheck; `cb(payload_or_None)` either
        immediately (verdict already memoized this era — the cross-validator
        dedupe) or at the next flush."""
        key = (root, k, n)
        memo = self._memo.get(era)
        if memo is not None and key in memo:
            self.memo_hits += 1
            metrics.inc("rbc_flush_memo_hits_total")
            cb(memo[key])
            return
        self._interp.setdefault(era, []).append((key, shards, k, root, cb))
        metrics.set_gauge("rbc_batcher_queue_depth", self.pending)

    def flush(self, era: Optional[int] = None) -> int:
        """Flush one era's submissions (None = every era with a backlog).
        Returns the number of submissions completed."""
        if era is None:
            eras = sorted(set(self._enc) | set(self._interp))
        else:
            eras = [era] if self.pending_for(era) else []
        done = 0
        for e in eras:
            done += self._flush_era(e)
        if done:
            metrics.set_gauge("rbc_batcher_queue_depth", self.pending)
        return done

    def _flush_era(self, era: int) -> int:
        encs = self._enc.pop(era, [])
        interps = self._interp.pop(era, [])
        if not encs and not interps:
            return 0
        t0 = time.perf_counter()
        timings = dict.fromkeys(PHASES, 0.0)
        memo = self._memo.setdefault(era, {})
        # drop verdicts for settled eras so a long devnet run stays bounded
        for stale in [e for e in self._memo if e < era - 2]:
            del self._memo[stale]
        # dedupe interpolations: first submission per key computes, the
        # rest ride the memo fan-out
        uniq: Dict[tuple, tuple] = {}
        waiters: Dict[tuple, List[Callable]] = {}
        order: List[tuple] = []
        for key, shards, k, root, cb in interps:
            if key not in uniq:
                uniq[key] = (shards, k, root)
                order.append(key)
            waiters.setdefault(key, []).append(cb)
        deduped = len(interps) - len(uniq)
        if deduped:
            metrics.inc("rbc_flush_deduped_total", deduped)
        self.deduped += deduped
        self.items += len(encs) + len(interps)
        with tracing.span(
            "rbc.flush",
            era=era,
            encodes=len(encs),
            interpolates=len(uniq),
            interpolates_submitted=len(interps),
        ):
            enc_out = self._run_encodes(era, encs, timings)
            verdicts = self._run_interps(era, uniq, order, timings)
        metrics.inc("rbc_flush_total")
        metrics.observe_hist(  # lint-allow: metric-name dimensionless batch-size distribution
            "rbc_batch_size", len(encs) + len(uniq), buckets=_BATCH_BUCKETS
        )
        self.flushes += 1
        self.last_timings = dict(timings, wall_s=time.perf_counter() - t0)
        for (_v, _k, _n, cb), shards in zip(encs, enc_out):
            cb(shards)
        for key in order:
            memo[key] = verdicts[key]
            for cb in waiters[key]:
                cb(verdicts[key])
        return len(encs) + len(interps)

    def _run_encodes(self, era: int, encs: List[tuple],
                     timings: dict) -> List[List[bytes]]:
        if not encs:
            return []
        return rs_batch.encode_batch(
            [(v, k, n) for (v, k, n, _cb) in encs], device=self.device,
            timings=timings, mesh=self.mesh, era=era)

    def _run_interps(
        self, era: int, uniq: Dict[tuple, tuple], order: List[tuple], timings: dict
    ) -> Dict[tuple, Optional[bytes]]:
        verdicts: Dict[tuple, Optional[bytes]] = {}
        if not order:
            return verdicts
        payloads = rs_batch.decode_batch(
            [(uniq[key][0], uniq[key][1]) for key in order],
            device=self.device, timings=timings, mesh=self.mesh, era=era)
        # re-encode the successful reconstructions in one batch, then
        # recheck every Merkle commitment with ONE fused keccak call
        payload_of = dict(zip(order, payloads))
        ok_keys = [key for key, p in zip(order, payloads) if p is not None]
        reenc = rs_batch.encode_batch(
            [(payload_of[key], key[1], key[2]) for key in ok_keys],
            device=self.device, timings=timings, mesh=self.mesh, era=era)
        t = time.perf_counter()
        flat_leaves = hashes.keccak256_batch([s for shards in reenc for s in shards])
        trees, off = [], 0
        for shards in reenc:
            trees.append(flat_leaves[off : off + len(shards)])
            off += len(shards)
        roots = dict(zip(ok_keys, hashes.merkle_roots(trees)))
        for key, payload in zip(order, payloads):
            verdicts[key] = (
                payload if payload is not None and roots[key] == key[0] else None
            )
        timings["recheck_s"] += time.perf_counter() - t
        return verdicts
