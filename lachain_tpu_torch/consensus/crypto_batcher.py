"""Router-level TPKE crypto flush batcher on the card.

The port of `lachain_tpu/consensus/crypto_batcher.py`. HoneyBadger's
verify+combine work is batched per validator at its era tick; where N
validators run in one process, each submits its pending EraSlotJobs here
and the delivery loop flushes the batcher when the network goes quiet:
one `GpuBackend.tpke_era_verify_combine` era covers every validator's every
ready slot (one grand multi-pairing on the host, one era's kernels on the
card per chunk).

As in the reference:
  * every validator submits the same job for a slot; jobs are deduped by
    content (`_job_fingerprint`) against the same key-set object, each
    distinct job runs once and its result fans out to every submitter, in
    submission order;
  * `flush(era)` takes one era's submissions (untagged ones always join);
  * a flush is cut into chunks of at most `max_slots_per_call` slots that
    never straddle two key sets;
  * with `depth` 2 the chunks run two-phase: chunk e+1 is dispatched before
    chunk e is finished, so that chunk e+1's host pack overlaps chunk e's
    kernels and chunk e's finish (download, grand check) overlaps chunk
    e+1's kernels (GpuEraPipeline.dispatch_era). One host thread packs and
    checks, so only the card's time can be hidden;
  * callbacks run inside flush; a callback that submits again joins the
    next flush.

Differences, by the port's rules: the backend and the random generator are
passed in (the reference reads `get_backend()` and draws from `secrets`);
a failed flush raises out of `flush`, after finishing the chunks still in
flight so that the pipeline's staging is free for the next flush, and the
submissions it took are dropped (the reference hands every callback None
and lets each submitter fall back to its host path). The reference's
metrics and spans are kept under its names: the whole flush is a
`tracing.wait("crypto_flush")`, the era calls a `tpke.flush` span (cat
"crypto": `slots`, `slots_submitted`, `slots_padded`, `pad_waste`), the
histograms `tpke_flush_slots` and `tpke_flush_pad_waste`, the counter
`tpke_flush_deduped_slots_total` and the gauge `tpke_batcher_queue_depth`;
`last_timings` holds the phases of the last flush, and `deduped_slots` and
`chunks` count beside them what chip_smoke.py and the tests read.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ..utils import metrics, tracing

logger = logging.getLogger(__name__)

# per-flush slot counts are small powers of two in practice; the buckets
# track the padded slot shapes the era's kernels run
_SLOT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_WASTE_BUCKETS = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5)


def _pow2_at_least(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _job_fingerprint(job) -> Optional[tuple]:
    """Content key of an EraSlotJob: verify+combine is a pure function of
    (shares, lagrange row, H(U,V), W), so two jobs with equal fingerprints
    (against the same key set) have equal results. Returns None for job
    shapes the batcher doesn't recognize — those never dedupe."""
    try:
        return (
            tuple(job.u_by_validator),
            tuple(job.lagrange_row),
            job.h,
            job.w,
        )
    except (AttributeError, TypeError):
        return None


class TpkeEraBatcher:
    """Collects (jobs, callback) submissions; flush() runs them through
    `backend` (a GpuBackend) in eras of at most `max_slots_per_call` slots,
    with `rng` drawing every era's RLC coefficients. `depth` eras may be in
    flight at once: by default the backend's `era_dispatch_depth`; 1 runs
    each chunk to its end before the next.

    `last_timings` holds the last flush's phases in seconds: `build_s` (the
    lazy builders), `dedupe_s`, `era_s` (every chunk's dispatch and
    finish), `callbacks_s`, `wall_s`, and `chunks`, each chunk's
    GpuBackend.last_timings (pack_s, launch_s, device_s, wait_s, fetch_s,
    pairing_s)."""

    def __init__(self, backend, rng, max_slots_per_call: int = 512,
                 depth: Optional[int] = None):
        most = backend.era_dispatch_depth
        if depth is None:
            depth = most
        if not 1 <= depth <= most:
            raise ValueError(f"depth must lie in [1, {most}], got {depth}")
        if max_slots_per_call < 1:
            raise ValueError("max_slots_per_call must be at least 1")
        self.backend = backend
        self.rng = rng
        self.max_slots_per_call = max_slots_per_call
        self.depth = depth
        # submissions carry an era tag (None = untagged): a lazy builder
        # posts into ITS era's engine, so flushes are era-selective
        self._pending: List[Tuple[Sequence, Sequence, Callable, Optional[int]]] = []
        self._lazy: List[Tuple[Callable, Optional[int]]] = []
        self.flushes = 0
        self.slots_flushed = 0
        self.deduped_slots = 0
        self.chunks = 0
        self.last_timings: dict = {}

    @property
    def pending(self) -> int:
        return len(self._pending) + len(self._lazy)

    def pending_for(self, era: Optional[int]) -> int:
        """Pending submissions a flush(era) would cover (None counts all)."""
        if era is None:
            return self.pending
        return sum(
            1 for (_j, _v, _c, e) in self._pending if e is None or e == era
        ) + sum(1 for (_b, e) in self._lazy if e is None or e == era)

    def submit(
        self, jobs: Sequence, verification_keys, callback, era: Optional[int] = None
    ) -> None:
        """Queue `jobs` for the next flush; `callback(results)` receives the
        per-job (ok, combined) list, in submission order."""
        if jobs:
            self._pending.append((jobs, verification_keys, callback, era))
            metrics.set_gauge("tpke_batcher_queue_depth", self.pending)

    def submit_lazy(self, build, era: Optional[int] = None) -> None:
        """Queue a job BUILDER resolved at flush time: `build()` returns
        (jobs, verification_keys, callback) or None, so that a protocol
        prepares its slots once per flush, covering everything that became
        ready in the meantime."""
        self._lazy.append((build, era))
        metrics.set_gauge("tpke_batcher_queue_depth", self.pending)

    def flush(self, era: Optional[int] = None) -> int:
        """Run pending jobs through the backend's era calls; returns the
        number of submissions completed. `era` selects one era's
        submissions (untagged ones always join); None flushes everything.
        Callbacks run inside flush and may re-submit (their work joins the
        NEXT flush). A failure raises; the submissions taken are dropped."""
        if not self._pending and not self._lazy:
            return 0
        # for the delivery loop the whole flush (job build, era calls,
        # callbacks) is one stall on the crypto: the era report's
        # crypto_flush wait. Protocol spans its callbacks open outrank it
        # in the report's sweep, so no time counts twice
        with tracing.wait("crypto_flush", pending=self.pending):
            return self._flush(era)

    def _flush(self, era: Optional[int]) -> int:
        t0 = time.perf_counter()
        if era is None:
            taken, self._pending = self._pending, []
            lazy_taken, self._lazy = self._lazy, []
        else:
            taken, keep = [], []
            for s in self._pending:
                (taken if s[3] is None or s[3] == era else keep).append(s)
            self._pending = keep
            lazy_taken, lazy_keep = [], []
            for s in self._lazy:
                (lazy_taken if s[1] is None or s[1] == era else lazy_keep).append(s)
            self._lazy = lazy_keep
        batch = [(jobs, vks, cb) for (jobs, vks, cb, _e) in taken]
        for build, _e in lazy_taken:
            item = build()
            if item is not None:
                batch.append(item)
        if not batch:
            return 0
        t1 = time.perf_counter()
        # shares MUST verify against their own keys: jobs dedupe per
        # key-set identity, and a chunk never straddles two key sets
        flat_jobs: List = []
        owners: List[Tuple[int, int]] = []  # (submission idx, job idx)
        key_of: List = []  # per-flat-job key-set object
        alias: List[int] = []  # per-original-job index into flat_jobs
        seen: dict = {}  # (id(vks), fingerprint) -> flat index
        for si, (jobs, vks, _cb) in enumerate(batch):
            for ji, job in enumerate(jobs):
                owners.append((si, ji))
                fp = _job_fingerprint(job)
                idx = seen.get((id(vks), fp)) if fp is not None else None
                if idx is None:
                    idx = len(flat_jobs)
                    flat_jobs.append(job)
                    key_of.append(vks)
                    if fp is not None:
                        seen[(id(vks), fp)] = idx
                alias.append(idx)
        if len(owners) > len(flat_jobs):
            metrics.inc(
                "tpke_flush_deduped_slots_total", len(owners) - len(flat_jobs)
            )
        t2 = time.perf_counter()
        sid = tracing.begin("tpke.flush", cat="crypto", submissions=len(batch))
        try:
            results, chunk_timings, padded = self._run_chunks(flat_jobs, key_of)
        except BaseException:
            tracing.end(sid, outcome="exception")
            raise
        t3 = time.perf_counter()
        # each chunk's slot axis is padded to a power of two: the share of
        # padded lanes burnt on dummy slots tunes max_slots_per_call
        waste = 1.0 - len(flat_jobs) / padded if padded else 0.0
        tracing.end(
            sid,
            slots=len(flat_jobs),
            slots_submitted=len(owners),
            slots_padded=padded,
            pad_waste=round(waste, 4),
        )
        metrics.observe_hist(  # lint-allow: metric-name dimensionless slot-count distribution
            "tpke_flush_slots", len(flat_jobs), buckets=_SLOT_BUCKETS
        )
        metrics.observe_hist(  # lint-allow: metric-name dimensionless waste-fraction distribution
            "tpke_flush_pad_waste", waste, buckets=_WASTE_BUCKETS
        )
        self.flushes += 1
        self.slots_flushed += len(flat_jobs)
        self.deduped_slots += len(owners) - len(flat_jobs)
        self.chunks += len(chunk_timings)
        metrics.set_gauge("tpke_batcher_queue_depth", self.pending)
        per_sub: List[List] = [[None] * len(jobs) for (jobs, _vks, _cb) in batch]
        for (si, ji), ai in zip(owners, alias):
            per_sub[si][ji] = results[ai]
        for (_jobs, _vks, cb), res in zip(batch, per_sub):
            cb(res)
        t4 = time.perf_counter()
        self.last_timings = {
            "build_s": t1 - t0, "dedupe_s": t2 - t1, "era_s": t3 - t2,
            "callbacks_s": t4 - t3, "wall_s": t4 - t0, "chunks": chunk_timings,
        }
        return len(batch)

    def _run_chunks(self, flat_jobs, key_of):
        """Every distinct job's (ok, combined), chunk by chunk, with `depth`
        chunks in flight; each chunk's backend timings; and the slots of
        every chunk padded to a power of two, summed."""
        backend = self.backend
        results: List = [None] * len(flat_jobs)
        timings: List[dict] = []
        inflight: List[Tuple[int, Callable]] = []
        padded = 0

        def finish_oldest() -> None:
            off, fin = inflight.pop(0)
            out = fin()
            results[off : off + len(out)] = out
            timings.append(dict(backend.last_timings))

        try:
            off = 0
            while off < len(flat_jobs):
                vks = key_of[off]
                end = off + 1
                while (
                    end < len(flat_jobs)
                    and end - off < self.max_slots_per_call
                    and key_of[end] is vks
                ):
                    end += 1
                padded += _pow2_at_least(end - off)
                inflight.append((off, backend.tpke_era_verify_combine_async(
                    flat_jobs[off:end], vks, self.rng)))
                if len(inflight) >= self.depth:
                    finish_oldest()
                off = end
            while inflight:
                finish_oldest()
        finally:
            # only after a failure: finish what is still in flight, so that
            # the pipeline's staging and in-flight slots are free again
            for _off, fin in inflight:
                try:
                    fin()
                except Exception:
                    logger.exception("an in-flight era chunk failed too")
        return results, timings, padded
