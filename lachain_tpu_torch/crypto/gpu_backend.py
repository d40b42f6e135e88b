"""GPU crypto backend: the era's threshold crypto and the MSMs on the card.

The port of `lachain_tpu/crypto/tpu_backend.py`. Two era-tick batch ops
share one engine (`_dispatch_era_batch`, the port of the reference's,
tpu_backend.py:396-485): mask absent lanes, pad the slot axis to a power of
two with fully-masked dummy slots, dispatch the era pipeline, and return a
finish call that folds every slot into ONE grand multi-pairing (2 pairs per
slot) and bisects on failure. Each slot's equality is randomized by its own
RLC coefficients, so a pairing product over any subset is a sound batch
check for that subset.
  * `tpke_era_verify_combine_async`: TPKE decryption shares (G1) on
    GpuEraPipeline.dispatch_era, whose kernels run between dispatch and
    finish; at most `era_dispatch_depth` (the pipeline's MAX_INFLIGHT)
    dispatches may be unfinished. `tpke_era_verify_combine` is its
    dispatch and finish in one call;
  * `ts_era_verify_combine`: common-coin signature shares (G2),
    TsGpuEraPipeline, synchronous (the reference has no async coin op).
`era_calls`, `era_slots_total` and `ts_era_calls` count the era calls run
to their end, as the reference's counters do.
`g1_msm` / `g2_msm` run on the card through `g1.msm_reduce` /
`g2.msm2_reduce` (tpu_backend.py:207-267); `g1_msm_batch` runs many G1
MSMs (a DKG's row checks and key derivation) in one such call.

Every batch runs on the pipeline's device; there is no lane threshold that
routes work elsewhere. Pairings, hash-to-curve and single scalar
multiplications stay on the host backend, whose ops this class exposes by
name: by default the native library (`native_backend.NativeBackend`, as
the JAX package's TpuBackend picks it, tpu_backend.py:109-116); pure
Python only where the caller passes `host_backend=HostBackend()`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from . import bls12381 as bls
from .host import batch_bisect_verify
from .native_backend import NativeBackend
from ..ops import g1, g2
from ..ops.glv import W256
from ..ops.verify import (
    ESCAPES,
    GpuEraPipeline,
    TsGpuEraPipeline,
    _pow2_at_least,
    resolve_device,
)
from ..parallel import mesh_by_default
from ..parallel.mesh import MeshEraPipeline, canonical_device, cards_from


@dataclass
class CoinJob:
    """One common coin's pending share verification+combination work.

    sigma_by_signer: length-K row of partial-signature points (G2); None
        where validator j's share has not arrived (that lane is masked out).
    lagrange_row:    length-K row of Lagrange-at-0 coefficients; nonzero
        exactly on the t+1 shares chosen for the combination.
    h:               H_G2(msg), the hashed coin id being signed.
    """

    sigma_by_signer: List[Optional[tuple]]
    lagrange_row: List[int]
    h: tuple


@dataclass
class EraSlotJob:
    """One ACS slot's pending verification+combination work.

    u_by_validator: length-K row of decryption-share points; None where
        validator j's share has not arrived (that lane is masked out).
    lagrange_row:   length-K row of Lagrange-at-0 coefficients; nonzero
        exactly on the t+1 shares chosen for the combination.
    h:              H_G2(U, V) for the slot's ciphertext.
    w:              the ciphertext's W point (G2).
    """

    u_by_validator: List[Optional[tuple]]
    lagrange_row: List[int]
    h: tuple
    w: tuple


class GpuBackend:
    """Era-shaped batch crypto and MSMs on the card, host ops delegated.

    `GpuBackend()` asks for the card and raises where there is none;
    `device="cpu"` runs the kernels' plain versions (tests). The host ops
    run on `host_backend`, the native library when it is None. `pipeline`
    takes the TPKE era pipeline, as TpuBackend.__init__ does
    (tpu_backend.py:81-87): by default, on the card, a MeshEraPipeline over
    every visible card where there are two or more (`mesh_by_default`, the
    rule of tpu_backend.py:155-161), the backend's device first
    (`cards_from`), else a GpuEraPipeline on the backend's device; a
    synchronous pipeline (ops/verify.GlvEraPipeline) runs
    tpke_era_verify_combine through _dispatch_era_batch's synchronous
    branch. A pipeline whose (first) device is not the backend's raises.
    The coin era always runs on a TsGpuEraPipeline (tpu_backend.py:178-193),
    on the backend's device."""

    def __init__(self, device="cuda", host_backend=None, pipeline=None):
        self.device = resolve_device(device)
        if pipeline is not None and canonical_device(pipeline.device) != canonical_device(
                self.device):
            raise ValueError(f"a pipeline on {pipeline.device} for a backend "
                             f"on {self.device}")
        self._host = host_backend or NativeBackend()
        # the default pipelines' escapes to the host MSM use the host backend
        if pipeline is None:
            if self.device.type == "cuda" and mesh_by_default(torch.cuda.device_count()):
                pipeline = MeshEraPipeline(self._host, devices=cards_from(self.device))
            else:
                pipeline = GpuEraPipeline(self._host, self.device)
        self._pipeline = pipeline
        self._ts_pipeline = TsGpuEraPipeline(self._host, self.device)
        self._y_cache: dict = {}
        # wall seconds of the era finished last: the pipeline's phases +
        # `pairing_s`
        self.last_timings: dict = {}
        self.era_calls = 0
        self.era_slots_total = 0
        self.ts_era_calls = 0

    @property
    def era_dispatch_depth(self) -> int:
        """How many TPKE era dispatches may be unfinished at once: the
        pipeline's MAX_INFLIGHT, 1 for a synchronous pipeline
        (GlvEraPipeline)."""
        return getattr(self._pipeline, "MAX_INFLIGHT", 1)

    # -- host ops ------------------------------------------------------------
    @property
    def host_name(self) -> str:
        """The host backend's name ("native" or "python")."""
        return self._host.name

    @property
    def host(self):
        """The host backend: the consensus protocols run their host ops
        (hash-to-curve, point checks, pairings, the per-slot and coin MSMs)
        on it, as the JAX package's TpuBackend sends MSMs below its lane
        threshold to its host backend (tpu_backend.py:195-217)."""
        return self._host

    def g1_mul(self, point: tuple, scalar: int) -> tuple:
        return self._host.g1_mul(point, scalar)

    def g2_mul(self, point: tuple, scalar: int) -> tuple:
        return self._host.g2_mul(point, scalar)

    def pairing_check(self, pairs) -> bool:
        return self._host.pairing_check(pairs)

    def hash_to_g2(self, msg: bytes, domain: bytes = b"LTPU-G2") -> tuple:
        return self._host.hash_to_g2(msg, domain)

    # -- MSMs on the card ----------------------------------------------------
    def g1_msm(self, points, scalars) -> tuple:
        return self._device_msm([points], [scalars], group2=False)[0]

    def g2_msm(self, points, scalars) -> tuple:
        return self._device_msm([points], [scalars], group2=True)[0]

    def g1_msm_batch(self, point_lists, scalar_lists) -> list:
        """[sum_i s_gi P_gi for each group g] in one MSM call: a DKG row
        check's f+1 row MSMs, a keyring's N+1 key MSMs."""
        return self._device_msm(point_lists, scalar_lists, group2=False)

    def _device_msm(self, point_lists, scalar_lists, group2: bool) -> list:
        """[sum_i s_gi P_gi for each group g] as ONE windowed MSM (64 windows
        of the scalar mod r) and one tree reduce: every group padded with
        infinity to one power of two k, one `msm_reduce` / `msm2_reduce`
        over groups of k lanes and one fetch.

        An infinity input gets scalar 0: its packed form (0, 1, 0) is no
        group element the incomplete formulas can add. A group's sum that
        comes back as infinity while a lane of it is live is recomputed by
        the host MSM and counted in `ESCAPES`: equal partial sums (a
        repeated input) collide in the incomplete add and give Z = 0, like
        the era pipelines' combine lanes. The JAX route
        (tpu_backend.py:231-267) returns that infinity as it is."""
        inf, is_inf = (
            (bls.G2_INF, bls.g2_is_inf) if group2 else (bls.G1_INF, bls.g1_is_inf)
        )
        if len(scalar_lists) != len(point_lists):
            raise ValueError("one scalar list per point list")
        if any(len(p) != len(s) for p, s in zip(point_lists, scalar_lists)):
            raise ValueError("one scalar per point")
        if not point_lists:
            return []
        k = _pow2_at_least(max(len(p) for p in point_lists))
        lanes, ss = [], []
        for pts, scs in zip(point_lists, scalar_lists):
            pad = k - len(pts)
            lanes += list(pts) + [inf] * pad
            ss += [0 if is_inf(p) else s % bls.R for p, s in zip(pts, scs)]
            ss += [0] * pad
        dev = self.device
        digits = g1.digits_col(ss, W256, dev)
        cpu = dev.type == "cpu"
        if group2:
            rows, flags = g1.fetch(g2.msm2_reduce(g2.g2_pack(lanes, dev), digits, k))
            outs = g2.g2_unpack_host(rows, flags, cpu)
        else:
            rows, flags = g1.fetch(g1.msm_reduce(g1.g1_pack(lanes, dev), digits, k))
            outs = g1.g1_unpack_host(rows, flags, cpu)
        name = "g2_msm" if group2 else "g1_msm"
        for g, out in enumerate(outs):
            if is_inf(out) and any(ss[g * k:(g + 1) * k]):
                ESCAPES[name] += 1
                outs[g] = getattr(self._host, name)(point_lists[g], scalar_lists[g])
        return outs

    # -- the era-tick batch ops ----------------------------------------------
    def _stable_y_points(self, vks, attr: str) -> list:
        """One stable y-point list per key list, so the pipelines' device
        copy of the keys is reused across eras (keyed by identity with a
        strong reference). attr: "y_i" for TPKE verification keys, "y" for
        TS public keys."""
        key = (id(vks), attr)
        hit = self._y_cache.get(key)
        if hit is not None and hit[0] is vks:
            return hit[1]
        y_points = [getattr(vk, attr) for vk in vks]
        if len(self._y_cache) >= 8:
            self._y_cache.pop(next(iter(self._y_cache)))
        self._y_cache[key] = (vks, y_points)
        return y_points

    def _dispatch_era_batch(
        self, jobs, rows, lags, y_points, inf_point, pipeline, pairs_for, rng,
    ):
        """The engine both era ops share. A pipeline with `dispatch_era`
        runs its kernels until the returned call finishes it; a synchronous
        one completes here. `pairs_for(job, agg)` yields the two pairing
        pairs of one slot's verification equality."""
        s = len(jobs)
        k = len(y_points)
        slots, masks = [], []
        for row, lag in zip(rows, lags):
            if len(row) != k or len(lag) != k:
                raise ValueError(f"era job rows must have length {k}")
            masks.append([p is not None for p in row])
            slots.append(
                ([p if p is not None else inf_point for p in row], list(lag))
            )
        for _ in range(_pow2_at_least(s) - s):
            slots.append(([inf_point] * k, [0] * k))
            masks.append([False] * k)
        dispatch = getattr(pipeline, "dispatch_era", None)
        if dispatch is not None:
            pipeline_fin = dispatch(slots, y_points, rng, masks=masks)
        else:
            ran = pipeline.run_era(slots, y_points, rng, masks=masks)
            pipeline_fin = lambda: ran  # noqa: E731

        def finish() -> List[Tuple[bool, Optional[tuple]]]:
            aggs, _rlc = pipeline_fin()
            timings = dict(pipeline.last_timings)  # this era's, just finished

            def group_ok(idx: List[int]) -> bool:
                pairs = []
                for i in idx:
                    pairs.extend(pairs_for(jobs[i], aggs[i]))
                return self._host.pairing_check(pairs)

            t0 = time.perf_counter()
            ok_flags = batch_bisect_verify(group_ok, s)
            self.last_timings = dict(timings, pairing_s=time.perf_counter() - t0)
            return [
                (ok, aggs[i][2] if ok else None) for i, ok in enumerate(ok_flags)
            ]

        return finish

    def tpke_era_verify_combine_async(
        self, jobs: Sequence[EraSlotJob], verification_keys, rng
    ):
        """The two-phase tpke_era_verify_combine: draws the RLC
        coefficients, packs the era and launches its kernels now, and
        returns a finish() giving the same per-job results. Eras dispatched
        in order draw from `rng` as the same synchronous calls would."""
        if not jobs:
            return lambda: []
        fin = self._dispatch_era_batch(
            jobs,
            [j.u_by_validator for j in jobs],
            [j.lagrange_row for j in jobs],
            self._stable_y_points(verification_keys, "y_i"),
            bls.G1_INF,
            self._pipeline,
            lambda job, agg: [(agg[0], job.h), (bls.g1_neg(agg[1]), job.w)],
            rng,
        )

        def finish() -> List[Tuple[bool, Optional[tuple]]]:
            results = fin()
            self.era_calls += 1
            self.era_slots_total += len(jobs)
            return results

        return finish

    def tpke_era_verify_combine(
        self, jobs: Sequence[EraSlotJob], verification_keys, rng
    ) -> List[Tuple[bool, Optional[tuple]]]:
        """Verify + combine every pending TPKE slot in one pipeline run.

        Returns per-job (all_shares_valid, combined_point); `combined` is
        U^x for the slot (feed it to tpke.decrypt_with_combined). A slot
        whose shares fail the grand check is isolated by bisection and
        reports (False, None). The check per slot is
        e(u_agg, H) == e(y_agg, W)."""
        return self.tpke_era_verify_combine_async(jobs, verification_keys, rng)()

    def ts_era_verify_combine(
        self, jobs: Sequence[CoinJob], ts_public_keys, rng
    ) -> List[Tuple[bool, Optional[tuple]]]:
        """Verify + combine every pending common coin in one pipeline run.

        `ts_public_keys` is the per-validator TS key list (TsPublicKey, G1).
        Returns per-coin (all_shares_valid, combined_sigma), with the same
        grand multi-pairing and bisection as `tpke_era_verify_combine`; the
        check per coin is e(g1, sig_agg) == e(y_agg, H(coin id))."""
        if not jobs:
            return []
        results = self._dispatch_era_batch(
            jobs,
            [j.sigma_by_signer for j in jobs],
            [j.lagrange_row for j in jobs],
            self._stable_y_points(ts_public_keys, "y"),
            bls.G2_INF,
            self._ts_pipeline,
            lambda job, agg: [(bls.G1_GEN, agg[0]), (bls.g1_neg(agg[1]), job.h)],
            rng,
        )()
        self.ts_era_calls += 1
        return results
