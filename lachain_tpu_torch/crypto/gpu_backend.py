"""GPU crypto backend: the era's TPKE verify+combine on the card.

The port of `lachain_tpu/crypto/tpu_backend.py`'s TPKE half.
`tpke_era_verify_combine` masks absent lanes, pads the slot axis to a power
of two with fully-masked dummy slots, runs the era pipeline
(ops/verify.GpuEraPipeline), then folds every slot into ONE grand
multi-pairing (2 pairs per slot) and bisects on failure: each slot's
equality is randomized by its own RLC coefficients, so a pairing product
over any subset is a sound batch check for that subset.

Every era batch runs on the pipeline's device; there is no lane threshold
that routes work elsewhere. Pairings and hash-to-curve stay on the host
backend, whose ops this class exposes by name.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import bls12381 as bls
from .host import HostBackend, batch_bisect_verify
from ..ops.verify import GpuEraPipeline, _pow2_at_least


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
    """Era-shaped TPKE batch crypto on the card, host ops delegated.

    `GpuBackend()` asks for the card and raises where there is none;
    `device="cpu"` runs the kernels' plain versions (tests)."""

    def __init__(self, device="cuda", host_backend=None):
        self._host = host_backend or HostBackend()
        self._pipeline = GpuEraPipeline(self._host, device)
        self.device = self._pipeline.device
        self._y_cache: dict = {}
        # wall seconds of the last era: the pipeline's phases + `pairing_s`
        self.last_timings: dict = {}

    # -- host ops ------------------------------------------------------------
    def g1_mul(self, point: tuple, scalar: int) -> tuple:
        return self._host.g1_mul(point, scalar)

    def g2_mul(self, point: tuple, scalar: int) -> tuple:
        return self._host.g2_mul(point, scalar)

    def g1_msm(self, points, scalars) -> tuple:
        return self._host.g1_msm(points, scalars)

    def pairing_check(self, pairs) -> bool:
        return self._host.pairing_check(pairs)

    def hash_to_g2(self, msg: bytes, domain: bytes = b"LTPU-G2") -> tuple:
        return self._host.hash_to_g2(msg, domain)

    # -- the era-tick batch op ---------------------------------------------
    def _stable_y_points(self, vks) -> list:
        """One stable y-point list per verification-key list, so the
        pipeline's device copy of the keys is reused across eras (keyed by
        identity with a strong reference)."""
        key = id(vks)
        hit = self._y_cache.get(key)
        if hit is not None and hit[0] is vks:
            return hit[1]
        y_points = [vk.y_i for vk in vks]
        if len(self._y_cache) >= 8:
            self._y_cache.pop(next(iter(self._y_cache)))
        self._y_cache[key] = (vks, y_points)
        return y_points

    def tpke_era_verify_combine(
        self, jobs: Sequence[EraSlotJob], verification_keys, rng
    ) -> List[Tuple[bool, Optional[tuple]]]:
        """Verify + combine every pending slot in one pipeline run.

        Returns per-job (all_shares_valid, combined_point); `combined` is
        U^x for the slot (feed it to tpke.decrypt_with_combined). A slot
        whose shares fail the grand check is isolated by bisection and
        reports (False, None)."""
        if not jobs:
            return []
        y_points = self._stable_y_points(verification_keys)
        s = len(jobs)
        k = len(y_points)
        slots, masks = [], []
        for job in jobs:
            row, lag = job.u_by_validator, job.lagrange_row
            if len(row) != k or len(lag) != k:
                raise ValueError(f"era job rows must have length {k}")
            masks.append([p is not None for p in row])
            slots.append(
                ([p if p is not None else bls.G1_INF for p in row], list(lag))
            )
        for _ in range(_pow2_at_least(s) - s):
            slots.append(([bls.G1_INF] * k, [0] * k))
            masks.append([False] * k)
        aggs, _rlc = self._pipeline.run_era(slots, y_points, rng, masks=masks)

        def group_ok(idx: List[int]) -> bool:
            pairs = []
            for i in idx:
                pairs.append((aggs[i][0], jobs[i].h))
                pairs.append((bls.g1_neg(aggs[i][1]), jobs[i].w))
            return self._host.pairing_check(pairs)

        t0 = time.perf_counter()
        ok_flags = batch_bisect_verify(group_ok, s)
        self.last_timings = dict(
            self._pipeline.last_timings, pairing_s=time.perf_counter() - t0
        )
        return [
            (ok, aggs[i][2] if ok else None) for i, ok in enumerate(ok_flags)
        ]
