"""Era pipelines: batched TPKE share verification + combination.

The port of `lachain_tpu/ops/verify.py`'s G1 half. Per era, S ACS slots
hold K decryption shares each; the reference verifies every share with 2
pairings and combines each slot serially. Here the whole era becomes

  verify : e(sum_j c_j U_j, H) == e(sum_j c_j Y_j, W)  (random 64-bit c_j)
  combine: U^x = sum_i lambda_i U_i                    (per slot)

i.e. the MSMs of one `era_kernel_fused` run on the card plus one grand
multi-pairing on the host (crypto/gpu_backend.py).

`GpuEraPipeline.run_era` keeps the contract of `PallasEraPipeline.run_era`
(verify.py:262-326); `HostEraPipeline` computes the same aggregates with the
host MSM and is the port's own oracle.
"""
from __future__ import annotations

import time

import torch

from ..crypto import bls12381 as bls
from ..crypto.host import HostBackend
from . import g1
from .glv import W64, W128, glv_split


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; asking for the card where there is
    none raises (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def era_rlc(slots, k: int, rng, masks=None):
    """Per-lane 64-bit RLC coefficients, drawn row-major as
    rng.randbelow(2^64 - 1) + 1 and zeroed on masked (absent) lanes — the
    same draws in the same order as the JAX package's era_rlc."""
    s = len(slots)
    for a_list, b_list in slots:
        if len(a_list) != k or len(b_list) != k:
            raise ValueError(
                f"every slot must carry exactly {k} shares/coefficients"
            )
    if masks is not None and (
        len(masks) != s or any(len(m) != k for m in masks)
    ):
        raise ValueError("masks must be S x K")
    rlc = [
        [rng.randbelow((1 << 64) - 1) + 1 for _ in range(k)]
        for _ in range(s)
    ]
    if masks is not None:
        rlc = [
            [c if m else 0 for c, m in zip(row, mrow)]
            for row, mrow in zip(rlc, masks)
        ]
    return rlc


def _pow2_at_least(k: int) -> int:
    return 1 << max(0, k - 1).bit_length() if k > 1 else 1


class _TiledYCache:
    """Device copy of the era-invariant verification keys: one (3R, S*K_pad)
    tiled lane block per (key list, S, K_pad), keyed by id() with a strong
    reference so a collected list can never alias a new validator set."""

    LIMIT = 4  # validator sets kept

    def __init__(self, device):
        self._device = device
        self._cache = {}

    def get(self, y_points, s: int, k_pad: int):
        key = (id(y_points), s, k_pad)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is y_points:
            return hit[1]
        padded = list(y_points) + [bls.G1_INF] * (k_pad - len(y_points))
        y_dev = g1.g1_pack(padded, self._device).repeat(1, s)
        if len(self._cache) >= self.LIMIT:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (y_points, y_dev)
        return y_dev


class GpuEraPipeline:
    """The era pipeline on the G1 kernels (ops/g1.py).

    `last_timings` holds the wall seconds of the last run's phases: `pack_s`
    (marshal + upload), `device_s` (all launches, to a synchronised end) and
    `fetch_s` (download + unpack + per-slot finish)."""

    def __init__(self, backend=None, device="cuda"):
        self.device = resolve_device(device)
        self._backend = backend or HostBackend()
        self._y_cache = _TiledYCache(self.device)
        self.last_timings: dict = {}

    def run_era(self, slots, y_points, rng, masks=None):
        """slots: list of (u_list, lagrange_list) per ACS slot; y_points: the
        K verification keys. Returns (per-slot (u_agg, y_agg, combined)
        oracle points, rlc coefficients used).

        masks (optional): per-slot list of K bools; False lanes get a ZERO
        RLC coefficient, so an absent share (pass G1_INF for it) adds to
        neither aggregate."""
        t0 = time.perf_counter()
        s = len(slots)
        k = len(y_points)
        rlc = era_rlc(slots, k, rng, masks)
        # the tree reduce sums power-of-two groups of adjacent lanes: pad each
        # slot with flagged-out filler lanes (zero digits -> infinity flags)
        k_pad = _pow2_at_least(k)
        pad = k_pad - k
        dev = self.device
        u_flat = [u for u_list, _ in slots for u in u_list + [bls.G1_INF] * pad]
        u = g1.g1_pack(u_flat, dev)
        y = self._y_cache.get(y_points, s, k_pad)
        rlc_flat = [c for row in rlc for c in row + [0] * pad]
        lag_flat = [c for _, lag_list in slots for c in lag_list + [0] * pad]
        halves = [glv_split(v) for v in lag_flat]
        rlc16 = g1.digits_col(rlc_flat, W64, dev)
        lag1 = g1.digits_col([h[0] for h in halves], W128, dev)
        lag2 = g1.digits_col([h[1] for h in halves], W128, dev)
        t1 = time.perf_counter()
        fused = g1.era_kernel_fused(u, y, rlc16, lag1, lag2, k_pad)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        cols = g1.g1_unpack(fused[:-1], fused[-1] != 0)  # u_agg|y_agg|c1|c2
        out = []
        for i in range(s):
            comb = bls.g1_add(cols[2 * s + i], cols[3 * s + i])
            if comb[2] == 0 and any(c for c in slots[i][1]):
                # incomplete-add collision in the combine tree: the Lagrange
                # lanes carry no random coefficients, so the slot's combine
                # is recomputed by the host MSM (pg1 pipelines do the same)
                u_list, lag_list = slots[i]
                comb = self._backend.g1_msm(
                    [u for u, c in zip(u_list, lag_list) if c],
                    [c for c in lag_list if c],
                )
            out.append((cols[i], cols[s + i], comb))
        t3 = time.perf_counter()
        self.last_timings = {
            "pack_s": t1 - t0, "device_s": t2 - t1, "fetch_s": t3 - t2,
        }
        return out, rlc


class HostEraPipeline:
    """The same run_era contract computed with the host MSM: the port's
    oracle for GpuEraPipeline."""

    def __init__(self, backend=None):
        self._backend = backend or HostBackend()

    def run_era(self, slots, y_points, rng, masks=None):
        k = len(y_points)
        rlc = era_rlc(slots, k, rng, masks)
        msm = self._backend.g1_msm
        out = []
        for i, (pts_list, lag_list) in enumerate(slots):
            live = [j for j, c in enumerate(rlc[i]) if c]
            u_agg = msm([pts_list[j] for j in live], [rlc[i][j] for j in live])
            y_agg = msm([y_points[j] for j in live], [rlc[i][j] for j in live])
            comb_live = [j for j, c in enumerate(lag_list) if c]
            comb = msm(
                [pts_list[j] for j in comb_live],
                [lag_list[j] for j in comb_live],
            )
            out.append((u_agg, y_agg, comb))
        return out, rlc
