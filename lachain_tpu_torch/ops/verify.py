"""Era pipelines: batched share verification + combination.

The port of `lachain_tpu/ops/verify.py`'s pipelines. Per era, S slots hold
K shares each; the reference verifies every share with 2 pairings and
combines each slot serially. Here the whole era becomes MSMs on the card
plus one grand multi-pairing on the host (crypto/gpu_backend.py):

  TPKE (G1 shares, `GpuEraPipeline`, ops/g1.era_kernel_fused):
    verify : e(sum_j c_j U_j, H) == e(sum_j c_j Y_j, W)   (random 64-bit c_j)
    combine: U^x = sum_i lambda_i U_i                     (per slot)
  coin (G2 signature shares, `TsGpuEraPipeline`, ops/g2.ts_era_kernel):
    verify : e(g1, sum_j c_j sigma_j) == e(sum_j c_j Y_j, H(msg))
    combine: sigma = sum_i lambda_i sigma_i               (per coin)

`GpuEraPipeline.run_era` and `TsGpuEraPipeline.run_era` keep the contracts
of `PallasEraPipeline.run_era` (verify.py:262-326) and
`TsPallasPipeline.run_era` (:348-394); `HostEraPipeline` and
`TsHostEraPipeline` compute the same aggregates with the host MSMs and are
the port's own oracles.

`ESCAPES` counts each recompute on the host of a result the card returned
as infinity (an incomplete-add collision): the pipelines' combines here,
the device MSM routes in crypto/gpu_backend.py, and the degenerate Q of
a batched ECDSA recovery (ops/secp.GpuEcdsaRecover). A run can then show
that its answers came from the card.
"""
from __future__ import annotations

import time

import torch

from ..crypto import bls12381 as bls
from ..crypto.host import HostBackend
from ..crypto.native_backend import NativeBackend
from . import g1, g2
from .glv import W64, W128, W256, glv_split

ESCAPES = {"tpke_combine": 0, "ts_combine": 0, "g1_msm": 0, "g2_msm": 0,
           "ecdsa_recover": 0}


def reset_escapes() -> None:
    for name in ESCAPES:
        ESCAPES[name] = 0


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
    `fetch_s` (download + unpack + per-slot finish). `backend` serves the
    escapes to the host MSM: the native library when it is None, as in
    GpuBackend."""

    def __init__(self, backend=None, device="cuda"):
        self.device = resolve_device(device)
        self._backend = backend or NativeBackend()
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
        rows, flags = g1.fetch(fused)  # ONE device->host copy
        cols = g1.g1_unpack_host(rows, flags, dev.type == "cpu")  # u|y|c1|c2
        out = []
        for i in range(s):
            comb = bls.g1_add(cols[2 * s + i], cols[3 * s + i])
            if comb[2] == 0 and any(c for c in slots[i][1]):
                # incomplete-add collision in the combine tree: the Lagrange
                # lanes carry no random coefficients, so the slot's combine
                # is recomputed by the host MSM (pg1 pipelines do the same)
                u_list, lag_list = slots[i]
                ESCAPES["tpke_combine"] += 1
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


class TsGpuEraPipeline:
    """The coin-era pipeline on the G2 kernels (ops/g2.py), with the key
    aggregate on the G1 kernels.

    run_era(coins, y_points, rng, masks), coins = [(sig_list, lag_row)] per
    coin (K G2 signature shares and K Lagrange-at-0 coefficients), y_points
    = the K per-validator TS public keys (G1). Returns (per-coin
    (sig_rlc_agg G2, y_rlc_agg G1, combined_sig G2), rlc). `last_timings`
    holds the phases of the last run as GpuEraPipeline's does; `backend` as
    there."""

    def __init__(self, backend=None, device="cuda"):
        self.device = resolve_device(device)
        self._backend = backend or NativeBackend()
        self._y_cache = _TiledYCache(self.device)
        self.last_timings: dict = {}

    def run_era(self, coins, y_points, rng, masks=None):
        t0 = time.perf_counter()
        s = len(coins)
        k = len(y_points)
        rlc = era_rlc(coins, k, rng, masks)
        k_pad = _pow2_at_least(k)
        pad = k_pad - k
        dev = self.device
        sig_flat = [
            p for sig_list, _ in coins for p in sig_list + [bls.G2_INF] * pad
        ]
        rlc_flat = [c for row in rlc for c in row + [0] * pad]
        lag_flat = [c for _, lag in coins for c in lag + [0] * pad]
        sig = g2.g2_pack(sig_flat, dev)
        y = self._y_cache.get(y_points, s, k_pad)
        rlc16 = g1.digits_col(rlc_flat, W64, dev)
        lag64 = g1.digits_col(lag_flat, W256, dev)
        t1 = time.perf_counter()
        fused = g2.ts_era_kernel(sig, y, rlc16, lag64, k_pad)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        rows, flags = g1.fetch(fused)  # ONE device->host copy
        cpu = dev.type == "cpu"
        sig_cols = g2.g2_unpack_host(rows[:, : 2 * s], flags[: 2 * s], cpu)
        g1_rows = y.shape[0]
        y_cols = g1.g1_unpack_host(rows[:g1_rows, 2 * s :], flags[2 * s :], cpu)
        out = []
        for i in range(s):
            comb = sig_cols[s + i]
            if bls.g2_is_inf(comb) and any(c for c in coins[i][1]):
                # incomplete-add collision in the combine lanes: they carry no
                # random coefficients, so the coin's combine is recomputed by
                # the host MSM (the escape of TsPallasPipeline, :384-392)
                sig_list, lag_list = coins[i]
                ESCAPES["ts_combine"] += 1
                comb = self._backend.g2_msm(
                    [p for p, c in zip(sig_list, lag_list) if c],
                    [c for c in lag_list if c],
                )
            out.append((sig_cols[i], y_cols[i], comb))
        t3 = time.perf_counter()
        self.last_timings = {
            "pack_s": t1 - t0, "device_s": t2 - t1, "fetch_s": t3 - t2,
        }
        return out, rlc


class _HostEraPipelineBase:
    """The era-pipeline contract computed with the host MSMs: the port's
    oracle for its device pipelines, on the pure-Python HostBackend unless
    given another, so that it stays independent of the code under test.
    The share group differs per subclass (`_share_msm`)."""

    _share_msm = "g1_msm"

    def __init__(self, backend=None):
        self._backend = backend or HostBackend()

    def run_era(self, slots, y_points, rng, masks=None):
        k = len(y_points)
        rlc = era_rlc(slots, k, rng, masks)
        share_msm = getattr(self._backend, self._share_msm)
        msm = self._backend.g1_msm
        out = []
        for i, (pts_list, lag_list) in enumerate(slots):
            live = [j for j, c in enumerate(rlc[i]) if c]
            share_agg = share_msm(
                [pts_list[j] for j in live], [rlc[i][j] for j in live]
            )
            y_agg = msm([y_points[j] for j in live], [rlc[i][j] for j in live])
            comb_live = [j for j, c in enumerate(lag_list) if c]
            comb = share_msm(
                [pts_list[j] for j in comb_live],
                [lag_list[j] for j in comb_live],
            )
            out.append((share_agg, y_agg, comb))
        return out, rlc


class HostEraPipeline(_HostEraPipelineBase):
    """TPKE slots: the shares are G1 points."""

    _share_msm = "g1_msm"


class TsHostEraPipeline(_HostEraPipelineBase):
    """Coins: the shares are G2 signatures."""

    _share_msm = "g2_msm"
