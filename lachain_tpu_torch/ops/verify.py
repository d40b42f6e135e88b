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
`TsPallasPipeline.run_era` (:348-394); `GpuEraPipeline.dispatch_era` is
the async half of run_era, under the JAX package's
`MeshEraPipeline.dispatch_era` contract (parallel/mesh.py:375-487), on two
CUDA streams. `HostEraPipeline` and
`TsHostEraPipeline` compute the same aggregates with the host MSMs and are
the port's own oracles.

`ESCAPES` counts each recompute on the host of a result the card returned
as infinity (an incomplete-add collision): the pipelines' combines here,
the device MSM routes in crypto/gpu_backend.py, and the degenerate Q of
a batched ECDSA recovery (ops/secp.GpuEcdsaRecover). A run can then show
that its answers came from the card.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..crypto import bls12381 as bls
from ..crypto.host import HostBackend
from ..crypto.native_backend import NativeBackend
from . import curve, g1, g2, glv, msm
from .glv import W64, W128, W256

ESCAPES = {"tpke_combine": 0, "ts_combine": 0, "g1_msm": 0, "g2_msm": 0,
           "ecdsa_recover": 0, "tpke_verifier": 0}


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


class _KeyCache:
    """Device copies of era-invariant verification keys (GpuEraPipeline's
    tiled lane blocks, GlvEraPipeline's fixed-base tables), keyed by id()
    of the key list and the shape they were made for, with a strong
    reference so a collected list can never alias a new validator set;
    LIMIT entries are kept, the oldest dropped.

    On the card an entry is built on the stream current at its first use
    and read by later eras on other streams (GpuEraPipeline dispatches on
    two): every read orders the reading stream after the build's event and
    marks the entry as used there, so that its memory is not reused while
    that stream may still read it."""

    LIMIT = 4

    def __init__(self, device):
        self._device = device
        self._cache = {}

    def get(self, y_points, build, shape=()):
        """The entry of (y_points, shape), made by build() on a miss."""
        key = (id(y_points), *shape)
        hit = self._cache.get(key)
        card = self._device.type == "cuda"
        if hit is not None and hit[0] is y_points:
            _, value, built = hit
            if card:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(built)
                value.record_stream(stream)
            return value
        value = build()
        built = None
        if card:
            built = torch.cuda.Event()
            built.record(torch.cuda.current_stream(self._device))
        if len(self._cache) >= self.LIMIT:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = (y_points, value, built)
        return value


def _pad_keys(y_points, k_pad: int) -> list:
    return list(y_points) + [bls.G1_INF] * (k_pad - len(y_points))


# rows of a block's pinned upload: the share words (3 x 12), the RLC digits
# (W64) and the two GLV halves of the Lagrange coefficients (W128 each)
_U_ROWS = 3 * g1.NL
_STAGE_ROWS = _U_ROWS + W64 + 2 * W128


class _LagDigitCache:
    """The (lag1, lag2) digit planes, each (W128, k) int32, of a Lagrange
    row's GLV halves (msm.era_digits' layout), keyed by the row's values
    (the JAX package's parallel/mesh.py:229): a fixed signer set repeats
    its row across every slot of every era, so the split and the digits are
    made once."""

    def __init__(self, limit: int = 128):
        self._cache: dict = {}
        self._limit = limit

    def get(self, row) -> tuple:
        key = tuple(row)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        halves = [glv.glv_split(v) for v in row]
        planes = (glv.digits_col([h[0] for h in halves], W128),
                  glv.digits_col([h[1] for h in halves], W128))
        if len(self._cache) >= self._limit:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = planes
        return planes


class _EraStaging:
    """Host marshal buffers of one padded (s_pad, k_pad) era grid (the JAX
    package's parallel/mesh.py:192), in the upload's layouts: `u` (rows,
    s_pad, k_pad) share points (plain words on the card, g1_ref's limbs on
    the CPU), `rlc` (W64, s_pad, k_pad) and `lag1` / `lag2` (W128, ...)
    int32 MSB-first digit planes. Filler lanes hold infinity and zero
    digits; a fill writes only the live [:s, :k] region, after `clean(s,
    k)` has reset what a previous, larger live region left there, so an
    era's host work follows its live lanes.

    On the card, for a grid of (n_slot, n_share) blocks, `pinned` holds one
    page-locked block a shard, (n_slot, n_share, _STAGE_ROWS, S_l, K_l)
    int32, filled from the planes by `pack()`; on a grid of one block the
    planes are views of it and `pack()` copies nothing. `uploaded` holds
    the events recorded after the blocks' uploads, which a refill waits
    for."""

    __slots__ = ("u", "rlc", "lag1", "lag2", "pinned", "uploaded", "_inf_col",
                 "_filled")

    def __init__(self, s_pad: int, k_pad: int, inf_col: np.ndarray, blocks=None):
        self._inf_col = inf_col  # (rows,) infinity in the upload's layout
        self._filled = (s_pad, k_pad)  # everything is reset below
        self.pinned = None
        self.uploaded: list = []
        if blocks is not None:
            n_slot, n_share = blocks
            self.pinned = torch.empty(
                (n_slot, n_share, _STAGE_ROWS, s_pad // n_slot, k_pad // n_share),
                dtype=torch.int32, pin_memory=True)
        if blocks == (1, 1):
            self.u, self.rlc, self.lag1, self.lag2 = np.split(
                self.pinned.numpy()[0, 0], np.cumsum([_U_ROWS, W64, W128]))
        else:
            self.u = np.empty((len(inf_col), s_pad, k_pad), dtype=inf_col.dtype)
            self.rlc = np.empty((W64, s_pad, k_pad), dtype=np.int32)
            self.lag1 = np.empty((W128, s_pad, k_pad), dtype=np.int32)
            self.lag2 = np.empty((W128, s_pad, k_pad), dtype=np.int32)
        self.clean(0, 0)

    def _reset(self, slots, shares) -> None:
        self.u[:, slots, shares] = self._inf_col[:, None, None]
        for plane in (self.rlc, self.lag1, self.lag2):
            plane[:, slots, shares] = 0

    def clean(self, s: int, k: int) -> None:
        fs, fk = self._filled
        if fs > s:
            self._reset(slice(s, fs), slice(0, fk))
        if fk > k:
            self._reset(slice(0, min(fs, s)), slice(k, fk))
        self._filled = (s, k)

    def pack(self) -> None:
        """The grid into the shards' pinned blocks, block (r, c) the slots
        r * S_l.. and shares c * K_l.."""
        p = self.pinned.numpy()
        n_slot, n_share, _, s_l, k_l = p.shape
        if (n_slot, n_share) == (1, 1):
            return  # the planes are the block
        off = 0
        for plane in (self.u, self.rlc, self.lag1, self.lag2):
            rows = plane.shape[0]
            np.copyto(p[:, :, off:off + rows],
                      plane.reshape(rows, n_slot, s_l, n_share, k_l).transpose(1, 3, 0, 2, 4))
            off += rows


class _EraDispatch:
    """One dispatched era: calling it returns run_era's (out, rlc).

    On the card the host blocks on the last event of each device the era
    ran on (`spans`, one (start, last) pair a device; `done` is the first
    device's), reads the fused output (one launch out of Montgomery form
    and one download on the era's stream on the first device) and finishes
    each slot; on the CPU the work was done at dispatch and calling it
    returns it. `timings` holds the era's phases in seconds: `pack_s` (the
    host's marshal into the pinned buffers), `launch_s` (the host's time
    enqueueing the uploads and the launches; 0 on the CPU), `device_s` (on
    the card: CUDA events on the era's stream from the first upload to the
    last launch, the longest of its devices'; on the CPU: the plain
    versions' host time), `wait_s` (host time blocked in the call) and
    `fetch_s` (download, unpack and the per-slot finish)."""

    def __init__(self, pipeline, slots, rlc, timings, fused=None, stream=None,
                 spans=(), result=None):
        self._pipeline = pipeline
        self._slots = slots
        self._rlc = rlc
        self._fused = fused
        self._stream = stream
        self._spans = list(spans)
        self.done = self._spans[0][1] if self._spans else None
        self.timings = timings
        self._result = result
        self._called = False

    def __call__(self):
        if self._called:
            if self._result is None:
                raise RuntimeError("this era's finish failed")
            return self._result
        self._called = True
        try:
            if self.done is not None:
                t = self.timings
                t0 = time.perf_counter()
                for _start, last in self._spans:
                    last.synchronize()
                t1 = time.perf_counter()
                t["wait_s"] = t1 - t0
                t["device_s"] = max(a.elapsed_time(b) for a, b in self._spans) / 1e3
                with torch.cuda.stream(self._stream):
                    out = self._pipeline._finish_slots(self._fused, self._slots)
                t["fetch_s"] = time.perf_counter() - t1
                self._result = (out, self._rlc)
        finally:
            self._fused = None
            self._pipeline._release(self)
        return self._result


def _finish_g1_slots(fused, slots, device, backend) -> list:
    """A G1 era's fused output (3R + 1, 4 S_pad), columns u_agg | y_agg |
    comb1 | comb2 over S_pad >= S slots -> per-slot (u_agg, y_agg,
    combined) oracle points of the S live slots. A combine that collided in
    the incomplete add tree (the Lagrange lanes carry no random
    coefficients) is recomputed by the host MSM and counted in ESCAPES
    (msm.combine_or_host_msm; the pg1 pipelines do the same)."""
    s_pad = fused.shape[1] // 4
    rows, flags = g1.fetch(fused)  # ONE device->host copy
    cols = g1.g1_unpack_host(rows, flags, device.type == "cpu")
    out = []
    for i, slot in enumerate(slots):
        comb, escaped = msm.combine_or_host_msm(
            bls.g1_add(cols[2 * s_pad + i], cols[3 * s_pad + i]), *slot, backend)
        ESCAPES["tpke_combine"] += escaped
        out.append((cols[i], cols[s_pad + i], comb))
    return out


def _one_device(device) -> np.ndarray:
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = resolve_device(device)
    return grid


class _G1EraPipeline:
    """The G1 era pipelines' shared dispatch over an (n_slot, n_share) grid
    of devices: one device (GpuEraPipeline, GlvEraPipeline) or a mesh's
    (parallel/mesh.MeshEraPipeline).

    A dispatch draws the RLC coefficients over every lane in the
    synchronous order (era_rlc), fills the staging of its padded shape
    (`padded_shape`; _EraStaging, the Lagrange planes from _LagDigitCache),
    and for each block (r, c), slots r * S_l.. and shares c * K_l.., on
    the card uploads the block's pinned buffer to its device, converts its
    shares into Montgomery form (one `mont_convert`) and enqueues the
    device program (`_program`) there, without waiting for the card.
    `_join` makes the blocks' outputs one (3R + 1, 4 S_pad) u_agg | y_agg
    | comb1 | comb2 buffer on the first device, which the call fetches to
    finish each slot (_finish_g1_slots). A subclass gives the key operand
    of a block (`_keys`) and the program; a grid of several blocks, the
    cross-shard sum (`_join`).

    At most MAX_INFLIGHT dispatches may be unfinished: dispatch i runs on
    stream i % MAX_INFLIGHT of each of its devices and fills staging i %
    MAX_INFLIGHT of its padded shape, after waiting for the uploads that
    read it last (the copies only, not that era's kernels); one more raises
    RuntimeError. On the CPU the work is done at dispatch and the call
    only returns it, with the same in-flight bookkeeping. `calls` counts
    the dispatches, `pad_waste` is the last one's share of filler lanes,
    `last_timings` holds the phases of the era finished last (see
    _EraDispatch); `backend` serves the combine escapes to the host MSM:
    the native library when it is None, as in GpuBackend."""

    MAX_INFLIGHT = 2
    STAGED_SHAPES = 8  # padded shapes whose staging is kept

    def __init__(self, backend=None, device="cuda", grid=None):
        self._grid = _one_device(device) if grid is None else grid
        self.device = self._grid[0, 0]
        self._backend = backend or NativeBackend()
        distinct = list(dict.fromkeys(self._grid.flat))
        self._key_caches = {dev: _KeyCache(dev) for dev in distinct}
        self._lag_cache = _LagDigitCache()
        self._streams = None
        if self.device.type == "cuda":
            self._streams = {dev: tuple(torch.cuda.Stream(dev)
                                        for _ in range(self.MAX_INFLIGHT))
                             for dev in distinct}
        self._inf_col = self._u_rows([bls.G1_INF])[:, 0]
        self._staging: dict = {}
        self._inflight = 0
        self.calls = 0
        self.pad_waste = 0.0
        self.last_timings: dict = {}

    def padded_shape(self, s: int, k: int) -> tuple:
        """(s_pad, k_pad) the pipeline runs for a live (s, k) era grid: each
        slot padded to a power of two with flagged-out filler lanes (the
        tree reduce sums power-of-two groups of adjacent lanes)."""
        return s, _pow2_at_least(k)

    def _keys(self, dev, y_points, s_pad: int, k_pad: int, c: int):
        raise NotImplementedError

    def _program(self, u, y, rlc16, lag1, lag2, k: int, digits_checked=False):
        raise NotImplementedError

    def _join(self, outs, on):
        """The blocks' outputs (a list of rows) -> the era's fused buffer on
        the first device; `on(device)` gives the context of work there. One
        block: its own output."""
        (out,), = outs
        return out

    def _release(self, dispatch) -> None:
        self._inflight -= 1
        self.last_timings = dispatch.timings

    def _u_rows(self, points) -> np.ndarray:
        """Oracle points -> (rows, n) in the upload's layout."""
        if self._streams is not None:
            return g1.plain_words(g1.g1_xyz(points))
        return g1.g1_pack(points, "cpu").numpy()

    def _stage(self, s_pad: int, k_pad: int) -> _EraStaging:
        """Staging calls % MAX_INFLIGHT of the shape, free to refill."""
        ring = self._staging.get((s_pad, k_pad))
        if ring is None:
            if len(self._staging) >= self.STAGED_SHAPES:
                for old in self._staging.pop(next(iter(self._staging))):
                    for ev in old.uploaded:
                        ev.synchronize()
            blocks = self._grid.shape if self._streams is not None else None
            ring = self._staging[(s_pad, k_pad)] = tuple(
                _EraStaging(s_pad, k_pad, self._inf_col, blocks)
                for _ in range(self.MAX_INFLIGHT))
        stage = ring[self.calls % self.MAX_INFLIGHT]
        for ev in stage.uploaded:
            ev.synchronize()
        return stage

    def _fill(self, stage: _EraStaging, slots, rlc, s: int, k: int) -> None:
        stage.clean(s, k)
        stage.u[:, :s, :k] = self._u_rows(
            [u for u_list, _ in slots for u in u_list]).reshape(-1, s, k)
        stage.rlc[:, :s, :k] = glv.digits_col(
            [c for row in rlc for c in row], W64).reshape(W64, s, k)
        for i, (_, lag_list) in enumerate(slots):
            stage.lag1[:, i, :k], stage.lag2[:, i, :k] = self._lag_cache.get(lag_list)

    def _dispatch(self, slots, y_points, rng, masks=None) -> _EraDispatch:
        if self._inflight >= self.MAX_INFLIGHT:
            raise RuntimeError(
                f"{self._inflight} era dispatches are unfinished; finish one "
                f"before dispatching another (MAX_INFLIGHT = {self.MAX_INFLIGHT})"
            )
        t0 = time.perf_counter()
        s, k = len(slots), len(y_points)
        rlc = era_rlc(slots, k, rng, masks)  # every lane's, before any cut
        s_pad, k_pad = self.padded_shape(s, k)
        self.pad_waste = 1.0 - s * k / (s_pad * k_pad)
        stage = self._stage(s_pad, k_pad)
        self._fill(stage, slots, rlc, s, k)
        run = self._dispatch_cpu if self._streams is None else self._dispatch_card
        dispatch = run(stage, slots, y_points, rlc, s_pad, k_pad, t0)
        self.calls += 1
        self._inflight += 1
        return dispatch

    def _dispatch_cpu(self, stage, slots, y_points, rlc, s_pad, k_pad, t0):
        n_slot, n_share = self._grid.shape
        s_l, k_l = s_pad // n_slot, k_pad // n_share
        t1 = time.perf_counter()
        outs = []
        for r in range(n_slot):
            row = []
            for c in range(n_share):
                cut = (slice(None), slice(r * s_l, (r + 1) * s_l),
                       slice(c * k_l, (c + 1) * k_l))
                u, rlc16, lag1, lag2 = (
                    torch.from_numpy(np.ascontiguousarray(p[cut]).reshape(p.shape[0], -1))
                    for p in (stage.u, stage.rlc, stage.lag1, stage.lag2))
                y = self._keys(self._grid[r, c], y_points, s_pad, k_pad, c)
                row.append(self._program(u, y, rlc16, lag1, lag2, k_l, True))
            outs.append(row)
        fused = self._join(outs, lambda _dev: contextlib.nullcontext())
        t2 = time.perf_counter()
        out = self._finish_slots(fused, slots)
        timings = {"pack_s": t1 - t0, "launch_s": 0.0, "device_s": t2 - t1,
                   "wait_s": 0.0, "fetch_s": time.perf_counter() - t2}
        return _EraDispatch(self, slots, rlc, timings, result=(out, rlc))

    def _dispatch_card(self, stage, slots, y_points, rlc, s_pad, k_pad, t0):
        i = self.calls % self.MAX_INFLIGHT
        n_slot, n_share = self._grid.shape
        s_l, k_l = s_pad // n_slot, k_pad // n_share
        stage.pack()
        t1 = time.perf_counter()
        starts: dict = {}

        def on(dev):
            """This dispatch's stream on dev, its start event recorded at the
            device's first use."""
            stream = self._streams[dev][i]
            if dev not in starts:
                starts[dev] = torch.cuda.Event(enable_timing=True)
                starts[dev].record(stream)
            return torch.cuda.stream(stream)

        uploaded, outs = [], []
        for r in range(n_slot):
            row = []
            for c in range(n_share):
                dev = self._grid[r, c]
                with torch.cuda.stream(self._streams[dev][i]):
                    y = self._keys(dev, y_points, s_pad, k_pad, c)
                with on(dev):
                    buf = torch.empty((_STAGE_ROWS, s_l * k_l), dtype=torch.int32,
                                      device=dev)
                    buf.copy_(stage.pinned[r, c].view(_STAGE_ROWS, -1), non_blocking=True)
                    uploaded.append(torch.cuda.Event())
                    uploaded[-1].record()
                    # the share words, then the 4-bit digits, in range as
                    # glv.digits_col makes them
                    u = g1.mont_convert(buf[:_U_ROWS], into=True)
                    rlc16, lag1, lag2 = torch.split(buf[_U_ROWS:], [W64, W128, W128])
                    row.append(self._program(u, y, rlc16, lag1, lag2, k_l,
                                             digits_checked=True))
            outs.append(row)
        fused = self._join(outs, on)
        stage.uploaded = uploaded
        spans = []
        for dev, start in starts.items():  # the first device first
            last = torch.cuda.Event(enable_timing=True)
            last.record(self._streams[dev][i])
            spans.append((start, last))
        timings = {"pack_s": t1 - t0, "launch_s": time.perf_counter() - t1}
        return _EraDispatch(self, slots, rlc, timings, fused,
                            self._streams[self.device][i], spans)

    def _finish_slots(self, fused, slots) -> list:
        return _finish_g1_slots(fused, slots, self.device, self._backend)

    def run_era(self, slots, y_points, rng, masks=None):
        """slots: list of (u_list, lagrange_list) per ACS slot; y_points: the
        K verification keys. Returns (per-slot (u_agg, y_agg, combined)
        oracle points, rlc coefficients used). masks (optional): per-slot
        list of K bools; False lanes get a ZERO RLC coefficient, so an
        absent share (pass G1_INF for it) adds to neither aggregate."""
        return self._dispatch(slots, y_points, rng, masks)()


class GpuEraPipeline(_G1EraPipeline):
    """The era pipeline on the G1 kernels (ops/g1.py): the keys tiled to
    the lanes of a block, the device program g1.era_kernel_fused.

    `dispatch_era` is the async half of `run_era`, under the contract of
    the JAX package's MeshEraPipeline.dispatch_era (parallel/mesh.py:375-487):
    it draws the RLC coefficients, packs the era into a pinned host buffer,
    uploads it and launches the era's kernels on a CUDA stream of its own,
    and returns a call that blocks and finishes. At most MAX_INFLIGHT = 2
    dispatches may be unfinished (see _G1EraPipeline). A caller holding
    several eras (consensus/crypto_batcher.TpkeEraBatcher) so overlaps era
    e+1's host pack with era e's kernels, and era e's finish on the host
    with era e+1's kernels. Every tensor of one era is made, used and read
    on its own stream. A dispatch waits for the card only where a key set
    first meets a padded shape (its tiled keys upload once from pageable
    memory) and for the upload that last read its pinned buffer."""

    def _keys(self, dev, y_points, s_pad: int, k_pad: int, c: int):
        """Share block c's key columns (the keys padded with infinity to
        k_pad), tiled over a block's slots, on dev; made once per key set
        and shape and kept by identity (_KeyCache)."""
        n_slot, n_share = self._grid.shape
        s_l, k_l = s_pad // n_slot, k_pad // n_share
        return self._key_caches[dev].get(
            y_points,
            lambda: g1.g1_pack(_pad_keys(y_points, k_pad)[c * k_l:(c + 1) * k_l],
                               dev).repeat(1, s_l),
            (s_pad, k_pad, c))

    def _program(self, u, y, rlc16, lag1, lag2, k: int, digits_checked=False):
        return g1.era_kernel_fused(u, y, rlc16, lag1, lag2, k,
                                   digits_checked=digits_checked)

    def dispatch_era(self, slots, y_points, rng, masks=None) -> _EraDispatch:
        """slots: list of (u_list, lagrange_list) per ACS slot; y_points: the
        K verification keys. Returns a call giving (per-slot (u_agg, y_agg,
        combined) oracle points, rlc coefficients used); the coefficients
        are drawn here, so eras dispatched in order draw as the same run_era
        calls would.

        masks (optional): per-slot list of K bools; False lanes get a ZERO
        RLC coefficient, so an absent share (pass G1_INF for it) adds to
        neither aggregate."""
        return self._dispatch(slots, y_points, rng, masks)


class GlvEraPipeline(_G1EraPipeline):
    """The era pipeline on the fixed-base key tables (the JAX package's
    GlvEraPipeline, verify.py:144-231), synchronous like it: no dispatch_era,
    one stream, one pinned buffer a shape (MAX_INFLIGHT = 1).

    The verification keys Y_i are fixed for a validator set, so `y_device`
    makes their fixed-base tables d * 16^(15 - w) * Y_i once (one
    `g1_mont` into Montgomery form and one `g1_fixed_tables` launch) and
    keeps them for up to 4 key sets. Each era then runs GpuEraPipeline's
    marshal and upload (_G1EraPipeline) and the device program
    msm.glv_era_fused: one table build and one scan over [u | u | phi(u)]
    (3K lanes a slot), the fixed-base scan over the S*K_pad key lanes (no
    doubling), ONE tree reduce over the four groups and one fetch. A warm
    era launches g1_table 1, g1_msm_scan 1, g1_fixed_scan 1, g1_add
    log2(K_pad), g1_mont 3 (the share pack, phi's product by beta, the
    fetch); a key set's first era adds g1_fixed_tables 1 and g1_mont 1."""

    MAX_INFLIGHT = 1

    def y_device(self, y_points):
        """The fixed-base tables (16, 16, 3R, K_pad) of the K verification
        keys (padded with infinity to K_pad), made once per key set and
        cached. Keyed by id() with a strong reference to the key list and an
        `is` recheck, so a collected list can never alias a new validator
        set (verify.py:166-185); up to 4 sets stay cached."""
        k_pad = _pow2_at_least(len(y_points))
        return self._key_caches[self.device].get(y_points, lambda: msm.y_fixed_base_tables(
            g1.g1_pack(_pad_keys(y_points, k_pad), self.device)))

    def _keys(self, dev, y_points, s_pad: int, k_pad: int, c: int):
        return self.y_device(y_points)

    def _program(self, u, y, rlc16, lag1, lag2, k: int, digits_checked=False):
        return msm.glv_era_fused(u, y, rlc16, lag1, lag2, k,
                                 digits_checked=digits_checked)


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
        self._y_cache = _KeyCache(self.device)
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
        y = self._y_cache.get(
            y_points, lambda: g1.g1_pack(_pad_keys(y_points, k_pad), dev).repeat(1, s),
            (s, k_pad))
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
    The share group differs per subclass (`_share_msm`). It runs on the
    CPU and can stand behind `GpuBackend(device="cpu", pipeline=...)`
    (CPU tests of the consensus protocols, where the plain kernels' era
    would take seconds a flush); `last_timings` stays empty."""

    _share_msm = "g1_msm"
    device = torch.device("cpu")

    def __init__(self, backend=None):
        self._backend = backend or HostBackend()
        self.last_timings: dict = {}

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


# ---------------------------------------------------------------------------
# the bit-serial era steps (verify.py:32-83) and the per-batch verifier
# ---------------------------------------------------------------------------


def tpke_era_slots_step(u, y, rlc_bits, lagrange_bits):
    """The era's three MSMs per slot (tpke_era_slots_step, verify.py:54):
    u, y (3R, S, K) share points and their verification keys;
    rlc_bits / lagrange_bits (S, K, nbits) MSB-first bit rows (zero rows
    for shares outside the combine) on the same device -> (u_agg, y_agg,
    combined) each (3R, S), and their (3, S) infinity flags.

    One table build, one scan and one tree over the joined lanes [u | y |
    u] with digits [rlc | rlc | lag] (curve.bits_to_digits; the shorter
    behind leading zero windows), K padded to a power of two with flagged
    lanes. Infinity inputs get zero digits and the flags and Z = 0 mean
    what curve.g1_msm's do: a clear flag with Z = 0 marks an incomplete add
    that met p = +-q (GpuTpkeVerifier recomputes such a sum on the host)."""
    r3, s, k = u.shape
    k_pad = _pow2_at_least(k)
    rlc = curve.bits_to_digits(rlc_bits.reshape(s * k, -1))
    lag = curve.bits_to_digits(lagrange_bits.reshape(s * k, -1))

    def lanes(t):
        """(rows, S*K) -> (rows, S*K_pad): each slot padded with zero lanes."""
        rows = t.shape[0]
        return curve.pad_lanes(t.reshape(rows * s, k), k_pad).reshape(rows, s * k_pad)

    u2, y2 = u.reshape(r3, s * k), y.reshape(r3, s * k)
    digits = msm.joined_digits(*(lanes(curve.live_digits(p, d))
                                 for p, d in ((u2, rlc), (y2, rlc), (u2, lag))))
    joined = torch.cat([lanes(u2), lanes(y2), lanes(u2)], dim=1)
    acc, fl = g1.msm_scan(g1.build_table(joined), digits, digits_checked=True)
    out, ofl = g1.tree_reduce_k(acc, fl, k_pad)  # u_agg | y_agg | combined
    return out[:, :s], out[:, s:2 * s], out[:, 2 * s:], ofl.reshape(3, s)


def tpke_era_step(u, y, rlc_bits, lagrange_bits):
    """One batch's three MSMs (tpke_era_step, verify.py:32): u, y (3R, n),
    rlc_bits / lagrange_bits (n, nbits) -> (u_agg, y_agg, combined) each
    (3R,), and their (3,) infinity flags: tpke_era_slots_step with one
    slot."""
    u_agg, y_agg, comb, flags = tpke_era_slots_step(
        u[:, None], y[:, None], rlc_bits[None], lagrange_bits[None])
    return u_agg[:, 0], y_agg[:, 0], comb[:, 0], flags[:, 0]


class GpuTpkeVerifier:
    """The per-batch verify + combine (the JAX package's TpuTpkeVerifier,
    verify.py:452-498): marshals oracle shares to the card, runs
    tpke_era_step there, and finishes with 2 pairings on the host backend
    (the native library when it is None).

    The step's adds are incomplete, so an aggregate that comes back as
    infinity while some lane is live (a nonzero coefficient on a finite
    point: a repeated point, or p with -p) is recomputed by the host MSM
    and counted in ESCAPES["tpke_verifier"]; the reference's complete adds
    give that answer directly."""

    RLC_BITS, LAGRANGE_BITS = 128, 256  # verify.py:487-488

    def __init__(self, backend=None, device="cuda"):
        self.device = resolve_device(device)
        self._backend = backend or NativeBackend()

    def verify_and_combine(self, u_points, y_points, h_point, w_point, rlc,
                           lagrange):
        """Returns (all_valid, combined_point)."""
        n = len(u_points)
        if not n or not n == len(y_points) == len(rlc) == len(lagrange):
            raise ValueError("one share, key, RLC and Lagrange coefficient each, "
                             "at least one")
        size = _pow2_at_least(n)
        pad = size - n
        u_all = list(u_points) + [bls.G1_INF] * pad
        y_all = list(y_points) + [bls.G1_INF] * pad
        rlc_all = [c % (1 << self.RLC_BITS) for c in rlc] + [0] * pad
        lag_all = [c % (1 << self.LAGRANGE_BITS) for c in lagrange] + [0] * pad
        dev = self.device
        bits = [torch.from_numpy(curve.scalars_to_bits(v, nb)).to(dev)
                for v, nb in ((rlc_all, self.RLC_BITS), (lag_all, self.LAGRANGE_BITS))]
        u_agg, y_agg, comb, flags = tpke_era_step(
            g1.g1_pack(u_all, dev), g1.g1_pack(y_all, dev), *bits)
        fused = torch.cat([torch.stack([u_agg, y_agg, comb], dim=1),
                           flags.to(torch.int32)[None]], dim=0)
        rows, fl = g1.fetch(fused)  # ONE device->host copy
        aggs = g1.g1_unpack_host(rows, fl, dev.type == "cpu")
        for i, (pts, scalars) in enumerate(((u_all, rlc_all), (y_all, rlc_all),
                                            (u_all, lag_all))):
            live = any(c and not bls.g1_is_inf(p) for p, c in zip(pts, scalars))
            if bls.g1_is_inf(aggs[i]) and live:
                ESCAPES["tpke_verifier"] += 1
                aggs[i] = self._backend.g1_msm(pts, scalars)
        u_agg, y_agg, combined = aggs
        ok = self._backend.pairing_check(
            [(u_agg, h_point), (bls.g1_neg(y_agg), w_point)]
        )
        return ok, combined
