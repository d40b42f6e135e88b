"""Single-controller device mesh for the batched crypto kernels.

The port of `lachain_tpu/parallel/mesh.py`. The reference shard_maps its era
kernel and MSMs over a `jax.sharding.Mesh`: one process makes one call,
`device_put` cuts the grid across the devices, and the partial point sums
meet in an `all_gather` and a replicated point-add tree. Here a `Mesh` is a
grid of torch devices and one host thread drives every shard: block (r, c)
of the work runs on `mesh.devices[r, c]` through the kernel wrappers of one
card (each launch on its tensor's own device, `ops/g1._run`), its partials
move to the first device of their row with `Tensor.to(..., non_blocking=
True)`, and the flagged tree of `g1.tree_reduce_k` (G2: `tree_reduce2_k`)
sums them there over the shards, padded to a power of two with flagged
lanes. That takes the place of `all_gather` + `g1_reduce_sum`: the same
points, summed in another order (compare them with `bls.g1_eq`). The adds
are incomplete, so two equal partials give Z = 0, which the era's combine
escape (`msm.combine_or_host_msm`) catches.

A device may appear more than once: `make_era_mesh(["cpu"] * 8)` is the 4x2
mesh of the JAX tests' 8 virtual CPU devices, and `[cuda:0] * 8` runs every
sharded code path on one card with the real kernels; only the copies
between devices are then no-ops.

  * `Mesh`, `make_mesh`, `make_era_mesh` (mesh.py:43, :89), `pad_pow2`
    (:184);
  * `sharded_g1_msm` / `sharded_g2_msm` (:51, :73): block i of the lanes
    through `curve.g1_msm` / `g2_msm` on device i;
  * `sharded_era_step` (:102) over `verify.tpke_era_slots_step` and
    `sharded_glv_era_step` (:145) over `msm.tpke_era_glv_kernel`: slots in
    blocks along 'slot', shares along 'share';
  * `MeshEraPipeline` (:258): GpuEraPipeline's dispatch on the mesh's
    blocks, and the cross-shard sum of its partials.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import curve, g1, g2, msm
from ..ops.verify import GpuEraPipeline, resolve_device, tpke_era_slots_step
from ..utils import metrics


class Mesh:
    """Devices on a grid with named axes, as `jax.sharding.Mesh` exposes
    one: `devices`, a numpy object array of torch.device (repeats allowed),
    `axis_names`, and `shape`, an ordered axis name -> size map."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device grid with axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def distinct(self) -> list:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))


def canonical_device(dev: torch.device) -> torch.device:
    """dev, with "cuda" read as the current CUDA device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def cards_from(device) -> list:
    """Every visible CUDA device, from `device`'s on and wrapping around:
    the devices of an entry point's default mesh, whose first device, where
    the partials meet, is the entry point's own."""
    count = torch.cuda.device_count()
    first = canonical_device(torch.device(device)).index
    return [torch.device("cuda", (first + i) % count) for i in range(count)]


def _device_list(devices=None, n_devices: Optional[int] = None) -> list:
    """The mesh's devices: `devices` as given (repeats allowed), by default
    every visible CUDA device; the first `n_devices` of them where given.
    No card raises, as asking for more devices than the list holds does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh over the visible CUDA devices, but torch.cuda.is_available() "
                "is False; pass devices (e.g. ['cpu'] * 8) to build one on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [canonical_device(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"{n_devices} devices asked of a list of {len(devs)}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError("a mesh's devices must all be CUDA or all the CPU: "
                         "the two keep points in different layouts")
    return devs


def _grid(devs: list, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(devices=None, n_devices: Optional[int] = None, axis: str = "shares") -> Mesh:
    """1-D mesh over the share / column axis (mesh.py:43)."""
    devs = _device_list(devices, n_devices)
    return Mesh(_grid(devs, (len(devs),)), (axis,))


def make_era_mesh(devices_or_n=None) -> Mesh:
    """2-D ('slot', 'share') mesh for the era (mesh.py:89): 'slot' data
    parallel over ACS slots, 'share' over the shares within a slot; (n // 2,
    2) for an even n >= 4, else (n, 1). `devices_or_n`: a device list, or
    the number of visible CUDA devices to take (None: all)."""
    if isinstance(devices_or_n, int):
        devs = _device_list(None, devices_or_n)
    else:
        devs = _device_list(devices_or_n)
    n = len(devs)
    shape = (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)
    return Mesh(_grid(devs, shape), ("slot", "share"))


def pad_pow2(n: int, multiple: int) -> int:
    """Smallest power of two >= n that is divisible by `multiple`."""
    size = max(multiple, 1)
    while size < n or size % multiple:
        size *= 2
    return size


def _bounds(n: int, parts: int) -> list:
    """[(begin, end)] of `parts` contiguous blocks of n, as even as can be
    (a block is empty where n < parts)."""
    return [(n * i // parts, n * (i + 1) // parts) for i in range(parts)]


def _no_stream(_dev):
    return contextlib.nullcontext()


def _flagged_sum(parts, dev, reduce, on=_no_stream):
    """Lane-wise flagged sum of the partials `parts` [((R, m) points, (m,)
    flags)], each on its shard's device -> ((R, m), (m,) bool) on `dev`:
    each part moves to dev, the parts' lane j lie adjacent, padded to a
    power of two with flagged lanes, and `reduce` (g1.tree_reduce_k / g2.
    tree_reduce2_k) sums every group. A flag is set where it is nonzero.
    `on(device)` gives the context of work on a device (a pipeline's
    stream there); a move runs in both devices'."""
    n = len(parts)
    n_pad = pad_pow2(n, 1)
    with on(dev):
        pts, fls = [], []
        for p, f in parts:
            with on(p.device):
                pts.append(p.to(dev, non_blocking=True))
                fls.append(f.to(dev, non_blocking=True))
        pts += [torch.zeros_like(pts[0])] * (n_pad - n)
        fls += [torch.ones_like(fls[0])] * (n_pad - n)
        r, m = pts[0].shape
        return reduce(torch.stack(pts, dim=-1).reshape(r, m * n_pad),
                      torch.stack(fls, dim=-1).reshape(m * n_pad).bool(), n_pad)


def _sum_rows(grid: np.ndarray, parts, on=_no_stream):
    """parts[r][c]: block (r, c)'s partials ((3R, m) points, (m,) flags) on
    grid[r, c]. Per slot row, their flagged sum over the share blocks on
    the row's first device, the rows then joined along the lanes on the
    grid's first device -> ((3R, n_slot * m), (n_slot * m,) bool)."""
    dev0 = grid[0, 0]
    rows = [_flagged_sum(row, grid[r, 0], g1.tree_reduce_k, on)
            for r, row in enumerate(parts)]
    with on(dev0):
        moved = []
        for p, f in rows:
            with on(p.device):
                moved.append((p.to(dev0, non_blocking=True), f.to(dev0, non_blocking=True)))
        return (torch.cat([p for p, _ in moved], dim=1),
                torch.cat([f for _, f in moved]))


def _sharded_msm(mesh: Mesh, local, reduce):
    devs = list(mesh.devices.flat)

    def msm_fn(points, bits):
        n = points.shape[-1]
        if n < 1 or bits.shape[0] != n:
            raise ValueError(f"one bit row per point, at least one: {n} points, "
                             f"{bits.shape[0]} rows")
        parts = []
        for dev, (a, b) in zip(devs, _bounds(n, len(devs))):
            if a < b:  # a block with no lanes adds nothing
                pt, fl = local(points[:, a:b].contiguous().to(dev), bits[a:b].to(dev))
                parts.append((pt[:, None], fl[None]))
        acc, fl = _flagged_sum(parts, devs[0], reduce)
        return acc[:, 0], fl[0]

    return msm_fn


def sharded_g1_msm(mesh: Mesh):
    """sum_i s_i P_i over the mesh (mesh.py:51) -> a call taking the full
    (3R, n) G1 point columns and (n, nbits) MSB-first bits: block i of the
    lanes runs `curve.g1_msm` on the mesh's device i (in grid order), and
    the (point, flag) partials are summed on the first device. Returns
    curve.g1_msm's ((3R,) point, () infinity flag) there."""
    return _sharded_msm(mesh, curve.g1_msm, g1.tree_reduce_k)


def sharded_g2_msm(mesh: Mesh):
    """sharded_g1_msm over G2 (mesh.py:73): (P, n) columns, `curve.g2_msm`
    a block, -> ((P,) point, () flag)."""
    return _sharded_msm(mesh, curve.g2_msm, g2.tree_reduce2_k)


def _blocks(mesh: Mesh, s: int, k: int):
    n_slot, n_share = mesh.shape["slot"], mesh.shape["share"]
    if s % n_slot or k % n_share:
        raise ValueError(f"{s} slots x {k} shares do not cut into the mesh's "
                         f"{n_slot} x {n_share} blocks")
    return s // n_slot, k // n_share


def _blocks_of(mesh: Mesh, shard) -> list:
    """shard(r, c, device) of every block, a list of slot rows."""
    n_slot, n_share = mesh.devices.shape
    return [[shard(r, c, mesh.devices[r, c]) for c in range(n_share)]
            for r in range(n_slot)]


def sharded_era_step(mesh: Mesh):
    """`verify.tpke_era_slots_step` over a ('slot', 'share') mesh
    (mesh.py:102) -> a call with its arguments, u, y (3R, S, K) and bits
    (S, K, nbits), S and K divisible by the mesh's axes: block (r, c) of
    slots and shares runs the step on its device, and each row's partials
    are summed over 'share' on the row's first device. Returns the step's
    (u_agg, y_agg, combined) (3R, S) and (3, S) flags on the mesh's first
    device."""
    n_slot = mesh.shape["slot"]

    def step(u, y, rlc_bits, lagrange_bits):
        r3, s, k = u.shape
        s_l, k_l = _blocks(mesh, s, k)

        def shard(r, c, dev):
            def cut(t, axis):  # the slot axis; the share axis follows it
                block = t.narrow(axis, r * s_l, s_l).narrow(axis + 1, c * k_l, k_l)
                return block.contiguous().to(dev)

            ua, ya, comb, fl = tpke_era_slots_step(cut(u, 1), cut(y, 1),
                                                   cut(rlc_bits, 0), cut(lagrange_bits, 0))
            return torch.cat([ua, ya, comb], dim=1), fl.reshape(-1)

        pts, fl = _sum_rows(mesh.devices, _blocks_of(mesh, shard))  # lanes: row, u | y | comb, slot
        pts = pts.reshape(r3, n_slot, 3, s_l).transpose(1, 2).reshape(r3, 3, s)
        fl = fl.reshape(n_slot, 3, s_l).transpose(0, 1).reshape(3, s)
        return pts[:, 0], pts[:, 1], pts[:, 2], fl

    return step


def sharded_glv_era_step(mesh: Mesh):
    """`msm.tpke_era_glv_kernel` over a ('slot', 'share') mesh (mesh.py:145)
    -> a call with its arguments, u, y (3R, S*K) slot-major lanes, rlc16
    (16, S*K), lag1 / lag2 (32, S*K) and K, with S and K divisible by the
    mesh's axes and K / n_share a power of two: block (r, c) runs the
    4K-lane kernel on its device, and each row's (S_l, 4) partials are
    summed over 'share' on the row's first device. Returns the kernel's
    ((3R, S, 4) points, (S, 4) flags) on the mesh's first device."""

    def step(u, y, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
        r3, n = u.shape
        s = n // k
        s_l, k_l = _blocks(mesh, s, k)

        def shard(r, c, dev):
            def cut(t):
                block = t.reshape(t.shape[0], s, k)[:, r * s_l:(r + 1) * s_l,
                                                    c * k_l:(c + 1) * k_l]
                return block.reshape(t.shape[0], -1).to(dev)

            pts, fl = msm.tpke_era_glv_kernel(*(cut(t) for t in (u, y, rlc16, lag1, lag2)),
                                              k_l, digits_checked)
            return pts.reshape(r3, -1), fl.reshape(-1)  # lane slot * 4 + group

        pts, fl = _sum_rows(mesh.devices, _blocks_of(mesh, shard))
        return pts.reshape(r3, s, 4), fl.reshape(s, 4)

    return step


class MeshEraPipeline(GpuEraPipeline):
    """The era pipeline over a ('slot', 'share') mesh (mesh.py:258):
    GpuEraPipeline's dispatch (ops/verify._G1EraPipeline) on a grid of
    blocks. Block (r, c), slots r * S_l.. and shares c * K_l.., runs the
    era kernel (g1.era_kernel, the work of msm.tpke_era_glv_kernel) on
    mesh.devices[r, c]; each slot row's partials are summed over 'share' on
    the row's first device and the rows joined on the mesh's first device
    (`_join`).

    `run_era(slots, y_points, rng, masks)` and `dispatch_era` keep
    GpuEraPipeline's contract. A dispatch draws the RLC coefficients over
    all S x K lanes in the synchronous order before any block is cut, fills
    double-buffered staging for the padded shape (`padded_shape`: k_pad =
    pad_pow2(k, n_share), s_pad a multiple of n_slot), and on the card
    packs each block into its pinned buffer and uploads it to its device.
    Each block's key columns are made once per key set and shape and kept
    by identity on its device. Each distinct device has a stream for each
    of the MAX_INFLIGHT = 2 dispatches that may be unfinished; the returned
    call waits for every device's last event. `devices`: a list (repeats
    allowed), by default every visible CUDA device.

    `calls`, `n_devices`, `pad_waste` (of the last dispatch),
    `device_busy_s` (the finished eras' device phases summed) and
    `gather_mb` (the partials that crossed shards, summed: see `_join`)
    count beside the reference's gauges `mesh_devices` and
    `mesh_pad_waste_fraction`, set at each dispatch; the reference's spans
    (`mesh.marshal`, `mesh.device`, `wait("device")`, mesh.py:401-467) are
    the shared dispatch's (ops/verify._G1EraPipeline). `last_timings` holds
    the phases of the era finished last in _EraDispatch's keys."""

    def __init__(self, backend=None, devices=None):
        self.mesh = make_era_mesh(devices)
        super().__init__(backend, grid=self.mesh.devices)
        self.n_devices = int(self.mesh.devices.size)
        self.device_busy_s = 0.0
        self.gather_mb = 0.0

    def _dispatch(self, slots, y_points, rng, masks=None):
        dispatch = super()._dispatch(slots, y_points, rng, masks)
        metrics.set_gauge("mesh_devices", self.n_devices)
        metrics.set_gauge("mesh_pad_waste_fraction", round(self.pad_waste, 4))
        return dispatch

    def padded_shape(self, s: int, k: int) -> tuple:
        """(s_pad, k_pad) the mesh runs for a live (s, k) era grid; the
        warmup dedupes slot tiers that fall on one."""
        n_slot, n_share = self.mesh.shape["slot"], self.mesh.shape["share"]
        return -(-s // n_slot) * n_slot, pad_pow2(k, n_share)

    def _release(self, dispatch) -> None:
        super()._release(dispatch)
        self.device_busy_s += dispatch.timings.get("device_s", 0.0)

    def _join(self, outs, on):
        """The blocks' fused (3R + 1, 4 S_l) outputs, flags in the last row
        -> the era's (3R + 1, 4 S_pad) on the first device: per slot row the
        flagged sum over 'share', the rows then joined (_sum_rows) and laid
        out u_agg | y_agg | comb1 | comb2 over all slots. `gather_mb` adds
        the partials that leave their shard: the n_slot (n_share - 1) share
        blocks summed into their row's first block and the n_slot - 1 rows
        joined to the first, each of 4 S_l lanes of 3 x 12 int32 words and
        a flag word (the card's layout, 148 bytes a lane)."""
        n_slot, n_share = self.mesh.devices.shape
        pts, fl = _sum_rows(self.mesh.devices,
                            [[(o[:-1], o[-1]) for o in row] for row in outs], on)
        r3, m = pts.shape[0], pts.shape[1] // n_slot  # m = 4 S_l
        with on(self.device):
            pts = pts.reshape(r3, n_slot, 4, m // 4).transpose(1, 2).reshape(r3, -1)
            fl = fl.reshape(n_slot, 4, m // 4).transpose(0, 1).reshape(1, -1)
            fused = torch.cat([pts, fl.to(pts.dtype)], dim=0)
        lanes = (n_slot * (n_share - 1) + n_slot - 1) * m
        self.gather_mb += lanes * (3 * g1.NL + 1) * 4 / 1e6
        return fused
