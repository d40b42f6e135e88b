"""The port's mesh era pipeline vs the JAX package, on the CPU, at K = 4.

`MeshEraPipeline(devices=["cpu"] * n)` for n in {1, 2, 8} (the 1x1, 2x1 and
4x2 meshes) with s = 3 slots, two masked lanes on one slot (on the 4x2
mesh they fill one share block: a shard all masked) and, past s, a padded
slot, is held against the JAX package's `HostEraPipeline(PythonBackend())`
on an identically seeded rng (equal rlc rows, `g1_eq` on every (u_agg,
y_agg, combined)) and against the port's `GpuEraPipeline(device="cpu")`.
Two dispatches in flight, finished in order, equal run_era's draws and
sums. K = 7 (each slot padded to 8 lanes) is tests/test_torch_mesh_era7.py,
the sharded era step and MSMs tests/test_torch_mesh.py: the plain versions
take ~2-5 s an era here on one core, and each file stays near 30 s. Exact:
affine points mod p.
"""
from __future__ import annotations

import functools
import random

import pytest
import torch

from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.ops.verify import HostEraPipeline as JaxHostEraPipeline
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops.verify import ESCAPES, GpuEraPipeline, reset_escapes
from lachain_tpu_torch.parallel.mesh import MeshEraPipeline

pytestmark = pytest.mark.mesh

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

S = 3


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _points(rng, n):
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _era(k: int):
    """(y_points, slots, masks): slot 1 lacks its last two shares."""
    rng = random.Random(9000 + k)
    y_points = _points(rng, k)
    slots, masks = [], []
    for si in range(S):
        mask = [not (si == 1 and j >= k - 2) for j in range(k)]
        lag = [rng.randrange(1, bls.R) if m else 0 for m in mask]
        us = [p if m else bls.G1_INF for p, m in zip(_points(rng, k), mask)]
        slots.append((us, lag))
        masks.append(mask)
    return y_points, slots, masks


def _seed(k: int) -> int:
    return 0x5EED + k


@functools.lru_cache(maxsize=None)
def _jax_runs(k: int):
    """The JAX host pipeline's first two eras from one seeded rng."""
    y_points, slots, masks = _era(k)
    pipe, rng = JaxHostEraPipeline(PythonBackend()), SeededRng(_seed(k))
    return tuple(pipe.run_era(slots, y_points, rng, masks) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _mesh_run(n: int, k: int):
    y_points, slots, masks = _era(k)
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * n)
    reset_escapes()
    out = pipe.run_era(slots, y_points, SeededRng(_seed(k)), masks)
    assert not any(ESCAPES.values())
    assert pipe.calls == 1 and set(pipe.last_timings) == {
        "pack_s", "launch_s", "device_s", "wait_s", "fetch_s"}
    return out, pipe


def _assert_same(got, want):
    (g_out, g_rlc), (w_out, w_rlc) = got, want
    assert g_rlc == w_rlc
    assert len(g_out) == len(w_out) == S
    for s, (a, b) in enumerate(zip(g_out, w_out)):
        for name, x, y in zip(("u_agg", "y_agg", "combined"), a, b):
            assert bls.g1_eq(x, y), (s, name)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_era_equals_jax_host_pipeline(n, k=4):
    got, pipe = _mesh_run(n, k)
    _assert_same(got, _jax_runs(k)[0])
    n_slot, n_share = pipe.mesh.devices.shape
    s_pad, k_pad = pipe.padded_shape(S, k)
    assert pipe.pad_waste == pytest.approx(1 - S * k / (s_pad * k_pad))
    assert pipe.gather_mb == pytest.approx(
        (n_slot * (n_share - 1) + n_slot - 1) * (s_pad // n_slot) * 4 * 148 / 1e6)


def test_mesh_era_equals_single_pipeline(k=4):
    y_points, slots, masks = _era(k)
    want = GpuEraPipeline(HostBackend(), device="cpu").run_era(
        slots, y_points, SeededRng(_seed(k)), masks)
    for n in (1, 2, 8):
        _assert_same(_mesh_run(n, k)[0], want)


def test_two_dispatches_in_flight_equal_run_era():
    """Eras e and e+1 dispatched on one rng, then finished in order: the
    first equals run_era on that seed, the second the JAX pipeline's second
    era on the same rng; a third unfinished dispatch raises."""
    k = 4
    y_points, slots, masks = _era(k)
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * 2)
    rng = SeededRng(_seed(k))
    first = pipe.dispatch_era(slots, y_points, rng, masks)
    second = pipe.dispatch_era(slots, y_points, rng, masks)
    with pytest.raises(RuntimeError, match="unfinished"):
        pipe.dispatch_era(slots, y_points, rng, masks)
    got1, got2 = first(), second()
    assert first() is got1  # a finished dispatch returns its result again
    _assert_same(got1, _mesh_run(2, k)[0])
    _assert_same(got1, _jax_runs(k)[0])
    _assert_same(got2, _jax_runs(k)[1])
    assert pipe.calls == 2 and pipe._inflight == 0
