"""The port's device mesh against the JAX package's, host logic only.

The JAX side runs on its 8 forced CPU devices (tests/conftest.py) and
compiles nothing: its `MeshEraPipeline(n_devices=n)` is built as
tests/test_mesh.py:207 builds it, with the pure-Python backend. The port's
mesh is a list of devices, here `["cpu"] * n`.

* `make_era_mesh(n).shape` for n = 1..8 and `pad_pow2` over a grid equal
  the JAX ones; `make_mesh` is 1-D; asking for more devices than the list
  holds, or mixing the CPU with the card, raises.
* `padded_shape` equals JAX `MeshEraPipeline.padded_shape` on every mesh.
* `_EraStaging` re-cleans after a shrinking live region exactly where the
  JAX staging does, and leaves the live region as it was; its pack puts
  each block of the grid where its shard uploads from.
* `_LagDigitCache` planes equal JAX `glv_split` + `scalars_to_digits`,
  transposed, and hit by the row's values.
* `sharded_g1_msm` / `sharded_g2_msm` over 4 CPU shards (a shard of no
  live lane, a shard of no lane) and `sharded_era_step` over the 2x2 mesh
  equal the JAX `PythonBackend` MSMs, as affine points, and
  `sharded_glv_era_step` over the 2x2 mesh equals `msm.tpke_era_glv_kernel`
  on one device (the plain versions run here, ~15 s in all on one core).
* The pipeline's cross-shard sum (`_join`) keeps each row's live block
  and counts the partials that leave their shard.
* The rule of the backend's default pipeline and of RbcEraBatcher's mesh
  (`mesh_by_default`) for 0, 1 and 2 visible cards, and GpuBackend's use
  of it, over every card from the backend's own on; a mesh warmup dedupes
  the slot tiers by padded shape as the JAX warmup does, on a pipeline of
  the same kind and devices.
"""
from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.ops import msm as jmsm
from lachain_tpu.parallel import mesh as jmesh
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import gpu_backend
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.crypto.warmup import WarmupThread
from lachain_tpu_torch.ops import curve, g1, g2, msm
from lachain_tpu_torch.ops.verify import _STAGE_ROWS, _EraStaging, _LagDigitCache
from lachain_tpu_torch.parallel import mesh as mesh_module
from lachain_tpu_torch.parallel import mesh_by_default, mesh_unsupported_reason
from lachain_tpu_torch.parallel.mesh import (
    MeshEraPipeline,
    make_era_mesh,
    make_mesh,
    pad_pow2,
    sharded_era_step,
    sharded_g1_msm,
    sharded_g2_msm,
    sharded_glv_era_step,
)

pytestmark = pytest.mark.mesh

torch.set_num_threads(1)


def _points(rng, n):
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


def _jax_pipeline(n: int):
    return jmesh.MeshEraPipeline(backend=PythonBackend(), n_devices=n)


@pytest.mark.parametrize("n", range(1, 9))
def test_era_mesh_shape_equals_jax(n):
    assert len(jax.devices()) >= 8
    got, want = make_era_mesh(["cpu"] * n), jmesh.make_era_mesh(n)
    assert got.axis_names == tuple(want.axis_names) == ("slot", "share")
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    assert got.distinct() == [torch.device("cpu")]


def test_make_mesh_is_one_axis_and_checks_its_devices(monkeypatch):
    mesh = make_mesh(["cpu"] * 5, n_devices=3)
    assert mesh.axis_names == ("shares",) and mesh.shape == {"shares": 3}
    assert make_mesh(["cpu"] * 4, axis="cols").shape == {"cols": 4}
    with pytest.raises(ValueError):
        make_mesh(["cpu"] * 2, n_devices=3)
    with pytest.raises(ValueError):
        make_era_mesh([])
    monkeypatch.setattr(mesh_module, "resolve_device", torch.device)  # no card here
    with pytest.raises(ValueError, match="layouts"):
        make_mesh(["cpu", "cuda:0"])


def test_pad_pow2_equals_jax():
    for n in range(0, 70):
        for multiple in (1, 2, 3, 4, 8):
            assert pad_pow2(n, multiple) == jmesh.pad_pow2(n, multiple), (n, multiple)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_padded_shape_equals_jax(n):
    pipe, ref = MeshEraPipeline(HostBackend(), devices=["cpu"] * n), _jax_pipeline(n)
    assert pipe.n_devices == ref.n_devices == n
    for s in (1, 2, 3, 4, 5, 7, 16, 33, 64):
        for k in (1, 2, 3, 4, 5, 7, 9, 64, 100):
            assert pipe.padded_shape(s, k) == ref.padded_shape(s, k), (s, k)


def _inf_lanes_port(stage) -> np.ndarray:
    """(s_pad, k_pad) bool: lanes holding infinity and zero digits."""
    inf = (stage.u == stage._inf_col[:, None, None]).all(0)
    zero = ~(stage.rlc.any(0) | stage.lag1.any(0) | stage.lag2.any(0))
    return inf & zero


def _inf_lanes_jax(stage) -> np.ndarray:
    inf = (stage.u == stage._inf_row).all((2, 3))
    zero = ~(stage.rlc.any(2) | stage.lag1.any(2) | stage.lag2.any(2))
    return inf & zero


@pytest.mark.parametrize("steps", [[(4, 8), (2, 2)], [(4, 8), (4, 3), (1, 8)],
                                   [(3, 5), (4, 8), (2, 6)]])
def test_staging_recleans_like_jax(steps):
    """Fill the live region with garbage, then shrink it: the lanes each
    staging resets to filler are the JAX staging's, the live ones keep
    what was written."""
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * 8)
    port = _EraStaging(4, 8, pipe._inf_col)
    ref = _jax_pipeline(8)._get_staging(4, 8)
    assert _inf_lanes_port(port).all() and _inf_lanes_jax(ref).all()
    for s, k in steps:
        for st, u_live in ((port, port.u[:, :s, :k]), (ref, ref.u[:s, :k])):
            st.clean(s, k)
            u_live[...] = 7
            for plane in (st.rlc, st.lag1, st.lag2):
                (plane[:, :s, :k] if st is port else plane[:s, :k])[...] = 3
            if st is ref:
                st._filled = (s, k)
        lanes = _inf_lanes_port(port)
        assert np.array_equal(lanes, _inf_lanes_jax(ref)), (s, k)
        assert not lanes[:s, :k].any() and lanes.sum() == 4 * 8 - s * k
        assert (port.u[:, :s, :k] == 7).all() and (port.rlc[:, :s, :k] == 3).all()


def test_staging_packs_each_block_for_its_shard():
    """The card's pack: pinned[r, c] holds the grid's slots r * S_l.. and
    shares c * K_l.., the share words, then the RLC and the two GLV digit
    planes (here with a page-able buffer in place of the pinned one)."""
    inf = g1.plain_words(g1.g1_xyz([bls.G1_INF]))[:, 0]
    stage = _EraStaging(4, 8, inf)
    rng = np.random.default_rng(5)
    for plane in (stage.u, stage.rlc, stage.lag1, stage.lag2):
        plane[...] = rng.integers(0, 1 << 30, plane.shape, dtype=np.int32)
    stage.pinned = torch.empty((2, 2, _STAGE_ROWS, 2, 4), dtype=torch.int32)
    stage.pack()
    p = stage.pinned.numpy()
    for r in range(2):
        for c in range(2):
            want = np.concatenate([plane[:, 2 * r:2 * r + 2, 4 * c:4 * c + 4]
                                   for plane in (stage.u, stage.rlc, stage.lag1, stage.lag2)])
            assert np.array_equal(p[r, c], want), (r, c)


def test_lag_digit_cache_equals_jax():
    rng = random.Random(7)
    rows = [[rng.randrange(bls.R) for _ in range(5)], [0, 1, bls.R - 1, 2 ** 128, 3]]
    port, ref = _LagDigitCache(), _jax_pipeline(2)._lag_cache
    for row in rows:
        l1, l2 = port.get(row)
        r1, r2 = ref.get(row)
        assert l1.dtype == np.int32 and l1.shape == (jmsm.W128, len(row))
        assert np.array_equal(l1, r1.T) and np.array_equal(l2, r2.T)
        halves = [jmsm.glv_split(v) for v in row]
        assert np.array_equal(l1, jmsm.scalars_to_digits([h[0] for h in halves],
                                                         jmsm.W128).T)
        assert port.get(tuple(row))[0] is l1  # keyed by the values


def test_inf_column_is_the_packed_infinity():
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * 2)
    assert np.array_equal(pipe._inf_col, g1.g1_pack([bls.G1_INF], "cpu").numpy()[:, 0])


@pytest.mark.parametrize("n", [1, 2, 8])
def test_join_sums_each_row_and_counts_the_bytes_that_cross(n):
    """The pipeline's cross-shard sum on blocks whose partials are flagged
    but for share block 0's: each slot row keeps block (r, 0)'s partials
    exactly, laid out u_agg | y_agg | comb1 | comb2 over all S_pad slots;
    gather_mb adds the n_slot (n_share - 1) share blocks and n_slot - 1
    rows that leave their shard, 4 S_l lanes of 148 bytes each."""
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * n)
    n_slot, n_share = pipe.mesh.devices.shape
    s_l = 3
    rows = g1.g1_pack([bls.G1_GEN], "cpu").shape[0] + 1
    gen = torch.Generator().manual_seed(n)
    outs = []
    for _r in range(n_slot):
        row = []
        for c in range(n_share):
            out = torch.randint(0, 1 << 20, (rows, 4 * s_l), generator=gen)
            out[-1] = int(c > 0)
            row.append(out)
        outs.append(row)
    fused = pipe._join(outs, mesh_module._no_stream)
    want = torch.stack([row[0] for row in outs], dim=1)  # (rows, n_slot, 4 S_l)
    want = want.reshape(rows, n_slot, 4, s_l).transpose(1, 2).reshape(rows, -1)
    assert torch.equal(fused, want)
    lanes = (n_slot * (n_share - 1) + n_slot - 1) * 4 * s_l
    assert pipe.gather_mb == pytest.approx(lanes * 148 / 1e6)
    assert {1: 0, 2: 4 * s_l, 8: 7 * 4 * s_l}[n] == lanes


@pytest.mark.parametrize("count,meshed", [(0, False), (1, False), (2, True), (8, True)])
def test_default_pipeline_rule(count, meshed, monkeypatch):
    """mesh_by_default for `count` visible cards, and GpuBackend on a card
    (the device check and the pipelines stubbed) building a mesh pipeline
    over every card exactly where it holds."""
    assert mesh_by_default(count) is meshed
    assert (mesh_unsupported_reason(["cpu"] * count) is None) is meshed
    built = []

    class Stub:
        def __init__(self, *args, **kwargs):
            built.append((type(self).__name__, args, kwargs))
            self.device = torch.device("cuda", 0)

    class MeshStub(Stub):
        pass

    class SingleStub(Stub):
        pass

    monkeypatch.setattr(gpu_backend, "resolve_device", torch.device)  # no card here
    monkeypatch.setattr(gpu_backend.torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(gpu_backend.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(gpu_backend, "MeshEraPipeline", MeshStub)
    monkeypatch.setattr(gpu_backend, "GpuEraPipeline", SingleStub)
    monkeypatch.setattr(gpu_backend, "TsGpuEraPipeline", Stub)
    host = HostBackend()
    backend = GpuBackend(host_backend=host)
    kind = type(backend._pipeline).__name__
    assert kind == ("MeshStub" if meshed else "SingleStub")
    assert built[0][1][0] is host  # the escapes go to the host backend
    if meshed:  # every card, the backend's first
        cards = [torch.device("cuda", i) for i in range(count)]
        assert built[0][2] == {"devices": cards}
        built.clear()
        GpuBackend(device="cuda:1", host_backend=host)
        assert built[0][2] == {"devices": cards[1:] + cards[:1]}
    assert type(GpuBackend(device="cpu", host_backend=host)._pipeline).__name__ == "SingleStub"


def test_cpu_backend_takes_a_mesh_pipeline_on_its_device():
    pipe = MeshEraPipeline(HostBackend(), devices=["cpu"] * 8)
    backend = GpuBackend(device="cpu", host_backend=HostBackend(), pipeline=pipe)
    assert backend._pipeline is pipe and backend.era_dispatch_depth == 2


def test_mesh_warmup_dedupes_tiers_like_jax():
    """The JAX warmup keeps the first (largest) slot tier of each padded
    shape (warmup.py:65-83); the port's thread does so on a pipeline of its
    own of the same kind over the same devices."""
    backend = GpuBackend(device="cpu", host_backend=HostBackend(),
                         pipeline=MeshEraPipeline(HostBackend(), devices=["cpu"] * 8))
    t = WarmupThread(64, backend, None, include_ts=False)
    ref, want, seen = _jax_pipeline(8), [], set()
    for s in (64, 32, 16, 8, 4, 2, 1):
        if ref.padded_shape(s, 64) not in seen:
            seen.add(ref.padded_shape(s, 64))
            want.append(s)
    assert t.shapes == want == [64, 32, 16, 8, 4]
    pipe = t.backend._pipeline
    assert isinstance(pipe, MeshEraPipeline) and pipe is not backend._pipeline
    assert list(pipe.mesh.devices.flat) == list(backend._pipeline.mesh.devices.flat)


def _g1_point(pt, fl):
    rows, flags = g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None])
    return g1.g1_unpack_host(rows, flags, True)[0]


@pytest.mark.parametrize("n,dead", [(8, (2, 3)), (3, ())])
def test_sharded_g1_msm_equals_jax(n, dead):
    """n points over 4 shards: at n = 8 shard 1's two points are infinity
    (its partial is flagged), at n = 3 shard 0 has no lane."""
    rng = random.Random(0x61 + n)
    pts = _points(rng, n)
    for i in dead:
        pts[i] = bls.G1_INF
    scalars = [rng.randrange(1 << 64) for _ in range(n)]
    bits = torch.from_numpy(curve.scalars_to_bits(scalars, 64))
    pt, fl = sharded_g1_msm(make_mesh(["cpu"] * 4))(g1.g1_pack(pts, "cpu"), bits)
    assert tuple(pt.shape) == (g1.g1_pack([bls.G1_GEN], "cpu").shape[0],)
    assert not bool(fl)
    assert bls.g1_eq(_g1_point(pt, fl), PythonBackend().g1_msm(pts, scalars))


def test_sharded_g2_msm_equals_jax():
    rng = random.Random(0x62)
    pts = [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) for _ in range(5)]
    pts[4] = bls.G2_INF
    scalars = [rng.randrange(1 << 64) for _ in range(5)]
    bits = torch.from_numpy(curve.scalars_to_bits(scalars, 64))
    pt, fl = sharded_g2_msm(make_mesh(["cpu"] * 4))(g2.g2_pack(pts, "cpu"), bits)
    rows, flags = g1.fetch(torch.cat([pt, fl.to(pt.dtype)[None]])[:, None])
    got = g2.g2_unpack_host(rows, flags, True)[0]
    assert bls.g2_eq(got, PythonBackend().g2_msm(pts, scalars))


def test_sharded_era_step_equals_jax():
    """tpke_era_slots_step over the 2x2 mesh at S = 2, K = 4: per slot
    u_agg = sum rlc_j u_j, y_agg = sum rlc_j y_j, combined = sum lag_j u_j,
    against the JAX PythonBackend MSMs; slot 1's second share block has
    zero coefficients (a shard of no live lane)."""
    rng = random.Random(0x63)
    s, k = 2, 4
    u = [_points(rng, k) for _ in range(s)]
    y = _points(rng, k)
    rlc = [[rng.randrange(1, 1 << 64) for _ in range(k)] for _ in range(s)]
    lag = [[rng.randrange(1 << 128) for _ in range(k)] for _ in range(s)]
    rlc[1][2:] = [0, 0]
    lag[1][2:] = [0, 0]
    r3 = g1.g1_pack([bls.G1_GEN], "cpu").shape[0]
    pu = g1.g1_pack([p for row in u for p in row], "cpu").reshape(r3, s, k)
    py = g1.g1_pack(y * s, "cpu").reshape(r3, s, k)

    def bits(rows, nbits):
        flat = curve.scalars_to_bits([c for row in rows for c in row], nbits)
        return torch.from_numpy(flat).reshape(s, k, nbits)

    mesh = make_era_mesh(["cpu"] * 4)
    assert mesh.shape == {"slot": 2, "share": 2}
    u_agg, y_agg, comb, flags = sharded_era_step(mesh)(pu, py, bits(rlc, 64),
                                                       bits(lag, 128))
    assert tuple(flags.shape) == (3, s) and not flags.any()
    host = PythonBackend()
    for i in range(s):
        fused = torch.stack([u_agg[:, i], y_agg[:, i], comb[:, i]], dim=1)
        rows, fl = g1.fetch(torch.cat([fused, flags[:, i].to(fused.dtype)[None]]))
        got = g1.g1_unpack_host(rows, fl, True)
        assert bls.g1_eq(got[0], host.g1_msm(u[i], rlc[i]))
        assert bls.g1_eq(got[1], host.g1_msm(y, rlc[i]))
        assert bls.g1_eq(got[2], host.g1_msm(u[i], lag[i]))


def test_sharded_glv_era_step_equals_one_device():
    """msm.tpke_era_glv_kernel over the 2x2 mesh at S = 2, K = 4 against the
    same kernel on one device: every (slot, group) the same affine point and
    flag; slot 1's second share block has zero coefficients (a shard whose
    partials are all flagged) and slot 0 combines nothing (its comb flags
    set)."""
    rng = random.Random(0x64)
    s, k = 2, 4
    rlc = [rng.randrange(1, 1 << 64) for _ in range(s * k)]
    lag = [rng.randrange(bls.R) for _ in range(s * k)]
    rlc[6:8] = [0, 0]
    lag[6:8] = [0, 0]
    lag[0:4] = [0] * 4
    u = g1.g1_pack(_points(rng, s * k), "cpu")
    y = g1.g1_pack(_points(rng, k) * s, "cpu")
    digits = [torch.from_numpy(d) for d in msm.era_digits(rlc, lag)]
    got = sharded_glv_era_step(make_era_mesh(["cpu"] * 4))(u, y, *digits, k)
    want = msm.tpke_era_glv_kernel(u, y, *digits, k)
    for (pts, fl) in (got, want):
        assert tuple(pts.shape[1:]) == (s, 4) and tuple(fl.shape) == (s, 4)
    assert torch.equal(got[1], want[1]) and bool(got[1][0, 2]) and bool(got[1][0, 3])

    def points(pts, fl):
        cols = pts.reshape(pts.shape[0], s * 4).contiguous()
        return g1.g1_unpack_host(cols.numpy(), fl.reshape(-1).numpy(), True)

    assert all(bls.g1_eq(a, b) for a, b in zip(points(*got), points(*want)))
