"""The port's mesh era pipeline vs the JAX package, on the CPU, at K = 7.

tests/test_torch_mesh_era.py's check with K = 7 shares a slot: each slot
padded to 8 lanes (a share block of 4 on the 4x2 mesh), s = 3 slots with
two masked lanes on one, and on the 4x2 mesh a fourth slot row all
padding. `MeshEraPipeline(devices=["cpu"] * n)` for n in {1, 2, 8} must
equal the JAX package's `HostEraPipeline(PythonBackend())` on an
identically seeded rng: equal rlc rows, `g1_eq` on every (u_agg, y_agg,
combined). Its own file because each era takes 7-10 s here on one core.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_mesh_era import _assert_same, _jax_runs, _mesh_run

pytestmark = pytest.mark.mesh

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_era_k7_equals_jax_host_pipeline(n):
    got, pipe = _mesh_run(n, 7)
    _assert_same(got, _jax_runs(7)[0])
    assert pipe.padded_shape(3, 7)[1] == 8
