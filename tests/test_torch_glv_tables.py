"""The fixed-base key tables and their scan vs the JAX package, on the CPU.

* `msm.y_fixed_base_tables` (the port's, over `g1.fixed_tables`' plain
  version) at K=2: every entry [w, d], d = 1..15, must equal the host's
  d * 16^(15 - w) * Y_i and the JAX function's entry of the same window
  and digit (the JAX tables reversed to MSB-first windows,
  msm.py:261-263), as affine points. An off-by-reverse error still gives
  valid points, so each entry is held to the host's multiple, not only the
  scan's output.
* `g1.fixed_scan` (plain) at S=2, K=3 over k_pad=4 key columns against the
  host's rlc * Y per lane: a zero digit in the middle, leading zero
  windows, an all-zero lane and the pad key column must come back as the
  host's points and infinity flags.

The JAX function runs op by op (jitting it compiles for ~50 s at K=3);
it is called once, in a module fixture.
"""
from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.ops import msm as jmsm
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import g1, glv, msm

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _col(pts, flags, j: int):
    """Lane j of (3R, n) plain points (+ flags) as an oracle point."""
    n = pts.shape[-1]
    co = g1.g1_coords(pts)
    if flags is not None and bool(flags[j]):
        return bls.G1_INF
    return (co[j], co[n + j], co[2 * n + j])


@pytest.fixture(scope="module")
def keys():
    rng = random.Random(0x7AB1E5)
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_tables(keys):
    tables = jmsm.y_fixed_base_tables(jnp.asarray(jmsm.g1_to_device_loose(keys)))
    return np.asarray(tables)  # (K, 16, 16, 3, L)


def test_tables_equal_host_multiples_and_jax(keys, jax_tables):
    k = len(keys)
    tables = msm.y_fixed_base_tables(g1.g1_pack(keys, "cpu"))
    assert tuple(tables.shape) == (glv.W64, glv.TABLE, 132, k)
    assert jax_tables.shape[:3] == (k, glv.W64, glv.TABLE)
    for w in range(glv.W64):
        jax_pts = jmsm.g1_from_device_loose(
            jax_tables[:, w].reshape(k * glv.TABLE, 3, -1))  # i-major
        for d in range(1, glv.TABLE):
            co = g1.g1_coords(tables[w, d])
            for i, y in enumerate(keys):
                got = (co[i], co[k + i], co[2 * k + i])
                assert bls.g1_eq(got, bls.g1_mul(y, d * 16 ** (glv.W64 - 1 - w))), (w, d, i)
                assert bls.g1_eq(got, jax_pts[i * glv.TABLE + d]), (w, d, i)


def test_fixed_scan_equals_host_per_lane(keys):
    rng = random.Random(0x5CA7)
    ys = keys + [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))]
    k, k_pad = len(ys), 4
    tables = g1.fixed_tables(g1.g1_pack(ys + [bls.G1_INF], "cpu"))
    rlc = [rng.randrange(1, 1 << 64) for _ in range(2 * k_pad)]
    rlc[0] = 0x1000000000000001  # zero digits between two nonzero ones
    rlc[1] = 5  # 15 leading zero windows
    rlc[2] = 0  # an all-zero lane
    rlc[k_pad - 1] = rlc[2 * k_pad - 1] = 0  # the pad key column
    rlc[k_pad + 2] = (1 << 64) - 1
    digits = torch.from_numpy(glv.digits_col(rlc, glv.W64))
    acc, flags = g1.fixed_scan(tables, digits, k_pad)
    for j, c in enumerate(rlc):
        assert bool(flags[j]) == (c == 0)
        if c:
            want = bls.g1_mul(ys[j % k_pad], c)
            assert bls.g1_eq(_col(acc, flags, j), want), j
    # y_agg_fixed_base: the scan, then the flagged tree over k_pad lanes
    pts, fl = msm.y_agg_fixed_base(tables, digits, k_pad)
    for s in range(2):
        row = rlc[s * k_pad:(s + 1) * k_pad]
        want = bls.G1_INF
        for y, c in zip(ys, row):
            want = bls.g1_add(want, bls.g1_mul(y, c))
        assert bls.g1_eq(_col(pts, fl, s), want)
