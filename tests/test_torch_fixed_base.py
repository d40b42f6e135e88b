"""The fixed-base kernels' plain versions, in the card's order, vs the host
and the JAX package, on the CPU.

`g1_ref.fixed_tables` runs `g1_fixed_tables`' order (one doubling chain a
key, then every window's table in log depth) and `g1_ref.fixed_scan`
`g1_fixed_scan`'s (the 16 windows split over 4 sub-lanes whose partials
meet in a fixed order). Both change Jacobian words, not points, so each is
held here to the host's scalar multiples and to the JAX package's
`msm.y_fixed_base_tables` / `msm.y_agg_fixed_base` as affine points:

* the tables at K=2 and K=3 (an infinity key, a pad column's, among
  them): every entry [w, d], d = 1..15, against d * 16^(15 - w) * Y_i and
  the JAX entry of the same window and digit;
* the scan over k_pad=4 key columns (3 keys and the pad column): every
  lane against the host's rlc * Y and its infinity flag, every slot's sum
  against the JAX aggregate; among the lanes an all-zero lane, sub-lanes
  whose windows are all zero between nonzero ones, a lane zero except in
  its last sub-lane, leading zero windows and the pad key column;
* the scan at every pattern of zero and nonzero sub-lanes (16 lanes), so
  that each combine meets a flagged left side, a flagged right side, both
  and neither.

The JAX tables are `msm.y_fixed_base_tables`' own chain with its two
steps, `_build_table` and `g1_dbl`, jitted once each (jitting the whole
function compiles for ~50 s; tests/test_torch_glv_tables.py runs it op
by op at K=2).
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.ops import msm as jmsm
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import g1, glv

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

K_PAD = 4
# S=3 slots x K_PAD lanes of 64-bit RLC coefficients; column 3 is the pad
# key's (infinity), whose coefficients are 0 as the era pipeline pads them
RLC = [
    0xABCD00000000_1234,  # sub-lanes 1, 2 zero between nonzero ones
    5,                    # 15 leading zero windows
    0,                    # an all-zero lane
    0,
    0x9ABC,               # zero except in its last sub-lane
    0x12345678_00000000,  # its last two sub-lanes zero
    (1 << 64) - 1,
    0,
]


def _point(co, n: int, j: int):
    return (co[j], co[n + j], co[2 * n + j])


@pytest.fixture(scope="module")
def keys():
    """Three keys and the pad column's infinity."""
    rng = random.Random(0xF1BA5E)
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(3)] + [bls.G1_INF]


@pytest.fixture(scope="module")
def jax_tables(keys):
    """msm.y_fixed_base_tables' chain over every key, its two steps jitted:
    (K, 16, 16, 3, L), windows MSB-first (msm.py:261-263)."""
    build, dbl = jax.jit(jmsm._build_table), jax.jit(jmsm.g1_dbl)
    rows, base = [], jnp.asarray(jmsm.g1_to_device_loose(keys))
    for w in range(jmsm.W64):
        rows.append(build(base))
        if w + 1 < jmsm.W64:
            for _ in range(jmsm.WINDOW):
                base = dbl(base)
    return np.asarray(jnp.stack(rows[::-1], axis=1))


@pytest.fixture(scope="module")
def scan_setup(keys):
    rng = random.Random(0x5CA1)
    rlc = RLC + [rng.randrange(1, 1 << 64) for _ in range(K_PAD - 1)] + [0]
    tables = g1.fixed_tables(g1.g1_pack(keys, "cpu"))
    digits = torch.from_numpy(glv.digits_col(rlc, glv.W64))
    return rlc, tables, digits


@pytest.mark.parametrize("cols", [(0, 1), (0, 3, 1)], ids=["K2", "K3_infinity"])
def test_tables_equal_host_multiples_and_jax(keys, jax_tables, cols):
    ys = [keys[c] for c in cols]
    k = len(ys)
    tables = g1.fixed_tables(g1.g1_pack(ys, "cpu"))
    assert tuple(tables.shape) == (glv.W64, glv.TABLE, 132, k)
    assert not tables[:, 0].any()  # entry 0: the zero point, never selected
    for w in range(glv.W64):
        jax_pts = jmsm.g1_from_device_loose(
            jax_tables[list(cols), w].reshape(k * glv.TABLE, 3, -1))  # key-major
        for d in range(1, glv.TABLE):
            co = g1.g1_coords(tables[w, d])
            for i, y in enumerate(ys):
                got = _point(co, k, i)
                if y == bls.G1_INF:
                    assert got[2] == 0, (w, d)  # Z = 0 all along
                    assert jax_pts[i * glv.TABLE + d][2] == 0
                    continue
                assert bls.g1_eq(got, bls.g1_mul(y, d * 16 ** (glv.W64 - 1 - w))), (w, d, i)
                assert bls.g1_eq(got, jax_pts[i * glv.TABLE + d]), (w, d, i)


@pytest.fixture(scope="module")
def jax_aggregates(jax_tables, scan_setup):
    rlc = scan_setup[0]
    slots = len(rlc) // K_PAD
    rlc64 = np.stack([jmsm.scalars_to_digits(rlc[s * K_PAD:(s + 1) * K_PAD], jmsm.W64)
                      for s in range(slots)])
    pts, flags = jax.jit(jmsm.y_agg_fixed_base)(jnp.asarray(jax_tables), jnp.asarray(rlc64))
    return jmsm.g1_from_device_loose(np.asarray(pts), np.asarray(flags))


def test_fixed_scan_equals_host_and_jax(keys, scan_setup, jax_aggregates):
    rlc, tables, digits = scan_setup
    n = len(rlc)
    acc, flags = g1.fixed_scan(tables, digits, K_PAD)
    co = g1.g1_coords(acc)
    lanes = []
    for j, c in enumerate(rlc):
        assert bool(flags[j]) == (c == 0), j
        lanes.append(bls.G1_INF if flags[j] else _point(co, n, j))
        if c:
            assert bls.g1_eq(lanes[j], bls.g1_mul(keys[j % K_PAD], c)), j
    for s, want in enumerate(jax_aggregates):
        got = bls.G1_INF
        for p in lanes[s * K_PAD:(s + 1) * K_PAD]:
            got = bls.g1_add(got, p)
        assert bls.g1_eq(got, want), s


def test_fixed_scan_every_sub_lane_pattern(keys, scan_setup):
    """Slot m's lanes have sub-lane q (windows 4q .. 4q + 3, MSB-first)
    nonzero iff bit q of m is set: all 16 patterns, over the 3 real keys."""
    tables = scan_setup[1]
    rng = random.Random(0x5B1A)
    rlc = []
    for m in range(16):  # slot m: its 3 key lanes at pattern m, the pad 0
        for col in range(K_PAD):
            c = 0
            for q in range(4):
                if m >> q & 1 and col < K_PAD - 1:
                    c |= rng.randrange(1, 1 << 16) << (16 * (3 - q))
            rlc.append(c)
    n = len(rlc)
    digits = torch.from_numpy(glv.digits_col(rlc, glv.W64))
    acc, flags = g1.fixed_scan(tables, digits, K_PAD)
    co = g1.g1_coords(acc)
    for j, c in enumerate(rlc):
        assert bool(flags[j]) == (c == 0), j
        if c:
            assert bls.g1_eq(_point(co, n, j), bls.g1_mul(keys[j % K_PAD], c)), j
