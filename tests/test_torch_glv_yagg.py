"""`msm.y_agg_fixed_base` vs the JAX package's, on the CPU.

At S=2 slots and K=3 keys (k_pad=4: one pad key column), the JAX tables
are made by `msm.y_fixed_base_tables`' own chain (msm.py:246-263) with its
two steps, `_build_table` and `g1_dbl`, jitted once each (jitting the whole
function compiles for ~50 s; tests/test_torch_glv_tables.py holds it op by
op at K=2). `jax.jit(msm.y_agg_fixed_base)` sums them per slot; the port's
`y_agg_fixed_base` is fed the same tables, carried into its layout, and its
own `y_fixed_base_tables`: every slot's aggregate must be the JAX one as an
affine point, with the same infinity flag (one slot has a zero RLC
coefficient on a key, one key has an all-zero-digit lane).
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
from lachain_tpu_torch.ops import g1, g1_ref, glv, msm

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _jax_tables(y_dev):
    """msm.y_fixed_base_tables' chain, its two steps jitted."""
    build, dbl = jax.jit(jmsm._build_table), jax.jit(jmsm.g1_dbl)
    rows, base = [], y_dev
    for w in range(jmsm.W64):
        rows.append(build(base))
        if w + 1 < jmsm.W64:
            for _ in range(jmsm.WINDOW):
                base = dbl(base)
    return jnp.stack(rows[::-1], axis=1)


def _port_layout(jtables, k_pad: int):
    """JAX (K, 16, 16, 3, L) tables -> the port's plain (16, 16, 132,
    k_pad), the pad columns infinity."""
    k = jtables.shape[0]
    a = np.asarray(jtables).transpose(1, 2, 0, 3, 4)  # (16, 16, K, 3, L)
    pts = jmsm.g1_from_device_loose(a.reshape(-1, 3, a.shape[-1]))
    out = []
    for e in range(glv.W64 * glv.TABLE):
        col = pts[e * k:(e + 1) * k] + [bls.G1_INF] * (k_pad - k)
        out.append(torch.from_numpy(g1_ref.points_to_limbs(col)))
    return torch.stack(out).reshape(glv.W64, glv.TABLE, 132, k_pad)


def test_y_agg_fixed_base_equals_jax():
    rng = random.Random(0x7A66)
    s, k, k_pad = 2, 3, 4
    keys = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(k)]
    rlc = [[rng.randrange(1, 1 << 64) for _ in range(k)] for _ in range(s)]
    rlc[0][2] = 0  # an absent share
    rlc[1][0] = 0xF0000000000000F  # zero digits inside the coefficient

    jtables = _jax_tables(jnp.asarray(jmsm.g1_to_device_loose(keys)))
    rlc64 = np.stack([jmsm.scalars_to_digits(row, jmsm.W64) for row in rlc])
    jpts, jflags = jax.jit(jmsm.y_agg_fixed_base)(jtables, jnp.asarray(rlc64))
    want = jmsm.g1_from_device_loose(np.asarray(jpts), np.asarray(jflags))

    digits = torch.from_numpy(glv.digits_col(
        [c for row in rlc for c in row + [0] * (k_pad - k)], glv.W64))
    own = msm.y_fixed_base_tables(g1.g1_pack(keys + [bls.G1_INF], "cpu"))
    for tables in (_port_layout(jtables, k_pad), own):
        pts, flags = msm.y_agg_fixed_base(tables, digits, k_pad)
        got = g1.g1_unpack_host(pts.numpy(), flags.numpy(), True)
        assert flags.tolist() == np.asarray(jflags).tolist()
        for i in range(s):
            assert bls.g1_eq(got[i], want[i]), i
            host = bls.G1_INF
            for y, c in zip(keys, rlc[i]):
                host = bls.g1_add(host, bls.g1_mul(y, c))
            assert bls.g1_eq(got[i], host), i
