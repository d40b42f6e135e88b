"""The G2 scan and MSM composites of the port (ops/g2.py) vs pg2's, on the
CPU.

`msm2_windowed` (table build + the 16-entry windowed scan, pg2
`_msm2_kernel`'s keep/flag rules) and `msm2_reduce` (plus the tree reduce)
run over the kernels' plain versions here and must equal pg2's outputs limb
for limb, flags included, at the shapes of tests/test_pg2.py:83-97 (n=8,
4 windows of 16-bit scalars): a zero lane comes back flagged, a lane with
leading zero windows does not. Each pg2 call runs once per module: its
interpret-mode emulation takes seconds per call. The tolerance is exact.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.ops import pg1, pg2
from lachain_tpu_torch.ops import g1, g2

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _unpack(arr, flags=None) -> list:
    """Decode as the pipelines do: one fused buffer (flag row last) through
    `g1.fetch`, then `g2.g2_unpack_host`."""
    if flags is None:
        flags = torch.zeros(arr.shape[-1], dtype=torch.bool)
    rows, fl = g1.fetch(torch.cat([arr, flags.to(arr)[None, :]]))
    return g2.g2_unpack_host(rows, fl, arr.device.type == "cpu")


@pytest.fixture(scope="module")
def case():
    rng = random.Random(0x4D32)
    n = 8
    pts = [jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, jbls.R)) for _ in range(n)]
    pts[6] = jbls.G2_INF  # a padding lane: infinity with a zero scalar
    scalars = [rng.randrange(1, 1 << 16) for _ in range(n)]
    scalars[2] = scalars[6] = 0  # zero lanes come back flagged
    scalars[5] = 9  # leading zero windows
    return pts, scalars, pg1.digits_col(scalars, 4)


def test_msm2_windowed_vs_pg2(case):
    pts, scalars, dig = case
    want_acc, want_fl = pg2.msm2_windowed(
        jnp.asarray(pg2.g2_pack(pts)), jnp.asarray(dig)
    )
    acc, fl = g2.msm2_windowed(g2.g2_pack(pts, "cpu"), torch.from_numpy(dig))
    assert (acc.numpy() == np.asarray(want_acc)).all()
    assert (fl.numpy() == np.asarray(want_fl)).all()
    got = _unpack(acc, fl)
    for i, (p, s) in enumerate(zip(pts, scalars)):
        assert jbls.g2_eq(got[i], jbls.g2_mul(p, s)), i
    assert fl.tolist() == [i in (2, 6) for i in range(len(pts))]


def test_msm2_reduce_vs_pg2(case):
    pts, scalars, dig = case
    want = np.asarray(
        pg2.msm2_reduce(jnp.asarray(pg2.g2_pack(pts)), jnp.asarray(dig), 4)
    )
    got = g2.msm2_reduce(g2.g2_pack(pts, "cpu"), torch.from_numpy(dig), 4)
    assert got.shape == (289, 2)
    assert (got.numpy() == want).all()
    rows, flags = g1.fetch(got)  # as the MSM route decodes it
    sums = g2.g2_unpack_host(rows, flags, cpu_layout=True)
    for grp in range(2):
        want_pt = jbls.G2_INF
        for i in range(4 * grp, 4 * grp + 4):
            want_pt = jbls.g2_add(want_pt, jbls.g2_mul(pts[i], scalars[i]))
        assert jbls.g2_eq(sums[grp], want_pt)
