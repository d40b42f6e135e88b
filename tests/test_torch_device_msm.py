"""The port's device MSM routes (`GpuBackend.g1_msm` / `g2_msm` over
`g1.msm_reduce` / `g2.msm2_reduce`) vs the JAX package, on the CPU.

64 windows of the full scalar mod r, n padded to a power of two with
infinity: on points made by the JAX package's `bls12381`, the sum must
equal `lachain_tpu.crypto.provider.PythonBackend`'s MSM (and the JAX
package's own products) for infinity inputs with nonzero scalars, zero and
full-width scalars, scalars above r, n = 5 (not a power of two), n = 0 and
n = 1, with no recompute on the host (`verify.ESCAPES` stays 0). A sum that
the card returns as infinity (a repeated input, whose equal partial sums
collide in the incomplete add, or a true zero sum) is recomputed by the
host and counted. The comparison is exact.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.ops import verify

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

GROUPS = {
    "g1": (jbls.G1_GEN, jbls.g1_mul, jbls.G1_INF, jbls.g1_eq, "g1_msm"),
    "g2": (jbls.G2_GEN, jbls.g2_mul, jbls.G2_INF, jbls.g2_eq, "g2_msm"),
}


@pytest.fixture(scope="module")
def backend():
    return GpuBackend(device="cpu")


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_device_msm_equals_host(backend, group):
    gen, mul, inf, eq, name = GROUPS[group]
    rng = random.Random(0xD3 + len(group))
    pts = [mul(gen, rng.randrange(1, jbls.R)) for _ in range(4)] + [inf]
    scalars = [jbls.R - 1, 0, rng.randrange(jbls.R), jbls.R + 12345, 7]
    device, oracle = getattr(backend, name), getattr(PythonBackend(), name)
    verify.reset_escapes()
    assert eq(device(pts, scalars), oracle(pts, scalars))
    assert eq(device([], []), inf)
    assert eq(device([pts[1]], [5]), mul(pts[1], 5))  # one lane, no tree
    assert verify.ESCAPES == dict.fromkeys(verify.ESCAPES, 0)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_device_msm_collision_is_counted(backend, group):
    """A repeated input: the tree adds P + P, which the incomplete add
    cannot; the sum comes back as infinity, the host recomputes it, and
    `ESCAPES` counts that recompute. A true zero sum P + (-P) also comes
    back as infinity: the card cannot tell it from a collision, so the host
    confirms it, and that is counted too."""
    gen, mul, inf, eq, name = GROUPS[group]
    p = mul(gen, random.Random(0xC011 + len(group)).randrange(1, jbls.R))
    device, oracle = getattr(backend, name), getattr(PythonBackend(), name)
    verify.reset_escapes()
    got = device([p, p], [3, 3])
    assert eq(got, mul(p, 6)) and eq(got, oracle([p, p], [3, 3]))
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), **{name: 1})
    assert eq(device([p, p], [1, jbls.R - 1]), inf)
    assert verify.ESCAPES[name] == 2
