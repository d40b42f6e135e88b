"""`GpuTpkeVerifier` vs the JAX package's `TpuTpkeVerifier`, on the CPU.

* At n=3 (padded to 4) on JAX-dealt TPKE shares: the same (ok, combined),
  and a poisoned share gives ok False on both. `TpuTpkeVerifier`'s jitted
  step compiles for ~150 s on one core, so it runs here as its body,
  three calls of `jax.jit(curve.g1_msm)` compiled once at n=4 and 256 bits
  (tests/test_torch_era_step.py holds the port's steps to the same).
* A repeated share under equal coefficients collides in the incomplete
  tree: `GpuTpkeVerifier` recomputes each such aggregate on the host,
  counts it in `ESCAPES["tpke_verifier"]`, and equals the host.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.ops import curve as jcurve
from lachain_tpu.ops import verify as jverify
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import verify
from lachain_tpu_torch.ops.verify import GpuTpkeVerifier

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

NBITS = 256
_JAX_MSM = jax.jit(jcurve.g1_msm)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _jax_msm(dev_pts, bits):
    """jax.jit(curve.g1_msm) at its one compiled width: bit rows
    zero-extended in front to NBITS."""
    bits = jnp.pad(jnp.asarray(bits), ((0, 0), (NBITS - bits.shape[-1], 0)))
    return _JAX_MSM(jnp.asarray(dev_pts), bits)


def _jax_step(u_dev, y_dev, rlc_bits, lag_bits):
    """tpke_era_step's body (verify.py:48-51) on _jax_msm: TpuTpkeVerifier's
    step."""
    return (_jax_msm(u_dev, rlc_bits), _jax_msm(y_dev, rlc_bits),
            _jax_msm(u_dev, lag_bits))


def _oracle(jax_pt):
    pt = jcurve.g1_from_device(np.asarray(jax_pt)[None])[0]
    return pt if pt[2] else bls.G1_INF


def _points(rng, n):
    return [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]


def _shares(n, f, seed, poison=None):
    dealer = jtpke.TpkeTrustedKeyGen(n, f, rng=SeededRng(seed))
    ct = dealer.pub.encrypt(b"\x42" * 32, share_id=0, rng=SeededRng(seed + 1))
    decs = [dealer.private_key(i).decrypt_share(ct, check=False) for i in range(n)]
    u = [d.ui for d in decs]
    if poison is not None:
        u[poison] = jbls.g1_add(u[poison], jbls.G1_GEN)
    ids = list(range(f + 1))
    lag = [0] * n
    for i, c in zip(ids, jbls.fr_lagrange_coeffs([i + 1 for i in ids], at=0)):
        lag[i] = c
    y = [vk.y_i for vk in dealer.verification_keys]
    return dealer, ct, u, y, lag


@pytest.mark.parametrize("poison", [None, 1])
def test_verifier_equals_tpu_verifier(poison, monkeypatch):
    n, f = 3, 0
    dealer, ct, u, y, lag = _shares(n, f, 0x7E0, poison)
    h, w = jtpke.ciphertext_h(ct), ct.w
    rng = random.Random(0x7E1)
    rlc = [rng.randrange(1, 1 << 64) for _ in range(n)]
    monkeypatch.setattr(jverify, "tpke_era_step_jit", _jax_step)
    want_ok, want_comb = jverify.TpuTpkeVerifier(PythonBackend()).verify_and_combine(
        u, y, h, w, rlc, lag)
    verify.reset_escapes()
    got_ok, got_comb = GpuTpkeVerifier(HostBackend(), device="cpu").verify_and_combine(
        u, y, h, w, rlc, lag)
    assert verify.ESCAPES == dict.fromkeys(verify.ESCAPES, 0)
    assert got_ok is want_ok is (poison is None)
    assert bls.g1_eq(got_comb, want_comb if want_comb[2] else bls.G1_INF)
    if poison is None:
        assert jtpke.decrypt_with_combined(ct, got_comb) == b"\x42" * 32


def test_verifier_collision_escapes_to_host():
    rng = random.Random(0x7E2)
    p, q = _points(rng, 2)
    c = rng.randrange(1, bls.R)
    rlc = [rng.randrange(1, 1 << 64)] * 2 + [rng.randrange(1, 1 << 64)]
    u, y, lag = [p, p, q], _points(rng, 3), [c, c, 0]
    host = HostBackend()
    h = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    verify.reset_escapes()
    ok, comb = GpuTpkeVerifier(host, device="cpu").verify_and_combine(
        u, y, h, h, rlc, lag)
    # u_agg (p, p under one RLC coefficient) and the combine collide
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), tpke_verifier=2)
    assert bls.g1_eq(comb, host.g1_msm(u, lag))
    u_agg, y_agg = host.g1_msm(u, rlc), host.g1_msm(y, rlc)
    assert ok is host.pairing_check([(u_agg, h), (bls.g1_neg(y_agg), h)])
