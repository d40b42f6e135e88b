"""The port's ECDSA module vs the JAX package's, and batched recovery.

`lachain_tpu_torch/crypto/ecdsa.py` is a copy of the host parts of
`lachain_tpu/crypto/ecdsa.py`: the signer's bytes, `recover_hash`, key
compression and addresses must be the reference's. `recover_hash_batch`
runs every regular entry through `ops/secp.GpuEcdsaRecover`; on the CPU
(device="cpu") that is the plain versions of the secp kernels at the full
64 windows, and every entry must equal the JAX `ecdsa.recover_hash`: valid
signatures, each malformed kind, and a crafted signature whose pairwise
add degenerates (u1*R == u2*G), which the oracle answers and
`verify.ESCAPES["ecdsa_recover"]` counts. Exact equality throughout.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.ops import psecp
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import secp, verify

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def keys():
    rng = random.Random(0xEC5A)
    return [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(3)]


def _hash(rng) -> bytes:
    return bytes(rng.randrange(256) for _ in range(32))


def _degenerate_sig():
    """u1*R == u2*G (tests/test_psecp.py:107-123): R = kG, s = (N-z)/k, so
    the pairwise add of the two lanes meets p == q and gives Z = 0."""
    k = 0x1234567
    rp = ecdsa._mul(ecdsa.G, k)
    z = 0x55AA
    s = (ecdsa.N - z) * pow(k, -1, ecdsa.N) % ecdsa.N
    sig = rp[0].to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([rp[1] & 1])
    return z.to_bytes(32, "big"), sig


def _non_residue_r(start: int) -> int:
    """The first r >= start whose x^3 + 7 has no square root mod p."""
    r = start
    while pow((r**3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) != ecdsa.P - 1:
        r += 1
    return r


def test_constants_equal_reference():
    assert (ecdsa.P, ecdsa.N, ecdsa.G) == (jecdsa.P, jecdsa.N, jecdsa.G)


def test_sign_hash_py_bytes_equal_reference(keys):
    rng = random.Random(1)
    for priv in keys:
        h = _hash(rng)
        sig = ecdsa._sign_hash_py(priv, h)
        assert sig == jecdsa._sign_hash_py(priv, h)
        assert ecdsa.recover_hash(h, sig) == ecdsa.public_key_bytes(priv)
        assert ecdsa.public_key_bytes(priv) == jecdsa.public_key_bytes(priv)


def test_recover_hash_equals_reference(keys):
    rng = random.Random(2)
    h = _hash(rng)
    sig = ecdsa._sign_hash_py(keys[0], h)
    cases = [(h, sig), (_hash(rng), sig), *_malformed(h, sig, rng)]
    for hh, ss in cases:
        assert ecdsa.recover_hash(hh, ss) == jecdsa.recover_hash(hh, ss)


def test_address_and_decompress_equal_reference(keys):
    for priv in keys:
        pub = ecdsa.public_key_bytes(priv)
        x, y = ecdsa.decompress_public_key(pub)
        assert (x, y) == jecdsa.decompress_public_key(pub)
        full = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
        for form in (pub, full):
            assert ecdsa.address_from_public_key(form) == jecdsa.address_from_public_key(form)
    for bad in (b"\x05" + bytes(32), b"\x02" + bytes(31), b"\x02" + b"\xff" * 32):
        with pytest.raises(ValueError):
            ecdsa.decompress_public_key(bad)
        with pytest.raises(ValueError):
            jecdsa.decompress_public_key(bad)


def _malformed(h: bytes, sig: bytes, rng):
    """One (hash, sig) of each malformed kind the recover path must answer
    as recover_hash does."""
    flip = bytearray(sig)
    flip[40] ^= 0xFF  # a flipped s byte: still valid, another key
    nr = _non_residue_r(rng.randrange(1, 1 << 255))
    return [
        (h, bytes(flip)),
        (h, bytes(32) + sig[32:]),  # r = 0
        (h, (ecdsa.N + 5).to_bytes(32, "big") + sig[32:]),  # r >= N
        (h, sig[:64] + bytes([4])),  # v = 4
        (h, nr.to_bytes(32, "big") + sig[32:64] + bytes([0])),  # non-residue x
        (bytes(32), sig),  # z = 0: the G lane's digits are all zero
        (h, sig[:64]),  # wrong signature length
        (h[:31], sig),  # wrong hash lengths
        (h + b"\x01", sig),
    ]


def test_recover_hash_batch_cpu_equals_reference(keys):
    """Full 64-window recovery on the plain versions: valid signatures,
    each malformed kind and the crafted collision, all equal to the JAX
    ecdsa.recover_hash; exactly one answer comes from the host oracle."""
    rng = random.Random(3)
    hashes, sigs = [], []
    for priv in keys:
        h = _hash(rng)
        hashes.append(h)
        sigs.append(ecdsa._sign_hash_py(priv, h))
    for h, s in _malformed(hashes[0], sigs[0], rng):
        hashes.append(h)
        sigs.append(s)
    dh, ds = _degenerate_sig()
    hashes.append(dh)
    sigs.append(ds)
    verify.reset_escapes()
    secp.reset_launches()
    got = ecdsa.recover_hash_batch(hashes, sigs, device="cpu")
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), ecdsa_recover=1)
    assert all(v == 0 for v in secp.LAUNCHES.values())  # no card was used
    want = [jecdsa.recover_hash(h, s) for h, s in zip(hashes, sigs)]
    assert got == want
    assert got[:3] == [ecdsa.public_key_bytes(p) for p in keys]
    assert got[-1] is not None


def test_gpu_ecdsa_recover_cpu_edges(keys):
    """Empty and all-invalid batches run no chunk; a length mismatch
    raises; the validation equals psecp's."""
    rec = secp.GpuEcdsaRecover(device="cpu")
    assert rec.recover_batch([], []) == []
    assert rec.last_timings["device_s"] == 0.0
    h = bytes(range(32))
    sig = ecdsa._sign_hash_py(keys[1], h)
    bad = [sig[:64] + bytes([9]), bytes(32) + sig[32:], sig[:40]]
    assert rec.recover_batch([h] * 3, bad) == [None] * 3
    for s in bad + [sig]:
        assert rec._validate(h, s) == psecp.TpuEcdsaRecover._validate(h, s)
    with pytest.raises(ValueError):
        rec.recover_batch([h], [])
    with pytest.raises(ValueError):
        ecdsa.recover_hash_batch([h], [], device="cpu")
