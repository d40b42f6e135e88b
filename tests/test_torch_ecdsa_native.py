"""The port's host ECDSA, AES-GCM, ECIES and VRF vs the JAX package's.

`lachain_tpu_torch/crypto/ecdsa.py` runs `public_key_bytes`, `sign_hash`,
`verify_hash` and `recover_hash` in the port's native host library (its
copy of the reference's `secp256k1.cpp`); its pure-Python forms
(`_sign_hash_py`, `_verify_hash_py`, `_recover_hash_py`) are the plain
versions. On seeded keys and hashes every one must give the reference's
bytes and verdicts: valid signatures and malformed ones (r = 0, s >= N,
v > 3, a short signature, a wrong key, a key of irregular length), and the
native batch entries the scalar ones. ECDH secrets are equal; AES-GCM and
ECIES ciphertexts decrypt across the packages both ways, the port's GCM
(`_aes_fallback`, always used) is the reference's bytes under a fixed
nonce, and a flipped tag byte raises. `crypto/vrf.py`: equal proofs and
hashes, proofs verify across the packages, equal lottery verdicts.
Exact equality throughout; pure host code, ~2 s.
"""
from __future__ import annotations

import ctypes
import random

import pytest
import torch

from lachain_tpu.crypto import _aes_fallback as jaes
from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.crypto import vrf as jvrf
from lachain_tpu_torch.crypto import _aes_fallback as aes
from lachain_tpu_torch.crypto import ecdsa, vrf

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)


class Rng:
    """`randbelow` over a seeded random.Random: the port's rng API."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def _keys(seed: int, n: int):
    rng = random.Random(seed)
    return [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(n)]


def _hashes(seed: int, n: int):
    rng = random.Random(seed)
    return [rng.randbytes(32) for _ in range(n)]


def _malformed(sig: bytes):
    """{kind: signature} of every malformed kind the recovery and the
    verifier refuse."""
    n = ecdsa.N.to_bytes(32, "big")
    return {
        "r_zero": bytes(32) + sig[32:],
        "s_zero": sig[:32] + bytes(32) + sig[64:],
        "s_above_n": sig[:32] + n + sig[64:],
        "r_above_n": n + sig[32:],
        "v_four": sig[:64] + b"\x04",
        "short": sig[:64],
        "long": sig + b"\x00",
        "flip_s": sig[:40] + bytes([sig[40] ^ 1]) + sig[41:],
    }


def test_public_keys_and_signatures_equal_reference():
    keys, hashes = _keys(0xEC01, 6), _hashes(0xEC02, 6)
    for priv in keys:
        pub = ecdsa.public_key_bytes(priv)
        assert pub == jecdsa.public_key_bytes(priv)
        assert ecdsa.address_from_public_key(pub) == jecdsa.address_from_public_key(pub)
        for h in hashes:
            sig = ecdsa.sign_hash(priv, h)
            assert sig == jecdsa.sign_hash(priv, h) == jecdsa._sign_hash_py(priv, h)
            assert ecdsa._sign_hash_py(priv, h) == sig


def test_the_native_library_is_used():
    """sign_hash, verify_hash and recover_hash reach the native entries."""
    calls = []
    lib = ecdsa._lib()

    class Spy:
        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                calls.append(name)
                return fn(*args)
            return call

    priv, h = _keys(0xEC03, 1)[0], _hashes(0xEC04, 1)[0]
    ecdsa._LIB[:] = [Spy()]
    try:
        sig = ecdsa.sign_hash(priv, h)
        pub = ecdsa.recover_hash(h, sig)
        assert ecdsa.verify_hash(pub, h, sig)
    finally:
        ecdsa._LIB[:] = [lib]
    assert calls == ["lt_ec_sign", "lt_ec_recover", "lt_ec_verify"]


def test_verify_and_recover_equal_reference_on_malformed_signatures():
    keys, hashes = _keys(0xEC05, 3), _hashes(0xEC06, 3)
    other = ecdsa.public_key_bytes(_keys(0xEC07, 1)[0])
    for priv, h in zip(keys, hashes):
        pub = ecdsa.public_key_bytes(priv)
        sig = ecdsa.sign_hash(priv, h)
        cases = dict(_malformed(sig), valid=sig)
        for kind, s in cases.items():
            want = jecdsa.recover_hash(h, s)
            assert ecdsa.recover_hash(h, s) == want, kind
            assert ecdsa._recover_hash_py(h, s) == jecdsa._recover_hash_py(h, s) == want, kind
            for key in (pub, other, pub[:32], b"\x05" + pub[1:]):
                want = jecdsa.verify_hash(key, h, s)
                assert ecdsa.verify_hash(key, h, s) == want, kind
                assert ecdsa._verify_hash_py(key, h, s) == want, kind
        assert ecdsa.recover_hash(h, sig) == pub and ecdsa.verify_hash(pub, h, sig)
        assert not ecdsa.verify_hash(other, h, sig)
    # a hash of irregular length takes the pure-Python forms, as in the reference
    h, sig = b"\x01" * 31, ecdsa.sign_hash(keys[0], hashes[0])
    assert ecdsa.recover_hash(h, sig) == jecdsa.recover_hash(h, sig)
    assert ecdsa.verify_hash(ecdsa.public_key_bytes(keys[0]), h, sig) is False


def test_native_batch_entries_equal_scalar_ones():
    keys, hashes = _keys(0xEC08, 4), _hashes(0xEC09, 8)
    sigs = [ecdsa.sign_hash(keys[i % 4], h) for i, h in enumerate(hashes)]
    sigs[3] = _malformed(sigs[3])["r_zero"]
    sigs[5] = _malformed(sigs[5])["flip_s"]
    pubs = [ecdsa.public_key_bytes(keys[i % 4]) for i in range(8)]
    lib, m = ecdsa._lib(), len(hashes)
    outs, oks = ctypes.create_string_buffer(33 * m), ctypes.create_string_buffer(m)
    assert lib.lt_ec_recover_batch(b"".join(hashes), b"".join(sigs), m, 2, outs, oks) == 0
    got = [outs.raw[33 * i:33 * i + 33] if oks.raw[i] == 1 else None for i in range(m)]
    assert got == [ecdsa.recover_hash(h, s) for h, s in zip(hashes, sigs)]
    vok = ctypes.create_string_buffer(m)
    assert lib.lt_ec_verify_batch(b"".join(pubs), b"".join(hashes), b"".join(sigs),
                                  m, 2, vok) == 0
    assert [b == 1 for b in vok.raw] == [
        jecdsa.verify_hash(p, h, s) for p, h, s in zip(pubs, hashes, sigs)]


def test_ecdh_aes_gcm_and_ecies_cross_the_packages():
    a, b = _keys(0xEC0A, 2)
    pa, pb = ecdsa.public_key_bytes(a), ecdsa.public_key_bytes(b)
    secret = ecdsa.ecdh_shared_secret(a, pb)
    assert secret == ecdsa.ecdh_shared_secret(b, pa) == jecdsa.ecdh_shared_secret(a, pb)
    msg = random.Random(0xEC0B).randbytes(1000)
    for key in (secret, secret[:16], secret[:24]):
        nonce = random.Random(len(key)).randbytes(12)
        assert aes.encrypt(key, nonce, msg, b"ad") == jaes.encrypt(key, nonce, msg, b"ad")
        ct = ecdsa.aes_gcm_encrypt(key, msg, Rng(len(key)))
        assert ct == Rng(len(key)).randbelow(1 << 96).to_bytes(12, "big") + jaes.encrypt(
            key, ct[:12], msg)
        assert jecdsa.aes_gcm_decrypt(key, ct) == msg
        assert ecdsa.aes_gcm_decrypt(key, jecdsa.aes_gcm_encrypt(key, msg)) == msg
        bad = ct[:-1] + bytes([ct[-1] ^ 0x80])
        with pytest.raises(ValueError):
            ecdsa.aes_gcm_decrypt(key, bad)
        with pytest.raises(Exception):
            jecdsa.aes_gcm_decrypt(key, bad)
    with pytest.raises(ValueError):
        ecdsa.aes_gcm_decrypt(secret, bytes(27))
    blob = ecdsa.ecies_encrypt(pb, msg, Rng(0xEC0C))
    assert blob == ecdsa.ecies_encrypt(pb, msg, Rng(0xEC0C))  # seeded
    assert jecdsa.ecies_decrypt(b, blob) == msg == ecdsa.ecies_decrypt(b, blob)
    assert ecdsa.ecies_decrypt(b, jecdsa.ecies_encrypt(pb, msg, Rng(0xEC0D))) == msg
    with pytest.raises(ValueError):
        ecdsa.ecies_decrypt(b, blob[:60])


def test_vrf_equals_reference():
    keys = _keys(0xEC0E, 3)
    alphas = [b"", b"era-7", random.Random(0xEC0F).randbytes(64)]
    for sk in keys:
        pk = ecdsa.public_key_bytes(sk)
        for alpha in alphas:
            proof, beta = vrf.evaluate(sk, alpha)
            assert (proof, beta) == jvrf.evaluate(sk, alpha)
            assert vrf.proof_to_hash(proof) == jvrf.proof_to_hash(proof) == beta
            assert vrf.verify(pk, alpha, proof) and jvrf.verify(pk, alpha, proof)
            bad = proof[:40] + bytes([proof[40] ^ 1]) + proof[41:]
            assert vrf.verify(pk, alpha, bad) == jvrf.verify(pk, alpha, bad) is False
            assert vrf.verify(pk, alpha + b"x", proof) is False
            assert vrf.verify(pk, alpha, proof[:80]) is False
    rng = random.Random(0xEC10)
    for _ in range(200):
        beta = rng.randbytes(32)
        total = rng.randrange(1, 10**6)
        stake, seats = rng.randrange(-2, total + 2), rng.randrange(0, 40)
        assert vrf.is_winner(beta, stake, total, seats) == jvrf.is_winner(
            beta, stake, total, seats)
