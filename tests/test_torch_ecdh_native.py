"""The port's native ECDH (`lt_ec_ecdh` in the port's
`crypto/native/secp256k1.cpp`, called by `crypto/ecdsa.ecdh_shared_secret`)
against its plain version `_ecdh_shared_secret_py` and the JAX package's
pure-Python `ecdh_shared_secret`: the same 32 bytes on seeded keys and on
edge scalars, a ValueError for every key the pure-Python form refuses
(a bad length or prefix, x >= p, x off the curve, a degenerate product),
and ECIES across the packages both ways.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.crypto.native_backend import load_lib

torch.set_num_threads(1)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _off_curve_x() -> int:
    """The smallest x whose x^3 + 7 is not a square mod p."""
    x = 1
    while pow((x ** 3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) == 1:
        x += 1
    return x


def test_entry_is_typed():
    fn = load_lib().lt_ec_ecdh
    assert fn.argtypes is not None and len(fn.argtypes) == 4


@pytest.mark.parametrize("seed", range(4))
def test_native_equals_pure_python_and_jax(seed):
    rng = SeededRng(seed)
    for _ in range(16):
        a = ecdsa.generate_private_key(rng)
        b = ecdsa.generate_private_key(rng)
        pub_b = ecdsa.public_key_bytes(b)
        got = ecdsa.ecdh_shared_secret(a, pub_b)
        assert got == ecdsa._ecdh_shared_secret_py(a, pub_b)
        assert got == jecdsa.ecdh_shared_secret(a, pub_b)
        assert got == ecdsa.ecdh_shared_secret(b, ecdsa.public_key_bytes(a))


@pytest.mark.parametrize("scalar", [
    1, 2, ecdsa.N - 1, ecdsa.N + 1, 2 ** 256 - 1, (1 << 255) + 12345,
])
def test_edge_scalars(scalar):
    """Scalars at and past the group order are reduced mod n, as the
    pure-Python ladder does."""
    pub = ecdsa.public_key_bytes(ecdsa.generate_private_key(SeededRng(7)))
    priv = scalar.to_bytes(32, "big")
    assert ecdsa.ecdh_shared_secret(priv, pub) == ecdsa._ecdh_shared_secret_py(priv, pub)


@pytest.mark.parametrize("priv_len", [1, 31, 33, 40])
def test_irregular_private_key_length(priv_len):
    priv = bytes(range(1, priv_len + 1))
    pub = ecdsa.public_key_bytes(ecdsa.generate_private_key(SeededRng(8)))
    assert ecdsa.ecdh_shared_secret(priv, pub) == ecdsa._ecdh_shared_secret_py(priv, pub)
    assert ecdsa.ecdh_shared_secret(priv, pub) == jecdsa.ecdh_shared_secret(priv, pub)


def _bad_keys():
    good = ecdsa.public_key_bytes(ecdsa.generate_private_key(SeededRng(9)))
    x_off = _off_curve_x()
    return {
        "short": good[:32],
        "long": good + b"\x00",
        "empty": b"",
        "prefix_04": b"\x04" + good[1:],
        "prefix_00": b"\x00" + good[1:],
        "x_is_p": b"\x02" + ecdsa.P.to_bytes(32, "big"),
        "x_above_p": b"\x03" + (2 ** 256 - 1).to_bytes(32, "big"),
        "off_curve": b"\x02" + x_off.to_bytes(32, "big"),
    }


@pytest.mark.parametrize("case", sorted(_bad_keys()))
def test_rejects_what_the_pure_python_form_rejects(case):
    pub = _bad_keys()[case]
    priv = ecdsa.generate_private_key(SeededRng(10))
    for fn in (ecdsa.ecdh_shared_secret, ecdsa._ecdh_shared_secret_py,
               jecdsa.ecdh_shared_secret):
        with pytest.raises(ValueError):
            fn(priv, pub)


@pytest.mark.parametrize("scalar", [0, ecdsa.N, 2 * ecdsa.N])
def test_rejects_a_degenerate_product(scalar):
    pub = ecdsa.public_key_bytes(ecdsa.generate_private_key(SeededRng(11)))
    priv = scalar.to_bytes(33, "big")  # 2n lies past 2^256
    for fn in (ecdsa.ecdh_shared_secret, ecdsa._ecdh_shared_secret_py,
               jecdsa.ecdh_shared_secret):
        with pytest.raises(ValueError, match="degenerate"):
            fn(priv, pub)


def test_ecies_crosses_the_packages():
    rng = SeededRng(12)
    priv = ecdsa.generate_private_key(rng)
    pub = ecdsa.public_key_bytes(priv)
    for size in (0, 1, 32, 704, 1000):
        msg = bytes(i % 251 for i in range(size))
        assert jecdsa.ecies_decrypt(priv, ecdsa.ecies_encrypt(pub, msg, rng)) == msg
        assert ecdsa.ecies_decrypt(priv, jecdsa.ecies_encrypt(pub, msg)) == msg
    other = ecdsa.generate_private_key(rng)
    with pytest.raises(ValueError):
        ecdsa.ecies_decrypt(other, ecdsa.ecies_encrypt(pub, b"secret", rng))
