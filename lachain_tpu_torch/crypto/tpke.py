"""Threshold public-key encryption over BLS12-381: the port's TPKE subset.

The parts of `lachain_tpu/crypto/tpke.py` that the era verify+combine path
needs, with the same algebra and the same pad, so that a ciphertext made by
the JAX package decrypts here:
  keys    : master secret x = f(0) for a degree-t polynomial f over Fr;
            validator i holds x_i = f(i+1); Y = g1^x, Y_i = g1^{x_i}.
  encrypt : r <- Fr;  U = g1^r;  V = msg XOR XOF(Y^r);  W = H_G2(U, V)^r.
  decrypt : U_i = U^{x_i}  (a "partially decrypted share").
  verify  : e(U_i, H) == e(Y_i, W)  with H = H_G2(U, V).
  combine : U^x = Lagrange_0({(i+1, U_i)});  msg = V XOR XOF(U^x).
Every random draw takes an explicit `rng` with a `randbelow` method
(`secrets` in production, a seeded object in tests).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from . import bls12381 as bls
from .hashes import xof
from .host import HostBackend

_ENC_DOMAIN = b"LTPU-TPKE-PAD"
_HW_DOMAIN = b"LTPU-TPKE-W"

_HOST = HostBackend()


def _pad(y_r_point: tuple, nbytes: int) -> bytes:
    """Keystream derived from the shared G1 point."""
    return xof(_ENC_DOMAIN, bls.g1_to_bytes(y_r_point), nbytes)


@functools.lru_cache(maxsize=4096)
def _hash_uv_to_g2(u: tuple, v: bytes) -> tuple:
    """H_G2(U, V), memoized: every share of a ciphertext is checked
    against it."""
    return _HOST.hash_to_g2(bls.g1_to_bytes(u) + v, _HW_DOMAIN)


def _xor(a: bytes, b: bytes) -> bytes:
    return (int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).to_bytes(
        len(a), "big"
    )


def decrypt_with_combined(share: "EncryptedShare", y_r: tuple) -> bytes:
    """Strip the pad given the combined point U^x."""
    return _xor(share.v, _pad(y_r, len(share.v)))


@dataclass(frozen=True)
class EncryptedShare:
    """Ciphertext of one validator's tx-batch share."""

    u: tuple  # G1
    v: bytes
    w: tuple  # G2
    share_id: int


@dataclass(frozen=True)
class PartiallyDecryptedShare:
    """One validator's decryption share U_i = U^{x_i}."""

    ui: tuple  # G1
    decryptor_id: int
    share_id: int


class TpkePublicKey:
    """Master TPKE public key + threshold."""

    def __init__(self, y: tuple, t: int):
        self.y = y  # G1
        self.t = t  # polynomial degree: t+1 shares reconstruct

    def encrypt(self, msg: bytes, share_id: int, rng) -> EncryptedShare:
        r = rng.randbelow(bls.R - 1) + 1
        u = _HOST.g1_mul(bls.G1_GEN, r)
        y_r = _HOST.g1_mul(self.y, r)
        v = _xor(msg, _pad(y_r, len(msg)))
        w = _HOST.g2_mul(_hash_uv_to_g2(u, v), r)
        return EncryptedShare(u=u, v=v, w=w, share_id=share_id)


@dataclass(frozen=True)
class TpkeVerificationKey:
    """Per-validator verification key Y_i = g1^{x_i}."""

    y_i: tuple


class TpkePrivateKey:
    """Validator key share x_i."""

    def __init__(self, x_i: int, my_id: int):
        self.x_i = x_i % bls.R
        self.my_id = my_id

    def decrypt_share(
        self, share: EncryptedShare, check: bool = True
    ) -> PartiallyDecryptedShare:
        """Validate the ciphertext (e(g1, W) == e(U, H)), then emit
        U_i = U^{x_i}."""
        if check:
            h = _hash_uv_to_g2(share.u, share.v)
            ok = _HOST.pairing_check(
                [(bls.G1_GEN, share.w), (bls.g1_neg(share.u), h)]
            )
            if not ok:
                raise ValueError("invalid TPKE ciphertext")
        ui = _HOST.g1_mul(share.u, self.x_i)
        return PartiallyDecryptedShare(
            ui=ui, decryptor_id=self.my_id, share_id=share.share_id
        )


class TpkeTrustedKeyGen:
    """Trusted dealer for devnets, tests and the chip smoke run."""

    def __init__(self, n: int, f: int, rng):
        if n <= 3 * f:
            raise ValueError("TPKE dealer requires n > 3f")
        coeffs = [rng.randbelow(bls.R) for _ in range(f + 1)]
        self.pub = TpkePublicKey(bls.g1_mul(bls.G1_GEN, coeffs[0]), t=f)
        self._shares = [
            bls.fr_eval_poly(coeffs, i + 1) for i in range(n)
        ]
        self.verification_keys = [
            TpkeVerificationKey(bls.g1_mul(bls.G1_GEN, s))
            for s in self._shares
        ]

    def private_key(self, i: int) -> TpkePrivateKey:
        return TpkePrivateKey(self._shares[i], i)
