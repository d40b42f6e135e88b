"""Carry key material and era inputs into the port from numpy arrays.

This system runs no model: its "weights" are the TPKE and threshold-
signature key material and each era's ciphertexts, decryption shares and
coin signature shares. The JAX package serializes them
with its own `bls12381.g1_to_bytes` (96 bytes, affine x || y, all-zero for
infinity), `g2_to_bytes` (192 bytes) and `fr_to_bytes` (32 bytes, big
endian); these functions read those encodings from uint8 arrays and return
the port's objects, with the same on-curve and subgroup checks.
`consensus_keys_from_numpy` carries a whole era key set (TPKE,
threshold-signature and ECDSA keys) into the port's consensus key sets.
`signed_transactions_from_bytes` carries the JAX package's signed
transactions (`core/types.SignedTransaction.encode()`) into the port's
`SignedTransaction`s. `bivar_polynomial_from_numpy` carries a DKG
dealer's polynomial; a DKG node's state crosses as the JAX package's
`TrustlessKeygen.to_bytes()`, which the port's
`consensus.keygen.TrustlessKeygen.from_bytes` reads as it is.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .consensus.keygen import BiVarSymmetricPolynomial
from .consensus.keys import PrivateConsensusKeys, PublicConsensusKeys
from .core.types import SignedTransaction
from .crypto import bls12381 as bls
from .crypto.threshold_sig import (
    PartialSignature,
    TsPrivateKeyShare,
    TsPublicKey,
    TsPublicKeySet,
)
from .crypto.tpke import (
    EncryptedShare,
    PartiallyDecryptedShare,
    TpkePrivateKey,
    TpkePublicKey,
    TpkeVerificationKey,
)


def _rows(a, width: int) -> List[bytes]:
    a = np.asarray(a, dtype=np.uint8)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"expected a uint8 (n, {width}) array, got {a.shape}")
    return [row.tobytes() for row in a]


def _one(a, width: int) -> bytes:
    return _rows(np.asarray(a, dtype=np.uint8).reshape(1, -1), width)[0]


def tpke_keys_from_numpy(y, t: int, y_i, x_i):
    """Serialized TPKE keys -> (TpkePublicKey, [TpkeVerificationKey],
    [TpkePrivateKey]).

    y: uint8 (96,) master key Y; t: threshold degree; y_i: uint8 (n, 96)
    verification keys; x_i: uint8 (n, 32) private shares, validator i's at
    row i."""
    pub = TpkePublicKey(bls.g1_from_bytes(_one(y, bls.G1_BYTES)), t)
    vks = [
        TpkeVerificationKey(bls.g1_from_bytes(b))
        for b in _rows(y_i, bls.G1_BYTES)
    ]
    privs = [
        TpkePrivateKey(bls.fr_from_bytes(b), i)
        for i, b in enumerate(_rows(x_i, bls.FR_BYTES))
    ]
    if len(vks) != len(privs):
        raise ValueError("y_i and x_i must have one row per validator")
    return pub, vks, privs


def encrypted_share_from_numpy(u, v, w, share_id: int) -> EncryptedShare:
    """u: uint8 (96,), v: uint8 (m,) padded message, w: uint8 (192,)."""
    return EncryptedShare(
        u=bls.g1_from_bytes(_one(u, bls.G1_BYTES)),
        v=np.asarray(v, dtype=np.uint8).tobytes(),
        w=bls.g2_from_bytes(_one(w, bls.G2_BYTES)),
        share_id=share_id,
    )


def decrypted_shares_from_numpy(
    ui, decryptor_ids: Sequence[int], share_id: int
) -> List[PartiallyDecryptedShare]:
    """ui: uint8 (k, 96) share points; decryptor_ids: k validator ids."""
    pts = [bls.g1_from_bytes(b) for b in _rows(ui, bls.G1_BYTES)]
    if len(pts) != len(decryptor_ids):
        raise ValueError("one decryptor id per share row")
    return [
        PartiallyDecryptedShare(ui=p, decryptor_id=int(d), share_id=share_id)
        for p, d in zip(pts, decryptor_ids)
    ]


def ts_keys_from_numpy(y_i, t: int, x_i):
    """Serialized threshold-signature keys -> (TsPublicKeySet,
    [TsPrivateKeyShare]).

    y_i: uint8 (n, 96) per-validator public keys; t: threshold degree;
    x_i: uint8 (n, 32) private shares, validator i's at row i. The shared
    key is interpolated from the first t+1 keys, as the JAX package does."""
    keys = [TsPublicKey(bls.g1_from_bytes(b)) for b in _rows(y_i, bls.G1_BYTES)]
    shares = [
        TsPrivateKeyShare(bls.fr_from_bytes(b), i)
        for i, b in enumerate(_rows(x_i, bls.FR_BYTES))
    ]
    if len(keys) != len(shares):
        raise ValueError("y_i and x_i must have one row per validator")
    return TsPublicKeySet(keys, t), shares


def partial_signatures_from_numpy(
    sigma, signer_ids: Sequence[int]
) -> List[PartialSignature]:
    """sigma: uint8 (k, 192) signature shares (G2); signer_ids: k ids."""
    pts = [bls.g2_from_bytes(b) for b in _rows(sigma, bls.G2_BYTES)]
    if len(pts) != len(signer_ids):
        raise ValueError("one signer id per signature row")
    return [
        PartialSignature(sigma=p, signer_id=int(i))
        for p, i in zip(pts, signer_ids)
    ]


def consensus_keys_from_numpy(f: int, tpke_y, tpke_y_i, tpke_x_i, ts_y_i, ts_x_i,
                              ecdsa_pubs: Sequence[bytes],
                              ecdsa_privs: Sequence[bytes]):
    """A dealt era key set (the JAX package's `consensus.keys.
    trusted_key_gen` output, serialized) -> (PublicConsensusKeys,
    [PrivateConsensusKeys per validator]).

    tpke_y: uint8 (96,) TPKE master key; tpke_y_i: uint8 (n, 96) TPKE
    verification keys; tpke_x_i: uint8 (n, 32) TPKE private shares; ts_y_i
    / ts_x_i: the threshold-signature keys alike; f: the fault bound, the
    degree of both polynomials; ecdsa_pubs / ecdsa_privs: n compressed
    public keys (33 bytes) and n private keys (32 bytes)."""
    tpke_pub, vks, tpke_privs = tpke_keys_from_numpy(tpke_y, f, tpke_y_i, tpke_x_i)
    ts_keys, ts_shares = ts_keys_from_numpy(ts_y_i, f, ts_x_i)
    n = len(vks)
    if not (len(ts_shares) == len(ecdsa_pubs) == len(ecdsa_privs) == n):
        raise ValueError("every key list must have one entry per validator")
    pub = PublicConsensusKeys(
        n=n, f=f, tpke_pub=tpke_pub, tpke_verification_keys=vks,
        ts_keys=ts_keys, ecdsa_pub_keys=[bytes(k) for k in ecdsa_pubs])
    privs = [
        PrivateConsensusKeys(tpke_priv=tp, ts_share=tss, ecdsa_priv=bytes(sk))
        for tp, tss, sk in zip(tpke_privs, ts_shares, ecdsa_privs)
    ]
    return pub, privs


def signed_transactions_from_bytes(blobs: Sequence[bytes]) -> List[SignedTransaction]:
    """The JAX package's wire encodings of signed transactions (each its
    `SignedTransaction.encode()`) -> the port's `SignedTransaction`s, with
    the same hashes and senders. A malformed encoding raises ValueError."""
    return [SignedTransaction.decode(bytes(b)) for b in blobs]


def bivar_polynomial_from_numpy(coeffs, degree: int) -> BiVarSymmetricPolynomial:
    """A DKG dealer's symmetric bivariate polynomial: coeffs uint8
    ((degree + 1)(degree + 2) / 2, 32), each row one Fr coefficient big
    endian (the JAX package's `fr_to_bytes`), in its packed triangular
    order; degree: f. ValueError for a coefficient >= r or a wrong count."""
    return BiVarSymmetricPolynomial(
        degree, [bls.fr_from_bytes(b) for b in _rows(coeffs, bls.FR_BYTES)])
