"""Threshold public-key encryption over BLS12-381: the port's TPKE subset.

The parts of `lachain_tpu/crypto/tpke.py` that the era verify+combine path
and HoneyBadger need, with the same algebra and the same pad, so that a
ciphertext made by the JAX package decrypts here:
  keys    : master secret x = f(0) for a degree-t polynomial f over Fr;
            validator i holds x_i = f(i+1); Y = g1^x, Y_i = g1^{x_i}.
  encrypt : r <- Fr;  U = g1^r;  V = msg XOR XOF(Y^r);  W = H_G2(U, V)^r.
  decrypt : U_i = U^{x_i}  (a "partially decrypted share").
  verify  : e(U_i, H) == e(Y_i, W)  with H = H_G2(U, V).
  combine : U^x = Lagrange_0({(i+1, U_i)});  msg = V XOR XOF(U^x).
Every random draw takes an explicit `rng` with a `randbelow` method
(`secrets` in production, a seeded object in tests).

HoneyBadger's host side (reference :65-343, :523): the wire
records (`EncryptedShare` / `PartiallyDecryptedShare` `to_bytes` /
`from_bytes`, the wire format of the JAX package; the keys' too, :191-197,
:473-494, which the DKG's confirm vote hashes), `ciphertext_h`,
`decode_encrypted_shares_batch`, `verify_ciphertext`,
`batch_verify_ciphertexts`, the per-slot `batch_verify_shares` (RLC +
bisection) and `full_decrypt`, `peek_decrypted_share_ids` and
`decrypt_shares_batch`. There is no global provider: each group operation
and hash runs on the `backend` its caller passes (the consensus protocols
pass their host backend, the native library), the pure-Python
`host.HostBackend` where none is given; H_G2(U, V) is memoized per
(U, V, backend).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence

from . import bls12381 as bls
from .hashes import xof
from .host import HostBackend, batch_bisect_verify, select_distinct
from .provider import deserialize_batch_g1, deserialize_batch_g2
from ..utils.serialization import Reader, write_bytes, write_u32
from ..utils import metrics

_ENC_DOMAIN = b"LTPU-TPKE-PAD"
_HW_DOMAIN = b"LTPU-TPKE-W"

_HOST = HostBackend()


def _pad(y_r_point: tuple, nbytes: int) -> bytes:
    """Keystream derived from the shared G1 point."""
    return xof(_ENC_DOMAIN, bls.g1_to_bytes(y_r_point), nbytes)


@functools.lru_cache(maxsize=4096)
def _hash_uv_cached(u: tuple, v: bytes, backend) -> tuple:
    return backend.hash_to_g2(bls.g1_to_bytes(u) + v, _HW_DOMAIN)


def _hash_uv_to_g2(u: tuple, v: bytes, backend=None) -> tuple:
    """H_G2(U, V) through `backend.hash_to_g2`, memoized: every share of a
    ciphertext is checked against it."""
    return _hash_uv_cached(u, v, backend or _HOST)


def ciphertext_h(share: "EncryptedShare", backend=None) -> tuple:
    """H_G2(U, V) for a ciphertext: the G2 point every share of this
    ciphertext is verified against (e(U_i, H) == e(Y_i, W))."""
    return _hash_uv_to_g2(share.u, share.v, backend)


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

    def to_bytes(self) -> bytes:
        return (
            bls.g1_to_bytes(self.u)
            + bls.g2_to_bytes(self.w)
            + write_u32(self.share_id)
            + write_bytes(self.v)
        )

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "EncryptedShare":
        """Parse with `backend`'s checked deserializers (ValueError on a
        bad point)."""
        backend = backend or _HOST
        u = backend.g1_deserialize(data[: bls.G1_BYTES])
        w = backend.g2_deserialize(data[bls.G1_BYTES : bls.G1_BYTES + bls.G2_BYTES])
        r = Reader(data[bls.G1_BYTES + bls.G2_BYTES :])
        share_id = r.u32()
        v = r.bytes_()
        r.assert_eof()
        return cls(u=u, v=v, w=w, share_id=share_id)


def decode_encrypted_shares_batch(blobs, backend, memo=None) -> list:
    """Parse many serialized EncryptedShares, the U and W points through
    provider.deserialize_batch_g1 / _g2 on `backend` (with `memo`, a
    provider.CryptoMemo). Returns a list aligned with `blobs`; malformed or
    invalid entries are None."""
    metas = []
    for data in blobs:
        try:
            r = Reader(data[bls.G1_BYTES + bls.G2_BYTES :])
            share_id = r.u32()
            v = r.bytes_()
            r.assert_eof()
            metas.append((share_id, v))
        except Exception:
            metas.append(None)
    live = [i for i, m in enumerate(metas) if m is not None]
    us = deserialize_batch_g1([blobs[i][: bls.G1_BYTES] for i in live], backend, memo)
    ws = deserialize_batch_g2(
        [blobs[i][bls.G1_BYTES : bls.G1_BYTES + bls.G2_BYTES] for i in live],
        backend, memo)
    out = [None] * len(blobs)
    for j, i in enumerate(live):
        if us[j] is None or ws[j] is None:
            continue
        share_id, v = metas[i]
        out[i] = EncryptedShare(u=us[j], v=v, w=ws[j], share_id=share_id)
    return out


@dataclass(frozen=True)
class PartiallyDecryptedShare:
    """One validator's decryption share U_i = U^{x_i}."""

    ui: tuple  # G1
    decryptor_id: int
    share_id: int

    def to_bytes(self) -> bytes:
        return (
            bls.g1_to_bytes(self.ui)
            + write_u32(self.decryptor_id)
            + write_u32(self.share_id)
        )

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "PartiallyDecryptedShare":
        ui = (backend or _HOST).g1_deserialize(data[: bls.G1_BYTES])
        r = Reader(data[bls.G1_BYTES :])
        dec_id = r.u32()
        share_id = r.u32()
        r.assert_eof()
        return cls(ui=ui, decryptor_id=dec_id, share_id=share_id)


def peek_decrypted_share_ids(data: bytes):
    """(decryptor_id, share_id) of a serialized PartiallyDecryptedShare
    without parsing its point, or None when malformed: the ingest path's
    checks need only the ids."""
    if len(data) != bls.G1_BYTES + 8:
        return None
    return (
        int.from_bytes(data[bls.G1_BYTES : bls.G1_BYTES + 4], "big"),
        int.from_bytes(data[bls.G1_BYTES + 4 :], "big"),
    )


class TpkePublicKey:
    """Master TPKE public key + threshold."""

    def __init__(self, y: tuple, t: int):
        self.y = y  # G1
        self.t = t  # polynomial degree: t+1 shares reconstruct

    def to_bytes(self) -> bytes:
        return bls.g1_to_bytes(self.y) + write_u32(self.t)

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "TpkePublicKey":
        """Parse with `backend`'s checked G1 deserializer (ValueError on a
        bad point)."""
        y = (backend or _HOST).g1_deserialize(data[: bls.G1_BYTES])
        r = Reader(data[bls.G1_BYTES :])
        t = r.u32()
        r.assert_eof()
        return cls(y, t)

    @metrics.timed("crypto_tpke_encrypt")
    def encrypt(self, msg: bytes, share_id: int, rng, backend=None) -> EncryptedShare:
        backend = backend or _HOST
        r = rng.randbelow(bls.R - 1) + 1
        u = backend.g1_mul(bls.G1_GEN, r)
        y_r = backend.g1_mul(self.y, r)
        v = _xor(msg, _pad(y_r, len(msg)))
        w = backend.g2_mul(_hash_uv_to_g2(u, v, backend), r)
        return EncryptedShare(u=u, v=v, w=w, share_id=share_id)

    def verify_ciphertext(self, share: EncryptedShare, backend=None) -> bool:
        """e(g1, W) == e(U, H_G2(U, V)): ciphertext consistency."""
        backend = backend or _HOST
        h = _hash_uv_to_g2(share.u, share.v, backend)
        return backend.pairing_check(
            [(bls.G1_GEN, share.w), (bls.g1_neg(share.u), h)]
        )

    @metrics.timed("crypto_tpke_verify_shares")
    def batch_verify_shares(
        self,
        vks: Sequence["TpkeVerificationKey"],
        decs: Sequence[PartiallyDecryptedShare],
        share: EncryptedShare,
        rng,
        backend=None,
    ) -> List[bool]:
        """Per-share validity of one ciphertext's decryption shares:
        e(sum c_j U_j, H) == e(sum c_j Y_j, W) with random c_j below 2^128,
        bisected on failure (reference :245)."""
        if len(vks) != len(decs):
            raise ValueError("one verification key per share")
        if not decs:
            return []
        backend = backend or _HOST
        h = _hash_uv_to_g2(share.u, share.v, backend)

        def group_ok(idx: List[int]) -> bool:
            cs = [rng.randbelow((1 << 128) - 1) + 1 for _ in idx]
            u_agg = backend.g1_msm([decs[i].ui for i in idx], cs)
            y_agg = backend.g1_msm([vks[i].y_i for i in idx], cs)
            return backend.pairing_check(
                [(u_agg, h), (bls.g1_neg(y_agg), share.w)]
            )

        return batch_bisect_verify(group_ok, len(decs))

    @metrics.timed("crypto_tpke_full_decrypt")
    def full_decrypt(
        self,
        share: EncryptedShare,
        decs: Sequence[PartiallyDecryptedShare],
        backend=None,
    ) -> bytes:
        """Lagrange-combine t+1 decryption shares of distinct decryptors
        and strip the pad (reference :278)."""
        chosen = select_distinct(
            decs, key=lambda d: d.decryptor_id, count=self.t + 1
        )
        if chosen is None:
            raise ValueError(
                f"need {self.t + 1} distinct decryptor ids, got "
                f"{len(set(d.decryptor_id for d in decs))}"
            )
        cs = bls.fr_lagrange_coeffs([d.decryptor_id + 1 for d in chosen], at=0)
        y_r = (backend or _HOST).g1_msm([d.ui for d in chosen], cs)
        return decrypt_with_combined(share, y_r)


def batch_verify_ciphertexts(
    shares: Sequence[EncryptedShare], backend, rng, memo=None
) -> List[bool]:
    """Validate many ciphertexts with one random-linear-combination
    multi-pairing, bisecting on failure (reference :303). With `memo` (a
    provider.CryptoMemo) each ciphertext's verdict, a pure function of
    (U, V, W), is computed once."""
    if not shares:
        return []
    keys = [(s.u, s.v, s.w) for s in shares]
    table = memo.ct_valid if memo is not None else {}
    out: List[Optional[bool]] = [table.get(k) for k in keys]
    todo = [i for i, v in enumerate(out) if v is None]
    if not todo:
        return out
    hs = {i: _hash_uv_to_g2(shares[i].u, shares[i].v, backend) for i in todo}

    def group_ok(idx):
        pairs = []
        for t in idx:
            i = todo[t]
            r_s = rng.randbelow((1 << 128) - 1) + 1
            pairs.append((backend.g1_mul(bls.G1_GEN, r_s), shares[i].w))
            pairs.append((backend.g1_mul(bls.g1_neg(shares[i].u), r_s), hs[i]))
        return backend.pairing_check(pairs)

    verdicts = batch_bisect_verify(group_ok, len(todo))
    for t, ok in zip(todo, verdicts):
        out[t] = ok
        if memo is not None:
            memo.put(table, keys[t], ok)
    return out


@dataclass(frozen=True)
class TpkeVerificationKey:
    """Per-validator verification key Y_i = g1^{x_i}."""

    y_i: tuple

    def to_bytes(self) -> bytes:
        return bls.g1_to_bytes(self.y_i)

    @classmethod
    def from_bytes(cls, data: bytes, backend=None) -> "TpkeVerificationKey":
        return cls((backend or _HOST).g1_deserialize(data))


class TpkePrivateKey:
    """Validator key share x_i."""

    def __init__(self, x_i: int, my_id: int):
        self.x_i = x_i % bls.R
        self.my_id = my_id

    def to_bytes(self) -> bytes:
        return bls.fr_to_bytes(self.x_i) + write_u32(self.my_id)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TpkePrivateKey":
        x = bls.fr_from_bytes(data[: bls.FR_BYTES])
        r = Reader(data[bls.FR_BYTES :])
        my_id = r.u32()
        r.assert_eof()
        return cls(x, my_id)

    @metrics.timed("crypto_tpke_part_decrypt")
    def decrypt_share(
        self, share: EncryptedShare, check: bool = True, backend=None
    ) -> PartiallyDecryptedShare:
        """Validate the ciphertext (e(g1, W) == e(U, H)), then emit
        U_i = U^{x_i}."""
        backend = backend or _HOST
        if check:
            h = _hash_uv_to_g2(share.u, share.v, backend)
            ok = backend.pairing_check(
                [(bls.G1_GEN, share.w), (bls.g1_neg(share.u), h)]
            )
            if not ok:
                raise ValueError("invalid TPKE ciphertext")
        ui = backend.g1_mul(share.u, self.x_i)
        return PartiallyDecryptedShare(
            ui=ui, decryptor_id=self.my_id, share_id=share.share_id
        )


@metrics.timed("crypto_tpke_part_decrypt_batch")
def decrypt_shares_batch(
    priv: TpkePrivateKey, shares: List[EncryptedShare], backend
) -> List[PartiallyDecryptedShare]:
    """One node's decryption shares U_i = U^{x_i} for many ciphertexts, in
    one threaded `backend.g1_mul_batch` call where the backend has one and
    there are 8 or more (reference :523); equal to decrypt_share(check=
    False) share by share."""
    batch = getattr(backend, "g1_mul_batch", None)
    if batch is None or len(shares) < 8:
        return [priv.decrypt_share(s, check=False, backend=backend) for s in shares]
    uis = batch([s.u for s in shares], [priv.x_i] * len(shares))
    return [
        PartiallyDecryptedShare(ui=ui, decryptor_id=priv.my_id, share_id=s.share_id)
        for ui, s in zip(uis, shares)
    ]


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
