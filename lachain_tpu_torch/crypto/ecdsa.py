"""secp256k1 ECDSA of the port: signing, verification, recovery, ECDH,
AES-GCM and ECIES on the host, and batched recovery on the card.

The port's copy of `lachain_tpu/crypto/ecdsa.py`: the domain parameters and
affine curve law (:26-64), `generate_private_key` (:69), `public_key_point`
/ `public_key_bytes` (:87), `decompress_public_key`,
`address_from_public_key`, the RFC 6979 nonce, `sign_hash` (:185),
`verify_hash` (:224), `ecdh_shared_secret` (:252), AES-GCM (:263-289),
ECIES (:291-307), `recover_hash` (:309) and `recover_hash_batch` (:357).

`public_key_bytes`, `sign_hash`, `verify_hash`, `recover_hash` and
`ecdh_shared_secret`'s shared point (and the keccak of
`address_from_public_key`) run in the port's native host library (its
copy of the reference's `crypto/native/secp256k1.cpp` with the port's
`lt_ec_ecdh` added, built by `ops/_build.host_library()`,
typed by `native_backend.load_lib`); a missing compiler or a failed build
raises, there is no pure-Python fallback. Where the library returns an
error code, each answers as the reference's function does: `sign_hash`
signs in Python (`_sign_hash_py`), `public_key_bytes` derives in Python,
`recover_hash` returns None; `verify_hash` and `recover_hash` take the
pure-Python forms (`_verify_hash_py`, `_recover_hash_py`) for a key or a
hash of irregular length, as the reference does; `ecdh_shared_secret`
raises ValueError wherever the reference's pure-Python form does. The
pure-Python forms (`_ecdh_shared_secret_py` too) are the plain versions
the tests hold the library to.

AES-GCM always runs `_aes_fallback` (the port's copy of the reference's
pure-Python GCM): the port imports no optional package. The random
generators are explicit: `generate_private_key`, `aes_gcm_encrypt` (its
nonce) and `ecies_encrypt` take an `rng` with `randbelow` (`secrets` in
production, a seeded object in tests) where the reference draws from
`secrets`.

`recover_hash_batch` sends every entry of regular length to the card
(ops/secp.GpuEcdsaRecover): there is no batch-size threshold, and an error
on the card propagates instead of falling back to the host. Entries of
irregular length take `recover_hash`, as in the JAX package. Its
recoverer is kept per device (`batch_recoverer`), so the last call's
phases can be read.

Signing is not constant-time (branchy double-and-add over the nonce), as
in the reference: devnet grade; recovery takes only public inputs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import hmac
from typing import List, Optional, Sequence, Tuple

from .hashes import keccak256_host, sha256

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p: Optional[Tuple[int, int]], q: Optional[Tuple[int, int]]):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _mul(p: Optional[Tuple[int, int]], k: int):
    k %= N
    result = None
    addend = p
    while k:
        if k & 1:
            result = _add(result, addend)
        addend = _add(addend, addend)
        k >>= 1
    return result


def _compress(pt: Tuple[int, int]) -> bytes:
    return bytes([0x02 | (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def generate_private_key(rng) -> bytes:
    """A private key, 32 bytes big endian in [1, N), drawn from `rng`
    (`secrets` in production, a seeded object in tests): the reference's
    draw (:69), so that one seed deals the same keys in both packages."""
    while True:
        k = rng.randbelow(N)
        if 1 <= k < N:
            return k.to_bytes(32, "big")


def public_key_point(priv: bytes) -> Tuple[int, int]:
    return _mul(G, int.from_bytes(priv, "big"))


_LIB: list = []


def _lib():
    """The native host library with its ECDSA entries typed, loaded on
    first use (the import of the build stays out of this module's import);
    a failed build raises."""
    if not _LIB:
        from .native_backend import load_lib

        _LIB.append(load_lib())
    return _LIB[0]


# sha256(priv) -> compressed public key: nodes sign with a handful of
# long-lived keys; keyed by a hash so the cache pins no secret bytes
_PUB_CACHE: dict = {}


def public_key_bytes(priv: bytes) -> bytes:
    """Compressed SEC1 encoding (33 bytes)."""
    ck = sha256(priv)
    pub = _PUB_CACHE.get(ck)
    if pub is not None:
        return pub
    out = ctypes.create_string_buffer(33)
    if _lib().lt_ec_pubkey(priv, out) == 0:
        pub = out.raw
    else:
        pub = _compress(public_key_point(priv))
    if len(_PUB_CACHE) > 4096:
        _PUB_CACHE.clear()
    _PUB_CACHE[ck] = pub
    return pub


def decompress_public_key(pub: bytes) -> Tuple[int, int]:
    # ValueError (not assert): malformed keys come from untrusted input
    if len(pub) != 33 or pub[0] not in (2, 3):
        raise ValueError("pubkey must be 33 bytes with 02/03 prefix")
    x = int.from_bytes(pub[1:], "big")
    if x >= P:
        raise ValueError("pubkey x out of range")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("pubkey not on curve")
    if (y & 1) != (pub[0] & 1):
        y = P - y
    return (x, y)


def address_from_public_key(pub: bytes) -> bytes:
    """20-byte Ethereum-style address: keccak256(uncompressed_xy)[12:].
    Memoized: a compressed key's decompression is a pure-Python square
    root (~0.2 ms), and a chain derives the same validators' and senders'
    addresses again and again (the governance contract's sender check
    walks the elected set's keys on every keygen transaction)."""
    return _address(bytes(pub))


@functools.lru_cache(maxsize=1 << 16)
def _address(pub: bytes) -> bytes:
    x, y = decompress_public_key(pub) if len(pub) == 33 else (
        int.from_bytes(pub[1:33], "big"),
        int.from_bytes(pub[33:], "big"),
    )
    raw = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return keccak256_host(raw)[12:]


def _rfc6979_k(priv: bytes, msg_hash: bytes) -> int:
    """Deterministic nonce per RFC 6979 (HMAC-SHA256)."""
    holder = b"\x01" * 32
    key = b"\x00" * 32
    key = hmac.new(key, holder + b"\x00" + priv + msg_hash, hashlib.sha256).digest()
    holder = hmac.new(key, holder, hashlib.sha256).digest()
    key = hmac.new(key, holder + b"\x01" + priv + msg_hash, hashlib.sha256).digest()
    holder = hmac.new(key, holder, hashlib.sha256).digest()
    while True:
        holder = hmac.new(key, holder, hashlib.sha256).digest()
        k = int.from_bytes(holder, "big")
        if 1 <= k < N:
            return k
        key = hmac.new(key, holder + b"\x00", hashlib.sha256).digest()
        holder = hmac.new(key, holder, hashlib.sha256).digest()


def _signature(d: int, z: int, k: int, pt: Tuple[int, int]) -> Optional[bytes]:
    """r || s || v for secret d, hash scalar z and nonce k with pt = k*G;
    None when r or s is 0. Low-s normalization flips the parity bit."""
    r = pt[0] % N
    if r == 0:
        return None
    s = _inv(k, N) * (z + r * d) % N
    if s == 0:
        return None
    v = (pt[1] & 1) | (2 if pt[0] >= N else 0)
    if s > N // 2:
        s = N - s
        v ^= 1
    return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def sign_hash(priv: bytes, msg_hash: bytes) -> bytes:
    """65-byte recoverable signature r(32) || s(32) || v(1), low-s
    enforced, RFC 6979 nonce: the native library's, or `_sign_hash_py`'s
    where the library refuses the key (as the reference does)."""
    if len(msg_hash) != 32 or len(priv) != 32:
        raise ValueError("msg_hash and priv must be 32 bytes")
    out = ctypes.create_string_buffer(65)
    if _lib().lt_ec_sign(priv, msg_hash, out) == 0:
        return out.raw
    return _sign_hash_py(priv, msg_hash)


def _sign_hash_py(priv: bytes, msg_hash: bytes) -> bytes:
    """`sign_hash` in pure Python (the reference's `_sign_hash_py`)."""
    if len(msg_hash) != 32 or len(priv) != 32:
        raise ValueError("msg_hash and priv must be 32 bytes")
    z = int.from_bytes(msg_hash, "big") % N
    d = int.from_bytes(priv, "big")
    extra = b""
    while True:
        # r == 0 / s == 0 are ~2^-256 events; retry with a tweaked nonce
        # stream while keeping z bound to the ORIGINAL message hash.
        k = _rfc6979_k(priv, hashlib.sha256(msg_hash + extra).digest() if extra else msg_hash)
        sig = _signature(d, z, k, _mul(G, k))
        if sig is not None:
            return sig
        extra += b"\x00"


def verify_hash(pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
    """Whether `sig` signs `msg_hash` under the compressed key `pub`: in
    the native library; a key or hash of irregular length takes
    `_verify_hash_py`, as in the reference."""
    if len(pub) == 33 and len(msg_hash) == 32:
        return bool(_lib().lt_ec_verify(pub, msg_hash, sig, len(sig)))
    return _verify_hash_py(pub, msg_hash, sig)


def _verify_hash_py(pub: bytes, msg_hash: bytes, sig: bytes) -> bool:
    """`verify_hash` in pure Python (the reference's `_verify_hash_py`)."""
    if len(sig) != 65:
        return False
    try:
        q = decompress_public_key(pub)
    except ValueError:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    if not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(msg_hash, "big") % N
    w = _inv(s, N)
    pt = _add(_mul(G, z * w % N), _mul(q, r * w % N))
    if pt is None:
        return False
    return pt[0] % N == r


def ecdh_shared_secret(priv: bytes, pub: bytes) -> bytes:
    """32-byte shared secret: sha256 of the compressed shared point
    priv * pub, made by the native library's `lt_ec_ecdh`. ValueError for a
    key that does not decompress (a bad length or prefix, x >= p, x off
    the curve) and for a degenerate product (priv = 0 mod n), as
    `_ecdh_shared_secret_py`."""
    k = (int.from_bytes(priv, "big") % N).to_bytes(32, "big")
    out = ctypes.create_string_buffer(33)
    rc = _lib().lt_ec_ecdh(k, pub, len(pub), out)
    if rc == 2:
        raise ValueError("pubkey invalid: not 33 bytes, bad prefix, x out of range "
                         "or not on curve")
    if rc != 0:
        raise ValueError("degenerate ECDH result")
    return hashlib.sha256(out.raw).digest()


def _ecdh_shared_secret_py(priv: bytes, pub: bytes) -> bytes:
    """`ecdh_shared_secret` in pure Python (the reference's form)."""
    pt = _mul(decompress_public_key(pub), int.from_bytes(priv, "big"))
    if pt is None:
        raise ValueError("degenerate ECDH result")
    return hashlib.sha256(_compress(pt)).digest()


def aes_gcm_encrypt(key: bytes, plaintext: bytes, rng) -> bytes:
    """nonce(12) || ciphertext || tag(16), the nonce drawn from `rng`."""
    from . import _aes_fallback

    nonce = rng.randbelow(1 << 96).to_bytes(12, "big")
    return nonce + _aes_fallback.encrypt(key, nonce, plaintext)


def aes_gcm_decrypt(key: bytes, data: bytes) -> bytes:
    """The plaintext of `aes_gcm_encrypt`'s output; ValueError when the
    payload is short or its tag does not verify."""
    from . import _aes_fallback

    if len(data) < 12 + 16:
        raise ValueError("AES-GCM payload too short")
    return _aes_fallback.decrypt(key, data[:12], data[12:])


def ecies_encrypt(pub: bytes, plaintext: bytes, rng) -> bytes:
    """ECIES = ephemeral ECDH + AES-GCM, the ephemeral key and the nonce
    drawn from `rng`. Layout: ephemeral compressed public key (33) ||
    nonce (12) || ciphertext || tag."""
    eph = generate_private_key(rng)
    key = ecdh_shared_secret(eph, pub)
    return public_key_bytes(eph) + aes_gcm_encrypt(key, plaintext, rng)


def ecies_decrypt(priv: bytes, data: bytes) -> bytes:
    if len(data) < 33 + 12 + 16:
        raise ValueError("ECIES payload too short")
    key = ecdh_shared_secret(priv, data[:33])
    return aes_gcm_decrypt(key, data[33:])


def recover_hash(msg_hash: bytes, sig: bytes) -> Optional[bytes]:
    """Recover the compressed public key from a 65-byte signature, or None:
    in the native library; a hash of irregular length takes
    `_recover_hash_py`, as in the reference."""
    if len(msg_hash) != 32:
        return _recover_hash_py(msg_hash, sig)
    out = ctypes.create_string_buffer(33)
    if _lib().lt_ec_recover(msg_hash, sig, len(sig), out) == 0:
        return out.raw
    return None


def _recover_hash_py(msg_hash: bytes, sig: bytes) -> Optional[bytes]:
    """`recover_hash` in pure Python (the reference's `_recover_hash_py`)."""
    if len(sig) != 65:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if not (1 <= r < N and 1 <= s < N) or v > 3:
        return None
    x = r + (N if v & 2 else 0)
    if x >= P:
        return None
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != (v & 1):
        y = P - y
    rp = (x, y)
    z = int.from_bytes(msg_hash, "big") % N
    rinv = _inv(r, N)
    q = _mul(_add(_mul(rp, s), _mul(G, N - z)), rinv)
    if q is None:
        return None
    return _compress(q)


# the batch recovery of each device, kept so that a caller can read the
# last call's phases (`batch_recoverer(device).last_timings`)
_RECOVERERS: dict = {}


def batch_recoverer(device="cuda"):
    """The `GpuEcdsaRecover` that `recover_hash_batch` runs on `device`
    (raises where the card is missing)."""
    from ..ops.secp import GpuEcdsaRecover

    rec = GpuEcdsaRecover(device)
    return _RECOVERERS.setdefault(str(rec.device), rec)


def recover_hash_batch(
    hashes: Sequence[bytes], sigs: Sequence[bytes], device="cuda"
) -> List[Optional[bytes]]:
    """Recover many signatures at once: the pool-ingest path. Every entry
    with a 32-byte hash and a 65-byte signature runs through
    `GpuEcdsaRecover` on `device` (the card unless the caller passes
    "cpu"); the others take `recover_hash`. Same results as `recover_hash`
    on every entry."""
    n = len(hashes)
    if n != len(sigs):
        raise ValueError("hashes/sigs length mismatch")
    rec = batch_recoverer(device)  # raises where the card is missing
    regular = [i for i in range(n) if len(hashes[i]) == 32 and len(sigs[i]) == 65]
    out: List[Optional[bytes]] = [None] * n
    got = rec.recover_batch([hashes[i] for i in regular], [sigs[i] for i in regular])
    for pos, i in enumerate(regular):
        out[i] = got[pos]
    regular_set = set(regular)
    for i in range(n):
        if i not in regular_set:
            out[i] = recover_hash(hashes[i], sigs[i])
    return out
