"""The host backend on the native BLS12-381 library (ctypes).

The port's copy of the subset of `lachain_tpu/crypto/native_backend.py`
(:63-235) that `GpuBackend`, its era pipelines and the consensus
protocols use: the grand multi-pairing (`pairing_check`), `hash_to_g2`,
`g1_mul`, `g2_mul`, `g1_mul_batch` (a node's TPKE decryption shares of an
era tick, a DKG commitment), `g1_msm`, `g1_msm_batch` (the port's: HostBackend's
loop, one `g1_msm` a group), `g2_msm`, and the wire checks that raise
`ValueError` on a bad point (`g1_deserialize`, `g2_deserialize`). The library is the port's copy
of the JAX package's C++ sources (`crypto/native/`), built by
`ops/_build.host_library()` into `lachain_tpu_torch/_build/`; a missing
compiler or a failed build raises, and nothing falls back to pure Python.
Pure Python runs only where a caller passes `host.HostBackend()`.

Points cross the boundary in the port's own wire format (`bls12381.py`:
big-endian affine, zeros for infinity), so results come back as affine
tuples (Z = 1); they are the same group elements `HostBackend` returns
(tests/test_torch_native_host.py). `load_lib` also types the library's
secp256k1 ECDSA entries, which `crypto/ecdsa.py` calls (the reference
calls them untyped through its `_native_lib`). Imports no torch.
"""
from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

from . import bls12381 as bls
from .host import HostBackend
from ..ops import _build

_B = ctypes.c_char_p
_N = ctypes.c_size_t
_I = ctypes.c_int
_SIGNATURES = {
    "lt_version": [],
    "lt_g1_mul": [_B, _B, _B],
    "lt_g2_mul": [_B, _B, _B],
    "lt_g1_msm": [_B, _B, _N, _B],
    "lt_g1_mul_batch": [_B, _B, _N, _I, _B],
    "lt_g2_msm": [_B, _B, _N, _B],
    "lt_pairing_check": [_B, _B, _N],
    "lt_pairing_check_mt": [_B, _B, _N, _I],
    "lt_hash_to_g2": [_B, _N, _B, _N, _B],
    "lt_g1_check": [_B],
    "lt_g2_check": [_B],
    # secp256k1 ECDSA and ECDH (crypto/native/secp256k1.cpp:647-911), the
    # entries crypto/ecdsa.py calls: 0 = ok for pubkey, ecdh, sign and
    # recover; 1 = valid for verify; the batches fill one byte per entry of
    # `oks`
    "lt_ec_pubkey": [_B, _B],
    "lt_ec_ecdh": [_B, _B, _N, _B],
    "lt_ec_sign": [_B, _B, _B],
    "lt_ec_verify": [_B, _B, _B, _N],
    "lt_ec_recover": [_B, _B, _N, _B],
    "lt_ec_recover_batch": [_B, _B, _N, _I, _B, _B],
    "lt_ec_verify_batch": [_B, _B, _B, _N, _I, _B],
}
# a product of at least this many pairs spreads its Miller loops over
# threads (lt_pairing_check_mt); below it thread start-up would dominate
MT_PAIRS = 8


def load_lib():
    """The host library with its entry points' argument types set."""
    lib = _build.host_library()
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _I
    if lib.lt_version() != 1:
        raise RuntimeError("host library: unexpected lt_version")
    return lib


def _scalar32(s: int) -> bytes:
    return (s % bls.R).to_bytes(32, "big")


class NativeBackend:
    """Group ops, pairings and hashing on the host, in the native library."""

    name = "native"

    def __init__(self):
        self._lib = load_lib()

    # -- group ops -----------------------------------------------------------
    def g1_mul(self, point: tuple, scalar: int) -> tuple:
        out = ctypes.create_string_buffer(bls.G1_BYTES)
        if self._lib.lt_g1_mul(bls.g1_to_bytes(point), _scalar32(scalar), out):
            raise ValueError("native g1_mul: bad point encoding")
        return bls.g1_from_bytes(out.raw, check_subgroup=False)

    def g2_mul(self, point: tuple, scalar: int) -> tuple:
        out = ctypes.create_string_buffer(bls.G2_BYTES)
        if self._lib.lt_g2_mul(bls.g2_to_bytes(point), _scalar32(scalar), out):
            raise ValueError("native g2_mul: bad point encoding")
        return bls.g2_from_bytes(out.raw, check_subgroup=False)

    def g1_mul_batch(self, points: Sequence[tuple], scalars: Sequence[int]) -> list:
        """n independent products points[i] * scalars[i] (no sum) in one
        threaded call: a node's decryption shares of an era tick."""
        if len(points) != len(scalars):
            raise ValueError("g1_mul_batch: points/scalars length mismatch")
        if not points:
            return []
        pts = b"".join(bls.g1_to_bytes(p) for p in points)
        ss = b"".join(_scalar32(s) for s in scalars)
        out = ctypes.create_string_buffer(bls.G1_BYTES * len(points))
        threads = min(os.cpu_count() or 1, 16)
        if self._lib.lt_g1_mul_batch(pts, ss, len(points), threads, out):
            raise ValueError("native g1_mul_batch: bad point encoding")
        raw = out.raw
        return [bls.g1_from_bytes(raw[i * bls.G1_BYTES:(i + 1) * bls.G1_BYTES],
                                  check_subgroup=False) for i in range(len(points))]

    def g1_msm(self, points: Sequence[tuple], scalars: Sequence[int]) -> tuple:
        if len(points) != len(scalars):
            raise ValueError("g1_msm: points/scalars length mismatch")
        if not points:
            return bls.G1_INF
        pts = b"".join(bls.g1_to_bytes(p) for p in points)
        ss = b"".join(_scalar32(s) for s in scalars)
        out = ctypes.create_string_buffer(bls.G1_BYTES)
        if self._lib.lt_g1_msm(pts, ss, len(points), out):
            raise ValueError("native g1_msm: bad point encoding")
        return bls.g1_from_bytes(out.raw, check_subgroup=False)

    g1_msm_batch = HostBackend.g1_msm_batch

    def g2_msm(self, points: Sequence[tuple], scalars: Sequence[int]) -> tuple:
        if len(points) != len(scalars):
            raise ValueError("g2_msm: points/scalars length mismatch")
        if not points:
            return bls.G2_INF
        pts = b"".join(bls.g2_to_bytes(p) for p in points)
        ss = b"".join(_scalar32(s) for s in scalars)
        out = ctypes.create_string_buffer(bls.G2_BYTES)
        if self._lib.lt_g2_msm(pts, ss, len(points), out):
            raise ValueError("native g2_msm: bad point encoding")
        return bls.g2_from_bytes(out.raw, check_subgroup=False)

    # -- pairings ------------------------------------------------------------
    def pairing_check(self, pairs: Sequence[Tuple[tuple, tuple]]) -> bool:
        """Prod e(P_i, Q_i) == 1 with one shared final exponentiation. A
        product of MT_PAIRS pairs or more (the era's grand check, 2 pairs a
        slot) runs its independent Miller loops on up to 16 threads."""
        if not pairs:
            return True
        g1s = b"".join(bls.g1_to_bytes(p) for p, _ in pairs)
        g2s = b"".join(bls.g2_to_bytes(q) for _, q in pairs)
        if len(pairs) >= MT_PAIRS:
            threads = min(os.cpu_count() or 1, 16)
            rc = self._lib.lt_pairing_check_mt(g1s, g2s, len(pairs), threads)
        else:
            rc = self._lib.lt_pairing_check(g1s, g2s, len(pairs))
        if rc < 0:
            raise ValueError("native pairing_check: bad point encoding")
        return rc == 1

    # -- hashing -------------------------------------------------------------
    def hash_to_g2(self, msg: bytes, domain: bytes = b"LTPU-G2") -> tuple:
        out = ctypes.create_string_buffer(bls.G2_BYTES)
        self._lib.lt_hash_to_g2(msg, len(msg), domain, len(domain), out)
        return bls.g2_from_bytes(out.raw, check_subgroup=False)

    # -- wire deserialization (native on-curve + subgroup check) -------------
    def g1_deserialize(self, data: bytes) -> tuple:
        if len(data) != bls.G1_BYTES:
            raise ValueError("bad G1 encoding length")
        if self._lib.lt_g1_check(data) != 2:
            raise ValueError("G1 point invalid or not in subgroup")
        return bls.g1_from_bytes(data, check_subgroup=False)

    def g2_deserialize(self, data: bytes) -> tuple:
        if len(data) != bls.G2_BYTES:
            raise ValueError("bad G2 encoding length")
        if self._lib.lt_g2_check(data) != 2:
            raise ValueError("G2 point invalid or not in subgroup")
        return bls.g2_from_bytes(data, check_subgroup=False)
