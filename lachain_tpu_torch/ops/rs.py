"""GF(2^8) Reed-Solomon erasure coding, vectorized over byte columns: the
scalar host codec and the port's oracle for the batched one.

A copy of `lachain_tpu/ops/rs.py` (numpy only): `encode`, `decode`,
`reencode` and the Gauss-Jordan `_gf_mat_inv`, with the same tables and
byte layouts. Its n > 255 branches delegate to the port's batched codec
(`ops/rs_batch.py`) on the CPU (`device="cpu"`, its plain PyTorch
product), as the reference's delegate to its own.

Design: Vandermonde-evaluation Reed-Solomon. A payload is split into K data
shards; each byte column of the K shards is a degree-(K-1) polynomial's
coefficient vector, evaluated at N fixed points to produce N code shards.
Any K received shards reconstruct by interpolation.

Field: GF(2^8) with the reduction polynomial x^8+x^4+x^3+x^2+1 (0x11D).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_POLY = 0x11D

# exp/log tables: generator 2 is primitive for 0x11D.
_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(_EXP[255 - _LOG[a]])


def _gf_mul_vec(c: int, v: np.ndarray) -> np.ndarray:
    """c * v for a scalar c and uint8 vector v."""
    if c == 0:
        return np.zeros_like(v)
    if c == 1:
        return v.copy()
    out = np.zeros_like(v)
    nz = v != 0
    out[nz] = _EXP[_LOG[c] + _LOG[v[nz]]]
    return out


def _eval_points(n: int) -> List[int]:
    # x-coordinates 1..n (0 excluded so Vandermonde stays invertible)
    assert n < 256, "GF(2^8) RS supports at most 255 shards"
    return list(range(1, n + 1))


def encode(data: bytes, k: int, n: int) -> List[bytes]:
    """Split `data` into k data shards and RS-extend to n total shards.

    Shard layout: data is left-padded with a 4-byte length prefix then
    zero-padded to k * shard_size; shard j holds coefficient j of each column
    polynomial. Returns n shards of equal size.
    """
    assert 0 < k <= n
    if n > 255:
        # GF(2^8) has only 255 distinct evaluation points; past that the
        # codec switches to GF(2^16) symbols (rs_batch.py) behind the same
        # API, on the host
        from . import rs_batch

        return rs_batch.encode(data, k, n, device="cpu")
    prefixed = len(data).to_bytes(4, "big") + data
    shard_size = (len(prefixed) + k - 1) // k
    padded = prefixed + b"\x00" * (k * shard_size - len(prefixed))
    coeffs = np.frombuffer(padded, dtype=np.uint8).reshape(k, shard_size)
    shards = []
    for x in _eval_points(n):
        # Horner: p(x) = (...((c_{k-1} x) + c_{k-2}) x + ...) + c_0
        acc = np.zeros(shard_size, dtype=np.uint8)
        for j in range(k - 1, -1, -1):
            acc = _gf_mul_vec(x, acc) ^ coeffs[j]
        shards.append(acc.tobytes())
    return shards


def decode(shards: Sequence[Optional[bytes]], k: int) -> Optional[bytes]:
    """Reconstruct the payload from any k non-None shards.

    `shards` is the full n-length list with None for missing entries, in
    eval-point order. Returns None if fewer than k shards are present or the
    length prefix is inconsistent.
    """
    n = len(shards)
    have = [(i, s) for i, s in enumerate(shards) if s is not None]
    if len(have) < k:
        return None
    have = have[:k]
    size = len(have[0][1])
    # adversarial-input guard: a malicious proposer can commit a Merkle
    # root over DIFFERENT-SIZED shards (each with a valid branch); mixed
    # sizes must be a clean decode failure, not a crash (np.stack raises)
    if any(len(s) != size for _, s in have):
        return None
    if n > 255:
        # GF(2^16) symbols (see encode): delegate to the batched codec's
        # single-item path, which applies the same first-k / mixed-size /
        # length-prefix guards plus the even-byte symbol check
        from . import rs_batch

        return rs_batch.decode(shards, k, device="cpu")
    xs = [_eval_points(n)[i] for i, _ in have]
    mat = np.zeros((k, k), dtype=np.uint8)  # Vandermonde rows [x^0 .. x^{k-1}]
    for r, x in enumerate(xs):
        v = 1
        for c in range(k):
            mat[r, c] = v
            v = gf_mul(v, x)
    inv = _gf_mat_inv(mat)
    if inv is None:
        return None
    received = np.stack(
        [np.frombuffer(s, dtype=np.uint8) for _, s in have]
    )  # (k, size)
    coeffs = np.zeros((k, size), dtype=np.uint8)
    for r in range(k):
        acc = np.zeros(size, dtype=np.uint8)
        for c in range(k):
            acc ^= _gf_mul_vec(int(inv[r, c]), received[c])
        coeffs[r] = acc
    flat = coeffs.reshape(-1).tobytes()
    if len(flat) < 4:
        return None
    length = int.from_bytes(flat[:4], "big")
    if length > len(flat) - 4:
        return None
    return flat[4 : 4 + length]


def reencode(shards: Sequence[Optional[bytes]], k: int) -> Optional[List[bytes]]:
    """Reconstruct ALL n shards from any k (for Merkle-root recheck in RBC)."""
    n = len(shards)
    payload = decode(shards, k)
    if payload is None:
        return None
    return encode(payload, k, n)


def _gf_mat_inv(mat: np.ndarray) -> Optional[np.ndarray]:
    """Gauss-Jordan inversion over GF(2^8)."""
    k = mat.shape[0]
    a = mat.astype(np.int32).copy()
    inv = np.eye(k, dtype=np.int32)
    for col in range(k):
        piv = None
        for r in range(col, k):
            if a[r, col] != 0:
                piv = r
                break
        if piv is None:
            return None
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        pinv = gf_inv(int(a[col, col]))
        for c in range(k):
            a[col, c] = gf_mul(int(a[col, c]), pinv)
            inv[col, c] = gf_mul(int(inv[col, c]), pinv)
        for r in range(k):
            if r == col or a[r, col] == 0:
                continue
            f = int(a[r, col])
            for c in range(k):
                a[r, c] ^= gf_mul(f, int(a[col, c]))
                inv[r, c] ^= gf_mul(f, int(inv[col, c]))
    return inv.astype(np.uint8)
