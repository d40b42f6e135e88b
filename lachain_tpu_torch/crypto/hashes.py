"""Hash primitives of the port: the TPKE pad's XOF, Keccak-256 and the
Merkle root.

Copies of `lachain_tpu/crypto/hashes.py:xof`, of its pure-Python
Keccak-256 sponge (the legacy pre-NIST padding; hashlib ships only NIST
SHA-3), of `keccak256_batch` (:123) and of `merkle_root` (:194). The coin
bit `threshold_sig.Signature.parity` is the low bit of keccak256 of the
serialized signature, so it must equal the JAX package's.

`keccak256_batch` hashes a whole batch in one call of the port's host
library (`lt_keccak256_batch`, `crypto/native/bls381.cpp`, threaded in
C++, built by `ops/_build.host_library()`); without the library it
raises, where the reference falls back to hashing item by item. The
Merkle roots hash each level of every tree in one such call.

The consensus path's per-message hashes (an RBC shard's leaf, a Merkle
branch's nodes) take `keccak256_host`, one item in one call of the same
library (`lt_keccak256`, the reference's native `keccak256`), which
raises without it too. `merkle_proof` / `merkle_verify` are the
reference's (:214-248); `merkle_proofs` gives every leaf's branch of one
tree, each level hashed in one `keccak256_batch` call. `sha256` (:174)
serves the VRF and the ECDSA key cache.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Optional, Sequence


def xof(domain: bytes, data: bytes, nbytes: int) -> bytes:
    """SHAKE-256 XOF with a length-prefixed domain tag."""
    h = hashlib.shake_256()
    h.update(len(domain).to_bytes(1, "big") + domain + data)
    return h.digest(nbytes)


_KECCAK_ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rol(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & _MASK


def _keccak_f(a: List[List[int]]) -> None:
    for rnd in range(_KECCAK_ROUNDS):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 with legacy 0x01 padding (Ethereum-style), not SHA3-256."""
    rate = 136
    state = [[0] * 5 for _ in range(5)]
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % rate:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : i * 8 + 8], "little")
            state[i % 5][i // 5] ^= lane
        _keccak_f(state)
    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        out += state[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


_BATCH_FN: list = []
_ONE_FN: list = []


def _batch_fn():
    """lt_keccak256_batch of the host library, bound on first use (the
    import of the build stays out of the protocol modules' import)."""
    if not _BATCH_FN:
        from ..ops import _build

        fn = _build.host_library().lt_keccak256_batch
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                       ctypes.c_size_t, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_ubyte)]
        fn.restype = ctypes.c_int
        _BATCH_FN.append(fn)
    return _BATCH_FN[0]


def _one_fn():
    """lt_keccak256 of the host library, bound on first use."""
    if not _ONE_FN:
        from ..ops import _build

        fn = _build.host_library().lt_keccak256
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
        fn.restype = None
        _ONE_FN.append(fn)
    return _ONE_FN[0]


def keccak256_host(data: bytes) -> bytes:
    """keccak256(data) in one call of the host library: the value of
    `keccak256`, at the speed the consensus path's per-message hashes
    need."""
    out = ctypes.create_string_buffer(32)
    _one_fn()(data, len(data), out)
    return out.raw


def keccak256_batch(items: Sequence[bytes], nthreads: int = 0) -> List[bytes]:
    """keccak256 of every item, in ONE call of the host library (threaded
    in C++, the GIL released)."""
    n = len(items)
    if n == 0:
        return []
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    offsets = (ctypes.c_uint64 * (n + 1))()
    total = 0
    for i, d in enumerate(items):
        offsets[i] = total
        total += len(d)
    offsets[n] = total
    out = (ctypes.c_ubyte * (n * 32))()
    rc = _batch_fn()(b"".join(items), offsets, n, nthreads, out)
    if rc != 0:
        raise RuntimeError(f"lt_keccak256_batch failed: {rc}")
    raw = bytes(out)
    return [raw[i * 32 : (i + 1) * 32] for i in range(n)]


def merkle_roots(trees: Sequence[Sequence[bytes]]) -> List[Optional[bytes]]:
    """merkle_root of every tree; each level of all the trees is hashed in
    one keccak256_batch call."""
    levels = [list(t) for t in trees]
    while True:
        pairs, spans = [], []
        for level in levels:
            lo = len(pairs)
            pairs += [level[i] + level[i + 1] for i in range(0, len(level) - 1, 2)]
            spans.append((lo, len(pairs)))
        if not pairs:
            return [level[0] if level else None for level in levels]
        hashed = keccak256_batch(pairs)
        for t, (lo, hi) in enumerate(spans):
            if hi > lo:
                odd = [levels[t][-1]] if len(levels[t]) % 2 else []
                levels[t] = hashed[lo:hi] + odd


def merkle_root(leaves: Sequence[bytes]) -> Optional[bytes]:
    """Binary Merkle root over 32-byte leaf hashes: pairwise
    keccak256(left || right), the odd node promoted unchanged (the shape
    of the reference's MerkleTree.ComputeRoot); None for no leaves."""
    return merkle_roots([leaves])[0]


def _levels(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """Every level of the Merkle tree over `leaves`, the leaves first."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        level = levels[-1]
        hashed = keccak256_batch(
            [level[i] + level[i + 1] for i in range(0, len(level) - 1, 2)])
        levels.append(hashed + ([level[-1]] if len(level) % 2 else []))
    return levels


def merkle_proofs(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """merkle_proof(leaves, i) for every i, from one tree."""
    levels = _levels(leaves)
    return [
        [level[(i >> d) ^ 1] if (i >> d) ^ 1 < len(level) else b""
         for d, level in enumerate(levels[:-1])]
        for i in range(len(leaves))
    ]


def merkle_proof(leaves: Sequence[bytes], index: int) -> List[bytes]:
    """Sibling path for leaves[index] (b"" where the node was promoted
    unchanged); verify with merkle_verify."""
    return merkle_proofs(leaves)[index]


def merkle_verify(
    leaf: bytes, index: int, proof: Sequence[bytes], root: bytes
) -> bool:
    node = leaf
    idx = index
    for sib in proof:
        if sib == b"":
            pass  # promoted unchanged
        elif idx % 2 == 0:
            node = keccak256_host(node + sib)
        else:
            node = keccak256_host(sib + node)
        idx //= 2
    return node == root
