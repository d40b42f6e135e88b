"""Pure-Python AES-GCM: the port's copy of
`lachain_tpu/crypto/_aes_fallback.py`, which the port's
`ecdsa.aes_gcm_encrypt` / `aes_gcm_decrypt` always use (the reference
prefers the `cryptography` package when it is installed; the port imports
no optional package, and the output is the same bytes).

Wire-compatible with AESGCM: for a 12-byte nonce the output is
ciphertext||tag(16) over AES-128/192/256 in GCM per NIST SP 800-38D.
Throughput is irrelevant for the call sites (wallet blobs and ECIES
payloads, a few KB) — correctness and zero dependencies are the point.
"""
from __future__ import annotations

# -- AES block cipher -------------------------------------------------------

_SBOX = [
    0x63, 0x7C, 0x77, 0x7B, 0xF2, 0x6B, 0x6F, 0xC5, 0x30, 0x01, 0x67, 0x2B,
    0xFE, 0xD7, 0xAB, 0x76, 0xCA, 0x82, 0xC9, 0x7D, 0xFA, 0x59, 0x47, 0xF0,
    0xAD, 0xD4, 0xA2, 0xAF, 0x9C, 0xA4, 0x72, 0xC0, 0xB7, 0xFD, 0x93, 0x26,
    0x36, 0x3F, 0xF7, 0xCC, 0x34, 0xA5, 0xE5, 0xF1, 0x71, 0xD8, 0x31, 0x15,
    0x04, 0xC7, 0x23, 0xC3, 0x18, 0x96, 0x05, 0x9A, 0x07, 0x12, 0x80, 0xE2,
    0xEB, 0x27, 0xB2, 0x75, 0x09, 0x83, 0x2C, 0x1A, 0x1B, 0x6E, 0x5A, 0xA0,
    0x52, 0x3B, 0xD6, 0xB3, 0x29, 0xE3, 0x2F, 0x84, 0x53, 0xD1, 0x00, 0xED,
    0x20, 0xFC, 0xB1, 0x5B, 0x6A, 0xCB, 0xBE, 0x39, 0x4A, 0x4C, 0x58, 0xCF,
    0xD0, 0xEF, 0xAA, 0xFB, 0x43, 0x4D, 0x33, 0x85, 0x45, 0xF9, 0x02, 0x7F,
    0x50, 0x3C, 0x9F, 0xA8, 0x51, 0xA3, 0x40, 0x8F, 0x92, 0x9D, 0x38, 0xF5,
    0xBC, 0xB6, 0xDA, 0x21, 0x10, 0xFF, 0xF3, 0xD2, 0xCD, 0x0C, 0x13, 0xEC,
    0x5F, 0x97, 0x44, 0x17, 0xC4, 0xA7, 0x7E, 0x3D, 0x64, 0x5D, 0x19, 0x73,
    0x60, 0x81, 0x4F, 0xDC, 0x22, 0x2A, 0x90, 0x88, 0x46, 0xEE, 0xB8, 0x14,
    0xDE, 0x5E, 0x0B, 0xDB, 0xE0, 0x32, 0x3A, 0x0A, 0x49, 0x06, 0x24, 0x5C,
    0xC2, 0xD3, 0xAC, 0x62, 0x91, 0x95, 0xE4, 0x79, 0xE7, 0xC8, 0x37, 0x6D,
    0x8D, 0xD5, 0x4E, 0xA9, 0x6C, 0x56, 0xF4, 0xEA, 0x65, 0x7A, 0xAE, 0x08,
    0xBA, 0x78, 0x25, 0x2E, 0x1C, 0xA6, 0xB4, 0xC6, 0xE8, 0xDD, 0x74, 0x1F,
    0x4B, 0xBD, 0x8B, 0x8A, 0x70, 0x3E, 0xB5, 0x66, 0x48, 0x03, 0xF6, 0x0E,
    0x61, 0x35, 0x57, 0xB9, 0x86, 0xC1, 0x1D, 0x9E, 0xE1, 0xF8, 0x98, 0x11,
    0x69, 0xD9, 0x8E, 0x94, 0x9B, 0x1E, 0x87, 0xE9, 0xCE, 0x55, 0x28, 0xDF,
    0x8C, 0xA1, 0x89, 0x0D, 0xBF, 0xE6, 0x42, 0x68, 0x41, 0x99, 0x2D, 0x0F,
    0xB0, 0x54, 0xBB, 0x16,
]

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _expand_key(key: bytes) -> list:
    nk = len(key) // 4
    if nk not in (4, 6, 8):
        raise ValueError("AES key must be 16/24/32 bytes")
    nr = nk + 6
    words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        w = list(words[i - 1])
        if i % nk == 0:
            w = [_SBOX[b] for b in w[1:] + w[:1]]
            w[0] ^= _RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            w = [_SBOX[b] for b in w]
        words.append([a ^ b for a, b in zip(words[i - nk], w)])
    # one flat 16-byte round key per round
    return [
        sum(words[4 * r : 4 * r + 4], []) for r in range(nr + 1)
    ]


def _encrypt_block(round_keys: list, block: bytes) -> bytes:
    nr = len(round_keys) - 1
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, nr):
        s = [_SBOX[b] for b in s]
        # ShiftRows on column-major state: row r rotates left by r
        s = [s[(i + 4 * ((i % 4))) % 16] for i in range(16)]
        t = []
        for c in range(0, 16, 4):
            a0, a1, a2, a3 = s[c : c + 4]
            t += [
                _xtime(a0) ^ _xtime(a1) ^ a1 ^ a2 ^ a3,
                a0 ^ _xtime(a1) ^ _xtime(a2) ^ a2 ^ a3,
                a0 ^ a1 ^ _xtime(a2) ^ _xtime(a3) ^ a3,
                _xtime(a0) ^ a0 ^ a1 ^ a2 ^ _xtime(a3),
            ]
        s = [b ^ k for b, k in zip(t, round_keys[rnd])]
    s = [_SBOX[b] for b in s]
    s = [s[(i + 4 * ((i % 4))) % 16] for i in range(16)]
    return bytes(b ^ k for b, k in zip(s, round_keys[nr]))


# -- GCM --------------------------------------------------------------------

_R = 0xE1 << 120


def _gmul(x: int, y: int) -> int:
    z = 0
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= x
        x = (x >> 1) ^ _R if x & 1 else x >> 1
    return z


def _ghash(h: int, data: bytes) -> int:
    y = 0
    for i in range(0, len(data), 16):
        blk = data[i : i + 16]
        y = _gmul(int.from_bytes(blk, "big") ^ y, h)
    return y


def _pad16(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 16)


def _gcm_core(key: bytes, nonce: bytes, data: bytes, aad: bytes):
    """Returns (ctr_stream(data), tag_for(aad, processed_output)) pieces:
    the CTR keystream XOR and a closure computing the tag over a given
    ciphertext — encrypt tags its output, decrypt tags its input."""
    if len(nonce) != 12:
        raise ValueError("GCM fallback supports 96-bit nonces only")
    rk = _expand_key(key)
    h = int.from_bytes(_encrypt_block(rk, b"\x00" * 16), "big")
    j0 = nonce + b"\x00\x00\x00\x01"
    out = bytearray()
    ctr = int.from_bytes(j0[12:], "big")
    for i in range(0, len(data), 16):
        ctr = (ctr + 1) & 0xFFFFFFFF
        ks = _encrypt_block(rk, nonce + ctr.to_bytes(4, "big"))
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
    ek_j0 = int.from_bytes(_encrypt_block(rk, j0), "big")

    def tag(ciphertext: bytes) -> bytes:
        lengths = (len(aad) * 8).to_bytes(8, "big") + (
            len(ciphertext) * 8
        ).to_bytes(8, "big")
        s = _ghash(h, _pad16(aad) + _pad16(ciphertext) + lengths)
        return (s ^ ek_j0).to_bytes(16, "big")

    return bytes(out), tag


def encrypt(key: bytes, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    ct, tag = _gcm_core(key, nonce, plaintext, aad)
    return ct + tag(ct)


def decrypt(key: bytes, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
    if len(data) < 16:
        raise ValueError("ciphertext shorter than GCM tag")
    ct, want = data[:-16], data[-16:]
    pt, tag = _gcm_core(key, nonce, ct, aad)
    got = tag(ct)
    # constant-time-ish compare (hmac.compare_digest without the import
    # ceremony would be fine too; this is not a remote oracle)
    import hmac

    if not hmac.compare_digest(got, want):
        raise ValueError("GCM tag mismatch")
    return pt
