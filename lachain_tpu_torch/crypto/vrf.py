"""ECVRF over secp256k1 and the stake-weighted lottery.

The port's copy of `lachain_tpu/crypto/vrf.py` over the port's `ecdsa` and
`hashes.sha256`, bytes for bytes: the reference's construction and domain
separation (ECVRF-SECP256K1-SHA256-TAI shape, RFC 9381 structure),
  prove : H = try-and-increment hash-to-curve(pk, alpha)
          Gamma = H^sk;  k = a nonce from sk and H
          c = H2(H, Gamma, g^k, H^k);  s = k + c*sk mod n
  verify: U = g^s - pk^c;  V = H^s - Gamma^c;  recompute c
  beta  = sha256(domain || Gamma)  — the lottery roll.
`is_winner` is the reference's exact-integer Bernoulli rule: a staker
with `stake` of `total_stake` rolling for `seats` seats wins iff
  beta/2^256 < 1 - (1 - seats/total)^stake.
Pure Python; imports no torch.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

from . import ecdsa as ec
from .hashes import sha256

_PROVE_DOMAIN = b"LTPU-VRF"


def _point_to_bytes(pt: Tuple[int, int]) -> bytes:
    return bytes([0x02 | (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def _bytes_to_point(b: bytes) -> Tuple[int, int]:
    return ec.decompress_public_key(b)


def _hash_to_curve(pk: bytes, alpha: bytes) -> Tuple[int, int]:
    """Try-and-increment onto secp256k1."""
    ctr = 0
    while True:
        h = sha256(_PROVE_DOMAIN + b"|h2c|" + pk + alpha + ctr.to_bytes(4, "big"))
        x = int.from_bytes(h, "big")
        if x < ec.P:
            y2 = (pow(x, 3, ec.P) + 7) % ec.P
            y = pow(y2, (ec.P + 1) // 4, ec.P)
            if y * y % ec.P == y2:
                return (x, y if y % 2 == 0 else ec.P - y)
        ctr += 1


def _challenge(*points: Tuple[int, int]) -> int:
    h = hashlib.sha256()
    h.update(_PROVE_DOMAIN + b"|c|")
    for pt in points:
        h.update(_point_to_bytes(pt))
    return int.from_bytes(h.digest()[:16], "big")  # 128-bit challenge


def _nonce(sk: bytes, hbytes: bytes) -> int:
    return (
        int.from_bytes(sha256(_PROVE_DOMAIN + b"|k|" + sk + hbytes), "big")
        % ec.N
    ) or 1


def evaluate(sk: bytes, alpha: bytes) -> Tuple[bytes, bytes]:
    """Returns (proof, beta). Proof = Gamma(33) || c(16) || s(32) = 81 bytes.

    Role of Vrf.Evaluate (ValidatorStatusManager.cs:437)."""
    pk = ec.public_key_bytes(sk)
    h_pt = _hash_to_curve(pk, alpha)
    x = int.from_bytes(sk, "big")
    gamma = ec._mul(h_pt, x)
    k = _nonce(sk, _point_to_bytes(h_pt))
    g_k = ec._mul(ec.G, k)
    h_k = ec._mul(h_pt, k)
    c = _challenge(h_pt, gamma, g_k, h_k)
    s = (k + c * x) % ec.N
    proof = _point_to_bytes(gamma) + c.to_bytes(16, "big") + s.to_bytes(32, "big")
    return proof, proof_to_hash(proof)


def verify(pk: bytes, alpha: bytes, proof: bytes) -> bool:
    """Role of Vrf.Verify."""
    if len(proof) != 81:
        return False
    try:
        gamma = _bytes_to_point(proof[:33])
        q = ec.decompress_public_key(pk)
    except (ValueError, AssertionError):
        return False
    c = int.from_bytes(proof[33:49], "big")
    s = int.from_bytes(proof[49:81], "big")
    if not (0 < s < ec.N):
        return False
    h_pt = _hash_to_curve(pk, alpha)
    # U = g^s - pk^c ; V = H^s - Gamma^c
    neg = lambda pt: (pt[0], ec.P - pt[1])
    u = ec._add(ec._mul(ec.G, s), neg(ec._mul(q, c)))
    v = ec._add(ec._mul(h_pt, s), neg(ec._mul(gamma, c)))
    if u is None or v is None:
        return False
    return _challenge(h_pt, gamma, u, v) == c


def proof_to_hash(proof: bytes) -> bytes:
    """beta — the uniform lottery roll (role of Vrf.ProofToHash,
    StakingContract.cs:534)."""
    return sha256(_PROVE_DOMAIN + b"|beta|" + proof[:33])


def is_winner(
    beta: bytes, stake: int, total_stake: int, seats: int
) -> bool:
    """Stake-weighted election: P(win) = 1 - (1 - seats/total)^stake.

    Exact integer evaluation: beta/2^256 < 1 - ((total-seats)/total)^stake
      <=>  (beta_int) * total^stake < (2^256) * (total^stake - (total-seats)^stake)
    (role of Vrf.IsWinner, StakingContract.cs:520).
    """
    if stake <= 0 or total_stake <= 0:
        return False
    if seats >= total_stake:
        return True
    beta_int = int.from_bytes(beta, "big")
    # (1 - seats/total)^stake in Q.256 fixed point via square-and-multiply
    # with floor rounding — exact integer ops, so every node computes the
    # identical bit pattern (consensus-safe), cost O(256 * log2(stake)).
    SHIFT = 256
    q = ((total_stake - seats) << SHIFT) // total_stake
    result = 1 << SHIFT
    base = q
    e = stake
    while e:
        if e & 1:
            result = (result * base) >> SHIFT
        base = (base * base) >> SHIFT
        e >>= 1
    lose_fp = result  # floor of (1 - seats/total)^stake * 2^256
    return beta_int < (1 << SHIFT) - lose_fp
