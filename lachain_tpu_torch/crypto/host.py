"""Host crypto ops of the port: the pure-Python oracle behind a backend API.

The subset of `lachain_tpu/crypto/provider.py` that the TPKE and coin era
paths and the consensus protocols use (with the checked deserializers): pairings and hash-to-curve stay on the host, as they do in the
JAX package, and the era pipelines' escapes to the host MSM and their host
oracles run the G1 and G2 MSMs here. `batch_bisect_verify` is the shared RLC
bisection loop; `select_distinct` picks the shares of a combine.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from . import bls12381 as bls


class HostBackend:
    """Group ops, pairings and hashing on the host (pure Python): the
    oracle of the port's host pipelines and of its native backend."""

    name = "python"

    def g1_msm(self, points: Sequence[tuple], scalars: Sequence[int]) -> tuple:
        acc = bls.G1_INF
        for pt, s in zip(points, scalars):
            acc = bls.g1_add(acc, bls.g1_mul(pt, s))
        return acc

    def g1_msm_batch(self, point_lists, scalar_lists) -> list:
        """`g1_msm` of each group (GpuBackend's batch, one call a group)."""
        if len(point_lists) != len(scalar_lists):
            raise ValueError("one scalar list per point list")
        return [self.g1_msm(p, s) for p, s in zip(point_lists, scalar_lists)]

    def g2_msm(self, points: Sequence[tuple], scalars: Sequence[int]) -> tuple:
        acc = bls.G2_INF
        for pt, s in zip(points, scalars):
            acc = bls.g2_add(acc, bls.g2_mul(pt, s))
        return acc

    def g1_mul(self, point: tuple, scalar: int) -> tuple:
        return bls.g1_mul(point, scalar)

    def g2_mul(self, point: tuple, scalar: int) -> tuple:
        return bls.g2_mul(point, scalar)

    def pairing_check(self, pairs: Sequence[Tuple[tuple, tuple]]) -> bool:
        """Prod e(Pi, Qi) == 1 with one shared final exponentiation."""
        return bls.fp12_eq_one(bls.multi_pairing(pairs))

    def hash_to_g2(self, msg: bytes, domain: bytes = b"LTPU-G2") -> tuple:
        return bls.hash_to_g2(msg, domain)

    def g1_deserialize(self, data: bytes) -> tuple:
        """Wire bytes -> point, on-curve and subgroup checked (ValueError)."""
        if len(data) != bls.G1_BYTES:
            raise ValueError("bad G1 encoding length")
        return bls.g1_from_bytes(data, check_subgroup=True)

    def g2_deserialize(self, data: bytes) -> tuple:
        if len(data) != bls.G2_BYTES:
            raise ValueError("bad G2 encoding length")
        return bls.g2_from_bytes(data, check_subgroup=True)


def batch_bisect_verify(group_ok, n: int) -> List[bool]:
    """Per-item validity from a probabilistic subset check `group_ok(idx)`:
    one check when everything is valid, O(log n) checks per invalid item."""
    results = [False] * n

    def solve(idx):
        if group_ok(idx):
            for i in idx:
                results[i] = True
            return
        if len(idx) == 1:
            return
        mid = len(idx) // 2
        solve(idx[:mid])
        solve(idx[mid:])

    if n:
        solve(list(range(n)))
    return results


def select_distinct(shares, key, count: int):
    """First `count` shares with distinct `key(share)`, or None if impossible.

    Used before Lagrange combination: duplicates are skipped (not an error)
    so a caller holding [id0, id0, id1, id2] can still combine t+1 = 3
    distinct shares.
    """
    seen = set()
    out = []
    for s in shares:
        k = key(s)
        if k in seen:
            continue
        seen.add(k)
        out.append(s)
        if len(out) == count:
            return out
    return None
