"""Batched wire parsing of G1 and G2 points for the consensus protocols.

The port of `deserialize_batch_g1` / `deserialize_batch_g2` and
`_memo_parse` (`lachain_tpu/crypto/provider.py:118-165`), without the
global provider: the caller passes the `backend` whose checked
deserializers (`g1_deserialize` / `g2_deserialize`, on-curve and subgroup
checks that raise ValueError) parse each point, and, to parse each
distinct encoding once across the validators of one process, a
`CryptoMemo`. Every point gets a sound per-point subgroup check: a random
linear combination over the batch is not sound here (the cofactors have
small prime factors), so the batching wins are only the lazy parse (the
protocols parse just the shares they combine) and the memo by exact
bytes. Imports no torch.
"""
from __future__ import annotations

from typing import Optional, Sequence


class CryptoMemo:
    """Memo tables of pure crypto verdicts, shared by the validators of one
    process (in the simulator all of them receive the same broadcast
    bytes): `g1` / `g2` map wire bytes to the parsed point (None where
    invalid), `ct_valid` maps a ciphertext (u, v, w) to its validity
    (tpke.batch_verify_ciphertexts). Each table is cleared whole when it
    reaches `cap` entries."""

    def __init__(self, cap: int = 1 << 18):
        self.cap = cap
        self.g1: dict = {}
        self.g2: dict = {}
        self.ct_valid: dict = {}

    def put(self, table: dict, key, value) -> None:
        if len(table) >= self.cap:
            table.clear()
        table[key] = value


def _parse(data: bytes, parse, table: Optional[dict], memo):
    if table is not None:
        hit = table.get(data)
        if hit is not None or data in table:
            return hit
    try:
        pt = parse(data)
    except (ValueError, AssertionError):
        pt = None
    if table is not None:
        memo.put(table, bytes(data), pt)
    return pt


def deserialize_batch_g1(datas: Sequence[bytes], backend,
                         memo: Optional[CryptoMemo] = None) -> list:
    """Parse many G1 encodings with `backend.g1_deserialize`; invalid
    entries come back as None."""
    table = memo.g1 if memo is not None else None
    return [_parse(d, backend.g1_deserialize, table, memo) for d in datas]


def deserialize_batch_g2(datas: Sequence[bytes], backend,
                         memo: Optional[CryptoMemo] = None) -> list:
    """G2 analogue of deserialize_batch_g1 (same per-point soundness)."""
    table = memo.g2 if memo is not None else None
    return [_parse(d, backend.g2_deserialize, table, memo) for d in datas]
