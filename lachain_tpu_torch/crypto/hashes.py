"""The XOF keystream of the TPKE pad (copy of `lachain_tpu/crypto/hashes.py:xof`)."""
from __future__ import annotations

import hashlib


def xof(domain: bytes, data: bytes, nbytes: int) -> bytes:
    """SHAKE-256 XOF with a length-prefixed domain tag."""
    h = hashlib.shake_256()
    h.update(len(domain).to_bytes(1, "big") + domain + data)
    return h.digest(nbytes)
