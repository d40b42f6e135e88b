"""Era key sets for consensus.

The port of `lachain_tpu/consensus/keys.py`: `PublicConsensusKeys` (the
validators' TPKE, threshold-signature and ECDSA public keys),
`PrivateConsensusKeys` (one validator's secrets) and the trusted dealer
`trusted_key_gen` (:85-121). Every protocol reads them through its router.
The wire form (`encode` / `decode`) is not ported: the port's key sets
come from its dealer or from the JAX package's through
`convert.consensus_keys_from_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..crypto import ecdsa
from ..crypto import threshold_sig as ts
from ..crypto import tpke


@dataclass
class PublicConsensusKeys:
    n: int
    f: int
    tpke_pub: tpke.TpkePublicKey
    tpke_verification_keys: List[tpke.TpkeVerificationKey]  # per validator
    ts_keys: ts.TsPublicKeySet
    ecdsa_pub_keys: List[bytes]  # per-validator ECDSA public keys (compressed)

    def __post_init__(self):
        if not (self.n > 3 * self.f or self.f == 0):
            raise ValueError(f"n={self.n} must exceed 3f={3 * self.f}")
        if len(self.tpke_verification_keys) != self.n or self.ts_keys.n != self.n:
            raise ValueError("one TPKE and one threshold-signature key per validator")


@dataclass
class PrivateConsensusKeys:
    """A node's secret material. Observers carry just an ECDSA identity."""

    tpke_priv: Optional[tpke.TpkePrivateKey] = None
    ts_share: Optional[ts.TsPrivateKeyShare] = None
    ecdsa_priv: Optional[bytes] = None


def trusted_key_gen(n: int, f: int, rng):
    """Dealer for tests and the chip smoke run: (public_keys, [private keys
    of validator i]). Draws from `rng` in the reference's order (the TPKE
    polynomial, the threshold-signature polynomial, then n ECDSA keys), so
    one seeded rng deals the same keys in both packages."""
    tp = tpke.TpkeTrustedKeyGen(n, f, rng)
    tsd = ts.TsTrustedKeyGen(n, f, rng)
    ecdsa_privs = [ecdsa.generate_private_key(rng) for _ in range(n)]
    pub = PublicConsensusKeys(
        n=n,
        f=f,
        tpke_pub=tp.pub,
        tpke_verification_keys=list(tp.verification_keys),
        ts_keys=tsd.pub_key_set,
        ecdsa_pub_keys=[ecdsa.public_key_bytes(sk) for sk in ecdsa_privs],
    )
    privs = [
        PrivateConsensusKeys(
            tpke_priv=tp.private_key(i),
            ts_share=tsd.private_key_share(i),
            ecdsa_priv=ecdsa_privs[i],
        )
        for i in range(n)
    ]
    return pub, privs
