"""Era key sets for consensus.

The port of `lachain_tpu/consensus/keys.py`: `PublicConsensusKeys` (the
validators' TPKE, threshold-signature and ECDSA public keys) with its wire
form (`encode` / `decode`, :34-70: the JAX package's bytes, the blob a
DKG's keyring installs), `PrivateConsensusKeys` (one validator's secrets;
`observer`) and the trusted dealer `trusted_key_gen` (:85-121). Every
protocol reads them through its router. Key sets come from the dealer,
from a DKG (`consensus/keygen.py`), from `decode`, or from the JAX
package's arrays through `convert.consensus_keys_from_numpy`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..crypto import ecdsa
from ..crypto import threshold_sig as ts
from ..crypto import tpke
from ..utils.serialization import Reader, write_bytes, write_bytes_list, write_u32


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

    def encode(self) -> bytes:
        """The wire form: n, f, the TPKE key, its verification keys, the
        threshold-signature key set and the ECDSA keys, length-prefixed."""
        return (
            write_u32(self.n)
            + write_u32(self.f)
            + write_bytes(self.tpke_pub.to_bytes())
            + write_bytes_list([k.to_bytes() for k in self.tpke_verification_keys])
            + write_bytes(self.ts_keys.to_bytes())
            + write_bytes_list(list(self.ecdsa_pub_keys))
        )

    @classmethod
    def decode(cls, data: bytes, backend=None) -> "PublicConsensusKeys":
        """`encode`'s bytes -> the keys, each point checked by `backend`'s
        deserializer (the pure-Python host's where none is given);
        ValueError on a bad point or record."""
        r = Reader(data)
        n = r.u32()
        f = r.u32()
        tpke_pub = tpke.TpkePublicKey.from_bytes(r.bytes_(), backend)
        vks = [tpke.TpkeVerificationKey.from_bytes(b, backend) for b in r.bytes_list()]
        ts_keys = ts.TsPublicKeySet.from_bytes(r.bytes_(), backend)
        ecdsa_pubs = r.bytes_list()
        r.assert_eof()
        return cls(n=n, f=f, tpke_pub=tpke_pub, tpke_verification_keys=vks,
                   ts_keys=ts_keys, ecdsa_pub_keys=ecdsa_pubs)


@dataclass
class PrivateConsensusKeys:
    """A node's secret material. Observers carry just an ECDSA identity."""

    tpke_priv: Optional[tpke.TpkePrivateKey] = None
    ts_share: Optional[ts.TsPrivateKeyShare] = None
    ecdsa_priv: Optional[bytes] = None

    @classmethod
    def observer(cls, ecdsa_priv: bytes) -> "PrivateConsensusKeys":
        return cls(ecdsa_priv=ecdsa_priv)


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
