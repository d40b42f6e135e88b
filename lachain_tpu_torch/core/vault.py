"""Private wallet: the encrypted key file with era-indexed threshold keys.

The port of `lachain_tpu/core/vault.py` (the C# reference's
PrivateWallet.cs): an AES-GCM encrypted JSON file holding the node's
ECDSA identity and its TPKE / TS key shares keyed by the era they became
valid from, looked up by predecessor search (PrivateWallet.cs:63-108,
191-202), so that the share dealt for the cycle boundary era E serves
every era until the next rotation.

The file is the JAX package's, `LTPUWLT1` || salt (16) || nonce (12) ||
ciphertext || tag, its key PBKDF2-HMAC-SHA256 of the password (100,000
iterations): each package opens the other's. Difference, by the port's
rules: the salt and the nonce are drawn from an explicit `rng`
(`secrets` in production) where the reference draws from `secrets`; so a
seeded rng gives the same file twice. Host work only.
"""
from __future__ import annotations

import base64
import bisect
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from ..consensus.keys import PrivateConsensusKeys
from ..crypto import ecdsa
from ..crypto import threshold_sig as ts
from ..crypto import tpke

PBKDF2_ITERS = 100_000
MAGIC = b"LTPUWLT1"


def _derive_key(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, PBKDF2_ITERS, dklen=32)


class PrivateWallet:
    def __init__(
        self,
        path: Optional[str] = None,
        password: str = "",
        *,
        rng,
        ecdsa_priv: Optional[bytes] = None,
    ):
        self.path = path
        self._password = password
        self._rng = rng
        self.ecdsa_priv = ecdsa_priv or ecdsa.generate_private_key(rng)
        # era -> key share, and the sorted eras
        self._tpke: Dict[int, tpke.TpkePrivateKey] = {}
        self._ts: Dict[int, ts.TsPrivateKeyShare] = {}
        self._eras: List[int] = []

    @property
    def public_key(self) -> bytes:
        return ecdsa.public_key_bytes(self.ecdsa_priv)

    # -- era-keyed shares (predecessor lookup) -------------------------------

    def add_threshold_keys(
        self, era: int, tpke_priv: tpke.TpkePrivateKey, ts_share: ts.TsPrivateKeyShare
    ) -> None:
        """Register the shares valid from `era` (reference
        AddThresholdSignatureKeyAfterBlock / AddTpkePrivateKeyAfterBlock);
        a wallet with a path saves."""
        self._tpke[era] = tpke_priv
        self._ts[era] = ts_share
        if era not in self._eras:
            bisect.insort(self._eras, era)
        if self.path:
            self.save()

    def _predecessor_era(self, era: int) -> Optional[int]:
        i = bisect.bisect_right(self._eras, era)
        return self._eras[i - 1] if i else None

    def threshold_keys_for_era(
        self, era: int
    ) -> Optional[Tuple[tpke.TpkePrivateKey, ts.TsPrivateKeyShare]]:
        e = self._predecessor_era(era)
        if e is None:
            return None
        return self._tpke[e], self._ts[e]

    def has_keys_for_era(self, era: int) -> bool:
        return self._predecessor_era(era) is not None

    def consensus_keys_for_era(self, era: int) -> Optional[PrivateConsensusKeys]:
        pair = self.threshold_keys_for_era(era)
        if pair is None:
            return None
        return PrivateConsensusKeys(tpke_priv=pair[0], ts_share=pair[1],
                                    ecdsa_priv=self.ecdsa_priv)

    def set_password(self, password: str) -> None:
        """Re-key the wallet (the operator's `encrypt` verb)."""
        self._password = password

    def to_json(self) -> str:
        """The decrypted payload as JSON (the operator's `decrypt` verb)."""
        return json.dumps(self._payload(), indent=2)

    # -- the file --------------------------------------------------------------

    def _payload(self) -> dict:
        def b64(b):
            return base64.b64encode(b).decode()

        return {
            "ecdsa": b64(self.ecdsa_priv),
            "tpke": {str(e): b64(k.to_bytes()) for e, k in self._tpke.items()},
            "ts": {str(e): b64(k.to_bytes()) for e, k in self._ts.items()},
        }

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("wallet has no path")
        plaintext = json.dumps(self._payload()).encode()
        salt = self._rng.randbelow(1 << 128).to_bytes(16, "big")
        blob = ecdsa.aes_gcm_encrypt(_derive_key(self._password, salt), plaintext, self._rng)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC + salt + blob)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, password: str = "", *, rng) -> "PrivateWallet":
        """Open a wallet file (either package's); `rng` serves its later
        saves. A wrong password or a damaged file raises ValueError."""
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:8] != MAGIC:
            raise ValueError("not a wallet file")
        salt, blob = raw[8:24], raw[24:]
        data = json.loads(ecdsa.aes_gcm_decrypt(_derive_key(password, salt), blob))
        b64d = base64.b64decode
        w = cls(path=path, password=password, rng=rng, ecdsa_priv=b64d(data["ecdsa"]))
        for e_str, enc in data["tpke"].items():
            w._tpke[int(e_str)] = tpke.TpkePrivateKey.from_bytes(b64d(enc))
        for e_str, enc in data["ts"].items():
            w._ts[int(e_str)] = ts.TsPrivateKeyShare.from_bytes(b64d(enc))
        w._eras = sorted(set(w._tpke) | set(w._ts))
        return w
