"""The port's PrivateWallet (`lachain_tpu_torch/core/vault.py`) against the
JAX package's (`lachain_tpu/core/vault.py`, ref tests/test_vault_keygen.py:
41-80): the era predecessor lookup, a save / load round trip, a wrong
password refused, and each package opening the other's `LTPUWLT1` file.
The JAX package draws the file's salt and nonce from `secrets`, so the
packages' files differ: the decrypted payloads are compared."""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.core.vault import PrivateWallet as JaxWallet
from lachain_tpu.crypto import threshold_sig as jts
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu_torch.core.vault import PrivateWallet
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.crypto import threshold_sig as ts
from lachain_tpu_torch.crypto import tpke

torch.set_num_threads(1)


class Rng:
    def __init__(self, seed=1):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def dealers(tpke_mod=tpke, ts_mod=ts):
    return tpke_mod.TpkeTrustedKeyGen(4, 1, Rng(3)), ts_mod.TsTrustedKeyGen(4, 1, Rng(4))


def filled(cls, path, password, **kw):
    """A wallet of `cls` holding validator 2's shares from era 7 and
    validator 3's from era 40 (the same keys in either package)."""
    td, sd = dealers(*((jtpke, jts) if cls is JaxWallet else (tpke, ts)))
    w = cls(path=path, password=password, ecdsa_priv=ecdsa.generate_private_key(Rng(2)), **kw)
    w.add_threshold_keys(7, td.private_key(2), sd.private_key_share(2))
    w.add_threshold_keys(40, td.private_key(3), sd.private_key_share(3))
    return w


def test_era_predecessor_lookup(tmp_path):
    td, sd = dealers()
    w = PrivateWallet(str(tmp_path / "w.wallet"), "pw", rng=Rng(5),
                      ecdsa_priv=ecdsa.generate_private_key(Rng(1)))
    assert not w.has_keys_for_era(5) and w.consensus_keys_for_era(5) is None
    w.add_threshold_keys(10, td.private_key(0), sd.private_key_share(0))
    w.add_threshold_keys(50, td.private_key(1), sd.private_key_share(1))
    assert not w.has_keys_for_era(9)
    for era, my_id in ((10, 0), (49, 0), (50, 1), (10**9, 1)):
        tp, share = w.threshold_keys_for_era(era)
        assert tp.my_id == share.my_id == my_id
    keys = w.consensus_keys_for_era(50)
    assert keys.tpke_priv.my_id == 1 and keys.ecdsa_priv == w.ecdsa_priv


def test_save_load_roundtrip_and_wrong_password(tmp_path):
    path = str(tmp_path / "node.wallet")
    w = filled(PrivateWallet, path, "hunter2", rng=Rng(6))
    back = PrivateWallet.load(path, "hunter2", rng=Rng(7))
    assert back.ecdsa_priv == w.ecdsa_priv and back.public_key == w.public_key
    td, sd = dealers()
    tp, share = back.threshold_keys_for_era(8)
    assert tp.to_bytes() == td.private_key(2).to_bytes()
    assert share.to_bytes() == sd.private_key_share(2).to_bytes()
    assert back.to_json() == w.to_json()
    with pytest.raises(ValueError):
        PrivateWallet.load(path, "wrong", rng=Rng(7))
    with open(path, "rb") as fh:
        raw = fh.read()
    with open(path, "wb") as fh:
        fh.write(b"NOTAWLT1" + raw[8:])
    with pytest.raises(ValueError):
        PrivateWallet.load(path, "hunter2", rng=Rng(7))


def test_seeded_rng_gives_the_same_file(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    filled(PrivateWallet, a, "pw", rng=Rng(8))
    filled(PrivateWallet, b, "pw", rng=Rng(8))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_port_opens_the_jax_packages_wallet(tmp_path):
    path = str(tmp_path / "jax.wallet")
    jw = filled(JaxWallet, path, "pw")
    w = PrivateWallet.load(path, "pw", rng=Rng(9))
    assert w.to_json() == jw.to_json()
    assert [w.has_keys_for_era(e) for e in (6, 7, 39, 40)] == [False, True, True, True]
    with pytest.raises(ValueError):
        PrivateWallet.load(path, "wrong", rng=Rng(9))


def test_jax_package_opens_the_ports_wallet(tmp_path):
    path = str(tmp_path / "port.wallet")
    w = filled(PrivateWallet, path, "pw", rng=Rng(10))
    jw = JaxWallet.load(path, password="pw")
    assert jw.to_json() == w.to_json()
    assert jw.threshold_keys_for_era(41)[0].to_bytes() == w.threshold_keys_for_era(41)[0].to_bytes()
    with pytest.raises(Exception):
        JaxWallet.load(path, password="wrong")


def test_set_password_rekeys(tmp_path):
    path = str(tmp_path / "re.wallet")
    w = filled(PrivateWallet, path, "old", rng=Rng(11))
    w.set_password("new")
    w.save()
    assert PrivateWallet.load(path, "new", rng=Rng(12)).to_json() == w.to_json()
    with pytest.raises(ValueError):
        PrivateWallet.load(path, "old", rng=Rng(12))
    with pytest.raises(ValueError):
        PrivateWallet(rng=Rng(13)).save()
