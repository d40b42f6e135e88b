"""The host crypto under the port's consensus vs the JAX package's, on the CPU.

* `threshold_sig.ThresholdSigner`: with one bad share among good ones and
  deferred verification, the same combined signature (and coin bit) and
  the same `pruned` set as the JAX package's signer; with verification on
  arrival, the bad share is refused.
* `tpke`: the wire records round-trip and cross between the packages byte
  for byte; `ciphertext_h`, `verify_ciphertext`, `batch_verify_ciphertexts`
  (a bad ciphertext among good ones, and its memo), the per-slot
  `batch_verify_shares` with a bad share, `full_decrypt`,
  `peek_decrypted_share_ids` and `decrypt_shares_batch` agree with the
  reference's on carried keys; H_G2 runs through the backend it is given.
* `hashes.merkle_proof` / `merkle_verify` / `merkle_proofs`,
  `provider.deserialize_batch_g1` / `_g2` with bad points (off the curve,
  outside the subgroup, the wrong length) and their memo,
  `ecdsa.generate_private_key` and `consensus.keys.trusted_key_gen` under a
  seeded rng, and `convert.consensus_keys_from_numpy`.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.consensus.keys import trusted_key_gen as jax_key_gen
from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.crypto import hashes as jhashes
from lachain_tpu.crypto import provider as jprovider
from lachain_tpu.crypto import threshold_sig as jts
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu_torch.consensus.keys import trusted_key_gen
from lachain_tpu_torch.consensus.simulator import SeededRng as PortRng
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa, hashes, provider
from lachain_tpu_torch.crypto import threshold_sig as ts
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend
from tests.test_consensus import SeededRng
from tests.test_torch_consensus import carried_keys

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

N, F = 7, 2


@pytest.fixture(scope="module")
def native():
    return NativeBackend()


@pytest.fixture(scope="module")
def keys():
    return carried_keys(N, F)


def _not_in_subgroup_g1(seed: int) -> bytes:
    """An on-curve G1 encoding outside the prime-order subgroup."""
    rng = random.Random(seed)
    while True:
        x = rng.randrange(bls.P)
        y = bls.fp_sqrt((x * x * x + 4) % bls.P)
        if y is not None and not bls.g1_is_inf(bls.g1_mul((x, y, 1), bls.R)):
            return x.to_bytes(48, "big") + y.to_bytes(48, "big")


# ---------------------------------------------------------------------------
# ThresholdSigner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [0, F])
def test_threshold_signer_prunes_like_the_reference(keys, native, bad):
    (jpub, jprivs), (pub, privs) = keys
    msg = b"coin|0|1|5"
    jsigner = jts.ThresholdSigner(msg, jprivs[0].ts_share, jpub.ts_keys)
    signer = ts.ThresholdSigner(msg, privs[0].ts_share, pub.ts_keys, native, PortRng(1))
    for i in range(N):
        jps = jprivs[i].ts_share.sign(msg)
        if i == bad:  # a well-formed point that signs another message
            jps = jts.PartialSignature(jprivs[i].ts_share.sign(b"other").sigma, i)
        ps = ts.PartialSignature.from_bytes(jps.to_bytes(), native)
        assert ps.to_bytes() == jps.to_bytes()
        jsigner.add_share(jps, verify=False)
        signer.add_share(ps, verify=False)
    assert signer.pruned == jsigner.pruned == {bad}
    assert signer.signature.to_bytes() == jsigner.signature.to_bytes()
    assert signer.signature.parity == jsigner.signature.parity
    assert pub.ts_keys.shared.verify(msg, signer.signature, native)


def test_threshold_signer_verifies_on_arrival(keys, native):
    (_jpub, _jprivs), (pub, privs) = keys
    msg = b"coin|0|2|5"
    signer = ts.ThresholdSigner(msg, privs[0].ts_share, pub.ts_keys, native, PortRng(2))
    wrong = ts.PartialSignature(privs[1].ts_share.sign(b"x", native).sigma, 1)
    assert not signer.add_share(wrong)
    assert signer.add_share(signer.sign())
    assert not signer.add_share(ts.PartialSignature(wrong.sigma, N))  # id out of range
    for i in range(1, F + 1):
        assert signer.add_share(privs[i].ts_share.sign(msg, native))
    assert signer.signature is not None and not signer.pruned


# ---------------------------------------------------------------------------
# tpke: wire records, ciphertext checks, per-slot shares
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ciphertexts(keys):
    """Three JAX ciphertexts under the carried key, their port copies by
    wire bytes, and every validator's JAX decryption shares of each."""
    (jpub, jprivs), (_pub, _privs) = keys
    out = []
    for s in range(3):
        msg = bytes([s]) * (40 + s)
        ct = jpub.tpke_pub.encrypt(msg, share_id=s, rng=SeededRng(500 + s))
        decs = [p.tpke_priv.decrypt_share(ct, check=False) for p in jprivs]
        out.append((msg, ct, tpke.EncryptedShare.from_bytes(ct.to_bytes()), decs))
    return out


def test_wire_records_cross_between_packages(ciphertexts, native):
    for _msg, ct, pct, decs in ciphertexts:
        assert pct.to_bytes() == ct.to_bytes()
        assert tpke.EncryptedShare.from_bytes(pct.to_bytes(), native) == pct
        assert jtpke.EncryptedShare.from_bytes(pct.to_bytes()).to_bytes() == ct.to_bytes()
        for d in decs:
            pd = tpke.PartiallyDecryptedShare.from_bytes(d.to_bytes(), native)
            assert pd.to_bytes() == d.to_bytes()
            assert tpke.peek_decrypted_share_ids(d.to_bytes()) == (
                jtpke.peek_decrypted_share_ids(d.to_bytes())) == (d.decryptor_id, d.share_id)
    assert tpke.peek_decrypted_share_ids(b"\x00" * 10) is None
    with pytest.raises(ValueError):
        tpke.EncryptedShare.from_bytes(_not_in_subgroup_g1(1) + ct.to_bytes()[96:], native)


def test_decode_encrypted_shares_batch(ciphertexts, native):
    blobs = [ct.to_bytes() for _m, ct, _p, _d in ciphertexts]
    bad = [blobs[0][:-1], _not_in_subgroup_g1(2) + blobs[1][96:]]
    memo = provider.CryptoMemo()
    got = tpke.decode_encrypted_shares_batch(blobs + bad, native, memo)
    want = jtpke.decode_encrypted_shares_batch(blobs + bad)
    assert [g.to_bytes() if g else None for g in got] == [
        w.to_bytes() if w else None for w in want]
    assert got[3] is None and got[4] is None
    # one entry per distinct encoding: the short blob never parses, and the
    # bad-U blob's W is blob 1's
    assert len(memo.g1) == 4 and len(memo.g2) == 3


def test_ciphertext_checks(keys, ciphertexts, native):
    (_jpub, _jprivs), (pub, _privs) = keys
    cts = [pct for _m, _c, pct, _d in ciphertexts]
    for _m, ct, pct, _d in ciphertexts:
        assert bls.g2_eq(tpke.ciphertext_h(pct, native), jtpke.ciphertext_h(ct))
        assert pub.tpke_pub.verify_ciphertext(pct, native)
    forged = tpke.EncryptedShare(cts[1].u, cts[1].v + b"!", cts[1].w, 1)
    assert not pub.tpke_pub.verify_ciphertext(forged, native)
    memo = provider.CryptoMemo()
    batch = cts + [forged]
    want = jtpke.batch_verify_ciphertexts(
        [jtpke.EncryptedShare.from_bytes(c.to_bytes()) for c in batch])
    got = tpke.batch_verify_ciphertexts(batch, native, PortRng(3), memo)
    assert got == want == [True, True, True, False]
    assert len(memo.ct_valid) == 4
    assert tpke.batch_verify_ciphertexts(batch, native, PortRng(4), memo) == got


def test_share_checks_and_full_decrypt(keys, ciphertexts, native):
    (jpub, _jprivs), (pub, _privs) = keys
    msg, ct, pct, decs = ciphertexts[0]
    pdecs = [tpke.PartiallyDecryptedShare.from_bytes(d.to_bytes(), native) for d in decs]
    pdecs[2] = tpke.PartiallyDecryptedShare(bls.g1_mul(pdecs[2].ui, 1337), 2, 0)
    jdecs = list(decs)
    jdecs[2] = jtpke.PartiallyDecryptedShare(jbls.g1_mul(decs[2].ui, 1337), 2, 0)
    got = pub.tpke_pub.batch_verify_shares(pub.tpke_verification_keys, pdecs, pct,
                                           PortRng(5), native)
    want = jpub.tpke_pub.batch_verify_shares(jpub.tpke_verification_keys, jdecs, ct)
    assert got == want == [i != 2 for i in range(N)]
    good = [d for d, ok in zip(pdecs, got) if ok]
    assert pub.tpke_pub.full_decrypt(pct, good, native) == msg
    assert pub.tpke_pub.full_decrypt(pct, good[::-1]) == msg  # pure-Python host
    with pytest.raises(ValueError):
        pub.tpke_pub.full_decrypt(pct, good[:F], native)


def test_decrypt_shares_batch(keys, ciphertexts, native):
    (_jpub, jprivs), (_pub, privs) = keys
    cts = [pct for _m, _c, pct, _d in ciphertexts] * 3  # 9: the threaded batch call
    for backend in (native, HostBackend()):
        got = tpke.decrypt_shares_batch(privs[4].tpke_priv, cts, backend)
        want = jtpke.decrypt_shares_batch(
            jprivs[4].tpke_priv, [jtpke.EncryptedShare.from_bytes(c.to_bytes()) for c in cts])
        assert [d.to_bytes() for d in got] == [d.to_bytes() for d in want]


class CountingHost(HostBackend):
    def __init__(self):
        self.hashes = 0

    def hash_to_g2(self, msg, domain=b"LTPU-G2"):
        self.hashes += 1
        return super().hash_to_g2(msg, domain)


def test_hashes_to_g2_run_on_the_given_backend(ciphertexts):
    _msg, _ct, pct, _d = ciphertexts[2]
    host = CountingHost()
    h = tpke.ciphertext_h(pct, host)
    assert host.hashes == 1 and tpke.ciphertext_h(pct, host) is h  # memoized
    assert bls.g2_eq(ts._hash_to_sig_point(b"coin", host), jts._hash_to_sig_point(b"coin"))
    assert host.hashes == 2


# ---------------------------------------------------------------------------
# Merkle branches, point parsing, key dealing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 7, 16, 64])
def test_merkle_branches(n):
    rng = random.Random(n)
    leaves = [rng.randbytes(32) for _ in range(n)]
    root = jhashes.merkle_root(leaves)
    assert hashes.merkle_root(leaves) == root
    proofs = hashes.merkle_proofs(leaves)
    for i in range(n):
        assert proofs[i] == hashes.merkle_proof(leaves, i) == jhashes.merkle_proof(leaves, i)
        assert hashes.merkle_verify(leaves[i], i, proofs[i], root)
        assert not hashes.merkle_verify(bytes(32), i, proofs[i], root)
    assert hashes.keccak256_host(b"abc" * 50) == hashes.keccak256(b"abc" * 50)


def test_deserialize_batches_with_bad_points(native):
    rng = random.Random(9)
    g1s = [bls.g1_to_bytes(bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))) for _ in range(3)]
    g2s = [bls.g2_to_bytes(bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))) for _ in range(2)]
    bad1 = [_not_in_subgroup_g1(3), b"\x01" * 96, g1s[0][:95]]
    bad2 = [b"\x02" * 192, g2s[0][:-1]]
    memo = provider.CryptoMemo()
    for backend in (native, HostBackend()):
        got1 = provider.deserialize_batch_g1(g1s + bad1 + g1s[:1], backend, memo)
        want1 = jprovider.deserialize_batch_g1(g1s + bad1 + g1s[:1],
                                               backend=jprovider.PythonBackend())
        assert [bls.g1_to_bytes(p) if p else None for p in got1] == [
            jbls.g1_to_bytes(p) if p else None for p in want1]
        assert got1[3:6] == [None] * 3
        got2 = provider.deserialize_batch_g2(g2s + bad2, backend)
        assert [bls.g2_to_bytes(p) if p else None for p in got2] == g2s + [None, None]
    assert len(memo.g1) == 6  # one entry per distinct encoding
    small = provider.CryptoMemo(cap=2)
    provider.deserialize_batch_g1(g1s, native, small)
    assert len(small.g1) == 1  # cleared whole at the cap


def test_key_dealing_under_a_seeded_rng(keys):
    assert all(ecdsa.generate_private_key(PortRng(s)) ==
               jecdsa.generate_private_key(PortRng(s)) for s in range(5))
    pub, privs = trusted_key_gen(4, 1, SeededRng(401))
    jpub, jprivs = jax_key_gen(4, 1, rng=SeededRng(401))
    assert bls.g1_to_bytes(pub.tpke_pub.y) == jbls.g1_to_bytes(jpub.tpke_pub.y)
    assert [bls.g1_to_bytes(k.y) for k in pub.ts_keys.keys] == [
        jbls.g1_to_bytes(k.y) for k in jpub.ts_keys.keys]
    assert pub.ecdsa_pub_keys == jpub.ecdsa_pub_keys
    assert [p.ecdsa_priv for p in privs] == [p.ecdsa_priv for p in jprivs]
    assert [p.tpke_priv.x_i for p in privs] == [p.tpke_priv.x_i for p in jprivs]
    # the carried key set of the protocol tests equals the JAX dealer's
    (jpub7, jprivs7), (pub7, privs7) = keys
    assert [bls.g1_to_bytes(v.y_i) for v in pub7.tpke_verification_keys] == [
        jbls.g1_to_bytes(v.y_i) for v in jpub7.tpke_verification_keys]
    assert [p.ts_share.x_i for p in privs7] == [p.ts_share.x_i for p in jprivs7]
    assert pub7.ts_keys.t == F and pub7.n == N
    with pytest.raises(ValueError):
        from lachain_tpu_torch import convert

        convert.consensus_keys_from_numpy(
            F, np.frombuffer(jbls.g1_to_bytes(jpub7.tpke_pub.y), dtype=np.uint8),
            np.zeros((N, 96), np.uint8), np.zeros((N, 32), np.uint8),
            np.zeros((N, 96), np.uint8), np.zeros((N, 32), np.uint8),
            jpub7.ecdsa_pub_keys[:-1], [p.ecdsa_priv for p in jprivs7])
