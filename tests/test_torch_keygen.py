"""The port's DKG (`lachain_tpu_torch/consensus/keygen.py`) against the JAX
package's (`lachain_tpu/consensus/keygen.py`), on the native host backend.

* At (4, 1) and (7, 2) a port fleet and a JAX fleet of the same seeds run
  side by side, every commit then every value in one total order
  (ref tests/test_keygen.py:35-55): equal commitments coefficient by
  coefficient, every node's `to_bytes()` byte-equal after each dealer's
  round, equal `finished_dealers` and keyring hashes; the confirm fires at
  N - f; the TS combine and the TPKE round trip of ref
  tests/test_keygen.py:59-100 pass under the port's keyrings.
* Messages cross the packages as bytes: a fleet of port and JAX nodes, each
  parsing what it receives in its own package, derives the all-port fleet's
  keyring; a JAX node's snapshot resumes in the port's `from_bytes`
  (ref :103-125).
* The rejections of ref :128-150 and the other ValueError cases.
* `PublicConsensusKeys.encode` is the JAX package's bytes and `decode`
  gives the keys back; the TPKE and TS keys' wire forms;
  `convert.bivar_polynomial_from_numpy`.

The JAX package encrypts from `secrets`, so message bytes differ between
the packages; the tests compare snapshots, plaintexts and keyrings. Each
fleet runs once a module (~15 s of the JAX package's pure-Python ECDH at
(7, 2)).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.consensus import keygen as jkg
from lachain_tpu.consensus import keys as jkeys
from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import threshold_sig as jts
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu_torch import convert
from lachain_tpu_torch.consensus import keygen as kg
from lachain_tpu_torch.consensus import keys
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.crypto import threshold_sig as ts
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend

torch.set_num_threads(1)

NATIVE = NativeBackend()


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def ecdsa_keys(n, seed):
    rng = SeededRng(seed)
    privs = [ecdsa.generate_private_key(rng) for _ in range(n)]
    return privs, [ecdsa.public_key_bytes(p) for p in privs]


def port_node(i, privs, pubs, f, seed, backend=NATIVE):
    return kg.TrustlessKeygen(privs[i], pubs, f, 0, SeededRng(seed + i), backend)


def jax_node(i, privs, pubs, f, seed):
    return jkg.TrustlessKeygen(privs[i], pubs, f, cycle=0, rng=SeededRng(seed + i))


def is_port(node) -> bool:
    return isinstance(node, kg.TrustlessKeygen)


def parse_commit(node, data: bytes):
    if is_port(node):
        return kg.CommitMessage.from_bytes(data, NATIVE)
    return jkg.CommitMessage.from_bytes(data)


def parse_value(node, data: bytes):
    return (kg.ValueMessage if is_port(node) else jkg.ValueMessage).from_bytes(data)


def run_by_bytes(nodes, commits, ready):
    """Deliver each (dealer, commit bytes) to every node in order, then each
    node's value bytes to every node, every message parsed by its receiver
    in its own package (the on-chain order of ref test_keygen.py:35-55)."""
    for dealer, data in commits:
        values = [(i, node.handle_commit(dealer, parse_commit(node, data)).to_bytes())
                  for i, node in enumerate(nodes)]
        for sender, vdata in values:
            for i, node in enumerate(nodes):
                if node.handle_send_value(sender, parse_value(node, vdata)):
                    ready[i] = True


def lockstep(n, f, seed):
    """A port fleet and a JAX fleet of the same seeds, side by side; every
    round's snapshots compared. -> (privs, port nodes, keyrings, confirm
    flags, JAX keyrings)."""
    privs, pubs = ecdsa_keys(n, seed)
    port = [port_node(i, privs, pubs, f, seed) for i in range(n)]
    jax = [jax_node(i, privs, pubs, f, seed) for i in range(n)]
    commits_p = [node.start_keygen() for node in port]
    commits_j = [node.start_keygen() for node in jax]
    for cp, cj in zip(commits_p, commits_j):
        assert len(cp.commitment.coeffs) == (f + 1) * (f + 2) // 2
        assert [bls.g1_to_bytes(c) for c in cp.commitment.coeffs] == [
            jbls.g1_to_bytes(c) for c in cj.commitment.coeffs]
        assert [len(r) for r in cp.encrypted_rows] == [len(r) for r in cj.encrypted_rows]
    ready_p, ready_j = [False] * n, [False] * n
    for dealer in range(n):
        values_p = [(i, node.handle_commit(dealer, commits_p[dealer]))
                    for i, node in enumerate(port)]
        values_j = [(i, node.handle_commit(dealer, commits_j[dealer]))
                    for i, node in enumerate(jax)]
        for (sender, vp), (_, vj) in zip(values_p, values_j):
            for i in range(n):
                ready_p[i] |= port[i].handle_send_value(sender, vp)
                ready_j[i] |= jax[i].handle_send_value(sender, vj)
        assert [node.to_bytes() for node in port] == [node.to_bytes() for node in jax]
        assert [node.finished_dealers for node in port] == [
            node.finished_dealers for node in jax]
    assert ready_p == ready_j == [True] * n
    keyrings = [node.try_get_keys() for node in port]
    return privs, port, keyrings, ready_p, [node.try_get_keys() for node in jax]


@pytest.fixture(scope="module", params=[(4, 1), (7, 2)], ids=["4-1", "7-2"])
def fleet(request):
    n, f = request.param
    return (n, f) + lockstep(n, f, seed=42)


def test_fleet_keyrings_equal_the_jax_package(fleet):
    n, f, _privs, port, keyrings, _ready, jkeyrings = fleet
    assert all(node.finished() for node in port)
    assert len({k.public_key_hash for k in keyrings}) == 1
    assert [k.public_key_hash for k in keyrings] == [k.public_key_hash for k in jkeyrings]
    for k, jk in zip(keyrings, jkeyrings):
        assert k.tpke_priv.to_bytes() == jk.tpke_priv.to_bytes()
        assert k.ts_share.to_bytes() == jk.ts_share.to_bytes()
        assert [v.to_bytes() for v in k.tpke_verification_keys] == [
            v.to_bytes() for v in jk.tpke_verification_keys]
        assert bls.g1_to_bytes(k.ts_key_set.shared.y) == jbls.g1_to_bytes(jk.ts_key_set.shared.y)


def test_fleet_confirm_fires_at_n_minus_f(fleet):
    n, f, privs, port, keyrings, _ready, _j = fleet
    h = keyrings[0].public_key_hash
    pubs = port[0].ecdsa_pub_keys
    for node in port:
        resumed = kg.TrustlessKeygen.from_bytes(node.to_bytes(), privs[node.my_idx],
                                                SeededRng(0), NATIVE)
        assert resumed == node
        fired = [resumed.handle_confirm(h) for _ in range(n)]
        assert fired == [i == n - f - 1 for i in range(n)]
        assert resumed.handle_confirm(b"\x00" * 32) is False
    pub = keyrings[0].public_keys(f, pubs)
    assert keys.PublicConsensusKeys.decode(pub.encode(), NATIVE).encode() == pub.encode()
    assert keyrings[1].private_keys(privs[1]).ecdsa_priv == privs[1]


def test_fleet_threshold_signature_combines(fleet):
    """ref test_keygen.py:59-82: every share verifies, any f+1 combine to
    the same signature, which verifies under the shared key."""
    _n, f, _privs, _port, keyrings, _ready, _j = fleet
    msg = b"post-dkg coin"
    shares = [k.ts_share.sign(msg, NATIVE) for k in keyrings]
    key_set = keyrings[0].ts_key_set
    assert all(key_set.verify_share(msg, s, NATIVE) for s in shares)
    sig = key_set.combine(shares[: f + 1], NATIVE)
    assert key_set.shared.verify(msg, sig, NATIVE)
    assert key_set.combine(shares[-(f + 1):], NATIVE).to_bytes() == sig.to_bytes()


def test_fleet_tpke_roundtrip(fleet):
    """ref test_keygen.py:85-100: a ciphertext under the keyring's key
    decrypts from f+1 shares, each verified under its verification key."""
    _n, f, _privs, _port, keyrings, _ready, _j = fleet
    pub = keyrings[0].tpke_pub
    msg = b"x" * 32
    share = pub.encrypt(msg, 3, SeededRng(5), NATIVE)
    partials = [k.tpke_priv.decrypt_share(share, backend=NATIVE) for k in keyrings[: f + 1]]
    vks = [keyrings[0].tpke_verification_keys[p.decryptor_id] for p in partials]
    assert pub.batch_verify_shares(vks, partials, share, SeededRng(6), NATIVE) == [True] * (f + 1)
    assert pub.full_decrypt(share, partials, NATIVE) == msg


def test_messages_cross_the_packages():
    """Port nodes 0, 2 and JAX nodes 1, 3 exchange bytes only; they derive
    the all-port fleet's keyring (seed 42, (4, 1))."""
    n, f, seed = 4, 1, 42
    privs, pubs = ecdsa_keys(n, seed)
    nodes = [(port_node if i % 2 == 0 else jax_node)(i, privs, pubs, f, seed) for i in range(n)]
    ready = [False] * n
    run_by_bytes(nodes, [(d, node.start_keygen().to_bytes()) for d, node in enumerate(nodes)],
                 ready)
    assert ready == [True] * n
    port = [port_node(i, privs, pubs, f, seed) for i in range(n)]
    run_by_bytes(port, [(d, node.start_keygen().to_bytes()) for d, node in enumerate(port)],
                 [False] * n)
    assert [node.to_bytes() for node in nodes] == [node.to_bytes() for node in port]
    hashes = {node.try_get_keys().public_key_hash for node in nodes + port}
    assert len(hashes) == 1


def test_jax_snapshot_resumes_in_the_port():
    """ref test_keygen.py:103-125 across the packages: JAX node 0's
    mid-protocol snapshot resumes as a port node, which completes the
    protocol beside the JAX nodes with their keyring."""
    n, f, seed = 4, 1, 9
    privs, pubs = ecdsa_keys(n, seed)
    nodes = [jax_node(i, privs, pubs, f, seed) for i in range(n)]
    commits = [(d, node.start_keygen().to_bytes()) for d, node in enumerate(nodes)]
    ready = [False] * n
    run_by_bytes(nodes, commits[:2], ready)
    snapshot = nodes[0].to_bytes()
    resumed = kg.TrustlessKeygen.from_bytes(snapshot, privs[0], SeededRng(1), NATIVE)
    assert resumed.to_bytes() == snapshot
    assert resumed == kg.TrustlessKeygen.from_bytes(snapshot, privs[0], SeededRng(2), NATIVE)
    assert resumed.my_idx == 0 and resumed.cycle == 0
    nodes[0] = resumed
    run_by_bytes(nodes, commits[2:], ready)
    assert ready == [True] * n
    assert len({node.try_get_keys().public_key_hash for node in nodes}) == 1


def fresh_fleet(n, f, seed):
    privs, pubs = ecdsa_keys(n, seed)
    return privs, pubs, [port_node(i, privs, pubs, f, seed) for i in range(n)]


def test_rejects_bad_row():
    """ref test_keygen.py:128-140."""
    n, f = 4, 1
    _privs, pubs, nodes = fresh_fleet(n, f, 11)
    commit = nodes[1].start_keygen()
    bad_rows = list(commit.encrypted_rows)
    bad_rows[0] = ecdsa.ecies_encrypt(pubs[0], b"\x00" * ((f + 1) * bls.FR_BYTES),
                                      SeededRng(3))
    with pytest.raises(ValueError, match="commitment does not match row"):
        nodes[0].handle_commit(1, kg.CommitMessage(commit.commitment, bad_rows))
    nodes[2].handle_commit(1, commit)  # an honest receiver accepts the original


def test_rejects_double_commit_and_replayed_value():
    """ref test_keygen.py:143-150."""
    _privs, _pubs, nodes = fresh_fleet(4, 1, 13)
    commit = nodes[1].start_keygen()
    vmsg = nodes[0].handle_commit(1, commit)
    with pytest.raises(ValueError, match="double commit"):
        nodes[0].handle_commit(1, commit)
    nodes[0].handle_send_value(0, vmsg)
    with pytest.raises(ValueError, match="already handled"):
        nodes[0].handle_send_value(0, vmsg)


@pytest.mark.parametrize("case", [
    "unknown_sender", "row_count", "degree", "undecryptable", "row_length",
    "value_dealer", "value_sender", "value_before_commit", "value_count", "outsider",
])
def test_rejections(case):
    """Every other ValueError of the reference's handle_commit and
    handle_send_value, each with the reference's message."""
    n, f = 4, 1
    privs, pubs, nodes = fresh_fleet(n, f, 17)
    commit = nodes[1].start_keygen()
    other = kg.BiVarSymmetricPolynomial.random(2, SeededRng(4)).commit(NATIVE)
    rows = commit.encrypted_rows
    calls = {
        "unknown_sender": (lambda: nodes[0].handle_commit(n, commit), "unknown sender"),
        "row_count": (lambda: nodes[0].handle_commit(1, kg.CommitMessage(commit.commitment,
                                                                          rows[:-1])),
                      "bad encrypted row count"),
        "degree": (lambda: nodes[0].handle_commit(1, kg.CommitMessage(other, rows)),
                   "degree"),
        "undecryptable": (lambda: nodes[0].handle_commit(1, kg.CommitMessage(
            commit.commitment, [b"\x02" * 80] + rows[1:])), "undecryptable row"),
        "row_length": (lambda: nodes[0].handle_commit(1, kg.CommitMessage(
            commit.commitment, [ecdsa.ecies_encrypt(pubs[0], b"\x01" * 31, SeededRng(2))]
            + rows[1:])), "bad row length"),
        "value_dealer": (lambda: nodes[0].handle_send_value(0, kg.ValueMessage(n, [])),
                         "unknown dealer"),
        "value_sender": (lambda: nodes[0].handle_send_value(-1, kg.ValueMessage(1, [])),
                         "unknown sender"),
        "value_before_commit": (lambda: nodes[0].handle_send_value(
            2, kg.ValueMessage(1, [b""] * n)), "value before commitment"),
        "value_count": (lambda: (nodes[0].handle_commit(1, commit),
                                 nodes[0].handle_send_value(2, kg.ValueMessage(1, [b""]))),
                        "bad encrypted value count"),
        "outsider": (lambda: kg.TrustlessKeygen(ecdsa.generate_private_key(SeededRng(99)),
                                                pubs, f, 0, SeededRng(1), NATIVE)
                     .handle_commit(1, commit), "not a keygen participant"),
    }
    call, match = calls[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_garbled_value_is_acked_but_not_valid():
    """A value that does not decrypt, or decrypts to a value off the
    commitment, still counts toward the quorum but never enters the
    interpolation (ref keygen.py:409-439)."""
    n, f = 4, 1
    _privs, pubs, nodes = fresh_fleet(n, f, 19)
    commit = nodes[2].start_keygen()
    vmsgs = [node.handle_commit(2, commit) for node in nodes]
    garbled = kg.ValueMessage(2, [b"\x07" * 93] + vmsgs[1].encrypted_values[1:])
    true = bls.fr_from_bytes(ecdsa.ecies_decrypt(nodes[0]._priv, vmsgs[3].encrypted_values[0]))
    off = kg.ValueMessage(2, [ecdsa.ecies_encrypt(pubs[0], bls.fr_to_bytes(true + 1),
                                                  SeededRng(8))] + vmsgs[3].encrypted_values[1:])
    nodes[0].handle_send_value(1, garbled)
    nodes[0].handle_send_value(0, vmsgs[0])
    assert nodes[0].finished_dealers == []
    nodes[0].handle_send_value(3, off)
    state = nodes[0].states[2]
    assert state.acks == [True, True, False, True]
    assert state.valid == [True, False, False, False]
    assert state.value_count() == 3 and nodes[0].finished_dealers == [2]
    with pytest.raises(ValueError, match="not enough values"):
        state.interpolate_values()
    assert nodes[0].try_get_keys() is None  # one dealer of the f + 1 needed
    with pytest.raises(ValueError, match="without commitment"):
        kg.KeygenState(n).interpolate_values()


def test_structures_match_the_jax_package():
    """The polynomial's rows, the committed row and point, the state and
    message records, against the JAX package's on one seeded polynomial."""
    f = 2
    poly = kg.BiVarSymmetricPolynomial.random(f, SeededRng(21))
    jpoly = jkg.BiVarSymmetricPolynomial.random(f, SeededRng(21))
    assert poly.coeffs == jpoly.coeffs
    assert [kg._tri_index(i, j) for i in range(3) for j in range(3)] == [
        jkg._tri_index(i, j) for i in range(3) for j in range(3)]
    for x in (0, 1, 5):
        assert poly.evaluate_row(x) == jpoly.evaluate_row(x)
    com = poly.commit(NATIVE)
    jcom = jpoly.commit()
    assert com.to_bytes() == jcom.to_bytes()
    assert kg.Commitment.from_bytes(jcom.to_bytes(), HostBackend()) == com
    for x in (0, 3):
        assert [bls.g1_to_bytes(p) for p in com.evaluate_row(x, NATIVE)] == [
            jbls.g1_to_bytes(p) for p in jcom.evaluate_row(x)]
    for x, y in ((1, 1), (2, 5)):
        assert bls.g1_to_bytes(com.evaluate(x, y, NATIVE)) == jbls.g1_to_bytes(
            jcom.evaluate(x, y))
    with pytest.raises(ValueError, match="coefficient count"):
        kg.Commitment(com.coeffs[:-1])
    with pytest.raises(ValueError, match="multiple of G1"):
        kg.Commitment.from_bytes(b"\x00" * 95, NATIVE)
    with pytest.raises(ValueError, match="wrong number"):
        kg.BiVarSymmetricPolynomial(f, poly.coeffs[:-1])
    vm = kg.ValueMessage(3, [b"a", b"", b"xyz"])
    assert vm.to_bytes() == jkg.ValueMessage(3, [b"a", b"", b"xyz"]).to_bytes()
    assert kg.ValueMessage.from_bytes(vm.to_bytes()) == vm
    cm = kg.CommitMessage(com, [b"r0", b"r1"])
    assert cm.to_bytes() == jkg.CommitMessage(jcom, [b"r0", b"r1"]).to_bytes()
    back = kg.CommitMessage.from_bytes(cm.to_bytes(), NATIVE)
    assert back.commitment == com and back.encrypted_rows == [b"r0", b"r1"]
    state = kg.KeygenState(4)
    state.commitment, state.values, state.acks = com, [1, 2, 0, 7], [True, True, False, True]
    state.valid = [True, False, False, True]
    jstate = jkg.KeygenState.from_bytes(state.to_bytes())
    assert jstate.to_bytes() == state.to_bytes()
    assert kg.KeygenState.from_bytes(state.to_bytes(), NATIVE) == state
    assert bls.fr_interpolate([1, 2, 3], [5, 7, 9]) == jbls.fr_interpolate([1, 2, 3], [5, 7, 9])
    assert bls.fr_interpolate([1, 2, 3], [5, 7, 9], at=4) == 11


def _solve_mod_r(rows):
    """The solution of the consistent, full-column-rank system `rows`
    ([coefficients..., constant] over Fr) by Gauss-Jordan elimination;
    None when its rank is below the number of unknowns."""
    rows = [list(r) for r in rows]
    unknowns = len(rows[0]) - 1
    for col in range(unknowns):
        pivot = next((r for r in range(col, len(rows)) if rows[r][col] % bls.R), None)
        if pivot is None:
            return None
        rows[col], rows[pivot] = rows[pivot], rows[col]
        inv = pow(rows[col][col], -1, bls.R)
        rows[col] = [v * inv % bls.R for v in rows[col]]
        for r in range(len(rows)):
            if r != col and rows[r][col]:
                k = rows[r][col]
                rows[r] = [(a - k * b) % bls.R for a, b in zip(rows[r], rows[col])]
    return [rows[c][unknowns] for c in range(unknowns)]


@pytest.mark.parametrize("f", [2, 3])
def test_f_colluders_recover_a_dealers_secret(f):
    """Pins a fault of the reference that the port keeps for its bytes
    (ROADMAP.md queue C): `_tri_index` is not injective, so the rows that
    f validators decrypt, f(f+1) linear equations over Fr, determine every
    coefficient the dealer's polynomial uses, F(0, 0) among them. With an
    injective packing f rows leave F(0, 0) open; when the packing is fixed,
    this test must change with it."""
    assert [kg._tri_index(i, j) for i in range(f + 1) for j in range(f + 1)] == [
        jkg._tri_index(i, j) for i in range(f + 1) for j in range(f + 1)]
    used = sorted({kg._tri_index(i, j) for i in range(f + 1) for j in range(f + 1)})
    assert len(used) < (f + 1) * (f + 2) // 2
    poly = kg.BiVarSymmetricPolynomial.random(f, SeededRng(40 + f))
    system = []
    for x in range(1, f + 1):  # the f colluders' rows F(x, .)
        for i, value in enumerate(poly.evaluate_row(x)):
            eq = [0] * (len(used) + 1)
            for j in range(f + 1):
                eq[used.index(kg._tri_index(i, j))] += pow(x, j, bls.R)
            eq[-1] = value
            system.append(eq)
    solved = _solve_mod_r(system)
    assert solved == [poly.coeffs[c] for c in used]
    assert solved[used.index(0)] == poly.evaluate_row(0)[0]  # F(0, 0)


def test_bivar_polynomial_from_numpy():
    f = 3
    jpoly = jkg.BiVarSymmetricPolynomial.random(f, SeededRng(23))
    arr = np.frombuffer(b"".join(jbls.fr_to_bytes(c) for c in jpoly.coeffs),
                        dtype=np.uint8).reshape(-1, 32)
    poly = convert.bivar_polynomial_from_numpy(arr, f)
    assert poly.degree == f and poly.coeffs == jpoly.coeffs
    assert poly.commit(NATIVE).to_bytes() == jpoly.commit().to_bytes()
    with pytest.raises(ValueError, match="wrong number"):
        convert.bivar_polynomial_from_numpy(arr[:-1], f)
    bad = arr.copy()
    bad[0] = 0xFF
    with pytest.raises(ValueError, match="out of range"):
        convert.bivar_polynomial_from_numpy(bad, f)


def test_key_wire_forms_are_the_jax_packages():
    """PublicConsensusKeys.encode (and the TPKE and TS keys in it) gives
    the JAX package's bytes of the same dealt keys; decode gives the keys
    back and rejects a bad point."""
    n, f = 4, 1
    pub, privs = keys.trusted_key_gen(n, f, SeededRng(31))
    jpub, jprivs = jkeys.trusted_key_gen(n, f, rng=SeededRng(31))
    blob = pub.encode()
    assert blob == jpub.encode()
    for backend in (NATIVE, HostBackend(), None):
        back = keys.PublicConsensusKeys.decode(blob, backend)
        assert back.encode() == blob
        assert bls.g1_eq(back.ts_keys.shared.y, pub.ts_keys.shared.y)
    assert jkeys.PublicConsensusKeys.decode(blob).encode() == blob
    assert privs[2].tpke_priv.to_bytes() == jprivs[2].tpke_priv.to_bytes()
    assert privs[2].ts_share.to_bytes() == jprivs[2].ts_share.to_bytes()
    tp = tpke.TpkePrivateKey.from_bytes(jprivs[2].tpke_priv.to_bytes())
    tss = ts.TsPrivateKeyShare.from_bytes(jprivs[2].ts_share.to_bytes())
    assert (tp.x_i, tp.my_id, tss.x_i, tss.my_id) == (
        jprivs[2].tpke_priv.x_i, 2, jprivs[2].ts_share.x_i, 2)
    assert tpke.TpkePublicKey.from_bytes(jpub.tpke_pub.to_bytes()).to_bytes() == \
        jtpke.TpkePublicKey.from_bytes(pub.tpke_pub.to_bytes()).to_bytes()
    assert ts.TsPublicKeySet.from_bytes(jpub.ts_keys.to_bytes(), NATIVE).to_bytes() == \
        jts.TsPublicKeySet.from_bytes(pub.ts_keys.to_bytes()).to_bytes()
    obs = keys.PrivateConsensusKeys.observer(privs[0].ecdsa_priv)
    assert obs.tpke_priv is None and obs.ts_share is None
    off_curve = bytearray(blob)
    at = 8 + 4  # n, f, then the TPKE key's length prefix
    off_curve[at + 95] ^= 1
    with pytest.raises(ValueError):
        keys.PublicConsensusKeys.decode(bytes(off_curve), NATIVE)
    with pytest.raises(ValueError, match="trailing"):
        keys.PublicConsensusKeys.decode(blob + b"\x00", NATIVE)
    with pytest.raises(ValueError, match="trailing"):
        tpke.TpkePrivateKey.from_bytes(privs[0].tpke_priv.to_bytes() + b"\x00")
