"""The port's validator rotation (`lachain_tpu_torch/core/validator_status.py`,
`keygen_manager.py`, `validator_manager.py`, `vault.py`,
`consensus/attendance.py`) against the JAX package's, side by side: the
(4, 1) full cycle of ref tests/test_vault_keygen.py:135 and :235 and
tests/test_attendance_onchain.py:248, on chip_smoke's RotationChain
(tests/torch_rotation_common.py). The same seeded keys and rngs in both
packages; the port's validator 0 runs its keygen on
GpuBackend(device="cpu") (the kernels' plain versions), its other
validators on the native host backend (the JAX package's on its own
backend). Checked: the same block, state root, KEYGEN_STATE row of every
validator and system transactions after every block; each package's
validator 0 resumed mid-DKG from the other's row; the same installed
(first era, public key set); keys_for_era before and after the flip; a TPKE
era and a coin era under the rotated keys through GpuBackend(device="cpu")
with the host era pipelines; the same attendance report, checked in on
chain; the port's wallet installing, saving and reloading the shares.

The JAX package's ECIES draws its ephemeral key and nonce from `secrets`;
for equal commits and values the test hands its keygen's encryptions the
keygen's own seeded rng, drawn as the port draws (`jax_ecies`), with the
JAX package's own ECDH and AES-GCM.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
import torch_exec_common as common
import torch_rotation_common as rot

torch.set_num_threads(1)

JAX, PORT = rot.package("lachain_tpu"), rot.package("lachain_tpu_torch")


def jax_ecies(monkeypatch):
    """The JAX package's keygen encrypts with its keygen's rng: the
    ephemeral key, then the nonce, as the port's ecies_encrypt draws them."""
    from lachain_tpu.consensus import keygen as jkg
    from lachain_tpu.crypto import _aes_fallback
    from lachain_tpu.crypto import ecdsa as je

    current = []

    def encrypt(pub, plaintext, rng=None):
        rng = current[-1]
        eph = je.generate_private_key(rng)
        nonce = rng.randbelow(1 << 96).to_bytes(12, "big")
        key = je.ecdh_shared_secret(eph, pub)
        return je.public_key_bytes(eph) + nonce + _aes_fallback.encrypt(key, nonce, plaintext)

    for name in ("start_keygen", "handle_commit"):
        inner = getattr(jkg.TrustlessKeygen, name)

        def wrapped(self, *args, _inner=inner, **kw):
            current.append(self._rng)
            try:
                return _inner(self, *args, **kw)
            finally:
                current.pop()

        monkeypatch.setattr(jkg.TrustlessKeygen, name, wrapped)
    monkeypatch.setattr(je, "ecies_encrypt", encrypt)


def jax_manager(i, priv, send, on_keys, rng, kv):
    return JAX.keygen_manager.KeyGenManager(priv, send, on_keys=on_keys, rng=rng, kv=kv)


def port_manager(i, priv, send, on_keys, rng, kv):
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.crypto.native_backend import NativeBackend

    backend = GpuBackend(device="cpu") if i == 0 else NativeBackend()
    return PORT.keygen_manager.KeyGenManager(priv, send, rng=rng, backend=backend,
                                             on_keys=on_keys, kv=kv)


def set_cycle(duration, phase, attendance):
    for p in (JAX, PORT):
        p.system_contracts.set_cycle_params(duration, phase, attendance)


@pytest.fixture(scope="module")
def sides():
    common.reset_module_state()
    set_cycle(chip_smoke.ROT_CYCLE, chip_smoke.ROT_VRF_PHASE, chip_smoke.ROT_ATTENDANCE)
    try:
        with pytest.MonkeyPatch.context() as mp:
            jax_ecies(mp)
            out = [rot.Side("jax", JAX, jax_manager),
                   rot.Side("port", PORT, port_manager, device="cpu")]
            rot.drive(out)
        yield out
    finally:
        common.reset_module_state()


@pytest.mark.parametrize("height", range(1, rot.HEIGHTS + 1))
def test_every_block_equals_the_jax_packages(sides, height):
    jax, port = (s.records[height - 1] for s in sides)
    for key in ("hash", "block", "state_hash", "rows", "sent", "keys", "attendance"):
        assert jax[key] == port[key], f"block {height}: {key} differs"


def test_the_cycle_ran_its_course(sides):
    """Every stage left its mark: the lottery elected all four, the DKG
    rows grew and were persisted, the set flipped at block 19."""
    port = sides[1]
    records = port.records
    sc = PORT.system_contracts
    assert all(r["rows"] == [None] * rot.N for r in records[:10])
    assert all(all(row for row in r["rows"]) for r in records[10:])
    assert len(records[11]["sent"]) == rot.N * rot.N  # every validator's values
    assert sum(sc.SEL_KEYGEN_CONFIRM in tx for tx in records[12]["sent"]) == rot.N
    assert records[17]["keys"] == records[16]["keys"] == port.genesis.encode()
    assert records[18]["keys"] != port.genesis.encode()  # keys_for_era(20) after block 19


def test_each_package_resumes_the_others_row(sides):
    jax, port = sides
    assert jax.restored == port.restored
    assert jax.records[rot.RESTART_AFTER - 1]["rows"][0] == port.records[
        rot.RESTART_AFTER - 1]["rows"][0]
    assert port.managers[0].keygen is not None and jax.managers[0].keygen is not None


def test_installed_key_sets_equal(sides):
    jax, port = sides
    want = {i: (e, k.public_keys(rot.F, p).encode()) for i, (e, k, p) in jax.installed.items()}
    got = {i: (e, k.public_keys(rot.F, p).encode()) for i, (e, k, p) in port.installed.items()}
    assert got == want and sorted(got) == list(range(rot.N))
    assert {e for e, _ in got.values()} == {chip_smoke.ROT_CYCLE}
    assert len({b for _, b in got.values()}) == 1


def test_keys_for_era_flip(sides):
    jax, port = sides
    for era in range(0, rot.HEIGHTS + 2):
        assert port.chain.vm.keys_for_era(era).encode() == jax.chain.vm.keys_for_era(era).encode()
    assert port.chain.vm.keys_for_era(chip_smoke.ROT_CYCLE - 1) is port.genesis
    rotated = port.chain.vm.keys_for_era(chip_smoke.ROT_CYCLE)
    assert rotated is port.chain.vm.keys_for_era(chip_smoke.ROT_CYCLE + 1)
    first_era, keyring, participants = port.installed[0]
    assert rotated.encode() == keyring.public_keys(rot.F, participants).encode()


def test_rotated_keys_run_an_era(sides, tmp_path):
    """Validator 0's wallet installs its shares, saves and reloads; its
    slot's shares are matched as ref core/node.py:1048-1075 does; a TPKE era
    and a coin era under the rotated set verify and combine every slot and
    coin through GpuBackend(device="cpu") on the host pipelines."""
    from lachain_tpu_torch.core.vault import PrivateWallet
    from lachain_tpu_torch.crypto import threshold_sig as ts
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.crypto.native_backend import NativeBackend
    from lachain_tpu_torch.ops.verify import HostEraPipeline

    port = sides[1]
    era = chip_smoke.ROT_CYCLE
    keys = port.chain.vm.keys_for_era(era)
    path = str(tmp_path / "node0.wallet")
    wallet = PrivateWallet(path, "pw", rng=rot.Rng(3), ecdsa_priv=port.privs[0])
    first_era, keyring, _ = port.installed[0]
    wallet.add_threshold_keys(first_era, keyring.tpke_priv, keyring.ts_share)
    back = PrivateWallet.load(path, "pw", rng=rot.Rng(4))
    assert back.has_keys_for_era(era) and not back.has_keys_for_era(era - 1)
    host = NativeBackend()
    by_slot = {}
    for i, (_e, ring, _p) in port.installed.items():
        by_slot[ring.tpke_priv.my_id] = ring
    my = keys.ecdsa_pub_keys.index(PORT.ecdsa.public_key_bytes(port.privs[0]))
    mine = chip_smoke.private_keys_matching(back, port.genesis_privs[0], keys, my, era, host)
    assert mine is not None and mine.tpke_priv.x_i == by_slot[my].tpke_priv.x_i
    assert chip_smoke.private_keys_matching(back, port.genesis_privs[0], keys, (my + 1) % rot.N,
                                            era, host) is None
    tprivs = [mine.tpke_priv if i == my else by_slot[i].tpke_priv for i in range(rot.N)]
    cts, msgs, jobs = chip_smoke.rotation_era(keys, tprivs, 11, host)
    backend = GpuBackend(device="cpu", pipeline=HostEraPipeline(host))
    res = backend.tpke_era_verify_combine(jobs, keys.tpke_verification_keys, rot.Rng(12))
    assert [ok and tpke.decrypt_with_combined(ct, comb) == m
            for (ok, comb), ct, m in zip(res, cts, msgs)] == [True] * rot.N
    coins = [(b"coin %d" % c, {i: by_slot[i].ts_share.sign(b"coin %d" % c, host)
                               for i in range(rot.N)}) for c in range(rot.N)]
    sigs = ts.era_verify_combine(keys.ts_keys, coins, rot.Rng(13),
                                 GpuBackend(device="cpu", pipeline=HostEraPipeline(host)))
    assert all(s is not None and keys.ts_keys.shared.verify(m, s, host)
               for (m, _), s in zip(coins, sigs))


def test_attendance_report_equal_and_checked_in(sides):
    jax, port = sides
    sc = PORT.system_contracts
    report_at = chip_smoke.ROT_CYCLE - 1  # the records of block 20
    reports = [[tx for tx in s.records[report_at]["sent"] if sc.SEL_SUBMIT_ATTENDANCE in tx]
               for s in sides]
    assert len(reports[1]) == 1 and reports[0] == reports[1]
    counts = port.chain.attendance.counts_for(0)
    assert counts == jax.chain.attendance.counts_for(0)
    assert sum(counts.values()) == (chip_smoke.ROT_CYCLE - 1) * (rot.N - 1)
    key = b"att_checkin:" + (1).to_bytes(8, "big")
    pub0 = PORT.ecdsa.public_key_bytes(port.privs[0])
    for s in sides:
        raw = s.chain.storage(sc.STAKING_ADDRESS, key)
        assert raw is not None and PORT.system_contracts.Reader(raw).bytes_list() == [pub0]
