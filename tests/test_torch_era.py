"""The port's era pipeline and backend vs the JAX package, on the CPU.

* `GpuEraPipeline(device="cpu").run_era` against the JAX package's own
  oracle `lachain_tpu.ops.verify.HostEraPipeline`, on JAX-dealt eras at
  (n, f) = (5, 1) and (7, 2), with partly masked slots and an all-absent
  dummy slot: the rlc lists must be identical and the (u_agg, y_agg,
  combined) points equal, with no combine recomputed on the host; a slot
  whose combine lanes collide is recomputed there and counted in
  `verify.ESCAPES`.
* `GpuBackend(device="cpu").tpke_era_verify_combine` against the JAX
  package's `TpuBackend(host_backend=PythonBackend())` at (5, 1), with the
  keys and the era carried across by `lachain_tpu_torch.convert` and one
  poisoned share: the (ok, combined) lists and the plaintexts must be equal.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.crypto.tpu_backend import EraSlotJob as JaxEraSlotJob
from lachain_tpu.crypto.tpu_backend import TpuBackend
from lachain_tpu.ops.verify import HostEraPipeline as JaxHostEraPipeline
from lachain_tpu_torch import convert
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.ops import verify
from lachain_tpu_torch.ops.verify import GpuEraPipeline

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _jax_era(n, f, n_slots, seed):
    dealer = jtpke.TpkeTrustedKeyGen(n, f, rng=SeededRng(seed))
    slots = []
    for s in range(n_slots):
        msg = bytes([s + 1]) * 32
        ct = dealer.pub.encrypt(msg, share_id=s, rng=SeededRng(seed + 100 + s))
        decs = [dealer.private_key(i).decrypt_share(ct, check=False) for i in range(n)]
        slots.append((ct, decs, msg))
    return dealer, slots


def _lagrange_row(n, ids):
    row = [0] * n
    for i, c in zip(ids, jbls.fr_lagrange_coeffs([i + 1 for i in ids], at=0)):
        row[i] = c
    return row


@pytest.mark.parametrize("n,f", [(5, 1), (7, 2)])
def test_pipeline_vs_jax_host_pipeline(n, f):
    dealer, era = _jax_era(n, f, 3, seed=11 * n)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots, masks = [], []
    for s, (_ct, decs, _msg) in enumerate(era):
        mask = [True] * n
        if s == 1:  # two absent shares; combine over the present ones
            mask[0] = mask[n - 1] = False
        present = [i for i in range(n) if mask[i]]
        row = [d.ui if mask[i] else jbls.G1_INF for i, d in enumerate(decs)]
        slots.append((row, _lagrange_row(n, present[: f + 1])))
        masks.append(mask)
    slots.append(([jbls.G1_INF] * n, [0] * n))  # all-absent dummy slot
    masks.append([False] * n)

    verify.reset_escapes()
    got, got_rlc = GpuEraPipeline(device="cpu").run_era(
        slots, y_points, SeededRng(5), masks=masks
    )
    assert verify.ESCAPES["tpke_combine"] == 0  # every combine from the kernels
    want, want_rlc = JaxHostEraPipeline(PythonBackend()).run_era(
        slots, y_points, SeededRng(5), masks=masks
    )
    assert got_rlc == want_rlc
    assert all(c == 0 for c in got_rlc[-1])
    for g_slot, w_slot in zip(got, want):
        for g, w in zip(g_slot, w_slot):
            assert bls.g1_eq(g, w)
    assert all(bls.g1_is_inf(p) for p in got[-1])
    for s in (0, 2):  # combined point strips the pad
        assert tpke.decrypt_with_combined(
            tpke.EncryptedShare(era[s][0].u, era[s][0].v, era[s][0].w, s),
            got[s][2],
        ) == era[s][2]


def test_pipeline_combine_collision_is_counted():
    """Two equal shares under equal Lagrange coefficients: both GLV halves
    of the combine collide in the incomplete add (Z = 0), the pipeline
    recomputes that slot's combine with the host MSM, as the pg1 pipelines
    do, and counts it in `ESCAPES`. The result equals the JAX host
    pipeline's."""
    rng = random.Random(0xE5D)
    p = jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R))
    c = rng.randrange(1, jbls.R)
    y_points = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(2)]
    slots = [([p, p], [c, c])]
    verify.reset_escapes()
    got, got_rlc = GpuEraPipeline(device="cpu").run_era(slots, y_points, SeededRng(6))
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), tpke_combine=1)
    want, want_rlc = JaxHostEraPipeline(PythonBackend()).run_era(
        slots, y_points, SeededRng(6)
    )
    assert got_rlc == want_rlc
    assert bls.g1_eq(got[0][2], jbls.g1_mul(p, 2 * c))
    assert all(bls.g1_eq(a, b) for a, b in zip(got[0], want[0]))


def _to_port(dealer, era):
    """Carry the JAX-side keys and era into the port through numpy arrays of
    the JAX package's own encodings."""
    pub, vks, privs = convert.tpke_keys_from_numpy(
        np.frombuffer(jbls.g1_to_bytes(dealer.pub.y), np.uint8),
        dealer.pub.t,
        np.stack([np.frombuffer(jbls.g1_to_bytes(vk.y_i), np.uint8)
                  for vk in dealer.verification_keys]),
        np.stack([np.frombuffer(jbls.fr_to_bytes(dealer.private_key(i).x_i), np.uint8)
                  for i in range(len(dealer.verification_keys))]),
    )
    port_era = []
    for ct, decs, msg in era:
        pct = convert.encrypted_share_from_numpy(
            np.frombuffer(jbls.g1_to_bytes(ct.u), np.uint8),
            np.frombuffer(ct.v, np.uint8),
            np.frombuffer(jbls.g2_to_bytes(ct.w), np.uint8),
            ct.share_id,
        )
        pdecs = convert.decrypted_shares_from_numpy(
            np.stack([np.frombuffer(jbls.g1_to_bytes(d.ui), np.uint8) for d in decs]),
            [d.decryptor_id for d in decs],
            ct.share_id,
        )
        port_era.append((pct, pdecs, msg))
    return pub, vks, privs, port_era


def test_backend_vs_tpu_backend_with_poisoned_share():
    n, f = 5, 1
    dealer, era = _jax_era(n, f, 3, seed=29)
    pub, vks, privs, port_era = _to_port(dealer, era)
    assert pub.t == f
    # the carried keys reproduce the JAX shares bit for bit
    for i in range(n):
        share = privs[i].decrypt_share(port_era[0][0], check=True)
        assert bls.g1_to_bytes(share.ui) == jbls.g1_to_bytes(era[0][1][i].ui)

    bad_slot, bad_lane = 1, 0
    lag = _lagrange_row(n, list(range(f + 1)))
    jax_jobs, port_jobs = [], []
    for s, ((ct, decs, _), (pct, pdecs, _)) in enumerate(zip(era, port_era)):
        jrow = [d.ui for d in decs]
        prow = [d.ui for d in pdecs]
        if s == bad_slot:
            jrow[bad_lane] = jbls.g1_add(jrow[bad_lane], jbls.G1_GEN)
            prow[bad_lane] = bls.g1_add(prow[bad_lane], bls.G1_GEN)
        if s == 2:
            jrow[n - 1] = prow[n - 1] = None  # an absent share
        jax_jobs.append(JaxEraSlotJob(jrow, list(lag), jtpke.ciphertext_h(ct), ct.w))
        port_jobs.append(EraSlotJob(prow, list(lag),
                                    tpke._hash_uv_to_g2(pct.u, pct.v), pct.w))
    for jj, pj in zip(jax_jobs, port_jobs):  # same H_G2(U, V) and W
        assert bls.g2_eq(jj.h, pj.h) and bls.g2_eq(jj.w, pj.w)

    want = TpuBackend(host_backend=PythonBackend()).tpke_era_verify_combine(
        jax_jobs, dealer.verification_keys, rng=SeededRng(77)
    )
    got = GpuBackend(device="cpu").tpke_era_verify_combine(
        port_jobs, vks, SeededRng(77)
    )
    assert [ok for ok, _ in got] == [ok for ok, _ in want]
    assert [ok for ok, _ in got] == [s != bad_slot for s in range(len(era))]
    for s, ((ok, comb), (_, wcomb)) in enumerate(zip(got, want)):
        if not ok:
            assert comb is None and wcomb is None
            continue
        assert bls.g1_eq(comb, wcomb)
        plain = tpke.decrypt_with_combined(port_era[s][0], comb)
        assert plain == jtpke.decrypt_with_combined(era[s][0], wcomb) == era[s][2]


def test_ragged_slots_raise():
    dealer, era = _jax_era(5, 1, 1, seed=3)
    y_points = [vk.y_i for vk in dealer.verification_keys]
    row = [d.ui for d in era[0][1]]
    with pytest.raises(ValueError):
        GpuEraPipeline(device="cpu").run_era(
            [(row[:-1], [0] * 4)], y_points, SeededRng(1)
        )
