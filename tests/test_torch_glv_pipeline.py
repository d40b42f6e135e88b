"""`GlvEraPipeline` and `GpuBackend(pipeline=...)` on the CPU.

* `GlvEraPipeline(device="cpu").run_era` against the JAX package's
  `HostEraPipeline` and the port's `GpuEraPipeline`, with the same seeded
  rng, on a JAX-dealt era at (n, f) = (5, 1) (K=5 padded to 8) with partly
  masked slots and an all-absent dummy slot: the same rlc lists and the same
  (u_agg, y_agg, combined), with no combine recomputed on the host.
* A forced combine collision (two equal shares under equal Lagrange
  coefficients) escapes to the host MSM exactly once and equals the host's.
* `GpuBackend(device="cpu", pipeline=GlvEraPipeline(device="cpu"))` on a
  small TPKE era: every slot decrypts and a poisoned share isolates
  exactly its slot, as `tpke_era_verify_combine` on the default pipeline
  gives it; a pipeline on another device raises.
* The key-set cache: identity by `is` (an equal list is another set), at
  most 4 sets, the oldest dropped.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import tpke as jtpke
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.ops.verify import HostEraPipeline as JaxHostEraPipeline
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import verify
from lachain_tpu_torch.ops.verify import GlvEraPipeline, GpuEraPipeline

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _lagrange_row(n, ids):
    row = [0] * n
    for i, c in zip(ids, jbls.fr_lagrange_coeffs([i + 1 for i in ids], at=0)):
        row[i] = c
    return row


def test_run_era_equals_host_and_gpu_pipelines():
    n, f = 5, 1
    dealer = jtpke.TpkeTrustedKeyGen(n, f, rng=SeededRng(61))
    y_points = [vk.y_i for vk in dealer.verification_keys]
    slots, masks, cts = [], [], []
    for s in range(2):
        msg = bytes([s + 7]) * 32
        ct = dealer.pub.encrypt(msg, share_id=s, rng=SeededRng(161 + s))
        decs = [dealer.private_key(i).decrypt_share(ct, check=False) for i in range(n)]
        mask = [True] * n
        if s == 1:  # two absent shares; combine over the present ones
            mask[0] = mask[3] = False
        present = [i for i in range(n) if mask[i]]
        slots.append(([d.ui if mask[i] else jbls.G1_INF for i, d in enumerate(decs)],
                      _lagrange_row(n, present[: f + 1])))
        masks.append(mask)
        cts.append((ct, msg))
    slots.append(([jbls.G1_INF] * n, [0] * n))  # all-absent dummy slot
    masks.append([False] * n)

    verify.reset_escapes()
    glv = GlvEraPipeline(HostBackend(), device="cpu")
    got, got_rlc = glv.run_era(slots, y_points, SeededRng(5), masks=masks)
    assert verify.ESCAPES == dict.fromkeys(verify.ESCAPES, 0)
    assert set(glv.last_timings) == {"pack_s", "launch_s", "device_s", "wait_s", "fetch_s"}
    want, want_rlc = JaxHostEraPipeline(PythonBackend()).run_era(
        slots, y_points, SeededRng(5), masks=masks)
    ref, ref_rlc = GpuEraPipeline(HostBackend(), device="cpu").run_era(
        slots, y_points, SeededRng(5), masks=masks)
    assert got_rlc == want_rlc == ref_rlc
    assert all(c == 0 for c in got_rlc[-1])
    for g_slot, w_slot, r_slot in zip(got, want, ref):
        for g, w, r in zip(g_slot, w_slot, r_slot):
            assert bls.g1_eq(g, w) and bls.g1_eq(g, r)
    assert all(bls.g1_is_inf(p) for p in got[-1])
    for s, (ct, msg) in enumerate(cts):
        assert jtpke.decrypt_with_combined(ct, got[s][2]) == msg


def test_combine_collision_escapes_once():
    """Both GLV halves of the combine meet P + P in the incomplete tree
    (Z = 0): the slot's combine is recomputed by the host MSM, counted
    once, and equal to the JAX host pipeline's."""
    rng = random.Random(0xC011)
    p = bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
    c = rng.randrange(1, bls.R)
    y_points = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(2)]
    slots = [([p, p], [c, c])]
    verify.reset_escapes()
    got, got_rlc = GlvEraPipeline(HostBackend(), device="cpu").run_era(
        slots, y_points, SeededRng(6))
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), tpke_combine=1)
    want, want_rlc = JaxHostEraPipeline(PythonBackend()).run_era(
        slots, y_points, SeededRng(6))
    assert got_rlc == want_rlc
    assert bls.g1_eq(got[0][2], bls.g1_mul(p, 2 * c))
    assert all(bls.g1_eq(a, b) for a, b in zip(got[0], want[0]))


def _era(n: int, seed: int):
    f = (n - 1) // 3
    dealer = tpke.TpkeTrustedKeyGen(n, f, SeededRng(seed))
    privs = [dealer.private_key(i) for i in range(n)]
    lag = [0] * n
    for i, c in zip(range(f + 1), bls.fr_lagrange_coeffs(list(range(1, f + 2)), at=0)):
        lag[i] = c
    cts, msgs, jobs = [], [], []
    for s in range(3):
        msg = bytes([(s * 5 + i) % 256 for i in range(32)])
        ct = dealer.pub.encrypt(msg, s, SeededRng(seed * 100 + s))
        row = [p.decrypt_share(ct, check=False).ui for p in privs]
        jobs.append(EraSlotJob(row, list(lag), tpke._hash_uv_to_g2(ct.u, ct.v), ct.w))
        cts.append(ct)
        msgs.append(msg)
    return dealer, cts, msgs, jobs


def test_backend_on_glv_pipeline_decrypts_and_isolates():
    dealer, cts, msgs, jobs = _era(4, 19)
    vks = dealer.verification_keys
    bad = 1
    row = list(jobs[bad].u_by_validator)
    row[0] = bls.g1_add(row[0], bls.G1_GEN)
    jobs[bad] = EraSlotJob(row, jobs[bad].lagrange_row, jobs[bad].h, jobs[bad].w)
    backend = GpuBackend(device="cpu", pipeline=GlvEraPipeline(device="cpu"))
    assert backend.era_dispatch_depth == 1  # synchronous: no dispatch_era
    got = backend.tpke_era_verify_combine(jobs, vks, SeededRng(3))
    assert [ok for ok, _ in got] == [s != bad for s in range(len(jobs))]
    assert got[bad][1] is None
    for s, (ok, comb) in enumerate(got):
        if ok:
            assert tpke.decrypt_with_combined(cts[s], comb) == msgs[s]
    want = GpuBackend(device="cpu").tpke_era_verify_combine(jobs, vks, SeededRng(3))
    assert [ok for ok, _ in got] == [ok for ok, _ in want]
    assert all(c is None or bls.g1_eq(c, w) for (_, c), (_, w) in zip(got, want))
    assert backend.era_calls == 1 and backend.era_slots_total == len(jobs)
    assert "pairing_s" in backend.last_timings


def test_backend_refuses_a_pipeline_on_another_device(monkeypatch):
    pipeline = GlvEraPipeline(device="cpu")
    monkeypatch.setattr(pipeline, "device", torch.device("meta"))
    with pytest.raises(ValueError):
        GpuBackend(device="cpu", pipeline=pipeline)


def test_key_set_cache_identity_and_limit(monkeypatch):
    built = []

    def fake_tables(y):
        built.append(y)
        return object()

    monkeypatch.setattr(verify.msm, "y_fixed_base_tables", fake_tables)
    pipeline = GlvEraPipeline(device="cpu")
    a, b, c, d = ([bls.g1_mul(bls.G1_GEN, i + 2)] for i in range(4))
    first = pipeline.y_device(a)
    assert pipeline.y_device(a) is first and len(built) == 1
    assert pipeline.y_device(list(a)) is not first  # equal, not the same set
    pipeline.y_device(b)
    pipeline.y_device(c)
    assert len(built) == 4
    assert pipeline.y_device(a) is first and len(built) == 4  # 4 sets kept
    pipeline.y_device(d)  # a fifth set drops the oldest, a
    assert len(built) == 5
    for keys in (b, c, d):
        pipeline.y_device(keys)
    assert len(built) == 5
    assert pipeline.y_device(a) is not first and len(built) == 6
