"""The port's common-coin path vs the JAX package, on the CPU.

* `TsGpuEraPipeline(device="cpu").run_era` against the JAX package's own
  oracle `lachain_tpu.ops.verify.TsHostEraPipeline` on JAX-dealt keys at
  (n, f) = (5, 1) and (7, 2), with masked lanes and an all-absent dummy
  coin: the rlc lists must be identical and the points equal, with no
  combine recomputed on the host; a coin whose combine lanes collide is
  recomputed there and counted in `verify.ESCAPES`.
* `GpuBackend(device="cpu").ts_era_verify_combine` against the JAX
  package's `TpuBackend(host_backend=PythonBackend())` at (4, 1), with keys
  and shares carried across by `lachain_tpu_torch.convert`, one partial
  coin and one poisoned share: the (ok, combined) lists must be equal.
* The port's `threshold_sig.era_verify_combine` against the JAX one: the
  signature bytes and the parity bits must be equal, on the card's path and
  on the host's.
Every comparison is exact; inputs come from seeded `random.Random`s.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto import hashes as jhashes
from lachain_tpu.crypto import threshold_sig as jts
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu.crypto.tpu_backend import CoinJob as JaxCoinJob
from lachain_tpu.crypto.tpu_backend import TpuBackend
from lachain_tpu.ops.verify import TsHostEraPipeline as JaxTsHostEraPipeline
from lachain_tpu_torch import convert
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import hashes, threshold_sig
from lachain_tpu_torch.crypto.gpu_backend import CoinJob, GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.ops import verify
from lachain_tpu_torch.ops.verify import TsGpuEraPipeline

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _jax_coins(n, f, n_coins, seed):
    """A JAX-dealt key set and every validator's share of each coin."""
    dealer = jts.TsTrustedKeyGen(n, f, rng=SeededRng(seed))
    coins = []
    for c in range(n_coins):
        msg = b"coin|era=%d|id=%d" % (seed, c)
        coins.append((msg, [dealer.private_key_share(i).sign(msg) for i in range(n)]))
    return dealer, coins


def _lagrange_row(n, ids):
    row = [0] * n
    for i, c in zip(ids, jbls.fr_lagrange_coeffs([i + 1 for i in ids], at=0)):
        row[i] = c
    return row


def _to_port(dealer, n):
    """The JAX dealer's keys through numpy arrays of its own encodings."""
    key_set, privs = convert.ts_keys_from_numpy(
        np.stack([np.frombuffer(jbls.g1_to_bytes(k.y), np.uint8)
                  for k in dealer.pub_key_set.keys]),
        dealer.pub_key_set.t,
        np.stack([np.frombuffer(jbls.fr_to_bytes(dealer.private_key_share(i).x_i),
                                np.uint8) for i in range(n)]),
    )
    return key_set, privs


def _port_shares(shares):
    return convert.partial_signatures_from_numpy(
        np.stack([np.frombuffer(jbls.g2_to_bytes(s.sigma), np.uint8) for s in shares]),
        [s.signer_id for s in shares],
    )


@pytest.mark.parametrize("n,f", [(5, 1), (7, 2)])
def test_ts_pipeline_vs_jax_host_pipeline(n, f):
    dealer, coins = _jax_coins(n, f, 3, seed=13 * n)
    y_points = [k.y for k in dealer.pub_key_set.keys]
    rows, masks = [], []
    for c, (_msg, shares) in enumerate(coins):
        mask = [True] * n
        if c == 1:  # two absent shares; combine over the present ones
            mask[0] = mask[n - 1] = False
        present = [i for i in range(n) if mask[i]]
        sig = [s.sigma if mask[i] else jbls.G2_INF for i, s in enumerate(shares)]
        rows.append((sig, _lagrange_row(n, present[: f + 1])))
        masks.append(mask)
    rows.append(([jbls.G2_INF] * n, [0] * n))  # all-absent dummy coin
    masks.append([False] * n)

    verify.reset_escapes()
    got, got_rlc = TsGpuEraPipeline(device="cpu").run_era(
        rows, y_points, SeededRng(5), masks=masks
    )
    assert verify.ESCAPES["ts_combine"] == 0  # every combine from the kernels
    want, want_rlc = JaxTsHostEraPipeline(PythonBackend()).run_era(
        rows, y_points, SeededRng(5), masks=masks
    )
    assert got_rlc == want_rlc
    assert all(c == 0 for c in got_rlc[-1])
    for g_coin, w_coin in zip(got, want):
        assert bls.g2_eq(g_coin[0], w_coin[0])
        assert bls.g1_eq(g_coin[1], w_coin[1])
        assert bls.g2_eq(g_coin[2], w_coin[2])
    assert bls.g2_is_inf(got[-1][0]) and bls.g2_is_inf(got[-1][2])
    for c in (0, 2):  # the combine verifies under the shared key
        sig = threshold_sig.Signature(got[c][2])
        assert jts.TsPublicKey(dealer.pub_key_set.shared.y).verify(
            coins[c][0], jts.Signature(sig.sigma)
        )


def test_ts_pipeline_combine_collision_is_counted():
    """Two equal shares under equal Lagrange coefficients: the combine lanes
    collide in the incomplete add (Z = 0), the pipeline recomputes that
    coin's combine with the host MSM, as TsPallasPipeline does, and counts
    it in `ESCAPES`. The result equals the JAX host pipeline's."""
    rng = random.Random(0xE5C)
    p = jbls.g2_mul(jbls.G2_GEN, rng.randrange(1, jbls.R))
    c = rng.randrange(1, jbls.R)
    y_points = [jbls.g1_mul(jbls.G1_GEN, rng.randrange(1, jbls.R)) for _ in range(2)]
    rows = [([p, p], [c, c])]
    verify.reset_escapes()
    got, got_rlc = TsGpuEraPipeline(device="cpu").run_era(rows, y_points, SeededRng(6))
    assert verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), ts_combine=1)
    want, want_rlc = JaxTsHostEraPipeline(PythonBackend()).run_era(
        rows, y_points, SeededRng(6)
    )
    assert got_rlc == want_rlc
    assert bls.g2_eq(got[0][2], jbls.g2_mul(p, 2 * c))
    assert all(eq(a, b) for eq, a, b in
               zip((bls.g2_eq, bls.g1_eq, bls.g2_eq), got[0], want[0]))


def test_backend_vs_tpu_backend_with_poisoned_share():
    n, f = 4, 1
    dealer, coins = _jax_coins(n, f, 3, seed=31)
    key_set, _privs = _to_port(dealer, n)
    assert bls.g1_eq(key_set.shared.y, dealer.pub_key_set.shared.y)
    bad_coin, bad_lane = 1, 0
    lag = _lagrange_row(n, list(range(f + 1)))
    jax_jobs, port_jobs = [], []
    for c, (msg, shares) in enumerate(coins):
        jrow = [s.sigma for s in shares]
        prow = [s.sigma for s in _port_shares(shares)]
        if c == bad_coin:
            jrow[bad_lane] = jbls.g2_add(jrow[bad_lane], jbls.G2_GEN)
            prow[bad_lane] = bls.g2_add(prow[bad_lane], bls.G2_GEN)
        if c == 2:
            jrow[n - 1] = prow[n - 1] = None  # an absent share
        h = threshold_sig._hash_to_sig_point(msg)
        assert bls.g2_eq(h, jts._hash_to_sig_point(msg))
        jax_jobs.append(JaxCoinJob(jrow, list(lag), h))
        port_jobs.append(CoinJob(prow, list(lag), h))

    want = TpuBackend(host_backend=PythonBackend()).ts_era_verify_combine(
        jax_jobs, dealer.pub_key_set.keys, rng=SeededRng(77)
    )
    got = GpuBackend(device="cpu").ts_era_verify_combine(
        port_jobs, key_set.keys, SeededRng(77)
    )
    assert [ok for ok, _ in got] == [ok for ok, _ in want]
    assert [ok for ok, _ in got] == [c != bad_coin for c in range(len(coins))]
    for (ok, comb), (_, wcomb) in zip(got, want):
        if not ok:
            assert comb is None and wcomb is None
            continue
        assert bls.g2_eq(comb, wcomb)


def test_era_verify_combine_vs_jax():
    """Signature bytes and coin bits equal the JAX package's, on the card's
    path (GpuBackend on the CPU) and on the host's (HostBackend). Coin 1
    holds a bad chosen share, coin 2 too few signers, coin 3 a bad share
    outside the chosen t+1 (it cannot flip the result)."""
    n, f = 4, 1
    dealer, coins = _jax_coins(n, f, 4, seed=47)
    key_set, privs = _to_port(dealer, n)
    jax_in, port_in = [], []
    for c, (msg, shares) in enumerate(coins):
        jsh = {s.signer_id: s for s in shares}
        if c == 1:
            s0 = jsh[0]
            jsh[0] = jts.PartialSignature(jbls.g2_add(s0.sigma, jbls.G2_GEN), 0)
        if c == 2:
            jsh = {3: jsh[3]}
        if c == 3:
            s3 = jsh[3]
            jsh[3] = jts.PartialSignature(jbls.g2_neg(s3.sigma), 3)
        jax_in.append((msg, jsh))
        port_in.append((msg, {s.signer_id: s for s in _port_shares(list(jsh.values()))}))
    # the carried private shares sign bit for bit as the JAX ones do
    ps = privs[2].sign(coins[0][0], HostBackend())
    assert bls.g2_to_bytes(ps.sigma) == jbls.g2_to_bytes(coins[0][1][2].sigma)
    assert key_set.verify_share(coins[0][0], ps, HostBackend())
    assert not key_set.verify_share(coins[1][0], ps, HostBackend())

    want = jts.era_verify_combine(dealer.pub_key_set, jax_in, rng=SeededRng(3))
    for backend in (GpuBackend(device="cpu"), HostBackend()):
        got = threshold_sig.era_verify_combine(
            key_set, port_in, SeededRng(3), backend
        )
        assert [g is None for g in got] == [w is None for w in want]
        assert [g is None for g in got] == [False, True, True, False]
        for g, w in zip(got, want):
            if g is not None:
                assert g.to_bytes() == w.to_bytes()
                assert g.parity == w.parity
    sig0 = threshold_sig.Signature.from_bytes(want[0].to_bytes())
    assert key_set.shared.verify(coins[0][0], sig0, HostBackend())


def test_era_verify_combine_propagates_device_errors(monkeypatch):
    """No exception-to-host fallback: an error on the card's path reaches
    the caller."""
    n, f = 4, 1
    dealer, coins = _jax_coins(n, f, 1, seed=59)
    key_set, _ = _to_port(dealer, n)
    msg, shares = coins[0]
    backend = GpuBackend(device="cpu")

    def broken(*_a, **_k):
        raise RuntimeError("device path failed")

    monkeypatch.setattr(backend._ts_pipeline, "run_era", broken)
    port_shares = {s.signer_id: s for s in _port_shares(shares)}
    with pytest.raises(RuntimeError, match="device path failed"):
        threshold_sig.era_verify_combine(
            key_set, [(msg, port_shares)], SeededRng(1), backend
        )


def test_keccak256_matches_jax():
    rng = random.Random(0xCC)
    for size in (0, 1, 135, 136, 137, 192, 300):
        data = bytes(rng.randrange(256) for _ in range(size))
        assert hashes.keccak256(data) == jhashes._keccak256_py(data)
