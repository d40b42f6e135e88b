"""`g1_msm_batch`, the DKG's route to the card, on the CPU.

* `GpuBackend(device="cpu").g1_msm_batch` runs the card's composite (one
  table build, scan and tree reduce over every group padded to one power
  of two k) on the plain versions of the kernels; it equals the native
  host group by group at 16 lanes or fewer, with infinity inputs, zero
  scalars, groups of different sizes, and a repeated point whose
  collision escapes to the host and is counted in `ESCAPES["g1_msm"]`.
* The DKG's calls: `Commitment.evaluate_row` makes one `g1_msm_batch` and
  no `g1_msm`, the value check one `g1_msm` over the distinct coefficients,
  and `try_get_keys` its N+1 key MSMs as one batch of N+1 groups.
* `Commitment.evaluate(x, x)` (a validator's own value) on the plain route:
  the (f+1)^2 terms repeat points with equal scalars; summed by coefficient,
  no partial sums collide and nothing escapes (at f = 2 the terms' layout
  of the reference collided: C[2] x^2 + C[3] x^3 twice at the tree's
  second level).
* A value check whose MSM launch fails raises; only the value's
  decryption is caught, as a byzantine sender's.
* At (4, 1), validator 0 on `GpuBackend(device="cpu")` and the others on
  the native backend: every round's snapshot and the keyring equal the
  all-native fleet's. One plain call takes ~1.2-1.8 s here, ~25 calls in
  all.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu_torch.consensus import keygen as kg
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend
from lachain_tpu_torch.ops import g1, verify

torch.set_num_threads(1)

NATIVE = NativeBackend()


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


@pytest.fixture(scope="module")
def plain():
    return GpuBackend(device="cpu")


def points(rng, n):
    return NATIVE.g1_mul_batch([bls.G1_GEN] * n, [rng.randrange(1, bls.R) for _ in range(n)])


def same(got, want) -> bool:
    return len(got) == len(want) and all(bls.g1_eq(a, b) for a, b in zip(got, want))


def test_groups_equal_the_host(plain):
    """Groups of 1, 3 and 4 points (k = 4, 12 lanes) with an infinity input,
    a zero scalar, a group whose every scalar is zero and a scalar >= r."""
    rng = random.Random(1)
    p = points(rng, 8)
    groups = [[p[0]], [p[1], bls.G1_INF, p[2]], [p[3], p[4], p[5], p[6]], [p[7], p[0]]]
    scalars = [[rng.randrange(bls.R)], [rng.randrange(bls.R), 5, 0],
               [1, bls.R + 3, rng.randrange(bls.R), rng.randrange(bls.R)], [0, 0]]
    verify.reset_escapes()
    got = plain.g1_msm_batch(groups, scalars)
    assert same(got, NATIVE.g1_msm_batch(groups, scalars))
    assert same(got, HostBackend().g1_msm_batch(groups, scalars))
    assert bls.g1_is_inf(got[3])
    assert not any(verify.ESCAPES.values())


def test_one_group_of_sixteen(plain):
    rng = random.Random(2)
    p = points(rng, 16)
    s = [rng.randrange(bls.R) for _ in range(16)]
    assert same(plain.g1_msm_batch([p], [s]), [NATIVE.g1_msm(p, s)])


def test_repeated_point_escapes_to_the_host(plain):
    """[P, P] with equal scalars: the tree's incomplete add of two equal
    partial sums gives Z = 0, the group comes back as infinity with live
    lanes, and the host recomputes it: one escape; the other group is the
    card's."""
    rng = random.Random(3)
    p = points(rng, 2)
    verify.reset_escapes()
    got = plain.g1_msm_batch([[p[0], p[0]], [p[1], bls.G1_INF]], [[5, 5], [7, 9]])
    assert verify.ESCAPES["g1_msm"] == 1
    assert same(got, [NATIVE.g1_mul(p[0], 10), NATIVE.g1_mul(p[1], 7)])
    verify.reset_escapes()


@pytest.mark.parametrize("x,y", [(1, 1), (3, 3)])
def test_evaluate_on_the_plain_route_never_escapes(plain, x, y):
    com = kg.BiVarSymmetricPolynomial.random(2, SeededRng(3)).commit(NATIVE)
    want = NATIVE.g1_msm(
        [com.coeffs[kg._tri_index(i, j)] for i in range(3) for j in range(3)],
        [x ** i * y ** j for i in range(3) for j in range(3)])
    verify.reset_escapes()
    assert bls.g1_eq(com.evaluate(x, y, plain), want)
    assert not any(verify.ESCAPES.values())


def test_argument_errors_and_empty(plain):
    assert plain.g1_msm_batch([], []) == []
    assert NATIVE.g1_msm_batch([], []) == []
    with pytest.raises(ValueError):
        plain.g1_msm_batch([[bls.G1_GEN]], [])
    with pytest.raises(ValueError):
        plain.g1_msm_batch([[bls.G1_GEN]], [[1, 2]])
    with pytest.raises(ValueError):
        NATIVE.g1_msm_batch([[bls.G1_GEN]], [])
    with pytest.raises(ValueError):
        HostBackend().g1_msm_batch([[bls.G1_GEN]], [])


class Spy:
    """A host backend that counts the MSM calls the DKG makes."""

    def __init__(self):
        self.host = NATIVE
        self.calls = []

    def g1_msm(self, pts, ss):
        self.calls.append(("g1_msm", len(pts)))
        return NATIVE.g1_msm(pts, ss)

    def g1_msm_batch(self, pls, sls):
        self.calls.append(("batch", len(pls), max(len(p) for p in pls)))
        return NATIVE.g1_msm_batch(pls, sls)

    def g1_mul(self, pt, s):
        return NATIVE.g1_mul(pt, s)


def fleet(n, f, seed, backends):
    rng = SeededRng(seed)
    privs = [ecdsa.generate_private_key(rng) for _ in range(n)]
    pubs = [ecdsa.public_key_bytes(p) for p in privs]
    return [kg.TrustlessKeygen(privs[i], pubs, f, 0, SeededRng(seed + i), backends[i])
            for i in range(n)]


def run(nodes, snapshots):
    commits = [node.start_keygen() for node in nodes]
    for dealer, commit in enumerate(commits):
        values = [(i, node.handle_commit(dealer, commit)) for i, node in enumerate(nodes)]
        for sender, vmsg in values:
            for node in nodes:
                node.handle_send_value(sender, vmsg)
        snapshots.append([node.to_bytes() for node in nodes])
    return [node.try_get_keys() for node in nodes]


def test_dkg_calls_one_batch_per_row_check_and_keyring():
    n, f = 7, 2
    # the coefficients the (f+1)^2 terms reach: (0, 2) and (1, 1) share one
    distinct = len({kg._tri_index(i, j) for i in range(f + 1) for j in range(f + 1)})
    assert distinct == 5
    spy = Spy()
    nodes = fleet(n, f, 5, [spy] + [NATIVE] * (n - 1))
    commits = [node.start_keygen() for node in nodes]
    for dealer, commit in enumerate(commits):
        spy.calls.clear()
        values = [node.handle_commit(dealer, commit) for node in nodes]
        assert spy.calls == [("batch", f + 1, f + 1)]  # validator 0's row check
        for sender, vmsg in enumerate(values):
            spy.calls.clear()
            for node in nodes:
                node.handle_send_value(sender, vmsg)
            assert spy.calls == [("g1_msm", distinct)]  # its value check
    spy.calls.clear()
    assert nodes[0].try_get_keys() is not None
    # the f+1 dealers' committed rows at 0, then the N+1 keys in one batch
    assert spy.calls == [("batch", f + 1, f + 1)] * (f + 1) + [("batch", n + 1, f + 1)]


def test_plain_validator_equals_the_native_fleet(plain):
    """Validator 0 on GpuBackend(device="cpu"), the card's composite on the
    plain versions: the all-native fleet's snapshot after every dealer's
    round, its keyring, and no escape."""
    n, f, seed = 4, 1, 42
    want_snaps, got_snaps = [], []
    want = run(fleet(n, f, seed, [NATIVE] * n), want_snaps)
    verify.reset_escapes()
    got = run(fleet(n, f, seed, [plain] + [NATIVE] * (n - 1)), got_snaps)
    assert got_snaps == want_snaps
    assert [k.public_key_hash for k in got] == [k.public_key_hash for k in want]
    assert got[0].tpke_priv.to_bytes() == want[0].tpke_priv.to_bytes()
    assert not any(verify.ESCAPES.values())


def test_a_failed_launch_raises_from_the_value_check(plain, monkeypatch):
    """A value check whose MSM fails on the device raises: only the value's
    decryption is caught (a byzantine sender's garbled value is acked but
    not valid), never the group work after it."""
    n, f = 4, 1
    nodes = fleet(n, f, 17, [plain] + [NATIVE] * (n - 1))
    commit = nodes[1].start_keygen()
    vmsgs = [node.handle_commit(1, commit) for node in nodes]

    def boom(*_args, **_kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(g1, "msm_reduce", boom)
    garbled = kg.ValueMessage(1, [b"\x07" * 93] + vmsgs[2].encrypted_values[1:])
    assert nodes[0].handle_send_value(2, garbled) is False
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        nodes[0].handle_send_value(3, vmsgs[3])
    state = nodes[0].states[1]
    assert state.acks[2] and not state.valid[2] and not state.valid[3]
