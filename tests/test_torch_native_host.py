"""The port's native host backend against the pure-Python oracles, on the CPU.

`lachain_tpu_torch.crypto.native_backend.NativeBackend` (the port's copy of
the JAX package's C++ library, built with g++ into lachain_tpu_torch/_build/)
is `GpuBackend`'s default host backend. Here it is held to the port's
`HostBackend`, the JAX package's `PythonBackend` and, where it builds, the
JAX package's own `NativeBackend`: the same bools from `pairing_check` on
products that hold and that fail (serial below 8 pairs, threaded from 8),
the same points from `hash_to_g2` in the TPKE and threshold-signature
domains, `g1_mul`, `g2_mul` and the two MSMs (infinity inputs and zero
scalars included), the same rejections of off-curve, out-of-range and
bad-length encodings; and one small TPKE era through
`GpuBackend(device="cpu")` gives the same (ok, combined) per slot and
isolates the same poisoned slot with the native host as with
`host_backend=HostBackend()`. `bls381.cpp` picks an ADX/BMI2 field
product where the compiler targets it (`-march=native` on most x86 hosts)
and a portable one elsewhere; a second build with both extensions turned
off holds the portable path to the oracle too. Pair lists stay small: the
pure-Python pairing takes ~50 ms a pair on one core. Tolerance: exact
(points compared as group elements; the native results are affine, Z = 1).
"""
from __future__ import annotations

import ctypes
import platform
import random
import subprocess

import pytest
import torch

from lachain_tpu.crypto import bls12381 as jbls
from lachain_tpu.crypto.provider import PythonBackend
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.crypto import threshold_sig, tpke
from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
from lachain_tpu_torch.crypto.host import HostBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend
from lachain_tpu_torch.ops import _build

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


@pytest.fixture(scope="module")
def native():
    return NativeBackend()


@pytest.fixture(scope="module")
def oracles():
    """The pure-Python backends: the port's and the JAX package's."""
    return {"host": HostBackend(), "jax_python": PythonBackend()}


@pytest.fixture(scope="module")
def jax_native():
    mod = pytest.importorskip("lachain_tpu.crypto.native_backend")
    return mod.NativeBackend()


def _g1(rng):
    return bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))


def _g2(rng):
    return bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))


def _pairs(rng, count: int, hold: bool) -> list:
    """count pairs whose product is 1 (pairs (aP, bQ), (-abP, Q) repeated),
    or, with hold False, the same with the last G1 point moved."""
    out = []
    for _ in range(count // 2):
        a, b = rng.randrange(1, bls.R), rng.randrange(1, bls.R)
        out += [(bls.g1_mul(bls.G1_GEN, a), bls.g2_mul(bls.G2_GEN, b)),
                (bls.g1_neg(bls.g1_mul(bls.G1_GEN, a * b % bls.R)), bls.G2_GEN)]
    if not hold:
        p, q = out[-1]
        out[-1] = (bls.g1_add(p, bls.G1_GEN), q)
    return out


@pytest.mark.parametrize("count", [2, 8])
@pytest.mark.parametrize("hold", [True, False])
def test_pairing_check_identity(native, oracles, jax_native, count, hold):
    pairs = _pairs(random.Random(count * 2 + hold), count, hold)
    assert native.pairing_check(pairs) is hold
    for backend in (*oracles.values(), jax_native):
        assert backend.pairing_check(pairs) is hold
    assert native.pairing_check([]) is True


@pytest.mark.parametrize("domain", [tpke._HW_DOMAIN, threshold_sig._SIG_DOMAIN])
def test_hash_to_g2_identity(native, oracles, jax_native, domain):
    for msg in (b"", b"coin|era=3|id=7", bytes(range(200))):
        got = native.hash_to_g2(msg, domain)
        for backend in (*oracles.values(), jax_native):
            assert bls.g2_eq(got, backend.hash_to_g2(msg, domain))
        assert bls.g2_is_on_curve(got)
    assert bls.g2_eq(native.hash_to_g2(b"x"), oracles["host"].hash_to_g2(b"x"))


def test_scalar_mul_identity(native, oracles, jax_native):
    rng = random.Random(0xA7)
    p, q = _g1(rng), _g2(rng)
    scalars = [0, 1, 2, bls.R - 1, bls.R, bls.R + 5, rng.randrange(1 << 256)]
    for k in scalars:
        for point in (p, bls.G1_INF):
            got = native.g1_mul(point, k)
            for backend in (*oracles.values(), jax_native):
                assert bls.g1_eq(got, backend.g1_mul(point, k))
        for point in (q, bls.G2_INF):
            got = native.g2_mul(point, k)
            for backend in (*oracles.values(), jax_native):
                assert bls.g2_eq(got, backend.g2_mul(point, k))
    assert bls.g1_is_inf(native.g1_mul(p, 0)) and bls.g2_is_inf(native.g2_mul(q, bls.R))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_msm_identity(native, oracles, jax_native, n):
    rng = random.Random(0xB0 + n)
    p1 = [_g1(rng) for _ in range(n)]
    p2 = [_g2(rng) for _ in range(n)]
    ss = [rng.randrange(bls.R) for _ in range(n)]
    if n >= 5:  # an infinity input, a zero scalar, a repeated point
        p1[1], p2[1] = bls.G1_INF, bls.G2_INF
        ss[2] = 0
        p1[4], p2[4] = p1[3], p2[3]
    got1, got2 = native.g1_msm(p1, ss), native.g2_msm(p2, ss)
    for backend in (*oracles.values(), jax_native):
        assert bls.g1_eq(got1, backend.g1_msm(p1, ss))
        assert bls.g2_eq(got2, backend.g2_msm(p2, ss))
    with pytest.raises(ValueError):
        native.g1_msm(p1, ss + [1])


def _off_curve_g1() -> bytes:
    return (1).to_bytes(48, "big") + (1).to_bytes(48, "big")


def _off_curve_g2() -> bytes:
    return b"".join(v.to_bytes(48, "big") for v in (1, 0, 1, 0))


def test_bad_encodings_raise(native, jax_native):
    rng = random.Random(0xBAD)
    p, q = _g1(rng), _g2(rng)
    g1b, g2b = bls.g1_to_bytes(p), bls.g2_to_bytes(q)
    assert bls.g1_eq(native.g1_deserialize(g1b), p)
    assert bls.g2_eq(native.g2_deserialize(g2b), q)
    bad1 = [g1b[:-1], g1b + b"\x00", _off_curve_g1(),
            bls.P.to_bytes(48, "big") + g1b[48:]]  # x out of range
    bad2 = [g2b[:-1], g2b + b"\x00", _off_curve_g2()]
    for data in bad1:
        with pytest.raises(ValueError):
            native.g1_deserialize(data)
        with pytest.raises(ValueError):
            jax_native.g1_deserialize(data)
    for data in bad2:
        with pytest.raises(ValueError):
            native.g2_deserialize(data)
        with pytest.raises(ValueError):
            jax_native.g2_deserialize(data)
    # the oracle's own parse rejects them too
    with pytest.raises(ValueError):
        jbls.g1_from_bytes(_off_curve_g1())
    # an off-curve point reaches no native op
    off = (1, 1, 1)
    with pytest.raises(ValueError):
        native.g1_mul(off, 3)
    with pytest.raises(ValueError):
        native.pairing_check([(off, q), (p, q)])
    with pytest.raises(ValueError):
        native.g2_mul(((1, 0), (1, 0), (1, 0)), 3)


def _era(n, f, slots, seed):
    dealer = tpke.TpkeTrustedKeyGen(n, f, SeededRng(seed))
    privs = [dealer.private_key(i) for i in range(n)]
    lag = [0] * n
    for i, c in zip(range(f + 1), bls.fr_lagrange_coeffs(list(range(1, f + 2)), at=0)):
        lag[i] = c
    cts, jobs = [], []
    for s in range(slots):
        ct = dealer.pub.encrypt(bytes([s + 1]) * 32, s, SeededRng(seed + 1 + s))
        row = [p.decrypt_share(ct, check=False).ui for p in privs]
        jobs.append(EraSlotJob(row, list(lag), tpke._hash_uv_to_g2(ct.u, ct.v), ct.w))
        cts.append(ct)
    return dealer, cts, jobs


def test_era_native_host_equals_python_host(native):
    """GpuBackend(device="cpu") with its default native host and with the
    pure-Python one: the same (ok, combined) per slot, the poisoned slot
    isolated by the same bisection, every other slot decrypting."""
    n, f = 4, 1
    dealer, cts, jobs = _era(n, f, 3, seed=0x5E)
    bad = 1
    row = list(jobs[bad].u_by_validator)
    row[0] = bls.g1_add(row[0], bls.G1_GEN)  # a chosen share: the slot fails
    jobs[bad] = EraSlotJob(row, jobs[bad].lagrange_row, jobs[bad].h, jobs[bad].w)
    default = GpuBackend(device="cpu")
    assert default.host_name == "native"
    python = GpuBackend(device="cpu", host_backend=HostBackend())
    assert python.host_name == "python"
    got = default.tpke_era_verify_combine(jobs, dealer.verification_keys, SeededRng(9))
    want = python.tpke_era_verify_combine(jobs, dealer.verification_keys, SeededRng(9))
    assert [ok for ok, _ in got] == [ok for ok, _ in want] == [s != bad for s in range(3)]
    for s, ((ok, comb), (_, wcomb)) in enumerate(zip(got, want)):
        if not ok:
            assert comb is None and wcomb is None
            continue
        assert comb == wcomb  # both from the same device pipeline
        assert tpke.decrypt_with_combined(cts[s], comb) == bytes([s + 1]) * 32
    assert set(default.last_timings) == set(python.last_timings)


def test_portable_build_equals_host(monkeypatch, tmp_path):
    """The library built without ADX/BMI2 (the portable field product, the
    path of a CPU without them) gives the oracle's answers too."""
    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the ADX/BMI2 product exists only on x86-64")
    so = tmp_path / "libportable.so"
    subprocess.run(
        [_build._gxx(), *_build.HOST_FLAGS, "-mno-adx", "-mno-bmi2", "-o", str(so),
         *(str(_build.HOST_SRC / name) for name in _build.HOST_SOURCES)],
        check=True, capture_output=True)
    monkeypatch.setattr(_build, "host_library", lambda: ctypes.CDLL(str(so)))
    portable, host = NativeBackend(), HostBackend()
    rng = random.Random(0x9087)
    for hold in (True, False):
        pairs = _pairs(rng, 2, hold)
        assert portable.pairing_check(pairs) is hold
    p, k = _g1(rng), rng.randrange(bls.R)
    assert bls.g1_eq(portable.g1_mul(p, k), host.g1_mul(p, k))
    assert bls.g2_eq(portable.hash_to_g2(b"portable"), host.hash_to_g2(b"portable"))
