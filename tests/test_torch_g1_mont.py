"""The G1 Montgomery conversions (`g1.mont_convert`, `g1.mul_beta`) on the CPU.

On the card every BLS12-381 coordinate is 12 x 32-bit Montgomery words,
and one `g1_mont` launch converts a whole (12c [+ 1], n) buffer as it lies
(csrc/g1.cu). The kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py); here its plain version, `g1_ref.mont_mul_words` (16-bit
limbs in int64 over the card's word layout), is held to Python ints, and
the marshal around it (`fp_encode`, `fp_decode`, `g1_pack`, `g1_coords`,
`fetch`, `g2_pack`, `g2_coords`) runs its card branch on CPU tensors in
the card's word layout, where every conversion takes the plain version.
pg1 (the JAX package, plain numpy here) packs and unpacks the same points.
Tolerance: exact equality.
"""
from __future__ import annotations

import random
import re

import numpy as np
import pytest
import torch

from lachain_tpu.ops import pg1
from lachain_tpu_torch.crypto import bls12381 as bls
from lachain_tpu_torch.ops import _build, g1, g1_ref, g2, glv

pytestmark = pytest.mark.kernel

torch.set_num_threads(1)

P = bls.P
R = 1 << 384
R_INV = pow(R, -1, P)
EDGE = [0, 1, P - 1, P, R - 1]  # the last two only below 2^384, not below p


def _words(vals) -> torch.Tensor:
    return torch.from_numpy(g1._words(vals).view(np.int32))


def _ints(t) -> list:
    return g1._from_words(t.numpy().view(np.uint32))


@pytest.fixture
def card_layout(monkeypatch):
    """The card's word layout on CPU tensors: every marshal takes its card
    branch, and its conversions (CPU tensors) take the plain version."""
    monkeypatch.setattr(g1, "_cpu_layout", lambda _device: False)
    monkeypatch.setattr(g2, "_cpu_layout", lambda _device: False)
    g1.reset_launches()
    yield torch.device("cpu")
    assert all(v == 0 for v in g1.LAUNCHES.values())  # nothing launched


@pytest.mark.parametrize("factor", ["out", "into", "beta"])
def test_mont_mul_words_vs_ints(factor):
    """x * k / R mod p, canonical, for x anywhere below 2^384 (a reduction
    out of form reads whatever the kernels stored)."""
    k = {"out": 1, "into": R * R % P, "beta": glv.BETA * R % P}[factor]
    rng = random.Random(0x6A0)
    vals = EDGE + [k * P for k in range(2, 10)] + [rng.randrange(R) for _ in range(40)]
    if factor != "out":  # a product's operands lie below p
        vals = [v % P for v in vals]
    got = _ints(g1_ref.mont_mul_words(_words(vals), k))
    assert got == [v * k * R_INV % P for v in vals]


@pytest.mark.parametrize("n", [1, 63, 65])
def test_mont_convert_plain_version(n):
    """Coordinates of a (12c, n) or (12c + 1, n) buffer both ways, a flag row
    copied bit for bit, x R mod p and x / R mod p on Python ints."""
    rng = random.Random(0x6A1 + n)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n)])[: 3 * n]
    flags = np.array([rng.randrange(-(1 << 31), 1 << 31) for _ in range(n)], np.int32)
    words = torch.cat([_words(vals[c * n : (c + 1) * n]) for c in range(3)])
    buf = torch.cat([words, torch.from_numpy(flags[None])])
    g1.reset_launches()
    into = g1.mont_convert(buf, into=True)
    assert _ints(into[:-1]) == [v * R % P for v in vals]
    assert np.array_equal(into[-1].numpy(), flags)
    assert torch.equal(g1.mont_convert(into, into=False), buf)
    assert torch.equal(g1.mont_convert(into[:-1], into=False), words)  # no flag row
    assert all(v == 0 for v in g1.LAUNCHES.values())
    with pytest.raises(ValueError):
        g1.mont_convert(buf[:-3], into=True)  # 34 rows: not 12c or 12c + 1
    with pytest.raises(ValueError):
        g1.mont_convert(buf[0], into=True)


def test_mul_beta_is_phi():
    """mul_beta on pg1's limbs (the CPU layout) is beta * x mod p, and
    phi(u) = (beta X, Y, Z) is lambda * u on G1."""
    rng = random.Random(0x6A2)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(5)]
    xs = [p[0] for p in pts]
    got = g1_ref.limbs_to_ints(g1.mul_beta(g1.fp_encode(xs, "cpu")).numpy())
    assert got == [glv.BETA * x % P for x in xs]
    for p, bx in zip(pts, got):
        assert bls.g1_eq((bx, p[1], p[2]), bls.g1_mul(p, glv.LAMBDA))


@pytest.mark.parametrize("n", [1, 63, 65])
def test_card_marshal_round_trips(card_layout, n):
    """fp_encode / fp_decode, g1_pack / g1_coords / fetch and g2_pack /
    g2_coords / fetch in the card's word layout against Python ints."""
    dev = card_layout
    rng = random.Random(0x6A3 + n)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(n)])[:n]
    enc = g1.fp_encode(vals, dev)
    assert enc.shape == (g1.NL, n) and enc.dtype == torch.int32
    assert _ints(enc) == [v * R % P for v in vals]
    assert g1.fp_decode(enc) == vals

    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(n)]
    pts[0] = bls.G1_INF
    packed = g1.g1_pack(pts, dev)
    assert packed.shape == (3 * g1.NL, n) and packed.is_contiguous()
    mapped = [(0, 1, 0) if p[2] == 0 else p for p in pts]
    want = [p[c] for c in range(3) for p in mapped]
    assert _ints(packed) == [v * R % P for v in want]
    assert g1.g1_coords(packed) == want
    flags = torch.zeros(n, dtype=torch.int32)
    flags[0] = 1
    rows, fl = g1.fetch(torch.cat([packed, flags[None]]))
    assert fl.tolist() == [True] + [False] * (n - 1)
    assert g1.g1_unpack_host(rows, fl, cpu_layout=False) == pts

    pts2 = [bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R)) for _ in range(min(n, 4))]
    pts2[0] = bls.G2_INF
    packed2 = g2.g2_pack(pts2, dev)
    assert packed2.shape == (g2.ROWS2, len(pts2)) and packed2.is_contiguous()
    comps = [(0, 0, 1, 0, 0, 0)] + [
        (x0, x1, y0, y1, z0, z1) for (x0, x1), (y0, y1), (z0, z1) in pts2[1:]]
    want2 = [c[j] for j in range(6) for c in comps]
    assert g2.g2_coords(packed2) == want2
    fl2 = torch.zeros(len(pts2), dtype=torch.int32)
    rows2, f2 = g1.fetch(torch.cat([packed2, fl2[None]]))  # (73, m): G2's fetch
    got2 = g2.g2_unpack_host(rows2, f2, cpu_layout=False)
    assert got2[0] == bls.G2_INF and got2[1:] == pts2[1:]


def test_packs_equal_pg1(card_layout):
    """The card's G1 pack holds the values pg1's pack holds: pg1.g1_unpack
    of pg1.g1_pack and g1_coords of g1.g1_pack give the same coordinates."""
    rng = random.Random(0x6A4)
    pts = [bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R)) for _ in range(7)]
    pts.append(bls.G1_INF)
    want = pg1.g1_unpack(pg1.g1_pack(pts))
    got = g1.g1_coords(g1.g1_pack(pts, card_layout))
    n = len(pts)
    got_pts = [bls.G1_INF if got[2 * n + i] == 0 else
               (got[i], got[n + i], got[2 * n + i]) for i in range(n)]
    assert got_pts == want


def _constant(source: str, name: str) -> int:
    """A word constant of a csrc bank, as an int."""
    text = (_build.CSRC / source).read_text()
    body = re.search(rf"__constant__ uint32_t {name}\[NL\] = \{{([^}}]*)\}}", text)[1]
    words = [int(w.strip().rstrip("u"), 0) for w in body.split(",")]
    assert len(words) == g1.NL
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_card_constants():
    assert _constant("fp.cuh", "kR2") == R * R % P
    assert _constant("g1.cu", "kBetaR") == glv.BETA * R % P
    assert _constant("fp.cuh", "kP") == P
