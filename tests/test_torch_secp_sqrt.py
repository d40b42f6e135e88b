"""The secp256k1 square root's addition chain, the unpadded batch around it
and the card's Montgomery conversions, on the CPU.

The card's `sqrt` runs `secp.SQRT_CHAIN` (libsecp256k1's chain for
(p+1)/4) where psecp walks the exponent's bits; a Python-int run of the
chain must give psecp's `sqrt_kernel` output (plain jit on the CPU) and
`pow(y2, (p+1)/4, p)` on seeded x, edge and non-residue x included, with
253 squarings and 13 products. `GpuEcdsaRecover(device="cpu")` launches
its square root over exactly the batch (no padding to a power of two) and
must equal the JAX package's `recover_hash` at batch sizes that are not
powers of two. The plain words the card's `sqrt` takes and gives
round-trip through `_words` / `_from_words`, and `mont_convert`'s plain
version equals Python ints. psecp's `TpuEcdsaRecover` cannot run here (its
64-window scan blows up XLA-CPU, tests/test_psecp.py), and a 4097-lane
plain square root takes about a minute on one core: the 4097-signature
recovery runs on the card (tests/test_torch_cuda.py). Tolerance: exact
equality.
"""
from __future__ import annotations

import random
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lachain_tpu.crypto import ecdsa as jecdsa
from lachain_tpu.ops import psecp
from lachain_tpu_torch.crypto import ecdsa
from lachain_tpu_torch.ops import _build, secp, secp_ref

# one intra-op thread: parallel test workers must not oversubscribe the cores
torch.set_num_threads(1)

P = ecdsa.P
R = 1 << 256


def chain(y2: int):
    """secp.SQRT_CHAIN on Python ints from y2 -> (value, exponent,
    squarings, products): step (s, k) squares s times, then multiplies by
    x_k = y2^(2^k - 1), which an earlier step made."""
    xs = {1: y2}
    cur, e, squarings, products = y2, 1, 0, 0
    for s, k in secp.SQRT_CHAIN:
        for _ in range(s):
            cur = cur * cur % P
        squarings += s
        e <<= s
        if k is not None:
            cur = cur * xs[k] % P
            e += (1 << k) - 1
            products += 1
        if e & (e + 1) == 0:  # cur = y2^(2^b - 1): x_b
            xs[e.bit_length()] = cur
    return cur, e, squarings, products


def _non_residues(rng, count: int) -> list:
    out = []
    while len(out) < count:
        x = rng.randrange(P)
        if pow((x**3 + 7) % P, (P - 1) // 2, P) == P - 1:
            out.append(x)
    return out


def test_chain_counts_and_exponent():
    _, e, squarings, products = chain(3)
    assert e == (P + 1) // 4
    assert (squarings, products, len(secp.SQRT_CHAIN)) == (253, 13, 14)
    # psecp: one square per exponent bit below the top one, one product
    # per set bit among them
    assert len(secp_ref.SQRT_STEPS) + sum(secp_ref.SQRT_STEPS) == 499


def test_chain_equals_pow_and_psecp():
    rng = random.Random(0x5021)
    xs = [0, 1, P - 1, ecdsa.GX] + _non_residues(rng, 4)
    xs += [rng.randrange(P) for _ in range(8)]
    got = [chain((x**3 + 7) % P)[0] for x in xs]
    assert got == [pow((x**3 + 7) % P, (P + 1) // 4, P) for x in xs]
    lx = psecp.limbs_from_ints(xs).T
    want = np.asarray(psecp.sqrt_kernel_jit(jnp.asarray(lx.astype(np.int32)),
                                            jnp.asarray(psecp._SQRT_BITS)))
    assert got == secp_ref.limbs_to_ints(want)
    assert got[3] in (ecdsa.GY, P - ecdsa.GY)
    for x, y in zip(xs[4:8], got[4:8]):  # non-residues: the y^2 check fails
        assert y * y % P != (x**3 + 7) % P


def _signed(rng, n: int):
    keys = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(4)]
    hashes = [rng.randbytes(32) for _ in range(n)]
    sigs = [ecdsa._sign_hash_py(keys[i % 4], h) for i, h in enumerate(hashes)]
    return keys, hashes, sigs


@pytest.mark.parametrize("n", [1, 63, 65])
def test_recover_batch_unpadded_equals_recover_hash(n, monkeypatch):
    """n valid signatures: the square root computes n lanes, and every
    answer is its signer's key and equals the JAX package's recover_hash
    (which the port's equals, tests/test_torch_ecdsa.py)."""
    keys, hashes, sigs = _signed(random.Random(0x5022 + n), n)
    lanes = []
    real = secp.sqrt

    def counted(x):
        lanes.append(x.shape[-1])
        return real(x)

    monkeypatch.setattr(secp, "sqrt", counted)
    secp.reset_launches()
    got = secp.GpuEcdsaRecover(device="cpu").recover_batch(hashes, sigs)
    assert lanes == [n]
    assert all(v == 0 for v in secp.LAUNCHES.values())
    pubs = [ecdsa.public_key_bytes(k) for k in keys]
    assert got == [pubs[i % 4] for i in range(n)]
    assert got == [jecdsa.recover_hash(h, s) for h, s in zip(hashes, sigs)]


@pytest.mark.parametrize("n", [1, 63, 65, 4097])
def test_word_marshal_round_trips(n):
    """The plain words `sqrt` takes and gives, one coordinate or a point's
    three (X... | Y... | Z...), and the card's unpack of fetched rows."""
    rng = random.Random(0x5023 + n)
    vals = [0, P - 1, (1 << 256) - 1][:n] + [rng.randrange(P) for _ in range(n - 3)]
    words = secp._words(vals)
    assert words.shape == (secp.NL, n) and words.dtype == np.uint32
    assert secp._from_words(words) == vals
    pts = [(rng.randrange(P), rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    rows = np.concatenate([secp._words([p[c] for p in pts]) for c in range(3)])
    assert secp._from_words(rows) == [p[c] for c in range(3) for p in pts]
    flags = np.zeros(n, dtype=bool)
    flags[0] = True
    got = secp.pt_unpack_host(rows.view(np.int32), flags, cpu_layout=False)
    assert got == [None] + [p if p[2] else None for p in pts[1:]]


@pytest.mark.parametrize("n", [1, 63, 65])
def test_mont_convert_plain_version(n):
    """mont_convert on a CPU tensor: the plain version, in the card's word
    layout, equals x R mod p and x / R mod p on Python ints, with 0, 1 and
    p - 1 among the values, and copies a flag row bit for bit."""
    rng = random.Random(0x5024 + n)
    vals = ([0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n)])[: 3 * n]
    flags = np.array([rng.randrange(-(1 << 31), 1 << 31) for _ in range(n)], np.int32)
    words = np.concatenate([secp._words(vals[c * n : (c + 1) * n]) for c in range(3)])
    buf = torch.from_numpy(np.concatenate([words.view(np.int32), flags[None]]))
    secp.reset_launches()
    into = secp.mont_convert(buf, into=True)
    assert secp._from_words(into[:-1].numpy().view(np.uint32)) == [v * R % P for v in vals]
    assert np.array_equal(into[-1].numpy(), flags)
    back = secp.mont_convert(into, into=False)
    assert torch.equal(back, buf)
    one = secp.mont_convert(buf[: secp.NL], into=False)
    assert secp._from_words(one.numpy().view(np.uint32)) == [
        v * pow(R, -1, P) % P for v in vals[:n]]
    assert all(v == 0 for v in secp.LAUNCHES.values())
    with pytest.raises(ValueError):
        secp.mont_convert(buf[:-3], into=True)  # 22 rows: not 8c or 8c + 1


def _constant(name: str) -> int:
    """A word constant of csrc/secp.cu's bank, as an int."""
    text = (_build.CSRC / "secp.cu").read_text()
    body = re.search(rf"__constant__ uint32_t {name}\[NL\] = \{{([^}}]*)\}}", text)[1]
    words = [int(w.strip().rstrip("u"), 0) for w in body.split(",")]
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_card_constants():
    """The constants the card's conversions and y2 read: R^2 mod p (into
    Montgomery form) and 7 R mod p."""
    assert _constant("kR2") == secp._R2 == R * R % P
    assert _constant("kSevenR") == 7 * R % P
