"""The port's Reed-Solomon codec against the JAX package's, bit for bit.

`lachain_tpu_torch.ops.rs_batch` with `device="cpu"` (the plain PyTorch
version of the `rs_matmul` kernel) and with `device="numpy"` against
`lachain_tpu.ops.rs_batch` (its numpy path: JAX on the CPU) and
`lachain_tpu.ops.rs`, on seeded payloads: both fields, random erasures
from 0 to n - k, equivocating shards, mixed and odd shard sizes, empty
payloads, mixed (k, n) and mixed-field batches in one call (one product
per field). The plain products against `GF.matmul` per group, the
Vandermonde matrices and inverses, and the port's `keccak256_batch` and
`merkle_root` against the JAX package's. The kernel itself runs on the
card only (tests/test_torch_cuda.py, chip_smoke.py).
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.crypto import hashes as jhashes
from lachain_tpu.ops import rs as jrs
from lachain_tpu.ops import rs_batch as jrb
from lachain_tpu_torch.crypto import hashes
from lachain_tpu_torch.ops import rs, rs_batch, rs_ref

torch.set_num_threads(1)

pytestmark = pytest.mark.kernel


def _erase(shards, rng, lost):
    out = list(shards)
    for i in rng.sample(range(len(out)), lost):
        out[i] = None
    return out


def _kn(n):
    return n, max(n - 2 * ((n - 1) // 3), 1)


def _payload(rng, size):
    return bytes(rng.getrandbits(8) for _ in range(size))


@pytest.mark.parametrize("seed", range(24))
def test_gf8_encode_decode_equal_reference(seed):
    """Batch encode == the reference's batch and scalar encodes; decode
    under 0..n-k erasures == the reference's verdicts, on the plain
    version and the numpy oracle."""
    rng = random.Random(seed)
    n, k = _kn(rng.randint(4, 64))
    data = _payload(rng, rng.choice([0, 1, rng.randint(2, 400)]))
    want = jrs.encode(data, k, n)
    assert jrb.encode_batch([(data, k, n)])[0] == want
    for dev in ("cpu", "numpy"):
        assert rs_batch.encode_batch([(data, k, n)], device=dev)[0] == want
    assert rs.encode(data, k, n) == want
    shards = _erase(want, rng, rng.randint(0, n - k))
    for dev in ("cpu", "numpy"):
        assert rs_batch.decode(shards, k, device=dev) == data
    assert rs.decode(shards, k) == jrs.decode(shards, k) == data
    assert rs.reencode(shards, k) == jrs.reencode(shards, k)


@pytest.mark.parametrize("n,size", [(256, 0), (260, 37), (300, 700)])
def test_gf16_encode_decode_equal_reference(n, size):
    rng = random.Random(n + size)
    n, k = _kn(n)
    data = _payload(rng, size)
    want = jrb.encode(data, k, n)
    assert rs_batch.encode(data, k, n, device="cpu") == want
    assert rs.encode(data, k, n) == jrs.encode(data, k, n) == want
    shards = _erase(want, rng, rng.randint(0, n - k))
    assert rs_batch.decode(shards, k, device="cpu") == jrb.decode(shards, k) == data
    assert rs.decode(shards, k) == data


def test_bad_shards_equal_reference():
    """Equivocating shards (two polynomials), a mixed size among the first
    k, a mixed size past them (unchecked, as in the reference), an odd
    GF(2^16) size, too few shards and a bad length prefix: the same
    payload or None as the reference, per item of one batch."""
    rng = random.Random(5)
    items = []
    for n in (16, 40, 260):
        n, k = _kn(n)
        good, evil = _payload(rng, 64), _payload(rng, 64)
        shards = list(jrb.encode(good, k, n))
        wrong = jrb.encode(evil, k, n)
        mixed = list(shards)
        mixed[rng.randrange(k)] = wrong[rng.randrange(n)]
        items.append((mixed, k))
        short = list(shards)
        short[1] = short[1][:-2]
        items.append((short, k))
        late = list(shards)
        late[n - 1] = late[n - 1] + b"\x00\x00"
        items.append((late, k))
        items.append(([None] * (n - k + 1) + shards[n - k + 1 :], k))
        garbage = [bytes([0xFF]) * len(s) for s in shards]
        items.append((garbage, k))
    n, k = _kn(260)
    odd = [s + b"\x01" for s in jrb.encode(b"odd", k, n)]
    items.append((odd, k))
    want = jrb.decode_batch(items)
    assert want[2] is not None and want[3] is None  # late mixed size passes
    assert rs_batch.decode_batch(items, device="cpu") == want
    assert rs_batch.decode_batch(items, device="numpy") == want
    for shards, k in items:
        if len(shards) <= 255:
            assert rs.decode(shards, k) == jrs.decode(shards, k)


def test_mixed_batch_one_product_per_field(monkeypatch):
    """One call mixing (k, n) shapes, both fields and erasure patterns
    returns the reference's results in submission order, with one grouped
    product per field and call."""
    rng = random.Random(99)
    enc, dec = [], []
    for _ in range(16):
        n, k = _kn(rng.choice([4, 7, 16, 260]))
        data = _payload(rng, rng.randint(0, 150))
        enc.append((data, k, n))
        shards = jrb.encode(data, k, n)
        dec.append((_erase(shards, rng, rng.randint(0, n - k)), k))
    calls = []
    real = rs_batch.rs_matmul

    def counted(bits, mats, b, widths):
        calls.append((bits, len(mats), b.shape[1]))
        return real(bits, mats, b, widths)

    monkeypatch.setattr(rs_batch, "rs_matmul", counted)
    assert rs_batch.encode_batch(enc, device="cpu") == jrb.encode_batch(enc)
    assert sorted(c[0] for c in calls) == [8, 16]
    # the GF(2^8) product holds every (k, n) group of its field
    groups8 = {(k, n) for _d, k, n in enc if n <= 255}
    assert [c[1] for c in calls if c[0] == 8] == [len(groups8)]
    calls.clear()
    assert rs_batch.decode_batch(dec, device="cpu") == jrb.decode_batch(dec)
    assert sorted(c[0] for c in calls) == [8, 16]


def _matrices(rng, field, r, k, c, zero_frac):
    def sym(shape):
        m = rng.integers(1, field.order + 1, size=shape).astype(field.dtype)
        m[rng.random(shape) < zero_frac] = 0
        return m

    return sym((r, k)), sym((k, c))


@pytest.mark.parametrize("bits", [8, 16])
def test_plain_products_equal_gf_matmul(bits):
    """gf_matmul and the grouped form (groups of their own k and rows, a
    group of no columns, B's unread rows filled with noise) equal the
    JAX package's GF.matmul per group."""
    rng = np.random.default_rng(bits)
    jfield = jrb.GF8 if bits == 8 else jrb.gf16()
    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    exp = torch.from_numpy(field.exp.astype(np.int32))
    log = torch.from_numpy(field.log)
    a, b = _matrices(rng, field, 9, 7, 33, 0.2)
    got = rs_ref.gf_matmul(exp, log, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), jfield.matmul(a, b))
    shapes = [(5, 3, 11), (9, 7, 0), (2, 7, 20), (9, 4, 1)]
    pairs = [_matrices(rng, field, *s, 0.3) for s in shapes]
    big = np.concatenate([np.pad(bb, ((0, 7 - bb.shape[0]), (0, 0))) for _a, bb in pairs], axis=1)
    noise = rng.integers(1, field.order, size=big.shape).astype(field.dtype)
    for (_a, bb), lo in zip(pairs, np.cumsum([0] + [s[2] for s in shapes])):
        big[bb.shape[0] :, lo : lo + bb.shape[1]] = noise[bb.shape[0] :, lo : lo + bb.shape[1]]
    out = rs_batch.rs_matmul(bits, [torch.from_numpy(aa) for aa, _b in pairs],
                             torch.from_numpy(big), [s[2] for s in shapes]).numpy()
    assert out.shape == (9, big.shape[1])
    off = 0
    for (aa, bb), (r, _k, c) in zip(pairs, shapes):
        np.testing.assert_array_equal(out[:r, off : off + c], jfield.matmul(aa, bb))
        assert not out[r:, off : off + c].any()
        off += c


def test_rs_matmul_refuses_bad_operands():
    a = torch.zeros((3, 2), dtype=torch.uint8)
    b = torch.zeros((2, 5), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_batch.rs_matmul(8, [a], b.to(torch.int32), [5])
    with pytest.raises(ValueError):
        rs_batch.rs_matmul(16, [a], b, [5])  # GF(2^16) symbols are uint16
    with pytest.raises(ValueError):
        rs_batch.rs_matmul(8, [a], b, [4])
    with pytest.raises(ValueError):
        rs_batch.rs_matmul(8, [torch.zeros((3, 3), dtype=torch.uint8)], b, [5])


@pytest.mark.parametrize("bits,k,n", [(8, 5, 13), (8, 22, 64), (16, 4, 300)])
def test_vandermonde_and_inverse_equal_reference(bits, k, n):
    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    jfield = jrb.GF8 if bits == 8 else jrb.gf16()
    np.testing.assert_array_equal(rs_batch.vandermonde(field, k, n),
                                  jrb.vandermonde(jfield, k, n))
    xs = tuple(sorted(random.Random(n).sample(range(1, n + 1), k)))
    np.testing.assert_array_equal(rs_batch._inverse_for(field, k, xs),
                                  jrb._inverse_for(jfield, k, xs))
    np.testing.assert_array_equal(field.exp, jfield.exp)
    np.testing.assert_array_equal(field.log, jfield.log)


def test_keccak_batch_and_merkle_roots_equal_reference():
    rng = random.Random(3)
    items = [_payload(rng, rng.choice([0, 1, 32, 135, 136, 137, 300])) for _ in range(200)]
    assert hashes.keccak256_batch(items) == jhashes.keccak256_batch(items)
    assert hashes.keccak256_batch(items[:5], nthreads=1) == [jhashes.keccak256(d) for d in items[:5]]
    assert hashes.keccak256_batch([]) == []
    assert hashes.keccak256_batch([b"abc"])[0] == hashes.keccak256(b"abc")
    leaves = hashes.keccak256_batch(items)
    trees = [leaves[:m] for m in (0, 1, 2, 3, 5, 8, 13, 64, 65)]
    assert hashes.merkle_roots(trees) == [jhashes.merkle_root(t) for t in trees]
    for t in trees:
        assert hashes.merkle_root(t) == jhashes.merkle_root(t)
