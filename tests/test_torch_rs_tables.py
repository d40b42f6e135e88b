"""The Reed-Solomon kernels' forms of A and their plain products against
the JAX package, on the CPU.

`rs_batch.operand` puts a matrix A into the form `csrc/rs.cu` takes:
GF(2^8) nibble tables (`rs_ref.nibble_tables`), GF(2^16) log(A) with
0xFFFF at a zero (`rs_ref.log_matrix`). The tables and log(A) against the
reference's `field.log[a]` / `a != 0` and `GF.mul`, coefficient by
coefficient; the plain products on those forms (`rs_ref.nibble_matmul`,
the kernel's model `rs_ref.nibble_matmul_words`, which writes out its
`prmt` selection over 4-column words, and `rs_ref.log_matmul`) against
the JAX package's `GF.matmul` and its jitted `_device_jit(bits)` (`_mm`,
on JAX's CPU backend), with zeros in A and B, k_g < K, rows_g < R, an
empty group, widths that are not multiples of 4 and mixed groups in one
call; the wrapper's cut of a launch into items
(a Python walk of the kernel's item decode: every output once, every SM
reached at the N=256 flush's decode and re-encode); `clear_caches()`; and
an RBC flush on `device="cpu"` against the numpy oracle and the JAX
package's codec. Seeded numpy inputs go to both packages.
"""
from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lachain_tpu.ops import rs_batch as jrb
from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher, scalar_verdict
from lachain_tpu_torch.crypto import hashes
from lachain_tpu_torch.ops import rs_batch, rs_ref

torch.set_num_threads(1)

pytestmark = pytest.mark.kernel

SMS = 132  # an H100's SMs


def _fields(bits):
    return (rs_batch.GF8, jrb.GF8) if bits == 8 else (rs_batch.gf16(), jrb.gf16())


def _symbols(rng, field, shape, zero_frac=0.2):
    m = rng.integers(1, field.order + 1, size=shape).astype(field.dtype)
    m[rng.random(shape) < zero_frac] = 0
    return m


def _plain(bits, form, b, words=False):
    """The plain product of one group on the CPU (GF(2^8): the kernel's
    model over 4-column words when `words`)."""
    if bits == 8:
        product = rs_ref.nibble_matmul_words if words else rs_ref.nibble_matmul
        return product(torch.from_numpy(form), torch.from_numpy(b)).numpy()
    exp, log = (torch.from_numpy(t.astype(np.int64)) for t in rs_ref.log16_tables(_fields(16)[0]))
    out = rs_ref.log_matmul(exp, log, torch.from_numpy(form), torch.from_numpy(b))
    return out.numpy()


# -- the forms of A --------------------------------------------------------------


def test_nibble_tables_equal_gf_mul():
    """Every GF(2^8) coefficient's 32 bytes are c * x and c * (x << 4) for
    x < 16 by the reference's GF.mul; a zero coefficient's are zeros."""
    field, jfield = _fields(8)
    a = np.arange(256, dtype=np.uint8).reshape(16, 16)
    tabs = rs_ref.nibble_tables(field, a)
    assert tabs.shape == (16, 16, 32) and tabs.dtype == np.uint8
    for c in range(256):
        row = tabs[c // 16, c % 16]
        assert [int(v) for v in row[:16]] == [jfield.mul(c, x) for x in range(16)]
        assert [int(v) for v in row[16:]] == [jfield.mul(c, x << 4) for x in range(16)]
    np.testing.assert_array_equal(rs_batch.operand(8, a), tabs)


@pytest.mark.parametrize("seed", range(3))
def test_log_matrix_equals_reference_log_and_mask(seed):
    """log(A) is the reference's field.log[a] where a != 0 and 0xFFFF (no
    logarithm's value) where a == 0; exp of it gives a back."""
    field, jfield = _fields(16)
    rng = np.random.default_rng(seed)
    a = _symbols(rng, field, (40, 30), 0.3)
    a[0, :4] = [0, 1, 2, 0xFFFF]
    la = rs_batch.operand(16, a)
    assert la.dtype == np.uint16
    nz = a != 0
    np.testing.assert_array_equal(la[nz], jfield.log[a[nz]])
    assert (la[~nz] == rs_ref.SENTINEL).all() and (la[nz] < field.order).all()
    np.testing.assert_array_equal(jfield.exp[la[nz]], a[nz])
    for r, j in [(0, 1), (0, 2), (0, 3), (5, 7)]:
        if a[r, j]:
            assert jfield.mul(int(a[r, j]), 1) == int(jfield.exp[la[r, j]])


def test_log16_tables():
    """The GF(2^16) kernel's exp: the reference's 65,535 powers and a 0;
    its log: the reference's, 0xFFFF at 0."""
    field, jfield = _fields(16)
    exp, log = rs_ref.log16_tables(field)
    assert exp.shape == log.shape == (65536,)
    np.testing.assert_array_equal(exp[:65535], jfield.exp[:65535])
    assert exp[65535] == 0 and log[0] == rs_ref.SENTINEL
    np.testing.assert_array_equal(log[1:], jfield.log[1:])


# -- prmt and the nibble selection ---------------------------------------------------


def test_prmt_copy_and_sign_modes():
    x, y = 0x44332211, 0x88776655
    assert int(rs_ref.prmt(x, y, 0x3210)) == x
    assert int(rs_ref.prmt(x, y, 0x7654)) == y
    assert int(rs_ref.prmt(x, y, 0x0147)) == 0x11225588
    assert int(rs_ref.prmt(x, y, 0x6543)) == 0x77665544  # B's word at byte offset 3
    assert int(rs_ref.prmt(0x00FF8001, 0, 0xBA98)) == 0x00FFFF00  # top bits replicated
    assert int(rs_ref.prmt(x, y, 0xF8)) == 0x1111FF00


def test_nibble_selectors_select_each_bytes_nibbles():
    """For random words: selector nibble i holds byte i's low (high)
    nibble's low 3 bits, mask byte i is 0xFF where that nibble's bit 3 is
    set."""
    w = torch.from_numpy(np.random.default_rng(1).integers(0, 1 << 32, 500))
    lo_sel, hi_sel, lo_mask, hi_mask = rs_ref.nibble_selectors(w)
    for i in range(4):
        byte = (w >> (8 * i)) & 0xFF
        for sel, mask, nib in ((lo_sel, lo_mask, byte & 15), (hi_sel, hi_mask, byte >> 4)):
            assert torch.equal((sel >> (4 * i)) & 0xF, nib & 7)
            assert torch.equal((mask >> (8 * i)) & 0xFF, torch.where(nib >= 8, 0xFF, 0))


# -- the plain products against the JAX package ---------------------------------------


def _jax_mm(bits, a, b):
    """The JAX package's jitted `_mm` on its CPU backend."""
    jfield = _fields(bits)[1]
    fn = jrb._device_jit(bits)
    out = fn(jnp.asarray(jfield.exp), jnp.asarray(jfield.log[a]), jnp.asarray(a != 0),
             jnp.asarray(jfield.log[b]), jnp.asarray(b != 0))
    return np.asarray(out)


@pytest.mark.parametrize("bits,words", [(8, False), (8, True), (16, False)])
@pytest.mark.parametrize("shape", [(9, 7, 33), (4, 1, 1), (22, 22, 131), (3, 5, 6)])
def test_plain_product_equals_gf_matmul_and_jitted_mm(bits, words, shape):
    """One group, zeros in A and B (a zero row and column of A, a zero
    column of B), widths 1, 6, 33, 131 (not multiples of 4); GF(2^8) by
    the plain gather and by the kernel's word model."""
    field, jfield = _fields(bits)
    rng = np.random.default_rng(shape[2] + bits)
    r, k, c = shape
    a, b = _symbols(rng, field, (r, k)), _symbols(rng, field, (k, c))
    a[r // 2] = 0
    a[:, k // 2] = 0
    b[:, c // 2] = 0
    want = jfield.matmul(a, b)
    np.testing.assert_array_equal(_plain(bits, rs_batch.operand(bits, a), b, words), want)
    np.testing.assert_array_equal(_jax_mm(bits, a, b), want)


@pytest.mark.parametrize("bits", [8, 16])
def test_grouped_plain_product_equals_reference_per_group(bits):
    """One call of mixed groups through `rs_matmul` on the CPU: groups of
    their own k (k_g < K, B's rows past it noise), rows (rows_g < R: zero
    rows), an empty group, widths 1-7 and 131, a group of 0 rows."""
    field, jfield = _fields(bits)
    rng = np.random.default_rng(40 + bits)
    shapes = [(7, 5, 1), (22, 22, 131), (3, 2, 0), (9, 5, 3), (0, 4, 6), (1, 1, 7),
              (13, 9, 2)]
    kmax = max(k for _r, k, _c in shapes)
    mats = [_symbols(rng, field, (r, k)) for r, k, _c in shapes]
    b = _symbols(rng, field, (kmax, sum(c for *_x, c in shapes)))
    forms = [torch.from_numpy(rs_batch.operand(bits, m)) for m in mats]
    widths = [c for *_x, c in shapes]
    out = rs_batch.rs_matmul(bits, forms, torch.from_numpy(b), widths).numpy()
    assert out.shape == (22, b.shape[1])
    off = 0
    for m, w in zip(mats, widths):
        blk = b[: m.shape[1], off : off + w]
        np.testing.assert_array_equal(out[: m.shape[0], off : off + w], jfield.matmul(m, blk))
        if m.shape[0] and w:
            np.testing.assert_array_equal(out[: m.shape[0], off : off + w],
                                          _jax_mm(bits, m, blk))
        assert not out[m.shape[0] :, off : off + w].any()
        off += w


# -- the cut of a launch into items ---------------------------------------------------


def _walk(bits, widths, rows_g, R, tiles):
    """A Python walk of the kernel's items (`decode_item` in csrc/rs.cu):
    how many times each (row, column) of C is written, and the items."""
    mats = [torch.zeros((r, 1, 32) if bits == 8 else (r, 1),
                        dtype=torch.uint8 if bits == 8 else torch.uint16) for r in rows_g]
    host, items, _tiles = rs_batch.group_rows(bits, rs_batch.group_info(bits, mats), widths, R,
                                              tiles)
    host = np.asarray(host)
    rtile, ctile = tiles[:2]
    writes = np.zeros((R, sum(widths)), dtype=np.int64)
    firsts = host[:, 5]
    for item in range(items):
        g = int(np.searchsorted(firsts, item, side="right")) - 1
        cb, ce = int(host[g, 3]), int(host[g, 4])
        first, end = (cb // 4, (ce + 3) // 4) if bits == 8 else (cb, ce)
        ctiles = -(-(end - first) // ctile)
        local = item - int(firsts[g])
        rt, ct = divmod(local, ctiles)
        r0 = rt * rtile
        nrows = min(rtile, R - r0)
        u0 = first + ct * ctile
        nu = min(ctile, end - u0)
        assert nrows > 0 and nu > 0
        for u in range(u0, u0 + nu):
            cols = range(max(4 * u, cb), min(4 * u + 4, ce)) if bits == 8 else [u]
            for c in cols:
                writes[r0 : r0 + nrows, c] += 1
    return writes, items


@pytest.mark.parametrize("bits,shapes,tiles", [
    (8, [(64, 131)], (64, 15)),
    (8, [(22, 131)] * 5 + [(7, 1), (7, 0), (30, 6)], (22, 3)),
    (8, [(5, 1), (3, 2), (9, 3), (4, 5)], (4, 1)),
    (16, [(86, 5)] * 7 + [(100, 3), (1, 0)], (64, 9)),
    (16, [(256, 37)], (128, 19)),
])
def test_items_write_every_output_once(bits, shapes, tiles):
    widths = [c for _r, c in shapes]
    R = max(r for r, _c in shapes)
    writes, _items = _walk(bits, widths, [r for r, _c in shapes], R, tiles)
    assert (writes == 1).all()


@pytest.mark.parametrize("bits,shapes,min_items", [
    (16, [(86, 5)] * 256, SMS),        # N=256: the decode of 256 erasure patterns
    (16, [(256, 1280)], SMS),          # N=256: the re-encode
    (8, [(64, 8384)], 131),            # N=64: the re-encode, 2096 words in 131 tiles of 16
    (8, [(64, 82624)], SMS),           # a 10,000-transaction block's re-encode
    (8, [(22, 131)] * 64, 128),        # N=64: the decode, 2 tiles of 17 words a group
    (16, [(256, 5)], 1),               # N=256: the own proposal's encode
])
def test_wrapper_tiles_reach_every_sm(bits, shapes, min_items):
    """`tiles_for` at the flush's launch shapes: a tile fits one block's
    threads, the stage holds all of k, and the launch has an item for each
    of the 132 SMs where its columns allow, with the kernel's geometry
    (rows a thread, columns a unit, threads a block, largest rtile, ctile
    and stage depth)."""
    geom = (4, 4, 256, 64, 256, 32) if bits == 8 else (1, 1, 1024, 128, 256, 96)
    widths = [c for _r, c in shapes]
    R = max(r for r, _c in shapes)
    k = 22 if bits == 8 else 86
    info = [(0, r, k) for r, _c in shapes]
    rtile, ctile, kd = rs_batch.group_rows(bits, info, widths, R, None, geom, SMS)[2]
    assert 1 <= rtile <= geom[3] and 1 <= ctile <= geom[4] and kd == k
    assert -(-rtile // geom[0]) * ctile <= geom[2]
    writes, items = _walk(bits, widths, [r for r, _c in shapes], R, (rtile, ctile))
    assert items >= min_items and (writes == 1).all()


# -- the caches and a flush ---------------------------------------------------------


def test_clear_caches_drops_the_forms():
    """A flush leaves each matrix's form in the device cache, keyed by
    (matrix key, device); clear_caches() drops them with the host caches."""
    rs_batch.clear_caches()
    rs_batch.encode_batch([(b"payload", 3, 7), (b"x" * 40, 2, 260)], device="cpu")
    keys = [k for k, _d in rs_batch._DEV_MATS]
    assert (8, 3, 7) in keys and (16, 2, 260) in keys
    form8 = rs_batch._DEV_MATS[((8, 3, 7), "cpu")]
    assert form8.shape == (7, 3, 32) and form8.dtype == torch.uint8
    np.testing.assert_array_equal(
        form8.numpy(), rs_ref.nibble_tables(rs_batch.GF8, rs_batch.vandermonde(rs_batch.GF8, 3, 7)))
    assert rs_batch._DEV_MATS[((16, 2, 260), "cpu")].dtype == torch.uint16
    rs_batch.clear_caches()
    assert not rs_batch._DEV_MATS and not rs_batch._VCACHE and not rs_batch._ICACHE


@pytest.mark.parametrize("n,size", [(16, 300), (260, 40)])
def test_cpu_flush_equals_numpy_oracle_and_reference(n, size):
    """An era's flush on device="cpu" (the plain products on the kernels'
    forms): the same encoded shards, payloads and verdicts as on the numpy
    oracle, the JAX package's encode and scalar_verdict."""
    rng = random.Random(n)
    k = n - 2 * ((n - 1) // 3)
    own = rng.randbytes(size)
    era = []
    for s in range(4):
        payload = rng.randbytes(size)
        shards = list(jrb.encode(payload, k, n))
        if s == 1:
            shards[0] = jrb.encode(rng.randbytes(size), k, n)[0]
        root = hashes.merkle_root(hashes.keccak256_batch(shards))
        for i in rng.sample(range(n), 0 if s == 1 else rng.randint(0, n - k)):
            shards[i] = None
        era.append((shards, root, payload))
    results = {}
    for device in ("cpu", "numpy"):
        rs_batch.clear_caches()
        batcher = RbcEraBatcher(device=device)
        enc, verdicts = [], {}
        batcher.submit_encode(0, own, k, n, enc.append)
        for s, (shards, root, _p) in enumerate(era):
            batcher.submit_interpolate(0, shards, k, n, root,
                                       lambda v, s=s: verdicts.__setitem__(s, v))
        batcher.flush()
        results[device] = (enc, verdicts)
    assert results["cpu"] == results["numpy"]
    enc, verdicts = results["cpu"]
    assert enc == [jrb.encode(own, k, n)]
    for s, (shards, root, payload) in enumerate(era):
        assert verdicts[s] == scalar_verdict(shards, k, root)
        assert verdicts[s] == (None if s == 1 else payload)
