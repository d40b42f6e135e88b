"""The port's Reed-Solomon column shards against the JAX package, bit for bit.

`rs_batch.encode_batch` / `decode_batch(..., mesh=make_mesh(["cpu"] * n))`
for n in {2, 4}: every group's columns are cut into n contiguous blocks and
each device runs one product over its blocks, the blocks joined in column
order. The shards and payloads must equal the JAX package's `rs_batch`
host path and the unsharded port (`device="cpu"`), in both fields, with
mixed (k, n) groups, column counts that no shard count divides and fewer
columns than shards (a device with no columns launches nothing). An
`RbcEraBatcher(device="cpu", mesh=...)` flush gives the JAX batcher's
callbacks, and every verdict equals `scalar_verdict`.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from lachain_tpu.consensus import rbc_batcher as jrbc
from lachain_tpu.ops import rs_batch as jrb
from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher, scalar_verdict
from lachain_tpu_torch.ops import rs_batch
from lachain_tpu_torch.parallel.mesh import make_mesh

from test_torch_rbc import drive, make_era

pytestmark = pytest.mark.mesh

torch.set_num_threads(1)


def _erase(shards, rng):
    out = list(shards)
    k = len(shards) - 2 * ((len(shards) - 1) // 3)
    for i in rng.sample(range(len(out)), rng.randint(0, len(out) - k)):
        out[i] = None
    return out, k


# (k, n, payload bytes): a shard of 1 column (1 or 2 bytes); 3 and 5 columns
# (fewer than 4 shards, and no multiple of 2 or 4); 131 columns
ITEMS = [(2, 4, 0), (3, 7, 1), (3, 7, 8), (22, 64, 100), (22, 64, 2871),
         (2, 4, 17), (86, 256, 5), (86, 256, 699), (3, 300, 40)]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_codec_equals_reference(n_shards):
    rng = random.Random(n_shards)
    items = [(rng.randbytes(size), k, n) for k, n, size in ITEMS]
    mesh = make_mesh(["cpu"] * n_shards)
    want = jrb.encode_batch(items)
    assert rs_batch.encode_batch(items, device="cpu") == want
    timings: dict = {}
    assert rs_batch.encode_batch(items, device="cpu", mesh=mesh, timings=timings) == want
    assert {"pack_s", "device_s", "fetch_s"} <= set(timings)
    decodes = []
    for (data, k, n), shards in zip(items, want):
        erased, _k = _erase(shards, rng)
        decodes.append((erased, k))
    decodes.append((decodes[3][0][:1] + [None] * 63, 22))  # too few shards
    expect = jrb.decode_batch(decodes)
    assert expect[:-1] == [data for data, _k, _n in items] and expect[-1] is None
    assert rs_batch.decode_batch(decodes, device="cpu") == expect
    assert rs_batch.decode_batch(decodes, device="cpu", mesh=mesh) == expect


@pytest.mark.parametrize("widths,n", [([1], 4), ([3, 5], 4), ([131, 1, 0, 7], 2),
                                      ([2, 2], 3)])
def test_column_shards_cut_each_group_in_order(widths, n, monkeypatch):
    """Each group's columns in n contiguous blocks, block i of a run of w
    the columns w * i // n .. w * (i + 1) // n (widths that differ by at
    most one): one product a device that holds a column, over its blocks
    of every group, joined in column order to the one-device product and
    GF.matmul's."""
    calls = []
    real = rs_batch.rs_matmul

    def counting(bits, mats, b, ws):
        calls.append(list(ws))
        return real(bits, mats, b, ws)

    monkeypatch.setattr(rs_batch, "rs_matmul", counting)
    field = rs_batch._field(8)
    rng = np.random.default_rng(len(widths) * 10 + n)
    groups = [((8, "column shards", tuple(widths), g),
               rng.integers(0, 256, (5, 3), dtype=np.uint8),
               [rng.integers(0, 256, (3, w - w // 2), dtype=np.uint8),
                rng.integers(0, 256, (3, w // 2), dtype=np.uint8)])
              for g, w in enumerate(widths)]
    got = rs_batch._products(field, groups, [torch.device("cpu")] * n, None)
    want = [[w * (i + 1) // n - w * i // n for w in widths if w * (i + 1) // n > w * i // n]
            for i in range(n)]
    assert calls == [ws for ws in want if ws]
    for ws in zip(*([w * (i + 1) // n - w * i // n for w in widths] for i in range(n))):
        assert max(ws) - min(ws) <= 1
    one = rs_batch._products(field, groups, [torch.device("cpu")], None)
    ref = rs_batch._products(field, groups, None, None)
    for g, w in enumerate(widths):
        assert got[g].shape == (5, w) and got[g].dtype == field.be_dtype
        assert np.array_equal(got[g], one[g]) and np.array_equal(got[g], ref[g])


def test_empty_shards_launch_nothing(monkeypatch):
    """Three columns over 4 shards: three products, one on each device that
    holds a column; the blocks join to the unsharded product."""
    calls = []
    real = rs_batch.rs_matmul

    def counting(bits, mats, b, widths):
        calls.append((bits, b.shape[1], list(widths)))
        return real(bits, mats, b, widths)

    monkeypatch.setattr(rs_batch, "rs_matmul", counting)
    items = [(bytes(range(5)), 3, 7)]  # a 4-byte prefix + 5 bytes over k = 3: 3 columns
    want = rs_batch.encode_batch(items, device="numpy")
    calls.clear()
    assert rs_batch.encode_batch(items, device="cpu", mesh=make_mesh(["cpu"] * 4)) == want
    assert calls == [(8, 1, [1])] * 3


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("n,slots,size", [(16, 16, 300), (260, 3, 40)])
def test_sharded_batcher_equals_reference(n_shards, n, slots, size):
    k, own, era = make_era(n, slots, size, seed=n + n_shards)
    era = [(shards, k, n, root) for shards, root in era]
    want, got, plain = [], [], []
    drive(jrbc.RbcEraBatcher(), n, k, own, era, want)
    port = drive(RbcEraBatcher(device="cpu", mesh=make_mesh(["cpu"] * n_shards)),
                 n, k, own, era, got)
    drive(RbcEraBatcher(device="cpu"), n, k, own, era, plain)
    assert got == want == plain
    assert port.mesh.shape == {"shares": n_shards}
    verdicts = {tag: v for tag, v in got}
    for s, (shards, _k, _n, root) in enumerate(era):
        assert verdicts[f"s{s}"] == scalar_verdict(shards, k, root)
