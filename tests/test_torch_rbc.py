"""The port's era RBC flush batcher against the JAX package's.

`lachain_tpu_torch.consensus.rbc_batcher.RbcEraBatcher(device="cpu")` and
`lachain_tpu.consensus.rbc_batcher.RbcEraBatcher` take the same seeded
submissions (the node's own encode, one interpolation per slot with its
own erasures, repeats of a root, an equivocating slot, a slot with mixed
shard sizes, later eras) and must give the same callbacks in the same
order, the same memo hits and dedupes, and the same era pruning, at N=16
(GF(2^8)) and at n=260 (GF(2^16)). Every verdict equals `scalar_verdict`.
A failing kernel wrapper or hash library raises out of `flush`; no card
with `device="cuda"` raises.
"""
from __future__ import annotations

import random

import pytest
import torch

from lachain_tpu.consensus import rbc_batcher as jrbc
from lachain_tpu.crypto import hashes as jhashes
from lachain_tpu.ops import rs_batch as jrb
from lachain_tpu.utils import metrics
from lachain_tpu_torch.consensus import rbc_batcher
from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher, scalar_verdict
from lachain_tpu_torch.crypto import hashes
from lachain_tpu_torch.ops import rs_batch

torch.set_num_threads(1)

pytestmark = pytest.mark.kernel


def _root(shards):
    return jhashes.merkle_root(jhashes.keccak256_batch(shards))


def make_era(n: int, slots: int, size: int, seed: int):
    """(k, own payload, [(shards with erasures, root)]): `slots` honest
    slots each losing a seeded 0..n-k shards, then an equivocating slot
    (shards of two polynomials under one root) and a slot whose first
    shard has another size."""
    rng = random.Random(seed)
    k = n - 2 * ((n - 1) // 3)
    own = rng.randbytes(size)
    out = []
    for _ in range(slots):
        shards = jrb.encode(rng.randbytes(size), k, n)
        erased = list(shards)
        for i in rng.sample(range(n), rng.randint(0, n - k)):
            erased[i] = None
        out.append((erased, _root(shards)))
    mixed = list(jrb.encode(rng.randbytes(size), k, n))
    mixed[rng.randrange(k)] = jrb.encode(rng.randbytes(size), k, n)[rng.randrange(n)]
    out.append((mixed, _root(mixed)))
    sized = list(jrb.encode(rng.randbytes(size), k, n))
    sized[0] = sized[0] + b"\x00\x00"
    out.append((sized, _root(sized)))
    return k, own, out


def drive(batcher, n, k, own, era, log):
    """The same submissions and flushes for either package's batcher, over
    (shards, k, n, root) slots: era 0's own encode and every slot, a
    repeat of slot 0 (deduped), then a memo hit; era 1; era 3, which drops
    era 0's memo, so that slot 0 computes again."""
    def cb(tag):
        return lambda v: log.append((tag, v))

    batcher.submit_encode(0, own, k, n, cb("enc0"))
    for s, slot in enumerate(era):
        batcher.submit_interpolate(0, *slot, cb(f"s{s}"))
    batcher.submit_interpolate(0, *era[0], cb("dup0"))
    log.append(("flushed", batcher.flush()))
    batcher.submit_interpolate(0, *era[0], cb("memo0"))
    log.append(("empty", batcher.flush(0)))
    batcher.submit_encode(1, own[::-1], k, n, cb("enc1"))
    batcher.submit_interpolate(1, *era[1], cb("e1s1"))
    log.append(("flushed1", batcher.flush(1)))
    batcher.submit_interpolate(3, *era[2], cb("e3s2"))
    batcher.submit_interpolate(3, *era[2], cb("e3s2b"))
    log.append(("flushed3", batcher.flush()))
    batcher.submit_interpolate(0, *era[0], cb("after_prune"))
    log.append(("pending", batcher.pending))
    log.append(("flushed_again", batcher.flush()))
    return batcher


@pytest.mark.parametrize("n,slots,size", [(16, 16, 300), (260, 4, 40)])
def test_batcher_equals_reference(n, slots, size):
    k, own, era = make_era(n, slots, size, seed=n)
    era = [(shards, k, n, root) for shards, root in era]
    want, got = [], []
    hits0 = metrics.counter_value("rbc_flush_memo_hits_total")
    dedup0 = metrics.counter_value("rbc_flush_deduped_total")
    ref = drive(jrbc.RbcEraBatcher(), n, k, own, era, want)
    port = drive(RbcEraBatcher(device="cpu"), n, k, own, era, got)
    assert got == want
    assert port.flushes == ref.flushes == 4
    assert port.memo_hits == metrics.counter_value("rbc_flush_memo_hits_total") - hits0 == 1
    assert port.deduped == metrics.counter_value("rbc_flush_deduped_total") - dedup0 == 2
    verdicts = {tag: v for tag, v in got}
    for s, (shards, _k, _n, root) in enumerate(era):
        assert verdicts[f"s{s}"] == scalar_verdict(shards, k, root)
    assert verdicts[f"s{slots}"] is None and verdicts[f"s{slots + 1}"] is None
    assert all(verdicts[f"s{s}"] is not None for s in range(slots))
    assert ("pending", 1) in got  # the pruned memo answers no more
    assert set(port.last_timings) == set(rbc_batcher.PHASES) | {"wall_s"}


def test_failing_kernel_or_hash_raises_out_of_flush(monkeypatch):
    """No scalar fallback: a product or hash failure raises out of flush."""
    k, own, era = make_era(16, 2, 50, seed=1)

    def boom(*_args, **_kw):
        raise RuntimeError("rs_matmul8: kernel launch failed")

    for target, name in ((rs_batch, "rs_matmul"), (hashes, "keccak256_batch")):
        with monkeypatch.context() as m:
            m.setattr(target, name, boom)
            m.setattr(rbc_batcher, "scalar_verdict", boom)
            b = RbcEraBatcher(device="cpu")
            b.submit_interpolate(0, era[0][0], k, 16, era[0][1], lambda v: None)
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                b.flush()
    b = RbcEraBatcher(device="cpu")
    b.submit_encode(0, own, k, 16, lambda v: None)
    monkeypatch.setattr(rs_batch, "rs_matmul", boom)
    with pytest.raises(RuntimeError):
        b.flush()


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError):
        RbcEraBatcher()
    with pytest.raises(RuntimeError):
        rs_batch.encode_batch([(b"x", 1, 2)])
    with pytest.raises(RuntimeError):
        rs_batch.decode_batch([([b"x", None], 1)])
