"""Plain PyTorch versions of the Reed-Solomon matrix product (`csrc/rs.cu`).

`gf_matmul` is `GF.matmul`'s j-loop (`lachain_tpu/ops/rs_batch.py:79-101`)
in torch: int64 gathers of the exp/log tables, `where` for the zero masks
and `bitwise_xor` over the contraction axis. `gf_matmul_grouped` is the
function one `rs_matmul8` / `rs_matmul16` launch computes: each group's A
into its own run of B's columns. The CPU tests and `chip_smoke.py`'s
kernel check use them; `ops/rs_batch.rs_matmul` runs them only for
tensors that lie on the CPU.

Symbols are uint8 (GF(2^8)) or uint16 (GF(2^16)) tensors. Both compute in
integers and convert at the boundary; uint16 crosses as an int16 view,
since torch has few operations on uint16.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _ints(t):
    """Symbols as int64."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def _symbols(x, dtype):
    """int32 values below 2^bits as symbols of `dtype`."""
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def _product(exp, log, a, b):
    """a (r, k) @ b (k, c) over the field of exp (2 * order,) and log
    (2^bits,), int32 tables; symbols in, int32 out."""
    r, k = a.shape
    ai, bi = _ints(a), _ints(b)
    log_a, mask_a = log[ai].long(), ai != 0
    log_b, mask_b = log[bi].long(), bi != 0
    out = torch.zeros((r, b.shape[1]), dtype=torch.int32, device=b.device)
    for j in range(k):
        prod = exp[log_a[:, j, None] + log_b[j][None, :]]
        out.bitwise_xor_(torch.where(mask_a[:, j, None] & mask_b[j][None, :], prod, 0))
    return out


def gf_matmul(exp, log, a, b):
    """a (r, k) @ b (k, c) over GF(2^bits): exp (2 * order,) and log
    (2^bits,) int32 tables of the field; symbols in, symbols out."""
    return _symbols(_product(exp, log, a, b), b.dtype)


def gf_matmul_grouped(exp, log, mats: Sequence, b, widths: Sequence[int]):
    """One launch's function: group g's A (rows_g, k_g) times the next
    widths[g] columns of b (K, C), rows past k_g unread; the result is (R,
    C), R the largest rows_g, rows past a group's own rows 0."""
    rows = max((m.shape[0] for m in mats), default=0)
    out = torch.zeros((rows, b.shape[1]), dtype=torch.int32, device=b.device)
    off = 0
    for m, w in zip(mats, widths):
        out[: m.shape[0], off : off + w] = _product(
            exp, log, m, b[: m.shape[1], off : off + w])
        off += w
    return _symbols(out, b.dtype)
