"""Plain versions of the Reed-Solomon matrix product (`csrc/rs.cu`) and the
host functions that put a matrix A into the kernels' forms.

The kernels compute `GF.matmul` (`lachain_tpu/ops/rs_batch.py:79-101`)
through two other forms of A, made once per cached matrix on the host:

* GF(2^8): `nibble_tables(a)`, per coefficient c two 16-entry tables, c * x
  and c * (x << 4) for x < 16 (32 bytes). The product by c is linear over
  GF(2), so c * b = lo[b & 15] ^ hi[b >> 4] (Intel ISA-L's
  `ec_init_tables` / `gf_vect_mul`, GF-Complete's "SPLIT 8 4"). A zero
  coefficient's tables are zeros. `nibble_matmul`, the plain version,
  gathers lo[b & 15] ^ hi[b >> 4] symbol by symbol; `nibble_matmul_words`
  models the kernel's way: four columns of B as one 32-bit word, their
  nibbles selected with PTX `prmt` (written out in `prmt`).
* GF(2^16): `log_matrix(a)`, log(A) with 0xFFFF (no logarithm's value) for
  a zero coefficient; `log_matmul` adds log b (the device log table maps
  0 to 0xFFFF too), reduces the sum by one conditional subtraction of
  65,535 and XORs exp of it where neither log is 0xFFFF.

The `*_grouped` functions are what one `rs_matmul8` / `rs_matmul16` launch
computes: each group's A into its own run of B's columns.
`ops/rs_batch.rs_matmul` runs them for tensors that lie on the CPU; the
CPU tests and `chip_smoke.py`'s kernel check hold the kernels to them.

Symbols are uint8 (GF(2^8)) or uint16 (GF(2^16)) tensors; the products
compute in int64 and convert at the boundary (uint16 crosses as an int16
view, since torch has few operations on uint16).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

SENTINEL = 0xFFFF  # log(A) and the device log table at a zero symbol
ORDER16 = 0xFFFF
WORD = 4  # GF(2^8) columns a 32-bit word holds


# -- host: the kernels' forms of a matrix ------------------------------------


def nibble_tables(field, a: np.ndarray) -> np.ndarray:
    """(rows, k) GF(2^8) symbols -> (rows, k, 32) uint8: per coefficient c,
    c * x for x < 16, then c * (x << 4) for x < 16."""
    xs = np.concatenate([np.arange(16), np.arange(16) << 4])
    a = np.asarray(a)
    prod = field.exp[field.log[a][..., None] + field.log[xs]]
    return np.where((a != 0)[..., None] & (xs != 0), prod, 0).astype(np.uint8)


def log_matrix(field, a: np.ndarray) -> np.ndarray:
    """(rows, k) GF(2^16) symbols -> log(A) as uint16, SENTINEL at a 0."""
    a = np.asarray(a)
    return np.where(a != 0, field.log[a], SENTINEL).astype(np.uint16)


def log16_tables(field):
    """The GF(2^16) kernel's tables as numpy uint16: exp of 65,536 entries
    (65,535 powers and a 0, so that every index the sum can reach after its
    one subtraction lies inside), log with SENTINEL at 0."""
    exp = np.zeros(ORDER16 + 1, dtype=np.uint16)
    exp[:ORDER16] = field.exp[:ORDER16]
    log = field.log.astype(np.uint16)
    log[0] = SENTINEL
    return exp, log


# -- PTX prmt ----------------------------------------------------------------


def prmt(x, y, sel):
    """PTX `prmt.b32 d, x, y, sel` in its default mode, on int64 tensors (or
    ints) of 32-bit values: byte i of d is byte (sel >> 4i) & 7 of the 8
    bytes y:x, or, where bit 3 of that selector nibble is set, that byte's
    top bit copied into all 8 bits."""
    dev = next((v.device for v in (x, y, sel) if isinstance(v, torch.Tensor)), None)
    x, y, sel = (torch.as_tensor(v, dtype=torch.int64, device=dev) for v in (x, y, sel))
    src = (x & 0xFFFFFFFF) | ((y & 0xFFFFFFFF) << 32)
    out = torch.zeros(torch.broadcast_shapes(src.shape, sel.shape), dtype=torch.int64,
                      device=dev)
    for i in range(4):
        s = (sel >> (4 * i)) & 0xF
        byte = (src >> (8 * (s & 7))) & 0xFF
        byte = torch.where((s & 8) != 0, ((byte >> 7) & 1) * 0xFF, byte)
        out |= byte << (8 * i)
    return out


def nibble_selectors(w):
    """Words of four columns -> (lo selector, hi selector, lo mask, hi
    mask), as the kernel makes them once per j: the selectors hold byte i's
    nibble's low 3 bits in nibble i (prmt reads nibbles 0-3, bit 3 clear:
    copy), the masks are 0xFF in byte i where that nibble's top bit is set
    (prmt's sign mode)."""
    t = w & 0x07070707
    lo_sel = prmt(t | (t >> 4), 0, 0x4420)
    t = (w >> 4) & 0x07070707
    hi_sel = prmt(t | (t >> 4), 0, 0x4420)
    lo_mask = prmt((w << 4) & 0xFFFFFFFF, 0, 0xBA98)
    hi_mask = prmt(w, 0, 0xBA98)
    return lo_sel, hi_sel, lo_mask, hi_mask


_SHIFTS = (0, 8, 16, 24)


def _bytes(w):
    """(n,) words -> (n, 4) uint8, byte i of each word in column i."""
    return torch.stack([(w >> s) & 0xFF for s in _SHIFTS], -1).to(torch.uint8)


def _lookup(src8, sel):
    """prmt of copy-mode selectors `sel` (n,) words over the 8 table bytes
    src8 (rows, 8) uint8 of every row at once -> (rows, n, 4) uint8."""
    nib = torch.stack([(sel >> (4 * i)) & 7 for i in range(4)], -1)  # (n, 4)
    return src8[:, nib]


def _select(x0, x1, mask):
    return (x0 & ~mask) | (x1 & mask)


# -- the products --------------------------------------------------------------


def nibble_matmul(tables, b):
    """(rows, k, 32) uint8 nibble tables times b (k, c) uint8 over GF(2^8)
    -> (rows, c) uint8: per j, each coefficient's lo[b & 15] ^ hi[b >> 4]."""
    rows, k = tables.shape[:2]
    bj = b[:k].to(torch.int64)
    acc = torch.zeros((rows, b.shape[1]), dtype=torch.uint8, device=b.device)
    for j in range(k):
        t = tables[:, j]  # (rows, 32)
        acc ^= t[:, bj[j] & 15] ^ t[:, 16 + (bj[j] >> 4)]
    return acc


def nibble_matmul_words(tables, b):
    """`nibble_matmul` as the kernel computes it: four columns a 32-bit
    word, each word's nibbles selected by `prmt` from the tables' 8-entry
    halves and a select on each nibble's top bit."""
    rows, k = tables.shape[:2]
    c = b.shape[1]
    nw = (c + WORD - 1) // WORD
    padded = torch.zeros((k, nw * WORD), dtype=torch.int64, device=b.device)
    padded[:, :c] = b[:k].to(torch.int64)
    words = sum(padded[:, i::WORD] << s for i, s in enumerate(_SHIFTS))  # (k, nw)
    acc = torch.zeros((rows, nw, WORD), dtype=torch.uint8, device=b.device)
    for j in range(k):
        lo_sel, hi_sel, lo_mask, hi_mask = nibble_selectors(words[j])
        t = tables[:, j]  # (rows, 32): lo entries 0-7, 8-15, hi entries 0-7, 8-15
        acc ^= _select(_lookup(t[:, 0:8], lo_sel), _lookup(t[:, 8:16], lo_sel),
                       _bytes(lo_mask))
        acc ^= _select(_lookup(t[:, 16:24], hi_sel), _lookup(t[:, 24:32], hi_sel),
                       _bytes(hi_mask))
    return acc.view(rows, nw * WORD)[:, :c]


def _ints(t):
    """Symbols as int64."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def _symbols16(x):
    """int64 values below 2^16 as uint16 symbols."""
    return x.to(torch.int16).view(torch.uint16)


def log_matmul(exp, log, log_a, b):
    """log(A) (rows, k) uint16 times b (k, c) uint16 over GF(2^16) -> (rows,
    c) uint16. exp and log: `log16_tables` as int64 tensors."""
    la = _ints(log_a)
    lb = log[_ints(b[: la.shape[1]])]
    acc = torch.zeros((la.shape[0], b.shape[1]), dtype=torch.int64, device=b.device)
    for j in range(la.shape[1]):
        e = la[:, j, None] + lb[j][None, :]
        e = torch.where(e >= ORDER16, e - ORDER16, e)
        live = (la[:, j, None] != SENTINEL) & (lb[j][None, :] != SENTINEL)
        acc ^= torch.where(live, exp[e], 0)
    return _symbols16(acc)


def _grouped(product, mats: Sequence, b, widths: Sequence[int]):
    rows = max((m.shape[0] for m in mats), default=0)
    out = torch.zeros((rows, b.shape[1]), dtype=b.dtype, device=b.device)
    off = 0
    for m, w in zip(mats, widths):
        if w:
            out[: m.shape[0], off : off + w] = product(m, b[: m.shape[1], off : off + w])
        off += w
    return out


def nibble_matmul_grouped(tables: Sequence, b, widths: Sequence[int]):
    """One rs_matmul8 launch's function: group g's tables (rows_g, k_g, 32)
    times the next widths[g] columns of b (K, C), rows past k_g unread; the
    result is (R, C), R the largest rows_g, rows past a group's own 0."""
    return _grouped(nibble_matmul, tables, b, widths)


def log_matmul_grouped(exp, log, log_as: Sequence, b, widths: Sequence[int]):
    """One rs_matmul16 launch's function, as `nibble_matmul_grouped` over
    each group's log(A) (rows_g, k_g)."""
    return _grouped(lambda la, bb: log_matmul(exp, log, la, bb), log_as, b, widths)
