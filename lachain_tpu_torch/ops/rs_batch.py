"""Batched Reed-Solomon over GF(2^8)/GF(2^16): Vandermonde matrix form, one
CUDA launch per batch call and field.

The port of `lachain_tpu/ops/rs_batch.py`. Encode is `V @ C` for the n x k
Vandermonde V (rows [x^0 .. x^{k-1}] at x = 1..n) against the k x L
coefficient matrix C; decode is `inv(V_sel) @ R` for the k received rows.
Items that share a (field, k, n), or for decode a (field, k, erasure
pattern), form one group, as in the reference; all groups of a call and
field then go to the card as ONE `rs_matmul8` / `rs_matmul16` launch
(`csrc/rs.cu`): each group's matrix times its own run of columns, in the
reference's column order, with no padding. The reference ran one jitted
product per group. `GF`, `field_for`, `vandermonde`, `_inverse_for` (the
Gauss-Jordan inverse, on the host as in the reference), `_coeff_matrix`
and the byte layouts are the reference's, so shards and payloads are its
bits. GF(2^16) (poly 0x1100B, generator 2) serves n > 255: shards are
big-endian uint16 symbols, swapped once at the host boundary, and an
odd-sized shard is a clean decode failure before any launch.

`encode_batch`, `decode_batch`, `encode` and `decode` take `device`:
"cuda" (the default; no card raises) launches the kernel, "cpu" runs its
plain PyTorch version (`ops/rs_ref.py`), and "numpy" runs `GF.matmul` per
group on the host (the reference's host product; an oracle, timed beside
the card by `chip_smoke.py`). Nothing falls back: the reference's
4096-column floor for the device, its `LACHAIN_RS_DEVICE` switch and probe,
its numpy fallback on a device error and its padding of columns to a power
of two are not carried over. The Vandermonde matrices and the inverses go
to the card once, in the kernels' forms (`operand`: GF(2^8) nibble tables,
GF(2^16) log(A)), made on the host with numpy and keyed like the host
caches; GF(2^16)'s exp and log tables go once per device.

`LAUNCHES` counts the kernel launches of `rs_matmul` (CUDA only).
"""
from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, rs_ref
from .g1 import _on_cpu, _run
from .verify import resolve_device


class GF:
    """A binary field GF(2^bits) with exp/log tables (generator 2)."""

    def __init__(self, bits: int, poly: int):
        self.bits = bits
        self.order = (1 << bits) - 1
        self.poly = poly
        self.dtype = np.uint8 if bits == 8 else np.uint16
        # big-endian wire dtype: shard bytes <-> symbol arrays
        self.be_dtype = np.uint8 if bits == 8 else np.dtype(">u2")
        self.sym_size = 1 if bits == 8 else 2
        exp = np.zeros(2 * self.order, dtype=self.dtype)
        log = np.zeros(1 << bits, dtype=np.int32)
        x = 1
        for i in range(self.order):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & (1 << bits):
                x ^= poly
        # generator 2 must cycle through every nonzero element exactly once
        assert x == 1, f"generator 2 is not primitive for poly {poly:#x}"
        exp[self.order :] = exp[: self.order]
        self.exp, self.log = exp, log

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("gf_inv(0)")
        return int(self.exp[self.order - self.log[a]])

    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """GF matrix product a (r,k) @ b (k,c): exp[log+log] gather with
        zero masks, XOR-accumulated over the contraction axis (the numpy
        oracle of the kernel)."""
        a = np.ascontiguousarray(a, dtype=self.dtype)
        b = np.ascontiguousarray(b, dtype=self.dtype)
        r, k = a.shape
        c = b.shape[1]
        out = np.zeros((r, c), dtype=self.dtype)
        log_b = self.log[b]  # (k, c)
        mask_b = b != 0
        log_a = self.log[a]  # (r, k)
        mask_a = a != 0
        for j in range(k):
            if not mask_a[:, j].any() or not mask_b[j].any():
                continue
            prod = self.exp[log_a[:, j, None] + log_b[j][None, :]]
            np.bitwise_xor(
                out,
                np.where(mask_a[:, j, None] & mask_b[j][None, :], prod, 0),
                out=out,
            )
        return out

    def mat_inv(self, mat: np.ndarray) -> Optional[np.ndarray]:
        """Gauss-Jordan inversion (first-nonzero pivot, same scan order as
        ops/rs.py::_gf_mat_inv); None when singular."""
        k = mat.shape[0]
        a = mat.astype(np.int64).copy()
        inv = np.eye(k, dtype=np.int64)
        exp, log = self.exp, self.log
        for col in range(k):
            piv = None
            for r in range(col, k):
                if a[r, col] != 0:
                    piv = r
                    break
            if piv is None:
                return None
            if piv != col:
                a[[col, piv]] = a[[piv, col]]
                inv[[col, piv]] = inv[[piv, col]]
            pinv = self.inv(int(a[col, col]))
            for row_arr in (a, inv):
                row = row_arr[col]
                nz = row != 0
                row[nz] = exp[log[row[nz]] + log[pinv]]
            for r in range(k):
                if r == col or a[r, col] == 0:
                    continue
                fac = int(a[r, col])
                for row_arr in (a, inv):
                    prow = row_arr[col]
                    nz = prow != 0
                    term = np.zeros(k, dtype=np.int64)
                    term[nz] = exp[log[prow[nz]] + log[fac]]
                    row_arr[r] ^= term
        return inv.astype(self.dtype)


GF8 = GF(8, 0x11D)  # matches ops/rs.py tables exactly

_GF16_CACHE: List[Optional[GF]] = [None]


def gf16() -> GF:
    """GF(2^16) built on first use (the 65535-step table bootstrap is not
    free; n <= 255 workloads never pay it)."""
    if _GF16_CACHE[0] is None:
        _GF16_CACHE[0] = GF(16, 0x1100B)
    return _GF16_CACHE[0]


def field_for(n: int) -> GF:
    if n <= 255:
        return GF8
    if n <= 65535:
        return gf16()
    raise ValueError(f"n={n} exceeds GF(2^16) evaluation points")


def _field(bits: int) -> GF:
    return GF8 if bits == 8 else gf16()


# -- cached per-(field, k, n) matrices ---------------------------------------

_VCACHE: Dict[Tuple[int, int, int], np.ndarray] = {}
_ICACHE: Dict[Tuple[int, int, Tuple[int, ...]], Optional[np.ndarray]] = {}
_CACHE_CAP = 512
# (matrix key, device) -> the matrix in the kernel's form on that device;
# (device, plain) -> GF(2^16)'s exp and log there
_DEV_MATS: Dict[tuple, torch.Tensor] = {}
_DEV_TABLES: Dict[Tuple[str, bool], Tuple[torch.Tensor, torch.Tensor]] = {}


def vandermonde(field: GF, k: int, n: int) -> np.ndarray:
    """n x k evaluation matrix: row i = [x^0 .. x^{k-1}] at x = i+1."""
    key = (field.bits, k, n)
    v = _VCACHE.get(key)
    if v is None:
        if len(_VCACHE) >= _CACHE_CAP:
            _VCACHE.clear()
        v = np.zeros((n, k), dtype=field.dtype)
        for r in range(n):
            acc = 1
            for c in range(k):
                v[r, c] = acc
                acc = field.mul(acc, r + 1)
        _VCACHE[key] = v
    return v


def _inverse_for(
    field: GF, k: int, xs: Tuple[int, ...]
) -> Optional[np.ndarray]:
    key = (field.bits, k, xs)
    if key in _ICACHE:
        return _ICACHE[key]
    if len(_ICACHE) >= _CACHE_CAP:
        _ICACHE.clear()
    mat = np.zeros((k, k), dtype=field.dtype)
    for r, x in enumerate(xs):
        acc = 1
        for c in range(k):
            mat[r, c] = acc
            acc = field.mul(acc, x)
    inv = field.mat_inv(mat)
    _ICACHE[key] = inv
    return inv


def clear_caches() -> None:
    """Forget every Vandermonde matrix and inverse, on the host and, in the
    kernels' forms, on the card (the next flush is a cold one)."""
    _VCACHE.clear()
    _ICACHE.clear()
    _DEV_MATS.clear()


def operand(bits: int, a: np.ndarray) -> np.ndarray:
    """A (rows, k) in the form `rs_matmul` takes: over GF(2^8) its nibble
    tables (rows, k, 32) uint8, over GF(2^16) log(A) (rows, k) uint16 with
    0xFFFF at a zero (`ops/rs_ref.py`)."""
    field = _field(bits)
    if bits == 8:
        return rs_ref.nibble_tables(field, a)
    return rs_ref.log_matrix(field, a)


def _dev_mat(key: tuple, a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """`operand` of a host-made matrix (key[0] its field's bits) on `dev`,
    made and uploaded once per key."""
    dkey = (key, str(dev))
    t = _DEV_MATS.get(dkey)
    if t is None:
        if len(_DEV_MATS) >= 2 * _CACHE_CAP:
            _DEV_MATS.clear()
        t = _DEV_MATS[dkey] = torch.from_numpy(operand(key[0], a)).to(dev)
    return t


def _tables16(dev: torch.device, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """GF(2^16)'s (exp, log) on `dev`, made once (`rs_ref.log16_tables`):
    uint16 for the kernel, int64 for the plain version."""
    key = (str(dev), plain)
    t = _DEV_TABLES.get(key)
    if t is None:
        tabs = rs_ref.log16_tables(gf16())
        t = _DEV_TABLES[key] = tuple(
            torch.from_numpy(x.astype(np.int64) if plain else x).to(dev) for x in tabs)
    return t


# -- the kernel wrapper ------------------------------------------------------

SYMBOLS = {8: torch.uint8, 16: torch.uint16}  # torch dtype of a field's symbols
LAUNCHES = {"rs_matmul8": 0, "rs_matmul16": 0}
# (library, bits) -> its `lt_rs_geometry`: rows a thread, columns a unit,
# threads a block, the largest rtile, ctile and stage depth
_GEOMETRY: Dict[Tuple[str, int], Tuple[int, ...]] = {}
_SMS: Dict[str, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def geometry(lib, bits: int) -> Tuple[int, ...]:
    """(rows a thread, columns a unit, threads a block, largest rtile,
    largest ctile, largest stage depth) of `lib`'s rs_matmul<bits>
    kernel."""
    vals = [ctypes.c_int() for _ in range(6)]
    rc = lib.lt_rs_geometry(0 if bits == 8 else 1, *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"lt_rs_geometry failed with CUDA error {rc}")
    return tuple(v.value for v in vals)


def tiles_for(units: int, rows: int, k: int, geom, sms: int) -> Tuple[int, int, int]:
    """(rtile, ctile, kd) of a call of `units` column units in all, `rows`
    rows and largest k: rtile its rows up to the kernel's largest; ctile
    the column units that cut the call into about one item an SM (fewer
    where the columns are few), at most a block's threads' worth of units
    (one pass) and the largest ctile; kd, the j a stage of shared memory
    holds, k up to the largest."""
    rb, _cols, block, max_rt, max_ct, max_kd = geom
    rtile = max(1, min(rows, max_rt))
    col_tiles = max(1, sms // -(-rows // rtile))
    ctile = max(1, min(-(-units // col_tiles), block // -(-rtile // rb), max_ct))
    return rtile, ctile, max(1, min(k, max_kd))


def group_info(bits: int, mats: Sequence[torch.Tensor]) -> List[Tuple[int, int, int]]:
    """[(address, rows_g, k_g)] of each group's form of A, each checked to
    be the form `rs_matmul` takes (`operand`: a contiguous (rows, k, 32)
    uint8 tensor over GF(2^8), on the card at a 16-byte aligned address,
    which the kernel reads in 16-byte loads; (rows, k) uint16 over
    GF(2^16)); one pass over the groups."""
    dtype, dim = (torch.uint8, 3) if bits == 8 else (torch.uint16, 2)
    out = []
    for g, m in enumerate(mats):
        shape = m.shape
        if (m.dtype != dtype or len(shape) != dim or not m.is_contiguous()
                or (dim == 3 and shape[2] != 32)):
            raise ValueError(f"rs_matmul mats[{g}]: expected GF(2^{bits})'s form of A "
                             f"(`operand`), a contiguous {dim}-D {dtype} tensor")
        ptr = m.data_ptr()
        if dim == 3 and ptr & 15 and m.is_cuda:
            raise ValueError(f"rs_matmul mats[{g}]: its address is not 16-byte aligned")
        out.append((ptr, shape[0], shape[1]))
    return out


def group_rows(bits: int, info: Sequence[Tuple[int, int, int]], widths: Sequence[int],
               rows: int, tiles: Optional[Sequence[int]] = None, geom=None, sms: int = 0):
    """(the kernel's group rows [A's form's address, rows_g, k_g,
    col_begin, col_end, first item], `info` the first three; the call's
    item count; its tiles, by default `tiles_for`'s with the kernel's
    geometry `geom` and `sms` SMs). Each group is cut into ceil(rows /
    rtile) row tiles x ceil(units / ctile) column tiles, a unit a word of 4
    columns that its columns touch (GF(2^8); shared with a neighbour where
    a group's run is not 4-aligned) or a column (GF(2^16)); its items are
    adjacent, in group order. One group's row is a list, made without
    numpy; many groups' one (G, 6) int64 array."""
    k = max(i[2] for i in info)
    if len(info) == 1:
        w = int(widths[0])
        units = total = (w + 3) // 4 if bits == 8 else w
    else:
        w = np.asarray(widths, dtype=np.int64)
        end = np.cumsum(w)
        begin = end - w
        units = np.where(w > 0, (end + 3) // 4 - begin // 4, 0) if bits == 8 else w
        total = int(units.sum())
    if tiles is None:
        tiles = tiles_for(total, rows, k, geom, sms)
    rtile, ctile = tiles[:2]
    items = -(-rows // rtile) * (-(-units // ctile))
    if len(info) == 1:
        return [[*info[0], 0, w, 0]], items, tiles
    out = np.empty((len(info), 6), dtype=np.int64)
    out[:, :3] = info
    out[:, 3] = begin
    out[:, 4] = end
    out[:, 5] = np.cumsum(items) - items
    return out, int(items.sum()), tiles


def _sms(dev: torch.device) -> int:
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[key]


def rs_matmul_plain(bits: int, mats: Sequence[torch.Tensor], b: torch.Tensor,
                    widths: Sequence[int]) -> torch.Tensor:
    """`rs_matmul`'s plain version on the tensors' own device: what the
    wrapper runs on the CPU, and the card checks' yardstick on the card."""
    if bits == 8:
        return rs_ref.nibble_matmul_grouped(mats, b, widths)
    return rs_ref.log_matmul_grouped(*_tables16(b.device, plain=True), mats, b, widths)


def rs_matmul(bits: int, mats: Sequence[torch.Tensor], b: torch.Tensor,
              widths: Sequence[int]) -> torch.Tensor:
    """Every group's product over GF(2^bits) in one launch (replaces the
    jitted `_mm`, lachain_tpu/ops/rs_batch.py:233, run once per group
    there): group g's A (rows_g, k_g), given in its kernel form mats[g]
    (`operand`: nibble tables (rows_g, k_g, 32) uint8, or log(A) (rows_g,
    k_g) uint16), times the next widths[g] columns of b (K, C), its rows
    past k_g unread, into those columns of the (R, C) result, R the largest
    rows_g and rows past a group's own 0. Symbols are `SYMBOLS[bits]`. CPU
    tensors run the plain version (`rs_ref.nibble_matmul_grouped`,
    `rs_ref.log_matmul_grouped`); CUDA tensors launch `rs_matmul<bits>`."""
    dtype = SYMBOLS[bits]
    on_cpu = _on_cpu(b, *mats)
    if len(widths) != len(mats) or sum(widths) != b.shape[1]:
        raise ValueError(f"widths {list(widths)} do not cover b's {b.shape[1]} columns")
    if b.dtype != dtype or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"rs_matmul b: expected a contiguous 2-D {dtype} tensor")
    info = group_info(bits, mats)
    if any(k > b.shape[0] for _p, _r, k in info):
        raise ValueError("rs_matmul: a group's k exceeds b's rows")
    if on_cpu:
        return rs_matmul_plain(bits, mats, b, widths)
    out = launch(_build.library(), bits, info, b, widths)
    if out.numel():  # launch() launches nothing for an empty result
        LAUNCHES[f"rs_matmul{bits}"] += 1
    return out


def launch(lib, bits: int, info: Sequence[Tuple[int, int, int]], b: torch.Tensor,
           widths: Sequence[int], tiles: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """One `lt_rs_matmul<bits>` launch of the library `lib` over the groups
    of `group_info` and columns b that `rs_matmul` has checked, cut into
    tiles (rtile, ctile, kd), by default `tiles_for`'s -> the (R, C) result
    (no launch when it is empty)."""
    rows = max((i[1] for i in info), default=0)
    cols = b.shape[1]
    out = torch.empty((rows, cols), dtype=b.dtype, device=b.device)
    if rows == 0 or cols == 0:
        return out
    geom = None
    if tiles is None:
        geom = _GEOMETRY.get((lib._name, bits))
        if geom is None:
            geom = _GEOMETRY[(lib._name, bits)] = geometry(lib, bits)
    host_rows, items, tiles = group_rows(bits, info, widths, rows, tiles, geom,
                                         _sms(b.device))
    # non_blocking: a blocking upload would wait for the work already
    # queued; CUDA stages the pageable rows before the call returns
    groups = torch.as_tensor(host_rows, dtype=torch.int64).to(b.device, non_blocking=True)
    args = (groups.data_ptr(), len(info), items, b.data_ptr(), cols, out.data_ptr(),
            rows, *tiles)
    if bits == 8:
        rc = _run(lib.lt_rs_matmul8, b, *args)
    else:
        exp, log = _tables16(b.device)
        rc = _run(lib.lt_rs_matmul16, b, exp.data_ptr(), log.data_ptr(), *args)
    if rc != 0:
        raise RuntimeError(f"rs_matmul{bits}: kernel launch failed with CUDA error {rc}")
    return out


# -- batched codec -----------------------------------------------------------


def resolve(device) -> Optional[torch.device]:
    """None for the numpy oracle, else the torch device (no card raises)."""
    return None if device == "numpy" else resolve_device(device)


def _add(timings: Optional[dict], key: str, t0: float) -> float:
    """Add the seconds since t0 to timings[key]; return the clock."""
    t = time.perf_counter()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + t - t0
    return t


def _products(field: GF, groups, devs: Optional[list],
              timings: Optional[dict]) -> List[np.ndarray]:
    """groups: [(matrix key, A (rows_g, k_g), [blocks (k_g, w) of B])] of
    one field -> each group's A @ [blocks] as big-endian wire symbols
    (field.be_dtype), (rows_g, sum of w). Over the devices `devs` (one, or
    a 1-D mesh's in order; the reference's column sharding,
    rs_batch.py:260-305, without its power-of-two padding) each group's
    columns are cut into len(devs) contiguous blocks, block i of a run of w
    the columns w * i // n .. w * (i + 1) // n: device i gets its blocks of
    every group packed into one host buffer (pinned on the card) and
    uploaded ("pack_s"), runs ONE launch over them ("device_s"; none where
    it has no columns), and its result is downloaded (into pinned memory on
    the card) and each group's blocks joined in column order ("fetch_s").
    On the CPU the same through the plain version; with devs None,
    GF.matmul per group."""
    t = time.perf_counter()
    if devs is None:
        outs = [field.matmul(a, np.concatenate(blocks, axis=1)).astype(field.be_dtype)
                for _key, a, blocks in groups]
        _add(timings, "device_s", t)
        return outs
    n = len(devs)
    card = devs[0].type == "cuda"
    widths = [sum(blk.shape[1] for blk in blocks) for _key, _a, blocks in groups]
    k_max = max(a.shape[1] for _key, a, _b in groups)
    shards = []  # (the groups' column ranges, the live groups' widths, forms, B)
    for i, dev in enumerate(devs):
        cuts = [(w * i // n, w * (i + 1) // n) for w in widths]
        live = [g for g, (lo, hi) in enumerate(cuts) if hi > lo]
        if not live:
            continue
        ws = [cuts[g][1] - cuts[g][0] for g in live]
        host = torch.empty((k_max, sum(ws)), dtype=SYMBOLS[field.bits], pin_memory=card)
        view, off = host.numpy(), 0
        for g in live:  # columns lo..hi of the group's blocks side by side
            lo, hi = cuts[g]
            pos = 0
            for blk in groups[g][2]:
                w = blk.shape[1]
                a, b = max(lo, pos), min(hi, pos + w)
                if a < b:
                    view[: blk.shape[0], off + a - lo : off + b - lo] = (
                        blk if b - a == w else blk[:, a - pos : b - pos])
                pos += w
            off += hi - lo
        mats = [_dev_mat(groups[g][0], groups[g][1], dev) for g in live]
        shards.append((cuts, ws, mats, host.to(dev, non_blocking=True)))
    used = list(dict.fromkeys(sh[3].device for sh in shards)) if card else []
    for dev in used:
        torch.cuda.synchronize(dev)
    t = _add(timings, "pack_s", t)
    outs = [rs_matmul(field.bits, mats, b, ws) for _cuts, ws, mats, b in shards]
    for dev in used:
        torch.cuda.synchronize(dev)
    t = _add(timings, "device_s", t)
    pieces: List[list] = [[] for _ in groups]  # a group's blocks in column order
    for (cuts, _ws, _mats, _b), out in zip(shards, outs):
        if card:
            fetched = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            fetched.copy_(out)
            out = fetched
        res, off = out.numpy().astype(field.be_dtype, copy=False), 0
        for g, (lo, hi) in enumerate(cuts):
            if hi > lo:
                pieces[g].append(res[: groups[g][1].shape[0], off : off + hi - lo])
                off += hi - lo
    results = []
    for p, (_key, a, _blocks) in zip(pieces, groups):
        if len(p) == 1:
            results.append(p[0])
        else:  # blocks of several devices, or no column at all
            results.append(np.concatenate(p or [np.zeros((a.shape[0], 0), field.dtype)], axis=1,
                                          dtype=field.be_dtype))
    _add(timings, "fetch_s", t)
    return results


def _coeff_matrix(field: GF, data: bytes, k: int) -> np.ndarray:
    """Length-prefix + zero-pad `data` into the k x L coefficient matrix
    (L in field symbols), mirroring ops/rs.py::encode's layout."""
    prefixed = len(data).to_bytes(4, "big") + data
    unit = k * field.sym_size
    shard_syms = (len(prefixed) + unit - 1) // unit
    shard_syms = max(shard_syms, 1)
    padded = prefixed + b"\x00" * (unit * shard_syms - len(prefixed))
    return (
        np.frombuffer(padded, dtype=field.be_dtype)
        .reshape(k, shard_syms)
        .astype(field.dtype)
    )


def _devices(device, mesh) -> Optional[list]:
    """The devices a call's products run on: a 1-D mesh's (parallel/
    mesh.py), in order, where one is given; else [device], or None for the
    numpy oracle."""
    if mesh is not None:
        return list(mesh.devices.flat)
    dev = resolve(device)
    return None if dev is None else [dev]


def encode_batch(
    items: Sequence[Tuple[bytes, int, int]], device="cuda",
    timings: Optional[dict] = None, mesh=None,
) -> List[List[bytes]]:
    """Encode many (data, k, n) payloads; one matrix product per (field,
    k, n) group and one launch per field (a launch per device and field
    over a `mesh`, in place of `device`: every group's columns cut into a
    contiguous block a device, the reference's column sharding,
    rs_batch.py:260-305, without its power-of-two padding). Returns
    per-item n-shard lists, ops/rs.py-bit-identical for n <= 255 and
    GF(2^16)-coded past that. `timings`, when given, accumulates the
    phases' seconds."""
    devs = _devices(device, mesh)
    results: List[Optional[List[bytes]]] = [None] * len(items)
    by_field: Dict[int, Dict[Tuple[int, int], List[int]]] = {}
    for idx, (data, k, n) in enumerate(items):
        assert 0 < k <= n
        by_field.setdefault(field_for(n).bits, {}).setdefault((k, n), []).append(idx)
    for bits, groups in by_field.items():
        field = _field(bits)
        t = time.perf_counter()
        work = [((bits, k, n), vandermonde(field, k, n),
                 [_coeff_matrix(field, items[i][0], k) for i in members])
                for (k, n), members in groups.items()]
        _add(timings, "pack_s", t)
        outs = _products(field, work, devs, timings)
        t = time.perf_counter()
        for (_key, _v, blocks), members, out in zip(work, groups.values(), outs):
            off = 0
            for i, blk in zip(members, blocks):
                w = blk.shape[1]
                results[i] = [out[r, off : off + w].tobytes() for r in range(out.shape[0])]
                off += w
        _add(timings, "fetch_s", t)
    return results  # type: ignore[return-value]


def decode_batch(
    items: Sequence[Tuple[Sequence[Optional[bytes]], int]], device="cuda",
    timings: Optional[dict] = None, mesh=None,
) -> List[Optional[bytes]]:
    """Decode many (shards, k) items; shards is the full n-length list with
    None for missing entries. One matrix product per (field, k, erasure
    pattern) group and one launch per field; per-item None on any of the
    scalar path's failure conditions (short, mixed-size, odd GF(2^16) size,
    bad length prefix). The first k present shards are the ones used, and
    only their sizes are checked, as in the reference. `timings` and `mesh`
    as in encode_batch, the host inverses apart ("inverse_s")."""
    devs = _devices(device, mesh)
    results: List[Optional[bytes]] = [None] * len(items)
    groups: Dict[Tuple[int, int, Tuple[int, ...]], List[int]] = {}
    sel: List[Optional[List[Tuple[int, bytes]]]] = [None] * len(items)
    for idx, (shards, k) in enumerate(items):
        n = len(shards)
        field = field_for(n)
        have = [(i, s) for i, s in enumerate(shards) if s is not None]
        if len(have) < k:
            continue
        have = have[:k]
        size = len(have[0][1])
        if any(len(s) != size for _, s in have):
            continue  # adversarial mixed-size commitment: clean failure
        if size % field.sym_size:
            continue  # GF(2^16): odd byte length cannot be symbols
        xs = tuple(i + 1 for i, _ in have)
        sel[idx] = have
        groups.setdefault((field.bits, k, xs), []).append(idx)
    t = time.perf_counter()
    by_field: Dict[int, list] = {}
    for key, members in groups.items():
        bits, k, xs = key
        inv = _inverse_for(_field(bits), k, xs)
        if inv is not None:  # singular selection: every member fails cleanly
            by_field.setdefault(bits, []).append((key, inv, members))
    _add(timings, "inverse_s", t)
    for bits, work in by_field.items():
        field = _field(bits)
        t = time.perf_counter()
        prepared = [
            (key, inv, [np.frombuffer(b"".join(s for _i, s in sel[i]),
                                      dtype=field.be_dtype).reshape(key[1], -1)
                        for i in members])
            for key, inv, members in work
        ]
        _add(timings, "pack_s", t)
        outs = _products(field, prepared, devs, timings)
        t = time.perf_counter()
        for (_key, _inv, blocks), (_k, _i, members), out in zip(prepared, work, outs):
            off = 0
            for i, blk in zip(members, blocks):
                w = blk.shape[1]
                flat = out[:, off : off + w].tobytes()
                off += w
                if len(flat) < 4:
                    continue
                length = int.from_bytes(flat[:4], "big")
                if length > len(flat) - 4:
                    continue
                results[i] = flat[4 : 4 + length]
        _add(timings, "fetch_s", t)
    return results


def encode(data: bytes, k: int, n: int, device="cuda") -> List[bytes]:
    """Single-item convenience (ops/rs.py delegates its n > 255 branch
    here with device="cpu")."""
    return encode_batch([(data, k, n)], device=device)[0]


def decode(shards: Sequence[Optional[bytes]], k: int, device="cuda") -> Optional[bytes]:
    return decode_batch([(shards, k)], device=device)[0]
