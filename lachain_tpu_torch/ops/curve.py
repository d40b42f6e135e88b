"""Bit-serial MSM entries of `lachain_tpu/ops/curve.py` on the window kernels.

The JAX package's `curve.g1_msm` (curve.py:192) and `curve.g2_msm` (:364)
take (n, nbits) MSB-first bit rows and run a complete double-and-add per
lane, then a tree sum. Here the same entries take the port's point columns
((3R, n) G1, (P, n) G2, ops/g1.py and ops/g2.py) and bits on the same
device; the bits become 4-bit windows (`bits_to_digits`, on the device)
and run through ONE windowed MSM and tree reduce (`g1.msm_reduce` /
`g2.msm2_reduce`) over n padded to a power of two with flagged lanes.
`scalars_to_bits` is the host marshal (curve.py:61), vectorised.

Those kernels add incompletely, and infinity is a flag, not Z = 0:
  * an input lane whose Z is 0 (infinity as packed) gets zero digits, by a
    test on the device (no read back), so it adds nothing;
  * the returned flag is set when no lane contributed (the sum is
    infinity);
  * a clear flag with Z = 0 marks an incomplete add that met p = +-q (a
    repeated point, or p with -p): Z = 0 then spreads up every later add.
    These entries return that point as it is; callers that hold the oracle
    points (ops/verify.GpuTpkeVerifier) recompute such a sum on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import g1, g2


def scalars_to_bits(scalars: Sequence[int], nbits: int = 256) -> np.ndarray:
    """ints -> (n, nbits) int32 bit rows, MSB first: bit b of row i is
    (s_i >> (nbits - 1 - b)) & 1, as curve.scalars_to_bits (curve.py:61)
    gives it (bits above nbits dropped, two's complement for s < 0)."""
    nbytes = (nbits + 7) // 8
    mask = (1 << nbits) - 1
    buf = b"".join((int(s) & mask).to_bytes(nbytes, "big") for s in scalars)
    a = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), nbytes)
    return np.unpackbits(a, axis=1)[:, 8 * nbytes - nbits:].astype(np.int32)


def bits_to_digits(bits):
    """(n, nbits) MSB-first bit rows (a tensor; a bit counts where it is 1,
    as the JAX package's double-and-add reads it) -> (ceil(nbits / 4), n)
    int32 MSB-first 4-bit digits on the same device: nbits padded up to a
    multiple of 4 with leading zeros. Every digit lies in [0, 16)."""
    n, nbits = bits.shape
    nwin = (nbits + 3) // 4
    b = (bits == 1).to(torch.int32)
    pad = 4 * nwin - nbits
    if pad:
        b = torch.cat([torch.zeros((n, pad), dtype=b.dtype, device=b.device), b], dim=1)
    w = torch.tensor([8, 4, 2, 1], dtype=torch.int32, device=b.device)
    return (b.view(n, nwin, 4) * w).sum(-1, dtype=torch.int32).T.contiguous()


def live_digits(points, digits):
    """Zero the digits of every lane whose Z rows (the last third of its
    rows, as packed) are all 0: an infinity input adds nothing."""
    z = points[2 * points.shape[0] // 3:]
    return torch.where((z == 0).all(0), torch.zeros_like(digits), digits)


def pad_lanes(t, n_pad: int):
    """(rows, n) -> (rows, n_pad): zero columns after the n lanes."""
    extra = n_pad - t.shape[-1]
    if extra == 0:
        return t
    return torch.cat([t, torch.zeros((t.shape[0], extra), dtype=t.dtype,
                                     device=t.device)], dim=1)


def _msm(points, bits, reduce):
    n = points.shape[-1]
    if n < 1 or bits.shape[0] != n:
        raise ValueError(f"one bit row per point, at least one: {n} points, "
                         f"{bits.shape[0]} rows")
    n_pad = 1 << (n - 1).bit_length()
    digits = live_digits(points, bits_to_digits(bits))
    fused = reduce(pad_lanes(points, n_pad), pad_lanes(digits, n_pad), n_pad)
    return fused[:-1, 0], fused[-1, 0] != 0


def g1_msm(points, bits):
    """sum_i s_i P_i (curve.g1_msm, curve.py:192): points (3R, n) G1
    columns, bits (n, nbits) MSB-first on the same device -> ((3R,) point,
    () bool infinity flag), on the device. See the module docstring for the
    flag and Z = 0."""
    return _msm(points, bits,
                lambda p, d, k: g1.msm_reduce(p, d, k, digits_checked=True))


def g2_msm(points, bits):
    """sum_i s_i Q_i over G2 (curve.g2_msm, curve.py:364): points (P, n) G2
    columns, bits (n, nbits) -> ((P,) point, () bool infinity flag). See
    the module docstring for the flag and Z = 0."""
    return _msm(points, bits,
                lambda p, d, k: g2.msm2_reduce(p, d, k, digits_checked=True))
