"""Fixed-base key tables and the GLV era kernels on the G1 kernels.

The port of the XLA device programs of `lachain_tpu/ops/msm.py`, under
their names, in the port's column layout: a point is a (3R, n) column of
`ops/g1.py` (Montgomery words on the card, pg1's limbs on the CPU), S slots
of K lanes lie slot-major along n, and digits are (W, n) MSB-first planes.
  * `y_fixed_base_tables` / `y_agg_fixed_base`: the verification keys'
    tables d * 16^(15 - w) * Y_i, made once per validator set (the
    `g1_fixed_tables` kernel), and each slot's sum_i rlc_i * Y_i from them
    by gathers and adds with no doubling (the `g1_fixed_scan` kernel) and
    the flagged tree over k_pad lanes.
  * `tpke_era_glv_kernel3`: the era scan without the y lanes, [u | u |
    phi(u)], 3K lanes a slot.
  * `tpke_era_glv_kernel`: the 4K-lane era kernel's (S, 4) entry over
    `g1.era_kernel`.
  * `glv_era_fused`: the GLV era's device program (ops/verify
    GlvEraPipeline): the 3K-lane scan and the fixed-base scan, then ONE
    tree over [u*rlc | y | u*lag1 | phi(u)*lag2], fused for one fetch.
  * `glv_split`, `era_digits` (an era's digit planes from its flat
    coefficients; the pipelines' staging, ops/verify._EraStaging, fills
    the same planes) and `combine_or_host_msm` (the shared escape of a
    colliding combine).

Sums are taken in another order than the JAX package's (it pairs the first
half of a group with the second, msm.py:221-238; `g1.tree_reduce_k` pairs
adjacent lanes, and the fixed-base scan sums 16 windows a lane, split over
4 sub-lanes, before the tree; the fixed-base tables are built in log
depth): the Jacobian coordinates differ, the points do not.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import g1, glv
from .glv import W64, W128, glv_split  # noqa: F401  (msm.glv_split)


def y_fixed_base_tables(y):
    """(3R, K) verification keys -> (16, 16, 3R, K) tables, entry [w, d] =
    d * 16^(15 - w) * Y_i (msm.py:246-263, indexed by MSB-first window):
    one `g1_fixed_tables` launch, once per validator set."""
    return g1.fixed_tables(y)


def y_agg_fixed_base(tables, rlc16, k_pad: int, digits_checked: bool = False):
    """tables from y_fixed_base_tables over k_pad key columns, rlc16 (16,
    S*k_pad) MSB-first RLC digits -> per-slot sum_i rlc[s, i] * Y_i as
    ((3R, S), (S,) infinity flags) (msm.py:266-277): the fixed-base scan,
    then the flagged tree over each slot's k_pad lanes."""
    acc, fl = g1.fixed_scan(tables, rlc16, k_pad, digits_checked)
    return g1.tree_reduce_k(acc, fl, k_pad)


def joined_digits(*parts):
    """Digit planes side by side, each behind leading zero windows up to the
    longest (the flag stays set through them)."""
    nwin = max(p.shape[0] for p in parts)
    return torch.cat([g1.lead_zeros(p, nwin) for p in parts], dim=1)


def _glv3_scan(u, rlc16, lag1, lag2, digits_checked: bool):
    """One table build and one scan over [u | u | phi(u)] with digits
    [rlc | lag1 | lag2], the RLC behind 16 leading zero windows ->
    ((3R, 3n), (3n,))."""
    r = u.shape[0] // 3
    phi_u = torch.cat([g1.mul_beta(u[:r].contiguous()), u[r:]], dim=0)
    lanes = torch.cat([u, u, phi_u], dim=1)
    return g1.msm_scan(g1.build_table(lanes), joined_digits(rlc16, lag1, lag2),
                       digits_checked)


def _by_slot(out, flags, groups: int):
    """(3R, groups * S) group-major tree outputs -> ((3R, S, groups), (S,
    groups)): the JAX package's (S, groups) order."""
    r, s = out.shape[0], out.shape[-1] // groups
    return (out.reshape(r, groups, s).transpose(1, 2),
            flags.reshape(groups, s).T)


def tpke_era_glv_kernel3(u, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
    """The era kernel without the y lanes (msm.py:285-304): u (3R, S*K) share
    points, rlc16 (16, S*K), lag1 / lag2 (32, S*K) GLV halves, K = k a power
    of two -> ((3R, S, 3), (S, 3) flags): u_agg, comb1, comb2 per slot. One
    table build, one scan over [u | u | phi(u)], one tree."""
    acc, fl = _glv3_scan(u, rlc16, lag1, lag2, digits_checked)
    return _by_slot(*g1.tree_reduce_k(acc, fl, k), 3)


def tpke_era_glv_kernel(u, y, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
    """The 4K-lane era kernel (msm.py:307-345): u, y (3R, S*K), digits as in
    tpke_era_glv_kernel3 -> ((3R, S, 4), (S, 4) flags): u_agg, y_agg, comb1,
    comb2 per slot (comb = comb1 + comb2, added on the host). The lanes and
    the work are `g1.era_kernel`'s: one table build, one scan over [u | y |
    u | phi(u)], one tree."""
    out_r, ofl_r, out_l, ofl_l = g1.era_kernel(u, y, rlc16, lag1, lag2, k,
                                               digits_checked)
    return _by_slot(torch.cat([out_r, out_l], dim=1), torch.cat([ofl_r, ofl_l]), 4)


def glv_era_fused(u, tables, rlc16, lag1, lag2, k: int, digits_checked: bool = False):
    """The GLV era's device program: tpke_era_glv_kernel3's scan over 3K
    lanes a slot and the fixed-base scan over the S*k y lanes, then ONE tree
    over [u*rlc | y | u*lag1 | phi(u)*lag2] -> one fused (3R + 1, 4S)
    buffer, the flag row last, columns u_agg | y_agg | comb1 | comb2 per
    slot (the layout of g1.era_kernel_fused): one device->host copy."""
    n = u.shape[-1]
    acc3, fl3 = _glv3_scan(u, rlc16, lag1, lag2, digits_checked)
    acc_y, fl_y = g1.fixed_scan(tables, rlc16, k, digits_checked)
    acc = torch.cat([acc3[:, :n], acc_y, acc3[:, n:]], dim=1)
    fl = torch.cat([fl3[:n], fl_y, fl3[n:]])
    out, ofl = g1.tree_reduce_k(acc, fl, k)
    return torch.cat([out, ofl.to(out.dtype)[None, :]], dim=0)


def era_digits(rlc_flat: Sequence[int], lag_flat: Sequence[int]):
    """An era's coefficient marshal (msm.py:367-386): the
    per-lane 64-bit RLC coefficients and Lagrange coefficients, slot-major
    -> numpy int32 MSB-first digit planes (rlc16 (16, n), lag1 (32, n), lag2
    (32, n)), the Lagrange coefficients GLV-split into halves below 2^128.
    The 64-bit RLC keeps its 16 windows; the scans put it behind leading
    zero windows where they join it with the halves."""
    halves = [glv_split(c) for c in lag_flat]
    return (glv.digits_col(rlc_flat, W64),
            glv.digits_col([h[0] for h in halves], W128),
            glv.digits_col([h[1] for h in halves], W128))


def combine_or_host_msm(comb, u_list, lag_list, backend):
    """The era pipelines' escape of a colliding combine (msm.py:389-399): a
    combine that comes back as infinity while some Lagrange coefficient is
    nonzero (two equal partial sums met in the incomplete add tree; these
    lanes carry no random coefficients) is recomputed by the host MSM.
    Returns (point, whether it was recomputed), so that the caller counts
    the escape."""
    if comb[2] == 0 and any(c for c in lag_list):
        return backend.g1_msm(
            [u for u, c in zip(u_list, lag_list) if c],
            [c for c in lag_list if c],
        ), True
    return comb, False

