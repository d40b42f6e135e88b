#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (lachain_tpu_torch) on one card.

    python3 chip_smoke.py [--seed S]

Phases, each of which must pass (any failure exits non-zero):
  1. build   the CUDA kernels of lachain_tpu_torch/csrc/ (g1.cu, g2.cu,
             secp.cu and rs.cu, one nvcc each, in parallel, sm_90a), with each
             kernel's registers, local bytes, threads per lane and block,
             and the host pairing library of lachain_tpu_torch/crypto/native/
             (g++, GpuBackend's host backend);
  2. kernels hold each of the nineteen kernels against its plain PyTorch
             version (ops/g1_ref.py, ops/g2_ref.py, ops/secp_ref.py,
             ops/rs_ref.py) on the
             card, on seeded inputs at the main paths' shapes (8192 lanes,
             the adds with a p == q lane; the G2 and secp scans with 64
             windows; the three table builds at their main path's lanes:
             the TPKE era's 16,384 joined lanes [u | y | u | phi(u)], the
             coin era's 4096 signature lanes, 22 live of each 64 and the
             others infinity, and one 4096-signature recovery chunk's 8192
             lanes [R_i, G], each table's entries 1, 2, 3 and 15 also held
             against the host's scalar multiples; the secp square root on
             plain words at 16384 lanes and at the recovery's 9,980; the
             secp Montgomery conversions out of and into form on a (25,
             8192) buffer with a flag row, the G1 ones (g1_mont) out of
             form, into it and by beta on a (37, 8192) buffer with a flag
             row and into form on the coin era's (72, 4096) G2 pack): exact
             equality of coordinates mod p and flags (of the conversions,
             words bit for bit, and Python ints); the Reed-Solomon product
             (rs_matmul8, rs_matmul16) bit for bit at every launch shape of
             the RBC flushes: GF(2^8) (64 x 22)(22 x 8,384), the N=64
             re-encode, (64 x 22)(22 x 131), the own proposal's encode,
             one grouped decode launch of 64 distinct (22 x 22) inverses
             over 131 columns each, and (64 x
             22)(22 x 82,624), a 10,000-transaction block's; GF(2^16) (256
             x 86)(86 x 1,280), the N=256 re-encode, (256 x 86)(86 x 5),
             the encode, and the decode of 256 distinct (86 x 86)
             inverses over 5 columns each; and ragged widths with zero
             rows and columns in both fields.
             The three scans run twice: at the main path's layout (the TPKE
             era's joined scan, 32 windows x 16,384 lanes; the coin era's
             scan, 48 leading zero windows on its RLC half and 22 live
             lanes of 64; one 4096-signature recovery chunk, [R_i, G]
             interleaved), over the tables built there, and at a
             random-digit kernel check (32 / 64 windows of random digits x
             8192 lanes). Every kernel's numbers in the kernels JSON are
             those of its kernel check, the shape the earlier slices
             reported; each scan's entry and the square root's also hold a
             `main` object, their numbers at the main path's layout;
  3. main    five paths, each with the kernel launch counts set to 0 just
             before its one counted call and read just after:
             the N=64 TPKE era (64 ACS slots x 64 decryption shares) through
             GpuBackend(device="cuda").tpke_era_verify_combine: every slot
             must verify and decrypt, with exactly 1 G1 table build, 1 G1
             scan, 6 tree adds, 4 G1 conversions (g1_mont), no doubling and
             no fp_mul; a poisoned share must isolate exactly its slot, 4
             slots are held against the port's HostEraPipeline, and the
             host backend's pairing (the native library) must equal the
             pure-Python HostBackend's on the era's grand-check pairs and
             on the same pairs with one slot poisoned;
             the N=64 coin era (64 coins x 64 signers, 22 live shares each)
             through threshold_sig.era_verify_combine on the same backend:
             every signature must verify under the shared key with the host
             combine's parity, with exactly 1 G2 table build, 1 G2 scan, 12
             G2 adds and no G2 doubling (and the key RLC's 1 G1 table
             build, 1 G1 scan and 6 adds; 3 g1_mont), a poisoned share must isolate exactly
             its coin, 4 coins are held against TsHostEraPipeline, and one
             device g1_msm and one g2_msm at n=100 against the host MSM;
             pool-ingest ECDSA recovery of 10,000 signatures from 64 senders
             (32 of them malformed) through
             ecdsa.recover_hash_batch(..., device="cuda"): every valid
             signature must recover its sender's key, every malformed one
             and 64 valid ones must equal ecdsa.recover_hash, the launches
             must be exactly one square root over the 9,980 x values that
             pass validation and, per 4096-signature chunk, 1 table build, 1
             scan, 1 pair add and 2 Montgomery conversions (no doubling, no
             secp_fp_mul); a crafted
             u1*R == u2*G
             signature, in a call of its own, must be answered by the host
             oracle exactly once;
             the RBC flush of one validator's era (its own proposal's encode,
             one interpolation per slot, each slot losing a seeded 0..n-k
             shards, an equivocating slot and a slot of mixed shard sizes)
             through RbcEraBatcher(device="cuda") at N=64 (GF(2^8)) and at
             N=256 (GF(2^16)), proposals the size of a 1,000-transaction
             block's share: every verdict must equal scalar_verdict on the
             host (None on the two bad slots), the encode rs.encode's (or
             GF.matmul's past n = 255), and a cold flush (no cached inverse)
             must launch exactly 3 rs_matmul (encode, the decode of every
             erasure pattern, re-encode). Around each counted call and the
             MSMs, no result may have been recomputed on the host
             (ops/verify.ESCAPES), and each path must launch its kernels;
  4. times   per-kernel times from CUDA events, the plain versions' times,
             each kernel's bound, the warm phase times of every path (the
             eras' `pairing_s` with the host backend's name; the RBC flush's
             cold phases with its host inverses apart, its warm phases each
             the best of 2, and its wall with device="cpu" and with the
             numpy GF.matmul oracle) and a torch.profiler split of each
             device phase by kernel, whose traced launches of each path's
             kernels must equal the counted ones.
The last three lines of standard output are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.

Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import random
import re
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and float32
# outside the tensor cores, 67 TFLOP/s = 33.5 T fused multiply-adds/s. The
# kernels' operations are 32-bit integer multiply-adds, counted 2 operations
# each like an FMA; Hopper issues them at no more than the float32 rate, so
# the bound from this peak is a floor.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# one 12 x 32-bit Montgomery product (CIOS): 2*12*12 + 12 word products
OPS_PER_FIELD_MUL = 2 * (2 * 12 * 12 + 12)
MULS_DBL, MULS_ADD = 7, 16  # field products per doubling / incomplete add
MULS_DBL2, MULS_ADD2 = 16, 44  # the same over Fp2 (G2), in Fp products
# of an add's products, those that read only q: q.z^2 and q.z^3
MULS_ZPOW, MULS_ZPOW2 = 2, 5
# the table builds: per lane 1 doubling and 13 adds of the lane's point,
# whose z powers are made once
MULS_TABLE = MULS_DBL + MULS_ZPOW + 13 * (MULS_ADD - MULS_ZPOW)  # G1, secp: 191
MULS_TABLE2 = MULS_DBL2 + MULS_ZPOW2 + 13 * (MULS_ADD2 - MULS_ZPOW2)  # 528
# one 8 x 32-bit secp256k1 Montgomery product: 2*8*8 + 8 word products; a
# secp doubling / add is 7 / 16 of them like G1's
OPS_PER_SECP_MUL = 2 * (2 * 8 * 8 + 8)
# one secp256k1 squaring needs 8*9/2 distinct a_i*a_j and the reduction's
# 8*8 + 8 (the kernels run it as a product, so their time pays 136)
OPS_PER_SECP_SQR = 2 * (8 * 9 // 2 + 8 * 8 + 8)
# word products of one conversion of a coordinate: the reduction out of
# Montgomery form, 8 steps of m and m * p (the product into form, 136, is
# timed beside it)
MONT_WORD_PRODUCTS = 8 * (8 + 1)
# the same over BLS12-381's 12 words (g1_mont)
G1_MONT_WORD_PRODUCTS = 12 * (12 + 1)
# the Reed-Solomon product's bound: one term (a GF(2^16) exp lookup) a
# lane a clock on every SM, 132 SMs x 32 lanes x the H100 SXM's 1.98 GHz
# boost clock (NVIDIA's H100 data sheet and Hopper white paper)
LOOKUPS_PER_S = 132 * 32 * 1.98e9
# the GF(2^8) nibble design's integer operations: 64 INT32 lanes an SM
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# host idle time around each profiled step (profile_device)
TRACE_PAD_S = 0.05

N_VALIDATORS = 64
KERNEL_LANES = 8192  # S*K*2 msm lanes of the N=64 eras
COIN_LANES = 4096  # the coin era's signature lanes: 64 coins x 64 signers
LIVE = 22  # t + 1 of the N=64 eras: the combined shares of a coin
SQRT_LANES = 16384  # the square root's kernel check of the earlier slices
# the x values of the 10,000-signature batch that pass validation (the
# 9,976 signatures that reach the scans and the 4 non-residue x): the
# recovery's square root runs exactly these lanes
RECOVER_SQRT_LANES = 9980
N_SIGNATURES = 10000
N_SENDERS = 64
# the RBC eras: N validators, each proposing 1000 // N transfers of a
# 1,000-transaction block (lachain_tpu/core/block_producer.py:29, :118)
RBC_ERAS = (64, 256)
BLOCK_TXS = 1000
# every counted RBC flush: the encode, the decode of every erasure pattern
# and the re-encode, one launch each
RBC_LAUNCHES = 3
KERNEL_NAMES = ("fp_mul_kernel", "dbl_kernel", "add_kernel", "msm_scan_kernel",
                "g1_table_kernel", "g1_mont_kernel",
                "g2_dbl_kernel", "g2_add_kernel", "g2_msm_scan_kernel",
                "g2_table_kernel",
                "secp_fp_mul_kernel", "secp_dbl_kernel", "secp_add_kernel",
                "secp_msm_scan_kernel", "secp_sqrt_kernel", "secp_table_kernel",
                "secp_mont_kernel", "rs_matmul8_kernel", "rs_matmul16_kernel")
G1_KERNELS = ("fp_mul", "g1_dbl", "g1_add", "g1_table", "g1_msm_scan", "g1_mont")
# the wrapper's kernel name -> the CUDA kernel's
KERNEL_OF = {"fp_mul": "fp_mul_kernel", "g1_dbl": "dbl_kernel",
             "g1_add": "add_kernel", "g1_msm_scan": "msm_scan_kernel"}
KERNEL_OF.update({k: f"{k}_kernel" for k in ("g1_table", "g1_mont", "g2_dbl", "g2_add",
                                              "g2_msm_scan", "g2_table",
                                              "secp_fp_mul", "secp_dbl", "secp_add",
                                              "secp_table", "secp_msm_scan",
                                              "secp_sqrt", "secp_mont",
                                              "rs_matmul8", "rs_matmul16")})
# the TPKE era's counted call: one table build over the joined lanes (one
# launch), one scan, a tree reduce of log2(64) = 6 adds; 4 G1 conversions
# (g1_mont: the share pack into Montgomery form, the key pack of the
# backend's first era, phi's product by beta, the fetch out of form), no
# fp_mul
TPKE_LAUNCHES = {"g1_msm_scan": 1, "g1_table": 1, "g1_dbl": 0, "g1_add": 6,
                 "g1_mont": 4, "fp_mul": 0}
# the coin era's counted call: one G2 table build (one launch) and one
# G2 scan over [table | table], two G2 tree reduces of 6 adds; the key RLC
# as one G1 table build, scan and tree reduce; 3 g1_mont (the G2 signature
# pack, the key pack of the first coin era, the fetch)
COIN_LAUNCHES = dict(TPKE_LAUNCHES, g2_table=1, g2_msm_scan=1, g2_add=12,
                     g2_dbl=0, g1_mont=3)
G2_KERNELS = ("g2_dbl", "g2_add", "g2_table", "g2_msm_scan")
SECP_KERNELS = ("secp_fp_mul", "secp_dbl", "secp_add", "secp_table",
                "secp_msm_scan", "secp_sqrt", "secp_mont")
RS_KERNELS = ("rs_matmul8", "rs_matmul16")
# the one-thread doublings serve no main path since each table build is
# one launch, secp_fp_mul none since the conversions are secp_mont, fp_mul
# none since the G1 conversions and phi's product by beta are g1_mont
NO_PATH = ("g1_dbl", "g2_dbl", "secp_dbl", "secp_fp_mul", "fp_mul")


class SeededRng:
    """`randbelow` over a seeded random.Random (the rng API the port takes)."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def check(cond, msg: str) -> None:
    """A failed check fails the run (kept under python -O, unlike assert)."""
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` calls, after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_once(fn):
    """(result, device ms) of one call of fn(), with no warm call: for the
    plain versions whose one call takes seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: int, nops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float(max((abs(x - y) for x, y in zip(a, b)), default=0))


def scan_products(digits, mul_dbl: int, mul_add: int) -> int:
    """Field products the digits need: from each lane's leading nonzero
    digit on, 4 doublings per window and one add per later nonzero digit."""
    import torch

    d = digits.cpu()
    nwin, n = d.shape
    nz = d != 0
    lead = torch.where(nz.any(0), nz.int().argmax(0), torch.full((n,), nwin))
    dbls = int((4 * (nwin - 1 - lead).clamp(min=0)).sum())
    adds = int(nz.sum()) - int(nz.any(0).sum())
    return dbls * mul_dbl + adds * mul_add


def report_line(name: str, r: dict) -> None:
    for label, x in (("", r), (" main", r.get("main"))):
        if x is None:
            continue
        shape = f"lanes={x['lanes']}" + (f" windows={x['windows']}" if "windows" in x else "")
        log(f"kernel {name}{label}: {x.get('layout', '')} {shape} ok={x['ok']} "
            f"max_abs_err={x['max_abs_err']} ms={x['ms']:.4f} "
            f"plain_ms={x['plain_ms']:.3f} bound_ms={x['bound'][0]:.5f} "
            f"({x['bound'][1]})")


def scan_entry(kernel, plain, coords, ktab, rtab, digits, muls_dbl, muls_add,
               point_bytes, layout: str, reps: int,
               ops_per_mul: int = OPS_PER_FIELD_MUL) -> dict:
    """One scan (`kernel`, its `plain` version, the `coords` reader) on the
    same table and digits: exactness, CUDA-event times of both, and the
    bound of the work these digits need."""
    import torch

    acc, fl = kernel(ktab, digits)
    (racc, rfl), plain_ms = cuda_ms_once(lambda: plain(rtab, digits))
    got, want = coords(acc), coords(racc.cpu())
    flags_ok = bool(torch.equal(fl.cpu(), rfl.cpu()))
    n = ktab.shape[-1]
    muls = scan_products(digits, muls_dbl, muls_add)
    nbytes = ktab.numel() * 4 + digits.numel() * 4 + point_bytes * n + n
    return dict(
        layout=layout, lanes=n, windows=int(digits.shape[0]),
        ok=got == want and flags_ok, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: kernel(ktab, digits), reps), plain_ms=plain_ms,
        bound=bound(nbytes, muls * ops_per_mul), want=want, flags=rfl.cpu(),
    )



# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(seed: int, dev):
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref, glv

    rng = random.Random(seed)
    n = KERNEL_LANES
    report = {}

    def ref_pts(points):
        return torch.from_numpy(g1_ref.points_to_limbs(points)).to(dev)

    # (1) fp_mul, with 0, 1, p-1 and 2^384 mod p among the operands
    edge = [0, 1, bls.P - 1, (1 << 384) % bls.P]
    xs = edge + [rng.randrange(bls.P) for _ in range(n - len(edge))]
    ys = list(reversed(edge)) + [rng.randrange(bls.P) for _ in range(n - len(edge))]
    kx, ky = g1.fp_encode(xs, dev), g1.fp_encode(ys, dev)
    rx = torch.from_numpy(g1_ref.ints_to_limbs(xs)).to(dev)
    ry = torch.from_numpy(g1_ref.ints_to_limbs(ys)).to(dev)
    got = g1.fp_decode(g1.fp_mul(kx, ky))
    want = g1_ref.limbs_to_ints(g1_ref.fp_mul(rx, ry).cpu().numpy())
    check(want == [x * y % bls.P for x, y in zip(xs, ys)], "g1_ref.fp_mul wrong")
    report["fp_mul"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.fp_mul(kx, ky), 200),
        plain_ms=cuda_ms(lambda: g1_ref.fp_mul(rx, ry), 5),
        bound=bound(3 * 48 * n, n * OPS_PER_FIELD_MUL),
    )

    # (2) g1_dbl and (3) g1_add on n Jacobian points (Z != 1), lane 7 of the
    # add holding p == q (Z = 0 on both sides)
    ps = glv.point_run(rng, n)
    qs = glv.point_run(rng, n)
    qs[7] = ps[7]
    kp, kq = g1.g1_pack(ps, dev), g1.g1_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    got = g1.g1_coords(g1.g1_dbl(kp))
    want = g1.g1_coords(g1_ref.dbl(rp).cpu())
    for i in range(0, n, 997):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_dbl(ps[i])), "g1_ref.dbl wrong")
    report["g1_dbl"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.g1_dbl(kp), 100),
        plain_ms=cuda_ms(lambda: g1_ref.dbl(rp), 3),
        bound=bound(2 * 144 * n, n * MULS_DBL * OPS_PER_FIELD_MUL),
    )
    got = g1.g1_coords(g1.g1_add(kp, kq))
    want = g1.g1_coords(g1_ref.add_incomplete(rp, rq).cpu())
    check(want[2 * n + 7] == 0, "g1_ref.add: p == q must give Z = 0")
    for i in range(0, n, 997):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_add(ps[i], qs[i])), "g1_ref.add wrong")
    report["g1_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.g1_add(kp, kq), 100),
        plain_ms=cuda_ms(lambda: g1_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 144 * n, n * MULS_ADD * OPS_PER_FIELD_MUL),
    )

    # (14) the table build at the TPKE era's joined lanes [u | y | u |
    # phi(u)] (g1.tpke_lanes, 16,384 lanes), against the plain chain of
    # one doubling and 13 adds
    lanes = g1.tpke_lanes(rng, slots=n // 128)
    m = len(lanes)
    kl, rl = g1.g1_pack(lanes, dev), ref_pts(lanes)
    ktab = g1.build_table(kl)
    rtab, plain_ms = cuda_ms_once(lambda: g1_ref.build_table(rl))
    got = [g1.g1_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [g1.g1_coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        for i in (0, m // 4, m - 1):  # a u, a y and a phi(u) lane
            pt = (want[k][i], want[k][m + i], want[k][2 * m + i])
            check(bls.g1_eq(pt, bls.g1_mul(lanes[i], k)),
                  "g1_ref.build_table wrong")
    report["g1_table"] = dict(
        lanes=m, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: g1.build_table(kl), 10), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 144 * m, m * MULS_TABLE * OPS_PER_FIELD_MUL),
    )
    del got, want

    # (4) msm_scan at the TPKE era's joined layout: 32 windows x 16,384
    # lanes, digits [rlc32 | rlc32 | lag1 | lag2] (g1.tpke_digits), over
    # the tables the card and the plain chain just built from those lanes
    scan = (g1.msm_scan, g1_ref.msm_scan, g1.g1_coords)
    main = scan_entry(*scan, ktab, rtab, g1.tpke_digits(rng, slots=n // 128).to(dev),
                      MULS_DBL, MULS_ADD, 144, "tpke joined", 10)
    del rtab

    # and the random-digit kernel check: 32 windows over a host-built table
    # k*P; every 61st lane has all-zero digits and must come back flagged
    nwin = glv.W128
    table_pts = [[bls.G1_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([bls.g1_add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([g1.g1_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    scalars = [rng.randrange(1 << 128) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = g1.digits_col(scalars, nwin, dev)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL, MULS_ADD, 144,
                     "random", 5)
    want, rfl = chk.pop("want"), chk.pop("flags")
    main.pop("want"), main.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, 3, n // 2):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_mul(ps[i], scalars[i])), "g1_ref.msm wrong")
    report["g1_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)

    # (17) g1_mont on a (37, 8192) buffer with a flag row (the fetch's
    # layout), and into form on the coin era's (72, 4096) G2 pack
    report["g1_mont"] = g1_mont_entry(rng, dev, n)
    report.update(check_g2_kernels(rng, dev))
    report.update(check_secp_kernels(rng, dev))
    report.update(check_rs_kernels(rng, dev))
    for name, r in report.items():
        report_line(name, r)
    bad = [name for name, r in report.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return report


def check_g2_kernels(rng: random.Random, dev):
    """The four G2 kernels against g2_ref: g2_dbl and g2_add at 8192 lanes,
    the table build at the coin era's 4096 signature lanes, the scan with
    64 windows at the coin era's layout and at random digits."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g2, g2_ref, glv

    n = KERNEL_LANES
    report = {}

    def ref_pts(points):
        return torch.from_numpy(g2_ref.points_to_limbs(points)).to(dev)

    # (5) g2_dbl and (6) g2_add on n Jacobian points (Z != 1), lane 7 of the
    # add holding p == q (Z = 0 on both sides)
    ps = glv.point_run(rng, n, bls.g2_mul, bls.g2_add, bls.G2_GEN)
    qs = glv.point_run(rng, n, bls.g2_mul, bls.g2_add, bls.G2_GEN)
    qs[7] = ps[7]
    kp, kq = g2.g2_pack(ps, dev), g2.g2_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    got = g2.g2_coords(g2.g2_dbl(kp))
    want = g2.g2_coords(g2_ref.dbl(rp).cpu())
    for i in range(0, n, 997):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_dbl(ps[i])), "g2_ref.dbl wrong")
    report["g2_dbl"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_dbl(kp), 50),
        plain_ms=cuda_ms(lambda: g2_ref.dbl(rp), 3),
        bound=bound(2 * 288 * n, n * MULS_DBL2 * OPS_PER_FIELD_MUL),
    )
    got = g2.g2_coords(g2.g2_add(kp, kq))
    want = g2.g2_coords(g2_ref.add_incomplete(rp, rq).cpu())
    check(want[4 * n + 7] == want[5 * n + 7] == 0, "g2_ref.add: p == q must give Z = 0")
    for i in range(0, n, 997):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_add(ps[i], qs[i])),
              "g2_ref.add wrong")
    report["g2_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_add(kp, kq), 50),
        plain_ms=cuda_ms(lambda: g2_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 288 * n, n * MULS_ADD2 * OPS_PER_FIELD_MUL),
    )

    # (13) the G2 table build at the coin era's signature lanes: 64 coins x
    # 64 signers, the first 22 of each coin live and the others infinity
    # (0, 1, 0), whose Z = 0 every entry keeps; against the plain chain of
    # one doubling and 13 adds
    m = COIN_LANES
    lanes = g2.coin_lanes(rng, coins=m // 64, live=LIVE)
    kl, rl = g2.g2_pack(lanes, dev), ref_pts(lanes)
    ktab = g2.build_table2(kl)
    rtab, plain_ms = cuda_ms_once(lambda: g2_ref.build_table(rl))
    got = [g2.g2_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [g2.g2_coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        check(bls.g2_eq(g2_lane(want[k], 0, m), bls.g2_mul(lanes[0], k)),
              "g2_ref.build_table wrong")
        check(want[k][4 * m + LIVE] == want[k][5 * m + LIVE] == 0,
              "g2_ref.build_table: an infinity lane must keep Z = 0")
    del rtab
    report["g2_table"] = dict(
        lanes=m, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: g2.build_table2(kl), 10), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 288 * m, m * MULS_TABLE2 * OPS_PER_FIELD_MUL),
    )

    # (7) g2_msm_scan over a host-built table k*P: at the coin era's layout
    # (g2.coin_digits: [rlc64 | lag64], 48 leading zero windows on
    # the RLC half, 22 live lanes of each 64 on both halves), then at the
    # random-digit kernel check (64 windows of random digits; every 61st lane
    # all zero and flagged)
    scan = (g2.msm2_scan, g2_ref.msm_scan, g2.g2_coords)
    nwin = 64
    table_pts = [[bls.G2_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([bls.g2_add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([g2.g2_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    del table_pts
    coin = g2.coin_digits(rng, coins=n // 128).to(dev)
    main = scan_entry(*scan, ktab, rtab, coin, MULS_DBL2, MULS_ADD2, 288,
                      "coin", 5)
    main.pop("want"), main.pop("flags")
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = torch.from_numpy(glv.digits_col(scalars, nwin)).to(dev)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL2, MULS_ADD2, 288,
                     "random", 3)
    want, rfl = chk.pop("want"), chk.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, n // 2):
        check(bls.g2_eq(g2_lane(want, i, n), bls.g2_mul(ps[i], scalars[i])),
              "g2_ref.msm wrong")
    del rtab
    report["g2_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)
    return report


def g2_lane(coords, i: int, n: int):
    """Lane i of g2_coords over n lanes -> an oracle G2 Jacobian tuple."""
    return tuple((coords[j * n + i], coords[(j + 1) * n + i]) for j in (0, 2, 4))


def check_secp_kernels(rng: random.Random, dev):
    """The seven secp256k1 kernels against secp_ref at the recover path's
    shapes: 8192 lanes (one 4096-signature chunk), the table build at a
    chunk's [R_i, G] lanes, the scan with 64 windows of random digits and at
    the chunk's layout, the square root at 16384 lanes and at the
    recovery's 9,980, the Montgomery conversions on a chunk's fused
    buffer."""
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import glv, secp, secp_ref

    n = KERNEL_LANES
    P = ecdsa.P
    report = {}

    def ref_fe(vals):
        return torch.from_numpy(secp_ref.ints_to_limbs(vals)).to(dev)

    def ref_pts(points):
        return torch.from_numpy(secp_ref.points_to_limbs(points)).to(dev)

    def affine(c, i):
        zi = pow(c[2 * n + i], -1, P)
        return (c[i] * zi * zi % P, c[n + i] * zi * zi * zi % P)

    # (8) secp_fp_mul, with 0, 1, p-1 and 2^256 mod p among the operands
    edge = [0, 1, P - 1, (1 << 256) % P]
    xs = edge + [rng.randrange(P) for _ in range(n - len(edge))]
    ys = list(reversed(edge)) + [rng.randrange(P) for _ in range(n - len(edge))]
    kx, ky = secp.fe_encode(xs, dev), secp.fe_encode(ys, dev)
    rx, ry = ref_fe(xs), ref_fe(ys)
    got = secp.fe_decode(secp.secp_fp_mul(kx, ky))
    want = secp_ref.limbs_to_ints(secp_ref.fp_mul(rx, ry).cpu().numpy())
    check(want == [x * y % P for x, y in zip(xs, ys)], "secp_ref.fp_mul wrong")
    report["secp_fp_mul"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_fp_mul(kx, ky), 200),
        plain_ms=cuda_ms(lambda: secp_ref.fp_mul(rx, ry), 5),
        bound=bound(3 * 32 * n, n * OPS_PER_SECP_MUL),
    )

    # (9) secp_dbl on n affine points; (10) secp_add on the doubled points
    # (Z != 1) and n more, lane 7 holding p == q (Z = 0 on both sides)
    secp_run = (ecdsa._mul, ecdsa._add, ecdsa.G, ecdsa.N)
    ps = glv.point_run(rng, n, *secp_run)
    qs = glv.point_run(rng, n, *secp_run)
    qs[7] = ecdsa._add(ps[7], ps[7])
    kp, kq = secp.pt_pack(ps, dev), secp.pt_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    kd, rd = secp.secp_dbl(kp), secp_ref.dbl(rp)
    got, want = secp.pt_coords(kd), secp_ref.coords(rd.cpu())
    for i in range(0, n, 997):
        check(affine(want, i) == ecdsa._add(ps[i], ps[i]), "secp_ref.dbl wrong")
    report["secp_dbl"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_dbl(kp), 100),
        plain_ms=cuda_ms(lambda: secp_ref.dbl(rp), 3),
        bound=bound(2 * 96 * n, n * MULS_DBL * OPS_PER_SECP_MUL),
    )
    got = secp.pt_coords(secp.secp_add(kd, kq))
    want = secp_ref.coords(secp_ref.add_incomplete(rd, rq).cpu())
    check(want[2 * n + 7] == 0, "secp_ref.add: p == q must give Z = 0")
    for i in range(1, n, 997):
        check(affine(want, i) == ecdsa._add(ecdsa._add(ps[i], ps[i]), qs[i]),
              "secp_ref.add wrong")
    report["secp_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.secp_add(kd, kq), 100),
        plain_ms=cuda_ms(lambda: secp_ref.add_incomplete(rd, rq), 3),
        bound=bound(3 * 96 * n, n * MULS_ADD * OPS_PER_SECP_MUL),
    )

    # (11) secp_msm_scan: 64 windows over a host-built table k*P; every 61st
    # lane has all-zero digits and must come back flagged
    nwin = glv.W256
    table_pts = [[None] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([ecdsa._add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([secp.pt_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    del table_pts
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = secp.digits_col(scalars, dev)
    scan = (secp.msm_scan, secp_ref.msm_scan, secp.pt_coords)
    chk = scan_entry(*scan, ktab, rtab, digits, MULS_DBL, MULS_ADD, 96,
                     "random", 5, OPS_PER_SECP_MUL)
    want, rfl = chk.pop("want"), chk.pop("flags")
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, 3, n // 2):
        check(affine(want, i) == ecdsa._mul(ps[i], scalars[i]), "secp_ref.msm wrong")
    del rtab

    # (15) the table build at the recovery's layout: one 4096-signature
    # chunk, [R_i, G] interleaved (secp.recover_layout, 8192 affine lanes),
    # against the plain chain of one doubling and 13 adds
    pts, rdigits = secp.recover_layout(rng, n // 2)
    kl, rl = secp.pt_pack(pts, dev), ref_pts(pts)
    ktab = secp.build_table(kl)
    rtab, plain_ms = cuda_ms_once(lambda: secp_ref.build_table(rl))
    got = [secp.pt_coords(ktab[k]) for k in range(glv.TABLE)]
    want = [secp_ref.coords(rtab[k].cpu()) for k in range(glv.TABLE)]
    for k in (1, 2, 3, 15):
        for i in (0, 1, n - 2):  # R_0, G, R_4095
            check(affine(want[k], i) == ecdsa._mul(pts[i], k),
                  "secp_ref.build_table wrong")
    report["secp_table"] = dict(
        lanes=n, ok=got == want,
        max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: secp.build_table(kl), 20), plain_ms=plain_ms,
        bound=bound((1 + glv.TABLE) * 96 * n, n * MULS_TABLE * OPS_PER_SECP_MUL),
    )
    del got, want

    # and the scan at the recovery's layout: the chunk's full-width u1, u2
    # over the tables the card and the plain chain just built
    main = scan_entry(*scan, ktab, rtab, rdigits.to(dev), MULS_DBL, MULS_ADD,
                      96, "recover", 5, OPS_PER_SECP_MUL)
    main.pop("want"), main.pop("flags")
    del rtab
    report["secp_msm_scan"] = dict(chk, ok=main["ok"] and chk["ok"], main=main)

    # (12) secp_sqrt on plain words at 16384 lanes and at the recovery's
    # 9,980 (no padding): random x (about half non-residues), 0, 1, p - 1
    # and G's x among them, every lane against the plain version
    sqrt_runs = {layout: sqrt_entry(rng, dev, m, layout)
                 for layout, m in (("check", SQRT_LANES), ("recover", RECOVER_SQRT_LANES))}
    report["secp_sqrt"] = dict(sqrt_runs["check"], main=sqrt_runs["recover"],
                               ok=all(r["ok"] for r in sqrt_runs.values()))

    # (16) secp_mont on a (25, 8192) buffer (a chunk's fused layout)
    report["secp_mont"] = mont_entry(rng, dev, n)
    return report


def mont_entry(rng: random.Random, dev, n: int) -> dict:
    """secp_mont on a (25, n) buffer, 3 coordinates of random words (0, 1
    and p - 1 among them) and a flag row, out of Montgomery form and into
    it, each against the plain version bit for bit and against Python ints,
    the flag row copied; both directions timed, the bound by bytes."""
    import numpy as np
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, secp_ref

    P, r = ecdsa.P, 1 << 256
    vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(3 * n - 3)]
    words = np.concatenate([secp._words(vals[c * n : (c + 1) * n]) for c in range(3)])
    flags = np.array([rng.randrange(2) for _ in range(n)], np.int32)[None]
    buf = torch.from_numpy(np.concatenate([words.view(np.int32), flags])).to(dev)
    runs = {}
    for into, want in ((False, [v * pow(r, -1, P) % P for v in vals]),
                       (True, [v * r % P for v in vals])):
        out = secp.mont_convert(buf, into)
        plain, plain_ms = cuda_ms_once(
            lambda into=into: secp_ref.mont_mul_words(buf, secp._R2 if into else 1))
        got = secp._download_words(out[:-1])
        runs[into] = dict(
            ok=torch.equal(out, plain) and got == want and torch.equal(out[-1], buf[-1]),
            max_abs_err=max_err(got, want), plain_ms=plain_ms,
            ms=cuda_ms(lambda into=into: secp.mont_convert(buf, into), 200))
    out_, in_ = runs[False], runs[True]
    return dict(
        lanes=n, rows=int(buf.shape[0]), ok=out_["ok"] and in_["ok"],
        max_abs_err=max(out_["max_abs_err"], in_["max_abs_err"]),
        ms=out_["ms"], plain_ms=out_["plain_ms"],
        into_ms=in_["ms"], into_plain_ms=in_["plain_ms"],
        bound=bound(2 * buf.numel() * 4, 3 * n * MONT_WORD_PRODUCTS * 2),
    )


def g1_mont_entry(rng: random.Random, dev, n: int) -> dict:
    """g1_mont on a (37, n) buffer, 3 coordinates of random words (0, 1 and
    p - 1 among them) and a flag row, out of Montgomery form, into it and
    by beta (the first coordinate), each against the plain version bit for
    bit and against Python ints, the flag row copied; and into form at the
    main path's largest conversion, the coin era's (72, n / 2) G2 signature
    pack. Each timed, the bound by bytes."""
    import numpy as np
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g1, g1_ref, glv

    P, r = bls.P, 1 << 384

    def buffer(coords: int, lanes: int, flag_row: bool):
        vals = [0, 1, P - 1] + [rng.randrange(P) for _ in range(coords * lanes - 3)]
        rows = [g1._words(vals[c * lanes : (c + 1) * lanes]).view(np.int32)
                for c in range(coords)]
        if flag_row:
            rows.append(np.array([rng.randrange(2) for _ in range(lanes)], np.int32)[None])
        return vals, torch.from_numpy(np.concatenate(rows)).to(dev)

    def ints(t):
        return g1._from_words(t.cpu().numpy().view(np.uint32))

    def run(buf, vals, op, factor, want):
        out = g1._mont(buf, op)
        plain, plain_ms = cuda_ms_once(lambda: g1_ref.mont_mul_words(buf, factor))
        coords = buf.shape[0] // g1.NL * g1.NL
        got = ints(out[:coords])
        return dict(
            ok=torch.equal(out, plain) and got == want
            and torch.equal(out[coords:], buf[coords:]),
            max_abs_err=max_err(got, want), plain_ms=plain_ms,
            ms=cuda_ms(lambda: g1._mont(buf, op), 200),
            bound=bound(2 * buf.numel() * 4,
                        coords // g1.NL * buf.shape[1] * 2
                        * (G1_MONT_WORD_PRODUCTS if op == g1._MONT_OUT
                           else OPS_PER_FIELD_MUL // 2)))

    vals, buf = buffer(3, n, True)
    out_ = run(buf, vals, g1._MONT_OUT, 1, [v * pow(r, -1, P) % P for v in vals])
    in_ = run(buf, vals, g1._MONT_INTO, g1._R2, [v * r % P for v in vals])
    x = buf[: g1.NL].contiguous()
    beta = run(x, vals[:n], g1._MONT_BETA, g1._BETA_R,
               [glv.BETA * v % P for v in vals[:n]])  # x beta R / R
    vals2, buf2 = buffer(6, n // 2, False)
    main = run(buf2, vals2, g1._MONT_INTO, g1._R2, [v * r % P for v in vals2])
    runs = (out_, in_, beta, main)
    return dict(
        lanes=n, rows=int(buf.shape[0]), ok=all(x["ok"] for x in runs),
        max_abs_err=max(x["max_abs_err"] for x in runs),
        ms=out_["ms"], plain_ms=out_["plain_ms"], bound=out_["bound"],
        into_ms=in_["ms"], into_plain_ms=in_["plain_ms"], beta_ms=beta["ms"],
        main=dict(main, layout="coin G2 pack, into form", lanes=n // 2),
    )


def sqrt_entry(rng: random.Random, dev, m: int, layout: str) -> dict:
    """The card's sqrt on m lanes of plain words against secp_ref.sqrt on
    every lane, both timed, with its bound a lane: the product into
    Montgomery form, y2's squaring and product, SQRT_CHAIN's squarings and
    products (each squaring at its own cost), the reduction out of form."""
    import torch

    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, secp_ref

    P = ecdsa.P
    non_residue = next(x for x in range(2, 100)
                       if pow((x ** 3 + 7) % P, (P - 1) // 2, P) == P - 1)
    xs = [ecdsa.GX, 0, 1, P - 1, non_residue] + [rng.randrange(P) for _ in range(m - 5)]
    kx = secp._upload_words(secp._words(xs), dev)
    rx = torch.from_numpy(secp_ref.ints_to_limbs(xs)).to(dev)
    got = secp._download_words(secp.sqrt(kx))
    want, plain_ms = cuda_ms_once(lambda: secp_ref.sqrt(rx))
    want = secp_ref.limbs_to_ints(want.cpu().numpy())
    check(want[0] in (ecdsa.GY, P - ecdsa.GY), "secp_ref.sqrt wrong at G")
    for i in range(1, m, 4099):
        check(want[i] == pow((xs[i] ** 3 + 7) % P, (P + 1) // 4, P),
              "secp_ref.sqrt wrong")
    sqrs = 1 + sum(s for s, _ in secp.SQRT_CHAIN)
    muls = 2 + sum(k is not None for _, k in secp.SQRT_CHAIN)
    ops = sqrs * OPS_PER_SECP_SQR + muls * OPS_PER_SECP_MUL + 2 * MONT_WORD_PRODUCTS
    return dict(
        layout=layout, lanes=m, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.sqrt(kx), 20), plain_ms=plain_ms,
        bound=bound(2 * 32 * m, m * ops),
    )


# ---------------------------------------------------------------------------
# phase 3: the N=64 era through GpuBackend
# ---------------------------------------------------------------------------


def make_era(n: int, seed: int):
    """Trusted dealer, one 32-byte message per slot, n x n decryption shares
    and the slots' EraSlotJobs (host oracle only; no kernel involved)."""
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob

    f = (n - 1) // 3
    dealer = tpke.TpkeTrustedKeyGen(n, f, SeededRng(seed))
    privs = [dealer.private_key(i) for i in range(n)]
    chosen = list(range(f + 1))
    lag = [0] * n
    for i, c in zip(chosen, bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)):
        lag[i] = c
    cts, msgs, jobs = [], [], []
    for s in range(n):
        msg = bytes([(s * 7 + i) % 256 for i in range(32)])
        ct = dealer.pub.encrypt(msg, s, SeededRng(seed * 1000 + s))
        row = [p.decrypt_share(ct, check=False).ui for p in privs]
        jobs.append(EraSlotJob(row, list(lag), tpke._hash_uv_to_g2(ct.u, ct.v), ct.w))
        cts.append(ct)
        msgs.append(msg)
    return dealer, cts, msgs, jobs


def profile_device(run) -> dict:
    """{kernel: [device ms, launches]} of one call of run() from
    torch.profiler; device work that is not one of the nineteen kernels
    (copies, cat, where) is summed under "torch". A trace loses the first
    device activities of its session (a trace of the recover path lacked
    its first three launches), so run() goes twice under the profiler's
    warm-up steps, whose events are dropped, and once under its active
    step, which is what is summed. The step's own span ("ProfilerStep*")
    covers the whole call and is left out. Each step idles TRACE_PAD_S on
    the host before run() and after it has synchronized, so that no launch
    lies near the edge of its step's window: the profiler drops a device
    activity whose time, mapped from the card's clock to the host's, falls
    outside the window, and unpadded traces lost launches made just after
    a window opened."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(3):
            time.sleep(TRACE_PAD_S)
            run()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
            prof.step()
    out: dict = {}
    for e in traced[0]:
        t = getattr(e, "self_device_time_total", 0) or 0
        name = kernel_of(e.key)
        # a kernel's launches count whatever device time the trace gives them
        if e.key.startswith("ProfilerStep") or (t <= 0 and name == "torch"):
            continue
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t / 1e3
        acc[1] += e.count
    return out


def profile_launches(run, want: dict, label: str, tries: int = 5) -> dict:
    """profile_device(run), again (at most `tries` traces) while its trace
    lacks some of the `want` {kernel: launches} that run() makes: traces
    of this card's profiler without the padding of profile_device lost a
    flush's first launch, one or all ten launches of a kernel's timed use,
    and in one run one of ten in three traces in a row. Each loss is
    logged, and the phase fails when the last trace still lacks some: no
    time is taken from a partial trace."""
    for i in range(tries):
        by_kernel = profile_device(run)
        got = {k: by_kernel.get(k, [0.0, 0])[1] for k in want}
        if got == want:
            break
        log(f"{label}: the trace lost device activities (trace {i + 1} of {tries}): "
            f"{got} != {want}")
    check(got == want, f"{label}: {tries} traces lacked launches: {got} != {want}")
    return by_kernel


def kernel_of(key: str) -> str:
    """The kernel of a profiler key, templated or not
    ("(anonymous namespace)::msm_scan_kernel<4>(...)" -> "msm_scan_kernel"),
    or "torch" for device work that is none of the nineteen."""
    m = re.search(r"::(\w+)[<(]", key)
    return m[1] if m and m[1] in KERNEL_NAMES else "torch"


def check_traced(label: str, by_kernel: dict, launches: dict, names) -> None:
    """Fail unless the profiled run traced as many launches of each of
    `names` as the counted main-path run made."""
    traced = {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in names}
    counted = {k: launches[k] for k in names}
    check(traced == counted,
          f"{label}: traced launches {traced} != counted {counted} (trace: {by_kernel})")
    log(f"{label}: traced launches equal the counted ones {counted}")


def reset_counts() -> None:
    """Set every kernel's launch count and every host recompute count to 0."""
    from lachain_tpu_torch.ops import g1, g2, rs_batch, secp, verify

    g1.reset_launches()
    g2.reset_launches()
    secp.reset_launches()
    rs_batch.reset_launches()
    verify.reset_escapes()


def read_launches() -> dict:
    from lachain_tpu_torch.ops import g1, g2, rs_batch, secp

    return dict(g1.LAUNCHES, **g2.LAUNCHES, **secp.LAUNCHES, **rs_batch.LAUNCHES)


def check_no_escapes(label: str) -> None:
    """Fail if a result the card returned as infinity was recomputed on the
    host since the last reset_counts(): every answer must come from the
    kernels."""
    from lachain_tpu_torch.ops import verify

    check(not any(verify.ESCAPES.values()),
          f"{label}: host recomputes {verify.ESCAPES}")


def phase_line(t: dict) -> str:
    """Phases in seconds ({"pack_s": ...}) as "pack 1.23 ms, ..."."""
    return ", ".join(f"{k[:-2]} {v * 1e3:.2f} ms" for k, v in t.items())


def warm_summary(label: str, warm) -> None:
    """The phases of the warm run with the least wall time, in ms."""
    best = min(warm, key=lambda w: w["wall_s"])
    log(f"{label} warm (best of {len(warm)}): {phase_line(best)}")


def profile_phase(label: str, new_pipeline, run_era, launches: dict, names) -> dict:
    """Warm up, then split one era call by kernel. Each call runs
    run_era(pipeline) on a fresh new_pipeline(), so that, like the counted
    call (the backend's first era), it packs the keys: its launches are the
    counted call's (`launches` of `names`), which its trace must hold."""
    last = []

    def run():
        last[:] = [new_pipeline()]
        run_era(last[0])

    run()
    by_kernel = profile_launches(run, {KERNEL_OF[k]: launches[k] for k in names}, label)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} device phase by kernel (torch.profiler, ms, launches): "
        f"{by_kernel}; busy {busy:.3f} ms of device phase "
        f"{last[0].last_timings['device_s'] * 1e3:.3f} ms")
    return by_kernel


def run_tpke_path(seed: int, backend, dev):
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob
    from lachain_tpu_torch.ops.verify import GpuEraPipeline, HostEraPipeline

    n = N_VALIDATORS
    t0 = time.perf_counter()
    dealer, cts, msgs, jobs = make_era(n, seed)
    log(f"host setup (dealer, {n} ciphertexts, {n * n} shares): "
        f"{time.perf_counter() - t0:.1f} s")
    vks = dealer.verification_keys

    def check_all(res, bad=()):
        for s, (ok, comb) in enumerate(res):
            if s in bad:
                check(ok is False and comb is None, f"slot {s} not isolated")
            else:
                check(ok, f"slot {s} failed verification")
                check(tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
                      f"slot {s} plaintext not recovered")

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 1))
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("tpke era")
    check_all(res)
    got = {k: launches[k] for k in TPKE_LAUNCHES}
    check(got == TPKE_LAUNCHES, f"tpke era launches {got} != {TPKE_LAUNCHES}")
    log(f"era N={n}: {n} slots verified and decrypted; cold {cold_s:.3f} s; "
        f"launches {launches}; phases {backend.last_timings}")

    warm = []
    for r in range(2):
        t0 = time.perf_counter()
        res = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 2 + r))
        wall = time.perf_counter() - t0
        check_all(res)
        warm.append(dict(backend.last_timings, wall_s=wall))
        log(f"era warm {r}: wall {wall:.4f} s, pairing_s "
            f"{backend.last_timings['pairing_s']:.4f} s on the {backend.host_name} "
            f"host backend, phases {backend.last_timings}")

    # one poisoned share (a chosen lane) must isolate exactly its slot
    bad_slot = n // 4 + 1
    row = list(jobs[bad_slot].u_by_validator)
    row[3] = bls.g1_add(row[3], bls.G1_GEN)
    poisoned = list(jobs)
    poisoned[bad_slot] = EraSlotJob(row, jobs[bad_slot].lagrange_row,
                                    jobs[bad_slot].h, jobs[bad_slot].w)
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(poisoned, vks, SeededRng(seed + 9))
    check_all(res, bad=(bad_slot,))
    log(f"poisoned era: slot {bad_slot} isolated, others decrypt; "
        f"{time.perf_counter() - t0:.2f} s")

    # device time by kernel over one warm device phase (all 64 slots)
    y_points = [vk.y_i for vk in vks]
    slots = [(list(j.u_by_validator), list(j.lagrange_row)) for j in jobs]
    by_kernel = profile_phase("era", lambda: GpuEraPipeline(device=dev), lambda p: p.run_era(
        slots, y_points, SeededRng(seed + 4)), launches, tuple(TPKE_LAUNCHES))
    check_traced("era", by_kernel, launches, tuple(TPKE_LAUNCHES))
    check_host_pairing(backend, jobs, GpuEraPipeline(device=dev).run_era(
        slots, y_points, SeededRng(seed + 6))[0], bad_slot)

    # 4 slots against the host oracle pipeline, same seeded rng
    slots = slots[:4]
    dev_out, dev_rlc = GpuEraPipeline(device=dev).run_era(
        slots, y_points, SeededRng(seed + 5))
    host_out, host_rlc = HostEraPipeline().run_era(
        slots, y_points, SeededRng(seed + 5))
    check(dev_rlc == host_rlc, "rlc draws differ")
    for s, (a, b) in enumerate(zip(dev_out, host_out)):
        for x, y in zip(a, b):
            check(bls.g1_eq(x, y), f"slot {s} aggregate differs from host")
    log("4 slots equal to HostEraPipeline (u_agg, y_agg, combined, rlc)")
    return launches, warm


def check_host_pairing(backend, jobs, aggs, bad_slot: int) -> None:
    """The backend's host pairing (the native library) against the
    pure-Python HostBackend on the TPKE era's own grand check, the 2 pairs
    e(u_agg, H), e(-y_agg, W) of every slot (GpuBackend._era_batch), and on
    the same pairs with slot `bad_slot`'s u_agg moved: both must hold the
    first and refuse the second. Both timed on the host clock."""
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto.host import HostBackend

    pairs = [pair for job, agg in zip(jobs, aggs)
             for pair in ((agg[0], job.h), (bls.g1_neg(agg[1]), job.w))]
    poisoned = list(pairs)
    p, q = pairs[2 * bad_slot]
    poisoned[2 * bad_slot] = (bls.g1_add(p, bls.G1_GEN), q)
    python = HostBackend()
    for label, ps, want in (("grand check", pairs, True),
                            ("poisoned grand check", poisoned, False)):
        t0 = time.perf_counter()
        got = backend.pairing_check(ps)
        t1 = time.perf_counter()
        oracle = python.pairing_check(ps)
        t2 = time.perf_counter()
        check(got is want and oracle is want,
              f"{label}: {backend.host_name} {got}, python {oracle}, want {want}")
        log(f"host pairing, {label} of {len(ps)} pairs: {backend.host_name} "
            f"{got} in {t1 - t0:.4f} s, python HostBackend {oracle} in "
            f"{t2 - t1:.4f} s")


# ---------------------------------------------------------------------------
# phase 3: the N=64 coin era through threshold_sig.era_verify_combine
# ---------------------------------------------------------------------------


def make_coins(n: int, seed: int):
    """Trusted TS dealer and n coins, each holding the shares of the t+1
    lowest-id signers (the ones the combine reads) plus two more."""
    from lachain_tpu_torch.crypto import threshold_sig
    from lachain_tpu_torch.crypto.host import HostBackend

    f = (n - 1) // 3
    dealer = threshold_sig.TsTrustedKeyGen(n, f, SeededRng(seed))
    host = HostBackend()
    privs = [dealer.private_key_share(i) for i in range(f + 3)]
    coins = []
    for c in range(n):
        msg = b"coin|era=%d|id=%d" % (seed, c)
        coins.append((msg, {p.my_id: p.sign(msg, host) for p in privs}))
    return dealer.pub_key_set, coins


def run_coin_path(seed: int, backend, dev):
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import threshold_sig
    from lachain_tpu_torch.crypto.host import HostBackend
    from lachain_tpu_torch.ops.verify import TsGpuEraPipeline, TsHostEraPipeline

    n = N_VALIDATORS
    host = HostBackend()
    t0 = time.perf_counter()
    key_set, coins = make_coins(n, seed + 100)
    chosen = list(range(key_set.t + 1))
    log(f"coin host setup (dealer, {n} coins x {key_set.t + 3} signatures): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = [key_set.combine([shares[i] for i in chosen], host) for _, shares in coins]
    log(f"host combine of {n} coins: {time.perf_counter() - t0:.1f} s")

    def check_all(res, bad=()):
        for c, sig in enumerate(res):
            if c in bad:
                check(sig is None, f"coin {c} not isolated")
                continue
            check(sig is not None, f"coin {c} failed verification")
            check(sig.to_bytes() == want[c].to_bytes(), f"coin {c} != host combine")
            check(sig.parity == want[c].parity, f"coin {c} parity differs")

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    res = threshold_sig.era_verify_combine(key_set, coins, SeededRng(seed + 11), backend)
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("coin era")
    check_all(res)
    got = {k: launches[k] for k in COIN_LAUNCHES}
    check(got == COIN_LAUNCHES, f"coin era launches {got} != {COIN_LAUNCHES}")
    t0 = time.perf_counter()
    for (msg, _), sig in zip(coins, res):
        check(key_set.shared.verify(msg, sig, host), "signature fails shared key")
    log(f"coin era N={n}: {n} coins combined, each verifies under the shared "
        f"key ({time.perf_counter() - t0:.1f} s) with the host's parity; cold "
        f"{cold_s:.3f} s; launches {launches}; phases {backend.last_timings}")

    warm = []
    for r in range(2):
        t0 = time.perf_counter()
        res = threshold_sig.era_verify_combine(
            key_set, coins, SeededRng(seed + 12 + r), backend)
        wall = time.perf_counter() - t0
        check_all(res)
        warm.append(dict(backend.last_timings, wall_s=wall))
        log(f"coin era warm {r}: wall {wall:.4f} s, pairing_s "
            f"{backend.last_timings['pairing_s']:.4f} s on the {backend.host_name} "
            f"host backend, phases {backend.last_timings}")

    # one poisoned chosen share must isolate exactly its coin
    bad_coin = n // 4 + 1
    poisoned = list(coins)
    msg, shares = coins[bad_coin]
    shares = dict(shares)
    shares[1] = threshold_sig.PartialSignature(bls.g2_add(shares[1].sigma, bls.G2_GEN), 1)
    poisoned[bad_coin] = (msg, shares)
    t0 = time.perf_counter()
    res = threshold_sig.era_verify_combine(key_set, poisoned, SeededRng(seed + 19), backend)
    check_all(res, bad=(bad_coin,))
    log(f"poisoned coin era: coin {bad_coin} isolated, others combine; "
        f"{time.perf_counter() - t0:.2f} s")

    # the coin rows era_verify_combine hands the pipeline
    lag = [0] * n
    for i, c in zip(chosen, bls.fr_lagrange_coeffs([i + 1 for i in chosen], at=0)):
        lag[i] = c
    rows = [([shares[i].sigma if i in chosen else bls.G2_INF for i in range(n)], lag)
            for _, shares in coins]
    masks = [[i in chosen for i in range(n)] for _ in coins]
    y_points = [k.y for k in key_set.keys]
    by_kernel = profile_phase("coin era", lambda: TsGpuEraPipeline(device=dev),
                              lambda p: p.run_era(rows, y_points, SeededRng(seed + 14),
                                                  masks=masks), launches, tuple(COIN_LAUNCHES))
    check_traced("coin era", by_kernel, launches, tuple(COIN_LAUNCHES))

    # 4 coins against the host oracle pipeline, same seeded rng
    dev_out, dev_rlc = TsGpuEraPipeline(device=dev).run_era(
        rows[:4], y_points, SeededRng(seed + 15), masks=masks[:4])
    host_out, host_rlc = TsHostEraPipeline().run_era(
        rows[:4], y_points, SeededRng(seed + 15), masks=masks[:4])
    check(dev_rlc == host_rlc, "coin rlc draws differ")
    for c, (a, b) in enumerate(zip(dev_out, host_out)):
        check(bls.g2_eq(a[0], b[0]) and bls.g1_eq(a[1], b[1])
              and bls.g2_eq(a[2], b[2]), f"coin {c} aggregate differs from host")
    log("4 coins equal to TsHostEraPipeline (sig_agg, y_agg, combined, rlc)")

    # the device MSM routes at n = 100 against the host MSM
    rng = random.Random(seed + 16)
    g2_pts = [s.sigma for _, shares in coins for s in shares.values()][:100]
    g1_pts = [key_set.keys[c % n].y for c in range(len(g2_pts))]
    scalars = [rng.randrange(bls.R) for _ in g2_pts]
    g1_pts[7] = bls.G1_INF
    reset_counts()
    t0 = time.perf_counter()
    got2, got1 = backend.g2_msm(g2_pts, scalars), backend.g1_msm(g1_pts, scalars)
    dev_s = time.perf_counter() - t0
    msm_launches = read_launches()
    check_no_escapes("device MSMs")
    idle = [k for k in ("g1_table", "g1_add", "g1_msm_scan", "g2_table", "g2_add",
                        "g2_msm_scan") if msm_launches[k] == 0]
    check(not idle, f"device MSMs never launched: {idle}")
    check(bls.g2_eq(got2, host.g2_msm(g2_pts, scalars)), "device g2_msm != host")
    check(bls.g1_eq(got1, host.g1_msm(g1_pts, scalars)), "device g1_msm != host")
    log(f"device g2_msm and g1_msm at n={len(g2_pts)} equal the host MSM, "
        f"no host recompute ({dev_s:.3f} s); launches {msm_launches}")
    return launches, warm


# ---------------------------------------------------------------------------
# phase 3: pool-ingest ECDSA recovery through ecdsa.recover_hash_batch
# ---------------------------------------------------------------------------

MALFORMED = ("flip_s", "r_zero", "r_above_n", "v_four", "non_residue",
             "z_zero", "short_sig", "short_hash")


def make_signatures(n: int, senders: int, rng: random.Random):
    """n signatures by `senders` seeded keys over random hashes, with the
    signer's own s, v and low-s rule (ecdsa._signature) and nonces that step
    by one: R_{i+1} = R_i + G, one affine add each instead of a scalar
    multiplication per signature. Every signature has its own R and z."""
    from lachain_tpu_torch.crypto import ecdsa

    privs = [rng.randrange(1, ecdsa.N).to_bytes(32, "big") for _ in range(senders)]
    pubs = [ecdsa.public_key_bytes(p) for p in privs]
    k = rng.randrange(1, ecdsa.N - n)
    rp = ecdsa._mul(ecdsa.G, k)
    hashes, sigs, owner = [], [], []
    for i in range(n):
        h = rng.randbytes(32)
        sig = ecdsa._signature(int.from_bytes(privs[i % senders], "big"),
                               int.from_bytes(h, "big") % ecdsa.N, k, rp)
        check(sig is not None, "r or s came out 0")
        hashes.append(h)
        sigs.append(sig)
        owner.append(i % senders)
        k += 1
        rp = ecdsa._add(rp, ecdsa.G)
    return pubs, hashes, sigs, owner


def malform(kind: str, h: bytes, sig: bytes, rng: random.Random):
    """One (hash, signature) of a malformed kind from a valid pair."""
    from lachain_tpu_torch.crypto import ecdsa

    if kind == "flip_s":  # still well-formed: recovers another key
        b = bytearray(sig)
        b[40] ^= 0xFF
        return h, bytes(b)
    if kind == "r_zero":
        return h, bytes(32) + sig[32:]
    if kind == "r_above_n":
        return h, (ecdsa.N + rng.randrange(1, 1 << 64)).to_bytes(32, "big") + sig[32:]
    if kind == "v_four":
        return h, sig[:64] + bytes([4])
    if kind == "non_residue":  # x^3 + 7 has no square root: the y^2 check
        r = rng.randrange(1, ecdsa.N)
        while pow((r**3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2, ecdsa.P) != ecdsa.P - 1:
            r += 1
        return h, r.to_bytes(32, "big") + sig[32:]
    if kind == "z_zero":  # u2 = 0: the G lane's digits are all zero
        return bytes(32), sig
    if kind == "short_sig":
        return h, sig[:64]
    return h[:31], sig  # short_hash


def degenerate_signature():
    """u1*R == u2*G (tests/test_psecp.py:107-123): R = kG, s = (N-z)/k, so
    the recover kernel's pairwise add meets p == q and gives Z = 0."""
    from lachain_tpu_torch.crypto import ecdsa

    k, z = 0x1234567, 0x55AA
    rp = ecdsa._mul(ecdsa.G, k)
    s = (ecdsa.N - z) * pow(k, -1, ecdsa.N) % ecdsa.N
    return (z.to_bytes(32, "big"),
            rp[0].to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([rp[1] & 1]))


def run_ecdsa_path(seed: int, dev):
    from lachain_tpu_torch.crypto import ecdsa
    from lachain_tpu_torch.ops import secp, verify
    from lachain_tpu_torch.ops.secp import GpuEcdsaRecover

    rng = random.Random(seed + 200)
    n = N_SIGNATURES
    t0 = time.perf_counter()
    pubs, hashes, sigs, owner = make_signatures(n, N_SENDERS, rng)
    bad = {}
    for j, i in enumerate(rng.sample(range(n), 4 * len(MALFORMED))):
        kind = MALFORMED[j % len(MALFORMED)]
        hashes[i], sigs[i] = malform(kind, hashes[i], sigs[i], rng)
        bad[i] = kind
    log(f"ecdsa host setup ({N_SENDERS} keys, {n} signatures, {len(bad)} "
        f"malformed): {time.perf_counter() - t0:.1f} s")

    # the launches one chunked call must make: one square root over the
    # x values that pass validation (plain words in and out, no
    # conversion launch around it); per chunk of 4096 signatures 1
    # conversion into Montgomery form (the pack), 1 table build, 1 scan, 1
    # pairwise add and 1 conversion out of it (the fetch). The signatures
    # that reach the scans: the valid ones, flip_s and z_zero.
    m = sum(GpuEcdsaRecover._validate(h, s) is not None for h, s in zip(hashes, sigs))
    check(m == RECOVER_SQRT_LANES,
          f"{m} x values reach the square root, not {RECOVER_SQRT_LANES}")
    n_jobs = sum(1 for i in range(n) if bad.get(i, "flip_s") in ("flip_s", "z_zero"))
    chunks = -(-n_jobs // GpuEcdsaRecover.CHUNK)
    want_launches = dict.fromkeys(read_launches(), 0)
    want_launches.update(secp_sqrt=1, secp_table=chunks, secp_add=chunks,
                         secp_msm_scan=chunks, secp_mont=2 * chunks)

    # the main-path run whose launches are counted
    reset_counts()
    t0 = time.perf_counter()
    got = ecdsa.recover_hash_batch(hashes, sigs, device="cuda")
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    check_no_escapes("ecdsa recover")
    check(chunks == 3, f"expected 3 chunks of the 10,000-signature batch, got {chunks}")
    check(launches == want_launches,
          f"ecdsa launches {launches} != expected {want_launches}")
    for i in range(n):
        if i not in bad:
            check(got[i] == pubs[owner[i]], f"signature {i} recovered the wrong key")
    t0 = time.perf_counter()
    for i, kind in bad.items():
        check(got[i] == ecdsa.recover_hash(hashes[i], sigs[i]),
              f"malformed {kind} at {i} differs from recover_hash")
    sample = rng.sample([i for i in range(n) if i not in bad], 64)
    for i in sample:
        check(got[i] == ecdsa.recover_hash(hashes[i], sigs[i]),
              f"signature {i} differs from recover_hash")
    kinds = {k: sum(1 for v in bad.values() if v == k) for k in MALFORMED}
    log(f"ecdsa recover of {n}: every valid signature gave its sender's key, "
        f"{len(bad)} malformed ({kinds}) and 64 valid equal recover_hash "
        f"({time.perf_counter() - t0:.1f} s); {n_jobs} on the card in {chunks} "
        f"chunks; cold {cold_s:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # the crafted collision, in a call of its own: one answer from the oracle
    dh, ds = degenerate_signature()
    reset_counts()
    one = ecdsa.recover_hash_batch([dh], [ds], device="cuda")
    check(verify.ESCAPES == dict(dict.fromkeys(verify.ESCAPES, 0), ecdsa_recover=1),
          f"collision: escapes {verify.ESCAPES}")
    check(one == [ecdsa.recover_hash(dh, ds)] and one[0] is not None,
          "collision answer differs from recover_hash")
    log(f"crafted u1*R == u2*G signature: answered by the host oracle once "
        f"(ESCAPES {verify.ESCAPES}), equal to recover_hash")

    # warm runs of the card path on the regular entries (what
    # recover_hash_batch hands GpuEcdsaRecover), with their phase split
    regular = [i for i in range(n) if len(hashes[i]) == 32 and len(sigs[i]) == 65]
    rh, rs = [hashes[i] for i in regular], [sigs[i] for i in regular]
    rec = GpuEcdsaRecover(dev)
    warm = []
    for r in range(2):
        out = rec.recover_batch(rh, rs)
        check(out == [got[i] for i in regular], "warm recover differs")
        warm.append(dict(rec.last_timings))
        log(f"ecdsa warm {r}: {rec.last_timings}")
    by_kernel = profile_launches(lambda: rec.recover_batch(rh, rs),
                                 {KERNEL_OF[k]: launches[k] for k in SECP_KERNELS},
                                 "ecdsa recover")
    busy = sum(v[0] for v in by_kernel.values())
    t = rec.last_timings
    log(f"ecdsa recover by kernel (torch.profiler, ms, launches): {by_kernel}; "
        f"busy {busy:.3f} ms of sqrt {t['sqrt_s'] * 1e3:.3f} ms + device "
        f"{t['device_s'] * 1e3:.3f} ms (profiled wall {t['wall_s']:.3f} s)")
    # the regular entries reach the card as the main-path call's did
    check_traced("ecdsa recover", by_kernel, launches, SECP_KERNELS)
    return launches, warm


# ---------------------------------------------------------------------------
# the Reed-Solomon product and the RBC flush
# ---------------------------------------------------------------------------


def rs_entry(dev, bits: int, mats, b, widths, layout: str, reps: int) -> dict:
    """One rs_matmul launch over numpy groups `mats` (put into the
    kernel's form on the host, as the flush's cache does) and columns `b`
    against its plain version on the card, bit for bit; both timed (the
    wrapper's calls by CUDA events, which include its host time, and the
    kernel's own device time from torch.profiler, `traced_ms`); the bound
    the larger of B in and C out over HBM's rate and the terms these inputs
    need (both factors nonzero) over one term a lane a clock; GF(2^8) also
    its nibble design's integer operations (7 a word of 4 products a row,
    12 a word's selectors a row block) over 64 INT32 lanes an SM."""
    import numpy as np
    import torch

    from lachain_tpu_torch.ops import _build, rs_batch

    field = rs_batch.GF8 if bits == 8 else rs_batch.gf16()
    kmats = [torch.from_numpy(rs_batch.operand(bits, m)).to(dev) for m in mats]
    kb = torch.from_numpy(b).to(dev)
    got = rs_batch.rs_matmul(bits, kmats, kb, widths).cpu().numpy().astype(np.int64)
    want, plain_ms = cuda_ms_once(lambda: rs_batch.rs_matmul_plain(bits, kmats, kb, widths))
    want = want.cpu().numpy().astype(np.int64)
    lookups, int_ops, off = 0, 0, 0
    rows_a_thread = rs_batch.geometry(_build.library(), bits)[0]
    for m, w in zip(mats, widths):
        nz_b = (b[: m.shape[1], off : off + w] != 0).sum(axis=1)
        lookups += int(((m != 0).sum(axis=0) * nz_b).sum())
        words = (off + w + 3) // 4 - off // 4 if w else 0
        int_ops += m.shape[1] * words * (7 * m.shape[0] + 12 * -(-m.shape[0] // rows_a_thread))
        off += w
    name = f"rs_matmul{bits}_kernel"
    traced = profile_launches(
        lambda: [rs_batch.rs_matmul(bits, kmats, kb, widths) for _ in range(10)],
        {name: 10}, layout)[name]
    nbytes = (b.size + got.size) * field.sym_size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lookups / LOOKUPS_PER_S * 1e3
    entry = dict(
        layout=layout, lanes=int(b.shape[1]), groups=len(mats), lookups=lookups,
        ok=bool((got == want).all()), max_abs_err=float(np.abs(got - want).max()),
        ms=cuda_ms(lambda: rs_batch.rs_matmul(bits, kmats, kb, widths), reps),
        traced_ms=traced[0] / traced[1], plain_ms=plain_ms,
        bound=(t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"),
    )
    if bits == 8:
        entry.update(int_ops=int_ops, int_bound_ms=int_ops / INT32_OPS_PER_S * 1e3)
    return entry


def check_rs_kernels(rng: random.Random, dev):
    """rs_matmul8 and rs_matmul16 at every launch shape of the RBC flushes,
    the A matrices the codec's own (Vandermonde, Gauss-Jordan inverses), B
    random symbols. GF(2^8): the N=64 re-encode (the entry's numbers), the
    own proposal's encode and the grouped decode of 64 distinct inverses
    at the flush's layout (131 columns a group, words shared by two
    groups), the 10,000-tx block's re-encode, and a ragged check of
    widths 1, 7, 123 with zero rows and columns in A and B.
    GF(2^16): the N=256 re-encode (its numbers), the own proposal's encode,
    the decode of 256 distinct inverses, and a ragged check."""
    import numpy as np

    from lachain_tpu_torch.ops import rs_batch

    nprng = np.random.default_rng(rng.randrange(1 << 32))
    gf8, gf16 = rs_batch.GF8, rs_batch.gf16()

    def symbols(field, rows, cols):
        return nprng.integers(0, field.order + 1, (rows, cols)).astype(field.dtype)

    def inverses(field, n, k, count):
        patterns = set()
        while len(patterns) < count:
            patterns.add(tuple(sorted(rng.sample(range(1, n + 1), k))))
        return [rs_batch._inverse_for(field, k, xs) for xs in sorted(patterns)]

    def zero_lines(mats, b):
        mats = [m.copy() for m in mats]
        for m in mats:
            m[nprng.integers(m.shape[0])] = 0
            m[:, nprng.integers(m.shape[1])] = 0
        b = b.copy()
        b[:, ::3] = 0
        return mats, b

    v64 = rs_batch.vandermonde(gf8, 22, 64)
    inv64 = inverses(gf8, 64, 22, 64)
    ragged8 = zero_lines([v64[:9, :5], v64[:3, :5], v64[:64, :22]], symbols(gf8, 22, 1 + 7 + 123))
    checks8 = [
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 8384), [8384],
                 "N=64 re-encode (64 x 22)(22 x 8384)", 100),
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 131), [131],
                 "N=64 encode (64 x 22)(22 x 131)", 100),
        rs_entry(dev, 8, inv64, symbols(gf8, 22, 64 * 131), [131] * 64,
                 "N=64 decode, 64 groups (22 x 22)(22 x 131)", 100),
        rs_entry(dev, 8, [v64], symbols(gf8, 22, 82624), [82624],
                 "10,000-tx block re-encode (64 x 22)(22 x 82624)", 20),
        rs_entry(dev, 8, *ragged8, [1, 7, 123],
                 "ragged: widths 1, 7, 123, zero rows and columns", 20),
    ]
    v256 = rs_batch.vandermonde(gf16, 86, 256)
    inv256 = inverses(gf16, 256, 86, 256)
    checks16 = [
        rs_entry(dev, 16, [v256], symbols(gf16, 86, 1280), [1280],
                 "N=256 re-encode (256 x 86)(86 x 1280)", 100),
        rs_entry(dev, 16, [v256], symbols(gf16, 86, 5), [5],
                 "N=256 encode (256 x 86)(86 x 5)", 100),
        rs_entry(dev, 16, inv256, symbols(gf16, 86, 256 * 5), [5] * 256,
                 "N=256 decode, 256 groups (86 x 86)(86 x 5)", 50),
        rs_entry(dev, 16, *zero_lines([v256[:130, :86], inv256[0][:3, :86]],
                                      symbols(gf16, 86, 301 + 2)), [301, 2],
                 "ragged: widths 301, 2, zero rows and columns", 20),
    ]
    for c in checks8[1:] + checks16[1:]:
        report_line("rs_matmul check", c)
    for bits, checks in ((8, checks8), (16, checks16)):
        for c in checks:
            extra = (f", integer-op bound {c['int_bound_ms']:.5f} ms" if "int_bound_ms" in c
                     else "")
            log(f"rs_matmul{bits} ({c['layout']}): device time {c['traced_ms']:.4f} ms a "
                f"launch (torch.profiler), {c['lookups']} terms{extra}")
    return {
        f"rs_matmul{bits}": dict(checks[0], checks=checks[1:], ok=all(c["ok"] for c in checks))
        for bits, checks in ((8, checks8), (16, checks16))
    }


def proposal_bytes(transfers: int) -> int:
    """A proposal's TPKE ciphertext: U (48 B), W (96 B), two u32 fields,
    V's length prefix and V, the transfers each a 177-byte signed transfer
    (lachain_tpu/core/types.py:80) behind a 4-byte length."""
    return 48 + 96 + 2 * 4 + 4 + transfers * (4 + 177)


def make_rbc_era(n: int, rng: random.Random):
    """One validator's RBC work of an era at N=n: (k, own proposal, the
    slots' payloads, [(shards with erasures, root)]). Every slot has its
    own seeded payload and root and loses a seeded 0..n-k shards; slot n-2
    is equivocating (some of its first k shards from another polynomial,
    all under one root), slot n-1 has a first shard of another size."""
    from lachain_tpu_torch.crypto import hashes
    from lachain_tpu_torch.ops import rs_batch

    k = n - 2 * ((n - 1) // 3)
    size = proposal_bytes(BLOCK_TXS // n)
    own = rng.randbytes(size)
    payloads = [rng.randbytes(size) for _ in range(n)]
    coded = rs_batch.encode_batch([(p, k, n) for p in payloads + [own]], device="numpy")
    evil = coded[-1]
    slots = []
    for s, shards in enumerate(coded[:n]):
        shards = list(shards)
        if s == n - 2:
            for i in rng.sample(range(k), 3):
                shards[i] = evil[rng.randrange(n)]
        elif s == n - 1:
            shards[0] = shards[0] + bytes(rs_batch.field_for(n).sym_size)
        slots.append(shards)
    roots = hashes.merkle_roots([hashes.keccak256_batch(sh) for sh in slots])
    era = []
    for s, (shards, root) in enumerate(zip(slots, roots)):
        if s < n - 2:
            for i in rng.sample(range(n), rng.randint(0, n - k)):
                shards[i] = None
        era.append((shards, root))
    return k, own, payloads, era


def rbc_flush(device, n: int, k: int, own: bytes, era):
    """A fresh RbcEraBatcher on `device` takes the era's own encode and one
    interpolation per slot and flushes -> (batcher, encoded shards,
    verdicts)."""
    from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher

    batcher = RbcEraBatcher(device=device)
    enc, verdicts = [], [None] * len(era)
    batcher.submit_encode(0, own, k, n, enc.append)
    for s, (shards, root) in enumerate(era):
        batcher.submit_interpolate(0, shards, k, n, root,
                                   lambda v, s=s: verdicts.__setitem__(s, v))
    batcher.flush()
    return batcher, enc[0], verdicts


def run_rbc_path(seed: int, n: int, dev):
    """The RBC flush of one validator's era at N=n on the card: the
    counted cold flush, the host oracle, warm flushes, the profiler split,
    and the same flush's wall with the plain versions and the numpy
    oracle."""
    from lachain_tpu_torch.consensus.rbc_batcher import scalar_verdict
    from lachain_tpu_torch.ops import rs, rs_batch

    label = f"rbc flush N={n}"
    rng = random.Random(seed + 300 + n)
    t0 = time.perf_counter()
    k, own, payloads, era = make_rbc_era(n, rng)
    field = rs_batch.field_for(n)
    log(f"{label}: host setup ({n} slots, k={k}, GF(2^{field.bits}), proposals of "
        f"{len(own)} B): {time.perf_counter() - t0:.1f} s")
    rbc_flush(dev, n, k, own, era[:1])  # the field's tables onto the card

    # the main-path run whose launches are counted: a cold flush, every
    # erasure pattern's inverse made anew on the host
    rs_batch.clear_caches()
    reset_counts()
    batcher, enc, verdicts = rbc_flush("cuda", n, k, own, era)
    launches = read_launches()
    check_no_escapes(label)
    want_launches = dict(dict.fromkeys(launches, 0), **{f"rs_matmul{field.bits}": RBC_LAUNCHES})
    check(launches == want_launches, f"{label}: launches {launches} != {want_launches}")
    log(f"{label} cold: {phase_line(batcher.last_timings)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    t0 = time.perf_counter()
    for s, (shards, root) in enumerate(era):
        check(verdicts[s] == scalar_verdict(shards, k, root),
              f"{label}: slot {s} differs from scalar_verdict")
        check((verdicts[s] is None) == (s >= n - 2),
              f"{label}: slot {s} verdict {'None' if verdicts[s] is None else 'a payload'}")
        if s < n - 2:
            check(verdicts[s] == payloads[s], f"{label}: slot {s} payload differs")
    want_enc = (rs.encode(own, k, n) if n <= 255
                else rs_batch.encode(own, k, n, device="numpy"))
    check(enc == want_enc, f"{label}: the encode differs from the host codec")
    log(f"{label}: {n} verdicts equal scalar_verdict (None on the equivocating "
        f"and the mixed-size slot), the encode the host codec's "
        f"({time.perf_counter() - t0:.1f} s)")

    warm = []
    for r in range(2):
        b, e, v = rbc_flush("cuda", n, k, own, era)
        check(e == enc and v == verdicts, f"{label}: warm flush {r} differs")
        warm.append(dict(b.last_timings))
    best = {p: min(w[p] for w in warm) for p in warm[0]}
    log(f"{label} warm (each phase the best of 2): {phase_line(best)}")
    by_kernel = profile_launches(lambda: rbc_flush("cuda", n, k, own, era),
                                 {KERNEL_OF[k]: launches[k] for k in RS_KERNELS}, label)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} by kernel (torch.profiler, ms, launches): {by_kernel}; busy {busy:.3f} ms")
    check_traced(label, by_kernel, launches, RS_KERNELS)
    for device in ("cpu", "numpy"):
        b, e, v = rbc_flush(device, n, k, own, era)
        check(e == enc and v == verdicts, f"{label}: the {device} flush differs")
        log(f"{label} with device={device!r} (reference, no yardstick): "
            f"{phase_line(b.last_timings)}")
    return launches, [dict(w) for w in warm]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
    from lachain_tpu_torch.ops import _build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    t0 = time.perf_counter()
    host_lib = _build.host_library()
    log(f"host library: {host_lib._name} ({time.perf_counter() - t0:.1f} s)")
    attrs = _build.kernel_attrs()
    log("kernel attrs (registers, local bytes, threads per lane, block): "
        + ", ".join(f"{k} {a['regs']}/{a['local_bytes']}/{a['threads_per_lane']}/{a['block']}"
                    for k, a in attrs.items()))

    report = check_kernels(args.seed, dev)
    backend = GpuBackend(device="cuda")
    paths = {
        "tpke_era": run_tpke_path(args.seed, backend, dev),
        "coin_era": run_coin_path(args.seed, backend, dev),
        "ecdsa_recover": run_ecdsa_path(args.seed, dev),
    }
    for n in RBC_ERAS:
        paths[f"rbc_flush_{n}"] = run_rbc_path(args.seed, n, dev)
    g1_path = tuple(k for k in G1_KERNELS if k not in NO_PATH)
    needs = {
        "tpke_era": g1_path,
        "coin_era": g1_path + ("g2_add", "g2_table", "g2_msm_scan"),
        "ecdsa_recover": tuple(k for k in SECP_KERNELS if k not in NO_PATH),
        "rbc_flush_64": ("rs_matmul8",),
        "rbc_flush_256": ("rs_matmul16",),
    }
    for path, (launches, warm) in paths.items():
        missing = [k for k in needs[path] if launches[k] == 0]
        check(not missing, f"{path} never launched: {missing}")
        warm_summary(path, warm)

    sources = dict(
        {k: "g1" for k in G1_KERNELS}, **{k: "g2" for k in G2_KERNELS},
        **{k: "secp" for k in SECP_KERNELS}, **{k: "rs" for k in RS_KERNELS})
    replaces = {
        "fp_mul": "lachain_tpu/ops/pg1.py:262",
        "g1_dbl": "lachain_tpu/ops/pg1.py:253",
        "g1_add": "lachain_tpu/ops/pg1.py:257",
        # build_table's chain of _add_kernel launches (and one
        # _dbl_kernel), pg1.py:447, in one launch
        "g1_table": "lachain_tpu/ops/pg1.py:257",
        "g1_msm_scan": "lachain_tpu/ops/pg1.py:355",
        "g2_dbl": "lachain_tpu/ops/pg2.py:218",
        "g2_add": "lachain_tpu/ops/pg2.py:222",
        # build_table2's chain of _add2_kernel launches (and one
        # _dbl2_kernel), pg2.py:356, in one launch
        "g2_table": "lachain_tpu/ops/pg2.py:222",
        "g2_msm_scan": "lachain_tpu/ops/pg2.py:272",
        # psecp has no launch of its own for the field product: its _mul
        "secp_fp_mul": "lachain_tpu/ops/psecp.py:121",
        # the port's own Montgomery representation: psecp has none
        "secp_mont": "none: the port's own Montgomery form (psecp has none)",
        # the port's own conversions (pg1 has no Montgomery form), and on
        # the TPKE era the product by beta of phi(u) that pg1's era_kernel
        # launches as _mul_kernel (pl_fp_mul)
        "g1_mont": "lachain_tpu/ops/pg1.py:262",
        "secp_dbl": "lachain_tpu/ops/psecp.py:235",
        "secp_add": "lachain_tpu/ops/psecp.py:239",
        # build_table's chain of _add_kernel launches (and one
        # _dbl_kernel), psecp.py:364, in one launch
        "secp_table": "lachain_tpu/ops/psecp.py:239",
        "secp_msm_scan": "lachain_tpu/ops/psecp.py:285",
        "secp_sqrt": "lachain_tpu/ops/psecp.py:380",
        # the jitted GF matmul _mm of _device_jit (plain XLA), one launch
        # per call and field over every group
        "rs_matmul8": "lachain_tpu/ops/rs_batch.py:233",
        "rs_matmul16": "lachain_tpu/ops/rs_batch.py:233",
    }
    def numbers(r: dict) -> dict:
        return {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1]}

    kernels = []
    for k, r in report.items():
        entry = {
            "name": k, "route": "cuda",
            "source": f"lachain_tpu_torch/csrc/{sources[k]}.cu",
            "replaces": replaces[k],
            "launches": sum(launches[k] for launches, _ in paths.values()),
            "launches_by_path": {p: v[0][k] for p, v in paths.items()},
            **numbers(r), "library_ms": None, "lanes": r["lanes"],
            "pass": r["ok"], **attrs[k],
        }
        if "main" in r:  # the kernel check above, the main path's layout below
            m = r["main"]
            shape = ("layout", "lanes", "windows")
            entry.update({k: r[k] for k in shape[::2] if k in r},
                         main=dict(numbers(m), **{k: m[k] for k in shape if k in m}))
        entry.update({k: r[k] for k in ("rows", "into_ms", "into_plain_ms", "beta_ms")
                      if k in r})
        if k in RS_KERNELS:  # its shape, and the other shapes it was held at
            rs_keys = ("layout", "lookups", "traced_ms", "int_bound_ms")
            entry.update({x: r[x] for x in rs_keys if x in r},
                         checks=[dict(numbers(c), **{x: c[x] for x in rs_keys if x in c},
                                      **{"pass": c["ok"]})
                                 for c in r.get("checks", ())])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
