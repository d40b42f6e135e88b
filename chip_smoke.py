#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (lachain_tpu_torch) on one card.

    python3 chip_smoke.py [--seed S]

Phases, each of which must pass (any failure exits non-zero):
  1. build   the CUDA kernels of lachain_tpu_torch/csrc/ (g1.cu, g2.cu and
             secp.cu, one nvcc each, in parallel, sm_90a), with each
             kernel's registers, local bytes, threads per lane and block;
  2. kernels hold each of the fifteen kernels against its plain PyTorch
             version (ops/g1_ref.py, ops/g2_ref.py, ops/secp_ref.py) on the
             card, on seeded inputs at the main paths' shapes (8192 lanes,
             the adds with a p == q lane; the G2 and secp scans with 64
             windows; the three table builds at their main path's lanes:
             the TPKE era's 16,384 joined lanes [u | y | u | phi(u)], the
             coin era's 4096 signature lanes, 22 live of each 64 and the
             others infinity, and one 4096-signature recovery chunk's 8192
             lanes [R_i, G], each table's entries 1, 2, 3 and 15 also held
             against the host's scalar multiples; the secp square root at
             16384 lanes): exact equality of coordinates mod p and flags.
             The three scans run twice: at the main path's layout (the TPKE
             era's joined scan, 32 windows x 16,384 lanes; the coin era's
             scan, 48 leading zero windows on its RLC half and 22 live
             lanes of 64; one 4096-signature recovery chunk, [R_i, G]
             interleaved), over the tables built there, and at a
             random-digit kernel check (32 / 64 windows of random digits x
             8192 lanes). Every kernel's numbers in the kernels JSON are
             those of its kernel check, the shape the earlier slices
             reported; each scan's entry also holds a `main` object, its
             numbers at the main path's layout;
  3. main    three paths, each with the kernel launch counts set to 0 just
             before its one counted call and read just after:
             the N=64 TPKE era (64 ACS slots x 64 decryption shares) through
             GpuBackend(device="cuda").tpke_era_verify_combine: every slot
             must verify and decrypt, with exactly 1 G1 table build, 1 G1
             scan, 6 tree adds and no doubling; a poisoned share must
             isolate exactly its slot, 4 slots are held against the port's
             HostEraPipeline;
             the N=64 coin era (64 coins x 64 signers, 22 live shares each)
             through threshold_sig.era_verify_combine on the same backend:
             every signature must verify under the shared key with the host
             combine's parity, with exactly 1 G2 table build, 1 G2 scan, 12
             G2 adds and no G2 doubling (and the key RLC's 1 G1 table
             build, 1 G1 scan and 6 adds), a poisoned share must isolate exactly
             its coin, 4 coins are held against TsHostEraPipeline, and one
             device g1_msm and one g2_msm at n=100 against the host MSM;
             pool-ingest ECDSA recovery of 10,000 signatures from 64 senders
             (32 of them malformed) through
             ecdsa.recover_hash_batch(..., device="cuda"): every valid
             signature must recover its sender's key, every malformed one
             and 64 valid ones must equal ecdsa.recover_hash, the launches
             must be exactly one square root and, per 4096-signature chunk,
             1 table build, 1 scan and 1 pair add (no doubling); a crafted
             u1*R == u2*G
             signature, in a call of its own, must be answered by the host
             oracle exactly once. Around each counted call and the MSMs, no
             result may have been recomputed on the host
             (ops/verify.ESCAPES), and each path must launch its kernels;
  4. times   per-kernel times from CUDA events, the plain versions' times,
             each kernel's bound, the warm phase times of every path and a
             torch.profiler split of each device phase by kernel, whose
             traced launches of each path's kernels must equal the counted
             ones.
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

N_VALIDATORS = 64
KERNEL_LANES = 8192  # S*K*2 msm lanes of the N=64 eras
COIN_LANES = 4096  # the coin era's signature lanes: 64 coins x 64 signers
LIVE = 22  # t + 1 of the N=64 eras: the combined shares of a coin
SQRT_LANES = 16384  # the 10,000-signature batch padded to a power of two
N_SIGNATURES = 10000
N_SENDERS = 64
KERNEL_NAMES = ("fp_mul_kernel", "dbl_kernel", "add_kernel", "msm_scan_kernel",
                "g1_table_kernel",
                "g2_dbl_kernel", "g2_add_kernel", "g2_msm_scan_kernel",
                "g2_table_kernel",
                "secp_fp_mul_kernel", "secp_dbl_kernel", "secp_add_kernel",
                "secp_msm_scan_kernel", "secp_sqrt_kernel", "secp_table_kernel")
G1_KERNELS = ("fp_mul", "g1_dbl", "g1_add", "g1_table", "g1_msm_scan")
# the wrapper's kernel name -> the CUDA kernel's
KERNEL_OF = {"fp_mul": "fp_mul_kernel", "g1_dbl": "dbl_kernel",
             "g1_add": "add_kernel", "g1_msm_scan": "msm_scan_kernel"}
KERNEL_OF.update({k: f"{k}_kernel" for k in ("g1_table", "g2_dbl", "g2_add",
                                              "g2_msm_scan", "g2_table",
                                              "secp_fp_mul", "secp_dbl", "secp_add",
                                              "secp_table", "secp_msm_scan",
                                              "secp_sqrt")})
# the TPKE era's counted call: one table build over the joined lanes (one
# launch), one scan, a tree reduce of log2(64) = 6 adds
TPKE_LAUNCHES = {"g1_msm_scan": 1, "g1_table": 1, "g1_dbl": 0, "g1_add": 6}
# the coin era's counted call: one G2 table build (one launch) and one
# G2 scan over [table | table], two G2 tree reduces of 6 adds; the key RLC
# as one G1 table build, scan and tree reduce
COIN_LAUNCHES = dict(TPKE_LAUNCHES, g2_table=1, g2_msm_scan=1, g2_add=12,
                     g2_dbl=0)
G2_KERNELS = ("g2_dbl", "g2_add", "g2_table", "g2_msm_scan")
SECP_KERNELS = ("secp_fp_mul", "secp_dbl", "secp_add", "secp_table",
                "secp_msm_scan", "secp_sqrt")
# the one-thread doublings serve no main path since each table build is
# one launch
NO_PATH = ("g1_dbl", "g2_dbl", "secp_dbl")


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
    report.update(check_g2_kernels(rng, dev))
    report.update(check_secp_kernels(rng, dev))
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
    """The six secp256k1 kernels against secp_ref at the recover path's
    shapes: 8192 lanes (one 4096-signature chunk), the table build at a
    chunk's [R_i, G] lanes, the scan with 64 windows of random digits and at
    the chunk's layout, the square root at 16384 lanes."""
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

    # (12) secp_sqrt at 16384 lanes: random x (about half non-residues),
    # G's x among them
    m = SQRT_LANES
    xs = [ecdsa.GX] + [rng.randrange(P) for _ in range(m - 1)]
    kx, rx = secp.fe_encode(xs, dev), ref_fe(xs)
    got = secp.fe_decode(secp.sqrt(kx))
    want, plain_ms = cuda_ms_once(lambda: secp_ref.sqrt(rx))
    want = secp_ref.limbs_to_ints(want.cpu().numpy())
    check(want[0] in (ecdsa.GY, P - ecdsa.GY), "secp_ref.sqrt wrong at G")
    for i in range(1, m, 4099):
        check(want[i] == pow((xs[i] ** 3 + 7) % P, (P + 1) // 4, P),
              "secp_ref.sqrt wrong")
    # x^2, x^3, then one square per exponent bit below the top one and one
    # product per set bit among them
    muls = 2 + len(secp_ref.SQRT_STEPS) + sum(secp_ref.SQRT_STEPS)
    report["secp_sqrt"] = dict(
        lanes=m, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: secp.sqrt(kx), 20),
        plain_ms=plain_ms,
        bound=bound(2 * 32 * m, m * muls * OPS_PER_SECP_MUL),
    )
    return report


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
    torch.profiler; device work that is not one of the fifteen kernels
    (copies, cat, where) is summed under "torch". A trace loses the first
    device activities of its session (a trace of the recover path lacked
    its first three launches), so run() goes once under the profiler's
    warm-up step, whose events are dropped, and once under its active
    step, which is what is summed. The step's own span ("ProfilerStep*")
    covers the whole call and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    out: dict = {}
    for e in traced[0]:
        t = getattr(e, "self_device_time_total", 0) or 0
        if t <= 0 or e.key.startswith("ProfilerStep"):
            continue
        name = kernel_of(e.key)
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t / 1e3
        acc[1] += e.count
    return out


def kernel_of(key: str) -> str:
    """The kernel of a profiler key, templated or not
    ("(anonymous namespace)::msm_scan_kernel<4>(...)" -> "msm_scan_kernel"),
    or "torch" for device work that is none of the fifteen."""
    m = re.search(r"::(\w+)[<(]", key)
    return m[1] if m and m[1] in KERNEL_NAMES else "torch"


def check_traced(label: str, by_kernel: dict, launches: dict, names) -> None:
    """Fail unless the profiled run traced as many launches of each of
    `names` as the counted main-path run made."""
    traced = {k: by_kernel.get(KERNEL_OF[k], [0, 0])[1] for k in names}
    counted = {k: launches[k] for k in names}
    check(traced == counted, f"{label}: traced launches {traced} != counted {counted}")
    log(f"{label}: traced launches equal the counted ones {counted}")


def reset_counts() -> None:
    """Set every kernel's launch count and every host recompute count to 0."""
    from lachain_tpu_torch.ops import g1, g2, secp, verify

    g1.reset_launches()
    g2.reset_launches()
    secp.reset_launches()
    verify.reset_escapes()


def read_launches() -> dict:
    from lachain_tpu_torch.ops import g1, g2, secp

    return dict(g1.LAUNCHES, **g2.LAUNCHES, **secp.LAUNCHES)


def check_no_escapes(label: str) -> None:
    """Fail if a result the card returned as infinity was recomputed on the
    host since the last reset_counts(): every answer must come from the
    kernels."""
    from lachain_tpu_torch.ops import verify

    check(not any(verify.ESCAPES.values()),
          f"{label}: host recomputes {verify.ESCAPES}")


def warm_summary(label: str, warm) -> None:
    """The phases of the warm run with the least wall time, in ms."""
    best = min(warm, key=lambda w: w["wall_s"])
    phases = ", ".join(f"{k[:-2]} {v * 1e3:.2f} ms" for k, v in best.items())
    log(f"{label} warm (best of {len(warm)}): {phases}")


def profile_phase(label: str, pipeline, run) -> dict:
    """Warm the pipeline, then split one device phase by kernel."""
    run()
    by_kernel = profile_device(run)
    busy = sum(v[0] for v in by_kernel.values())
    log(f"{label} device phase by kernel (torch.profiler, ms, launches): "
        f"{by_kernel}; busy {busy:.3f} ms of device phase "
        f"{pipeline.last_timings['device_s'] * 1e3:.3f} ms")
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
        log(f"era warm {r}: wall {wall:.4f} s, phases {backend.last_timings}")

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
    pipeline = GpuEraPipeline(device=dev)
    by_kernel = profile_phase("era", pipeline, lambda: pipeline.run_era(
        slots, y_points, SeededRng(seed + 4)))
    check_traced("era", by_kernel, launches, tuple(TPKE_LAUNCHES))

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
        log(f"coin era warm {r}: wall {wall:.4f} s, phases {backend.last_timings}")

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
    pipeline = TsGpuEraPipeline(device=dev)
    by_kernel = profile_phase("coin era", pipeline, lambda: pipeline.run_era(
        rows, y_points, SeededRng(seed + 14), masks=masks))
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
    # padded batch; per chunk of 4096 signatures 1 table build, 1 scan and
    # 1 pairwise add; conversions into and out of Montgomery form around
    # the square root and around each chunk. The signatures that reach the
    # scans: the valid ones, flip_s and z_zero.
    n_jobs = sum(1 for i in range(n) if bad.get(i, "flip_s") in ("flip_s", "z_zero"))
    chunks = -(-n_jobs // GpuEcdsaRecover.CHUNK)
    want_launches = dict.fromkeys(read_launches(), 0)
    want_launches.update(secp_sqrt=1, secp_table=chunks, secp_add=chunks,
                         secp_msm_scan=chunks, secp_fp_mul=2 + 2 * chunks)

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
    by_kernel = profile_device(lambda: rec.recover_batch(rh, rs))
    busy = sum(v[0] for v in by_kernel.values())
    t = rec.last_timings
    log(f"ecdsa recover by kernel (torch.profiler, ms, launches): {by_kernel}; "
        f"busy {busy:.3f} ms of sqrt {t['sqrt_s'] * 1e3:.3f} ms + device "
        f"{t['device_s'] * 1e3:.3f} ms (profiled wall {t['wall_s']:.3f} s)")
    # the regular entries reach the card as the main-path call's did
    check_traced("ecdsa recover", by_kernel, launches, SECP_KERNELS)
    return launches, warm


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
    g1_path = tuple(k for k in G1_KERNELS if k not in NO_PATH)
    needs = {
        "tpke_era": g1_path,
        "coin_era": g1_path + ("g2_add", "g2_table", "g2_msm_scan"),
        "ecdsa_recover": tuple(k for k in SECP_KERNELS if k not in NO_PATH),
    }
    for path, (launches, warm) in paths.items():
        missing = [k for k in needs[path] if launches[k] == 0]
        check(not missing, f"{path} never launched: {missing}")
        warm_summary(path, warm)

    sources = dict(
        {k: "g1" for k in G1_KERNELS}, **{k: "g2" for k in G2_KERNELS},
        **{k: "secp" for k in SECP_KERNELS})
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
        "secp_dbl": "lachain_tpu/ops/psecp.py:235",
        "secp_add": "lachain_tpu/ops/psecp.py:239",
        # build_table's chain of _add_kernel launches (and one
        # _dbl_kernel), psecp.py:364, in one launch
        "secp_table": "lachain_tpu/ops/psecp.py:239",
        "secp_msm_scan": "lachain_tpu/ops/psecp.py:285",
        "secp_sqrt": "lachain_tpu/ops/psecp.py:380",
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
        if "main" in r:  # the scans: the kernel check above, the main path below
            m = r["main"]
            entry.update(layout=r["layout"], windows=r["windows"],
                         main=dict(numbers(m), layout=m["layout"],
                                   lanes=m["lanes"], windows=m["windows"]))
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
