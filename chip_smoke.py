#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (lachain_tpu_torch) on one card.

    python3 chip_smoke.py [--seed S]

Phases, each of which must pass (any failure exits non-zero):
  1. build   the CUDA kernels of lachain_tpu_torch/csrc/ (g1.cu and g2.cu,
             nvcc, sm_90a), with each kernel's registers and local bytes;
  2. kernels hold each of the seven kernels against its plain PyTorch
             version (ops/g1_ref.py, ops/g2_ref.py) on the card, on seeded
             inputs at the main paths' shapes (8192 lanes; the G2 scan with
             64 windows): exact equality of coordinates mod p and flags;
  3. main    two paths, each with the kernel launch counts set to 0 just
             before its one counted call and read just after:
             the N=64 TPKE era (64 ACS slots x 64 decryption shares) through
             GpuBackend(device="cuda").tpke_era_verify_combine: every slot
             must verify and decrypt, a poisoned share must isolate exactly
             its slot, 4 slots are held against the port's HostEraPipeline;
             the N=64 coin era (64 coins x 64 signers, 22 live shares each)
             through threshold_sig.era_verify_combine on the same backend:
             every signature must verify under the shared key with the host
             combine's parity, a poisoned share must isolate exactly its
             coin, 4 coins are held against TsHostEraPipeline, and one device
             g1_msm and one g2_msm at n=100 against the host MSM. Around each
             counted era and the MSMs, no result may have been recomputed on
             the host (ops/verify.ESCAPES), and the MSMs must launch the
             kernels;
  4. times   per-kernel times from CUDA events, the plain versions' times,
             each kernel's bound, the warm per-era phase times of both paths
             and a torch.profiler split of each device phase by kernel.
The last three lines of standard output are the kernels JSON, the card's
name and power limit, and {"ok": true, "device": {...}}.

Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import random
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

N_VALIDATORS = 64
KERNEL_LANES = 8192  # S*K*2 msm lanes of the N=64 eras
KERNEL_NAMES = ("fp_mul_kernel", "dbl_kernel", "add_kernel", "msm_scan_kernel",
                "g2_dbl_kernel", "g2_add_kernel", "g2_msm_scan_kernel")


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


def point_run(n: int, rng: random.Random, bls):
    """n distinct points P0 + i*S in Jacobian form (chained host adds)."""
    p = bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
    step = bls.g1_mul(bls.G1_GEN, rng.randrange(1, bls.R))
    out = []
    for _ in range(n):
        out.append(p)
        p = bls.g1_add(p, step)
    return out


def point_run2(n: int, rng: random.Random, bls):
    """n distinct G2 points P0 + i*S in Jacobian form (chained host adds)."""
    p = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    step = bls.g2_mul(bls.G2_GEN, rng.randrange(1, bls.R))
    out = []
    for _ in range(n):
        out.append(p)
        p = bls.g2_add(p, step)
    return out


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
    log(f"kernel {name}: lanes={r['lanes']} ok={r['ok']} "
        f"max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound'][0]:.5f} "
        f"({r['bound'][1]})")


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

    # (2) g1_dbl and (3) g1_add on n Jacobian points (Z != 1)
    ps = point_run(n, rng, bls)
    qs = point_run(n, rng, bls)
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
    for i in range(0, n, 997):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_add(ps[i], qs[i])), "g1_ref.add wrong")
    report["g1_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.g1_add(kp, kq), 100),
        plain_ms=cuda_ms(lambda: g1_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 144 * n, n * MULS_ADD * OPS_PER_FIELD_MUL),
    )

    # (4) msm_scan: 32 windows over a host-built table k*P; every 61st lane
    # has all-zero digits and must come back flagged
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
    acc, fl = g1.msm_scan(ktab, digits)
    racc, rfl = g1_ref.msm_scan(rtab, digits)
    got = g1.g1_coords(acc)
    want = g1.g1_coords(racc.cpu())
    flags_ok = bool(torch.equal(fl.cpu(), rfl.cpu()))
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, 3, n // 2):
        pt = (want[i], want[n + i], want[2 * n + i])
        check(bls.g1_eq(pt, bls.g1_mul(ps[i], scalars[i])), "g1_ref.msm wrong")
    muls = scan_products(digits, MULS_DBL, MULS_ADD)
    nbytes = ktab.numel() * 4 + digits.numel() * 4 + 144 * n + n
    report["g1_msm_scan"] = dict(
        lanes=n, windows=nwin, ok=got == want and flags_ok,
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.msm_scan(ktab, digits), 5),
        plain_ms=cuda_ms(lambda: g1_ref.msm_scan(rtab, digits), 1),
        bound=bound(nbytes, muls * OPS_PER_FIELD_MUL),
    )
    report.update(check_g2_kernels(rng, dev))
    for name, r in report.items():
        report_line(name, r)
    bad = [name for name, r in report.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return report


def check_g2_kernels(rng: random.Random, dev):
    """The three G2 kernels against g2_ref at 8192 lanes; the scan with 64
    windows of random digits (the coin era's Lagrange pass)."""
    import torch

    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.ops import g2, g2_ref, glv

    n = KERNEL_LANES
    report = {}

    def ref_pts(points):
        return torch.from_numpy(g2_ref.points_to_limbs(points)).to(dev)

    def lanes_of(coords, i):
        return tuple((coords[j * n + i], coords[(j + 1) * n + i]) for j in (0, 2, 4))

    # (5) g2_dbl and (6) g2_add on n Jacobian points (Z != 1)
    ps = point_run2(n, rng, bls)
    qs = point_run2(n, rng, bls)
    kp, kq = g2.g2_pack(ps, dev), g2.g2_pack(qs, dev)
    rp, rq = ref_pts(ps), ref_pts(qs)
    got = g2.g2_coords(g2.g2_dbl(kp))
    want = g2.g2_coords(g2_ref.dbl(rp).cpu())
    for i in range(0, n, 997):
        check(bls.g2_eq(lanes_of(want, i), bls.g2_dbl(ps[i])), "g2_ref.dbl wrong")
    report["g2_dbl"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_dbl(kp), 50),
        plain_ms=cuda_ms(lambda: g2_ref.dbl(rp), 3),
        bound=bound(2 * 288 * n, n * MULS_DBL2 * OPS_PER_FIELD_MUL),
    )
    got = g2.g2_coords(g2.g2_add(kp, kq))
    want = g2.g2_coords(g2_ref.add_incomplete(rp, rq).cpu())
    for i in range(0, n, 997):
        check(bls.g2_eq(lanes_of(want, i), bls.g2_add(ps[i], qs[i])),
              "g2_ref.add wrong")
    report["g2_add"] = dict(
        lanes=n, ok=got == want, max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.g2_add(kp, kq), 50),
        plain_ms=cuda_ms(lambda: g2_ref.add_incomplete(rp, rq), 3),
        bound=bound(3 * 288 * n, n * MULS_ADD2 * OPS_PER_FIELD_MUL),
    )

    # (7) g2_msm_scan: 64 windows over a host-built table k*P; every 61st
    # lane has all-zero digits and must come back flagged
    nwin = 64
    table_pts = [[bls.G2_INF] * n, ps]
    for _ in range(glv.TABLE - 2):
        table_pts.append([bls.g2_add(a, b) for a, b in zip(table_pts[-1], ps)])
    ktab = torch.stack([g2.g2_pack(row, dev) for row in table_pts])
    rtab = torch.stack([ref_pts(row) for row in table_pts])
    del table_pts
    scalars = [rng.randrange(1 << 256) for _ in range(n)]
    for i in range(0, n, 61):
        scalars[i] = 0
    scalars[1] = 5  # leading zero windows, then one nonzero digit
    digits = torch.from_numpy(glv.digits_col(scalars, nwin)).to(dev)
    acc, fl = g2.msm2_scan(ktab, digits)
    (racc, rfl), plain_ms = cuda_ms_once(lambda: g2_ref.msm_scan(rtab, digits))
    got = g2.g2_coords(acc)
    want = g2.g2_coords(racc.cpu())
    flags_ok = bool(torch.equal(fl.cpu(), rfl.cpu()))
    check(bool(rfl[0]) and not bool(rfl[1]), "zero-digit lane flags wrong")
    for i in (1, 2, n // 2):
        check(bls.g2_eq(lanes_of(want, i), bls.g2_mul(ps[i], scalars[i])),
              "g2_ref.msm wrong")
    del racc, rtab
    muls = scan_products(digits, MULS_DBL2, MULS_ADD2)
    nbytes = ktab.numel() * 4 + digits.numel() * 4 + 288 * n + n
    report["g2_msm_scan"] = dict(
        lanes=n, windows=nwin, ok=got == want and flags_ok,
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g2.msm2_scan(ktab, digits), 3),
        plain_ms=plain_ms,
        bound=bound(nbytes, muls * OPS_PER_FIELD_MUL),
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
    torch.profiler; device work that is not one of the seven kernels
    (copies, cat, where) is summed under "torch"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t <= 0:
            continue
        name = next((k for k in KERNEL_NAMES if f"::{k}(" in e.key), "torch")
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t / 1e3
        acc[1] += e.count
    return out


def reset_counts() -> None:
    """Set every kernel's launch count and every host recompute count to 0."""
    from lachain_tpu_torch.ops import g1, g2, verify

    g1.reset_launches()
    g2.reset_launches()
    verify.reset_escapes()


def read_launches() -> dict:
    from lachain_tpu_torch.ops import g1, g2

    return dict(g1.LAUNCHES, **g2.LAUNCHES)


def check_no_escapes(label: str) -> None:
    """Fail if a result the card returned as infinity was recomputed on the
    host since the last reset_counts(): every answer must come from the
    kernels."""
    from lachain_tpu_torch.ops import verify

    check(not any(verify.ESCAPES.values()),
          f"{label}: host recomputes {verify.ESCAPES}")


def warm_summary(label: str, warm) -> None:
    best = min(warm, key=lambda w: w["wall_s"])
    log(f"{label} warm (best of {len(warm)}): pack {best['pack_s'] * 1e3:.2f} ms, "
        f"device {best['device_s'] * 1e3:.2f} ms, fetch {best['fetch_s'] * 1e3:.2f} ms, "
        f"host pairing {best['pairing_s']:.3f} s, wall {best['wall_s']:.3f} s")


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
    profile_phase("era", pipeline,
                  lambda: pipeline.run_era(slots, y_points, SeededRng(seed + 4)))

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
    profile_phase("coin era", pipeline, lambda: pipeline.run_era(
        rows, y_points, SeededRng(seed + 14), masks=masks))

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
    idle = [k for k in ("g1_dbl", "g1_add", "g1_msm_scan", "g2_dbl", "g2_add",
                        "g2_msm_scan") if msm_launches[k] == 0]
    check(not idle, f"device MSMs never launched: {idle}")
    check(bls.g2_eq(got2, host.g2_msm(g2_pts, scalars)), "device g2_msm != host")
    check(bls.g1_eq(got1, host.g1_msm(g1_pts, scalars)), "device g1_msm != host")
    log(f"device g2_msm and g1_msm at n={len(g2_pts)} equal the host MSM, "
        f"no host recompute ({dev_s:.3f} s); launches {msm_launches}")
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
    log(f"kernel attrs (regs, local bytes): {_build.kernel_attrs()}")

    report = check_kernels(args.seed, dev)
    backend = GpuBackend(device="cuda")
    paths = {
        "tpke_era": run_tpke_path(args.seed, backend, dev),
        "coin_era": run_coin_path(args.seed, backend, dev),
    }
    needs = {
        "tpke_era": ("fp_mul", "g1_dbl", "g1_add", "g1_msm_scan"),
        "coin_era": tuple(report),
    }
    for path, (launches, warm) in paths.items():
        missing = [k for k in needs[path] if launches[k] == 0]
        check(not missing, f"{path} never launched: {missing}")
        warm_summary(path, warm)

    sources = {"fp_mul": "g1", "g1_dbl": "g1", "g1_add": "g1",
               "g1_msm_scan": "g1", "g2_dbl": "g2", "g2_add": "g2",
               "g2_msm_scan": "g2"}
    replaces = {
        "fp_mul": "lachain_tpu/ops/pg1.py:262",
        "g1_dbl": "lachain_tpu/ops/pg1.py:253",
        "g1_add": "lachain_tpu/ops/pg1.py:257",
        "g1_msm_scan": "lachain_tpu/ops/pg1.py:355",
        "g2_dbl": "lachain_tpu/ops/pg2.py:218",
        "g2_add": "lachain_tpu/ops/pg2.py:222",
        "g2_msm_scan": "lachain_tpu/ops/pg2.py:272",
    }
    kernels = [
        {
            "name": k, "route": "cuda",
            "source": f"lachain_tpu_torch/csrc/{sources[k]}.cu",
            "replaces": replaces[k],
            "launches": sum(launches[k] for launches, _ in paths.values()),
            "launches_by_path": {p: v[0][k] for p, v in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None, "lanes": r["lanes"],
            "pass": r["ok"],
        }
        for k, r in report.items()
    ]
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
