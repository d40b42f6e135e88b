#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (lachain_tpu_torch) on one card.

    python3 chip_smoke.py [--seed S]

Phases, each of which must pass (any failure exits non-zero):
  1. build   the CUDA kernels of lachain_tpu_torch/csrc/ (nvcc, sm_90a);
  2. kernels hold each kernel against its plain PyTorch version
             (ops/g1_ref.py) on the card, on seeded inputs at the main
             path's shapes: exact equality of coordinates mod p and flags;
  3. main    the N=64 TPKE era (64 ACS slots x 64 decryption shares) through
             GpuBackend(device="cuda").tpke_era_verify_combine, with kernel
             launch counts taken around that one call; every slot must verify
             and decrypt; a poisoned share must isolate exactly its slot; 4
             slots are held against the port's HostEraPipeline;
  4. times   per-kernel times from CUDA events, the plain versions' times,
             each kernel's bound, and the warm per-era phase times.
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

N_VALIDATORS = 64
KERNEL_LANES = 8192  # S*K*2 msm lanes of the N=64 era


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


def max_err(a, b) -> float:
    return float(max((abs(x - y) for x, y in zip(a, b)), default=0))


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
    # the work these digits need: from each lane's leading nonzero digit on,
    # 4 doublings per window and one add per later nonzero digit
    d = digits.cpu()
    nz = d != 0
    lead = torch.where(nz.any(0), nz.int().argmax(0), torch.full((n,), nwin))
    dbls = int((4 * (nwin - 1 - lead).clamp(min=0)).sum())
    adds = int(nz.sum()) - int(nz.any(0).sum())
    muls = dbls * MULS_DBL + adds * MULS_ADD
    nbytes = ktab.numel() * 4 + digits.numel() * 4 + 144 * n + n
    report["g1_msm_scan"] = dict(
        lanes=n, windows=nwin, ok=got == want and flags_ok,
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: g1.msm_scan(ktab, digits), 5),
        plain_ms=cuda_ms(lambda: g1_ref.msm_scan(rtab, digits), 1),
        bound=bound(nbytes, muls * OPS_PER_FIELD_MUL),
    )
    for name, r in report.items():
        log(f"kernel {name}: lanes={r['lanes']} ok={r['ok']} "
            f"max_abs_err={r['max_abs_err']} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound'][0]:.5f} "
            f"({r['bound'][1]})")
    bad = [name for name, r in report.items() if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
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
    torch.profiler; device work that is not one of the four kernels (copies,
    cat, where) is summed under "torch"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = ("fp_mul_kernel", "dbl_kernel", "add_kernel", "msm_scan_kernel")
    out: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t <= 0:
            continue
        name = next((k for k in names if f"::{k}(" in e.key), "torch")
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += t / 1e3
        acc[1] += e.count
    return out


def run_main_path(seed: int, g1):
    from lachain_tpu_torch.crypto import bls12381 as bls
    from lachain_tpu_torch.crypto import tpke
    from lachain_tpu_torch.crypto.gpu_backend import EraSlotJob, GpuBackend
    from lachain_tpu_torch.ops.verify import GpuEraPipeline, HostEraPipeline

    n = N_VALIDATORS
    t0 = time.perf_counter()
    dealer, cts, msgs, jobs = make_era(n, seed)
    log(f"host setup (dealer, {n} ciphertexts, {n * n} shares): "
        f"{time.perf_counter() - t0:.1f} s")
    vks = dealer.verification_keys
    backend = GpuBackend(device="cuda")

    def check_all(res, bad=()):
        for s, (ok, comb) in enumerate(res):
            if s in bad:
                check(ok is False and comb is None, f"slot {s} not isolated")
            else:
                check(ok, f"slot {s} failed verification")
                check(tpke.decrypt_with_combined(cts[s], comb) == msgs[s],
                      f"slot {s} plaintext not recovered")

    # the main-path run whose launches are counted
    g1.reset_launches()
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(jobs, vks, SeededRng(seed + 1))
    cold_s = time.perf_counter() - t0
    launches = dict(g1.LAUNCHES)
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
    pipeline = GpuEraPipeline(device="cuda")
    pipeline.run_era(slots, y_points, SeededRng(seed + 4))
    by_kernel = profile_device(
        lambda: pipeline.run_era(slots, y_points, SeededRng(seed + 4)))
    busy = sum(v[0] for v in by_kernel.values())
    log(f"device phase by kernel (torch.profiler, ms, launches): {by_kernel}; "
        f"busy {busy:.3f} ms of device phase {pipeline.last_timings['device_s'] * 1e3:.3f} ms")

    # 4 slots against the host oracle pipeline, same seeded rng
    slots = slots[:4]
    dev_out, dev_rlc = GpuEraPipeline(device="cuda").run_era(
        slots, y_points, SeededRng(seed + 5))
    host_out, host_rlc = HostEraPipeline().run_era(
        slots, y_points, SeededRng(seed + 5))
    check(dev_rlc == host_rlc, "rlc draws differ")
    for s, (a, b) in enumerate(zip(dev_out, host_out)):
        for x, y in zip(a, b):
            check(bls.g1_eq(x, y), f"slot {s} aggregate differs from host")
    log("4 slots equal to HostEraPipeline (u_agg, y_agg, combined, rlc)")
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
    from lachain_tpu_torch.ops import _build, g1

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds})")
    log(f"kernel attrs (regs, local bytes): {_build.kernel_attrs()}")

    report = check_kernels(args.seed, dev)
    launches, warm = run_main_path(args.seed, g1)

    missing = [k for k, v in launches.items() if v == 0]
    check(not missing, f"main path never launched: {missing}")
    best = min(warm, key=lambda w: w["wall_s"])
    log(f"warm era (best of {len(warm)}): pack {best['pack_s'] * 1e3:.2f} ms, "
        f"device {best['device_s'] * 1e3:.2f} ms, fetch {best['fetch_s'] * 1e3:.2f} ms, "
        f"host pairing {best['pairing_s']:.3f} s, wall {best['wall_s']:.3f} s")

    replaces = {
        "fp_mul": "lachain_tpu/ops/pg1.py:262",
        "g1_dbl": "lachain_tpu/ops/pg1.py:253",
        "g1_add": "lachain_tpu/ops/pg1.py:257",
        "g1_msm_scan": "lachain_tpu/ops/pg1.py:355",
    }
    kernels = [
        {
            "name": k, "route": "cuda", "source": "lachain_tpu_torch/csrc/g1.cu",
            "replaces": replaces[k], "launches": launches[k],
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
