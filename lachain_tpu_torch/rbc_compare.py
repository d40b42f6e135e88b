"""Warm RBC flushes, TPKE eras or root eras of this tree beside earlier
checkouts, on one card.

    python3 -m lachain_tpu_torch.rbc_compare --baseline DIR [--baseline DIR]
        [--path rbc|tpke|root] [--eras 64 256] [--flushes 20] [--seed 1]
        [--out FILE]

With `--path rbc` (the default) each tree runs `chip_smoke.py`'s own RBC
era (`make_rbc_era`, `rbc_flush`: one validator's era at N=n, the same
seed, so the same payloads and erasures) in a process of its own, with its
own `lachain_tpu_torch` and kernels: one cold flush (the inverses, the
tables, the kernels' first use), then `--flushes` warm ones whose phases
(`RbcEraBatcher.last_timings`: pack, device, fetch, recheck ...) are kept
in ms. With `--path tpke` each tree runs `chip_smoke.py`'s TPKE era
(`make_era` at N=n, the same seed) through `GpuBackend()`'s
`tpke_era_verify_combine`: one cold era and 4 more that warm both of the
pipeline's streams, then `--flushes` warm eras whose phases
(`GpuBackend.last_timings`: pack, launch, device, wait, fetch, pairing)
and wall are kept in ms; every slot must verify. With `--path root` each
tree runs `chip_smoke.py`'s N=64 root era (`root_era_inputs`, TAKE_FIRST,
both batchers; give `--eras 64`, whose value is not read) on the native
engine once to warm, then on the Python engine and on the native engine
`--flushes` times each, outside torch.profiler: `python_wall` and
`native_wall` in ms (`root_run`'s wall), every run's block hash and
delivered_count the same; a tree with `lachain_tpu_torch/utils/tracing.py`
runs each era in an "era" span with chip_smoke's TRACE_CAPACITY rings, as
chip_smoke.py's root eras run, and adds `python_report` and
`native_report`, the era report's ms. The trees take turns,
the baselines, this tree, this tree and the baselines again, so that a
drift of the card or its host shows as a gap between a tree's two runs.
A DIR is an unpacked earlier checkout (`git archive <commit>
lachain_tpu_torch chip_smoke.py | tar -x -C DIR`); it builds its kernels
into its own `_build/` on its first run. Prints the card, one line per run,
and a JSON report of every run's phases, their medians and minima.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# one tree's runs: argv root, n, flushes, seed -> one JSON line
_CHILD = r"""
import json, random, sys
root, n, flushes, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, root)
import chip_smoke
from lachain_tpu_torch.ops import rs_batch
assert rs_batch.__file__.startswith(root), rs_batch.__file__
k, own, _payloads, era = chip_smoke.make_rbc_era(n, random.Random(seed + 300 + n))
_b, enc, verdicts = chip_smoke.rbc_flush("cuda", n, k, own, era)
phases = {}
for _ in range(flushes):
    b, e, v = chip_smoke.rbc_flush("cuda", n, k, own, era)
    assert e == enc and v == verdicts
    for p, s in b.last_timings.items():
        phases.setdefault(p, []).append(s * 1e3)
print(json.dumps(phases))
"""

_TPKE_CHILD = r"""
import json, sys, time
root, n, eras, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, root)
import chip_smoke
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.ops import verify
assert verify.__file__.startswith(root), verify.__file__
dealer, _cts, _msgs, jobs = chip_smoke.make_era(n, seed)
vks = dealer.verification_keys
backend = GpuBackend()
phases = {}
for i in range(5 + eras):
    t0 = time.perf_counter()
    res = backend.tpke_era_verify_combine(jobs, vks, chip_smoke.SeededRng(seed + 1 + i))
    wall = time.perf_counter() - t0
    assert all(ok for ok, _ in res), "a slot failed verification"
    if i >= 5:
        for p, s in dict(backend.last_timings, wall_s=wall).items():
            phases.setdefault(p, []).append(s * 1e3)
print(json.dumps(phases))
"""

_ROOT_CHILD = r"""
import contextlib, json, sys, time
root, _n, runs, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, root)
import chip_smoke
from lachain_tpu_torch.consensus.simulator import DeliveryMode, SimulatedNetwork
from lachain_tpu_torch.ops import verify
assert verify.__file__.startswith(root), verify.__file__
try:
    from lachain_tpu_torch.utils import tracing
except ImportError:  # a tree before the tracer
    tracing = None
pub, privs, proposals, _signer, parent = chip_smoke.root_era_inputs(seed)
phases, seen = {}, set()


def era(engine):
    chip_smoke.clear_block_memos()
    if tracing is not None:
        tracing.reset_for_tests()
        tracing.set_capacity(chip_smoke.TRACE_CAPACITY)
    if engine == "native":
        net, _p = chip_smoke.native_root_net(pub, privs, proposals, "cuda", parent, seed,
                                             DeliveryMode.TAKE_FIRST)
        if tracing is not None:
            net.trace_configure(chip_smoke.TRACE_CAPACITY)
    else:
        factories, _p = chip_smoke.root_factories(pub, privs, proposals, "cuda", parent)
        net = SimulatedNetwork(pub, privs, seed=seed, mode=DeliveryMode.TAKE_FIRST,
                               use_rbc_batcher=True, device="cuda", extra_factories=factories)
    span = tracing.span("era", era=0) if tracing is not None else contextlib.nullcontext()
    with span:
        wall, blocks = chip_smoke.root_run(net, range(chip_smoke.HB_N))
    seen.add((blocks[0].header.hash().hex(), net.delivered_count))
    out = {f"{engine}_wall": wall * 1e3}
    if tracing is not None:
        t0 = time.perf_counter()
        tracing.era_report()
        out[f"{engine}_report"] = (time.perf_counter() - t0) * 1e3
    if engine == "native":
        net.close()
    return out


era("native")
for _ in range(runs):
    for engine in ("python", "native"):
        for k, v in era(engine).items():
            phases.setdefault(k, []).append(v)
assert len(seen) == 1, seen
print(json.dumps(phases))
"""

_CHILDREN = {"rbc": _CHILD, "tpke": _TPKE_CHILD, "root": _ROOT_CHILD}


def run_tree(root: Path, n: int, flushes: int, seed: int, path: str = "rbc") -> dict:
    """{phase: [ms of each warm flush or era]} of one process of tree `root`."""
    out = subprocess.run([sys.executable, "-c", _CHILDREN[path], str(root), str(n),
                          str(flushes), str(seed)], cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root} N={n}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", action="append", required=True,
                    help="root of an earlier checkout (repeatable)")
    ap.add_argument("--path", choices=sorted(_CHILDREN), default="rbc")
    ap.add_argument("--eras", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--flushes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {f"baseline_{Path(d).name}": Path(d).resolve() for d in args.baseline}
    order = list(trees) + ["this", "this"] + list(trees)[::-1]
    trees["this"] = ROOT
    runs = []
    for n in args.eras:
        for label in order:
            phases = run_tree(trees[label], n, args.flushes, args.seed, args.path)
            runs.append({"tree": label, "n": n, "phases_ms": phases})
            med = {p: round(statistics.median(v), 4) for p, v in phases.items()}
            print(f"N={n} {label}: medians {med}", flush=True)
    for r in runs:
        r["median_ms"] = {p: statistics.median(v) for p, v in r["phases_ms"].items()}
        r["min_ms"] = {p: min(v) for p, v in r["phases_ms"].items()}
    line = json.dumps({"card": smi, "path": args.path, "seed": args.seed,
                       "flushes": args.flushes, "runs": runs})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
