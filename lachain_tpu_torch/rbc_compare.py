"""Warm RBC flushes of this tree beside earlier checkouts, on one card.

    python3 -m lachain_tpu_torch.rbc_compare --baseline DIR [--baseline DIR]
        [--eras 64 256] [--flushes 20] [--seed 1] [--out FILE]

Each tree runs `chip_smoke.py`'s own RBC era (`make_rbc_era`, `rbc_flush`:
one validator's era at N=n, the same seed, so the same payloads and
erasures) in a process of its own, with its own `lachain_tpu_torch` and
kernels: one cold flush (the inverses, the tables, the kernels' first
use), then `--flushes` warm ones whose phases (`RbcEraBatcher.last_timings`:
pack, device, fetch, recheck ...) are kept in ms. The trees take turns,
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


def run_tree(root: Path, n: int, flushes: int, seed: int) -> dict:
    """{phase: [ms of each warm flush]} of one process of tree `root`."""
    out = subprocess.run([sys.executable, "-c", _CHILD, str(root), str(n), str(flushes),
                          str(seed)], cwd=root, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root} N={n}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", action="append", required=True,
                    help="root of an earlier checkout (repeatable)")
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
            phases = run_tree(trees[label], n, args.flushes, args.seed)
            runs.append({"tree": label, "n": n, "phases_ms": phases})
            med = {p: round(statistics.median(v), 4) for p, v in phases.items()}
            print(f"N={n} {label}: medians {med}", flush=True)
    for r in runs:
        r["median_ms"] = {p: statistics.median(v) for p, v in r["phases_ms"].items()}
        r["min_ms"] = {p: min(v) for p, v in r["phases_ms"].items()}
    line = json.dumps({"card": smi, "seed": args.seed, "flushes": args.flushes, "runs": runs})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
