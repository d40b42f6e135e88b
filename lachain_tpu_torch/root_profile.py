"""Where the native root era's wall goes, on one card.

    python3 -m lachain_tpu_torch.root_profile [--seed 1] [--eras 2] [--top 45]

Runs `chip_smoke.py`'s N=64 root era (`run_root_native_path`'s keys,
proposals, parent and seed; TAKE_FIRST, both batchers, RootProtocol
native at every validator) `--eras` times unprofiled, printing each wall,
then once under cProfile, printing the `--top` functions by own time and
by cumulative time. cProfile counts a ctypes call's C++ time as its
caller's own time, so `NativeSimulatedNetwork.run`'s own time is the
engine's delivery and each crossing callback's cumulative time the host
shims' work. The first era also builds the kernels when the checkout has
none. Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--eras", type=int, default=2)
    ap.add_argument("--top", type=int, default=45)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("root_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from lachain_tpu_torch.consensus.keys import trusted_key_gen
    from lachain_tpu_torch.consensus.simulator import DeliveryMode

    dev = torch.device("cuda")
    seed = args.seed
    pub, privs = trusted_key_gen(cs.HB_N, cs.HB_F, cs.SeededRng(seed + 640))
    rng = random.Random(seed + 641)
    proposals, _signer = cs.root_transfers(cs.HB_N, -(-cs.BLOCK_TXS // cs.HB_N), rng)
    parent = rng.randbytes(32)

    def era():
        cs.clear_block_memos()
        net, _producers = cs.native_root_net(pub, privs, proposals, dev, parent, seed,
                                             DeliveryMode.TAKE_FIRST)
        wall, blocks = cs.root_run(net, range(cs.HB_N))
        torch.cuda.synchronize()
        net.close()
        return net, wall, blocks

    print(f"{torch.cuda.get_device_name(0)}; N={cs.HB_N}, seed {seed}", flush=True)
    for i in range(args.eras):
        net, wall, blocks = era()
        print(f"era {i}: wall {wall:.3f} s, {net.delivered_count} messages, block "
              f"{blocks[0].header.hash().hex()[:16]}, coin_s {net.coin_s:.3f}, tpke "
              f"{net.tpke_phase_s}", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    _net, wall, _blocks = era()
    prof.disable()
    print(f"profiled era: wall {wall:.3f} s", flush=True)
    for key in ("tottime", "cumulative"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
