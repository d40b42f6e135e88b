"""Height-gated hardfork flags.

The port's copy of `lachain_tpu/core/hardforks.py`: a fixed set of named
protocol changes, each activating at a configured block height, set ONCE
at process start and consulted by consensus-critical code paths. Every
node on a chain must configure identical heights or state hashes diverge.
The heights are process-wide state: tests reset them
(`reset_for_tests`) between cases.

Flags (heights default to 0 = active from genesis):
  strict_share_validation  HoneyBadger verifies decryption shares eagerly
                           below this height and defers to the batched
                           check above it
  boundary_finish_cycle    governance FinishCycle restricted to the cycle's
                           last block
  fast_wasm_gas            translatable WASM bills 200 gas/op (the
                           translated tier's dispatch speed) instead of the
                           interpreter rate 2000/op; below the activation
                           height every instruction bills the old rate
"""
from __future__ import annotations

from typing import Dict

_DEFAULTS: Dict[str, int] = {
    "strict_share_validation": 0,
    "boundary_finish_cycle": 0,
    "fast_wasm_gas": 0,
}

_heights: Dict[str, int] = dict(_DEFAULTS)
_frozen = False


def set_hardfork_heights(heights: Dict[str, int], *, force: bool = False) -> None:
    """Install configured activation heights (unknown names rejected).
    One-shot per process, like the reference's static initialization."""
    global _frozen
    if _frozen and not force:
        raise RuntimeError("hardfork heights already set")
    for name in heights:
        if name not in _DEFAULTS:
            raise ValueError(f"unknown hardfork flag {name!r}")
    _heights.update(heights)
    _frozen = True


def reset_for_tests() -> None:
    global _frozen
    _heights.clear()
    _heights.update(_DEFAULTS)
    _frozen = False


def is_active(name: str, height: int) -> bool:
    return height >= _heights[name]


def activation_height(name: str) -> int:
    return _heights[name]
