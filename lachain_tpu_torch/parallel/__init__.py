"""Device-mesh parallelism: the port of `lachain_tpu/parallel/`.

The reference probes its JAX build for `shard_map` (`get_shard_map`,
`shard_map_available`) and the visible devices before it imports its mesh
module. The port's mesh (`.mesh`) is plain PyTorch over a list of devices,
one host thread driving every shard, so only the device probe is carried
over: `mesh_unsupported_reason`, and `mesh_by_default`, the rule by which
an entry point on the card picks a mesh over every visible card.
"""
from __future__ import annotations

from typing import Optional, Sequence


def mesh_unsupported_reason(devices: Sequence) -> Optional[str]:
    """None when `devices` can hold a mesh, two or more of them (repeats
    allowed); otherwise the reason (parallel/__init__.py:55)."""
    if len(devices) < 2:
        return f"a mesh needs two or more devices, {len(devices)} given"
    return None


def mesh_by_default(device_count: int) -> bool:
    """Whether an entry point on the card that names no mesh runs on one
    over every visible card (GpuBackend's TPKE era pipeline, RbcEraBatcher):
    where `device_count` cards are visible and a mesh can hold them, as
    TpuBackend._get_pipeline picks its MeshEraPipeline when jax sees more
    than one device (crypto/tpu_backend.py:155-161)."""
    return mesh_unsupported_reason(range(device_count)) is None
