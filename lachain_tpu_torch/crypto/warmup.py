"""Node-start warmup of the era path.

The port of `lachain_tpu/crypto/warmup.py`. The reference compiles its
Mosaic era kernels at each reachable (S_pad, K_pad) shape on a background
thread at node start (core/node.py:333-335), largest first. On the card the
kernels are built once for every shape, but a process's first era still
pays for the nvcc build or load of the kernel library, the g++ host
library, the CUDA context, the lazy loading of each kernel module, the
pipeline's streams, and the caching allocator's device and pinned pools at
each tier's sizes. `warmup_era_kernels` starts a daemon thread that builds
both libraries, then runs the reference's fully masked dummy TPKE eras at
each slot tier, largest first, and one dummy coin era, on stable dummy
keys.

Slot tiers that fall on one `padded_shape` of the backend's pipeline (on
a mesh, parallel/mesh.py, several do) are warmed once, as in the
reference (warmup.py:65-83).

Two differences from the reference:
  * the port's GpuBackend is not thread-safe, so the thread runs its eras
    on a GpuBackend of its own, on the caller's device and host backend,
    with a pipeline of the same kind on the same devices (exposed as the
    thread's `.backend`). What it warms is process-wide: the builds, the
    CUDA context, lazy module loading, the allocator's and the pinned
    pools;
  * a failure is not swallowed: it is stored on the thread as `.error`,
    logged, and raised again by the thread's `join()`.
"""
from __future__ import annotations

import logging
import secrets
import threading
import time
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)


def _pow2_at_least(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def era_warmup_shapes(n_validators: int) -> List[int]:
    """Slot-axis sizes to warm, largest first."""
    top = _pow2_at_least(max(n_validators, 1))
    shapes = []
    s = top
    while s >= 1:
        shapes.append(s)
        s //= 2
    return shapes


def _same_pipeline(pipe):
    """A new TPKE era pipeline of pipe's kind, on its devices and host
    backend."""
    from ..parallel.mesh import MeshEraPipeline

    if isinstance(pipe, MeshEraPipeline):
        return MeshEraPipeline(pipe._backend, devices=list(pipe.mesh.devices.flat))
    return type(pipe)(pipe._backend, pipe.device)


class WarmupThread(threading.Thread):
    """The warmup's daemon thread. `.backend` is the GpuBackend its eras
    ran on, `.eras` the eras run as ("tpke", S) and ("coin", coins),
    `.seconds` its wall time, `.error` the exception that ended it (or
    None); `join()` raises that exception again."""

    def __init__(self, n_validators: int, backend, shapes, include_ts: bool):
        super().__init__(name="lt-torch-kernel-warmup", daemon=True)
        from .gpu_backend import GpuBackend

        pipe = _same_pipeline(backend._pipeline)
        self.backend = GpuBackend(device=backend.device, host_backend=backend._host,
                                  pipeline=pipe)
        self.n_validators = n_validators
        self.shapes = (list(shapes) if shapes is not None
                       else era_warmup_shapes(n_validators))
        padded: dict = {}
        for s in self.shapes:
            padded.setdefault(pipe.padded_shape(s, n_validators), s)
        self.shapes = list(padded.values())
        self.include_ts = include_ts
        self.eras: List[tuple] = []
        self.seconds: Optional[float] = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            self._warm()
        except BaseException as exc:  # kept for join(), which raises it
            self.error = exc
            logger.exception("era warmup failed")
        finally:
            self.seconds = time.perf_counter() - t0

    def _warm(self) -> None:
        from ..ops import _build
        from . import bls12381 as bls
        from .gpu_backend import CoinJob, EraSlotJob
        from .threshold_sig import TsPublicKey
        from .tpke import TpkeVerificationKey

        backend = self.backend
        if backend.device.type == "cuda":
            _build.library()
        if backend.host_name == "native":
            _build.host_library()
        k = self.n_validators
        # one key list for every tier: the pipeline keeps its device copy by
        # identity; every lane is masked, so the RLC draws are zeroed
        vks = [TpkeVerificationKey(bls.G1_GEN) for _ in range(k)]
        for s in self.shapes:
            jobs = [EraSlotJob([None] * k, [0] * k, bls.G2_GEN, bls.G2_GEN)
                    for _ in range(s)]
            backend.tpke_era_verify_combine(jobs, vks, secrets)
            self.eras.append(("tpke", s))
            logger.info("warmed TPKE era S=%d K=%d", s, k)
        if self.include_ts:
            keys = [TsPublicKey(bls.G1_GEN) for _ in range(k)]
            jobs = [CoinJob([None] * k, [0] * k, bls.G2_GEN)]
            backend.ts_era_verify_combine(jobs, keys, secrets)
            self.eras.append(("coin", len(jobs)))
            logger.info("warmed coin era K=%d", k)

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


def warmup_era_kernels(
    n_validators: int,
    backend,
    shapes: Optional[Sequence[int]] = None,
    include_ts: bool = True,
) -> WarmupThread:
    """Start a daemon thread warming the TPKE era at each slot tier of an
    N-validator chain (`shapes`, largest first, by default
    era_warmup_shapes(N)) and, with `include_ts`, one coin era, on a
    GpuBackend of its own on `backend`'s device and host backend. Returns
    the started thread."""
    t = WarmupThread(n_validators, backend, shapes, include_ts)
    t.start()
    return t
