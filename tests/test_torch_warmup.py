"""The port's node-start warmup and the build locks, on the CPU.

* `era_warmup_shapes` equals the JAX package's for n in {1, 4, 5, 16, 64}.
* A warmup at n = 4 on `GpuBackend(device="cpu")` runs one fully masked
  TPKE era per slot tier, largest first, and one coin era, on a backend of
  its own, and ends with no error; a failing warmup stores the exception
  and raises it again from `join()`.
* `ops/_build.library()` and `host_library()` build once when two threads
  ask at once (the compilers stubbed by counting builds).
"""
from __future__ import annotations

import threading
import time
import types

import pytest
import torch

from lachain_tpu.crypto.warmup import era_warmup_shapes as ref_shapes
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.crypto.warmup import era_warmup_shapes, warmup_era_kernels
from lachain_tpu_torch.ops import _build

pytestmark = pytest.mark.kernel

# tiny tensors: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 4, 5, 16, 64])
def test_shapes_equal_the_reference(n):
    assert era_warmup_shapes(n) == ref_shapes(n)


def test_cpu_warmup_runs_every_tier_and_a_coin_era():
    caller = GpuBackend(device="cpu")
    t = warmup_era_kernels(4, caller)
    t.join(timeout=240)
    assert not t.is_alive()
    assert t.error is None
    assert t.backend is not caller and t.backend.device == caller.device
    assert t.backend.host_name == caller.host_name
    assert t.eras == [("tpke", s) for s in era_warmup_shapes(4)] + [("coin", 1)]
    assert t.backend.era_calls == len(era_warmup_shapes(4))
    assert t.backend.ts_era_calls >= 1
    assert caller.era_calls == caller.ts_era_calls == 0
    assert t.seconds > 0


def test_failing_warmup_raises_from_join(monkeypatch):
    def fail(self, jobs, vks, rng):
        raise RuntimeError("era failed")

    monkeypatch.setattr(GpuBackend, "tpke_era_verify_combine", fail)
    t = warmup_era_kernels(4, GpuBackend(device="cpu"), include_ts=False)
    with pytest.raises(RuntimeError, match="era failed"):
        t.join(timeout=60)
    assert not t.is_alive()
    assert isinstance(t.error, RuntimeError) and t.eras == []


@pytest.mark.parametrize("which", ["library", "host_library"])
def test_two_threads_build_once(monkeypatch, tmp_path, which):
    """Both threads ask for the library while the first build is still
    running: the build runs once and both get the same library."""
    builds = []

    def slow_build(target, *_args):
        builds.append(target)
        time.sleep(0.2)
        target.write_bytes(b"")

    fake_lib = types.SimpleNamespace(
        _name="stub", **{name: types.SimpleNamespace() for name in _build._SIGNATURES})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake_lib)
    if which == "library":
        monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build, "_target", lambda nvcc: tmp_path / "lib.so")
        monkeypatch.setattr(_build, "_build", slow_build)
    else:
        monkeypatch.setattr(_build, "_gxx", lambda: "g++")
        monkeypatch.setattr(_build, "_host_target", lambda gxx: tmp_path / "host.so")
        monkeypatch.setattr(_build, "_publish",
                            lambda target, steps: slow_build(target))
    load = getattr(_build, which)
    got = []
    threads = [threading.Thread(target=lambda: got.append(load())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert got == [fake_lib, fake_lib]
