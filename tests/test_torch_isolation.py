"""The port stands alone and never hides a missing card.

* In a fresh interpreter, importing every module of `lachain_tpu_torch`
  (the storage, crash points, payload codec, send journal and DKG among them)
  must bring in neither JAX nor any module of the JAX package.
* Asking for the card where there is none raises: `GpuBackend()` (and so
  its `tpke_era_verify_combine` and `ts_era_verify_combine`, and with a
  pipeline given), `GpuEraPipeline()`, `GlvEraPipeline()`,
  `GpuTpkeVerifier()`, `TsGpuEraPipeline()`, `GpuEcdsaRecover()`,
  `ecdsa.recover_hash_batch`, `RbcEraBatcher()`, `rs_batch.encode_batch` /
  `decode_batch`, the mesh over the visible cards (`make_mesh()`,
  `MeshEraPipeline()`, an `RbcEraBatcher` on a mesh of the card) and the
  kernel build have no CPU fallback; neither have the consensus
  simulator (`SimulatedNetwork`) and the era router (`EraRouter`) built
  for the card.
* The host pairing library is the port's own build: it loads from
  `lachain_tpu_torch/_build/` (never from the JAX package's tree), its
  binding loads no torch, and without g++ the build raises; so does
  `hashes.keccak256_batch`, `hashes.keccak256_host` and the native ECDSA
  entries (`ecdsa.sign_hash`, `verify_hash`, `recover_hash`,
  `public_key_bytes`, `ecdh_shared_secret`), which have no pure-Python
  fallback.
* The native consensus engine is the port's own build too: it loads from
  `lachain_tpu_torch/_build/`, without g++ or on a failed build
  `consensus_library()` raises, and `NativeSimulatedNetwork()` built for
  the card (the default) raises without one; `root_profile` exits 2.
* Execution (`vm/`, `core/execution.py`, `system_contracts.py`,
  `parallel_exec.py`, `block_manager.py`, `tx_pool.py`, `block_producer.py`,
  `storage/crash_workload.py`) loads neither torch, JAX, the JAX package
  nor a kernel module at import; a `BlockManager` built for the card (the
  default) raises without one.
* The storage (`storage/trie.py`, `state.py`, `lsm.py`, `fsck.py`,
  `shrink.py`) loads neither torch, JAX nor the JAX package, even while it
  commits, scans and shrinks a store; its LSM engine is the port's own
  build, loaded from `lachain_tpu_torch/_build/`, and without g++ or on a
  failed build `lsm_library()` (and so `LsmKV()`) raises.
"""
from __future__ import annotations

import os
import random
import subprocess
import sys

import pytest
import torch

from lachain_tpu_torch.consensus.era import EraRouter
from lachain_tpu_torch.consensus.keys import trusted_key_gen
from lachain_tpu_torch.consensus.native_rt import NativeSimulatedNetwork
from lachain_tpu_torch.consensus.rbc_batcher import RbcEraBatcher
from lachain_tpu_torch.consensus.simulator import SeededRng, SimulatedNetwork
from lachain_tpu_torch.crypto import ecdsa, hashes
from lachain_tpu_torch.crypto.gpu_backend import GpuBackend
from lachain_tpu_torch.crypto.native_backend import NativeBackend
from lachain_tpu_torch.ops import _build, rs_batch
from lachain_tpu_torch.ops.secp import GpuEcdsaRecover
from lachain_tpu_torch.ops.verify import (
    GlvEraPipeline,
    GpuEraPipeline,
    GpuTpkeVerifier,
    TsGpuEraPipeline,
)
from lachain_tpu_torch.parallel.mesh import MeshEraPipeline, make_era_mesh, make_mesh

pytestmark = pytest.mark.kernel

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import lachain_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    lachain_tpu_torch.__path__, "lachain_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "lachain_tpu" or m.startswith("lachain_tpu."))
new = {"lachain_tpu_torch.consensus.rbc_batcher", "lachain_tpu_torch.ops.rs",
       "lachain_tpu_torch.ops.rs_batch", "lachain_tpu_torch.ops.rs_ref",
       "lachain_tpu_torch.ops.msm", "lachain_tpu_torch.ops.curve",
       "lachain_tpu_torch.parallel", "lachain_tpu_torch.parallel.mesh",
       "lachain_tpu_torch.crypto.provider", "lachain_tpu_torch.utils.serialization"}
new |= {f"lachain_tpu_torch.consensus.{m}" for m in (
    "messages", "protocol", "keys", "binary_broadcast", "binary_agreement",
    "common_coin", "common_subset", "reliable_broadcast", "honey_badger",
    "evidence", "journal", "era", "simulator", "root_protocol", "native_rt",
    "native_hosts", "keygen")}
new |= {"lachain_tpu_torch.crypto.vrf", "lachain_tpu_torch.crypto._aes_fallback",
        "lachain_tpu_torch.core", "lachain_tpu_torch.core.types",
        "lachain_tpu_torch.core.block_producer"}
new |= {"lachain_tpu_torch.network", "lachain_tpu_torch.network.faults",
        "lachain_tpu_torch.consensus.adversary"}
new |= {"lachain_tpu_torch.storage", "lachain_tpu_torch.storage.kv",
        "lachain_tpu_torch.storage.crashpoints", "lachain_tpu_torch.network.wire",
        "lachain_tpu_torch.consensus.journal"}
new |= {f"lachain_tpu_torch.storage.{m}" for m in ("trie", "state", "lsm", "fsck", "shrink")}
new |= {"lachain_tpu_torch.vm", "lachain_tpu_torch.utils.bloom",
        "lachain_tpu_torch.storage.crash_workload"}
new |= {f"lachain_tpu_torch.vm.{m}" for m in (
    "gas", "wasm", "interpreter", "translate", "builder", "abi", "external", "vm")}
new |= {f"lachain_tpu_torch.core.{m}" for m in (
    "hardforks", "execution", "system_contracts", "parallel_exec", "block_manager", "tx_pool")}
new |= {"lachain_tpu_torch.consensus.attendance"} | {f"lachain_tpu_torch.core.{m}" for m in (
    "vault", "validator_manager", "validator_status", "keygen_manager")}
assert new <= set(names), new - set(names)
print(len(names), bad)
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout.split("\n")[0]
    count, bad = out.split(" ", 1)
    assert int(count) >= 83  # every module of the package was imported
    assert bad == "[]"


_HOST_ONLY = """
import sys
import lachain_tpu_torch.crypto.ecdsa
import lachain_tpu_torch.crypto.provider
import lachain_tpu_torch.crypto.threshold_sig
import lachain_tpu_torch.crypto.tpke
import lachain_tpu_torch.crypto.vrf
import lachain_tpu_torch.core.types
import lachain_tpu_torch.core.block_producer
import lachain_tpu_torch.consensus.root_protocol
import lachain_tpu_torch.consensus.native_hosts
import lachain_tpu_torch.consensus.journal
import lachain_tpu_torch.consensus.keygen
import lachain_tpu_torch.consensus.attendance
import lachain_tpu_torch.network.wire
import lachain_tpu_torch.storage.crashpoints
import lachain_tpu_torch.storage.kv
print(sorted(m for m in sys.modules if m == "torch"
             or m.startswith("lachain_tpu_torch.ops")))
"""


def test_protocol_modules_load_no_torch():
    """A host-only user of the protocol modules never loads torch or the
    kernel build: the card backend is imported only where it is used."""
    out = subprocess.run(
        [sys.executable, "-c", _HOST_ONLY], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout.strip()
    assert out == "[]"


def _require_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")


def test_gpu_backend_without_card_raises():
    _require_no_card()
    with pytest.raises(RuntimeError):
        GpuBackend()
    with pytest.raises(RuntimeError):
        GpuEraPipeline()


def test_glv_path_and_verifier_without_card_raise():
    _require_no_card()
    with pytest.raises(RuntimeError):
        GlvEraPipeline()
    with pytest.raises(RuntimeError):
        GpuTpkeVerifier()
    with pytest.raises(RuntimeError):
        GpuBackend(pipeline=GlvEraPipeline(device="cpu"))


def test_coin_path_without_card_raises():
    _require_no_card()
    with pytest.raises(RuntimeError):
        TsGpuEraPipeline()
    with pytest.raises(RuntimeError):
        GpuBackend().ts_era_verify_combine([], [], None)


def test_ecdsa_path_without_card_raises():
    _require_no_card()
    with pytest.raises(RuntimeError):
        GpuEcdsaRecover()
    h = bytes(32)
    sig = bytes(64) + b"\x00"
    with pytest.raises(RuntimeError):
        ecdsa.recover_hash_batch([h], [sig])
    with pytest.raises(RuntimeError):
        ecdsa.recover_hash_batch([], [])


def test_keygen_manager_without_card_raises():
    from lachain_tpu_torch.core.keygen_manager import KeyGenManager

    _require_no_card()
    priv = (7).to_bytes(32, "big")
    with pytest.raises(RuntimeError):
        KeyGenManager(priv, lambda to, inv: None, rng=random.Random(1))
    with pytest.raises(RuntimeError):
        KeyGenManager(priv, lambda to, inv: None, rng=random.Random(1), device="cuda")


def test_rbc_path_without_card_raises():
    _require_no_card()
    with pytest.raises(RuntimeError):
        RbcEraBatcher()
    with pytest.raises(RuntimeError):
        rs_batch.encode_batch([(b"payload", 2, 4)])
    with pytest.raises(RuntimeError):
        rs_batch.decode([None, b"a", b"b", None], 2)


def test_mesh_without_card_raises():
    _require_no_card()
    for build in (make_mesh, make_era_mesh, MeshEraPipeline,
                  lambda: make_mesh(["cuda:0"] * 2),
                  lambda: MeshEraPipeline(devices=["cuda"] * 8),
                  lambda: RbcEraBatcher(mesh=make_mesh()),
                  lambda: RbcEraBatcher(device="cpu", mesh=make_mesh(["cuda"] * 2))):
        with pytest.raises(RuntimeError):
            build()


def test_consensus_on_the_card_without_card_raises():
    """The simulator and a router built for the card (the default) build a
    GpuBackend on it, which raises without one."""
    _require_no_card()
    pub, privs = trusted_key_gen(4, 1, SeededRng(1))
    with pytest.raises(RuntimeError):
        SimulatedNetwork(pub, privs)
    with pytest.raises(RuntimeError):
        SimulatedNetwork(pub, privs, device="cuda", use_rbc_batcher=True)
    with pytest.raises(RuntimeError):
        EraRouter(0, 0, pub, privs[0], lambda _t, _p: None, SeededRng(2))
    with pytest.raises(RuntimeError):
        NativeSimulatedNetwork(pub, privs)
    with pytest.raises(RuntimeError):
        NativeSimulatedNetwork(pub, privs, device="cuda", use_rbc_batcher=True)
    net = SimulatedNetwork(pub, privs, device="cpu")  # the plain versions
    assert net.backend.device.type == "cpu"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


_NATIVE_ONLY = """
import sys
import lachain_tpu_torch.crypto.native_backend as nb
lib = nb.NativeBackend()._lib
print(sorted(m for m in sys.modules if m == "torch" or m.startswith("torch.")
             or m == "jax" or m == "lachain_tpu" or m.startswith("lachain_tpu.")))
print(lib._name)
"""


def test_host_library_is_the_ports_own_build():
    """The native host backend loads its library from the port's build
    directory, and neither it nor its build imports torch, JAX or the JAX
    package (a host-only caller pays for none of them)."""
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE_ONLY], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split("\n")
    assert out[0] == "[]"
    path = os.path.realpath(out[1])
    build_dir = os.path.realpath(os.path.join(_ROOT, "lachain_tpu_torch", "_build"))
    assert os.path.dirname(path) == build_dir
    assert os.path.realpath(NativeBackend()._lib._name) == path


def test_host_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        NativeBackend()
    assert not list(tmp_path.iterdir())  # nothing was built


def test_native_ecdsa_without_host_library_raises(monkeypatch, tmp_path):
    """sign_hash, verify_hash, recover_hash, public_key_bytes and
    ecdh_shared_secret run in the host library or raise: no pure-Python
    fallback when the build fails."""
    monkeypatch.setattr(ecdsa, "_LIB", [])
    monkeypatch.setattr(ecdsa, "_PUB_CACHE", {})
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    priv, h = (7).to_bytes(32, "big"), bytes(range(32))
    sig = ecdsa._sign_hash_py(priv, h)
    pub = ecdsa._recover_hash_py(h, sig)
    for call in (lambda: ecdsa.sign_hash(priv, h), lambda: ecdsa.verify_hash(pub, h, sig),
                 lambda: ecdsa.recover_hash(h, sig), lambda: ecdsa.public_key_bytes(priv),
                 lambda: ecdsa.ecdh_shared_secret(priv, pub)):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            call()
    assert not list(tmp_path.iterdir())  # nothing was built


def test_keccak_batch_without_host_library_raises(monkeypatch, tmp_path):
    """keccak256_batch binds the host library or raises: no per-item
    fallback."""
    monkeypatch.setattr(hashes, "_BATCH_FN", [])
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        hashes.keccak256_batch([b"abc"])
    monkeypatch.setattr(hashes, "_ONE_FN", [])
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        hashes.keccak256_host(b"abc")


def test_host_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; nothing is loaded."""
    src = tmp_path / "src"
    src.mkdir()
    for name in _build.HOST_SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_HOST_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_SRC", src)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.host_library()
    assert _build._HOST_LIB is None
    assert not list((tmp_path / "build").glob("*.so"))


_ENGINE_ONLY = """
import sys
from lachain_tpu_torch.consensus.native_rt import load_rt
lib = load_rt()
print(sorted(m for m in sys.modules if m == "torch" or m.startswith("torch.")
             or m == "jax" or m == "lachain_tpu" or m.startswith("lachain_tpu.")))
print(lib._name)
"""


def test_consensus_engine_is_the_ports_own_build():
    """The native consensus engine loads from the port's build directory
    (never the JAX package's libconsensus_rt.so), and neither it nor its
    binding imports torch, JAX or the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _ENGINE_ONLY], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split("\n")
    assert out[0] == "[]"
    path = os.path.realpath(out[1])
    build_dir = os.path.realpath(os.path.join(_ROOT, "lachain_tpu_torch", "_build"))
    assert os.path.dirname(path) == build_dir
    assert os.path.basename(path).startswith("libconsensus_")


def test_root_profile_without_card_exits_2():
    """The native era's profiling tool measures on the card only: without
    one it exits 2 and profiles nothing."""
    _require_no_card()
    run = subprocess.run(
        [sys.executable, "-m", "lachain_tpu_torch.root_profile"], cwd=_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode == 2 and "no CUDA device" in run.stderr
    assert "profiled era" not in run.stdout


def test_consensus_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_CONSENSUS_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _build.consensus_library()
    assert not list(tmp_path.iterdir())  # nothing was built


def test_consensus_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; nothing is loaded."""
    src = tmp_path / "src"
    src.mkdir()
    for name in _build.CONSENSUS_SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_CONSENSUS_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "CONSENSUS_SRC", src)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.consensus_library()
    assert _build._CONSENSUS_LIB is None
    assert not list((tmp_path / "build").glob("*.so"))


_STORAGE_ONLY = """
import sys, tempfile
from lachain_tpu_torch.storage.fsck import fsck
from lachain_tpu_torch.storage.lsm import LsmKV
from lachain_tpu_torch.storage.shrink import DbShrink
from lachain_tpu_torch.storage.state import StateManager
d = tempfile.mkdtemp()
kv = LsmKV(d)
sm = StateManager(kv)
for height in range(3):
    snap = sm.new_snapshot()
    for i in range(50):
        snap.put("balances", bytes([height, i]), bytes(32))
    sm.freeze_and_commit(height, snap)
DbShrink(sm, kv).shrink(1)
report = fsck(kv, repair=False, deep=True)
assert [i.code for i in report.issues] == ["tip-block"], report.to_dict()
kv.close()
print(sorted(m for m in sys.modules if m == "torch" or m.startswith("torch.")
             or m == "jax" or m == "lachain_tpu" or m.startswith("lachain_tpu.")
             or m.startswith("lachain_tpu_torch.ops.") and m != "lachain_tpu_torch.ops._build"))
from lachain_tpu_torch.ops import _build
print(_build.lsm_library()._name)
"""


def test_storage_loads_no_torch_and_its_own_engine():
    """Committing, shrinking and fsck over LsmKV load neither torch, JAX,
    the JAX package nor a kernel module; the engine loads from the port's
    build directory (never the JAX package's libllsm.so)."""
    out = subprocess.run(
        [sys.executable, "-c", _STORAGE_ONLY], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split("\n")
    assert out[0] == "[]"
    path = os.path.realpath(out[1])
    build_dir = os.path.realpath(os.path.join(_ROOT, "lachain_tpu_torch", "_build"))
    assert os.path.dirname(path) == build_dir
    assert os.path.basename(path).startswith("liblsm_")


def test_lsm_build_without_gxx_raises(monkeypatch, tmp_path):
    from lachain_tpu_torch.storage import lsm

    monkeypatch.setattr(_build, "_LSM_LIB", None)
    monkeypatch.setattr(lsm, "_LIB", [])
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _build.lsm_library()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        lsm.LsmKV(str(tmp_path / "db"))
    assert not list(tmp_path.iterdir())  # nothing was built or opened


def test_lsm_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; nothing is loaded."""
    src = tmp_path / "src"
    src.mkdir()
    for name in _build.LSM_SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(_build, "_LSM_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LSM_SRC", src)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.lsm_library()
    assert _build._LSM_LIB is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_block_manager_on_the_card_without_card_raises():
    _require_no_card()
    from lachain_tpu_torch.core import execution
    from lachain_tpu_torch.core.block_manager import BlockManager
    from lachain_tpu_torch.storage.kv import MemoryKV
    from lachain_tpu_torch.storage.state import StateManager

    kv = MemoryKV()
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockManager(kv, StateManager(kv), execution.TransactionExecuter(225))
    BlockManager(kv, StateManager(kv), execution.TransactionExecuter(225), device="cpu")


_EXEC_ONLY = """
import sys, tempfile, os
import lachain_tpu_torch.vm
from lachain_tpu_torch.core import block_producer, hardforks, system_contracts
from lachain_tpu_torch.storage import crash_workload
import lachain_tpu_torch.utils.bloom
print(sorted(m for m in sys.modules if m == "torch" or m.startswith("torch.")
             or m == "jax" or m == "lachain_tpu" or m.startswith("lachain_tpu.")
             or m.startswith("lachain_tpu_torch.ops.") and m != "lachain_tpu_torch.ops._build"))
d = tempfile.mkdtemp()
kv = crash_workload.open_kv(os.path.join(d, "db"), "sqlite")
print(crash_workload.run_workload(kv, blocks=2, shrink=False)["height"])
kv.close()
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("lachain_tpu.")))
"""


def test_execution_loads_no_torch_at_import():
    """The VM, the executer, the system contracts, the pool, the block
    manager and the producer load neither torch, JAX, the JAX package nor
    a kernel module at import (a BlockManager resolves its device only
    when it is built); the host workload then runs a chain."""
    out = subprocess.run(
        [sys.executable, "-c", _EXEC_ONLY], cwd=_ROOT, capture_output=True,
        text=True, check=True, timeout=300,
    ).stdout.split("\n")
    assert out[:3] == ["[]", "2", "[]"]
