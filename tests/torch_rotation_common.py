"""The (4, 1) validator rotation of tests/test_torch_rotation.py and the
card case of tests/test_torch_cuda.py, driven in lockstep on several
"sides": each a package (the JAX package's or the port's modules,
`package(root)`) with its own chain (`chip_smoke.RotationChain` on
MemoryKV) and every validator's services, all real (ref
tests/test_vault_keygen.py:135, :235): N ValidatorStatusManagers (validator
0's reading the chain's attendance) through block 19, then validator 0's;
N KeyGenManagers, each with its own MemoryKV, seeded rngs. Blocks 1-21:
stakes, VRF proofs, the lottery's close after block 10, commits (12),
values (13), confirms (14), FinishCycle (19), then cycle 1 under the
rotated set with validator 0's attendance report (20, 21). After block
`restart_after` every side's validator 0 manager is rebuilt from the next
side's KEYGEN_STATE row. Headers are co-signed by the era's set but one
seeded absentee. Imports neither JAX nor the JAX package: the caller
hands the sides in.
"""
from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import chip_smoke

N, F = 4, 1
CHAIN = 225
HEIGHTS = 21
RESTART_AFTER = 12  # the commits executed, every validator's values sent


_MODULES = ("consensus.attendance", "consensus.keys", "core.block_manager",
            "core.block_producer", "core.execution", "core.system_contracts", "core.tx_pool",
            "core.types", "core.validator_manager", "core.validator_status",
            "core.keygen_manager", "crypto.ecdsa", "storage.kv", "storage.state")


def package(root: str) -> SimpleNamespace:
    """The modules a side drives, of the package `root`."""
    return SimpleNamespace(**{m.split(".")[1]: importlib.import_module(f"{root}.{m}")
                              for m in _MODULES})


class Rng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


class Side:
    """One package's chain and validators. `make_manager(i, priv, send,
    on_keys, rng, kv)` builds validator i's KeyGenManager in the package;
    `device` and `ingest` go to RotationChain."""

    def __init__(self, name: str, pkg, make_manager, device=None, ingest=None, seed: int = 9):
        self.name, self.pkg, self.make_manager = name, pkg, make_manager
        genesis, gprivs = pkg.keys.trusted_key_gen(N, F, Rng(seed))
        self.genesis, self.genesis_privs = genesis, gprivs
        self.privs = [p.ecdsa_priv for p in gprivs]
        self.chain = chip_smoke.RotationChain(pkg, pkg.kv.MemoryKV(), genesis, self.privs, CHAIN,
                                              count=N, device=device, ingest=ingest)
        self.kvs = [pkg.kv.MemoryKV() for _ in range(N)]
        self.installed: dict = {}
        self.statuses = [pkg.validator_status.ValidatorStatusManager(
            p, self.chain.send_tx_for(p),
            attendance_reader=(lambda c: self.chain.attendance.counts_for(c)) if i == 0 else None)
            for i, p in enumerate(self.privs)]
        self.managers = [self.manager(i) for i in range(N)]
        self.records: list = []
        self.restored: bytes = b""

    def manager(self, i: int, rng_seed: int = 500):
        def on_keys(first_era, keyring, participants):
            self.installed[i] = (first_era, keyring, list(participants))

        return self.make_manager(i, self.privs[i], self.chain.send_tx_for(self.privs[i]),
                                 on_keys, Rng(rng_seed + i), self.kvs[i])

    def state_row(self, i: int):
        kv = self.pkg.kv
        return self.kvs[i].get(kv.prefixed(kv.EntryPrefix.KEYGEN_STATE))

    def step(self, height: int, absent) -> None:
        block = self.chain.produce(absent)
        services = (self.statuses if height < chip_smoke.ROT_CYCLE else self.statuses[:1])
        self.chain.after_block(block, services + self.managers)
        self.records.append(dict(
            height=height, hash=block.hash(), block=block.encode(),
            state_hash=self.chain.state.committed.state_hash(),
            rows=[self.state_row(i) for i in range(N)],
            sent=[stx.encode() for stx in self.chain.pending],
            keys=self.chain.vm.keys_for_era(height + 1).encode(),
            attendance=self.chain.attendance.to_bytes()))

    def restart_from(self, row: bytes) -> None:
        """Validator 0's node restarted on a store holding `row`."""
        kv = self.pkg.kv
        self.kvs[0] = kv.MemoryKV()
        self.kvs[0].put(kv.prefixed(kv.EntryPrefix.KEYGEN_STATE), row)
        self.managers[0] = self.manager(0, rng_seed=700)
        self.restored = self.managers[0].keygen.to_bytes()


def drive(sides) -> None:
    """Blocks 1..HEIGHTS on every side in lockstep (the cycle parameters
    set by the caller: chip_smoke.ROT_CYCLE, ROT_VRF_PHASE,
    ROT_ATTENDANCE)."""
    for side in sides:
        for s in side.statuses:
            s.become_staker(chip_smoke.ROT_STAKE)
    absent_rng = random.Random(5)
    for height in range(1, HEIGHTS + 1):
        absent = {absent_rng.randrange(N)}
        for side in sides:
            side.step(height, absent)
        if height == RESTART_AFTER:
            rows = [side.state_row(0) for side in sides]
            for k, side in enumerate(sides):
                side.restart_from(rows[(k + 1) % len(sides)])
