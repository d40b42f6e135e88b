"""ValidatorManager: the consensus key set of an era, read from chain state.

The port of `lachain_tpu/core/validator_manager.py` (the C# reference's
ValidatorManager.cs:25-60): the validator set of era E is what the
`validators/current` entry held in the state snapshot of block E-1
(written by the governance contract's FinishCycle,
`core/system_contracts.py`), cached per era; the genesis key set applies
until the first rotation lands. Host work only.
"""
from __future__ import annotations

from typing import Dict

from ..consensus.keys import PublicConsensusKeys
from ..storage.state import StateManager


class ValidatorManager:
    def __init__(self, state: StateManager, genesis_keys: PublicConsensusKeys):
        self._state = state
        self.genesis_keys = genesis_keys
        self._cache: Dict[int, PublicConsensusKeys] = {}
        self._decoded: Dict[bytes, PublicConsensusKeys] = {}

    def keys_for_era(self, era: int) -> PublicConsensusKeys:
        """The key set governing era `era` (block height `era`). Block
        era-1 should be persisted; before any rotation, for era 0, or
        while block era-1 is missing, the genesis set."""
        if era in self._cache:
            return self._cache[era]
        if era <= 0:
            return self.genesis_keys
        roots = self._state.roots_at(era - 1)
        if roots is None:
            # not persisted yet: observers bootstrap on the genesis set
            return self.genesis_keys
        raw = self._state.new_snapshot(roots).get("validators", b"current")
        if raw is None:
            keys = self.genesis_keys
        else:
            # one decoded object per distinct set: consecutive eras under
            # one set share identity (cheap change detection upstream)
            keys = self._decoded.get(raw)
            if keys is None:
                keys = PublicConsensusKeys.decode(raw)
                self._decoded[raw] = keys
        self._cache[era] = keys
        if len(self._cache) > 64:
            self._cache.pop(min(self._cache))
        return keys
