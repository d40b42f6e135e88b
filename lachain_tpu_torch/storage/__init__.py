"""The storage layer of the port: the key-value seam (`kv.py`: MemoryKV,
SqliteKV) and the native LSM engine behind it (`lsm.py`), the
content-addressed trie (`trie.py`) and the state snapshots over it
(`state.py`), the on-open invariant scanner (`fsck.py`), the staged
shrink (`shrink.py`), the crash points (`crashpoints.py`) and the
deterministic workload that drives them (`crash_workload.py`)."""
