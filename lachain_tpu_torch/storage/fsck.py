"""On-open invariant scanner: detect torn states, repair or refuse.

The port of `lachain_tpu/storage/fsck.py`, check for check: the same
issues, codes, details and repairs, so that `fsck(kv).to_dict()` equals
the JAX package's on the same rows. Every commit in the node is a
multi-write sequence, and a crash (power loss, kill -9, an injected crash
point) can land between the writes. The KV's atomic batches bound the
damage to a small set of enumerable torn states; this scanner checks each
invariant on open, REPAIRS what is safely repairable, and REFUSES to let
the node start otherwise: a node must never silently run on inconsistent
state.

Invariants (storage/crashpoints.py names the crash windows that can
violate them):

  tip-roots      the committed tip (BLOCK_HEIGHT) has a snapshot-index row
                 and its StateRoots decode                         [refuse]
  tip-block      the tip height resolves to a stored block         [refuse]
  root-nodes     every tree root at the tip exists as a trie node; deep
                 walks the full DFS of every retained snapshot     [refuse]
  orphan-block   block entries above the tip (block.persist.mid crash:
                 block batch durable, state commit not) — deleted; the
                 era re-finalizes it deterministically             [repair]
  journal-stale  journal entries for eras already settled on-chain
                 (missed GC) — pruned                              [repair]
  journal-decode undecodable journal values — dropped              [repair]
  pool-decode    undecodable pool entries — dropped                [repair]
  shrink-marks   SHRINK_MARK rows without a SHRINK_STATE — dropped [repair]
  shrink-resume  SHRINK_STATE present: an interrupted shrink will
                 resume on its next run                            [note]

Quick mode (the on-open default) costs a handful of point reads: only one
torn block is possible per crash through the persist pipeline, so orphan
probing checks heights tip+1..tip+PROBE directly instead of scanning the
block index; deep mode (``fsck(kv, deep=True)``) does the full scans and the
full trie DFS.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.serialization import Reader, write_u64
from .kv import EntryPrefix, KVStore, prefixed
from .state import StateRoots
from .trie import EMPTY_ROOT, InternalNode, _decode as _decode_node

logger = logging.getLogger(__name__)

# quick-mode orphan probe depth above the tip; the persist pipeline can
# leave at most ONE torn block, the margin covers manual tampering
ORPHAN_PROBE = 8

NOTE = "note"
REPAIRED = "repaired"
FATAL = "fatal"


@dataclass
class FsckIssue:
    code: str
    detail: str
    severity: str  # NOTE | REPAIRED | FATAL
    repair: Optional[str] = None  # what the repair did (severity REPAIRED)


@dataclass
class FsckReport:
    issues: List[FsckIssue] = field(default_factory=list)
    checked: List[str] = field(default_factory=list)
    deep: bool = False

    @property
    def clean(self) -> bool:
        return not self.issues

    @property
    def fatal(self) -> bool:
        return any(i.severity == FATAL for i in self.issues)

    @property
    def repaired(self) -> List[FsckIssue]:
        return [i for i in self.issues if i.severity == REPAIRED]

    def to_dict(self) -> dict:
        return {
            "clean": self.clean,
            "fatal": self.fatal,
            "deep": self.deep,
            "checked": list(self.checked),
            "issues": [
                {
                    "code": i.code,
                    "severity": i.severity,
                    "detail": i.detail,
                    **({"repair": i.repair} if i.repair else {}),
                }
                for i in self.issues
            ],
        }


class FsckError(Exception):
    """Raised by the node's open path when fsck refuses the database."""

    def __init__(self, report: FsckReport):
        self.report = report
        fatal = [i for i in report.issues if i.severity == FATAL]
        super().__init__(
            "fsck refused database: "
            + "; ".join(f"[{i.code}] {i.detail}" for i in fatal)
        )


def _tip(kv: KVStore) -> Optional[int]:
    enc = kv.get(prefixed(EntryPrefix.BLOCK_HEIGHT))
    return Reader(enc).u64() if enc else None


def _delete_orphan_block(kv: KVStore, height: int, report: FsckReport) -> None:
    """Remove every trace of a torn block above the tip. Safe by the
    protocol's own guarantee: the era that produced it will re-finalize the
    identical block after restart (deterministic execution over agreed
    txs), and its own tx/index rows must not shadow that replay."""
    hh_key = prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(height))
    h = kv.get(hh_key)
    deletes = [hh_key, prefixed(EntryPrefix.BLOCK_BLOOM, write_u64(height))]
    if h is not None:
        deletes.append(prefixed(EntryPrefix.BLOCK_BY_HASH, h))
        enc = kv.get(prefixed(EntryPrefix.BLOCK_BY_HASH, h))
        if enc is not None:
            try:
                from ..core.types import Block

                block = Block.decode(enc)
                for th in block.tx_hashes:
                    deletes.append(
                        prefixed(EntryPrefix.TRANSACTION_BY_HASH, th)
                    )
            except Exception:
                pass  # the block rows themselves still go
    # address-index rows for the height (prefix scan bounded by the u64
    # height segment living mid-key is not possible — drop via full scan
    # only in deep mode; quick mode leaves unreferenced index rows, which
    # read paths tolerate: they resolve through TRANSACTION_BY_HASH)
    kv.write_batch([], deletes)
    report.issues.append(
        FsckIssue(
            code="orphan-block",
            severity=REPAIRED,
            detail=f"block at height {height} above committed tip",
            repair=f"deleted {len(deletes)} block/tx rows; era will "
            "re-finalize deterministically",
        )
    )


def fsck(
    kv: KVStore, repair: bool = True, deep: bool = False
) -> FsckReport:
    """Scan the database's cross-keyspace invariants. With `repair`,
    safely-repairable issues are fixed in place (severity REPAIRED);
    without it they are reported FATAL so a read-only caller still sees
    them. Unrepairable states are always FATAL — callers must refuse to
    run (FsckError)."""
    report = FsckReport(deep=deep)
    repairable = REPAIRED if repair else FATAL

    tip = _tip(kv)
    report.checked.append("tip-roots")
    roots = None
    if tip is not None:
        enc = kv.get(
            prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(tip))
        )
        if enc is None:
            report.issues.append(
                FsckIssue(
                    code="tip-roots",
                    severity=FATAL,
                    detail=f"committed tip {tip} has no snapshot-index row "
                    "(state roots lost)",
                )
            )
        else:
            try:
                roots = StateRoots.decode(enc)
            except Exception:
                report.issues.append(
                    FsckIssue(
                        code="tip-roots",
                        severity=FATAL,
                        detail=f"snapshot-index row at tip {tip} does not "
                        "decode",
                    )
                )

    report.checked.append("tip-block")
    if tip is not None:
        h = kv.get(
            prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(tip))
        )
        if h is None or kv.get(prefixed(EntryPrefix.BLOCK_BY_HASH, h)) is None:
            report.issues.append(
                FsckIssue(
                    code="tip-block",
                    severity=FATAL,
                    detail=f"committed tip {tip} has state roots but no "
                    "stored block",
                )
            )

    # root-nodes: quick = the tip's tree roots resolve to stored trie
    # nodes; deep = DFS every retained snapshot's full node graph
    report.checked.append("root-nodes")
    if roots is not None:
        if deep:
            heights = []
            idx_prefix = prefixed(EntryPrefix.SNAPSHOT_INDEX)
            for key, _ in kv.scan_prefix(idx_prefix):
                heights.append(int.from_bytes(key[len(idx_prefix):], "big"))
            missing = _deep_trie_check(kv, sorted(heights))
            for h_hex, height in missing:
                report.issues.append(
                    FsckIssue(
                        code="root-nodes",
                        severity=FATAL,
                        detail=f"trie node {h_hex} unreachable for "
                        f"snapshot {height}",
                    )
                )
        else:
            for r in roots.all_roots():
                if r == EMPTY_ROOT:
                    continue
                if kv.get(prefixed(EntryPrefix.TRIE_NODE, r)) is None:
                    report.issues.append(
                        FsckIssue(
                            code="root-nodes",
                            severity=FATAL,
                            detail=f"tip {tip} root {r.hex()} has no "
                            "trie node (trie torn)",
                        )
                    )

    # orphan blocks above the tip (block.persist.mid window)
    report.checked.append("orphan-block")
    base = -1 if tip is None else tip
    if deep:
        hh_prefix = prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT)
        orphans = [
            int.from_bytes(key[len(hh_prefix):], "big")
            for key, _ in kv.scan_prefix(hh_prefix)
            if int.from_bytes(key[len(hh_prefix):], "big") > base
        ]
    else:
        orphans = [
            h
            for h in range(base + 1, base + 1 + ORPHAN_PROBE)
            if kv.get(
                prefixed(EntryPrefix.BLOCK_HASH_BY_HEIGHT, write_u64(h))
            )
            is not None
        ]
    for height in sorted(orphans):
        if repair:
            _delete_orphan_block(kv, height, report)
        else:
            report.issues.append(
                FsckIssue(
                    code="orphan-block",
                    severity=FATAL,
                    detail=f"block at height {height} above committed tip "
                    f"{tip}",
                )
            )

    # consensus journal: undecodable values and eras settled on-chain
    report.checked.append("journal")
    j_prefix = prefixed(EntryPrefix.CONSENSUS_STATE)
    bad_keys = []
    stale_keys = []
    cutoff = (tip if tip is not None else -1) + 1  # eras <= tip are settled
    for key, value in kv.scan_prefix(j_prefix):
        tail = key[len(j_prefix):]
        if len(tail) != 16:
            bad_keys.append(key)
            continue
        try:
            r = Reader(value)
            r.i64()
            r.bytes_()
        except Exception:
            bad_keys.append(key)
            continue
        if int.from_bytes(tail[:8], "big") < cutoff:
            stale_keys.append(key)
    if bad_keys:
        if repair:
            kv.write_batch([], bad_keys)
        report.issues.append(
            FsckIssue(
                code="journal-decode",
                severity=repairable,
                detail=f"{len(bad_keys)} undecodable journal entries",
                repair="dropped" if repair else None,
            )
        )
    if stale_keys:
        if repair:
            kv.write_batch([], stale_keys)
        report.issues.append(
            FsckIssue(
                code="journal-stale",
                severity=repairable,
                detail=f"{len(stale_keys)} journal entries for eras already "
                f"settled (< {cutoff})",
                repair="pruned" if repair else None,
            )
        )

    # Byzantine evidence records (consensus/evidence.py): malformed keys or
    # undecodable values are repairable garbage — an accusation that cannot
    # be decoded cannot be served and must not wedge la_getEvidence
    report.checked.append("evidence")
    from ..consensus.evidence import EvidenceRecord

    ev_prefix = prefixed(EntryPrefix.EVIDENCE)
    bad_ev = []
    for key, value in kv.scan_prefix(ev_prefix):
        if len(key) != len(ev_prefix) + 8:
            bad_ev.append(key)
            continue
        try:
            EvidenceRecord.decode(value)
        except Exception:
            bad_ev.append(key)
    if bad_ev:
        if repair:
            kv.write_batch([], bad_ev)
        report.issues.append(
            FsckIssue(
                code="evidence-decode",
                severity=repairable,
                detail=f"{len(bad_ev)} undecodable evidence records",
                repair="dropped" if repair else None,
            )
        )

    # pool repository: undecodable entries
    report.checked.append("pool")
    from ..core.types import SignedTransaction

    bad_pool = []
    p_prefix = prefixed(EntryPrefix.POOL_TX)
    for key, value in kv.scan_prefix(p_prefix):
        try:
            SignedTransaction.decode(value)
        except Exception:
            bad_pool.append(key)
    if bad_pool:
        if repair:
            kv.write_batch([], bad_pool)
        report.issues.append(
            FsckIssue(
                code="pool-decode",
                severity=repairable,
                detail=f"{len(bad_pool)} undecodable pool entries",
                repair="dropped" if repair else None,
            )
        )

    # fast-sync frontier spill rows: only meaningful DURING a sync; any
    # row present at open time is leftover from a sync that died mid-
    # download. The download itself is resumable by construction (present
    # trie nodes are skipped), so the rows are pure garbage.
    report.checked.append("fastsync-frontier")
    frontier_keys = [
        key
        for key, _ in kv.scan_prefix(prefixed(EntryPrefix.FASTSYNC_FRONTIER))
    ]
    if frontier_keys:
        if repair:
            kv.write_batch([], frontier_keys)
        report.issues.append(
            FsckIssue(
                code="fastsync-frontier",
                severity=repairable,
                detail=f"{len(frontier_keys)} frontier spill rows from an "
                "interrupted fast sync",
                repair="dropped; a restarted sync rediscovers the frontier"
                if repair
                else None,
            )
        )

    # shrink bookkeeping
    report.checked.append("shrink")
    shrink_state = kv.get(prefixed(EntryPrefix.SHRINK_STATE))
    if shrink_state is not None:
        report.issues.append(
            FsckIssue(
                code="shrink-resume",
                severity=NOTE,
                detail="interrupted shrink pass; resumes on next shrink run",
            )
        )
    else:
        mark_keys = [
            key for key, _ in kv.scan_prefix(prefixed(EntryPrefix.SHRINK_MARK))
        ]
        if mark_keys:
            if repair:
                kv.write_batch([], mark_keys)
            report.issues.append(
                FsckIssue(
                    code="shrink-marks",
                    severity=repairable,
                    detail=f"{len(mark_keys)} mark rows without an active "
                    "shrink pass",
                    repair="dropped" if repair else None,
                )
            )

    if report.fatal:
        logger.error("fsck: REFUSING database: %s", report.to_dict())
    elif not report.clean:
        logger.warning("fsck: repaired/notes: %s", report.to_dict())
    return report


def verify_imported_state(
    kv: KVStore, expect_state_hash: Optional[bytes]
) -> Optional[str]:
    """Migration/snapshot contract check for `db import`: the imported
    store's TIP state roots must hash to `expect_state_hash` (the value
    the operator read from a trusted block header), and the tip trie must
    be fully present. Returns None when the store passes, else a
    human-readable refusal reason. A dump is NOT self-certifying — only
    the operator-supplied expectation ties it to the real chain."""
    tip = _tip(kv)
    if tip is None:
        return "imported store has no committed tip height"
    enc = kv.get(prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(tip)))
    if enc is None:
        return f"imported store has no state roots at tip {tip}"
    try:
        roots = StateRoots.decode(enc)
    except Exception:
        return f"imported state roots at tip {tip} do not decode"
    if expect_state_hash is None:
        return (
            "refusing to trust the dump blindly: pass --expect-root with "
            "the state hash from a trusted block header "
            f"(imported tip {tip} announces {roots.state_hash().hex()})"
        )
    if roots.state_hash() != expect_state_hash:
        return (
            f"imported state root mismatch at tip {tip}: expected "
            f"{expect_state_hash.hex()}, dump contains "
            f"{roots.state_hash().hex()}"
        )
    missing = _deep_trie_check(kv, [tip])
    if missing:
        return (
            f"imported tip {tip} trie is incomplete: "
            f"{len(missing)} unreachable nodes (first {missing[0][0]})"
        )
    return None


def _deep_trie_check(kv: KVStore, heights) -> list:
    """Full DFS from every retained snapshot root; returns
    [(missing_hash_hex, height), ...]. Marks visited hashes so shared
    subtrees cost one walk."""
    missing = []
    seen = set()
    for height in heights:
        enc = kv.get(
            prefixed(EntryPrefix.SNAPSHOT_INDEX, write_u64(height))
        )
        if enc is None:
            continue
        try:
            roots = StateRoots.decode(enc)
        except Exception:
            missing.append(("<roots-undecodable>", height))
            continue
        stack = [r for r in roots.all_roots() if r != EMPTY_ROOT]
        while stack:
            h = stack.pop()
            if h in seen:
                continue
            seen.add(h)
            node_enc = kv.get(prefixed(EntryPrefix.TRIE_NODE, h))
            if node_enc is None:
                missing.append((h.hex(), height))
                continue
            try:
                node = _decode_node(node_enc)
            except Exception:
                missing.append((h.hex(), height))
                continue
            if isinstance(node, InternalNode):
                stack.extend(c for c in node.children if c != EMPTY_ROOT)
    return missing
