"""DbShrink: prune trie nodes unreachable from recent checkpoints.

The port of `lachain_tpu/storage/shrink.py` (the C# reference's DbShrink):
the content-addressed trie never collects garbage on its own (every
historical root keeps its nodes alive), so a long-running node prunes the
snapshots older than a retention depth with a staged, RESUMABLE
mark-and-sweep:

  stage MARK   walk every retained root (heights in [cutoff, tip]) and
               persist a mark row per reachable node hash; progress is
               checkpointed per height, so a crash resumes where it left
  stage SWEEP  scan every trie node, delete the unmarked ones
  stage CLEAN  drop the mark rows and the stale snapshot-index rows

The stage and its cursor live in the KV (SHRINK_STATE, JSON), in the JAX
package's encoding, so either package resumes the other's pass.

Difference, by design: the reference writes each mark row, each swept
node's delete and each mark's removal as a write of its own, one fsync
each (two fsyncs and more a retained node). The port writes a height's
marks together with that height's progress row in one atomic batch, and
the sweep's and the clean stage's deletes in batches of `BATCH`. The rows
at every checkpoint (the `shrink.*` crash points) are the reference's,
and a crash inside a height now leaves none of its marks, where the
reference's could leave a node marked before its children (which a
resumed walk would then never mark). Over LsmKV at a million accounts the
reference's writes would take ~2.9M fsyncs. Its reads, one `get` a node
for its mark and one for its row in the mark stage and one a node for its
mark in the sweep, are prefix scans here: the mark stage reads the
existing marks and the node rows once (a row missing from the scan is
read through the trie, which raises on a missing node as the reference
does), the sweep reads the marks once.
"""
from __future__ import annotations

import json
import logging
from typing import List, Optional

from .crashpoints import crash_point
from .kv import EntryPrefix, KVStore, prefixed
from .fsck import trie_node_rows
from .state import StateManager, StateRoots
from .trie import EMPTY_ROOT, InternalNode, _decode

logger = logging.getLogger(__name__)

_STATE_KEY = prefixed(EntryPrefix.SHRINK_STATE)
_MARK = EntryPrefix.SHRINK_MARK
_MARK_PREFIX = prefixed(_MARK)
BATCH = 4096  # deletes a write_batch in the sweep and clean stages


class DbShrink:
    def __init__(self, state: StateManager, kv: KVStore):
        self.state = state
        self.kv = kv

    # -- progress bookkeeping -----------------------------------------------

    def _load_progress(self) -> Optional[dict]:
        raw = self.kv.get(_STATE_KEY)
        return json.loads(raw.decode()) if raw else None

    def _save_progress(self, p: dict, marks=()) -> None:
        """The progress row, in one atomic batch with `marks` (mark keys)."""
        self.kv.write_batch(
            [(k, b"\x01") for k in marks]
            + [(_STATE_KEY, json.dumps(p).encode())]
        )

    def _delete(self, keys) -> None:
        for i in range(0, len(keys), BATCH):
            self.kv.write_batch([], keys[i : i + BATCH])

    # -- the staged shrink ---------------------------------------------------

    def shrink(self, retain_depth: int) -> dict:
        """Prune everything below (tip - retain_depth). Safe to re-invoke
        after a crash: resumes from the persisted stage/cursor. Returns
        stats {marked, swept, cutoff}."""
        tip = self.state.committed_height()
        if tip is None:
            return {"marked": 0, "swept": 0, "cutoff": 0}
        progress = self._load_progress()
        if progress is None:
            cutoff = max(0, tip - retain_depth)
            progress = {
                "stage": "mark",
                "cutoff": cutoff,
                "tip": tip,
                "next_height": cutoff,
                "marked": 0,
            }
            self._save_progress(progress)
        # a resumed run keeps its original CUTOFF (marks below it were never
        # made) but must extend the mark range to the CURRENT tip: blocks
        # committed between crash and resume would otherwise have their trie
        # nodes swept as unmarked — corrupting the newest state. Extra
        # marking is always safe; missing marks never are.
        cutoff = progress["cutoff"]
        if tip > progress["tip"]:
            old_tip = progress["tip"]
            progress["tip"] = tip
            if progress["stage"] != "mark":
                # the sweep/clean stages must never run with unmarked recent
                # heights: fall back to marking the delta first
                progress["stage"] = "mark"
                progress["next_height"] = old_tip + 1
            self._save_progress(progress)
        tip = progress["tip"]

        if progress["stage"] == "mark":
            nodes = marked = None  # read by one scan each at the first roots
            while True:
                for height in range(progress["next_height"], tip + 1):
                    roots = self.state.roots_at(height)
                    marks = []
                    if roots is not None:
                        if nodes is None:
                            nodes, marked = trie_node_rows(self.kv), self._marked()
                        marks = self._mark_roots(roots, nodes, marked)
                    progress["marked"] += len(marks)
                    progress["next_height"] = height + 1
                    # per-height resume point, durable with its marks
                    self._save_progress(progress, marks)
                    if marked is not None:
                        marked.update(k[len(_MARK_PREFIX):] for k in marks)
                    crash_point("shrink.mark.height")
                # Re-check the tip before committing to sweep: marking takes
                # real time, and a block committed meanwhile (threaded caller,
                # CLI racing a live node) would have its nodes swept as
                # unmarked. Loop until the tip is stable across a full mark
                # pass — the same extend-don't-shrink rule as the resume path.
                # shrink() itself is synchronous, so an in-event-loop caller
                # cannot be raced past this point.
                new_tip = self.state.committed_height()
                if new_tip is None or new_tip <= tip:
                    break
                progress["tip"] = tip = new_tip
                self._save_progress(progress)
            progress["stage"] = "sweep"
            self._save_progress(progress)

        if progress["stage"] == "sweep":
            crash_point("shrink.sweep.pre")
            swept = self._sweep(progress)
            progress["swept"] = progress.get("swept", 0) + swept
            progress["stage"] = "clean"
            self._save_progress(progress)

        if progress["stage"] == "clean":
            crash_point("shrink.clean.pre")
            self._clean_marks()
            # drop pruned heights from the snapshot index: scan live index
            # rows (O(retained) after the first shrink) instead of probing
            # every height since genesis
            idx_prefix = prefixed(EntryPrefix.SNAPSHOT_INDEX)
            stale = []
            for key, _ in self.kv.scan_prefix(idx_prefix):
                height = int.from_bytes(key[len(idx_prefix):], "big")
                if height < cutoff:
                    stale.append(key)
            self._delete(stale)
            self.kv.delete(_STATE_KEY)

        stats = {
            "marked": progress.get("marked", 0),
            "swept": progress.get("swept", 0),
            "cutoff": cutoff,
        }
        logger.info("db shrink done: %s", stats)
        return stats

    # -- stages --------------------------------------------------------------

    def _marked(self) -> set:
        """The hashes of the mark rows, from one prefix scan."""
        return {key[len(_MARK_PREFIX):] for key, _ in self.kv.scan_prefix(_MARK_PREFIX)}

    def _mark_roots(self, roots: StateRoots, nodes: dict, marked: set) -> List[bytes]:
        """DFS from every tree root of a snapshot -> the mark keys of the
        nodes not marked yet, for the caller's batch (a node already
        marked, in `marked` or in this walk, prunes the whole subtree walk:
        structural sharing makes repeated roots cheap). `nodes` holds the
        node rows by hash; a node it lacks is loaded through the trie."""
        marks: List[bytes] = []
        seen = set()
        stack = [r for r in roots.all_roots() if r != EMPTY_ROOT]
        while stack:
            h = stack.pop()
            if h in seen or h in marked:
                continue
            seen.add(h)
            marks.append(prefixed(_MARK, h))
            enc = nodes.get(h)
            node = self.state.trie._load(h) if enc is None else _decode(enc)
            if isinstance(node, InternalNode):
                stack.extend(
                    c for c in node.children if c != EMPTY_ROOT
                )
        return marks

    def _sweep(self, progress: dict) -> int:
        node_prefix = prefixed(EntryPrefix.TRIE_NODE)
        marked = self._marked()
        doomed = [key for key, _ in self.kv.scan_prefix(node_prefix)
                  if key[len(node_prefix):] not in marked]
        # the scan takes real time too: a block committed during it (threaded
        # caller) has unmarked nodes sitting in `doomed`. Mark the tip delta
        # now and drop the newly marked keys before deleting. A commit landing
        # after THIS point and before the deletes finish is out of scope —
        # shrink() must not race commits from another thread/process past
        # here (the KV is single-writer; the node calls shrink on its own
        # event-loop thread where the whole run is atomic).
        new_tip = self.state.committed_height()
        if new_tip is not None and new_tip > progress["tip"]:
            for height in range(progress["tip"] + 1, new_tip + 1):
                roots = self.state.roots_at(height)
                if roots is not None:
                    marks = self._mark_roots(roots, {}, marked)
                    self.kv.write_batch([(k, b"\x01") for k in marks])
                    marked.update(k[len(_MARK_PREFIX):] for k in marks)
                    progress["marked"] += len(marks)
            progress["tip"] = new_tip
            self._save_progress(progress)
            doomed = [k for k in doomed if k[len(node_prefix):] not in marked]
        self._delete(doomed)
        # pruned nodes may still sit in the trie's LRU cache; a fresh run
        # only ever reads retained roots, but drop the cache for hygiene
        self.state.trie.clear_cache()
        return len(doomed)

    def _clean_marks(self) -> None:
        self._delete([key for key, _ in self.kv.scan_prefix(_MARK_PREFIX)])
