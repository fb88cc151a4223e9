"""Incremental index updates — beyond the paper's full ``refresh()``
(port of ``repro.core.updates``).

The paper rebuilds the whole index on dataset change (Sec. IV-A). Because
our meta-HNSW routing is stable under insertions (new items are assigned
to existing partitions by Alg. 3 lines 7-10), we can support *online
inserts* by rebuilding ONLY the sub-HNSWs that received new items — the
meta-HNSW, partition labels and all untouched shards are reused.

This keeps insert cost at O(|affected shards|) instead of O(w), which is
the production middle ground between per-item graph insertion (hard to do
well online) and the paper's full rebuild.

Durability: when the index is attached to a published store version
(``repro_torch.store.IndexStore`` publish/load), every ``add_items`` and
``remove_items`` call is journaled to that version's append-only delta
log *after* it is applied — inserts as vector records, removals as
tombstones — so both survive a restart: ``IndexStore.load`` replays the
log in journal order through these same functions (same ``shard_seed``,
bit-identical rebuild).

New items are routed by a meta-HNSW search (``k=1``, ``ef=32``) on the
index's device, so on the card ``add_items`` launches the beam kernel;
the shard rebuilds run on the host builder, the same code as the
reference's, so a shard's graph is bit-identical in both packages.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import hnsw as H
from repro_torch.core import metrics as M
from repro_torch.core.meta_index import PyramidIndex, _assign_items


def _merge_tags(old: "H.HNSWGraph", new_tags: Optional[np.ndarray],
                m: int) -> Optional[np.ndarray]:
    """Tag column for a shard rebuild that appends ``m`` items: ``None``
    when neither side carries tags (the untagged fast path stays
    untagged), else old tags (zeros if absent) + new tags (zeros if
    absent)."""
    if old.tags is None and new_tags is None:
        return None
    new_col = (np.zeros(m, np.int64) if new_tags is None
               else np.asarray(new_tags, np.int64))
    return np.concatenate([old.tags_or_zeros(), new_col])


def add_items(index: PyramidIndex, new_items: np.ndarray,
              new_ids: Optional[np.ndarray] = None, *,
              tags: Optional[np.ndarray] = None,
              log_delta: bool = True) -> PyramidIndex:
    """Insert ``new_items`` into an existing index (in place).

    Args:
      index: a built PyramidIndex.
      new_items: [m, d] raw vectors (normalised internally for angular).
      new_ids: optional global ids; defaults to continuing after the
        current max id.
      tags: optional [m] int64 metadata tag bitsets for the new items
        (``repro_torch.core.filters``); omitted means tag 0 (matches no
        non-empty filter). Journaled with the insert and replayed, so
        tags survive restart and compaction.
      log_delta: journal this insert to the index's attached store delta
        log (no-op when the index is not store-attached). The replay
        path passes ``False`` — replaying must not re-journal.

    Returns the same index object with affected sub-HNSWs rebuilt.
    """
    cfg = index.config
    log = index.delta_log() if log_delta else None
    if log is not None:
        # fail BEFORE mutating: if the journal can no longer accept
        # records (its version was GC'd), raising after the in-memory
        # apply would leave a half-committed state a retry duplicates
        log.ensure_writable()
    # cast BEFORE preprocessing: the delta journal stores float32, and
    # replay must normalise the exact bytes the live apply normalised
    # (angular preprocessing keeps the input dtype, so float64 input
    # would otherwise round differently on replay)
    new_items = np.asarray(new_items, np.float32)
    x = M.preprocess_dataset(new_items, cfg.metric)
    if new_ids is None:
        # next free id = max over the non-empty shards (a skewed
        # partition or remove_items can leave a zero-item shard whose
        # ids.max() would raise) AND the persistent high-water mark —
        # without the watermark, ids freed by an un-journaled
        # remove_items would be reused, and delta replay onto the
        # published state (where the removed item still exists) would
        # alias one global id to two different vectors
        occupied = [int(g.ids.max()) for g in index.subs if g.ids.size]
        hwm = int(index.build_stats.get("max_assigned_id", -1))
        cur_max = max(occupied + [hwm], default=-1)
        new_ids = np.arange(cur_max + 1, cur_max + 1 + x.shape[0],
                            dtype=np.int64)
    else:
        new_ids = np.asarray(new_ids, dtype=np.int64)
    if new_ids.size:
        index.build_stats["max_assigned_id"] = max(
            int(index.build_stats.get("max_assigned_id", -1)),
            int(new_ids.max()))
    metric = "ip" if cfg.is_mips else cfg.metric
    if tags is not None:
        tags = np.asarray(tags, dtype=np.int64).ravel()

    parts = _assign_items(x, index.meta_arrays(), index.part_of_center,
                          metric)
    affected: List[int] = sorted(set(parts.tolist()))
    for s in affected:
        sel = parts == s
        old = index.subs[s]
        data = np.concatenate([old.data, x[sel]])
        ids = np.concatenate([old.ids, new_ids[sel]])
        index.subs[s] = H.build_hnsw(
            data, metric=metric, max_degree=cfg.max_degree,
            max_degree_upper=cfg.max_degree_upper,
            ef_construction=cfg.ef_construction,
            seed=H.shard_seed(cfg.seed, s), ids=ids,
            tags=_merge_tags(old, None if tags is None else tags[sel],
                             int(sel.sum())))
    index.build_stats["sub_sizes"] = [g.n for g in index.subs]
    index.build_stats["total_stored"] = sum(g.n for g in index.subs)
    index.invalidate_device_cache()   # subs changed: arena must rebuild
    if log is not None:
        # journal AFTER the in-memory apply (a crash mid-rebuild must
        # not leave a committed record the memory state never saw),
        # with the raw-but-f32 vectors + resolved ids: replay goes
        # back through add_items itself, preprocessing included. If
        # this append itself fails, the in-memory apply HAS happened —
        # the exception signals lost durability, not a failed insert.
        log.append(new_items, new_ids, tags=tags)
    return index


def remove_items(index: PyramidIndex, remove_ids: np.ndarray, *,
                 log_delta: bool = True) -> PyramidIndex:
    """Delete items by global id; affected sub-HNSWs are rebuilt.

    Removing every item of a shard leaves a truly-empty sub-HNSW
    (``H.empty_hnsw``): searches skip it and the arena pads it with an
    inert row, so a deleted id can never be returned by any path.

    Durable on store-attached indexes: the removal is journaled as a
    tombstone record *after* it is applied (``log_delta=False`` on the
    replay path), so crash recovery cannot resurrect deleted vectors.
    """
    cfg = index.config
    metric = "ip" if cfg.is_mips else cfg.metric
    remove_ids = np.asarray(remove_ids, dtype=np.int64).ravel()
    log = index.delta_log() if log_delta else None
    if log is not None:
        # fail BEFORE mutating, same contract as add_items
        log.ensure_writable()
    # pin the high-water mark BEFORE freeing ids: a later add_items must
    # never hand a removed item's id to a new vector (delta replay onto
    # the published state would alias the id to both)
    occupied = [int(g.ids.max()) for g in index.subs if g.ids.size]
    index.build_stats["max_assigned_id"] = max(
        occupied + [int(index.build_stats.get("max_assigned_id", -1))],
        default=-1)
    to_remove = set(remove_ids.tolist())
    for s, old in enumerate(index.subs):
        keep = np.asarray([int(i) not in to_remove for i in old.ids],
                          dtype=bool)
        if keep.size and keep.all():
            continue
        if not keep.any():
            index.subs[s] = H.empty_hnsw(
                old.d, metric=metric, max_degree=cfg.max_degree)
            continue
        index.subs[s] = H.build_hnsw(
            old.data[keep], metric=metric, max_degree=cfg.max_degree,
            max_degree_upper=cfg.max_degree_upper,
            ef_construction=cfg.ef_construction,
            seed=H.shard_seed(cfg.seed, s), ids=old.ids[keep],
            tags=None if old.tags is None else old.tags[keep])
    index.build_stats["sub_sizes"] = [g.n for g in index.subs]
    index.build_stats["total_stored"] = sum(g.n for g in index.subs)
    index.invalidate_device_cache()   # subs changed: arena must rebuild
    if log is not None:
        # journal AFTER the in-memory apply (mirrors add_items): replay
        # re-runs remove_items on the published state in journal order,
        # so a crash can never resurrect a deleted vector
        log.append_remove(remove_ids)
    return index


def set_item_tags(index: PyramidIndex, ids: np.ndarray,
                  tags: np.ndarray, *,
                  log_delta: bool = True) -> PyramidIndex:
    """Assign metadata tag bitsets to existing items by global id.

    Tags are per-node metadata — they never influence graph structure —
    so this mutates the sub-HNSW tag columns in place without any
    rebuild (cost O(total items), no device upload until the next
    search). Ids absent from the index are ignored; under MIPS
    replication every replica of an id receives the tag.

    Durable on store-attached indexes: journaled as an ``op="tags"``
    delta record applied in journal order on replay, so a tag written
    before a crash (or folded by the compactor) is never lost.
    """
    ids = np.asarray(ids, dtype=np.int64).ravel()
    tags = np.broadcast_to(
        np.asarray(tags, dtype=np.int64), ids.shape).ravel()
    log = index.delta_log() if log_delta else None
    if log is not None:
        log.ensure_writable()   # fail BEFORE mutating (same as add_items)
    tag_of = dict(zip(ids.tolist(), tags.tolist()))
    for g in index.subs:
        if not g.n:
            continue
        hits = [i for i, gid in enumerate(np.asarray(g.ids, np.int64))
                if int(gid) in tag_of]
        if not hits:
            continue
        col = g.tags_or_zeros()
        for i in hits:
            col[i] = tag_of[int(np.asarray(g.ids)[i])]
        g.tags = col
    # only the tag caches are stale: graphs, arenas and rerank tables
    # are untouched, so a full invalidate (and the arena re-upload it
    # forces) would be wasted work
    index._tags_arena = None
    index._tags_host = None
    if log is not None:
        log.append_tags(ids, tags)
    return index
