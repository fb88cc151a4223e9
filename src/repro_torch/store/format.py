"""Segment serialisation for the versioned index store (port of
``repro.store.format``: the same bytes and key names, so a segment's
content checksum is the same in both packages).

A *segment* is one ``.npz`` file holding a dict of numpy arrays (one
sub-HNSW, or the meta graph + partition labels). Integrity is tracked
with a **content checksum**: sha256 over the arrays' canonical bytes
(sorted key order; each key hashed with its name, dtype, shape, and raw
C-contiguous data). Hashing content instead of file bytes is deliberate:
``np.savez`` zip containers embed timestamps, so two bit-identical
indexes would hash to different *files* — while their content checksums
agree, which is exactly the determinism contract the parallel builder is
held to (parallel build == sequential build manifest checksums).
"""
from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Dict, List

import numpy as np

from repro_torch.core import hnsw as H


class StoreError(RuntimeError):
    """The store layout is missing or malformed."""


class StoreCorruptionError(StoreError):
    """A segment failed its checksum or could not be decoded."""


def content_checksum(arrays: Dict[str, np.ndarray]) -> str:
    """sha256 over the canonical bytes of an array dict (key-sorted)."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def graph_to_arrays(g: H.HNSWGraph) -> Dict[str, np.ndarray]:
    """Flatten one HNSW graph into a segment's array dict.

    Tag bitsets are persisted under a ``tags`` key — but only when any
    tag is non-zero: an untagged (or all-zero) graph serialises exactly
    as before this key existed, so historical segment checksums and the
    parallel-vs-sequential build determinism gate are unaffected.
    """
    out: Dict[str, np.ndarray] = {
        "data": np.ascontiguousarray(g.data, np.float32),
        "ids": np.ascontiguousarray(g.ids, np.int64),
        "levels": np.ascontiguousarray(g.levels, np.int32),
        "entry": np.asarray(g.entry, np.int64),
        "num_levels": np.asarray(len(g.neighbors), np.int64),
    }
    if g.tags is not None and np.any(np.asarray(g.tags)):
        out["tags"] = np.ascontiguousarray(g.tags, np.int64)
    for lvl, adj in enumerate(g.neighbors):
        out[f"nbr_{lvl}"] = np.ascontiguousarray(adj, np.int32)
    return out


def graph_from_arrays(arrays: Dict[str, np.ndarray],
                      metric: str) -> H.HNSWGraph:
    """Inverse of :func:`graph_to_arrays` (metric rides in the
    manifest, not the segment; a missing ``tags`` key means untagged)."""
    num_levels = int(arrays["num_levels"])
    neighbors: List[np.ndarray] = [
        arrays[f"nbr_{lvl}"] for lvl in range(num_levels)]
    tags = arrays.get("tags")
    return H.HNSWGraph(
        data=arrays["data"], ids=arrays["ids"], neighbors=neighbors,
        levels=arrays["levels"], entry=int(arrays["entry"]),
        metric=metric,
        tags=None if tags is None else np.asarray(tags, np.int64))


def write_segment(path: str, arrays: Dict[str, np.ndarray], *,
                  fsync: bool = True) -> str:
    """Write one segment and return its content checksum. Callers write
    into a not-yet-published tmpdir, so no in-place atomicity is needed
    here — the version-level rename is the publish barrier."""
    checksum = content_checksum(arrays)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return checksum


def read_segment(path: str, expected_checksum: str = "",
                 ) -> Dict[str, np.ndarray]:
    """Load one segment, verifying its content checksum when given."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, ValueError, KeyError, OSError,
            EOFError) as e:
        raise StoreCorruptionError(
            f"segment {path} could not be decoded: {e!r}") from e
    if expected_checksum:
        got = content_checksum(arrays)
        if got != expected_checksum:
            raise StoreCorruptionError(
                f"segment {path} checksum mismatch: manifest "
                f"{expected_checksum[:12]}.., file {got[:12]}..")
    return arrays
