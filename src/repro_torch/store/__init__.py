"""Versioned on-disk index store (the paper's HDFS persistence layer;
port of ``repro.store``, same on-disk format):

  * per-shard ``.npz`` segments + a meta segment + ``manifest.json``
    (config, shard list, content checksums, version id);
  * crash-safe atomic publish: segments are written to a tmpdir and the
    whole version appears with one ``rename``;
  * lazy per-shard loading (:meth:`IndexStore.reader`);
  * an append-only delta log that ``repro_torch.core.updates`` writes
    through, replayed on load;
  * GC of superseded versions (:meth:`IndexStore.gc`).

    from repro_torch.store import IndexStore
    store = IndexStore("/data/pyramid/wiki")
    vid = store.publish(index)          # atomic; attaches the delta log
    index = store.load(device="cuda")   # latest version + delta replay

The reference's ``Compactor`` (online maintenance) is not ported yet
(ROADMAP.md section 1, item 3).
"""
from repro_torch.store.format import (StoreCorruptionError, StoreError,
                                      content_checksum, graph_from_arrays,
                                      graph_to_arrays, read_segment,
                                      write_segment)
from repro_torch.store.store import DeltaLog, IndexStore, StoreReader

__all__ = [
    "DeltaLog", "IndexStore", "StoreReader",
    "StoreCorruptionError", "StoreError",
    "content_checksum", "graph_from_arrays", "graph_to_arrays",
    "read_segment", "write_segment",
]
