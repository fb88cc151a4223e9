"""Versioned on-disk index store (the paper's HDFS persistence layer;
port of ``repro.store``, same on-disk format):

  * per-shard ``.npz`` segments + a meta segment + ``manifest.json``
    (config, shard list, content checksums, version id);
  * crash-safe atomic publish: segments are written to a tmpdir and the
    whole version appears with one ``rename``;
  * lazy per-shard loading (:meth:`IndexStore.reader`);
  * an append-only delta log that ``repro_torch.core.updates`` writes
    through, replayed on load;
  * GC of superseded versions (:meth:`IndexStore.gc`);
  * online maintenance (:class:`Compactor`): the log folded into a new
    version, shard split/merge and centroid refresh, a hot swap.

    from repro_torch.store import IndexStore
    store = IndexStore("/data/pyramid/wiki")
    vid = store.publish(index)          # atomic; attaches the delta log
    index = store.load(device="cuda")   # latest version + delta replay
"""
from repro_torch.store.format import (StoreCorruptionError, StoreError,
                                      content_checksum, graph_from_arrays,
                                      graph_to_arrays, read_segment,
                                      write_segment)
from repro_torch.store.maintenance import Compactor
from repro_torch.store.store import DeltaLog, IndexStore, StoreReader

__all__ = [
    "Compactor", "DeltaLog", "IndexStore", "StoreReader",
    "StoreCorruptionError", "StoreError",
    "content_checksum", "graph_from_arrays", "graph_to_arrays",
    "read_segment", "write_segment",
]
