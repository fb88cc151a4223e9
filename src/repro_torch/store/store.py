"""The versioned index store: atomic publish, lazy reads, delta log, GC
(port of ``repro.store.store``).

The on-disk format is the reference's: a store published by either
package loads in the other, segment checksums are equal, and a delta
log written by one replays in the other to the same graphs. ``load``
builds the port's ``PyramidIndex`` on a device (``"cuda"`` unless the
caller asks for the CPU); the replay routes inserts on that device.

On-disk layout (one store root per dataset name)::

    root/
      CURRENT                     # text file: id of the published version
      versions/
        v0000001/
          manifest.json           # config, shard list, content checksums
          meta.npz                # meta-HNSW + part_of_center
          shard-0000.npz ...      # one segment per sub-HNSW
          delta/
            LOG                   # append-only jsonl of update records
            d000001.npz ...       # one per add_items / remove_items call

Crash-safety invariants:

  * a version is written to ``root/.tmp-<uuid>/`` and appears only via
    one atomic ``rename`` into ``versions/`` — readers can never observe
    a partial version, and a crashed publish leaves only a ``.tmp-``
    orphan that the next GC sweeps;
  * the version id is *claimed by the rename itself*: two concurrent
    publishers race on ``rename`` and the loser simply retries with the
    next id, so both end up with distinct, complete versions;
  * ``CURRENT`` is updated by write-tmp + ``os.replace`` (atomic on
    POSIX); if the process dies between the version rename and the
    ``CURRENT`` flip, :meth:`IndexStore.latest` falls back to the newest
    complete version on disk, so the publish still lands;
  * a delta record is two steps — write the ``.npz``, then append one
    jsonl line to ``LOG`` — and only the ``LOG`` line makes it real: a
    crash mid-append leaves an orphan file that replay ignores.
"""
from __future__ import annotations

import dataclasses
import errno
import fcntl
import json
import os
import shutil
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core import hnsw as H
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.store.format import (StoreError, graph_from_arrays,
                                graph_to_arrays, read_segment,
                                write_segment)

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_META_SEG = "meta.npz"
_CURRENT = "CURRENT"


def _jsonable(obj):
    """Coerce build stats (numpy scalars/arrays inside) to plain JSON."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _fsync_dir(path: str) -> None:
    try:   # best effort: not all filesystems allow dir fds
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


class DeltaLog:
    """Append-only update journal of one published version.

    Each :func:`repro_torch.core.updates.add_items` call appends one insert
    record (the *raw* vectors plus their resolved global ids), each
    ``remove_items`` call one tombstone record (ids only, LOG line
    tagged ``"op": "remove"`` — insert lines carry no ``op`` key, so an
    insert-only log is byte-identical to the pre-tombstone format), and
    each ``set_item_tags`` call one tag record (ids + tag bitsets, LOG
    line tagged ``"op": "tags"``).
    Replay applies records in journal order back through
    ``add_items``/``remove_items`` themselves, so the rebuilt shards are
    bit-identical to the pre-crash in-memory index. The jsonl ``LOG``
    line, written and fsynced *after* the record file, is the commit
    point.
    """

    def __init__(self, directory: str):
        self.dir = directory
        self.log_path = os.path.join(directory, "LOG")
        self._count: Optional[int] = None   # committed records (cached)
        self._log_size: int = -1            # LOG size when cached

    def _entries(self) -> List[dict]:
        try:
            with open(self.log_path, "rb") as f:
                body = f.read()
        except OSError:
            return []
        # the trailing newline IS the commit point (append fsyncs the
        # line and its newline together): a tail without one is an
        # uncommitted torn write — the exact bytes _heal_tail truncates
        # before the next append, so reader and writer agree on what
        # committed even when the torn tail happens to parse as JSON
        body = body[: body.rfind(b"\n") + 1]
        entries = []
        for line in body.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                # torn mid-file line (should not happen given the
                # commit rule): treat everything after it as torn too
                break
        return entries

    def __len__(self) -> int:
        return len(self._entries())

    def ensure_writable(self) -> None:
        """Raise unless the owning version still exists. Journaling into
        a GC'd version would silently makedirs a ghost delta dir no
        restart path can ever find or replay; ``add_items`` calls this
        BEFORE mutating the index so the failure is clean."""
        vdir = os.path.dirname(os.path.abspath(self.dir))
        if not os.path.exists(os.path.join(vdir, _MANIFEST)):
            raise StoreError(
                f"delta log's version at {vdir} is gone (superseded and "
                "GC'd?); publish a new version before journaling inserts")

    def _heal_tail(self) -> None:
        """Truncate a torn final line (crash mid-append). Replay already
        ignores the fragment, but appending after it would glue the next
        — fully committed — record onto the same physical line and lose
        it on every future replay."""
        try:
            size = os.path.getsize(self.log_path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.log_path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            body = f.read()
            keep = body.rfind(b"\n") + 1   # 0 when no complete line
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())

    def append(self, vectors: np.ndarray, ids: np.ndarray, *,
               tags: Optional[np.ndarray] = None) -> str:
        """Commit one insert record.

        Safe against concurrent writers *on the same host*: the whole
        append runs under an advisory ``flock`` and the record file is
        claimed with ``O_EXCL``, so two attached indexes journaling into
        the same version cannot clobber each other's records or
        interleave LOG lines (cross-host writers on network filesystems
        without flock semantics are out of scope).

        ``tags`` (optional [m] int64 bitsets) ride in the record under a
        ``tags`` array — included only when any tag is non-zero, so
        untagged insert records stay byte-identical to the pre-tag
        format."""
        arrays = {"vectors": np.ascontiguousarray(vectors, np.float32),
                  "ids": np.ascontiguousarray(ids, np.int64)}
        if tags is not None and np.any(np.asarray(tags)):
            arrays["tags"] = np.ascontiguousarray(tags, np.int64)
        return self._commit(arrays, {})

    def append_remove(self, ids: np.ndarray) -> str:
        """Commit one tombstone record (ids only; the LOG line carries
        ``"op": "remove"`` — insert lines stay untagged, keeping
        insert-only logs byte-identical to the pre-tombstone format)."""
        return self._commit(
            {"ids": np.ascontiguousarray(ids, np.int64)},
            {"op": "remove"})

    def append_tags(self, ids: np.ndarray, tags: np.ndarray) -> str:
        """Commit one tag-assignment record (``op: "tags"``): replay
        routes it through ``set_item_tags`` so metadata writes survive
        restart and compaction like inserts and removals do."""
        return self._commit(
            {"ids": np.ascontiguousarray(ids, np.int64),
             "tags": np.ascontiguousarray(tags, np.int64)},
            {"op": "tags"})

    def _commit(self, arrays: Dict[str, np.ndarray], extra: dict) -> str:
        self.ensure_writable()
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, ".lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            self._heal_tail()
            try:
                size = os.path.getsize(self.log_path)
            except OSError:
                size = 0
            if self._count is None or size != self._log_size:
                # first append, or another writer grew the LOG since we
                # cached: rescan (the common single-writer path stays
                # one initial scan + O(1) per append)
                self._count = len(self._entries())
            seq = self._count + 1
            while True:   # crashed-append orphans may occupy the name;
                fname = f"d{seq:06d}.npz"   # O_EXCL claims atomically
                fpath = os.path.join(self.dir, fname)
                try:
                    os.close(os.open(
                        fpath, os.O_WRONLY | os.O_CREAT | os.O_EXCL))
                    break
                except FileExistsError:
                    seq += 1
            checksum = write_segment(fpath, arrays)
            # persist the record's DIRECTORY ENTRY before committing the
            # LOG line: fsyncing the file alone does not survive a power
            # loss, and a committed line pointing at a missing file
            # would turn every future replay into StoreCorruptionError
            _fsync_dir(self.dir)
            line = json.dumps(dict(
                {"file": fname, "checksum": checksum,
                 "n": int(arrays["ids"].shape[0]),
                 "t": time.time()}, **extra))
            with open(self.log_path, "a") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._count += 1
            self._log_size = os.path.getsize(self.log_path)
        return fname

    def replay(self, *, verify: bool = True, start: int = 0
               ) -> Iterator[Tuple[str, Optional[np.ndarray], np.ndarray,
                                   Optional[np.ndarray]]]:
        """Yield committed ``(op, vectors, ids, tags)`` records in
        append order — ``op`` is ``"insert"`` (vectors present),
        ``"remove"`` (tombstone, vectors ``None``) or ``"tags"`` (tag
        assignment: ids + tags, vectors ``None``); ``tags`` is ``None``
        for untagged inserts and removals. ``start`` skips the first
        ``start`` records (the compactor's catch-up reads only the tail
        appended after its fold snapshot)."""
        for entry in self._entries()[start:]:
            arrays = read_segment(
                os.path.join(self.dir, entry["file"]),
                entry["checksum"] if verify else "")
            op = entry.get("op", "insert")
            yield (op, arrays.get("vectors"), arrays["ids"],
                   arrays.get("tags"))

    def truncate(self) -> int:
        """Drop every committed record (the compactor calls this once
        the log's contents are folded into a *newer published version*
        — after that rename the records are dead weight: recovery loads
        the newer version, never this log). Removes the record files and
        empties ``LOG`` under the same advisory lock appends take.
        Returns the number of records dropped."""
        if not os.path.isdir(self.dir):
            return 0   # never appended to: nothing to drop
        with open(os.path.join(self.dir, ".lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            entries = self._entries()
            # empty LOG first: a crash mid-truncate must not leave
            # committed lines pointing at deleted record files
            with open(self.log_path, "w") as f:
                f.flush()
                os.fsync(f.fileno())
            for entry in entries:
                try:
                    os.remove(os.path.join(self.dir, entry["file"]))
                except OSError:
                    pass
            _fsync_dir(self.dir)
            self._count = 0
            self._log_size = 0
        return len(entries)


class StoreReader:
    """Lazy, checksum-verified view of ONE published version.

    Loads the manifest eagerly and segments on demand —
    :meth:`load_shard` reads exactly one ``.npz``, which is how an
    engine executor fetches only the shard it serves instead of paying
    for the whole index.
    """

    def __init__(self, version_dir: str, *, verify: bool = True):
        self.dir = version_dir
        self.verify = verify
        mpath = os.path.join(version_dir, _MANIFEST)
        try:
            with open(mpath) as f:
                self.manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise StoreError(
                f"unreadable manifest at {mpath}: {e!r}") from e

    @property
    def version(self) -> str:
        return self.manifest["version"]

    @property
    def num_shards(self) -> int:
        return len(self.manifest["shards"])

    @property
    def config(self) -> PyramidConfig:
        return PyramidConfig(**self.manifest["config"])

    @property
    def metric(self) -> str:
        return self.manifest["metric"]

    def _read(self, entry: dict) -> Dict[str, np.ndarray]:
        return read_segment(
            os.path.join(self.dir, entry["file"]),
            entry["checksum"] if self.verify else "")

    def load_meta(self) -> Tuple[H.HNSWGraph, np.ndarray]:
        arrays = self._read(self.manifest["meta"])
        part = arrays.pop("part_of_center")
        return (graph_from_arrays(arrays, self.metric),
                part.astype(np.int32))

    def load_shard(self, i: int) -> H.HNSWGraph:
        """Read one sub-HNSW segment (lazy: touches only its file)."""
        return graph_from_arrays(
            self._read(self.manifest["shards"][i]), self.metric)

    def delta_log(self) -> DeltaLog:
        return DeltaLog(os.path.join(self.dir, "delta"))


class IndexStore:
    """Versioned store for one dataset's Pyramid indexes."""

    # gc() sweeps .tmp-/.trash- orphans only once they are older than
    # this — a younger tmpdir may belong to a publish still in flight
    ORPHAN_GRACE_S = 3600.0

    def __init__(self, root: str):
        self.root = str(root)
        self.versions_dir = os.path.join(self.root, "versions")

    # -- version bookkeeping ----------------------------------------------

    def versions(self) -> List[str]:
        """Complete (manifest-bearing) versions, oldest first."""
        if not os.path.isdir(self.versions_dir):
            return []
        return sorted(
            v for v in os.listdir(self.versions_dir)
            if os.path.exists(
                os.path.join(self.versions_dir, v, _MANIFEST)))

    def latest(self) -> Optional[str]:
        """The published version id — newest-wins between a valid
        ``CURRENT`` and the newest complete version on disk. The rename
        that lands a version IS its commit point: a crash between the
        rename and the ``CURRENT`` flip (a normal publish, or the
        compactor dying between its publish/truncate and flip steps)
        must still recover to the newer version, or the compactor's
        already-truncated delta records would be lost. ``_set_current``
        is newest-wins too, so ``CURRENT`` never legitimately points
        behind the newest complete version."""
        cur = None
        try:
            with open(os.path.join(self.root, _CURRENT)) as f:
                vid = f.read().strip()
            if vid and os.path.exists(
                    os.path.join(self.versions_dir, vid, _MANIFEST)):
                cur = vid
        except OSError:
            pass
        vs = self.versions()
        newest = vs[-1] if vs else None
        if self._vnum(newest) > self._vnum(cur):
            return newest
        return cur

    def version_dir(self, vid: str) -> str:
        return os.path.join(self.versions_dir, vid)

    def version_bytes(self, vid: str) -> int:
        total = 0
        for base, _, files in os.walk(self.version_dir(vid)):
            total += sum(
                os.path.getsize(os.path.join(base, f)) for f in files)
        return total

    # -- publish -----------------------------------------------------------

    def publish(self, index: PyramidIndex, *,
                keep: Optional[int] = None,
                set_current: bool = True) -> str:
        """Write ``index`` as a new version and flip ``CURRENT`` to it.

        Returns the version id. The index object is attached to the new
        version's (empty) delta log, so subsequent ``add_items`` calls
        are journaled against what was just published. ``keep`` runs
        :meth:`gc` afterwards. ``set_current=False`` skips the
        ``CURRENT`` flip (the compactor sequences truncate between the
        rename and the flip; the rename alone already commits — see
        :meth:`latest`).
        """
        os.makedirs(self.versions_dir, exist_ok=True)
        tmp = os.path.join(self.root, f".tmp-{uuid.uuid4().hex[:12]}")
        os.makedirs(tmp)
        try:
            meta_arrays = graph_to_arrays(index.meta)
            meta_arrays["part_of_center"] = np.ascontiguousarray(
                index.part_of_center, np.int32)
            meta_entry = {
                "file": _META_SEG,
                "checksum": write_segment(
                    os.path.join(tmp, _META_SEG), meta_arrays),
                "n": index.meta.n,
            }
            shard_entries = []
            for i, g in enumerate(index.subs):
                fname = f"shard-{i:04d}.npz"
                checksum = write_segment(
                    os.path.join(tmp, fname), graph_to_arrays(g))
                shard_entries.append(
                    {"file": fname, "checksum": checksum, "n": g.n})
            os.makedirs(os.path.join(tmp, "delta"))
            metric = ("ip" if index.config.is_mips
                      else index.config.metric)
            manifest = {
                "format_version": FORMAT_VERSION,
                "created_at": time.time(),
                "config": _jsonable(dataclasses.asdict(index.config)),
                "metric": metric,
                "build_stats": _jsonable(index.build_stats),
                "meta": meta_entry,
                "shards": shard_entries,
            }
            # persist the frozen int8 grid on every publish of a
            # non-empty index: a reopened index must requantize on the
            # IDENTICAL grid (not re-derive one from post-replay data),
            # or its codes would drift from the pre-restart engine's.
            # Deriving here also freezes the live index's grid at
            # publish time, so an engine that turns quantize=True on
            # later (pre- or post-crash) lands on the same grid as its
            # recovery path. Cost: one min/max pass over data publish
            # already reads in full for checksums. An all-empty index
            # (every shard zero items) has nothing to quantize — skip
            # rather than fail the publish.
            if any(g.n for g in index.subs):
                manifest["quant"] = index.quant_params().to_manifest()
            # segment dir entries must be durable BEFORE the rename
            # makes the version discoverable (a complete-looking
            # manifest must never reference files lost to power loss)
            _fsync_dir(tmp)
            # claim a version id with the rename itself: a concurrent
            # publisher that wins the id makes our rename fail, and we
            # retry with the next one — both publishes land, atomically
            for _ in range(10_000):
                vs = self.versions()
                nxt = 1 + max(
                    (int(v[1:]) for v in vs
                     if v.startswith("v") and v[1:].isdigit()),
                    default=0)
                vid = f"v{nxt:07d}"
                manifest["version"] = vid
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f, indent=1, sort_keys=True)
                    f.flush()
                    os.fsync(f.fileno())
                try:
                    os.rename(tmp, self.version_dir(vid))
                    break
                except OSError as e:
                    # only an id collision is retryable; a permission /
                    # quota / IO failure would spin the full retry
                    # budget and then hide the real errno
                    if e.errno not in (errno.EEXIST, errno.ENOTEMPTY):
                        raise
                    continue   # id already claimed: recompute and retry
            else:
                raise StoreError(
                    f"could not claim a version id under "
                    f"{self.versions_dir}")
            _fsync_dir(self.versions_dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if set_current:
            self._set_current(vid)
        index.attach_delta_log(
            DeltaLog(os.path.join(self.version_dir(vid), "delta")))
        if keep is not None:
            self.gc(keep=keep)
        return vid

    @staticmethod
    def _vnum(vid: Optional[str]) -> int:
        if vid and vid.startswith("v") and vid[1:].isdigit():
            return int(vid[1:])
        return -1

    def set_current(self, vid: str) -> None:
        """Publicly flip ``CURRENT`` (newest-wins; see
        :meth:`_set_current`) — the compactor's final metadata step
        after publishing with ``set_current=False`` and truncating."""
        self._set_current(vid)

    def _set_current(self, vid: str) -> None:
        """Flip ``CURRENT`` to ``vid`` — newest-wins under an advisory
        lock: a descheduled publisher resuming late must not flip
        ``CURRENT`` back onto its (older) version after a newer publish
        already landed (the classic lost-update)."""
        with open(os.path.join(self.root, ".current.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                with open(os.path.join(self.root, _CURRENT)) as f:
                    cur = f.read().strip()
            except OSError:
                cur = None
            if self._vnum(cur) >= self._vnum(vid):
                return   # a newer (or same) publish already flipped it
            tmp = os.path.join(self.root,
                               f".{_CURRENT}.{uuid.uuid4().hex[:8]}")
            with open(tmp, "w") as f:
                f.write(vid + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.root, _CURRENT))
            _fsync_dir(self.root)

    # -- load --------------------------------------------------------------

    def reader(self, version: Optional[str] = None, *,
               verify: bool = True) -> StoreReader:
        vid = version or self.latest()
        if vid is None:
            raise StoreError(
                f"no published index versions under {self.root}")
        return StoreReader(self.version_dir(vid), verify=verify)

    def load(self, version: Optional[str] = None, *, verify: bool = True,
             replay_delta: bool = True, attach_delta: bool = True,
             device: DeviceLike = "cuda") -> PyramidIndex:
        """Materialise a full :class:`PyramidIndex` from a version, on
        ``device``.

        Checksums are verified (``verify=False`` skips), the version's
        delta log is replayed in journal order through
        ``add_items``/``remove_items`` (same rebuild path, same
        ``shard_seed`` — bit-identical to the pre-restart index, and
        tombstones guarantee deleted vectors stay deleted), and the
        index is attached to that log so further updates keep
        journaling.
        """
        dev = resolve_device(device)
        reader = self.reader(version, verify=verify)
        meta, part_of_center = reader.load_meta()
        subs = [reader.load_shard(i) for i in range(reader.num_shards)]
        index = PyramidIndex(
            config=reader.config, meta=meta,
            part_of_center=part_of_center, subs=subs,
            build_stats=dict(reader.manifest.get("build_stats", {})),
            device=dev)
        if "quant" in reader.manifest:
            # attach BEFORE delta replay: replayed inserts requantize
            # through the same frozen grid as the live engine did, so
            # the rebuilt int8 arena is bit-identical to the pre-crash
            # one (tests/test_torch_store.py asserts the codes)
            from repro_torch.core.quant import QuantParams
            index.attach_quant_params(
                QuantParams.from_manifest(reader.manifest["quant"]))
        delta = reader.delta_log()
        if replay_delta:
            from repro_torch.core.updates import (add_items, remove_items,
                                            set_item_tags)
            for op, vectors, ids, tags in delta.replay(verify=verify):
                if op == "remove":
                    remove_items(index, ids, log_delta=False)
                elif op == "tags":
                    set_item_tags(index, ids, tags, log_delta=False)
                else:
                    add_items(index, vectors, ids, tags=tags,
                              log_delta=False)
        if attach_delta:
            index.attach_delta_log(delta)
        return index

    # -- GC ----------------------------------------------------------------

    def gc(self, keep: int = 2) -> List[str]:
        """Delete superseded versions, keeping the newest ``keep`` plus
        whatever ``CURRENT`` points at; also sweeps ``.tmp-`` orphans
        from crashed publishes. Returns the removed version ids."""
        if keep < 1:
            raise ValueError(f"gc keep must be >= 1, got {keep}")
        vs = self.versions()
        protect = set(vs[-keep:])
        cur = self.latest()
        if cur is not None:
            protect.add(cur)
        removed = []
        for vid in vs:
            if vid in protect:
                continue
            # rename-then-delete: the version disappears atomically, so
            # a concurrent reader either opened it in time or never sees
            # a half-deleted directory
            trash = os.path.join(
                self.root, f".trash-{vid}-{uuid.uuid4().hex[:8]}")
            try:
                os.rename(self.version_dir(vid), trash)
            except OSError:
                continue   # raced another GC
            shutil.rmtree(trash, ignore_errors=True)
            removed.append(vid)
        # sweep crash orphans — but only STALE ones: a fresh .tmp- dir
        # may be a concurrent publisher still writing its segments (and
        # a fresh .CURRENT.* a flip about to happen); deleting either
        # out from under its owner would fail their publish
        now = time.time()
        for name in os.listdir(self.root):
            if not name.startswith((".tmp-", ".trash-", f".{_CURRENT}.")):
                continue
            path = os.path.join(self.root, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue   # already gone (raced its owner or another GC)
            if age > self.ORPHAN_GRACE_S:
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        return removed

    # -- misc --------------------------------------------------------------

    def exists(self) -> bool:
        return bool(self.versions())

    def __repr__(self) -> str:
        return (f"IndexStore({self.root!r}, versions={self.versions()}, "
                f"current={self.latest()!r})")
