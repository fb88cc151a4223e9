"""Index-building launcher (the paper's GraphConstructor, Sec. IV-A; port
of ``repro.launch.build_index``).

Builds with the parallel constructor (``repro_torch.build``) and
publishes a versioned, checksummed store (``repro_torch.store``):

    python -m repro_torch.launch.build_index \\
        --n 20000 --d 32 --metric l2 --shards 8 --workers 4 \\
        --out /tmp/pyramid_store [--device cpu]

The k-means and the item assignment run on ``--device`` (the CUDA
device unless ``cpu`` is asked for). Serving then recovers from the
store (``ServingEngine.from_store``) or hot-swaps onto a fresh publish
(``Brokers.replace_index(name, path)``).

``save_index`` / ``load_index`` remain as deprecated shims over the
store. ``load_index`` still reads a legacy ``index.pkl``, but only one
the port pickled: a reference pickle names the reference's classes, and
loading it raises :class:`~repro_torch.store.StoreError` without
importing the reference package.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
import warnings
from typing import Optional

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.meta_index import PyramidIndex
from repro_torch.data.synthetic import clustered_vectors, norm_spread_vectors
from repro_torch.obs import get_logger

log = get_logger(__name__)


def save_index(index: PyramidIndex, path: str) -> None:
    """Deprecated: publish a store version at ``path`` instead.

    Delegates to :meth:`repro_torch.store.IndexStore.publish` (atomic,
    checksummed, versioned — no pickle is written). A legacy
    ``index.pkl`` in the same directory is moved aside so the old
    save/load round-trip cannot return the stale pickle."""
    warnings.warn(
        "save_index is deprecated: use "
        "repro_torch.store.IndexStore(path).publish(index)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.store import IndexStore
    IndexStore(path).publish(index)
    pkl = os.path.join(path, "index.pkl")
    if os.path.exists(pkl):   # superseded by the publish above
        os.replace(pkl, pkl + ".migrated")


class _PortUnpickler(pickle.Unpickler):
    """Unpickles the port's own index pickles only: a class of the
    reference package is refused before its module is imported."""

    def find_class(self, module, name):
        if module == "repro" or module.startswith("repro."):
            from repro_torch.store import StoreError
            raise StoreError(
                f"this index.pkl pickles the reference package's "
                f"{module}.{name}; the port reads only its own pickles. "
                f"Publish the index to a store with the reference "
                f"package (repro.store.IndexStore(path).publish) and load "
                f"that store here")
        return super().find_class(module, name)


def load_index(path: str, *, version: Optional[str] = None,
               device: DeviceLike = "cuda") -> PyramidIndex:
    """Open the index at ``path`` on ``device``: a store root (latest
    published version + delta-log replay) or a legacy ``index.pkl`` the
    port pickled (deprecated migration path). A published store version
    always wins over a leftover pickle — it is the newer artifact."""
    from repro_torch.store import IndexStore
    store = IndexStore(path)
    pkl = os.path.join(path, "index.pkl")
    # an explicit version request can never be served by the unversioned
    # pickle — fall through to the store, which raises if it's absent
    if version is None and os.path.exists(pkl) and not store.exists():
        dev = resolve_device(device)
        warnings.warn(
            "loading a legacy pickle index; re-publish it with "
            "repro_torch.store.IndexStore(path).publish(load_index(path)) "
            "— pickle support will be removed",
            DeprecationWarning, stacklevel=2)
        with open(pkl, "rb") as f:
            index = _PortUnpickler(f).load()
        index.device = dev
        return index
    return store.load(version=version, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "angular"])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--meta-size", type=int, default=256)
    ap.add_argument("--replication-r", type=int, default=0)
    ap.add_argument("--workers", type=int, default=None,
                    help="sub-HNSW build processes (default: "
                         "min(shards, cpu_count); 0 = sequential)")
    ap.add_argument("--data", default=None,
                    help=".npy file with the dataset (default: synthetic)")
    ap.add_argument("--out", default="/tmp/pyramid_store",
                    help="store root (a version is published under it)")
    ap.add_argument("--gc-keep", type=int, default=None,
                    help="after publishing, GC superseded versions "
                         "keeping this many")
    ap.add_argument("--quantize", action="store_true",
                    help="print the frozen int8 quantization grid (every "
                         "publish persists it in the manifest; this flag "
                         "only surfaces it)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the k-means and the item "
                         "assignment (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.data:
        x = np.load(args.data).astype(np.float32)
    elif args.metric == "ip":
        x = norm_spread_vectors(args.n, args.d, 64)
    else:
        x = clustered_vectors(args.n, args.d, 64)

    cfg = PyramidConfig(
        metric=args.metric, num_shards=args.shards,
        meta_size=args.meta_size, sample_size=min(len(x), 10_000),
        replication_r=args.replication_r or (300 if args.metric == "ip"
                                             else 0))
    from repro_torch.build import build_pyramid_index_parallel
    from repro_torch.store import IndexStore
    t0 = time.time()
    index = build_pyramid_index_parallel(
        x, cfg, device=dev, workers=args.workers, verbose=True)
    t_build = time.time() - t0
    if args.quantize:
        qp = index.quant_params()   # publish persists this frozen grid
        log.info(f"quantization grid: d={qp.d}, int8 "
                 f"(vector payload shrinks ~4x in quantize=True engines)")
    store = IndexStore(args.out)
    t0 = time.time()
    vid = store.publish(index, keep=args.gc_keep)
    log.info(f"index built in {t_build:.1f}s "
             f"(mode={index.build_stats['build_mode']}, "
             f"workers={index.build_stats['build_workers']}); "
             f"published {vid} to {args.out} in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
