"""Maintenance launcher: compact a store's delta log and rebalance its
shards (port of ``repro.launch.maintain``).

Runs :class:`repro_torch.store.maintenance.Compactor` against a
published store -- once by default (fold whatever the log holds, apply
at most one split/merge, publish, truncate), or as a long-running
daemon with ``--watch``:

    python -m repro_torch.launch.maintain \\
        --store /tmp/pyramid_store --gc-keep 2 [--device cpu]

The index is loaded on ``--device`` (the CUDA device unless ``cpu`` is
asked for): the fold's inserts route through the beam-walk kernel there,
and a split or centroid refresh runs its k-means through the top-k scan
kernel. Serving processes pointed at the same store pick the compacted
version up on their next ``Brokers.replace_index(name, path)`` /
``ServingEngine.from_store``; in-process serving instead wires the
compactor through ``Brokers.attach_maintenance``, so each cycle
hot-swaps the engine directly.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch.common.device import resolve_device
from repro_torch.obs import get_logger

log = get_logger(__name__)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True, help="store root")
    ap.add_argument("--threshold", type=int, default=1,
                    help="fold once this many delta records accumulated "
                         "(--watch mode; a one-shot run always folds)")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="disable shard split/merge planning")
    ap.add_argument("--split-factor", type=float, default=4.0,
                    help="split a shard above this multiple of the "
                         "mean sub-dataset size")
    ap.add_argument("--merge-factor", type=float, default=0.25,
                    help="merge two shards both below this multiple "
                         "of the mean")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="k-means++ meta-centroid refresh every N "
                         "cycles (0 = never; it is a full routing "
                         "rebuild)")
    ap.add_argument("--gc-keep", type=int, default=None,
                    help="GC superseded versions after each cycle, "
                         "keeping this many")
    ap.add_argument("--watch", action="store_true",
                    help="keep running, folding whenever --threshold "
                         "records accumulate")
    ap.add_argument("--poll-s", type=float, default=1.0,
                    help="--watch mode store poll period")
    ap.add_argument("--device", default="cuda",
                    help="torch device the index is loaded on (default "
                         "cuda; 'cpu' runs the plain PyTorch versions of "
                         "the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.store import Compactor, IndexStore
    store = IndexStore(args.store)
    index = store.load(device=dev)
    compactor = Compactor(
        store, index, threshold_records=args.threshold,
        rebalance=not args.no_rebalance,
        split_factor=args.split_factor, merge_factor=args.merge_factor,
        refresh_every=args.refresh_every, gc_keep=args.gc_keep,
        poll_s=args.poll_s)

    # ``delta``, never ``log``: that name is the module's logger
    if not args.watch:
        delta = index.delta_log()
        n = len(delta) if delta is not None else 0
        vid = compactor.run_once(force=True)
        log.info(f"compacted {n} delta records into {vid} "
                 f"(store={args.store})")
        log.info(json.dumps(compactor.stats(), indent=1))
        return

    # watch mode: the store is the only signal (writers live in other
    # processes), so poll the attached log length instead of the
    # in-process drain hook
    log.info(f"watching {args.store} (threshold={args.threshold} records, "
             f"poll={args.poll_s}s; ctrl-c to stop)")
    try:
        while True:
            delta = compactor.index.delta_log()
            if delta is not None and len(delta) >= args.threshold:
                vid = compactor.run_once(force=True)
                log.info(f"[maintain] cycle {compactor.cycles}: "
                         f"published {vid}, "
                         f"stats={json.dumps(compactor.stats())}")
            time.sleep(args.poll_s)
    except KeyboardInterrupt:
        log.info(f"stopped after {compactor.cycles} cycles")


if __name__ == "__main__":
    main()
