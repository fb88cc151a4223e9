"""Quickstart on the PyTorch port: build a Pyramid index and run
distributed similarity search (twin of ``examples/quickstart.py``).

This uses the single-host search path (``search_single_host``): the
whole index queried in one call on the index's device, no serving
engine. For served traffic use the futures-based session API instead
(see API.md)::

    with Brokers() as brokers:
        client = brokers.open_client("demo", index_path, metric="l2")
        res = client.search(q, k=10).result(timeout=5.0)

``examples/torch_serve_cluster.py`` shows that flow end to end.

PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--n 10000]

The host HNSW builder takes some 30 ms a row at these settings, so the
default 10,000 rows take minutes; ``--n`` builds over fewer.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.core import metrics as M
from repro_torch.core.distributed import search_single_host
from repro_torch.core.meta_index import build_pyramid_index
from repro_torch.data.synthetic import clustered_vectors, query_set
from repro_torch.store import IndexStore


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--n", type=int, default=10_000, help="dataset rows")
    args = ap.parse_args()

    # A Deep/SIFT-like clustered dataset (paper Table I, laptop scale)
    x = clustered_vectors(n=args.n, d=32, num_clusters=48, seed=0)
    queries = query_set(x, 50, seed=1)

    cfg = PyramidConfig(
        metric="l2",          # also: "ip" (MIPS, Alg. 5) or "angular"
        num_shards=8,         # w sub-HNSWs (one per worker in the paper)
        meta_size=256,        # m: meta-HNSW vertices (kmeans centers)
        sample_size=5_000,    # n': kmeans sample
        branching_factor=2,   # K: shards touched per query
    )
    print("building Pyramid index (meta-HNSW + partitions + sub-HNSWs)...")
    index = build_pyramid_index(x, cfg, verbose=True, device=args.device)

    ids, scores, mask = search_single_host(index, queries, k=10)
    true_ids, _ = M.brute_force_topk(queries, x, 10, "l2")
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(ids, true_ids))
    print(f"precision@10 = {hits / true_ids.size:.3f}")
    print(f"access rate  = {mask.mean():.3f} "
          f"(fraction of sub-HNSWs touched per query)")
    print(f"top-3 neighbours of query 0: ids={ids[0, :3]} "
          f"scores={scores[0, :3]}")

    # Persist it: publish a version into the on-disk store (atomic,
    # checksummed; API.md "Index build & store"). Reloading answers
    # identically; post-publish add_items are journaled to the version's
    # delta log and replayed on load (ServingEngine.from_store).
    with tempfile.TemporaryDirectory() as root:
        store = IndexStore(root)
        vid = store.publish(index)
        reloaded = store.load(device=args.device)
        ids2, _, _ = search_single_host(reloaded, queries, k=10)
        same = bool(np.array_equal(ids, ids2))
        print(f"published {vid}; reload parity: {same}")
    assert same


if __name__ == "__main__":
    main()
