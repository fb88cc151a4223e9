"""End-to-end serving example on the PyTorch port (twin of
``examples/serve_cluster.py``): the coordinator/executor engine behind
the futures-based ``PyramidClient`` session API, batched requests
streamed back via ``as_completed``, a straggler injected halfway
through, and the replica group resized live with ``client.scale``.

PYTHONPATH=src python examples/torch_serve_cluster.py [--device cpu] [--n 8000]

The host HNSW builder sets the build's time: ``--n`` builds over fewer
rows.
"""
import argparse
import time

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.core import metrics as M
from repro_torch.core.client import PyramidClient, as_completed
from repro_torch.core.meta_index import build_pyramid_index
from repro_torch.data.synthetic import clustered_vectors, query_set
from repro_torch.serving.engine import ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--n", type=int, default=8_000, help="dataset rows")
    args = ap.parse_args()

    x = clustered_vectors(n=args.n, d=32, num_clusters=48, seed=0)
    cfg = PyramidConfig(metric="l2", num_shards=4, meta_size=128,
                        sample_size=4_000, branching_factor=2,
                        max_degree=16, max_degree_upper=8,
                        ef_construction=60, ef_search=80)
    index = build_pyramid_index(x, cfg, device=args.device)

    print("starting engine: 4 topics x 2 replicas + monitor (Zookeeper "
          "analogue) ...")
    engine = ServingEngine(index, replicas=2)
    client = PyramidClient(engine)
    try:
        queries = query_set(x, 128, seed=2)
        true_ids, _ = M.brute_force_topk(queries, x, 10, "l2")

        t0 = time.perf_counter()
        futs1 = client.search_batch(queries[:64], k=10)
        # stream results in completion order: no barrier on the batch
        res1 = [f.result() for f in as_completed(futs1, timeout=60)]
        dt1 = time.perf_counter() - t0
        print(f"phase 1 (healthy): {len(res1)} queries in {dt1:.2f}s "
              f"({len(res1)/dt1:.0f} qps)")

        print("injecting straggler on exec-s0-r0 (cpu share 10%) and "
              "scaling shard 0 to 3 replicas to compensate...")
        engine.set_cpu_share("exec-s0-r0", 0.1)
        client.scale(0, 3)
        t0 = time.perf_counter()
        futs2 = client.search_batch(queries[64:], k=10)
        res2 = [f.result() for f in as_completed(futs2, timeout=120)]
        dt2 = time.perf_counter() - t0
        print(f"phase 2 (straggler): {len(res2)} queries in {dt2:.2f}s "
              f"({len(res2)/dt2:.0f} qps) — replicas absorbed the load")

        by_id = {r.query_id: r for r in res1 + res2}
        hits = sum(
            len(set(by_id[f.query_id].ids.tolist()) &
                set(true_ids[i].tolist()))
            for i, f in enumerate(futs1 + futs2) if f.query_id in by_id)
        print(f"overall precision@10 = {hits / true_ids.size:.3f}")
        p90 = np.percentile([r.latency_s for r in res1], 90) * 1e3
        print(f"p90 latency (healthy phase) = {p90:.1f} ms")
        stats = client.stats()
        print(f"engine stats: replicas={stats['replicas']} "
              f"submitted={stats['submitted_queries']} "
              f"restarts={stats['monitor_restarts']}")
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
