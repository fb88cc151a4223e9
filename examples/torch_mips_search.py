"""MIPS (maximum inner-product search) with Alg. 5 on the PyTorch port:
spherical k-means partitioning + norm replication, on Tiny-like
norm-spread data (twin of ``examples/mips_search.py``).

PYTHONPATH=src python examples/torch_mips_search.py [--device cpu] [--n 8000]

The host HNSW builder sets the time: ``--n`` builds over fewer rows.
"""
import argparse

import numpy as np

from repro_torch.common.config import PyramidConfig
from repro_torch.core import metrics as M
from repro_torch.core.distributed import search_single_host
from repro_torch.core.meta_index import build_pyramid_index
from repro_torch.data.synthetic import norm_spread_vectors


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--n", type=int, default=8_000, help="dataset rows")
    args = ap.parse_args()

    x = norm_spread_vectors(n=args.n, d=24, num_dirs=48, seed=0)
    q = np.random.default_rng(1).normal(size=(64, 24)).astype(np.float32)
    true_ids, _ = M.brute_force_topk(q, x, 10, "ip")

    for r in (0, 100):
        cfg = PyramidConfig(metric="ip", num_shards=8, meta_size=128,
                            sample_size=4_000, branching_factor=1,
                            replication_r=r, max_degree=16,
                            max_degree_upper=8, ef_construction=60,
                            ef_search=80)
        idx = build_pyramid_index(x, cfg, device=args.device)
        ids, _, mask = search_single_host(idx, q, k=10)
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(ids, true_ids))
        overhead = idx.build_stats["total_stored"] / len(x) - 1
        print(f"r={r:4d}: precision@10={hits/true_ids.size:.3f}  "
              f"access_rate={mask.mean():.3f}  "
              f"storage_overhead={overhead:+.1%}")
    print("norm replication (Alg. 5 lines 12-15) pulls large-norm items "
          "into every direction cone that needs them")


if __name__ == "__main__":
    main()
