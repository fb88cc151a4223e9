"""Index configuration (copy of ``repro.common.config.PyramidConfig``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Configuration of the paper's index (Alg. 3 / Alg. 5)."""

    metric: str = "l2"            # l2 | ip | angular
    num_shards: int = 16          # w: number of sub-HNSWs
    meta_size: int = 1_000        # m: k-means centers / meta-HNSW vertices
    sample_size: int = 20_000     # n': sample for k-means
    branching_factor: int = 4     # K: meta neighbours used for routing
    # HNSW parameters (paper defaults: M=32 bottom, 16 upper, ef=100)
    max_degree: int = 32
    max_degree_upper: int = 16
    ef_construction: int = 100
    ef_search: int = 100
    # MIPS norm-replication (Alg. 5)
    replication_r: int = 0        # r: top-r MIPS neighbours per meta vertex
    # capacity factor for distributed dispatch (queries per shard slot)
    capacity_factor: float = 2.0
    kmeans_iters: int = 12
    seed: int = 0

    @property
    def is_mips(self) -> bool:
        return self.metric == "ip"
