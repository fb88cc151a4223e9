"""Vector datasets for the Pyramid index (numpy copies of
``repro.data.synthetic``): Deep/SIFT-like clustered descriptors,
Tiny-like norm-spread vectors for MIPS, and query sets near the data."""
from __future__ import annotations

import numpy as np


def clustered_vectors(n: int, d: int, num_clusters: int, *, spread=0.15,
                      seed: int = 0) -> np.ndarray:
    """Deep/SIFT-like: clustered descriptors with similar norms."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_clusters, d))
    asg = rng.integers(0, num_clusters, size=n)
    x = centers[asg] + spread * rng.normal(size=(n, d))
    return x.astype(np.float32)


def norm_spread_vectors(n: int, d: int, num_dirs: int, *, sigma=0.8,
                        seed: int = 0) -> np.ndarray:
    """Tiny-like: wide Euclidean-norm spread (interesting for MIPS)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(num_dirs, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    asg = rng.integers(0, num_dirs, size=n)
    x = dirs[asg] + 0.2 * rng.normal(size=(n, d))
    norms = rng.lognormal(mean=0.0, sigma=sigma, size=(n, 1))
    return (x * norms).astype(np.float32)


def query_set(x: np.ndarray, num_queries: int, *, noise=0.02,
              seed: int = 1) -> np.ndarray:
    """Queries drawn near dataset items (paper-style query workload)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=num_queries, replace=True)
    return (x[idx] + noise * rng.normal(size=(num_queries, x.shape[1]))
            ).astype(np.float32)
