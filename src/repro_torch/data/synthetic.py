"""Synthetic data pipelines (numpy copies of ``repro.data.synthetic``):
token streams for LM training, frontend embeddings for the VLM and audio
stubs, and the vector sets of the Pyramid index (Deep/SIFT-like
clustered descriptors, Tiny-like norm-spread vectors for MIPS, and query
sets near the data). The same seed gives the reference's arrays bit for
bit: the same numpy generator calls in the same order."""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.common.config import ArchConfig


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenBatch:
    inputs: np.ndarray    # [B, S] int32 (or [B, S, F] f32 for frontends)
    targets: np.ndarray   # [B, S] int32
    # loss mask (1 where target counts)
    mask: np.ndarray      # [B, S] f32


class SyntheticLM:
    """Markov-ish synthetic token stream with learnable structure.

    Tokens follow ``x[t+1] = (a * x[t] + b + noise) % V`` per sequence so a
    model can reduce loss below uniform: enough signal for a short
    training run to show learning.
    """

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[TokenBatch]:
        return self

    def __next__(self) -> TokenBatch:
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq_len
        a = self.rng.integers(1, 8, size=(b, 1))
        c = self.rng.integers(0, v, size=(b, 1))
        x0 = self.rng.integers(0, v, size=(b, 1))
        toks = np.zeros((b, s + 1), dtype=np.int64)
        toks[:, :1] = x0
        for t in range(s):
            noise = self.rng.integers(0, 3, size=(b,))
            toks[:, t + 1] = (a[:, 0] * toks[:, t] + c[:, 0] + noise) % v
        if self.cfg.frontend:
            f = self.cfg.frontend_dim
            emb = self.rng.normal(size=(b, s, f)).astype(np.float32)
            return TokenBatch(inputs=emb,
                              targets=toks[:, 1:].astype(np.int32),
                              mask=np.ones((b, s), np.float32))
        return TokenBatch(inputs=toks[:, :-1].astype(np.int32),
                          targets=toks[:, 1:].astype(np.int32),
                          mask=np.ones((b, s), np.float32))


# ---------------------------------------------------------------------------
# Vector datasets for Pyramid (paper Table I analogues)
# ---------------------------------------------------------------------------


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
