"""Vector-dataset IO (port of ``repro.data.vectors``): fvecs/bvecs/ivecs
(the SIFT/Deep/GIST interchange formats of the paper's datasets) plus
npy/npz, with memory-mapped reads of a contiguous slice for the
distributed index-build workflow (Sec. III-A: each worker reads a part of
the dataset, :func:`worker_slice`, and the workers run k-means together,
``repro_torch.core.kmeans.kmeans_distributed``). Host numpy only; files
are written and read byte for byte as the reference writes and reads
them.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _vecs_meta(path: str, itemsize: int) -> Tuple[int, int]:
    """(n, d) of an *.fvecs/bvecs/ivecs file (d-prefixed records)."""
    with open(path, "rb") as f:
        d = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
    record = 4 + d * itemsize
    size = os.path.getsize(path)
    if size % record:
        raise ValueError(f"{path}: size {size} not a multiple of {record}")
    return size // record, d


def read_fvecs(path: str, start: int = 0,
               count: Optional[int] = None) -> np.ndarray:
    """float32 vectors; returns [count, d]."""
    n, d = _vecs_meta(path, 4)
    count = n - start if count is None else min(count, n - start)
    mm = np.memmap(path, dtype=np.float32, mode="r",
                   offset=start * (4 + 4 * d), shape=(count, d + 1))
    return np.ascontiguousarray(mm[:, 1:], dtype=np.float32)


def read_bvecs(path: str, start: int = 0,
               count: Optional[int] = None) -> np.ndarray:
    """uint8 vectors (SIFT1B); returns float32 [count, d]."""
    n, d = _vecs_meta(path, 1)
    count = n - start if count is None else min(count, n - start)
    mm = np.memmap(path, dtype=np.uint8, mode="r",
                   offset=start * (4 + d), shape=(count, d + 4))
    return mm[:, 4:].astype(np.float32)


def read_ivecs(path: str, start: int = 0,
               count: Optional[int] = None) -> np.ndarray:
    """int32 vectors (ground-truth files); returns [count, d] int32."""
    n, d = _vecs_meta(path, 4)
    count = n - start if count is None else min(count, n - start)
    mm = np.memmap(path, dtype=np.int32, mode="r",
                   offset=start * (4 + 4 * d), shape=(count, d + 1))
    return np.ascontiguousarray(mm[:, 1:])


def write_fvecs(path: str, x: np.ndarray) -> None:
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.float32)
    out[:, 0] = np.frombuffer(
        np.full((n,), d, dtype=np.int32).tobytes(), dtype=np.float32)
    out[:, 1:] = x
    out.tofile(path)


def load_dataset(path: str, start: int = 0,
                 count: Optional[int] = None) -> np.ndarray:
    """Dispatch on extension: .fvecs/.bvecs/.npy/.npz."""
    if path.endswith(".fvecs"):
        return read_fvecs(path, start, count)
    if path.endswith(".bvecs"):
        return read_bvecs(path, start, count)
    if path.endswith(".npy"):
        x = np.load(path, mmap_mode="r")
        end = x.shape[0] if count is None else start + count
        return np.asarray(x[start:end], dtype=np.float32)
    if path.endswith(".npz"):
        x = np.load(path)["x"]
        end = x.shape[0] if count is None else start + count
        return np.asarray(x[start:end], dtype=np.float32)
    raise ValueError(f"unknown dataset format: {path}")


def worker_slice(total: int, worker: int, num_workers: int) -> Tuple[int, int]:
    """Contiguous (start, count) for one worker's read."""
    per = -(-total // num_workers)
    start = min(worker * per, total)
    return start, min(per, total - start)
