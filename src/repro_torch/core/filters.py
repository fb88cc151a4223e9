"""Metadata filter semantics for filtered kNN (port of
``repro.core.filters``).

Every item carries an int64 tag bitset; a query carries an int64
``filter_tags`` word. ``filter_tags == 0`` means no filtering; otherwise
an item is alive iff ``tags & filter_tags != 0``. Filtering is an
alive-mask on the walk's emitted candidates, never on the navigation
beam. On the device, tags travel as two int32 words ``[..., 2]``
(lo, hi), the same layout as the reference, so the host helpers are
shared unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# hard cap on the 1/selectivity candidate-budget inflation
INFLATE_CAP = 8

_LO_MASK = np.uint64(0xFFFFFFFF)
_SHIFT = np.uint64(32)


def split_tag_words(tags: np.ndarray) -> np.ndarray:
    """Host int64 tag bitsets ``[...]`` -> int32 word pairs ``[..., 2]``
    (lo word, hi word)."""
    t = np.asarray(tags).astype(np.uint64)
    lo = (t & _LO_MASK).astype(np.uint32).view(np.int32)
    hi = (t >> _SHIFT).astype(np.uint32).view(np.int32)
    return np.stack([lo, hi], axis=-1)


def filter_words(filter_tags) -> np.ndarray:
    """Scalar-or-array int64 filter(s) -> int32 word pairs ``[..., 2]``."""
    return split_tag_words(np.asarray(filter_tags, dtype=np.uint64))


def alive_words(tag_words: torch.Tensor, fw: torch.Tensor) -> torch.Tensor:
    """Alive mask from word-split bitsets (device side): True where the
    filter is empty or the bitsets intersect. ``fw`` broadcasts against
    ``tag_words[..., 0]``."""
    lo = torch.bitwise_and(tag_words[..., 0], fw[..., 0])
    hi = torch.bitwise_and(tag_words[..., 1], fw[..., 1])
    no_filter = torch.bitwise_or(fw[..., 0], fw[..., 1]) == 0
    return torch.logical_or(no_filter, torch.bitwise_or(lo, hi) != 0)


def alive_np(tags: np.ndarray, filter_tags) -> np.ndarray:
    """Numpy twin of :func:`alive_words` on raw int64 bitsets."""
    t = np.asarray(tags).astype(np.uint64)
    f = np.asarray(filter_tags, dtype=np.uint64)
    return np.logical_or(f == 0, (t & f) != 0)


def selectivity_np(tags: Optional[np.ndarray], filter_tags: int) -> float:
    """Fraction of items alive under ``filter_tags``. ``filter == 0`` ->
    1.0; an untagged corpus under a non-zero filter -> 0.0."""
    if int(filter_tags) == 0:
        return 1.0
    if tags is None or np.asarray(tags).size == 0:
        return 0.0
    return float(np.mean(alive_np(tags, filter_tags)))


def inflation(selectivity: float, *, cap: int = INFLATE_CAP) -> int:
    """Candidate-budget multiplier: ``ceil(1/selectivity)`` capped at
    ``cap`` (>= 1); selectivity 0 maps to the cap."""
    if selectivity >= 1.0:
        return 1
    if selectivity <= 0.0:
        return int(cap)
    return int(min(int(cap), math.ceil(1.0 / selectivity)))
