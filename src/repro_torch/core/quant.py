"""Per-dimension int8 quantization grid and exact float32 rerank (numpy
copies of ``repro.core.quant``; the manifest dict is the same).

Dimension ``j`` stores ``c = clip(rint((x - zero[j]) / scale[j]), -127,
127)`` with the zero-point at the value-range midpoint, so dequantize is
one fused multiply-add ``x_hat = c * scale + zero``. Scoring is
asymmetric: float32 queries against dequantized rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import metrics as M

_LEVELS = 254.0
_CODE_MIN, _CODE_MAX = -127, 127


@dataclasses.dataclass
class QuantParams:
    """Frozen per-dimension int8 grid: ``scale`` [d] (> 0) and ``zero``
    [d], both float32."""

    scale: np.ndarray
    zero: np.ndarray

    def __post_init__(self):
        self.scale = np.ascontiguousarray(self.scale, np.float32)
        self.zero = np.ascontiguousarray(self.zero, np.float32)

    @property
    def d(self) -> int:
        return int(self.scale.shape[0])

    @classmethod
    def from_data(cls, data: Union[np.ndarray, Sequence[np.ndarray]]
                  ) -> "QuantParams":
        """Grid from per-dimension min/max over one [n, d] array or a
        sequence of them (accumulated without concatenating)."""
        if isinstance(data, np.ndarray):
            data = [data]
        lo = hi = None
        for block in data:
            block = np.asarray(block, np.float32)
            if block.size == 0:
                continue
            blo, bhi = block.min(axis=0), block.max(axis=0)
            lo = blo if lo is None else np.minimum(lo, blo)
            hi = bhi if hi is None else np.maximum(hi, bhi)
        if lo is None:
            raise ValueError("cannot derive QuantParams from empty data")
        lo64, hi64 = lo.astype(np.float64), hi.astype(np.float64)
        scale = np.maximum(hi64 - lo64, 1e-12) / _LEVELS
        zero = (lo64 + hi64) / 2.0
        return cls(scale=scale.astype(np.float32),
                   zero=zero.astype(np.float32))

    def quantize(self, x: np.ndarray) -> np.ndarray:
        """[*, d] float32 -> [*, d] int8 codes (round-half-even)."""
        x = np.asarray(x, np.float32)
        codes = np.rint((x - self.zero) / self.scale)
        return np.clip(codes, _CODE_MIN, _CODE_MAX).astype(np.int8)

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        """[*, d] int8 codes -> [*, d] float32 reconstruction."""
        return (np.asarray(codes, np.float32) * self.scale
                + self.zero).astype(np.float32)

    def to_manifest(self) -> Dict:
        return {
            "dtype": "int8",
            "bits": 8,
            "scale": [float(v) for v in self.scale],
            "zero": [float(v) for v in self.zero],
        }

    @classmethod
    def from_manifest(cls, entry: Dict) -> "QuantParams":
        if entry.get("dtype") != "int8":
            raise ValueError(
                f"unsupported quantization dtype {entry.get('dtype')!r}")
        return cls(scale=np.asarray(entry["scale"], np.float32),
                   zero=np.asarray(entry["zero"], np.float32))


def exact_rerank_np(queries: np.ndarray, cand_ids: np.ndarray, k: int, *,
                    table_ids: np.ndarray, table_vecs: np.ndarray,
                    metric: str) -> Tuple[np.ndarray, np.ndarray]:
    """Exact float32 rerank of quantized-search candidates against the
    full-precision table; stable on exact-score ties. Returns (ids [B, k]
    int64, scores [B, k] float32) best-first, (-1, -inf) padded."""
    queries = np.asarray(queries, np.float32)
    cand_ids = np.asarray(cand_ids)
    b, m = cand_ids.shape
    out_ids = np.full((b, k), -1, np.int64)
    out_scores = np.full((b, k), -np.inf, np.float32)
    pos = np.searchsorted(table_ids, np.clip(cand_ids, 0, None))
    pos = np.clip(pos, 0, max(len(table_ids) - 1, 0))
    found = np.logical_and(cand_ids >= 0, table_ids[pos] == cand_ids)
    for i in range(b):
        vi = np.where(found[i])[0]
        if vi.size == 0:
            continue
        vecs = table_vecs[pos[i, vi]]
        s = M.similarity_matrix_np(queries[i][None, :], vecs, metric)[0]
        order = np.argsort(-s, kind="stable")[:k]
        out_ids[i, : order.size] = cand_ids[i, vi[order]]
        out_scores[i, : order.size] = s[order]
    return out_ids, out_scores
