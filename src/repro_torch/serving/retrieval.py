"""Retrieval-augmented decoding (kNN-LM) over a Pyramid datastore (port
of ``repro.serving.retrieval``).

The decoder's final-norm hidden state queries the Pyramid index; the
retrieved (hidden state -> next token) memories become a kNN
distribution over the vocabulary, which is interpolated with the LM's
(Khandelwal et al., kNN-LM: the paper's reference [10]). Keys are hidden
states, values the observed next tokens.

Lookups run either single-host (``search_single_host`` on the index's
device) or through the serving engine via a :class:`PyramidClient`
session: ``open_datastore_client`` starts the engine and
``knn_probs(..., client=...)`` sends one ``search_batch`` per lookup,
resolved with ``gather_arrays``. Both paths share the index's one device
arena.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.common.config import ArchConfig, PyramidConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.client import PyramidClient, gather_arrays
from repro_torch.core.distributed import search_single_host
from repro_torch.core.meta_index import PyramidIndex, build_pyramid_index
from repro_torch.models.transformer import forward


@dataclasses.dataclass
class Datastore:
    index: PyramidIndex
    values: np.ndarray          # [n] int32 next-token ids


def build_datastore(params: dict, cfg: ArchConfig,
                    token_batches: Iterable, pyr_cfg: PyramidConfig, *,
                    device: DeviceLike = "cuda") -> Datastore:
    """Run the model over batches and store (hidden state -> next token)
    in a Pyramid index on ``device`` (the parameters' device).

    token_batches: iterable of [B, S] int arrays.
    """
    dev = resolve_device(device)
    keys = []
    vals = []
    for toks in token_batches:
        toks = torch.as_tensor(np.asarray(toks, np.int64), device=dev)
        hidden = hidden_states(params, cfg, toks)      # [B, S, D]
        # key at position t predicts token t+1
        keys.append(hidden[:, :-1].reshape(-1, hidden.shape[-1]).float()
                    .cpu().numpy())
        vals.append(toks[:, 1:].reshape(-1).cpu().numpy().astype(np.int32))
    x = np.concatenate(keys, axis=0)
    v = np.concatenate(vals, axis=0)
    index = build_pyramid_index(x, pyr_cfg, device=dev)
    return Datastore(index=index, values=v)


def hidden_states(params: dict, cfg: ArchConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] (the kNN-LM key convention):
    ``forward`` with ``skip_head=True``, so no second path through the
    trunk exists."""
    hid, _, _ = forward(params, cfg, tokens, skip_head=True)
    return hid


class DatastoreClient(PyramidClient):
    """A :class:`PyramidClient` that owns its engine: a context manager
    whose ``with`` block (or an explicit :meth:`shutdown`) stops the
    engine's threads."""

    def shutdown(self) -> None:
        """Shut the owned engine down, then close the session."""
        try:
            self.engine.shutdown()
        finally:
            self.close()

    def __exit__(self, *exc) -> None:
        if not self._closed:   # idempotent: explicit shutdown() inside
            self.shutdown()    # the with-block must not double-teardown


def open_datastore_client(datastore: Datastore, *, replicas: int = 1,
                          **engine_kw) -> DatastoreClient:
    """Serve ``datastore.index`` through the serving engine, on the
    index's device; the returned session feeds ``knn_probs(...,
    client=...)``. The client owns the engine, so use it as a context
    manager::

        with open_datastore_client(ds) as client:
            knn_probs(ds, q, k=8, vocab_size=V, client=client)

    Engine kwargs pass through (``quantize=True`` serves the datastore
    from the int8 arena, ``rerank_factor``, ``registry``, ``tracer``)."""
    return DatastoreClient.from_index(datastore.index, replicas=replicas,
                                      **engine_kw)


def knn_vocab_probs(values: np.ndarray, ids: np.ndarray,
                    scores: np.ndarray, *, vocab_size: int,
                    temperature: float = 10.0) -> np.ndarray:
    """Batched (hit ids, scores) -> [B, V] kNN next-token distributions.

    Scores are similarities (-L2^2 / ip), turned into weights by a
    max-subtracted softmax at ``temperature`` and scattered onto the hit
    tokens in one ``np.add.at``. Rows with no valid hit (all ids ``-1``)
    get the uniform distribution.
    """
    ids = np.asarray(ids)
    scores = np.asarray(scores, np.float32)
    b, k = ids.shape
    valid = ids >= 0
    s = np.where(valid, scores / temperature, -np.inf)
    smax = s.max(axis=1, keepdims=True)
    w = np.where(valid,
                 np.exp(s - np.where(np.isfinite(smax), smax, 0.0)), 0.0)
    norm = w.sum(axis=1, keepdims=True)
    w = w / np.where(norm > 0, norm, 1.0)
    probs = np.zeros((b, vocab_size), np.float32)
    rows = np.repeat(np.arange(b), k)
    toks = values[np.where(valid, ids, 0)].astype(np.int64)
    np.add.at(probs, (rows, toks.reshape(-1)),
              w.astype(np.float32).reshape(-1))
    probs[norm[:, 0] == 0] = 1.0 / vocab_size
    return probs


def knn_probs(datastore: Datastore, queries: np.ndarray, *, k: int,
              vocab_size: int, temperature: float = 10.0,
              branching_factor: Optional[int] = None,
              client: Optional[PyramidClient] = None,
              timeout_s: float = 30.0) -> np.ndarray:
    """kNN next-token distribution per query. queries: [B, D] hidden
    states. Returns [B, V] probabilities (host numpy).

    Without ``client`` the search is ``search_single_host`` on the
    datastore index's device. With ``client`` it goes through the serving
    engine's futures: one ``search_batch`` for the whole batch, resolved
    by :func:`repro_torch.core.client.gather_arrays`; a lookup missing
    ``timeout_s`` raises ``TimeoutError``."""
    queries = np.asarray(queries, np.float32)
    if client is not None:
        futures = client.search_batch(queries, k,
                                      branching_factor=branching_factor)
        ids, scores = gather_arrays(futures, k, timeout_s)
    else:
        ids, scores, _ = search_single_host(
            datastore.index, queries, k=k,
            branching_factor=branching_factor)
    return knn_vocab_probs(datastore.values, ids, scores,
                           vocab_size=vocab_size, temperature=temperature)


def interpolate(lm_logits: np.ndarray, knn_p: np.ndarray,
                lam: float = 0.25) -> np.ndarray:
    """p = lam * p_knn + (1-lam) * p_lm; returns log-probs [B, V]."""
    lm = np.asarray(lm_logits, np.float32)
    lm_p = np.exp(lm - lm.max(-1, keepdims=True))
    lm_p /= lm_p.sum(-1, keepdims=True)
    return np.log(lam * knn_p + (1 - lam) * lm_p + 1e-20)
