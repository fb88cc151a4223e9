"""Plain versions of the fused bottom-layer beam walk: a batched PyTorch
walk (``beam_search_ref``) and a per-row numpy twin (``beam_search_np``).

Port of ``repro.kernels.beam_search.ref``. The walk is Alg. 1
Search-Level with search factor ``ef`` on the bottom layer, batched over
a stack of graphs. Semantics shared by every implementation (the CUDA
kernel in ``csrc/beam_search.cu``, the torch walk, the numpy twin):

  * a row expands one beam entry per iteration while it has an
    unexpanded entry and fewer than ``max_iters`` expansions; the entry
    is the best unexpanded one, ties to the lowest beam position;
    finished rows are frozen;
  * neighbour slots < 0 are padding: never scored, visited or kept;
    the visited test of one step reads the mask before that step's
    marks, so a node listed twice in one row is a candidate twice;
  * the merged beam is a stable descending sort of (old beam, new
    neighbours in slot order): the old beam wins ties, and -0.0 == +0.0;
  * output is (scores [S, C, ef'], local node ids [S, C, ef']) best-first
    with ef' = min(ef, n), padded with (-inf, -1);
  * a slot whose entry is -1 (an empty slot of a shard's queue) is not
    walked: its output is all (-inf, -1). The reference walks every slot
    from a valid entry and has no such slot.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.kernels.quant_distance.ref import dequantize, quant_scores_np


def score_rows(q: torch.Tensor, rows: torch.Tensor, metric: str,
                scale: Optional[torch.Tensor],
                zero: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, d] against its gathered rows [B, m, d] -> [B, m]."""
    if scale is not None:
        rows = dequantize(rows, scale, zero)
    return M.row_similarity(q, rows.to(torch.float32), metric)


def beam_search_ref(data: torch.Tensor, bottom: torch.Tensor,
                    queries: torch.Tensor, entries: torch.Tensor, *,
                    metric: str, ef: int, max_iters: int,
                    scale: Optional[torch.Tensor] = None,
                    zero: Optional[torch.Tensor] = None,
                    return_work: bool = False):
    """Batched walk over all ``S * C`` rows in one loop.

    Args:
      data: [S, n, d] rows, float32 or int8 codes (with ``scale``/``zero``).
      bottom: [S, n, M0] int bottom-layer adjacency, -1 padded.
      queries: [S, C, d] float32 preprocessed queries.
      entries: [S, C] int bottom-layer entry node per slot, -1 for a slot
        not to walk.

    Returns (scores [S, C, ef'] f32, nodes [S, C, ef'] i32); with
    ``return_work`` also the work this input needs (what a roofline bound
    counts): expansions [S, C], rows scored [S, C], and per graph the
    distinct data rows [S] and distinct adjacency rows [S] that its
    slots read together.
    """
    s, n, d = data.shape
    m0 = bottom.shape[2]
    c = queries.shape[1]
    ef = min(ef, n)
    bsz = s * c
    dev = data.device
    if scale is not None:
        scale = scale.to(torch.float32).reshape(-1)
        zero = zero.to(torch.float32).reshape(-1)

    data_f = data.reshape(s * n, d)
    bottom_f = bottom.reshape(s * n, m0).long()
    q = queries.reshape(bsz, d).to(torch.float32)
    ent = entries.reshape(bsz).long()
    rows_idx = torch.arange(bsz, device=dev)
    off = (rows_idx // c) * n

    walked = ent >= 0
    ent0 = ent.clamp(min=0)
    visited = torch.zeros((bsz, n), dtype=torch.bool, device=dev)
    visited[rows_idx, ent0] = walked
    beam_i = torch.full((bsz, ef), -1, dtype=torch.long, device=dev)
    beam_i[:, 0] = ent
    beam_s = torch.full((bsz, ef), -torch.inf, dtype=torch.float32,
                        device=dev)
    beam_s[:, 0] = torch.where(walked, score_rows(
        q, data_f[ent0 + off][:, None, :], metric, scale, zero)[:, 0],
        -torch.inf)
    expanded = torch.zeros((bsz, ef), dtype=torch.bool, device=dev)
    cols = torch.arange(ef, device=dev)[None, :]
    no_new = torch.zeros((bsz, m0), dtype=torch.bool, device=dev)
    expansions = torch.zeros(bsz, dtype=torch.long, device=dev)
    scored = walked.long()                                  # the entry
    opened = torch.zeros((bsz, n), dtype=torch.bool, device=dev) \
        if return_work else None                # nodes whose row was read

    for _ in range(max_iters):
        live = ~expanded & (beam_i >= 0)
        active = live.any(dim=1)
        if not bool(active.any()):
            break
        j = torch.argmax(torch.where(live, beam_s, -torch.inf), dim=1)
        node = beam_i.gather(1, j[:, None])[:, 0]
        marked = expanded | ((cols == j[:, None]) & active[:, None])
        nbrs = bottom_f[node.clamp(min=0) + off]               # [bsz, m0]
        nbr_rows = nbrs.clamp(min=0)
        seen = visited.gather(1, nbr_rows)
        real = (nbrs >= 0) & active[:, None]
        valid = real & ~seen
        expansions += active
        if opened is not None:
            opened[rows_idx[active], node[active]] = True
        scored += valid.sum(dim=1)
        sims = torch.where(
            valid, score_rows(q, data_f[nbr_rows + off[:, None]], metric,
                               scale, zero), -torch.inf)
        flat = (rows_idx[:, None] * n + nbr_rows)[real]
        visited.view(-1)[flat] = True
        all_s = torch.cat([beam_s, sims], dim=1)
        all_i = torch.cat([beam_i, torch.where(valid, nbrs, -1)], dim=1)
        all_e = torch.cat([marked, no_new], dim=1)
        top_s, order = torch.sort(all_s, dim=1, descending=True, stable=True)
        order = order[:, :ef]
        keep = active[:, None]
        beam_s = torch.where(keep, top_s[:, :ef], beam_s)
        beam_i = torch.where(keep, all_i.gather(1, order), beam_i)
        expanded = torch.where(keep, all_e.gather(1, order), marked)
    out = (beam_s.reshape(s, c, ef), beam_i.to(torch.int32).reshape(s, c, ef))
    if return_work:
        return out + (expansions.reshape(s, c), scored.reshape(s, c),
                      visited.view(s, c, n).any(dim=1).sum(dim=1),
                      opened.view(s, c, n).any(dim=1).sum(dim=1))
    return out


def beam_search_np(data: np.ndarray, bottom: np.ndarray,
                   queries: np.ndarray, entries: np.ndarray, *,
                   metric: str, ef: int, max_iters: int,
                   scale: Optional[np.ndarray] = None,
                   zero: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of :func:`beam_search_ref` (per-row Python loop)."""
    data = np.asarray(data)
    bottom = np.asarray(bottom)
    queries = np.asarray(queries, np.float32)
    entries = np.asarray(entries)
    s, n, _ = data.shape
    m0 = bottom.shape[2]
    c = queries.shape[1]
    ef = min(ef, n)
    out_s = np.full((s, c, ef), -np.inf, np.float32)
    out_i = np.full((s, c, ef), -1, np.int32)
    for si in range(s):
        adj = bottom[si]
        codes = data[si]
        for ci in range(c):
            q = queries[si, ci]

            def score(rows_sel):
                if scale is not None:
                    return quant_scores_np(q[None, :], codes[rows_sel],
                                           scale, zero, metric=metric)[0]
                return M.similarity_matrix_np(
                    q[None, :], codes[rows_sel].astype(np.float32),
                    metric)[0]

            e = int(entries[si, ci])
            if e < 0:        # an empty slot: not walked
                continue
            visited = np.zeros(n, bool)
            visited[e] = True
            beam_s = np.full(ef, -np.inf, np.float32)
            beam_i = np.full(ef, -1, np.int32)
            expanded = np.zeros(ef, bool)
            beam_s[0] = score(np.asarray([e]))[0]
            beam_i[0] = e
            for _ in range(max_iters):
                live = ~expanded & (beam_i >= 0)
                if not live.any():
                    break
                j = int(np.argmax(np.where(live, beam_s, -np.inf)))
                node = int(beam_i[j])
                expanded[j] = True
                nbrs = adj[node]
                rows_sel = np.clip(nbrs, 0, n - 1)
                valid = (nbrs >= 0) & ~visited[rows_sel]
                sims = np.where(valid, score(rows_sel),
                                -np.inf).astype(np.float32)
                visited[nbrs[nbrs >= 0]] = True
                all_s = np.concatenate([beam_s, sims])
                all_i = np.concatenate(
                    [beam_i, np.where(valid, nbrs, -1).astype(np.int32)])
                all_e = np.concatenate([expanded, np.zeros(m0, bool)])
                order = np.argsort(-all_s, kind="stable")[:ef]
                beam_s = all_s[order].astype(np.float32)
                beam_i = all_i[order]
                expanded = all_e[order]
            out_s[si, ci] = beam_s
            out_i[si, ci] = beam_i
    return out_s, out_i
