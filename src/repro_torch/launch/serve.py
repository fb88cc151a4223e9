"""Serving launcher: prefill and greedy decode of a synthetic model, with
optional kNN-LM retrieval through a Pyramid datastore (port of
``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --tokens 6 \
        [--retrieval] [--device cpu]

The model is the ``.reduced()`` variant of ``--arch`` (as in the
reference launcher), its weights drawn from a seeded generator. It runs
on the CUDA device unless ``--device cpu`` is given. With
``--retrieval`` every decode step looks the last token's hidden state up
through ``knn_probs`` with no client (``search_single_host`` on the
datastore's device) and interpolates. The reference's serving-engine
options (``--quantize``, ``--rerank-factor``, ``--tenant``,
``--tenant-budget-mb``, ``--trace-out``, ``--metrics-port``) are not
ported yet and exit with a message.
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.registry import get_arch, list_archs
from repro_torch.models.transformer import grow_cache, init_params
from repro_torch.serving.decode import decode_step, prefill_step
from repro_torch.serving.retrieval import (build_datastore, hidden_states,
                                           interpolate, knn_probs)

log = logging.getLogger(__name__)

# options of the reference launcher that need the serving engine, the
# tenancy manager or the observability layer (ROADMAP.md section 1,
# queue 2: serving)
NOT_PORTED = ("quantize", "rerank_factor", "tenant", "tenant_budget_mb",
              "trace_out", "metrics_port")


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Run the launcher; returns the generated ids [batch, tokens]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true",
                    help="kNN-LM interpolation via a Pyramid datastore; "
                         "lookups go through knn_probs with no client "
                         "(search_single_host on the datastore's device)")
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    not_ported = "not yet ported (ROADMAP.md section 1, queue 2: serving)"
    ap.add_argument("--quantize", action="store_true", help=not_ported)
    ap.add_argument("--rerank-factor", type=int, help=not_ported)
    ap.add_argument("--tenant", metavar="NAME", help=not_ported)
    ap.add_argument("--tenant-budget-mb", type=float, help=not_ported)
    ap.add_argument("--trace-out", metavar="PATH", help=not_ported)
    ap.add_argument("--metrics-port", type=int, help=not_ported)
    args = ap.parse_args(argv)
    for name in NOT_PORTED:
        value = getattr(args, name)
        if value is not None and value is not False:
            ap.exit(2, f"--{name.replace('_', '-')} is {not_ported}\n")

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)), device=dev)

    ds = None
    if args.retrieval:
        corpus = rng.integers(0, cfg.vocab_size, size=(8, 64))
        pyr = PyramidConfig(metric="l2", num_shards=4, meta_size=32,
                            sample_size=400, branching_factor=2,
                            max_degree=12, max_degree_upper=6,
                            ef_construction=40, ef_search=60)
        ds = build_datastore(params, cfg, [corpus], pyr, device=dev)
        log.info("[serve] datastore ready: %d entries in %d shards on %s",
                 ds.values.shape[0], ds.index.num_shards, dev)

    t0 = time.time()
    logits, cache = prefill_step(params, prompt, cfg=cfg)
    cache = grow_cache(cache, args.prompt_len + args.tokens)
    log.info("[serve] prefill %s in %.2fs", tuple(prompt.shape),
             time.time() - t0)

    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    out_tokens = [tok[:, 0].cpu().numpy()]
    t0 = time.time()
    for t in range(args.tokens - 1):
        pos = torch.full((args.batch,), args.prompt_len + t,
                         dtype=torch.int32, device=dev)
        nxt, step_logits, cache = decode_step(params, cache, tok, pos,
                                              cfg=cfg)
        if ds is not None:
            # demo-grade retrieval key: the context-free hidden state of
            # the last token, as in the reference launcher
            kp = knn_probs(ds, hidden_states(params, cfg, tok)[:, -1]
                           .float().cpu().numpy(), k=8,
                           vocab_size=cfg.vocab_size)
            mixed = interpolate(step_logits.cpu().numpy(), kp, lam=args.lam)
            nxt = torch.as_tensor(mixed.argmax(-1), device=dev)
        tok = nxt[:, None].long()
        out_tokens.append(nxt.cpu().numpy())
    dt = time.time() - t0
    gen = np.stack(out_tokens, axis=1)
    log.info("[serve] decoded %d tokens/seq in %.2fs (%.1f tok/s)",
             args.tokens, dt, args.batch * args.tokens / max(dt, 1e-9))
    log.info("[serve] generated ids (row 0): %s", gen[0][:16])
    return gen


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
