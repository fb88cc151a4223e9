"""Serving launcher: prefill and greedy decode of a synthetic model, with
optional kNN-LM retrieval through a Pyramid datastore served by the
serving engine (port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --tokens 6 \
        [--retrieval [--quantize] [--rerank-factor 4]] \
        [--tenant NAME [--tenant-budget-mb 256]] \
        [--trace-out trace.json] [--metrics-port 0] [--device cpu]

The model is the ``.reduced()`` variant of ``--arch`` (as in the
reference launcher), its weights drawn from a seeded generator. It runs
on the CUDA device unless ``--device cpu`` is given. A frontend arch
(internvl2-2b, musicgen-medium) is prompted with seeded embeddings [B,
S, F], decodes over zero embeddings and refuses ``--retrieval``. With
``--retrieval`` the datastore is served by a ``ServingEngine`` through
``open_datastore_client`` (int8 with ``--quantize``), and every decode
step looks the last token's hidden state up through ``knn_probs(...,
client=...)`` and interpolates, as the reference launcher does. With
``--tenant`` the datastore is admitted as that named tenant through a
``TenantManager`` whose budget is ``--tenant-budget-mb``, and looked up
through the manager's client. ``--trace-out`` writes a Chrome trace of
the run, ``--metrics-port`` serves ``/metrics`` and ``/stats`` while it
runs.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.config import PyramidConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.registry import get_arch, list_archs
from repro_torch.models.transformer import grow_cache, init_params
from repro_torch.obs import MetricsRegistry, StatsServer, Tracer, get_logger
from repro_torch.serving.decode import decode_step, prefill_step
from repro_torch.serving.retrieval import (build_datastore, hidden_states,
                                           interpolate, knn_probs,
                                           open_datastore_client)

log = get_logger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Run the launcher; returns the generated ids [batch, tokens]."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true",
                    help="kNN-LM interpolation via a Pyramid datastore "
                         "served by the serving engine")
    ap.add_argument("--quantize", action="store_true",
                    help="serve the retrieval datastore from the int8 "
                         "arena (asymmetric distances + exact float32 "
                         "rerank; ~4x smaller device vector payload)")
    ap.add_argument("--rerank-factor", type=int, default=4,
                    help="with --quantize: exact-rerank the top "
                         "rerank_factor * k quantized candidates")
    ap.add_argument("--tenant", default=None, metavar="NAME",
                    help="serve the retrieval datastore as this named "
                         "tenant through a TenantManager (admission-"
                         "controlled device-memory budget, LRU "
                         "eviction; see repro_torch.serving.tenancy)")
    ap.add_argument("--tenant-budget-mb", type=float, default=256.0,
                    help="with --tenant: the manager's total device-"
                         "memory budget for tenant arenas, in MiB")
    ap.add_argument("--lam", type=float, default=0.3)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace_event JSON of the run "
                         "(validated; open in Perfetto)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus) and /stats on "
                         "this port for the duration of the run "
                         "(0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tracer = Tracer() if args.trace_out else None
    registry = MetricsRegistry()
    server = None
    if args.metrics_port is not None:
        server = StatsServer(registry, port=args.metrics_port).start()
        log.info("[serve] stats server on :%d (/metrics /stats)",
                 server.port)
    span = (tracer.span if tracer else
            (lambda *a, **kw: contextlib.nullcontext()))

    cfg = get_arch(args.arch).reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    if cfg.frontend:    # precomputed embeddings [B, S, F] stand for tokens
        prompt = torch.as_tensor(rng.normal(size=(
            args.batch, args.prompt_len, cfg.frontend_dim)).astype(
                np.float32), device=dev)
    else:
        prompt = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
            device=dev)

    ds = None
    ds_client = None
    # the datastore client owns its engine: the with-block stops the
    # executor threads on any exit path
    try:
        with contextlib.ExitStack() as stack:
            if args.retrieval:
                if cfg.frontend:
                    raise SystemExit("--retrieval expects a token-input arch")
                corpus = rng.integers(0, cfg.vocab_size, size=(8, 64))
                pyr = PyramidConfig(metric="l2", num_shards=4,
                                    meta_size=32, sample_size=400,
                                    branching_factor=2, max_degree=12,
                                    max_degree_upper=6, ef_construction=40,
                                    ef_search=60)
                with span("serve.build_datastore"):
                    ds = build_datastore(params, cfg, [corpus], pyr,
                                         device=dev)
                    if args.tenant:
                        from repro_torch.serving.tenancy import (
                            TenantManager)
                        tm = stack.enter_context(TenantManager(
                            int(args.tenant_budget_mb * 2**20),
                            registry=registry, device=dev))
                        tm.create(args.tenant, ds.index,
                                  quantize=args.quantize,
                                  rerank_factor=args.rerank_factor,
                                  tracer=tracer)
                        ds_client = tm.client(args.tenant)
                        log.info("[serve] tenant %r admitted: %s",
                                 args.tenant, tm.stats()["tenants"])
                        if server is not None:
                            server.add_stats_provider("tenancy", tm.stats)
                    else:
                        ds_client = stack.enter_context(
                            open_datastore_client(
                                ds, quantize=args.quantize,
                                rerank_factor=args.rerank_factor,
                                registry=registry, tracer=tracer))
                stats = ds_client.stats()
                log.info(
                    "[serve] datastore ready: %d entries, served by %d "
                    "executors on %s (quantized=%s, arena vector "
                    "bytes=%d)", ds.values.shape[0],
                    len(stats["executors"]), dev, stats["quantized"],
                    stats["arena_vector_bytes"])
                if server is not None:
                    server.add_stats_provider("engine", ds_client.stats)

            t0 = time.time()
            with span("serve.prefill", batch=args.batch,
                      prompt_len=args.prompt_len):
                logits, cache = prefill_step(params, prompt, cfg=cfg)
                cache = grow_cache(cache, args.prompt_len + args.tokens,
                                   window=cfg.sliding_window)
            log.info("[serve] prefill %s in %.2fs", tuple(prompt.shape),
                     time.time() - t0)

            tok = torch.argmax(logits[:, -1:].float(), dim=-1)
            if cfg.frontend:    # decode over embedding stand-ins
                tok_emb = torch.zeros((args.batch, 1, cfg.frontend_dim),
                                      dtype=torch.float32, device=dev)
            out_tokens = [tok[:, 0].cpu().numpy()]
            t0 = time.time()
            for t in range(args.tokens - 1):
                with span("serve.decode_step", step=t):
                    pos = torch.full((args.batch,), args.prompt_len + t,
                                     dtype=torch.int32, device=dev)
                    nxt, step_logits, cache = decode_step(
                        params, cache, tok_emb if cfg.frontend else tok, pos,
                        cfg=cfg)
                    if ds is not None:
                        # demo-grade retrieval key: the context-free
                        # hidden state of the last token, as in the
                        # reference launcher
                        kp = knn_probs(
                            ds, hidden_states(params, cfg, tok)[:, -1]
                            .float().cpu().numpy(), k=8,
                            vocab_size=cfg.vocab_size, client=ds_client)
                        mixed = interpolate(step_logits.cpu().numpy(), kp,
                                            lam=args.lam)
                        nxt = torch.as_tensor(mixed.argmax(-1), device=dev)
                    tok = nxt[:, None].long()
                    out_tokens.append(nxt.cpu().numpy())
            dt = time.time() - t0
    finally:
        if server is not None:
            server.stop()
    gen = np.stack(out_tokens, axis=1)
    log.info("[serve] decoded %d tokens/seq in %.2fs (%.1f tok/s)",
             args.tokens, dt, args.batch * args.tokens / max(dt, 1e-9))
    log.info("[serve] generated ids (row 0): %s", gen[0][:16])
    if tracer is not None:
        payload = tracer.write_chrome(args.trace_out)
        log.info("[serve] wrote %d trace events to %s",
                 len(payload["traceEvents"]), args.trace_out)
    return gen


if __name__ == "__main__":
    main()
