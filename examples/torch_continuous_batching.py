"""Continuous batching on the PyTorch port: more requests than decode
slots, slots recycled as sequences finish (twin of
``examples/continuous_batching.py``).

This drives the port's streaming engine (``repro_torch.serving.stream``)
in LM-only mode (datastore=None): the explicit prefill / insert /
generate_step surface, with tokens streamed back per step. The same
engine pointed at a Pyramid datastore turns every decode step into a
batched similarity query (see ``examples/torch_retrieval_decode.py``);
the simpler fixed-loop scheduler is ``repro_torch.serving.batcher.
ContinuousBatcher`` and gives the same greedy tokens.

PYTHONPATH=src python examples/torch_continuous_batching.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.common.registry import get_arch
from repro_torch.models.transformer import init_params
from repro_torch.serving.batcher import Request
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.stream import StreamEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = get_arch("qwen3-1.7b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)

    eng = StreamEngine(params, cfg, num_slots=4, max_seq=48,
                       sampler=SamplerConfig(greedy=True), device=dev)

    n_reqs = 10
    with eng:
        for i in range(n_reqs):
            plen = int(rng.integers(4, 12))
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=plen).astype(np.int32)
            sess = eng.prefill(Request(i, prompt, max_new_tokens=int(
                rng.integers(4, 10))))
            eng.insert(sess)

        t0 = time.time()
        streamed = 0
        while eng.has_work():
            streamed += len(eng.generate_step())   # [(req id, token)]
        dt = time.time() - t0
        done = eng.done

    total_tokens = sum(len(c.tokens) for c in done)
    assert streamed == total_tokens
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s) on {eng.num_slots} slots")
    for c in sorted(done, key=lambda c: c.request_id):
        print(f"  req {c.request_id}: prompt={c.prompt_len} "
              f"generated={len(c.tokens)} ids={c.tokens[:8]}")


if __name__ == "__main__":
    main()
