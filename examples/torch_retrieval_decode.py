"""Retrieval-augmented decoding (kNN-LM) over a Pyramid datastore, on
the PyTorch port (twin of ``examples/retrieval_decode.py``).

Builds a Pyramid datastore from a small qwen3-family model's hidden
states over a synthetic corpus, then decodes with kNN interpolation.

Two parts:
  1. the anatomy of one retrieval step: hidden-state query through the
     futures client, kNN vocab distribution, interpolation;
  2. the streaming engine (``repro_torch.serving.stream``) doing the same
     thing continuously: prefill / insert / generate_step with the
     per-step batched lookup double-buffered behind the next decode step.

PYTHONPATH=src python examples/torch_retrieval_decode.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.common.config import PyramidConfig
from repro_torch.common.registry import get_arch
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.transformer import forward, init_params
from repro_torch.serving.batcher import Request
from repro_torch.serving.retrieval import (build_datastore, hidden_states,
                                           interpolate, knn_probs,
                                           open_datastore_client)
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
    data = iter(SyntheticLM(cfg, batch=8, seq_len=32, seed=0))
    corpus = np.stack([next(data).inputs for _ in range(2)]).reshape(16, 32)

    print("building Pyramid datastore from model hidden states ...")
    pyr = PyramidConfig(metric="l2", num_shards=4, meta_size=32,
                        sample_size=400, branching_factor=2, max_degree=12,
                        max_degree_upper=6, ef_construction=40, ef_search=60)
    with torch.no_grad():
        ds = build_datastore(params, cfg, [corpus], pyr, device=dev)
    print(f"datastore: {ds.values.shape[0]} (hidden -> next-token) entries "
          f"across {ds.index.num_shards} sub-HNSWs")

    # -- part 1: one retrieval step, by hand ------------------------------
    # the datastore client owns its serving engine and is a context
    # manager: the with-block is the teardown
    prompt = torch.as_tensor(corpus[:2, :16], dtype=torch.int64, device=dev)
    with torch.no_grad(), open_datastore_client(ds) as client:
        hid = hidden_states(params, cfg, prompt).float().cpu().numpy()
        q = hid[:, -1]                     # current-position hidden state
        kp = knn_probs(ds, q, k=8, vocab_size=cfg.vocab_size,
                       client=client)
        logits, _, _ = forward(params, cfg, prompt)
    lm_logits = logits[:, -1].float().cpu().numpy()

    mixed = interpolate(lm_logits, kp, lam=0.5)
    gold = corpus[:2, 16]
    print(f"gold next tokens:          {gold}")
    print(f"LM-only argmax:            {lm_logits.argmax(-1)}")
    print(f"kNN-only argmax:           {kp.argmax(-1)}")
    print(f"interpolated argmax:       {mixed.argmax(-1)}")
    print("(the kNN memory recovers memorised continuations an untrained "
          "LM cannot)")

    # -- part 2: the streaming engine doing it continuously ---------------
    # every decode step issues ONE batched kNN lookup for all active
    # slots, resolved while the other slot group's decode step runs
    # (overlap=True); the int8 arena serves the datastore (quantize=True)
    print("\nstreaming decode: prefill / insert / generate_step ...")
    with StreamEngine(params, cfg, num_slots=4, max_seq=48,
                      datastore=ds, knn_k=8, lam=0.5,
                      quantize=True, rerank_factor=4, device=dev) as eng:
        for i in range(6):
            eng.submit(Request(i, corpus[i, :16].astype(np.int32),
                               max_new_tokens=8))
        while eng.has_work():
            for rid, tok in eng.generate_step():
                print(f"  req {rid} -> token {tok}")
        st = eng.stats()
    print(f"{st['sessions']['completed']} sessions, "
          f"{st['tokens_emitted']} tokens at "
          f"{st['tokens_per_s']:.1f} tok/s; per-step retrieval p50 "
          f"{st['retrieval']['latency_p50_s'] * 1e3:.2f} ms, kNN hit rate "
          f"{st['retrieval']['knn_hit_rate']:.2f}")


if __name__ == "__main__":
    main()
