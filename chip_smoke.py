"""Drive the PyTorch/CUDA port of the Pyramid index, its serving engine,
and kNN-LM serving over it, on one NVIDIA GPU.

    python3 chip_smoke.py [--n 50000]

Phases, each raising on failure (the script then exits non-zero):

  1. environment: the card's name and power limit, torch and CUDA
     versions, and the kernels' build from the sources in ``src/``
     (one ``nvcc`` process for each CUDA source, all started together);
  2. kernels against their plain PyTorch versions on the card, at the
     main path's shapes, with their times from CUDA events, their bounds
     and, where one exists, a PyTorch library call's time (the beam walk
     also with its time over the longest walk's expansions);
  3. a small index searched on the card and on the CPU (plain versions),
     float32, int8 and filtered: the answers must agree;
  4. the main path: ``build_pyramid_index_parallel`` (the shards' host
     builds in a process pool, largest first) on
     ``clustered_vectors(N, 128)`` with the paper's index parameters,
     then ``search_single_host`` on float32, int8 (rerank factor 4) and a
     filtered batch, each answer checked (well formed, exact scores of
     the rows returned, only alive rows under the filter), with recall@10
     against brute force, QPS, access rate, the shard-queue slots walked
     against those routed, the beam kernel's device time a launch, peak
     device memory and every kernel's launch count; and a brute-force
     scan of the whole int8
     arena through ``quant_scores`` (the int8 distance kernel's entry
     point), its top 10 held against float64 scores of the dequantized
     rows on a slice of the queries (the plain float32 version's share
     recorded beside); and the LSH baseline (``build_lsh``,
     ``search_lsh`` with the paper's Fig. 9 parameters: recall@10, QPS
     beside Pyramid's, its rerank through the top-k kernel, ids equal to
     the CPU's on a slice of the queries);
  5. kNN-LM serving of qwen3-1.7b at full width (bf16, synthetic weights
     from a seeded generator): first a float32 check that greedy decode
     from the prefill cache matches the full forward step by step; then
     the serving path: a datastore of hidden states over a seeded corpus
     (``build_datastore``), ``ContinuousBatcher`` over 16 requests in 8
     slots, and a kNN-LM step (``hidden_states`` -> ``knn_probs`` ->
     ``interpolate``) whose kNN argmax must hit the corpus's next token,
     with prefill and decode-step times, tokens/s, peak device memory,
     launches per kernel (``flash_decode`` once per layer and step) and
     flash-decode's device time a launch in a profiled decode step;
  6. mamba2-780m serving at full width, the same way (bf16, synthetic
     weights): a float32 check of the recurrent decode from the prefill
     state against the full forward, held layer by layer (each layer fed
     the full forward's own inputs; the end-to-end logits are recorded),
     a datastore of 2,048 keys, 16 requests in 8 slots, and a kNN-LM
     step; the SSD kernel must run once per layer in every full forward
     and never in a decode step. Phases 5 and 6 run their kNN-LM step a
     second time through the serving engine (``open_datastore_client``,
     as the reference launcher looks up), and drive the streaming engine
     (``StreamEngine``, 5s and 6s) over the phase's datastore and
     prompts, 16 new tokens a session in two groups of 4 slots: for qwen3
     the reference test's clean run (overlapped), a serialized run with
     tokens equal to it, an int8 run, and the test's fault storm (tokens
     equal to the clean run's); for mamba2 overlapped and serialized
     runs with equal tokens; each with flash-decode once a layer and step, the SSD once a layer
     and prefill, the beam kernel in its lookups and a kNN hit rate of
     at least 0.9; the float32 check of phase 5 also holds
     ``StreamEngine``'s greedy tokens equal to ``ContinuousBatcher``'s,
     and the two streaming examples run on the card in subprocesses,
     beside phase 6 (the streaming part raises past 180 s);
  7. Pyramid's serving engine on phase 4's index: ``ServingEngine`` with
     2 replicas of each of the 16 shards (32 executor threads on one
     device arena), 1,024 queries through ``PyramidClient.search_batch``
     in float32 and in int8 (rerank factor 4), then a seeded
     ``FaultSchedule.storm`` under the Monitor with ``auto_restart``:
     every future resolves exactly once, the storm's ids equal the
     fault-free run's query by query, and recall@10 is held to phase 4's;
     the beam kernel's device time a launch is read from a profiled
     float32 batch;
  8. the index store, online updates, the paper's API and tenancy:
     phase 4's index published to an ``IndexStore`` and loaded back on
     the card (its float32 and int8 ids, int8 grid and codes equal to
     phase 4's); a 1,024-row index built here, published, updated
     (``add_items`` of 128 rows from two clusters, ``set_item_tags``,
     ``remove_items`` of 32 ids) and checked live, then recovered by
     ``ServingEngine.from_store`` (the loaded index's segment checksums
     and ids equal to the live index's; recall within 0.02 of the
     pre-crash engine's) and by ``from_store`` in int8 (codes equal);
     Listing 1's ``Coordinator`` over the first store (ids equal to phase
     7's), a hot swap onto the recovered second index under an open
     client, and a ``TenantManager`` whose budget
     holds one of the two tenants: the evicted tenant's device memory
     comes back and its re-pinned ids are identical;
  9. online maintenance on the second store (``Compactor``): its delta
     log folded into a new version, which loads back with nothing to
     replay and the same segment checksums and ids; a cycle killed at its
     commit point (``publish``) and recovered to the crash-free state,
     each record applied once; then, through
     ``Brokers.attach_maintenance`` under an open client, a shard split,
     a cycle at the default factors, a centroid refresh and the default
     factors again, each followed by a hot swap: every in-flight future resolves once and recall@10
     stays within 0.02 of the engine's before maintenance (under 100 s,
     it raises past that).
  10. the multi-device path at world size 1: a (1, 1) mesh on NCCL, the
     SPMD search over phase 4's index and the distributed build's reads
     and k-means (under 60 s);
  11. training (under 120 s): ``train_step`` at full width, bf16, for
     mamba2-780m (batch 4 x 640, 4 steps: every leaf's gradient non-zero
     at step 1, the SSD kernel exactly twice a layer and step under remat
     and its backward kernel once) and qwen3-1.7b (batch 8 x 256, 3
     steps, no kernel of the port), with step times, tokens/s and peak
     device memory, and a bf16 checkpoint round trip; the reduced configs
     trained on the card and on the CPU from the same parameters and
     batches (losses and step-1 gradients within 1e-4), then the
     reference test's 60-step run on the card (its loss criterion); and
     ``python -m repro_torch.launch.train`` in a subprocess, its
     checkpoint loaded back bit for bit. Phase 2 holds the SSD's backward
     kernel against float64 autograd at three shapes, the layer's in bf16
     and in float32.
  12. sliding-window and local-global attention (under 150 s): 12a a
     float32 check of gemma3-12b at the reference config's widths
     (``configs/gemma3_12b.py``: d = 3,840, hd = 240) and depth 12
     (two 5:1 periods: ten layers on 1,024-slot rings, two global; the
     depth is the only cut), 4 prompts of 1,100 tokens then 32 greedy
     steps, decode logits within 1e-3 of the full forward and greedy
     tokens equal; 12b gemma3-12b's kNN-LM serving at full width (48
     layers, bf16 synthetic weights, 40 ring layers and 8 global ones) as
     phase 5 serves qwen3: a 1,400-key datastore (d = 3,840), 16
     requests of 700 to 1,400 tokens in 8 slots of a 2,048-row cache (a
     ring wraps in prefill, in decode, or never), 64 new tokens each,
     flash-decode 48 times a step, one overlapped ``StreamEngine`` run
     of 32 new tokens, and the kNN-LM step; 12c the float32 checks of
     h2o-danube-1.8b (hd = 80, a 4,000-token prompt and 200 steps
     through its 4,096-slot rings) and chatglm3-6b (16 query heads a kv
     head, 2-D rope; 256 tokens and 32 steps) at their configs' widths
     and depth 2. Flash-decode's plain version never runs on the card there.
     Phase 2 holds flash-decode at phase 12's shapes (hd = 80 and 240, G
     = 16, rings, a window) and the beam kernel at d = 3,840.

The line before the last is a JSON object with one entry per kernel (of
its phase-2 rows with a library call, the slowest against it; else its
first row); the last line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
L2_BYTES = 50e6

# kernel vs plain: share of equal ids, and score tolerance on equal ids
# (the kernel sums each dot product in another order than cuBLAS)
IDS_EQUAL_MIN = 0.999
N_QUERIES = 1024
RTOL, ATOL = 1e-5, 1e-4
# flash-decode vs its plain version: both read the same cache values and
# sum in float32, in another order
DECODE_TOL = 1e-4
# the int8 distance scan vs its plain version, relative to the largest
# |score| of the output: the kernel sums d = 128 exact products (three
# bf16 pieces of q * scale times the codes) in float32 on the tensor
# cores, cuBLAS sums q * x in its own order, so a score near zero can part
# by more than 1e-5 of itself; the elementwise rtol = atol = 1e-5 of the
# JAX tests is recorded beside
QUANT_TOL = 1e-5
# the SSD scan vs its plain version on float32 copies of the same inputs,
# as a share of the largest |y| (and of the largest |state|): both sum in
# float32, in another order, and the decays are exponentials of
# differences of float32 prefix sums that reach |cum| ~ 10^3 in a chunk
# (the plain version at chunks of 64 and of 256, the same function,
# differs by 1e-5 of max |y| at these decay rates on the CPU)
SSD_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, ids_k, ids_r, s_k, s_r) -> dict:
    import torch
    same = ids_k == ids_r
    share = float(same.float().mean())
    both = same & (ids_r >= 0)
    err = float((s_k[both] - s_r[both]).abs().max()) if bool(both.any()) \
        else 0.0
    ok_scores = bool(torch.all((s_k[both] - s_r[both]).abs()
                               <= ATOL + RTOL * s_r[both].abs()))
    pads_ok = bool(torch.equal(ids_k < 0, torch.isneginf(s_k)))
    if share < IDS_EQUAL_MIN or not ok_scores or not pads_ok:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (ids equal "
            f"{share:.5f}, max score err {err:.3g}, pads ok {pads_ok})")
    return {"ids_equal": share, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------


def environment() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.load_all()
    build_s = time.perf_counter() - t0
    for name in cuda_lib.sources():
        text = cuda_lib.build_log(name)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"nvcc {name}.cu: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers, {sum(spills)} bytes of "
            f"spill stores")
    log(f"kernel build (nvcc): {build_s:.2f} s")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc_build_s": build_s}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def beam_rows(n: int) -> list:
    """Phase 2's beam_search rows: the shard walk's shape (ef=100) under
    each metric, float32 and int8; the filtered shard walk's (ef = 100 x
    the inflation cap 8, n near the main path's largest shard); the
    routing walk's over the meta-HNSW (1,000 centres); an engine
    executor's batch (16 walks over one shard of n / 16 rows); and the
    kNN-LM lookups' shard walks of phases 5 and 6 (DATASTORE_PYR: 4
    shards of the 4,096-key qwen3-1.7b, 2,048-key mamba2-780m and
    1,400-key gemma3-12b datastores at their widths, M0 = 2 x
    max_degree, 8 slots, ef=60; d = 3,840 stages slices of d, not whole
    rows)."""
    rows = [dict(metric=m, quantized=qz) for qz in (False, True)
            for m in ("l2", "ip", "angular")]
    return rows + [
        dict(metric="l2", quantized=False, n=16_384, c=512, ef=800),
        dict(metric="l2", quantized=False, s=1, n=1000, c=1024, ef=64),
        dict(metric="l2", quantized=False, s=1, n=n // 16, c=16, ef=100),
        dict(metric="l2", quantized=False, s=4, n=1024, d=2048, m0=24, c=8,
             ef=60),
        dict(metric="l2", quantized=False, s=4, n=512, d=1536, m0=24, c=8,
             ef=60),
        dict(metric="l2", quantized=False, s=4, n=350, d=3840, m0=24, c=8,
             ef=60)]


def beam_inputs(dev, metric: str, quantized: bool, *, s: int = 16,
                n: int = 65_536, d: int = 128, m0: int = 32, c: int = 256,
                ef: int = 100, seed: int = 0):
    """S graphs of n rows of width d (16 x 65,536 is a 1M-row arena),
    M0 neighbour slots, C query slots each, on random -1-padded graphs:
    (data, bottom, queries, entries, keyword arguments of the walk)."""
    import torch
    max_iters = 400
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(s, n, d, device=dev, generator=g)
    bottom = torch.randint(0, n, (s, n, m0), device=dev, generator=g,
                           dtype=torch.int32)
    bottom[torch.rand(s, n, m0, device=dev, generator=g) < 0.2] = -1
    q = torch.randn(s, c, d, device=dev, generator=g)
    e = torch.randint(0, n, (s, c), device=dev, generator=g,
                      dtype=torch.int32)
    scale = zero = None
    if quantized:
        lo, hi = x.amin(dim=(0, 1)), x.amax(dim=(0, 1))
        scale, zero = (hi - lo) / 254.0, (hi + lo) / 2.0
        x = torch.clamp(torch.round((x - zero) / scale), -127, 127).to(
            torch.int8)
    return x, bottom, q, e, dict(metric=metric, ef=ef, max_iters=max_iters,
                                 scale=scale, zero=zero)


def check_beam(dev, metric: str, quantized: bool, *, s: int = 16,
               n: int = 65_536, d: int = 128, m0: int = 32, c: int = 256,
               ef: int = 100, seed: int = 0) -> dict:
    """The walk of ``beam_inputs`` on the kernel against its plain
    version; ``ms_per_expansion`` is the kernel's time over the longest
    walk's expansions (the chain a launch cannot be shorter than)."""
    import torch
    from repro_torch.kernels.beam_search import (beam_search_cuda,
                                                 beam_search_ref)
    x, bottom, q, e, kw = beam_inputs(dev, metric, quantized, s=s, n=n, d=d,
                                      m0=m0, c=c, ef=ef, seed=seed)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r, expansions, scored, rows, adj_rows = beam_search_ref(
        x, bottom, q, e, return_work=True, **kw)
    out = compare(f"beam_search {metric} {'int8' if quantized else 'f32'} "
                  f"ef={ef}", i_k, i_r, s_k, s_r)
    out["ms"] = cuda_ms(lambda: beam_search_cuda(x, bottom, q, e, **kw), 3)
    out["plain_ms"] = cuda_ms(lambda: beam_search_ref(x, bottom, q, e, **kw),
                              1, warmup=0)
    longest = int(expansions.max())
    out["longest_walk_expansions"] = longest
    out["ms_per_expansion"] = out["ms"] / max(1, longest)
    # the least the card must move: each distinct data row and adjacency
    # row of a graph read once (re-reads by other slots of that graph can
    # hit in L2), queries and entries in, beams out; the operations count
    # every scored row of every slot
    elem = 1 if quantized else 4
    n_exp, n_scored = int(expansions.sum()), int(scored.sum())
    n_rows, n_adj = int(rows.sum()), int(adj_rows.sum())
    efp = min(ef, n)
    nbytes = (n_rows * d * elem + n_adj * m0 * 4 + s * c * (d * 4 + 4)
              + s * c * efp * 8 + (2 * d * 4 if quantized else 0))
    ops_per_elem = 2 + (2 if metric != "ip" else 0) + (2 if quantized else 0)
    ops = n_scored * d * ops_per_elem
    out.update(shape=f"S={s} n={n} d={d} M0={m0} C={c} ef={ef}",
               metric=metric, dtype="int8" if quantized else "float32",
               expansions=n_exp, rows_scored=n_scored, distinct_rows=n_rows,
               distinct_adjacency_rows=n_adj, bytes=nbytes, ops=ops,
               library_ms=None, **bound(nbytes, ops))
    del x, bottom, q, e
    torch.cuda.empty_cache()
    return out


def bound(nbytes: float, ops: float, flops: float = FP32_FLOPS) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the merge's CUDA kernels (merge_warp_kernel, merge_block_kernel), as the
# profiler names them
MERGE_KERNEL_NAME = "merge_"


def check_merge(dev, b: int, m: int, k: int, seed: int = 1) -> dict:
    """B rows of m = w * k partials with duplicate ids (replication)."""
    import torch
    from repro_torch.kernels.merge_topk import merge_topk_cuda, merge_topk_ref
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(b, m, device=dev, generator=g)
    ids = torch.randint(-1, 4 * m, (b, m), device=dev, generator=g,
                        dtype=torch.int32)
    s_k, i_k = merge_topk_cuda(scores, ids, k=k)
    s_r, i_r = merge_topk_ref(scores, ids, k=k)
    out = compare(f"merge_topk m={m} k={k}", i_k, i_r, s_k, s_r)
    # a selection: ids and scores must be equal, not close
    if not (torch.equal(i_k, i_r) and torch.equal(s_k, s_r)):
        raise AssertionError(f"merge_topk m={m} k={k}: ids or scores differ "
                             f"from the plain version's")
    out["ms"] = cuda_ms(lambda: merge_topk_cuda(scores, ids, k=k), 20)
    out["kernel_device_ms"] = device_kernels_of(
        lambda: merge_topk_cuda(scores, ids, k=k), 20, MERGE_KERNEL_NAME)[0]
    out["plain_ms"] = cuda_ms(lambda: merge_topk_ref(scores, ids, k=k), 3)
    nbytes = b * m * 8 + b * k * 8
    ops = b * m * k * 3    # k rounds of max, position and id-match over m
    out.update(shape=f"B={b} m={m} k={k}", bytes=nbytes, ops=ops,
               library_ms=None, **bound(nbytes, ops))
    return out


def check_topk(dev, b: int, n: int, d: int, k: int, metric: str,
               seed: int = 2) -> dict:
    import torch
    from repro_torch.kernels.topk_distance import (topk_similarity_cuda,
                                                   topk_similarity_ref)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, d, device=dev, generator=g)
    x = torch.randn(n, d, device=dev, generator=g)
    s_k, i_k = topk_similarity_cuda(q, x, k=k, metric=metric)
    s_r, i_r = topk_similarity_ref(q, x, k=k, metric=metric)
    out = compare(f"topk_distance k={k} {metric}", i_k, i_r, s_k, s_r)
    out["ms"] = cuda_ms(
        lambda: topk_similarity_cuda(q, x, k=k, metric=metric), 20)
    out["kernel_device_ms"], _, out["stage_device_ms"] = device_kernels_of(
        lambda: topk_similarity_cuda(q, x, k=k, metric=metric), 10, "topk_")
    out["plain_ms"] = cuda_ms(
        lambda: topk_similarity_ref(q, x, k=k, metric=metric), 5)
    xn = -(x * x).sum(dim=1)
    if metric == "l2":   # 2 q.x - |x|^2 ranks as -||q - x||^2 per query
        def lib():
            return torch.topk(torch.addmm(xn, q, x.T, alpha=2.0), k)
    else:
        def lib():
            return torch.topk(q @ x.T, k)
    out["library_ms"] = cuda_ms(lib, 20)
    nbytes = (b * d + n * d) * 4 + b * k * 8
    ops = 2 * b * n * d
    out.update(shape=f"B={b} n={n} d={d} k={k}", metric=metric,
               bytes=nbytes, ops=ops, **bound(nbytes, ops))
    return out


def quant_inputs(dev, b: int, n: int, d: int, seed: int, phase4: bool):
    """The int8 scan's inputs: with ``phase4``, phase 4's own data, queries
    and int8 grid (``clustered_vectors``, ``query_set``, the index's
    ``QuantParams`` from per-dimension min and max over all rows), else
    the JAX kernel test's (rows with per-dimension scales of 0.5 to 3,
    normal queries)."""
    import torch
    from repro_torch.core.quant import QuantParams
    from repro_torch.data.synthetic import clustered_vectors, query_set
    if phase4:
        x = clustered_vectors(n, d, 1000, seed=0)
        q = query_set(x, b, seed=1)
    else:
        rng = np.random.default_rng(seed)
        x = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=(1, d))
             ).astype(np.float32)
        q = rng.normal(size=(b, d)).astype(np.float32)
    params = QuantParams.from_data(x)
    return [torch.as_tensor(a).to(dev) for a in (
        q, params.quantize(x), params.scale, params.zero)]


def check_quant(dev, b: int, n: int, d: int, metric: str,
                phase4: bool = False, seed: int = 6) -> dict:
    """The int8 distance scan against its plain version (dequantize, then
    ``similarity_matrix``), with ``torch.matmul`` of the queries against
    the already dequantized float32 rows as a yardstick: a different
    input, not the same function, so no library call is named."""
    import torch
    from repro_torch.kernels.quant_distance import (dequantize,
                                                    quant_scores_cuda,
                                                    quant_scores_ref)
    q, codes, scale, zero = quant_inputs(dev, b, n, d, seed, phase4)
    out = quant_scores_cuda(q, codes, scale, zero, metric=metric)
    ref = quant_scores_ref(q, codes, scale, zero, metric=metric)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = float(diff.max())
    scale_ = float(ref.abs().max())
    outside = int((diff > 1e-5 + 1e-5 * ref.abs()).sum())
    del diff
    if not (out.shape == (b, n) and bool(torch.isfinite(out).all())
            and err <= QUANT_TOL * scale_):
        raise AssertionError(
            f"quant_distance B={b} n={n} d={d} {metric}: kernel disagrees "
            f"with its plain version (max abs err {err:.3g}, |score| <= "
            f"{scale_:.3g}, tolerance {QUANT_TOL} of it)")
    del out, ref
    rows = dequantize(codes, scale, zero)
    reps = 20 if b * n > 1e6 else 200
    ms = cuda_ms(lambda: quant_scores_cuda(q, codes, scale, zero,
                                           metric=metric), reps)
    device_ms = device_kernels_of(
        lambda: quant_scores_cuda(q, codes, scale, zero, metric=metric),
        reps, "quant_distance")[0]
    plain_ms = cuda_ms(lambda: quant_scores_ref(q, codes, scale, zero,
                                                metric=metric), 5)
    yardstick_ms = cuda_ms(lambda: torch.matmul(q, rows.T), reps)
    del rows, q, codes
    torch.cuda.empty_cache()
    return {"shape": f"B={b} n={n} d={d}", "metric": metric,
            "max_abs_err": err, "score_scale": scale_,
            "tolerance": QUANT_TOL, "outside_rtol_atol_1e-5": outside,
            "ms": ms, "kernel_device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "matmul_yardstick_ms": yardstick_ms,
            **quant_bounds(b, n, d)}


def quant_bounds(b: int, n: int, d: int) -> dict:
    """The int8 scan's least work: codes, queries, scale and zero read
    once and the float32 scores written once, against the kernel's
    tensor-core products (three bf16 pieces of the query side: 3 x 2 B n
    d at the bf16 rate); ``fp32_fma_bound_ms`` is the bound of 2 B n d
    float32 FMAs instead (the CUDA-core kernel's, PRs 15 to 18)."""
    nbytes = n * d + 4 * b * d + 4 * b * n + 8 * d
    ops = 3 * 2 * b * n * d
    return {"bytes": nbytes, "ops": ops, **bound(nbytes, ops, BF16_FLOPS),
            "fp32_fma_bound_ms": bound(nbytes, 2 * b * n * d)["bound_ms"]}


def device_kernels_of(fn, reps: int, name: str):
    """(device ms per call, CUDA kernels per call, {kernel: device ms per
    call}) of the kernels whose name holds ``name``, from
    ``torch.profiler`` over ``reps`` calls: the card's own time, without
    the host's enqueue time that CUDA events over back-to-back launches
    include when a launch is shorter than its enqueue. A kernel is named
    by its function name, without namespace and template arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        if events:
            break
    us = sum(e.self_device_time_total for e in events)
    by_name = {}
    for e in events:
        m = re.search(r"(\w+)(?:<[^<>()]*>)?\(", e.key)
        short = m.group(1) if m else e.key
        by_name[short] = by_name.get(short, 0.0) + \
            e.self_device_time_total / 1e3 / reps
    return us / 1e3 / reps, sum(e.count for e in events) / reps, by_name


def served_positions(b: int, seed: int,
                     arch: str = "qwen3-1.7b") -> np.ndarray:
    """Cache positions of ``arch``'s served decode steps (its LM_SPECS
    cell): a prompt of prompt_lo to prompt_hi tokens plus 0 to max_new
    generated ones, in each of b slots."""
    cell = LM_SPECS[arch]["cell"]
    rng = np.random.default_rng(seed)
    return (rng.integers(cell["prompt_lo"], cell["prompt_hi"] + 1, b)
            + rng.integers(0, cell["max_new"] + 1, b) - 1)


def decode_inputs(dev, *, b: int = 8, s: int = 1024, h: int = 16,
                  kvh: int = 8, hd: int = 128, dtype: str = "bfloat16",
                  pos: str = "random", seed: int = 3):
    """q [B, H, hd] f32, a cache [B, S, KV, hd] in ``dtype`` and ``pos``:
    "random" (0..S-1), "full" (S - 1), "served" (:func:`served_positions`
    of qwen3-1.7b) or "served-gemma3" (those of gemma3-12b)."""
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, hd, device=dev, generator=g)
    k = torch.randn(b, s, kvh, hd, device=dev, generator=g).to(dt)
    v = torch.randn(b, s, kvh, hd, device=dev, generator=g).to(dt)
    if pos == "full":
        p = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    elif pos.startswith("served"):
        arch = "gemma3-12b" if pos == "served-gemma3" else "qwen3-1.7b"
        p = torch.as_tensor(served_positions(b, seed, arch),
                            dtype=torch.int32, device=dev)
    else:
        p = torch.randint(0, s, (b,), device=dev, generator=g,
                          dtype=torch.int32)
    return q, k, v, p


def rotating(k, v, fn):
    """``fn(k, v)`` over enough copies of the cache that each call reads
    it from device memory, not from the 50 MB L2, as a layer of a decode
    step does: (the call, the copies)."""
    import itertools
    copies = max(1, -(-int(4 * L2_BYTES) // (2 * k.nbytes)))
    it = itertools.cycle([(k, v)] + [(k.clone(), v.clone())
                                     for _ in range(copies - 1)])
    return (lambda: fn(*next(it))), copies


def decode_bound(k, pos, b: int, h: int, window: int = 0) -> dict:
    """The least the card must move: the valid K and V rows (0..pos[b],
    or the last ``window`` of them), q and pos in, the float32 output
    out; the operations are q.k and p.v for every head and valid row."""
    kvh, hd = k.shape[2], k.shape[3]
    valid = pos.long() + 1
    if window:
        valid = valid.clamp(max=window)
    rows = int(valid.sum())
    nbytes = (2 * rows * kvh * hd * k.element_size() + b * h * hd * 4 * 2
              + b * 4)
    ops = 4 * rows * h * hd
    return {"valid_rows": rows, "bytes": nbytes, "ops": ops,
            **bound(nbytes, ops)}


def check_decode(dev, *, b: int = 8, s: int = 1024, h: int = 16,
                 kvh: int = 8, hd: int = 128, dtype: str = "bfloat16",
                 pos: str = "random", seed: int = 3, window: int = 0,
                 ring: bool = False) -> dict:
    """Flash-decode against its plain version (:func:`decode_inputs`),
    with ``window`` the lower bound of a full-size cache on a sliding
    layer; ``ring``: the cache is a ring of S slots at positions past it,
    read as a sliding layer's decode reads it (pos_eff = min(pos, S - 1),
    every slot valid). Launches rotate over copies of the cache
    (:func:`rotating`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_cuda)
    q, k, v, pos_t = decode_inputs(dev, b=b, s=s, h=h, kvh=kvh, hd=hd,
                                   dtype=dtype, pos=pos, seed=seed)
    pos_mode, pos = pos, pos_t
    if ring:        # absolute positions s..3s-1, the ring's slots all valid
        pos = (pos + s).clamp(max=s - 1)
    out = flash_decode_cuda(q, k, v, pos, window)
    ref = decode_attention_ref(q, k, v, pos, window)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=DECODE_TOL, atol=DECODE_TOL):
        raise AssertionError(f"flash_decode B={b} S={s} H={h} KV={kvh} "
                             f"hd={hd} {dtype} {pos_mode} window={window} "
                             f"ring={ring}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3g})")
    rows = torch.arange(s, device=dev)[None, :]
    mask = rows <= pos[:, None].long()
    if window:
        mask &= rows > pos[:, None].long() - window
    mask = mask[:, None, None, :]
    qs = q.to(k.dtype)[:, :, None, :]
    launch, copies = rotating(
        k, v, lambda kk, vv: flash_decode_cuda(q, kk, vv, pos, window))
    ms = cuda_ms(launch, 100)
    kernel_ms = device_kernels_of(launch, 20, "flash_decode")[0]
    plain_ms = cuda_ms(rotating(
        k, v, lambda kk, vv: decode_attention_ref(q, kk, vv, pos,
                                                  window))[0], 5)
    library_ms = cuda_ms(rotating(
        k, v, lambda kk, vv: F.scaled_dot_product_attention(
            qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True))[0], 100)
    del launch
    torch.cuda.empty_cache()
    shown = {"full": "S-1", "served": "served",
             "served-gemma3": "gemma3 served"}.get(pos_mode, pos_mode)
    if ring:
        shown = "past the ring (every slot)"
    return {"shape": f"B={b} S={s} H={h} KV={kvh} hd={hd} {dtype} "
                     f"pos={shown}" + (f" window={window}" if window else "")
                     + (" ring" if ring else ""),
            "max_abs_err": err, "ms": ms, "kernel_device_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "cache_copies": copies, **decode_bound(k, pos, b, h, window)}


def check_ssd(dev, *, b: int = 1, s: int = 513, dtype: str = "bfloat16",
              h: int = 48, p: int = 64, n: int = 128, chunk: int = 256,
              reps: int = 20, seed: int = 4) -> dict:
    """The SSD scan against its plain version (``ssd_chunked`` on float32
    copies of the same inputs) at mamba2-780m's width: x [B, S, H, P] in
    ``dtype``, dt = softplus(normal) and a = -linspace(1, 16, H) as the
    model makes them, B and C the two halves of one [B, S, 2N]
    projection, read in place. Launches rotate over enough copies of the
    inputs that each one reads them from device memory, not from the
    50 MB L2, as a layer of a prefill does."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ssd_cuda, ssd_ref
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, device=dev, generator=g).to(dt_)
    dt = F.softplus(torch.randn(b, s, h, device=dev, generator=g))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    bc = torch.randn(b, s, 2 * n, device=dev, generator=g).to(dt_)
    y, st = ssd_cuda(x, dt, a, bc[..., :n], bc[..., n:], chunk=chunk)
    xf, bcf = x.float(), bc.float()

    def plain():
        return ssd_ref(xf, dt, a, bcf[..., :n], bcf[..., n:], chunk=chunk)
    y_r, st_r = plain()
    torch.cuda.synchronize()
    err = float((y - y_r).abs().max())
    err_state = float((st - st_r).abs().max())
    y_scale, st_scale = float(y_r.abs().max()), float(st_r.abs().max())
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()
            and err <= SSD_TOL * y_scale and err_state <= SSD_TOL * st_scale):
        raise AssertionError(
            f"ssd B={b} S={s} {dtype}: kernel disagrees with its plain "
            f"version (max abs err {err:.3g} of |y| <= {y_scale:.3g}, state "
            f"{err_state:.3g} of {st_scale:.3g}; tolerance {SSD_TOL} of each)")
    in_bytes = x.nbytes + dt.nbytes + bc.nbytes
    copies = max(1, -(-int(4 * L2_BYTES) // in_bytes))
    inputs = [(x, dt, bc)] + [(x.clone(), dt.clone(), bc.clone())
                              for _ in range(copies - 1)]
    it = itertools.cycle(inputs)

    def launch():
        xx, dd, bb = next(it)
        return ssd_cuda(xx, dd, a, bb[..., :n], bb[..., n:], chunk=chunk)
    ms = cuda_ms(launch, reps)
    # every stage's kernel is named ssd_kernel_*: the sum over the call
    kernel_ms, per_call, stages = device_kernels_of(
        launch, max(3, reps // 2), "ssd_kernel")
    plain_ms = cuda_ms(plain, 2)
    # the least the card must move: x, dt, a, B and C read once, y and the
    # state written once; the least operations of the chunked form: C B^T
    # once per (b, chunk) over its causal lower triangle (all heads share
    # it), then per head the triangle's product with x and the two state
    # terms (C S and B^T x), counted over the rows each chunk holds
    q = min(chunk, s)
    rows = [min(q, s - t) for t in range(0, s, q)]
    ops = sum(b * r * (r + 1) * n + b * h * (r * (r + 1) * p + 4 * r * n * p)
              for r in rows)
    nbytes = in_bytes + a.nbytes + y.nbytes + st.nbytes
    del inputs, it
    torch.cuda.empty_cache()
    return {"shape": f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} {dtype}",
            "max_abs_err": err, "max_abs_err_state": err_state,
            "y_scale": y_scale, "state_scale": st_scale, "tolerance": SSD_TOL,
            "ms": ms, "kernel_device_ms": kernel_ms,
            "cuda_kernels_per_call": per_call, "stage_device_ms": stages,
            "plain_ms": plain_ms,
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "input_copies": copies,
            **bound(nbytes, ops, ssd_flops(dtype))}


# the SSD backward against autograd through the plain scan on float64
# copies of the same inputs (the truth), within SSD_BWD_TOL and
# SSD_BWD_TOL_BF16 of each output's largest |value| (kernels/ssd/ops.py
# says why); the plain float32 version's share is recorded beside
SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "db", "dc", "dinit")


def ssd_flops(dtype: str) -> float:
    """The card's peak for the SSD kernels' products on ``dtype`` inputs:
    both run every product on the tensor cores (float32 operands as fp16
    pieces in three passes, csrc/ssd.cu), so a float32 row is bound at
    the tensor cores' float32 (TF32) rate, not at float32 FMAs'."""
    return BF16_FLOPS if dtype == "bfloat16" else TF32_FLOPS


def ssd_backward_ops(b: int, s: int, h: int, p: int, n: int,
                     chunk: int) -> float:
    """The least operations of the SSD's backward on these inputs,
    counted over the rows each chunk holds: C B^T and the two products
    with G over the causal lower triangle once per (b, chunk), and per
    head the six [rows, N] x [N or rows, P] state products (each chunk's
    state and state-gradient terms, B Sb, C S_c, and the head's parts of
    dB and dC) and two over the triangle (dy x^T, and dx's)."""
    q = min(chunk, s)
    rows = [min(q, s - t) for t in range(0, s, q)]
    return float(sum(b * (r * (r + 1) // 2) * n * 2 * 3 + b * h * (
        r * n * p * 2 * 6 + (r * (r + 1) // 2) * p * 2 * 2) for r in rows))


def check_ssd_backward(dev, *, b: int = 4, s: int = 640,
                       dtype: str = "bfloat16", h: int = 48, p: int = 64,
                       n: int = 128, chunk: int = 256, reps: int = 10,
                       seed: int = 5) -> dict:
    """The SSD scan's backward kernel (``ssd_backward_cuda``) against
    ``ssd_backward_ref`` on float64 copies of the same inputs, at
    mamba2-780m's width: inputs made as ``check_ssd`` makes them (B and C
    the halves of one [B, S, 2N] projection, read in place), dy float32
    as ``ssd_cuda``'s y is. Launches rotate over copies of the inputs
    that exceed the L2 four times, as a layer's backward in a train step
    reads them from device memory."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import (SSD_BWD_TOL, SSD_BWD_TOL_BF16,
                                         ssd_backward_cuda, ssd_backward_ref)
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, h, p, device=dev, generator=g).to(dt_)
    dt = F.softplus(torch.randn(b, s, h, device=dev, generator=g))
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    bc = torch.randn(b, s, 2 * n, device=dev, generator=g).to(dt_)
    dy = torch.randn(b, s, h, p, device=dev, generator=g)
    out = ssd_backward_cuda(x, dt, a, bc[..., :n], bc[..., n:], dy,
                            chunk=chunk)
    torch.cuda.synchronize()
    bcd = bc.double()
    truth = ssd_backward_ref(x.double(), dt.double(), a.double(),
                             bcd[..., :n], bcd[..., n:], dy.double(),
                             chunk=chunk)
    bcf = bc.float()

    def plain():
        return ssd_backward_ref(x.float(), dt, a, bcf[..., :n],
                                bcf[..., n:], dy, chunk=chunk)
    plain_out = plain()
    errs, abs_errs, plain_errs, scales, ok = {}, {}, {}, {}, True
    for name, got, want, pl in zip(SSD_BWD_OUTPUTS, out, truth, plain_out):
        scales[name] = float(want.abs().max())
        abs_errs[name] = float((got.double() - want).abs().max())
        errs[name] = abs_errs[name] / scales[name]
        plain_errs[name] = float((pl.double() - want).abs().max()) / \
            scales[name]
        tol = SSD_BWD_TOL_BF16 if got.dtype == torch.bfloat16 \
            else SSD_BWD_TOL
        ok &= bool(torch.isfinite(got).all()) and errs[name] <= tol
    del truth, plain_out, bcd
    if not ok:
        raise AssertionError(
            f"ssd_backward B={b} S={s} {dtype}: kernel disagrees with "
            f"float64 (share of each output's largest |value|: {errs}; "
            f"tolerance {SSD_BWD_TOL}, {SSD_BWD_TOL_BF16} for bf16 "
            f"outputs)")
    again = ssd_backward_cuda(x, dt, a, bc[..., :n], bc[..., n:], dy,
                              chunk=chunk)
    repeats = all(torch.equal(u, v) for u, v in zip(out, again))
    if not repeats:
        raise AssertionError(f"ssd_backward B={b} S={s} {dtype}: two calls "
                             f"on the same inputs differ")
    in_bytes = x.nbytes + dt.nbytes + bc.nbytes + dy.nbytes
    copies = max(1, -(-int(4 * L2_BYTES) // in_bytes))
    inputs = [(x, dt, bc, dy)] + [tuple(t.clone() for t in (x, dt, bc, dy))
                                  for _ in range(copies - 1)]
    it = itertools.cycle(inputs)

    def launch():
        xx, dd, bb, yy = next(it)
        return ssd_backward_cuda(xx, dd, a, bb[..., :n], bb[..., n:], yy,
                                 chunk=chunk)
    ms = cuda_ms(launch, reps)
    kernel_ms, per_call, stages = device_kernels_of(
        launch, max(3, reps // 2), "ssdb_kernel")
    plain_ms = cuda_ms(plain, 2)
    ops = ssd_backward_ops(b, s, h, p, n, chunk)
    nbytes = in_bytes + a.nbytes + sum(t.nbytes for t in out)
    del inputs, it, out, again
    torch.cuda.empty_cache()
    return {"shape": f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} {dtype}",
            "max_abs_err": max(abs_errs.values()), "abs_err": abs_errs,
            "err_share": errs,
            "plain_f32_err_share": plain_errs, "scale": scales,
            "tolerance": SSD_BWD_TOL, "tolerance_bf16": SSD_BWD_TOL_BF16,
            "repeats_bit_for_bit": repeats,
            "ms": ms, "kernel_device_ms": kernel_ms,
            "cuda_kernels_per_call": per_call, "stage_device_ms": stages,
            "plain_ms": plain_ms, "library_ms": None, "bytes": nbytes,
            "ops": ops, "input_copies": copies,
            "fp32_fma_bound_ms": bound(nbytes, ops, FP32_FLOPS)["bound_ms"],
            **bound(nbytes, ops, ssd_flops(dtype))}


def fmt_share(shares: dict) -> str:
    return ", ".join(f"{k} {v:.2e}" for k, v in shares.items())


def fmt_ms(by_name: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1]))


def kernels_vs_plain(dev, n: int) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"beam_search": [], "merge_topk": [], "topk_distance": [],
           "quant_distance": [], "decode_attention": [], "ssd": [],
           "ssd_backward": []}
    for kw in beam_rows(n):
        r = check_beam(dev, **kw)
        res["beam_search"].append(r)
        log(f"beam_search {r['dtype']} {r['metric']} {r['shape']}: ids "
            f"equal {r['ids_equal']:.5f} max err {r['max_abs_err']:.3g} "
            f"kernel {r['ms']:.3f} ms ({r['ms_per_expansion'] * 1e3:.2f} us "
            f"an expansion of the longest walk, "
            f"{r['longest_walk_expansions']}) plain {r['plain_ms']:.1f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    # the merges of a float32, an int8 (rerank factor 4) and a filtered
    # (inflation 8) batch: m = w * k_search over w = 16 shards
    for m, k in ((160, 10), (640, 40), (1280, 80)):
        r = check_merge(dev, 1024, m, k)
        res["merge_topk"].append(r)
        log(f"merge_topk m={m} k={k}: ids equal {r['ids_equal']:.5f} "
            f"kernel {r['ms']:.4f} ms (device {r['kernel_device_ms']:.4f} "
            f"ms) plain {r['plain_ms']:.3f} ms bound {r['bound_ms']:.5f} ms")
    # run K's two shapes, then the k-means assignments of phase 4's build
    # (the 20,000-row sample against 1,000 centres) and of phases 5 and 6's
    # datastores (400 sampled keys against 32 centres at qwen3-1.7b's and
    # mamba2-780m's widths, DATASTORE_PYR), then the LSH baseline's rerank
    # (one query against its largest candidate list, k = 10)
    for b, centres, d, k, metric in ((4096, 1000, 128, 1, "l2"),
                                     (4096, 1000, 128, 16, "ip"),
                                     (20_000, 1000, 128, 1, "l2"),
                                     (400, 32, 2048, 1, "l2"),
                                     (400, 32, 1536, 1, "l2"),
                                     (1, 2048, 128, 10, "l2")):
        r = check_topk(dev, b, centres, d, k, metric)
        res["topk_distance"].append(r)
        log(f"topk_distance {r['shape']} {metric}: ids equal "
            f"{r['ids_equal']:.5f} kernel {r['ms']:.4f} ms (device "
            f"{r['kernel_device_ms']:.4f} ms: {fmt_ms(r['stage_device_ms'])})"
            f" plain {r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
            f"bound {r['bound_ms']:.5f} ms")
    # the int8 scan: a brute-force scan of phase 4's whole quantized index,
    # the reference's roofline shape (benchmarks/roofline.py:208), and a
    # ragged shape
    for b, rows, d in ((N_QUERIES, n, 128), (256, 16_384, 128),
                       (37, 53, 8)):
        for metric in ("l2", "ip", "angular"):
            r = check_quant(dev, b, rows, d, metric,
                            phase4=(b, rows) == (N_QUERIES, n))
            res["quant_distance"].append(r)
            log(f"quant_distance {r['shape']} {metric}: max err "
                f"{r['max_abs_err']:.3g} (|score| <= {r['score_scale']:.3g};"
                f" {r['outside_rtol_atol_1e-5']} outside rtol=atol=1e-5) "
                f"kernel {r['ms']:.4f} ms (device "
                f"{r['kernel_device_ms']:.4f} ms) plain {r['plain_ms']:.4f} "
                f"ms matmul yardstick {r['matmul_yardstick_ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; float32 "
                f"FMA bound {r['fp32_fma_bound_ms']:.4f} ms)")
    # a full-width qwen3-1.7b decode step's attention (8 slots, a 1,024-row
    # cache; bf16 as served, f32 as checked), then a long cache, then
    # phase 5's served positions; then phase 12's layers: gemma3-12b's
    # local decode (a 1,024-slot ring, hd = 240, past the ring) and global
    # decode (2,048 rows at 12b's served positions), h2o-danube-1.8b's
    # (a 4,096-slot ring, hd = 80) and chatglm3-6b's (16 query heads a kv
    # head), a full-size cache with a window, and float32 at hd = 80 and
    # 240
    for kw in (dict(), dict(dtype="float32"),
               dict(s=32_768, pos="full"), dict(pos="served"),
               dict(hd=240, ring=True),
               dict(s=2048, hd=240, pos="served-gemma3"),
               dict(s=4096, h=32, hd=80, ring=True),
               dict(s=2048, h=32, kvh=2),
               dict(s=2048, hd=240, window=1024, pos="full"),
               dict(s=4096, h=32, hd=80, ring=True, dtype="float32"),
               dict(hd=240, ring=True, dtype="float32")):
        r = check_decode(dev, **kw)
        res["decode_attention"].append(r)
        log(f"decode_attention {r['shape']}: max err {r['max_abs_err']:.3g}"
            f" kernel {r['ms']:.4f} ms (device {r['kernel_device_ms']:.4f} "
            f"ms) plain {r['plain_ms']:.3f} ms library"
            f" {r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    # mamba2-780m's SSD: a corpus row's prefill (three chunks, the last
    # ragged; bf16 as served, f32 as checked), then a batch of long prompts
    for kw in (dict(), dict(dtype="float32"),
               dict(b=4, s=4096, reps=10)):
        r = check_ssd(dev, **kw)
        res["ssd"].append(r)
        log(f"ssd {r['shape']}: max err {r['max_abs_err']:.3g} (|y| <= "
            f"{r['y_scale']:.3g}; state {r['max_abs_err_state']:.3g} of "
            f"{r['state_scale']:.3g}) kernel {r['ms']:.4f} ms (device "
            f"{r['kernel_device_ms']:.4f} ms in "
            f"{r['cuda_kernels_per_call']:g} CUDA kernels: "
            f"{fmt_ms(r['stage_device_ms'])}) plain "
            f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    # its backward: phase 11a's layer shape (the train step's call; bf16
    # as trained, f32 as phase 11c checks), then the forward's two rows
    for kw in (dict(), dict(dtype="float32"), dict(b=1, s=513),
               dict(b=4, s=4096, reps=5)):
        r = check_ssd_backward(dev, **kw)
        res["ssd_backward"].append(r)
        log(f"ssd_backward {r['shape']}: error shares "
            f"{fmt_share(r['err_share'])} (plain float32 "
            f"{fmt_share(r['plain_f32_err_share'])}) kernel {r['ms']:.4f} ms (device {r['kernel_device_ms']:.4f} ms "
            f"in {r['cuda_kernels_per_call']:g} CUDA kernels: "
            f"{fmt_ms(r['stage_device_ms'])}) plain {r['plain_ms']:.3f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}; float32 FMA "
            f"bound {r['fp32_fma_bound_ms']:.4f} ms)")
    return res


def check_answer(name: str, ids, scores, x, q, k: int, alive=None) -> None:
    """What ``search_single_host`` returns must be well formed: [B, k]
    ids and scores, (-1, -inf) padding and nothing else non-finite, no id
    twice in a row, scores descending and equal to the exact l2
    similarity of the returned rows, and (under a filter) only alive
    rows."""
    if ids.shape != (q.shape[0], k) or scores.shape != ids.shape:
        raise AssertionError(f"{name}: answer of shape {ids.shape}")
    real = ids >= 0
    if not np.array_equal(~real, np.isneginf(scores)) \
            or not np.isfinite(scores[real]).all():
        raise AssertionError(f"{name}: padding or non-finite scores")
    with np.errstate(invalid="ignore"):      # -inf - -inf in the padding
        unsorted = np.any(np.diff(scores, axis=1) > 0)
    if unsorted:
        raise AssertionError(f"{name}: scores not best-first")
    for row in ids:
        got = row[row >= 0]
        if np.unique(got).size != got.size:
            raise AssertionError(f"{name}: an id returned twice")
    if alive is not None and not alive[ids[real]].all():
        raise AssertionError(f"{name}: a filtered-out row was returned")
    qq = np.repeat(q.astype(np.float64), k, axis=0)[real.ravel()]
    xx = x[ids[real]].astype(np.float64)
    exact = -((qq - xx) ** 2).sum(axis=1)
    tol = 1e-3 + 1e-5 * ((qq * qq).sum(axis=1) + (xx * xx).sum(axis=1))
    if np.any(np.abs(scores[real] - exact) > tol):
        raise AssertionError(f"{name}: scores differ from the exact l2 "
                             f"similarity of the returned rows")


# ---------------------------------------------------------------------------
# phase 3: a small index on the card and on the CPU
# ---------------------------------------------------------------------------


def small_index_agreement() -> dict:
    from repro_torch import convert
    from repro_torch.common.config import PyramidConfig
    from repro_torch.core.distributed import search_single_host
    from repro_torch.core.meta_index import build_pyramid_index
    from repro_torch.data.synthetic import clustered_vectors, query_set
    x = clustered_vectors(3000, 32, 24, seed=3)
    q = query_set(x, 128, seed=4)
    cfg = PyramidConfig(num_shards=4, meta_size=64, sample_size=2000,
                        max_degree=12, max_degree_upper=6,
                        ef_construction=40, ef_search=40)
    cpu = build_pyramid_index(x, cfg, device="cpu")
    tags = np.full(x.shape[0], 2, np.int64)
    tags[np.random.default_rng(5).random(x.shape[0]) < 0.05] |= 1
    for g in cpu.subs:       # filter bit 1: ~5% of the rows alive
        g.tags = tags[g.ids]
    cpu.invalidate_device_cache()
    fields = ("data", "ids", "neighbors", "levels", "entry", "metric",
              "tags")
    arrays = lambda g: {f: getattr(g, f) for f in fields}   # noqa: E731
    card = convert.index_from_arrays(
        cfg.__dict__, arrays(cpu.meta), cpu.part_of_center,
        [arrays(g) for g in cpu.subs], device="cuda")
    out = {}
    runs = {"float32": dict(), "int8": dict(quantize=True, rerank_factor=4),
            "filtered": dict(filter_tags=1)}
    for name, kw in runs.items():
        ids_c, s_c, _ = search_single_host(cpu, q, 10, **kw)
        ids_g, s_g, _ = search_single_host(card, q, 10, **kw)
        check_answer(f"small index {name} on the card", ids_g, s_g, x, q, 10,
                     alive=(tags & 1) != 0 if name == "filtered" else None)
        share = float(np.mean(ids_c == ids_g))
        if share < 0.99:
            raise AssertionError(f"small index {name}: card and CPU agree "
                                 f"on only {share:.4f} of ids")
        out[name] = share
    log(f"small index, card vs CPU plain path: ids equal {out}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def recall_at(ids: np.ndarray, truth: np.ndarray) -> float:
    k = truth.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(ids.tolist(), truth.tolist())]))


def gpu_truth(x, q, k, alive=None):
    import torch
    xt = torch.as_tensor(x, device="cuda")
    qt = torch.as_tensor(q, device="cuda")
    sims = 2.0 * qt @ xt.T - (xt * xt).sum(dim=1)[None, :]
    if alive is not None:
        sims[:, ~torch.as_tensor(alive, device="cuda")] = -torch.inf
    return torch.topk(sims, k, dim=1).indices.cpu().numpy()


# the beam walk's and flash-decode's CUDA kernels, as the profiler names
# them, by the launch counter of their wrappers
BEAM_KERNEL_NAME = "beam_walk_kernel"
PROFILED_KERNELS = {"beam_search": BEAM_KERNEL_NAME,
                    "decode_attention": "flash_decode_kernel"}


def device_breakdown(fn, batch_s: float) -> dict:
    """Device time of one call under ``torch.profiler``: total kernel time,
    its share of the call's unprofiled wall time (the rest is the card
    idling on the host), the kernels that take the most, and the launches
    and device time of each of PROFILED_KERNELS (``<name>_launches``,
    ``<name>_device_ms``, ``<name>_device_ms_per_launch``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    after = launch_counts()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    per_kernel = sorted(((e.key, e.self_device_time_total) for e in events),
                        key=lambda kv: -kv[1])
    device_us = sum(t for _, t in per_kernel)
    if device_us == 0:
        log("profiler saw no device time")
    out = {"device_ms": device_us / 1e3,
           "kernels_launched": sum(e.count for e in events),
           "busy_share": device_us / 1e6 / batch_s}
    for kernel, name in PROFILED_KERNELS.items():
        launches = after[kernel] - before[kernel]
        ms = sum(t for key, t in per_kernel if name in key) / 1e3
        out.update({f"{kernel}_launches": launches,
                    f"{kernel}_device_ms": ms,
                    f"{kernel}_device_ms_per_launch":
                        ms / launches if launches else None})
    out["top_kernels_ms"] = {k[:80]: t / 1e3 for k, t in per_kernel[:8]}
    return out


def counting_shard_walks(fn):
    """Runs fn with the arena's shard-walk ``beam_search`` call wrapped:
    returns fn's result and, summed over its calls, the slots handed to
    the walk and those of them with an entry >= 0 (the walked ones)."""
    import repro_torch.core.arena as arena
    inner = arena.beam_search
    seen = {"slots": 0, "walked": 0}

    def counted(*args, **kw):
        entries = args[3]
        seen["slots"] += entries.numel()
        seen["walked"] += int((entries >= 0).sum())
        return inner(*args, **kw)
    arena.beam_search = counted
    try:
        return fn(), seen
    finally:
        arena.beam_search = inner


def main_path(n: int, n_queries: int, workers: int) -> dict:
    import torch
    from repro_torch.build import build_pyramid_index_parallel
    from repro_torch.common.config import PyramidConfig
    from repro_torch.core.distributed import search_single_host
    from repro_torch.core.router import access_rate
    from repro_torch.data.synthetic import clustered_vectors, query_set
    from repro_torch.kernels import launch_counts, reset_launch_counts

    x = clustered_vectors(n, 128, 1000, seed=0)
    q = query_set(x, n_queries, seed=1)
    cfg = PyramidConfig()        # paper defaults: w=16 m=1000 K=4 M=32 ...
    k = 10
    rng = np.random.default_rng(5)
    tags = np.full(n, 2, np.int64)
    tags[rng.random(n) < 0.05] |= 1          # filter bit 1: ~5% alive
    torch.cuda.reset_peak_memory_stats()
    res = {"n": n, "d": 128, "queries": n_queries, "config": cfg.__dict__}

    reset_launch_counts()
    t0 = time.perf_counter()
    index = build_pyramid_index_parallel(x, cfg, workers=workers)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    res["build_stats"] = {key: index.build_stats[key] for key in (
        "plan_timings", "subgraphs_wall_s", "sub_sizes", "balance",
        "build_mode", "build_workers")}
    res["launches_build"] = launch_counts()
    log(f"build: {res['build_s']:.1f} s {res['build_stats']} launches "
        f"{res['launches_build']}")
    for g in index.subs:
        g.tags = tags[g.ids]
    index.invalidate_device_cache()

    truth = gpu_truth(x, q, k)
    truth_f = gpu_truth(x, q, k, alive=(tags & 1) != 0)
    runs = {"float32": dict(), "int8": dict(quantize=True, rerank_factor=4),
            "filtered": dict(filter_tags=1)}
    answers = {}
    for name, kw in runs.items():
        before = launch_counts()
        t0 = time.perf_counter()
        (ids, scores, mask), slots = counting_shard_walks(
            lambda: search_single_host(index, q, k, **kw))
        first_s = time.perf_counter() - t0
        slots["routed"] = int(mask.sum())
        check_answer(name, ids, scores, x, q, k,
                     alive=(tags & 1) != 0 if name == "filtered" else None)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            ids2, _, _ = search_single_host(index, q, k, **kw)
        dt = (time.perf_counter() - t0) / reps
        if not np.array_equal(ids, ids2):
            raise AssertionError(f"{name}: repeated search differs")
        answers[name] = (ids, scores)
        after = launch_counts()
        rec = recall_at(ids, truth_f if name == "filtered" else truth)
        res[name] = {"recall@10": rec, "qps": n_queries / dt,
                     "batch_s": dt, "first_call_s": first_s,
                     "access_rate": access_rate(torch.as_tensor(mask)),
                     "walk_slots": slots,
                     "launches_per_batch": {
                         key: (after[key] - before[key]) // (reps + 1)
                         for key in after}}
        res[name]["device"] = device_breakdown(
            lambda: search_single_host(index, q, k, **kw), dt)
        log(f"search {name}: recall@10 {rec:.4f} QPS "
            f"{res[name]['qps']:.1f} ({dt * 1e3:.1f} ms / batch of "
            f"{n_queries}) access rate {res[name]['access_rate']:.4f} "
            f"shard walks: {slots['walked']} of {slots['slots']} slots "
            f"walked, {slots['routed']} routed; launches per batch "
            f"{res[name]['launches_per_batch']} device "
            f"{res[name]['device']}")
    res["int8_scan"] = int8_scan(index, q, k, truth)
    res["lsh"] = lsh_baseline(x, q, k, truth, res["float32"]["qps"])
    res["launches"] = launch_counts()
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"main path launches {res['launches']} peak device memory "
        f"{res['peak_device_bytes'] / 2 ** 30:.2f} GiB")
    if any(res["launches"][name] <= 0 for name in PYRAMID_KERNELS
           + ("quant_distance",)):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{res['launches']}")
    if res["float32"]["recall@10"] < 0.90:
        raise AssertionError("float32 recall@10 below 0.90")
    if res["int8"]["recall@10"] < res["float32"]["recall@10"] - 0.01:
        raise AssertionError("int8 recall@10 more than 0.01 below float32")
    state = {"index": index, "x": x, "queries": q, "truth": truth,
             "answers": answers}
    return res, state


def int8_scan(index, q, k: int, truth) -> dict:
    """Brute force over the whole int8 arena through ``quant_scores``, the
    int8 distance kernel's entry point: every stored code row (pad rows
    masked) against every query, then the top k. Its recall@10 against
    the float32 truth is recorded, and its top k on the first 64 queries
    is held against the exact function the kernel approximates: float64
    l2 scores (``2 x.q - |q|^2 - |x|^2``) of the code rows dequantized as
    the plain version dequantizes them (``c * scale + zero`` rounded to
    float32, the rows every implementation scores), so that only the sums
    are exact. A position counts as equal when it holds the float64
    ranking's row, or a row with exactly the float64 score there (an
    exact tie: the arena stores one row twice). The share equal to the
    plain float32 version is recorded beside it, with that version's own
    exact-tie rule, its positional share, the ties and the misses: a
    float32 sum misorders rows whose scores part by less than its
    rounding."""
    import torch
    from repro_torch.kernels.quant_distance import (quant_scores,
                                                    quant_scores_ref)
    from repro_torch.kernels.quant_distance.ref import dequantize
    arena = index.arena("int8")
    d = arena.data.shape[-1]
    codes = arena.data.reshape(-1, d)
    ids = arena.ids.reshape(-1).long()
    scale, zero = arena.scale[0], arena.zero[0]
    qt = torch.as_tensor(q).to(codes.device)

    def masked(scores):
        return scores.masked_fill(ids[None, :] < 0, -torch.inf)

    def top(scores):
        s, pos = torch.topk(masked(scores), k, dim=1)
        return ids[pos], s, pos
    (top_ids, top_s, top_pos), dt = synced(lambda: top(quant_scores(
        qt, codes, scale, zero, metric="l2")))
    _, scan_s = synced(lambda: quant_scores(qt, codes, scale, zero,
                                            metric="l2"))
    # the exact reference: float64 sums over the float32 rows
    x64 = dequantize(codes, scale, zero).double()
    q64 = qt[:64].double()
    exact = masked(2.0 * q64 @ x64.T - (q64 * q64).sum(dim=1)[:, None]
                   - (x64 * x64).sum(dim=1)[None, :])
    ex_ids, ex_s, _ = top(exact)
    same64 = top_ids[:64] == ex_ids
    tied64 = exact.gather(1, top_pos[:64]) == ex_s
    share = float((same64 | tied64).float().mean())
    # the plain float32 version, recorded beside
    ref_scores = masked(quant_scores_ref(qt[:64], codes, scale, zero,
                                         metric="l2"))
    ref_ids, ref_s, _ = top(ref_scores)
    same = top_ids[:64] == ref_ids
    tied = ref_scores.gather(1, top_pos[:64]) == ref_s
    kernel_scores = quant_scores(qt[:64], codes, scale, zero, metric="l2")

    def pair(qi, j, other_ids):
        rows = [int(top_pos[qi, j]),
                int((ids == other_ids[qi, j]).nonzero()[0, 0])]
        return {"query": qi, "rank": j, "ids": [int(ids[r]) for r in rows],
                "plain": [float(ref_scores[qi, r]) for r in rows],
                "kernel": [float(kernel_scores[qi, r]) for r in rows],
                "float64": [float(exact[qi, r]) for r in rows]}
    ties = [pair(qi, j, ref_ids)
            for qi, j in (tied & ~same).nonzero().tolist()]
    misses = [pair(qi, j, ref_ids)
              for qi, j in (~(same | tied)).nonzero().tolist()]
    misses64 = [pair(qi, j, ex_ids)
                for qi, j in (~(same64 | tied64)).nonzero().tolist()]
    for name, rows in (("tie in the plain scores", ties),
                       ("miss against the plain version", misses),
                       ("miss against float64", misses64)):
        for p in rows:
            log(f"int8 scan: {name}: query {p['query']} rank {p['rank']}: "
                f"the kernel's row {p['ids'][0]}, the other's "
                f"{p['ids'][1]}; plain {p['plain']}, kernel {p['kernel']}, "
                f"float64 {p['float64']}")
    ids_np = top_ids.cpu().numpy()
    rec = recall_at(ids_np, truth)
    out = {"rows": int(codes.shape[0]), "stored_rows": int((ids >= 0).sum()),
           "seconds": dt, "scan_seconds": scan_s, "recall@10": rec,
           "ids_equal_float64_64": share,
           "ids_equal_float64_64_by_position": float(same64.float().mean()),
           "ids_equal_plain_64": float((same | tied).float().mean()),
           "ids_equal_plain_64_by_position": float(same.float().mean()),
           "ties": ties, "misses_plain": misses, "misses_float64": misses64}
    log(f"int8 brute-force scan (quant_scores over {out['rows']} code rows):"
        f" recall@10 {rec:.4f}, {dt * 1e3:.1f} ms with top-k, the scan "
        f"alone {scan_s * 1e3:.2f} ms; top-10 on 64 queries equal to "
        f"float64's {share:.5f} (by position "
        f"{out['ids_equal_float64_64_by_position']:.5f}), to the plain "
        f"float32 version's {out['ids_equal_plain_64']:.5f} (by position "
        f"{out['ids_equal_plain_64_by_position']:.5f})")
    if ids_np.shape != truth.shape or not bool(torch.isfinite(top_s).all()) \
            or share < IDS_EQUAL_MIN:
        raise AssertionError(f"int8 brute-force scan malformed or off the "
                             f"float64 scores: {out}")
    return out


# the LSH baseline as the paper's Fig. 9 comparison runs it
# (benchmarks/fig9_comparison.py:50-51; num_shards is the Pyramid path's w)
LSH_PARAMS = dict(metric="l2", num_shards=16, num_tables=8, num_bits=10,
                  width=3.0)
LSH_CHECK_QUERIES = 64


def lsh_baseline(x, q, k: int, truth, pyramid_qps: float) -> dict:
    """The third system of the paper's Fig. 9 on phase 4's rows:
    ``build_lsh`` (host hashing), then ``search_lsh`` over every query,
    whose exact rerank is the top-k scan kernel on the card (one launch a
    query over its candidates). Its answers must be well formed with the
    exact scores of the rows returned, and its ids equal to the CPU
    ``search_lsh`` (plain versions) on the first 64 queries; recall@10
    against the float32 truth and QPS beside Pyramid's are recorded."""
    import torch
    from repro_torch.core.lsh import build_lsh, search_lsh
    from repro_torch.kernels import launch_counts
    t0 = time.perf_counter()
    lsh = build_lsh(x, **LSH_PARAMS)
    build_s = time.perf_counter() - t0
    search_lsh(lsh, q[:4], k)                    # warm
    before = launch_counts()["topk_distance"]
    (ids, scores), dt = synced(lambda: search_lsh(lsh, q, k))
    launches = launch_counts()["topk_distance"] - before
    check_answer("lsh", ids, scores, x, q, k)
    m = LSH_CHECK_QUERIES
    ids_c, scores_c = search_lsh(lsh, q[:m], k, device="cpu")
    agree = compare("lsh on the card against the CPU",
                    torch.as_tensor(ids[:m]), torch.as_tensor(ids_c),
                    torch.as_tensor(scores[:m]), torch.as_tensor(scores_c))
    out = {"params": LSH_PARAMS, "build_s": build_s, "search_s": dt,
           "qps": len(q) / dt, "pyramid_float32_qps": pyramid_qps,
           "recall@10": recall_at(ids, truth),
           "topk_distance_launches": launches,
           "ids_equal_cpu_64": agree["ids_equal"],
           "max_abs_err_cpu_64": agree["max_abs_err"],
           "padded_slots": int((ids < 0).sum())}
    log(f"LSH baseline ({LSH_PARAMS}): built in {build_s:.1f} s; "
        f"{len(q)} queries in {dt:.2f} s, QPS {out['qps']:.1f} (Pyramid "
        f"float32 {pyramid_qps:.1f}), recall@10 {out['recall@10']:.4f}, "
        f"top-k launches {launches}, ids equal to the CPU's on {m} queries "
        f"{agree['ids_equal']:.4f}, padded slots {out['padded_slots']}")
    answered = int((ids[:, 0] >= 0).sum())   # a query with candidates
    if launches != answered:
        raise AssertionError(f"lsh: {launches} top-k launches for "
                             f"{answered} queries with candidates")
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: kNN-LM serving of qwen3-1.7b and of mamba2-780m at full
# width
# ---------------------------------------------------------------------------

# the reference launcher's datastore index (src/repro/launch/serve.py:106),
# unchanged for 4,096 keys at d = 2048, 2,048 keys at d = 1536 and 1,400
# keys at d = 3,840
DATASTORE_PYR = dict(metric="l2", num_shards=4, meta_size=32,
                     sample_size=400, branching_factor=2, max_degree=12,
                     max_degree_upper=6, ef_construction=40, ef_search=60)
# the kernels of the index build and Alg. 4 search (phase 4); the LM
# paths run these in their datastore and lookups
PYRAMID_KERNELS = ("beam_search", "merge_topk", "topk_distance")
# one served model per phase:
#   check: the float32 check, a batch of prompts then greedy decode steps;
#   cell: a seeded corpus of corpus_seqs x corpus_len tokens (its datastore is
#     built from batches of ds_batch rows), the prefill timed on the first
#     prompt or on a corpus prefix of prefill_len, `requests` requests whose
#     prompt lengths are drawn from prompt_lo..prompt_hi (every other one
#     a corpus prefix of at most prefix_max tokens), max_new new tokens
#     each, in `slots` slots of a max_seq-row cache;
#   kernels: the kernels the phase must launch, and those it must not;
#   step_kernel: launched once per layer in every decode step;
#   forward_kernel: launched once per layer in every full forward and in
#     no decode step;
#   gate: what the float32 check holds to LM_LOGITS_ATOL, "logits" (the
#     end-to-end logits and greedy tokens) or "layers" (every layer's
#     outputs, each layer fed the full forward's own inputs; the
#     end-to-end numbers are recorded). The random 48-layer Mamba2 stack
#     amplifies float32 rounding from layer to layer: the same SSD kernel
#     over the prompt and over the whole sequence, two orders of the same
#     sums, parts in the logits at one position by far more than
#     LM_LOGITS_ATOL (the check prints this floor as the prefill error).
#     Layer by layer nothing is amplified, and the prefill state's
#     hand-off to the recurrent decode is held at every layer.
LM_SPECS = {
    # a corpus of 8 rows (4,096 keys), a cut of scale that keeps time for
    # phase 12
    "qwen3-1.7b": dict(
        check=dict(batch=4, prompt_len=64, steps=32),
        cell=dict(corpus_seqs=8, corpus_len=513, ds_batch=8, requests=16,
                  prompt_lo=64, prompt_hi=256, prefix_max=512, slots=8,
                  max_seq=1024, max_new=64, knn_k=8, seed=11,
                  prefill_len=None),
        kernels=PYRAMID_KERNELS + ("decode_attention",), absent=("ssd",),
        step_kernel="decode_attention", forward_kernel=None, gate="logits"),
    # half of phase 5's corpus (2,048 keys), a cut of scale to keep time
    # for the script (phase 12); prompts of two and three chunks of 256
    "mamba2-780m": dict(
        check=dict(batch=4, prompt_len=300, steps=32),
        cell=dict(corpus_seqs=4, corpus_len=513, ds_batch=1, requests=16,
                  prompt_lo=64, prompt_hi=768, prefix_max=512, slots=8,
                  max_seq=1024, max_new=64, knn_k=8, seed=12,
                  prefill_len=512),
        kernels=PYRAMID_KERNELS + ("ssd",), absent=("decode_attention",),
        step_kernel=None, forward_kernel="ssd", gate="layers"),
    # phase 12: gemma3-12b's local-global stack, 40 layers on 1,024-slot
    # rings and 8 global ones. The float32 check runs 2 of its 5:1
    # periods (num_layers 12, the only cut of the phase: 48 float32
    # layers are 50 GB) over prompts of 1,100 tokens, past the window; the
    # cell serves all 48 layers in bf16 over one corpus row of 1,401
    # tokens (1,400 keys: its prefixes must reach the longest prompt),
    # prompts of 700 to 1,400 tokens in a 2,048-row cache, so that some
    # rings wrap in prefill, some in decode and some never (the seed is
    # one that draws all three)
    "gemma3-12b": dict(
        check=dict(batch=4, prompt_len=1100, steps=32, num_layers=12),
        cell=dict(corpus_seqs=1, corpus_len=1401, ds_batch=1, requests=16,
                  prompt_lo=700, prompt_hi=1400, prefix_max=1400, slots=8,
                  max_seq=2048, max_new=64, knn_k=8, seed=12,
                  prefill_len=None),
        kernels=PYRAMID_KERNELS + ("decode_attention",), absent=("ssd",),
        step_kernel="decode_attention", forward_kernel=None, gate="logits"),
    # phase 12c, float32 checks at the configs' widths and depth 2 (the
    # cut): h2o-danube-1.8b (hd = 80) over a prompt of 4,000 tokens and
    # 200 steps, so that its 4,096-slot rings wrap; chatglm3-6b (16 query
    # heads a kv head, 2-D rope) over 256 tokens and 32 steps
    "h2o-danube-1.8b": dict(
        check=dict(batch=1, prompt_len=4000, steps=200, num_layers=2),
        forward_kernel=None, gate="logits"),
    "chatglm3-6b": dict(
        check=dict(batch=1, prompt_len=256, steps=32, num_layers=2),
        forward_kernel=None, gate="logits"),
}
LM_LOGITS_ATOL = 1e-3
KNN_HIT_MIN = 0.9
# the streaming engine (StreamEngine) in phases 5 and 6 (5s, 6s): the
# phase's bf16 parameters, datastore and prompts, its cell's slots (two
# groups of slots / 2), max_seq and knn_k, lam 0.3, greedy, max_new
# STREAM_MAX_NEW[arch] (a cut from the cell's 64, for the script's time:
# 16 for qwen3 and mamba2, whose six runs share the 180 s budget with
# the float32 run and the examples; gemma3's one run keeps 32).
# Runs: "overlap" over
# the float32 arena with the engine's defaults; "clean", the reference
# test's engine settings (tests/test_stream.py::test_stream_decode_under_
# fault_storm), also overlapped; "serialized" (overlap=False); "int8"
# (quantize=True, rerank_factor=4; the share of tokens equal to the first
# run's recorded); "storm", clean's settings under the test's two events.
# An arch's first run is overlapped and the others are held to it:
# serialized tokens equal to the first run's, the storm's to clean's.
# qwen3 starts from "clean" and has no separate "overlap" run: engine
# settings change timing, never tokens (AF3 and AG4: clean's tokens equal
# to overlap's), and the run it saves keeps the part within its budget
STREAM_LAM = 0.3
STREAM_MAX_NEW = {"qwen3-1.7b": 16, "mamba2-780m": 16, "gemma3-12b": 32}
STREAM_RUNS = {"qwen3-1.7b": ("clean", "serialized", "int8", "storm"),
               "mamba2-780m": ("overlap", "serialized"),
               "gemma3-12b": ("overlap",)}
STREAM_STORM_ENGINE = dict(replicas=2, hedge=True, hedge_deadline_s=0.25,
                           auto_restart=False, executor_batch=4)
# the float32 check's engine-against-batcher run (qwen3-1.7b): prompts of
# 16 to 64 tokens, 16 new tokens each, in 4 slots
STREAM_F32 = dict(requests=6, prompt_lo=16, prompt_hi=64, max_new=16,
                  slots=4, max_seq=128, seed=8)
# the two streaming examples, run on the card in a subprocess each, and
# what their output must hold (tests/test_examples.py's markers)
STREAM_EXAMPLES = {"torch_continuous_batching.py": ("10 requests",),
                   "torch_retrieval_decode.py": ("streaming decode",
                                                 "sessions")}
# seconds the streaming runs (5s, 6s, the float32 run, and the script's
# wait for the examples, which run beside phase 6) may take together
STREAM_BUDGET_S = 180.0


def synced(fn):
    """(result, seconds) of ``fn()`` on the host clock, the device synced
    before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mamba_layer_check(params, cfg, seq, prompt_len: int) -> dict:
    """Each Mamba2 layer on its own, fed the full forward's input to that
    layer: the full sequence (the SSD kernel over all rows), the prompt
    alone (the kernel, giving the prefill state), then the recurrent
    decode of the remaining rows from that state, one row at a time.
    Returns the largest differences from the full sequence's outputs,
    over all layers, of the prompt's rows and of the decoded rows."""
    import torch
    from repro_torch.models.transformer import _mamba_layer_fwd
    blocks = params["blocks"]["mamba2"]
    x = params["embedding"][seq]
    err_prefill = err_decode = scale = 0.0
    for layer in range(cfg.num_layers):
        p = {k: w[layer] for k, w in blocks.items()}
        full, _ = _mamba_layer_fwd(p, cfg, x)
        pre, st = _mamba_layer_fwd(p, cfg, x[:, :prompt_len])
        st = {k: v.clone() for k, v in st.items()}
        dec = []
        for t in range(prompt_len, seq.shape[1]):
            out, st = _mamba_layer_fwd(p, cfg, x[:, t:t + 1], st,
                                       decode=True)
            dec.append(out)
        err_prefill = max(err_prefill, float(
            (pre - full[:, :prompt_len]).abs().max()))
        err_decode = max(err_decode, float(
            (torch.cat(dec, dim=1) - full[:, prompt_len:]).abs().max()))
        scale = max(scale, float(full.abs().max()))
        x = full
    return {"layer_prefill_max_abs_err": err_prefill,
            "layer_decode_max_abs_err": err_decode,
            "layer_output_scale": scale}


def stream_serve(params, cfg, prompts, dev, *, max_new: int, slots: int,
                 max_seq: int, **kw) -> tuple:
    """The prompts through a ``StreamEngine`` (engine kwargs ``kw``):
    returns (tokens by request id, a record of the run). Each request
    must complete exactly once with ``max_new`` tokens."""
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.batcher import Request
    from repro_torch.serving.stream import StreamEngine
    gc.collect()            # an earlier engine's caches (a cycle through
    torch.cuda.empty_cache()  # its registry's gauges) go before the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    with StreamEngine(params, cfg, num_slots=slots, max_seq=max_seq,
                      device=dev, **kw) as eng:
        for i, p in enumerate(prompts):
            eng.submit(Request(i, np.asarray(p), max_new_tokens=max_new))
        prefill_s = time.perf_counter() - t0
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        st = eng.stats()
    seconds = time.perf_counter() - t0
    after = launch_counts()
    ids = sorted(c.request_id for c in done)
    if ids != list(range(len(prompts))) or any(
            len(c.tokens) != max_new for c in done):
        raise AssertionError(f"stream: completions {ids}, tokens "
                             f"{[len(c.tokens) for c in done]}")
    ret = st["retrieval"]
    rec = {"seconds": seconds, "prefill_s": prefill_s,
           "tokens_per_s": st["tokens_per_s"],
           "tokens": st["tokens_emitted"], "steps": st["steps"],
           "sessions": st["sessions"],
           "retrieval": {k: ret[k] for k in (
               "lookups", "hedges", "latency_p50_s", "latency_p99_s",
               "wait_p50_s", "wait_p99_s", "knn_hit_rate")},
           "launches": {k: after[k] - before[k] for k in after},
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    return {c.request_id: c.tokens for c in done}, rec


def stream_path(arch: str, params, cfg, ds, prompts, conts, dev,
                cell: dict) -> dict:
    """5s / 6s: the phase's prompts through ``StreamEngine`` over its
    datastore, in the runs of ``STREAM_RUNS[arch]``, each gated on
    completions, the kNN hit rate and its launches (flash-decode once a
    layer and dispatched step, the SSD once a layer and prefill, the beam
    kernel in the lookups)."""
    from repro_torch.serving.faults import FaultEvent, FaultSchedule
    base = dict(max_new=STREAM_MAX_NEW[arch], slots=cell["slots"],
                max_seq=cell["max_seq"], datastore=ds, knn_k=cell["knn_k"],
                lam=STREAM_LAM)
    kwargs = {"overlap": dict(overlap=True),
              "serialized": dict(overlap=False),
              "int8": dict(overlap=True, quantize=True, rerank_factor=4),
              "clean": dict(overlap=True, **STREAM_STORM_ENGINE)}
    attn = "decode_attention"
    first = STREAM_RUNS[arch][0]
    res, tokens = {}, {}
    t_path = time.perf_counter()
    for name in STREAM_RUNS[arch]:
        schedule = None
        kw = kwargs.get(name)
        if name == "storm":
            schedule = FaultSchedule([
                FaultEvent(step=2, action="kill", target="exec-s0-r0",
                           when_actor="exec-s0-r0"),
                FaultEvent(step=3, action="cpu_share", target="exec-s1-r1",
                           value=0.1)])
            kw = dict(kwargs["clean"], fault_schedule=schedule)
        tokens[name], rec = stream_serve(params, cfg, prompts, dev,
                                         **base, **kw)
        n = rec["launches"]
        rec["corpus_continuation_share"] = float(np.mean([
            np.mean(np.asarray(tokens[name][i]) == c)
            for i, c in conts.items()]))
        if name != first:
            rec["tokens_equal_first_share"] = float(np.mean([
                np.mean(np.asarray(tokens[name][i])
                        == np.asarray(tokens[first][i]))
                for i in tokens[name]]))
        log(f"{arch} stream {name}: {rec['tokens']} tokens in "
            f"{rec['seconds']:.2f} s (prefills {rec['prefill_s']:.2f} s; "
            f"{rec['tokens_per_s']:.1f} tokens/s after them), {rec['steps']}"
            f" steps, retrieval {rec['retrieval']}, peak "
            f"{rec['peak_device_bytes'] / 2 ** 30:.2f} GiB, launches {n}, "
            f"corpus continuation {rec['corpus_continuation_share']:.4f}, "
            f"equal to {first} {rec.get('tokens_equal_first_share')}")
        if rec["retrieval"]["knn_hit_rate"] < KNN_HIT_MIN:
            raise AssertionError(f"stream {name}: kNN hit rate "
                                 f"{rec['retrieval']['knn_hit_rate']}")
        want_attn = cfg.num_layers * rec["steps"] \
            if LM_SPECS[arch]["step_kernel"] == attn else 0
        want_ssd = cfg.num_layers * len(prompts) \
            if LM_SPECS[arch]["forward_kernel"] == "ssd" else 0
        if n[attn] != want_attn or n["ssd"] != want_ssd \
                or n["beam_search"] <= 0:
            raise AssertionError(f"stream {name}: launches {n}; expected "
                                 f"{attn} {want_attn}, ssd {want_ssd} and "
                                 f"the beam kernel")
        if name == "storm":
            rec["faults_fired"] = len(schedule.fired)
            if len(schedule.fired) != len(schedule.events):
                raise AssertionError(f"stream storm: {len(schedule.fired)} "
                                     f"of {len(schedule.events)} fired")
        res[name] = rec
    for name, same_as in (("serialized", first), ("storm", "clean")):
        if name in tokens and tokens[name] != tokens[same_as]:
            raise AssertionError(f"stream: {name} tokens differ from "
                                 f"{same_as}'s")
    res["seconds"] = time.perf_counter() - t_path
    log(f"{arch} stream runs: {res['seconds']:.2f} s")
    return res


def stream_float32_check(params, cfg, dev) -> dict:
    """``StreamEngine`` LM-only against ``ContinuousBatcher`` on float32
    weights: equal greedy tokens, request for request (the reference
    test's criterion, in float32 so that the two heads' GEMM shapes
    cannot part a bf16 near-tie)."""
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    c = STREAM_F32
    rng = np.random.default_rng(c["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in
               rng.integers(c["prompt_lo"], c["prompt_hi"] + 1,
                            c["requests"])]
    t0 = time.perf_counter()
    batcher = ContinuousBatcher(params, cfg, num_slots=c["slots"],
                                max_seq=c["max_seq"], device=dev)
    for i, p in enumerate(prompts):
        batcher.submit(Request(i, p, max_new_tokens=c["max_new"]))
    want = {d.request_id: d.tokens for d in batcher.run_until_drained()}
    got, rec = stream_serve(params, cfg, prompts, dev,
                            max_new=c["max_new"], slots=c["slots"],
                            max_seq=c["max_seq"])
    rec["tokens_equal_batcher"] = got == want
    rec["seconds"] = time.perf_counter() - t0
    log(f"{cfg.name} float32 stream check: tokens equal to "
        f"ContinuousBatcher's {rec['tokens_equal_batcher']} over "
        f"{len(prompts)} requests, {rec['seconds']:.2f} s, launches "
        f"{rec['launches']}")
    if not rec["tokens_equal_batcher"]:
        raise AssertionError(f"float32 stream check: {got} != {want}")
    return rec


def start_stream_examples() -> dict:
    """Start the two streaming examples on the card, a subprocess each
    (:func:`finish_stream_examples` collects them)."""
    return {name: (time.perf_counter(), subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
        for name in STREAM_EXAMPLES}


def finish_stream_examples(procs: dict) -> dict:
    """Wait for the examples: each must exit 0 and print the lines its
    twin's test asserts. ``seconds`` is the time the script waited."""
    t0 = time.perf_counter()
    res, failed = {}, []
    for name, (start, proc) in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        res[name] = {"rc": proc.returncode,
                     "seconds": time.perf_counter() - start,
                     "last_line": (out.strip().splitlines() or [""])[-1]}
        log(f"example {name}: rc {proc.returncode}, done within "
            f"{res[name]['seconds']:.2f} s: {res[name]['last_line']}")
        if proc.returncode != 0 or any(
                m not in out for m in STREAM_EXAMPLES[name]):
            failed.append(f"{name}: {out[-2000:]}{err[-4000:]}")
    res["seconds"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    return res


def lm_float32_check(dev, arch: str) -> dict:
    """Teacher-forced: prefill, then greedy decode through ``decode_step``
    from the prefill cache; each step's logits are compared with the full
    forward's at that position over the sequence decoded so far, and the
    greedy tokens with its argmax. With the spec's gate "logits" these
    must agree within LM_LOGITS_ATOL and be equal; with "layers"
    (mamba2) every layer's prompt and decoded outputs must agree with the
    full sequence's within LM_LOGITS_ATOL (:func:`mamba_layer_check`),
    and the end-to-end numbers are recorded beside the same-kernel
    rounding floor (the prefill's last logits against the full
    forward's). Float32 weights at the full width, so that both sides
    compute in the same precision."""
    import dataclasses

    import torch
    from repro_torch.common.registry import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.models.transformer import (forward, grow_cache,
                                                init_params)
    from repro_torch.serving.decode import decode_step, prefill_step
    spec = LM_SPECS[arch]
    batch, prompt_len, steps = (spec["check"][k] for k in
                                ("batch", "prompt_len", "steps"))
    full_cfg = get_arch(arch)
    cfg = dataclasses.replace(full_cfg, dtype="float32", num_layers=spec[
        "check"].get("num_layers", full_cfg.num_layers))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    before = launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt, cfg=cfg)
    cache = grow_cache(cache, prompt_len + steps, window=cfg.sliding_window)
    toks = [torch.argmax(logits[:, -1].float(), dim=-1)]
    step_logits = []
    for i in range(steps):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                         device=dev)
        nxt, lg, cache = decode_step(params, cache, toks[-1][:, None], pos,
                                     cfg=cfg)
        step_logits.append(lg)
        toks.append(nxt.long())
    seq = torch.cat([prompt, torch.stack(toks[:steps], dim=1)], dim=1)
    full, _, _ = forward(params, cfg, seq)
    full = full.float()
    got = torch.stack(step_logits, dim=1)
    want = full[:, prompt_len:]
    err = float((got - want).abs().max())
    prefill_err = float((logits[:, -1] - full[:, prompt_len - 1]).abs().max())
    greedy_equal = bool(torch.equal(want.argmax(-1),
                                    torch.stack(toks[1:], dim=1)))
    torch.cuda.synchronize()
    after = launch_counts()
    res = {"arch": arch, "batch": batch, "prompt_len": prompt_len,
           "steps": steps, "num_layers": cfg.num_layers,
           "cut": ({} if cfg.num_layers == full_cfg.num_layers else
                   {"num_layers": f"{full_cfg.num_layers} -> "
                                  f"{cfg.num_layers}"}),
           "cache_rows": {g: int(c["k"].shape[2]) for g, c in cache.items()
                          if "k" in c},
           "max_abs_err": err,
           "prefill_max_abs_err": prefill_err, "greedy_equal": greedy_equal,
           "logit_scale": float(want.abs().max()),
           "launches": {k: after[k] - before[k] for k in after},
           "seconds": time.perf_counter() - t0}
    log(f"{arch} float32 check ({cfg.num_layers} layers, caches "
        f"{res['cache_rows']}): decode vs forward max abs err {err:.3g} "
        f"(prefill {prefill_err:.3g}, |logits| <= {res['logit_scale']:.2f})"
        f", greedy tokens equal {greedy_equal}, launches {res['launches']}")
    if spec["gate"] == "layers":
        res["first_token_difference"] = next(
            (i for i in range(steps) if not torch.equal(
                want.argmax(-1)[:, i], toks[i + 1])), None)
        res.update(mamba_layer_check(params, cfg, seq, prompt_len))
        log(f"{arch} float32 check, layer by layer over {cfg.num_layers} "
            f"layers: prompt rows max abs err "
            f"{res['layer_prefill_max_abs_err']:.3g}, decoded rows "
            f"{res['layer_decode_max_abs_err']:.3g} (|outputs| <= "
            f"{res['layer_output_scale']:.3g})")
        ok = (res["layer_prefill_max_abs_err"] <= LM_LOGITS_ATOL
              and res["layer_decode_max_abs_err"] <= LM_LOGITS_ATOL)
    else:
        ok = (err <= LM_LOGITS_ATOL and prefill_err <= LM_LOGITS_ATOL
              and greedy_equal)
    del cache, full, logits
    if ok and arch == "qwen3-1.7b":
        res["stream"] = stream_float32_check(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{arch} float32 check failed: {res}")
    kern = spec["forward_kernel"]
    if kern and res["launches"][kern] != 2 * cfg.num_layers:
        raise AssertionError(f"{kern} launched {res['launches'][kern]} times"
                             f" in 2 full forwards and {steps} decode steps")
    return res


def lm_path(dev, arch: str) -> dict:
    """The LM main path of ``arch`` at full width in bf16 (its LM_SPECS
    cell): datastore build, continuous batching, and a kNN-LM step for
    prompts that are corpus prefixes. The launch counts are set to 0 at
    its start and read at its end."""
    import torch
    from repro_torch.common.config import PyramidConfig
    from repro_torch.common.registry import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batcher import ContinuousBatcher, Request
    from repro_torch.serving.decode import prefill_step
    from repro_torch.serving.retrieval import (build_datastore,
                                               hidden_states, interpolate,
                                               knn_probs,
                                               open_datastore_client)
    from repro_torch.common.config import AttentionKind
    spec = LM_SPECS[arch]
    cell = spec["cell"]
    cfg = get_arch(arch)
    corpus_seqs, corpus_len, n_requests, slots, max_seq, max_new, knn_k = (
        cell[k] for k in ("corpus_seqs", "corpus_len", "requests",
                          "slots", "max_seq", "max_new", "knn_k"))
    rng = np.random.default_rng(cell["seed"])
    corpus = rng.integers(0, cfg.vocab_size, (corpus_seqs, corpus_len))
    lengths = rng.integers(cell["prompt_lo"], cell["prompt_hi"] + 1,
                           n_requests)
    # even requests are prefixes of corpus rows, odd ones random tokens
    lengths = np.array([min(n, cell["prefix_max"]) if i % 2 == 0 else n
                        for i, n in enumerate(lengths)])
    prompts = [corpus[i // 2 % corpus_seqs, :n] if i % 2 == 0 else
               rng.integers(0, cfg.vocab_size, n)
               for i, n in enumerate(lengths)]
    res = {"arch": arch, "dtype": cfg.dtype, "cell": cell,
           "datastore_config": DATASTORE_PYR}
    forwards = 0        # full forwards (prefills) run on this path
    if cfg.attention_kind != AttentionKind.FULL:
        # a prompt of n tokens fills a ring of R slots in prefill when
        # n > R; else its decode (positions n..n + max_new - 2) wraps it
        # when it reaches R, or never does
        r = min(cfg.sliding_window, max_seq)
        res["ring_wraps"] = {
            "ring_slots": r,
            "in_prefill": int((lengths > r).sum()),
            "in_decode": int(((lengths <= r)
                              & (lengths + max_new - 2 >= r)).sum()),
            "never": int((lengths + max_new - 2 < r).sum())}
        log(f"{arch}: prompts wrap their {r}-slot rings "
            f"{res['ring_wraps']}")
        if not all(res["ring_wraps"][k] for k in ("in_prefill",
                                                  "in_decode", "never")):
            raise AssertionError(f"{arch}: the prompts do not cover every "
                                 f"ring case: {res['ring_wraps']}")

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    params, res["init_s"] = synced(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    leaves = [t for k, t in params.items() if k != "blocks"] + [
        t for group in params["blocks"].values() for t in group.values()]
    res["params"] = sum(t.numel() for t in leaves)
    res["param_bytes"] = sum(t.nbytes for t in leaves)
    log(f"{arch}: {res['params']:,} parameters ({cfg.dtype}, "
        f"{res['param_bytes'] / 1e9:.2f} GB) initialised in "
        f"{res['init_s']:.2f} s")

    batches = [corpus[i:i + cell["ds_batch"]]
               for i in range(0, corpus_seqs, cell["ds_batch"])]
    ds, res["datastore_build_s"] = synced(lambda: build_datastore(
        params, cfg, batches, PyramidConfig(**DATASTORE_PYR), device=dev))
    forwards += len(batches)
    res["datastore_entries"] = int(ds.values.shape[0])
    res["datastore_build_stats"] = {k: ds.index.build_stats.get(k) for k in (
        "plan_timings", "subgraphs_wall_s", "sub_sizes")}
    log(f"datastore: {res['datastore_entries']} entries (d={cfg.d_model}) "
        f"built in {res['datastore_build_s']:.1f} s from {len(batches)} "
        f"batches {res['datastore_build_stats']}")

    # prefill of the first prompt, or of a corpus prefix of prefill_len
    one = torch.as_tensor((prompts[0] if cell["prefill_len"] is None else
                           corpus[0, :cell["prefill_len"]])[None], device=dev)
    prefill_step(params, one, cfg=cfg)                       # warm-up
    reps = [synced(lambda: prefill_step(params, one, cfg=cfg))[1]
            for _ in range(3)]
    forwards += 4
    res["prefill_ms"] = 1e3 * float(np.mean(reps))
    res["prefill_tokens"] = int(one.shape[1])

    batcher = ContinuousBatcher(params, cfg, num_slots=slots,
                                max_seq=max_seq, device=dev)
    # a decode step reads every weight but the embedding table once, and
    # reads and rewrites the recurrent state (Mamba2's SSM and conv state)
    state_bytes = sum(t.nbytes for t in batcher.cache.get("mamba2",
                                                          {}).values())
    res["decode_step_bound_bytes"] = (res["param_bytes"]
                                      - params["embedding"].nbytes
                                      + 2 * state_bytes)
    res["decode_step_bound_ms"] = 1e3 * res["decode_step_bound_bytes"] \
        / HBM_BYTES_PER_S
    for i, p in enumerate(prompts):
        batcher.submit(Request(i, p, max_new_tokens=max_new))
    counts0 = launch_counts()
    fwd_in_decode = 0   # forward-kernel launches in steps that admit none
    decode_s, admit_s, steps, profiled = [], [], 0, None
    t_serve, profiled_s = time.perf_counter(), 0.0
    while batcher.pending or any(a is not None for a in batcher.active):
        admitting = bool(batcher.pending) and None in batcher.active
        before = launch_counts()
        if not admitting and profiled is None and len(decode_s) >= 8:
            # one decode step under the profiler, left out of the times
            profiled, profiled_s = synced(lambda: device_breakdown(
                batcher.step, float(np.median(decode_s))))
            steps += 1
        else:
            n, dt = synced(batcher.step)
            if n:
                steps += 1
                (admit_s if admitting else decode_s).append(dt)
        if not admitting and spec["forward_kernel"]:
            fwd_in_decode += (launch_counts()[spec["forward_kernel"]]
                              - before[spec["forward_kernel"]])
    serve_s = time.perf_counter() - t_serve - profiled_s
    forwards += n_requests
    counts1 = launch_counts()
    serving_launches = {k: counts1[k] - counts0[k] for k in counts1}
    tokens = sum(len(c.tokens) for c in batcher.done)
    res.update({
        "prompt_lengths": lengths.tolist(),
        "completed": len(batcher.done), "generated_tokens": tokens,
        "decode_steps": steps, "serve_s": serve_s,
        "tokens_per_s": tokens / serve_s,
        "decode_step_ms_median": 1e3 * float(np.median(decode_s)),
        "decode_step_ms_mean": 1e3 * float(np.mean(decode_s)),
        "admit_step_ms_mean": 1e3 * float(np.mean(admit_s)),
        "recurrent_state_bytes": state_bytes,
        "launches_serving": serving_launches,
        "launches_per_step": {k: v / max(steps, 1)
                              for k, v in serving_launches.items()},
        "forward_kernel_launches_in_decode_steps": fwd_in_decode,
        "decode_step_device": profiled})
    log(f"serving: {len(batcher.done)}/{n_requests} requests, {tokens} "
        f"tokens in {serve_s:.2f} s ({res['tokens_per_s']:.1f} tokens/s), "
        f"prefill {res['prefill_ms']:.2f} ms ({res['prefill_tokens']} "
        f"tokens), decode step {res['decode_step_ms_median']:.2f} ms "
        f"(median of {len(decode_s)}; bound "
        f"{res['decode_step_bound_ms']:.3f} ms), launches in serving "
        f"{serving_launches} over {steps} steps, decode step device "
        f"{profiled}")
    if len(batcher.done) != n_requests or any(
            len(c.tokens) != max_new for c in batcher.done):
        raise AssertionError("serving: a request did not complete")
    kern = spec["step_kernel"]
    if kern and serving_launches[kern] != cfg.num_layers * steps:
        raise AssertionError(f"{kern} launched {serving_launches[kern]} "
                             f"times in {steps} decode steps")
    if spec["forward_kernel"] and fwd_in_decode:
        raise AssertionError(f"{spec['forward_kernel']} launched "
                             f"{fwd_in_decode} times in decode steps")

    # 5s / 6s: the same prompts through the streaming engine; even
    # requests are corpus prefixes, whose continuation is recorded
    conts = {i: corpus[i // 2 % corpus_seqs, n:n + STREAM_MAX_NEW[arch]]
             for i, n in enumerate(lengths) if i % 2 == 0}
    peak = torch.cuda.max_memory_allocated()
    res["stream"] = stream_path(arch, params, cfg, ds, prompts, conts, dev,
                                cell)
    forwards += n_requests * len(STREAM_RUNS[arch])
    peak = max([peak] + [r["peak_device_bytes"] for r in
                         res["stream"].values() if isinstance(r, dict)])

    # kNN-LM step: the hidden state at a corpus prefix's last position is
    # a stored key, so the nearest neighbour's value is the next token
    prefix = [(i // 2 % corpus_seqs, int(n)) for i, n in enumerate(lengths)
              if i % 2 == 0]
    hidden = torch.cat([hidden_states(params, cfg, torch.as_tensor(
        corpus[j, :n][None], device=dev))[:, -1] for j, n in prefix])
    forwards += len(prefix)
    lm_logits = (hidden @ params["lm_head"]).float().cpu().numpy()
    queries = hidden.float().cpu().numpy()
    gold = np.array([corpus[j, n] for j, n in prefix])
    knn_p, lookup_s = synced(lambda: knn_probs(
        ds, queries, k=knn_k, vocab_size=cfg.vocab_size))
    lookups = [synced(lambda: knn_probs(
        ds, queries, k=knn_k, vocab_size=cfg.vocab_size))[1]
        for _ in range(3)]
    # the same step through the serving engine, as the reference launcher
    # looks up (src/repro/launch/serve.py:95-140)
    with open_datastore_client(ds) as client:
        knn_c, lookup_c = synced(lambda: knn_probs(
            ds, queries, k=knn_k, vocab_size=cfg.vocab_size, client=client))
        lookups_c = [synced(lambda: knn_probs(
            ds, queries, k=knn_k, vocab_size=cfg.vocab_size,
            client=client))[1] for _ in range(3)]
        executors = len(client.stats()["executors"])
    hit_client = float(np.mean(knn_c.argmax(-1) == gold))
    mixed = interpolate(lm_logits, knn_p, lam=0.3)
    hit = float(np.mean(knn_p.argmax(-1) == gold))
    res.update({"knn_queries": len(prefix), "knn_k": knn_k,
                "knn_hit_rate": hit,
                "interpolated_hit_rate": float(np.mean(
                    mixed.argmax(-1) == gold)),
                "lm_hit_rate": float(np.mean(lm_logits.argmax(-1) == gold)),
                "lookup_ms_first": 1e3 * lookup_s,
                "lookup_ms": 1e3 * float(np.mean(lookups)),
                "knn_hit_rate_engine": hit_client,
                "engine_executors": executors,
                "lookup_ms_engine_first": 1e3 * lookup_c,
                "lookup_ms_engine": 1e3 * float(np.mean(lookups_c))})
    res["launches"] = launch_counts()
    res["full_forwards"] = forwards
    res["peak_device_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    log(f"kNN-LM: hit rate {hit:.4f} over {len(prefix)} corpus prefixes "
        f"(interpolated {res['interpolated_hit_rate']:.4f}, LM alone "
        f"{res['lm_hit_rate']:.4f}), lookup {res['lookup_ms']:.2f} ms for "
        f"{len(prefix)} queries; through the serving engine ({executors} "
        f"executors) hit rate {hit_client:.4f}, lookup "
        f"{res['lookup_ms_engine']:.2f} ms; launches {res['launches']} in "
        f"{forwards} full forwards and {steps} decode steps; peak device "
        f"memory "
        f"{res['peak_device_bytes'] / 2 ** 30:.2f} GiB")
    if mixed.shape != (len(prefix), cfg.vocab_size) or \
            not np.isfinite(mixed).all():
        raise AssertionError("kNN-LM: interpolated log-probs malformed")
    if min(hit, hit_client) < KNN_HIT_MIN:
        raise AssertionError(f"kNN-LM hit rate {hit:.4f} (through the "
                             f"engine {hit_client:.4f}) below {KNN_HIT_MIN}")
    if any(res["launches"][k] <= 0 for k in spec["kernels"]) or any(
            res["launches"][k] != 0 for k in spec["absent"]):
        raise AssertionError(f"{arch}: launches {res['launches']}; expected "
                             f"{spec['kernels']} to launch and "
                             f"{spec['absent']} not to")
    kern = spec["forward_kernel"]
    if kern and res["launches"][kern] != cfg.num_layers * forwards:
        raise AssertionError(f"{kern} launched {res['launches'][kern]} "
                             f"times in {forwards} full forwards of "
                             f"{cfg.num_layers} layers")
    del params, batcher, ds
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 12: sliding-window and local-global attention
# ---------------------------------------------------------------------------

PHASE12_LIMIT_S = 150.0


def counting_plain_decode():
    """Wrap flash-decode's plain version in its dispatch (the model's
    decode path) so that it counts its calls on CUDA tensors: (the
    counts, a function that restores it)."""
    from repro_torch.kernels.decode_attention import ops
    plain = ops.decode_attention_ref
    calls = {"cuda": 0, "cpu": 0}

    def counted(q, k, v, pos, window=0):
        calls[k.device.type] = calls.get(k.device.type, 0) + 1
        return plain(q, k, v, pos, window)

    ops.decode_attention_ref = counted

    def restore():
        ops.decode_attention_ref = plain
    return calls, restore


def sliding_path(dev) -> dict:
    """Phase 12: gemma3-12b's float32 check at depth 12 (12a), its kNN-LM
    serving at full width in bf16 (12b, :func:`lm_path`: a datastore of
    d = 3,840 keys, the batcher, one overlapped ``StreamEngine`` run, the
    kNN-LM step; flash-decode 48 times a decode step), and the float32
    checks of h2o-danube-1.8b and chatglm3-6b at depth 2 (12c). The
    plain version of flash-decode must never run on the card; the phase
    raises past PHASE12_LIMIT_S."""
    import torch
    t_phase = time.perf_counter()
    calls, restore = counting_plain_decode()
    res = {}
    try:
        res["float32_check"] = lm_float32_check(dev, "gemma3-12b")
        res["serving"] = lm_path(dev, "gemma3-12b")
        res["danube_float32_check"] = lm_float32_check(dev,
                                                       "h2o-danube-1.8b")
        res["chatglm3_float32_check"] = lm_float32_check(dev,
                                                         "chatglm3-6b")
    finally:
        restore()
    torch.cuda.empty_cache()
    res["plain_decode_calls"] = dict(calls)
    res["launches"] = res["serving"]["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: launches {res['launches']}; plain flash-decode calls "
        f"{res['plain_decode_calls']}; {res['phase_s']:.1f} s")
    if calls.get("cuda", 0):
        raise AssertionError(f"phase 12: flash-decode's plain version ran "
                             f"on the card {calls['cuda']} times")
    if res["phase_s"] > PHASE12_LIMIT_S:
        raise AssertionError(f"phase 12 took {res['phase_s']:.1f} s, over "
                             f"its {PHASE12_LIMIT_S:.0f} s")
    return res


# ---------------------------------------------------------------------------
# phase 7: Pyramid's serving engine on phase 4's index
# ---------------------------------------------------------------------------

ENGINE_REPLICAS = 2
STORM_SEED = 7
RECALL_SLACK = 0.02


def engine_run(eng, q, k: int, name: str) -> dict:
    """One batch of queries through ``PyramidClient.search_batch``: every
    future must resolve exactly once (one completion each, its own query,
    no id twice), and nothing stays pending. Returns the ids, the
    per-query latencies and the wall time."""
    from repro_torch.common.utils import nearest_rank
    from repro_torch.core.client import PyramidClient
    client = PyramidClient(eng, name=name)
    completions = {}

    def done(fut):
        completions[fut.query_id] = completions.get(fut.query_id, 0) + 1
    t0 = time.perf_counter()
    futs = client.search_batch(q, k)
    for f in futs:
        f.add_done_callback(done)
    results = [f.result(timeout=120.0) for f in futs]
    wall = time.perf_counter() - t0
    ids = np.full((len(q), k), -1, np.int64)
    for i, (f, r) in enumerate(zip(futs, results)):
        if r.query_id != f.query_id or len(set(r.ids.tolist())) != len(r.ids):
            raise AssertionError(f"{name}: query {f.query_id} resolved with "
                                 f"a foreign or duplicated result")
        ids[i, :len(r.ids)] = r.ids
    once = sorted(completions) == sorted(f.query_id for f in futs) and all(
        c == 1 for c in completions.values())
    if not once or eng.stats()["pending_queries"]:
        raise AssertionError(f"{name}: futures did not resolve exactly once")
    lat = sorted(r.latency_s for r in results)
    return {"ids": ids, "wall_s": wall, "qps": len(q) / wall,
            "query_p50_s": nearest_rank(lat, 50),
            "query_p99_s": nearest_rank(lat, 99),
            "hedges": sum(r.hedges for r in results)}


def engine_stats_summary(eng) -> dict:
    st = eng.stats()
    lat = st["latency"]
    return {"shard_e2e_p50_s_max": max(v["p50"] for v in lat.values()),
            "shard_e2e_p99_s_max": max(v["p99"] for v in lat.values()),
            "executors": len(st["executors"]),
            "restarts": st["restarts"], "redispatched": st["redispatched"],
            "hedged_queries": st["hedged_queries"],
            "expired_queries": st["expired_queries"],
            "access_rate": st["access_rate"],
            "arena_vector_bytes": st["arena_vector_bytes"],
            "recovery_events": len(st["recovery_timeline"]),
            "fault_step": st["fault_step"]}


def serving_path(state: dict, recall_single_host: float) -> dict:
    """Phase 7: ``ServingEngine`` over phase 4's index (no second build),
    float32, int8 with rerank factor 4, then a seeded fault storm under
    the Monitor. The launch counts are set to 0 at its start and read at
    its end."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultSchedule
    index, q, truth = state["index"], state["queries"], state["truth"]
    k = truth.shape[1]
    w = index.num_shards
    res = {"queries": len(q), "k": k, "shards": w,
           "replicas": ENGINE_REPLICAS}
    reset_launch_counts()
    t_phase = time.perf_counter()
    runs = {"float32": dict(), "int8": dict(quantize=True, rerank_factor=4)}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        eng = ServingEngine(index, replicas=ENGINE_REPLICAS, **kw)
        try:
            start_s = time.perf_counter() - t0
            first = engine_run(eng, q, k, name)
            again = engine_run(eng, q, k, name)
            if not np.array_equal(again["ids"], first["ids"]):
                raise AssertionError(f"engine {name}: a repeated batch "
                                     f"answered differently")
            out = {key: again[key] for key in ("wall_s", "qps",
                                                "query_p50_s",
                                                "query_p99_s")}
            out.update(first_batch_s=first["wall_s"], start_s=start_s,
                       recall=recall_at(first["ids"], truth),
                       **engine_stats_summary(eng))
            if name == "float32":
                res["fault_free_ids"] = first["ids"]
                out["device"] = device_breakdown(
                    lambda: engine_run(eng, q, k, name), out["wall_s"])
        finally:
            eng.shutdown()
        res[name] = out
        log(f"engine {name}: recall@10 {out['recall']:.4f} QPS "
            f"{out['qps']:.1f} ({out['wall_s'] * 1e3:.1f} ms / batch of "
            f"{len(q)}; first {out['first_batch_s'] * 1e3:.1f} ms) query "
            f"p50 {out['query_p50_s'] * 1e3:.2f} ms p99 "
            f"{out['query_p99_s'] * 1e3:.2f} ms, stats() shard p50 "
            f"{out['shard_e2e_p50_s_max'] * 1e3:.2f} ms p99 "
            f"{out['shard_e2e_p99_s_max'] * 1e3:.2f} ms, {out['executors']} "
            f"executors, restarts {out['restarts']} redispatched "
            f"{out['redispatched']} hedged {out['hedged_queries']}"
            + (f" device {out['device']}" if "device" in out else ""))

    storm = FaultSchedule.storm(STORM_SEED, num_shards=w,
                                replicas=ENGINE_REPLICAS)
    eng = ServingEngine(index, replicas=ENGINE_REPLICAS, auto_restart=True,
                        fault_schedule=storm,
                        monitor_opts={"backoff_base_s": 0.02,
                                      "period_s": 0.05})
    try:
        stormy = engine_run(eng, q, k, "storm")
        summary = engine_stats_summary(eng)
    finally:
        eng.shutdown()
    free = res.pop("fault_free_ids")
    state["engine_ids"] = free
    same = bool(np.array_equal(stormy["ids"], free))
    res["storm"] = {"seed": STORM_SEED,
                    "events": [dict(step=e.step, action=e.action,
                                    target=e.target, value=e.value)
                               for e in storm.events],
                    "fired": storm.fired, "done": storm.done(),
                    "ids_equal_fault_free": same,
                    "recall": recall_at(stormy["ids"], truth),
                    "wall_s": stormy["wall_s"], "qps": stormy["qps"],
                    "query_p99_s": stormy["query_p99_s"], **summary}
    res["launches"] = launch_counts()
    res["phase_s"] = time.perf_counter() - t_phase
    st = res["storm"]
    log(f"engine storm (seed {STORM_SEED}, {len(storm.fired)} of "
        f"{len(storm.events)} events fired): ids equal to the fault-free "
        f"run {same}, recall@10 {st['recall']:.4f}, {st['wall_s']:.2f} s, "
        f"restarts {st['restarts']} redispatched {st['redispatched']} "
        f"hedged {st['hedged_queries']}; launches {res['launches']}; phase "
        f"{res['phase_s']:.1f} s")
    if not same:
        raise AssertionError("engine storm: ids differ from the fault-free "
                             "run")
    if abs(res["float32"]["recall"] - recall_single_host) > RECALL_SLACK:
        raise AssertionError(
            f"engine float32 recall@10 {res['float32']['recall']:.4f} not "
            f"within {RECALL_SLACK} of search_single_host's "
            f"{recall_single_host:.4f}")
    if abs(st["recall"] - res["float32"]["recall"]) > RECALL_SLACK:
        raise AssertionError("engine storm recall off the fault-free run")
    if res["int8"]["recall"] < res["float32"]["recall"] - 0.01:
        raise AssertionError("engine int8 recall@10 more than 0.01 below "
                             "float32")
    if res["launches"]["beam_search"] <= 0:
        raise AssertionError(f"phase 7 never launched the beam kernel: "
                             f"{res['launches']}")
    return res


# ---------------------------------------------------------------------------
# phase 8: the index store, online updates, the paper's API and tenancy
# ---------------------------------------------------------------------------

# 8b's index: clustered_vectors(UPDATES_N, 128, UPDATES_CLUSTERS) with the
# paper's PyramidConfig() except the cuts below. Every insert and removal
# rebuilds the shards it touches with the host builder (about 35 ms a row
# at M = 32, ef_construction = 100), and 8b rebuilds them three times (the
# live apply and two from_store recoveries, float32 and int8; 8c's hot
# swap takes the float32 recovery's index), so N is cut until the phase
# fits its 120 s.
UPDATES_N = 1024
UPDATES_CLUSTERS = 32
UPDATES_CUTS = {
    "n": "4,096 -> 1,024: the rebuilds of the touched shards, three times "
         "over, at ~35 ms a row must fit the phase's 120 s",
    "meta_size": "1,000 -> 64: four k-means centres a shard; 1,000 "
                 "centres cannot be drawn from 1,024 rows",
    "sample_size": "20,000 -> 1,024: the whole set (N < 20,000)"}
UPDATES_ADD = 128          # rows drawn from two of the set's clusters
UPDATES_REMOVE = 32        # ids removed: half just added, half built
UPDATES_TAG = 4            # the tag bit written by set_item_tags
PHASE8_LIMIT_S = 120.0
# queries of 8c's Listing 1 run and of each tenant's search
API_QUERIES = 256


def checksums(index) -> list:
    from repro_torch.store import content_checksum, graph_to_arrays
    return [content_checksum(graph_to_arrays(g)) for g in index.subs]


def timed_rebuilds():
    """Wraps the host builder that ``repro_torch.core.updates`` rebuilds
    shards with: returns (a list that each rebuild appends ``[rows,
    seconds]`` to, the function that undoes the wrap)."""
    from repro_torch.core import hnsw
    inner = hnsw.build_hnsw
    seen = []

    def timed(data, *args, **kw):
        t0 = time.perf_counter()
        g = inner(data, *args, **kw)
        seen.append([int(len(data)), time.perf_counter() - t0])
        return g
    hnsw.build_hnsw = timed
    return seen, lambda: setattr(hnsw, "build_hnsw", inner)


def store_round_trip(state: dict, root: str):
    """8a: phase 4's index published and loaded back on the card; its
    searches, int8 grid and int8 codes must equal phase 4's. Returns the
    results and the loaded index."""
    import torch
    from repro_torch.core.distributed import search_single_host
    from repro_torch.store import IndexStore
    index, q = state["index"], state["queries"]
    k = state["truth"].shape[1]
    out = {}
    t0 = time.perf_counter()
    vid = IndexStore(root).publish(index)
    out["publish_s"] = time.perf_counter() - t0
    out["version_bytes"] = IndexStore(root).version_bytes(vid)
    t0 = time.perf_counter()
    loaded = IndexStore(root).load(device="cuda")
    out["load_s"] = time.perf_counter() - t0
    out["checksums_equal"] = checksums(loaded) == checksums(index)
    ids, scores, _ = search_single_host(loaded, q, k)
    ids4, scores4 = state["answers"]["float32"]
    out["float32_ids_equal"] = float((ids == ids4).all(axis=1).mean())
    out["float32_max_score_diff"] = float(np.abs(scores - scores4).max())
    ids8, _, _ = search_single_host(loaded, q, k, quantize=True,
                                    rerank_factor=4)
    out["int8_ids_equal"] = float(
        (ids8 == state["answers"]["int8"][0]).all(axis=1).mean())
    out["grid_equal"] = (loaded.quant_params().to_manifest()
                         == index.quant_params().to_manifest())
    out["int8_codes_equal"] = bool(torch.equal(
        loaded.arena("int8").data, index.arena("int8").data))
    log(f"8a store round trip: published {vid} ({out['version_bytes']} "
        f"bytes) in {out['publish_s']:.2f} s, loaded on the card in "
        f"{out['load_s']:.2f} s; checksums equal {out['checksums_equal']}, "
        f"float32 ids equal to phase 4's on {out['float32_ids_equal']:.4f} "
        f"of queries (max score diff {out['float32_max_score_diff']:.3g}), "
        f"int8 {out['int8_ids_equal']:.4f}, grid equal "
        f"{out['grid_equal']}, int8 codes equal {out['int8_codes_equal']}")
    if not (out["checksums_equal"] and out["float32_ids_equal"] == 1.0
            and out["float32_max_score_diff"] <= 1e-5
            and out["int8_ids_equal"] == 1.0 and out["grid_equal"]
            and out["int8_codes_equal"]):
        raise AssertionError(f"8a: the loaded index differs from phase "
                             f"4's: {out}")
    return out, loaded


def engine_recall(eng, q, truth, k: int):
    from repro_torch.core.client import gather_arrays
    ids, _ = gather_arrays(eng.submit(q, k=k), k, timeout=120.0)
    return ids, recall_at(ids, truth)


def online_updates(root: str):
    """8b: a small index built here, published, updated (an insert from
    two clusters, tags, a removal), checked live, then "crashed" and
    recovered three ways from its store. Returns the results and what
    8c reads: the recovered index, its queries, truth and ids, and the
    ``from_store`` engine's answers."""
    import torch
    from repro_torch.build import build_pyramid_index_parallel
    from repro_torch.common.config import PyramidConfig
    from repro_torch.core.distributed import search_single_host
    from repro_torch.core.updates import add_items, remove_items, set_item_tags
    from repro_torch.data.synthetic import clustered_vectors, query_set
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.store import IndexStore
    n, d, k = UPDATES_N, 128, 10
    x = clustered_vectors(n, d, UPDATES_CLUSTERS, seed=3)
    cfg = PyramidConfig(num_shards=16, meta_size=64, sample_size=n)
    out = {"n": n, "d": d, "clusters": UPDATES_CLUSTERS,
           "config": cfg.__dict__, "cuts": UPDATES_CUTS}
    t0 = time.perf_counter()
    index = build_pyramid_index_parallel(x, cfg, workers=os.cpu_count() or 1)
    out["build_s"] = time.perf_counter() - t0
    out["sub_sizes"] = [g.n for g in index.subs]
    t0 = time.perf_counter()
    IndexStore(root).publish(index)
    out["publish_s"] = time.perf_counter() - t0

    # rows near two of the set's clusters (their centres redrawn from the
    # set's seed, as clustered_vectors draws them)
    centres = np.random.default_rng(3).normal(size=(UPDATES_CLUSTERS, d))
    rng = np.random.default_rng(11)
    pick = rng.choice(UPDATES_CLUSTERS, size=2, replace=False)
    new = (centres[np.repeat(pick, UPDATES_ADD // 2)]
           + 0.15 * rng.normal(size=(UPDATES_ADD, d))).astype(np.float32)
    new_ids = np.arange(n, n + UPDATES_ADD)
    rebuilds, unwrap = timed_rebuilds()
    try:
        t0 = time.perf_counter()
        add_items(index, new)
        out["add_s"] = time.perf_counter() - t0
        out["add_rebuilds"] = list(rebuilds)
        tagged = new_ids[::3]
        t0 = time.perf_counter()
        set_item_tags(index, tagged, UPDATES_TAG)
        out["tags_s"] = time.perf_counter() - t0
        # half the removals are just added (tagged among them), half are
        # built rows of the shards the insert touched
        touched = [s for s, g in enumerate(index.subs)
                   if np.isin(new_ids, g.ids).any()]
        built_ids = np.concatenate([index.subs[s].ids for s in touched])
        built_ids = np.sort(built_ids[built_ids < n])
        gone = np.concatenate([
            new_ids[rng.choice(UPDATES_ADD, UPDATES_REMOVE // 2,
                               replace=False)],
            rng.choice(built_ids, UPDATES_REMOVE // 2, replace=False)])
        del rebuilds[:]
        t0 = time.perf_counter()
        remove_items(index, gone)
        out["remove_s"] = time.perf_counter() - t0
        out["remove_rebuilds"] = list(rebuilds)
    finally:
        unwrap()
    out["touched_shards"] = touched
    out["delta_records"] = len(index.delta_log())

    # the live index
    alive = np.ones(n + UPDATES_ADD, bool)
    alive[gone] = False
    corpus = np.concatenate([x, new])
    q = np.concatenate([query_set(x, 256, seed=12), new[alive[n:]]])
    truth = gpu_truth(corpus, q, k, alive=alive)
    ids, _, _ = search_single_host(index, q, k)
    kept = new_ids[alive[n:]]
    own_first = ids[256:, 0] == kept
    out["own_row_first"] = float(own_first.mean())
    out["removed_returned"] = int(np.isin(ids, gone).sum())
    tagged_alive = set(np.setdiff1d(tagged, gone).tolist())
    fids, _, _ = search_single_host(
        index, corpus[sorted(tagged_alive)], k, filter_tags=UPDATES_TAG)
    got = set(fids[fids >= 0].tolist())
    stored = {int(i) for g in index.subs
              for i, t in zip(g.ids, g.tags_or_zeros()) if t & UPDATES_TAG}
    out["tag_filter_exact"] = got == tagged_alive == stored
    out["recall_single_host"] = recall_at(ids, truth)
    eng = ServingEngine(index, replicas=1)
    try:
        _, out["recall_engine_pre_crash"] = engine_recall(eng, q, truth, k)
    finally:
        eng.shutdown()
    live_sums = checksums(index)
    live_codes = index.arena("int8").data.clone()
    log(f"8b online updates on {n} x {d} (16 shards of {out['sub_sizes']}):"
        f" built in {out['build_s']:.1f} s; add {UPDATES_ADD} rows "
        f"{out['add_s']:.1f} s (rebuilds [rows, s] {out['add_rebuilds']}),"
        f" tags {out['tags_s']:.3f} s, remove {UPDATES_REMOVE} ids "
        f"{out['remove_s']:.1f} s (rebuilds {out['remove_rebuilds']}); "
        f"own row first {out['own_row_first']:.4f}, removed ids returned "
        f"{out['removed_returned']}, tag filter exact "
        f"{out['tag_filter_exact']}; recall@10 single host "
        f"{out['recall_single_host']:.4f}, engine "
        f"{out['recall_engine_pre_crash']:.4f}")
    if not (out["own_row_first"] == 1.0 and out["removed_returned"] == 0
            and out["tag_filter_exact"]):
        raise AssertionError(f"8b: the live index after the updates is "
                             f"wrong: {out}")

    # the crash: the index and its engine are gone; recover from the
    # store. ServingEngine.from_store is IndexStore.load (verify, rebuild,
    # replay the delta log) and an engine on the loaded index: the
    # recovered index is checked through the engine's own copy, so the
    # log is replayed once for both
    del index, eng
    rebuilds, unwrap = timed_rebuilds()
    try:
        t0 = time.perf_counter()
        eng = ServingEngine.from_store(root, replicas=1)
        out["replay_s"] = time.perf_counter() - t0
        out["replay_rebuilds"] = list(rebuilds)
        loaded = eng.index
        try:
            ids2, _, _ = search_single_host(loaded, q, k)
            out["replay_checksums_equal"] = checksums(loaded) == live_sums
            out["replay_ids_equal"] = float((ids2 == ids).all(axis=1).mean())
            eng_ids, out["recall_from_store"] = engine_recall(eng, q,
                                                              truth, k)
        finally:
            eng.shutdown()
        t0 = time.perf_counter()
        engq = ServingEngine.from_store(root, replicas=1, quantize=True)
        out["from_store_int8_s"] = time.perf_counter() - t0
        try:
            out["int8_codes_equal"] = bool(torch.equal(
                engq.index.arena("int8").data, live_codes))
        finally:
            engq.shutdown()
    finally:
        unwrap()
    log(f"8b recovery: ServingEngine.from_store replayed "
        f"{out['delta_records']} records and started in "
        f"{out['replay_s']:.1f} s (rebuilds {out['replay_rebuilds']}); "
        f"checksums equal {out['replay_checksums_equal']}, ids equal "
        f"{out['replay_ids_equal']:.4f}, recall@10 "
        f"{out['recall_from_store']:.4f} (pre-crash "
        f"{out['recall_engine_pre_crash']:.4f}); from_store int8 "
        f"{out['from_store_int8_s']:.1f} s, codes equal "
        f"{out['int8_codes_equal']}")
    if not (out["replay_checksums_equal"] and out["replay_ids_equal"] == 1.0
            and abs(out["recall_from_store"]
                    - out["recall_engine_pre_crash"]) <= RECALL_SLACK
            and out["int8_codes_equal"]):
        raise AssertionError(f"8b: recovery from the store differs from "
                             f"the live index: {out}")
    ids_b = set(int(i) for g in loaded.subs for i in g.ids)
    return out, {"index": loaded, "queries": q, "truth": truth,
                 "ids": ids_b, "engine_ids": eng_ids}


def counter_series(registry, name: str) -> dict:
    series = registry.snapshot()[name]["series"]
    return {",".join(e["labels"].values()) or "all": e["value"]
            for e in series}


def api_and_tenancy(state: dict, root_a: str, index_a,
                    updates: dict) -> dict:
    """8c: Listing 1 over 8a's store, a hot swap onto 8b's recovered index
    under an open client, and two tenants (8a's index in float32, 8b's in
    int8) under a budget that holds one at a time."""
    import torch
    from repro_torch.core.api import Brokers, Coordinator, QueryPara
    from repro_torch.core.client import gather_arrays
    from repro_torch.serving.tenancy import (TenantManager,
                                             estimate_arena_bytes)
    k = state["truth"].shape[1]
    q = state["queries"][:API_QUERIES]
    out = {}
    with Brokers() as brokers:
        t0 = time.perf_counter()
        coord = Coordinator(brokers, root_a, "sift", "l2")
        out["coordinator_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = coord.execute_batch(q, QueryPara(k=k))
        out["listing1_s"] = time.perf_counter() - t0
        ids = np.stack([r.ids for r in res])
        out["listing1_ids_equal_phase7"] = float(
            (ids == state["engine_ids"][:API_QUERIES]).all(axis=1).mean())
        client = brokers.open_client("sift", root_a, metric="l2")
        # the hot swap onto 8b's index as 8b recovered it from its store
        # (replace_index takes a store path or a loaded index; 8b's
        # recovery already replayed the store's log; 9c swaps from a
        # store path, once the log is compacted away)
        t0 = time.perf_counter()
        brokers.replace_index("sift", updates["index"])
        out["hot_swap_s"] = time.perf_counter() - t0
        qb, truth_b = updates["queries"], updates["truth"]
        swapped, _ = gather_arrays(client.search_batch(qb, k=k), k, 120.0)
        out["swap_ids_in_8b"] = bool(set(swapped[swapped >= 0].tolist())
                                     <= updates["ids"])
        out["swap_recall"] = recall_at(swapped, truth_b)
        out["swap_recall_from_store"] = recall_at(updates["engine_ids"],
                                                  truth_b)
    log(f"8c Listing 1: Coordinator on 8a's store started in "
        f"{out['coordinator_start_s']:.1f} s, {API_QUERIES} queries in "
        f"{out['listing1_s']:.2f} s, ids equal to phase 7's on "
        f"{out['listing1_ids_equal_phase7']:.4f}; hot swap onto 8b's "
        f"recovered index {out['hot_swap_s']:.1f} s, the open client's ids "
        f"all in 8b "
        f"{out['swap_ids_in_8b']}, recall@10 {out['swap_recall']:.4f} "
        f"(8b's from_store engine {out['swap_recall_from_store']:.4f})")
    if not (out["listing1_ids_equal_phase7"] == 1.0 and out["swap_ids_in_8b"]
            and abs(out["swap_recall"] - out["swap_recall_from_store"])
            <= RECALL_SLACK):
        raise AssertionError(f"8c: the paper's API disagrees: {out}")

    big, small = index_a, updates["index"]
    est = {"big": estimate_arena_bytes(big),
           "small": estimate_arena_bytes(small, quantize=True)}
    budget = est["big"] + est["small"] - 1
    out["tenancy"] = {"estimates": est, "budget_bytes": budget}
    tm = TenantManager(budget)
    try:
        t0 = time.perf_counter()
        tm.create("big", big)
        tm.create("small", small, activate=False, quantize=True)
        admit_s = time.perf_counter() - t0
        ids1, _ = gather_arrays(tm.client("big").search_batch(q, k=k), k,
                                120.0)
        big_bytes = tm.stats()["tenants"]["big"]["bytes"]
        # the engines closed above sit in reference cycles until a
        # collection: collect them first, so the fall below is big's own
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        gather_arrays(tm.client("small").search_batch(
            updates["queries"][:API_QUERIES], k=k), k, 120.0)
        swap_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        live_after_small = {n: t["live"] for n, t in
                            tm.stats()["tenants"].items()}
        t0 = time.perf_counter()
        ids2, _ = gather_arrays(tm.client("big").search_batch(q, k=k), k,
                                120.0)
        repin_s = time.perf_counter() - t0
        st = tm.stats()
        ten = out["tenancy"]
        ten.update(
            admit_big_s=admit_s, touch_small_s=swap_s, repin_big_s=repin_s,
            big_arena_vector_bytes=big_bytes,
            memory_allocated_before=mem_before,
            memory_allocated_after=mem_after,
            memory_fall=mem_before - mem_after,
            live_after_small=live_after_small,
            repin_ids_identical=bool(np.array_equal(ids1, ids2)),
            tenants=st["tenants"],
            admissions=counter_series(tm.obs,
                                      "pyramid_tenant_admissions_total"),
            evictions=counter_series(tm.obs,
                                     "pyramid_tenant_evictions_total"),
            rejections=counter_series(tm.obs,
                                      "pyramid_tenant_rejections_total"))
    finally:
        tm.shutdown()
    log(f"8c tenancy: budget {budget} bytes (estimates {est}); touching "
        f"small evicted big {not ten['live_after_small']['big']} in "
        f"{ten['touch_small_s']:.2f} s, memory_allocated "
        f"{mem_before} -> {mem_after} (fell {ten['memory_fall']}, big's "
        f"arena vector bytes {big_bytes}); re-pin {repin_s:.2f} s, ids "
        f"identical {ten['repin_ids_identical']}; admissions "
        f"{ten['admissions']} evictions {ten['evictions']} rejections "
        f"{ten['rejections']}")
    if not (ten["live_after_small"] == {"big": False, "small": True}
            and ten["memory_fall"] >= big_bytes
            and ten["repin_ids_identical"]):
        raise AssertionError(f"8c: tenancy failed: {ten}")
    return out


def store_path(state: dict):
    """Phase 8: the store round trip at phase 4's size (8a), online
    updates and crash recovery on a small index (8b), and the paper's API
    and tenancy over both stores (8c); then phase 9 on 8b's store, before
    the stores are removed. The launch counts are set to 0 at each
    phase's start and read at its end. Returns both phases' results."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    res = {}
    reset_launch_counts()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        root_a, root_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        res["round_trip"], index_a = store_round_trip(state, root_a)
        t0 = time.perf_counter()
        res["updates"], updates = online_updates(root_b)
        res["updates"]["step_s"] = time.perf_counter() - t0
        res["api"] = api_and_tenancy(state, root_a, index_a, updates)
        res["launches"] = launch_counts()
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"phase 8: launches {res['launches']}; {res['phase_s']:.1f} s")
        missing = [name for name in PYRAMID_KERNELS
                   if res["launches"][name] <= 0]
        if missing:
            raise AssertionError(f"phase 8 never launched {missing}: "
                                 f"{res['launches']}")
        if res["phase_s"] > PHASE8_LIMIT_S:
            raise AssertionError(f"phase 8 took {res['phase_s']:.1f} s, "
                                 f"over its {PHASE8_LIMIT_S:.0f} s")
        del index_a          # phase 10 searches state["index"] again
        torch.cuda.empty_cache()
        maintenance = maintenance_path(root_b, updates, res["updates"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, maintenance


# ---------------------------------------------------------------------------
# phase 9: online maintenance on 8b's store
# ---------------------------------------------------------------------------

PHASE9_LIMIT_S = 100.0
# phase 9 runs on 8b's index and store: 8b's cut of scale holds
MAINT_CUTS = {"n": "8b's 1,024 rows plus its 128 inserts (UPDATES_CUTS: "
                   "every fold, split and refresh rebuilds shards with "
                   "the host builder at 15 to 35 ms a row)"}
MAINT_INSERT = 8           # rows of 9b's insert record
MAINT_TAG = 8              # the tag bit of 9b's tag record
MAINT_QUERIES = 64         # queries in flight across each hot swap


class SimulatedCrash(RuntimeError):
    pass


def cycle_stages(tracer) -> list:
    """Seconds of each compaction cycle and of its stages, from the
    ``compaction.*`` spans the Compactor writes."""
    spans = tracer.snapshot()
    out = []
    for cyc in (sp for sp in spans if sp.name == "compaction.cycle"):
        stages = {"cycle": cyc.duration,
                  "version_from": cyc.attrs.get("version_from"),
                  "version_to": cyc.attrs.get("version_to"),
                  "folded": cyc.attrs.get("folded")}
        for sp in spans:
            if sp.parent_id == cyc.span_id:
                stage = sp.name.split(".", 1)[1]
                stages[stage] = stages.get(stage, 0.0) + sp.duration
        out.append(stages)
    return out


def stored_ids(index) -> np.ndarray:
    return np.concatenate([g.ids for g in index.subs])


def compaction(root: str, updates: dict, replay_s: float):
    """9a: 8b's recovered index (attached to its version's delta log of
    three records) folded into a new version, then the store loaded back
    on the card: nothing to replay, every checksum and float32 id equal
    to the pre-compaction index's, the old log truncated to 0."""
    from repro_torch.core.distributed import search_single_host
    from repro_torch.obs import Tracer
    from repro_torch.store import Compactor, IndexStore
    live, q = updates["index"], updates["queries"]
    k = updates["truth"].shape[1]
    store = IndexStore(root)
    old_vid = store.latest()
    out = {"records": len(live.delta_log()), "version_from": old_vid}
    live_sums = checksums(live)
    ids_live, _, _ = search_single_host(live, q, k)
    tracer = Tracer()
    comp = Compactor(store, live, rebalance=False, tracer=tracer)
    t0 = time.perf_counter()
    out["version_to"] = comp.run_once(force=True)
    out["cycle_s"] = time.perf_counter() - t0
    out["stages_s"] = cycle_stages(tracer)
    rebuilds, unwrap = timed_rebuilds()
    try:
        t0 = time.perf_counter()
        loaded = IndexStore(root).load(device="cuda")
        out["load_s"] = time.perf_counter() - t0
    finally:
        unwrap()
    out["load_rebuilds"] = len(rebuilds)
    out["replayed"] = len(loaded.delta_log())
    out["replay_s_8b"] = replay_s
    out["old_log_records"] = len(store.reader(old_vid).delta_log())
    out["checksums_equal"] = checksums(loaded) == live_sums
    ids, _, _ = search_single_host(loaded, q, k)
    out["ids_equal"] = float((ids == ids_live).all(axis=1).mean())
    log(f"9a compaction: folded {out['records']} records of {old_vid} into "
        f"{out['version_to']} in {out['cycle_s']:.1f} s (stages "
        f"{out['stages_s']}); IndexStore.load {out['load_s']:.2f} s against "
        f"8b's replay {replay_s:.1f} s, replayed {out['replayed']} records "
        f"({out['load_rebuilds']} shard rebuilds); checksums equal "
        f"{out['checksums_equal']}, ids equal {out['ids_equal']:.4f}; "
        f"old log {out['old_log_records']} records")
    if not (out["replayed"] == 0 and out["load_rebuilds"] == 0
            and out["old_log_records"] == 0 and out["checksums_equal"]
            and out["ids_equal"] == 1.0 and out["records"] == 3):
        raise AssertionError(f"9a: compaction changed the index or left "
                             f"records to replay: {out}")
    return out, loaded


def crash_window(root: str, index):
    """9b: a cheap tag record and an insert of MAINT_INSERT rows, then a
    cycle killed at the commit point ("publish": the new version's rename
    has landed, the old log is not truncated, CURRENT not flipped).
    Recovery from the store must equal a crash-free cycle's state (the
    live index the records were applied to) with each record applied
    once."""
    from repro_torch.obs import Tracer
    from repro_torch.store import Compactor, IndexStore

    def boom(step):
        if step == "publish":
            raise SimulatedCrash(step)
    store = IndexStore(root)
    old_vid = store.latest()
    tracer = Tracer()
    comp = Compactor(store, index, rebalance=False, fault_hook=boom,
                     tracer=tracer)
    ids_before = stored_ids(index)
    tagged = np.sort(ids_before)[:MAINT_INSERT]
    # rows beside the smallest shard of at least MAINT_INSERT rows: one
    # cheap rebuild
    s = min((g.n, i) for i, g in enumerate(index.subs)
            if g.n >= MAINT_INSERT)[1]
    rng = np.random.default_rng(21)
    rows = index.subs[s].data[rng.choice(index.subs[s].n, MAINT_INSERT,
                                         replace=False)]
    new = (rows + 0.01 * rng.normal(size=rows.shape)).astype(np.float32)
    t0 = time.perf_counter()
    comp.set_item_tags(tagged, MAINT_TAG)
    comp.add_items(new)
    out = {"records_s": time.perf_counter() - t0, "shard": s,
           "version_from": old_vid}
    live = comp.index
    new_ids = np.setdiff1d(stored_ids(live), ids_before)
    live_sums = checksums(live)
    t0 = time.perf_counter()
    try:
        comp.run_once(force=True)
        raise AssertionError("9b: the cycle did not reach its publish")
    except SimulatedCrash:
        out["crashed_after_s"] = time.perf_counter() - t0
    out["stages_s"] = cycle_stages(tracer)
    t0 = time.perf_counter()
    recovered = IndexStore(root).load(device="cuda")
    out["recover_s"] = time.perf_counter() - t0
    out["version_recovered"] = IndexStore(root).latest()
    out["replayed"] = len(recovered.delta_log())
    out["stale_log_records"] = len(store.reader(old_vid).delta_log())
    got = stored_ids(recovered)
    out["checksums_equal"] = checksums(recovered) == live_sums
    # the same stored ids as the live index (8b's build stores a row twice
    # where a partition got no centre), each inserted id once
    out["ids_once"] = bool(
        np.array_equal(np.sort(got), np.sort(stored_ids(live)))
        and new_ids.size == MAINT_INSERT
        and all(int((got == i).sum()) == 1 for i in new_ids))
    tags = {int(i): int(t) for g in recovered.subs
            for i, t in zip(g.ids, g.tags_or_zeros())}
    out["tags_applied"] = all(tags[int(i)] == MAINT_TAG for i in tagged)
    log(f"9b crash at publish: tag and insert records in "
        f"{out['records_s']:.1f} s (shard {s}); the cycle raised after "
        f"{out['crashed_after_s']:.1f} s; recovered {out['version_recovered']}"
        f" in {out['recover_s']:.2f} s, replayed {out['replayed']} records "
        f"({old_vid}'s log still holds {out['stale_log_records']}, never "
        f"replayed); checksums equal to the crash-free state "
        f"{out['checksums_equal']}, each record once {out['ids_once']}, "
        f"tags applied {out['tags_applied']}")
    if not (out["checksums_equal"] and out["ids_once"]
            and out["tags_applied"] and out["replayed"] == 0
            and out["version_recovered"] != old_vid):
        raise AssertionError(f"9b: recovery after a crash at publish is "
                             f"not the crash-free state: {out}")
    return out


def maintenance_cycle(brokers, comp, client, q, truth_ids, k: int,
                      name: str) -> dict:
    """One maintenance cycle under an open client: MAINT_QUERIES futures
    in flight across the hot swap must each resolve once; after it, the
    client's engine serves the new version and its recall@10 (and
    ``search_single_host``'s on the new index) is recorded."""
    from repro_torch.core.client import gather_arrays
    from repro_torch.core.distributed import search_single_host
    from repro_torch.store import IndexStore
    completions = {}

    def done(fut):
        completions[fut.query_id] = completions.get(fut.query_id, 0) + 1
    futs = client.search_batch(q[:MAINT_QUERIES], k)
    for f in futs:
        f.add_done_callback(done)
    ops = len(comp.rebalance_ops)
    t0 = time.perf_counter()
    vid = comp.run_once(force=True)
    out = {"cycle_s": time.perf_counter() - t0, "version": vid,
           "op": list(comp.rebalance_ops[-1]) if len(comp.rebalance_ops)
           > ops else None}
    gather_arrays(futs, k, 120.0)
    out["futures_once"] = (sorted(completions) == sorted(
        f.query_id for f in futs) and all(c == 1 for c in
                                          completions.values()))
    eng = brokers.get_engine("maint")
    out["engine_on_new_version"] = bool(
        eng.index is comp.index
        and eng.w == IndexStore(comp.store.root).reader(vid).num_shards)
    ids, _ = gather_arrays(client.search_batch(q, k), k, 120.0)
    out["ids_in_new_version"] = bool(np.isin(
        ids[ids >= 0], stored_ids(comp.index)).all())
    out["recall"] = recall_at(ids, truth_ids)
    ids_s, _, _ = search_single_host(comp.index, q, k)
    out["recall_single_host"] = recall_at(ids_s, truth_ids)
    out["sub_sizes"] = [g.n for g in comp.index.subs]
    out["maintenance_stats"] = eng.stats()["maintenance"]
    log(f"9c {name}: op {out['op']}, {vid} in {out['cycle_s']:.1f} s; "
        f"futures once {out['futures_once']}, engine on the new version "
        f"{out['engine_on_new_version']}, client ids in it "
        f"{out['ids_in_new_version']}; recall@10 {out['recall']:.4f} "
        f"(single host {out['recall_single_host']:.4f}); shard sizes "
        f"{out['sub_sizes']}; stats()['maintenance'] "
        f"{out['maintenance_stats']}")
    return out


def rebalance_and_refresh(root: str, q) -> dict:
    """9c: ``Brokers.attach_maintenance`` on an engine serving the store,
    with a client open: a cycle whose split factor splits the largest
    splittable shard, one with the default factors, one centroid refresh
    (k-means++ and a rebuild of every shard), and one more with the
    default factors. Recall@10 after each hot swap must stay within
    RECALL_SLACK of the engine's before maintenance. Then a hot swap from
    the store path, the serving layer's refresh: the client's ids must
    not change."""
    from repro_torch.core.api import Brokers
    from repro_torch.core.client import gather_arrays
    from repro_torch.obs import Tracer
    k = 10
    out = {}
    tracer = Tracer()
    with Brokers() as brokers:
        t0 = time.perf_counter()
        client = brokers.open_client("maint", root, metric="l2")
        out["start_s"] = time.perf_counter() - t0
        index = brokers.get_engine("maint").index
        rows = np.concatenate([g.data for g in index.subs])
        ids_all = stored_ids(index)
        truth_ids = ids_all[gpu_truth(rows, q, k)]
        ids0, _ = gather_arrays(client.search_batch(q, k), k, 120.0)
        out["recall_before"] = recall_at(ids0, truth_ids)
        comp = brokers.attach_maintenance("maint", root, tracer=tracer)
        # the largest shard plan_rebalance may split (two meta centres
        # and eight rows at least)
        sizes = [g.n for g in index.subs]
        centres = np.bincount(np.asarray(index.part_of_center),
                              minlength=len(sizes))
        big = max(sizes[s] for s in range(len(sizes))
                  if centres[s] >= 2 and sizes[s] >= 8)
        comp.split_factor = 0.999 * big / (sum(sizes) / len(sizes))
        out["split"] = maintenance_cycle(brokers, comp, client, q, truth_ids,
                                         k, f"split (factor "
                                            f"{comp.split_factor:.3f})")
        comp.split_factor = 4.0
        out["default"] = maintenance_cycle(brokers, comp, client, q,
                                           truth_ids, k, "default factors")
        comp.rebalance, comp.refresh_every = False, 1
        out["refresh"] = maintenance_cycle(brokers, comp, client, q,
                                           truth_ids, k, "centroid refresh")
        # the refresh keeps w and may leave partitions without items: the
        # default factors then merge the two smallest
        comp.rebalance, comp.refresh_every = True, 0
        out["after_refresh"] = maintenance_cycle(
            brokers, comp, client, q, truth_ids, k,
            "default factors after the refresh")
        # the serving layer's refresh from the store path (replace_index
        # loads the latest published version on the card): the last cycle
        # published and truncated its log, so nothing is replayed and the
        # open client's ids stay the compacted index's
        ids_last, _ = gather_arrays(client.search_batch(q, k), k, 120.0)
        t0 = time.perf_counter()
        brokers.replace_index("maint", root)
        swap = {"swap_s": time.perf_counter() - t0}
        eng = brokers.get_engine("maint")
        ids_swap, _ = gather_arrays(client.search_batch(q, k), k, 120.0)
        swap.update(
            new_engine=eng.index is not comp.index,
            replayed=len(eng.index.delta_log()),
            checksums_equal=checksums(eng.index) == checksums(comp.index),
            ids_equal=float((ids_swap == ids_last).all(axis=1).mean()))
        out["store_swap"] = swap
        log(f"9c hot swap from the store path: {swap['swap_s']:.2f} s, "
            f"replayed {swap['replayed']} records, checksums equal "
            f"{swap['checksums_equal']}, the open client's ids equal "
            f"{swap['ids_equal']:.4f}")
    out["stages_s"] = cycle_stages(tracer)
    cycles = [out[c] for c in ("split", "default", "refresh",
                               "after_refresh")]
    op = out["split"]["op"]
    swap = out["store_swap"]
    if not (op and op[0] == "split" and sizes[op[1]] == big
            and swap["new_engine"] and swap["replayed"] == 0
            and swap["checksums_equal"] and swap["ids_equal"] == 1.0
            and out["refresh"]["maintenance_stats"]["centroid_refreshes"] == 1
            and all(c["futures_once"] and c["engine_on_new_version"]
                    and c["ids_in_new_version"]
                    and abs(c["recall"] - out["recall_before"]) <= RECALL_SLACK
                    for c in cycles)):
        raise AssertionError(f"9c: maintenance through the engine failed: "
                             f"{out}")
    return out


def maintenance_path(root: str, updates: dict, res8b: dict) -> dict:
    """Phase 9: online maintenance on 8b's store: compaction and recovery
    after it (9a), a crash at the commit point (9b), and split, merge and
    centroid refresh through the serving engine under an open client
    (9c). The launch counts are set to 0 at its start and read at its
    end."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    res = {"cuts": MAINT_CUTS}
    reset_launch_counts()
    t_phase = time.perf_counter()
    res["compaction"], loaded = compaction(root, updates,
                                           res8b["replay_s"])
    res["crash"] = crash_window(root, loaded)
    del loaded, updates["index"]
    res["engine"] = rebalance_and_refresh(root, updates["queries"])
    res["launches"] = launch_counts()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9: launches {res['launches']}; {res['phase_s']:.1f} s")
    missing = [name for name in PYRAMID_KERNELS if res["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"phase 9 never launched {missing}: "
                             f"{res['launches']}")
    if res["phase_s"] > PHASE9_LIMIT_S:
        raise AssertionError(f"phase 9 took {res['phase_s']:.1f} s, over "
                             f"its {PHASE9_LIMIT_S:.0f} s")
    return res


# ---------------------------------------------------------------------------
# phase 10: Pyramid's multi-device path on one card
# ---------------------------------------------------------------------------

PHASE10_LIMIT_S = 60.0
NAIVE_QUERIES = 256        # the naive baseline's batch (C = that batch)
WORKER_READS = (1, 4)      # workers reading phase 4's rows back


def dropped_pairs(mask, capacity: int) -> dict:
    """Routed (query, shard) pairs a capacity of C leaves unwalked: each
    shard walks the first C queries routed to it."""
    load = mask.sum(dim=0)
    routed = int(load.sum())
    return {"routed": routed,
            "dropped": routed - int(load.clamp(max=capacity).sum()),
            "max_load": int(load.max()), "capacity": capacity}


def uncounted(checks: dict, fn):
    """Runs a check's own reference ``fn`` and adds the kernel launches it
    made to ``checks``, which the phase takes back out of its counts: the
    path's counts hold the path's launches only."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    out = fn()
    for name, n in launch_counts().items():
        checks[name] = checks.get(name, 0) + n - before[name]
    return out


def spmd_search(mesh, state: dict, dev, checks: dict) -> dict:
    """10a: ``make_pyramid_search_fn`` over phase 4's index and queries on
    a (1, 1) mesh (every shard on this rank; the partials gathered over
    ``model`` by NCCL), float32 and int8 (rerank 4), its ids held equal to
    the one-device pipeline at the same capacity C (``arena_search`` with
    the same routing mask, then ``exact_rerank_np`` for int8); and the
    naive baseline (every query to every shard) on a slice of the
    queries, split over the ``data`` axis (one replica here). The
    reference runs' launches go to ``checks``."""
    import torch
    from repro_torch.core import quant as Q
    from repro_torch.core.arena import arena_search
    from repro_torch.core.distributed import local_arena, make_pyramid_search_fn
    from repro_torch.core.router import route_queries
    from repro_torch.kernels import launch_counts
    index, q, truth = state["index"], state["queries"], state["truth"]
    cfg, k = index.config, truth.shape[1]
    qt = torch.as_tensor(q, device=dev)
    meta, poc = index.meta_arrays(), index.part_of_center_tensor()
    w, kb = index.num_shards, cfg.branching_factor
    mask, _ = uncounted(checks, lambda: route_queries(
        meta, poc, qt, metric="l2", branching_factor=kb, num_shards=w,
        ef=max(64, kb)))
    table = index.rerank_table()
    out = {}
    runs = {"float32": (dict(), len(q)),
            "int8": (dict(quantize=True, rerank_factor=4), len(q)),
            "naive": (dict(naive=True, data_axis="data"), NAIVE_QUERIES)}
    for name, (kw, b) in runs.items():
        quantize = kw.get("quantize", False)
        fn = make_pyramid_search_fn(mesh, cfg, k=k, batch=b,
                                    index=index if quantize else None, **kw)
        arena = local_arena(index, mesh, quantize=quantize)
        qb = qt[:b]
        call = lambda: fn(arena, meta, poc, qb)
        before = launch_counts()
        (ids, scores), first_s = synced(call)
        reps = 3
        _, dt = synced(lambda: [call() for _ in range(reps)])
        after = launch_counts()
        dt /= reps
        ids = np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids)
        scores = np.asarray(scores.cpu() if hasattr(scores, "cpu")
                            else scores)
        # the one-device pipeline at the same capacity and routing
        k_in = k * kw.get("rerank_factor", 1)
        cap = b if kw.get("naive") else max(1, min(b, int(np.ceil(
            b * kb / w * cfg.capacity_factor))))
        mb = torch.ones((b, w), dtype=torch.bool, device=dev) \
            if kw.get("naive") else mask[:b]
        ref_ids, ref_s, _ = uncounted(checks, lambda: arena_search(
            arena, None, None, qb, metric="l2", k=k_in,
            ef=max(cfg.ef_search, k_in), capacity=cap, mask=mb))
        ref_ids = ref_ids.cpu().numpy()
        ref_s = ref_s.cpu().numpy()
        if quantize:
            ref_ids, ref_s = Q.exact_rerank_np(
                q[:b], ref_ids, k, table_ids=table[0], table_vecs=table[1],
                metric="l2")
        check_answer(f"spmd {name}", ids, scores, state["x"], q[:b], k)
        single = state["answers"]["float32"][0][:b]
        out[name] = {
            "batch": b, **dropped_pairs(mb, cap),
            "ids_equal_pipeline": float((ids == ref_ids).mean()),
            "max_score_diff_pipeline": float(np.abs(scores - ref_s).max()),
            "recall@10": recall_at(ids, truth[:b]),
            "recall@10_search_single_host": recall_at(single, truth[:b]),
            "qps": b / dt, "batch_s": dt, "first_call_s": first_s,
            "launches_per_batch": {
                key: (after[key] - before[key]) // (reps + 1)
                for key in ("beam_search", "merge_topk")}}
        r = out[name]
        log(f"10a spmd {name}: batch {b}, C {r['capacity']} (largest shard "
            f"load {r['max_load']}), dropped {r['dropped']} of {r['routed']}"
            f" routed pairs; ids equal to the same-capacity pipeline "
            f"{r['ids_equal_pipeline']:.5f} (max score diff "
            f"{r['max_score_diff_pipeline']:.3g}); recall@10 "
            f"{r['recall@10']:.4f} (search_single_host "
            f"{r['recall@10_search_single_host']:.4f}); QPS {r['qps']:.1f} "
            f"({dt * 1e3:.2f} ms a batch, first call {first_s:.2f} s); "
            f"launches a batch {r['launches_per_batch']}")
        if r["ids_equal_pipeline"] != 1.0 or \
                r["max_score_diff_pipeline"] > 1e-5:
            raise AssertionError(f"10a: the SPMD {name} search differs from "
                                 f"the one-device pipeline: {r}")
    return out


def distributed_build(mesh, state: dict, dev, checks: dict) -> dict:
    """10b: phase 4's rows written to an .fvecs file and read back by 1
    and 4 workers through ``worker_slice``; then ``kmeans_distributed``
    over the build's sample (the ``data`` axis on this card), held to the
    port's ``kmeans`` from the same initial centres (its launches go to
    ``checks``)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.kmeans import _init_centers, kmeans, kmeans_distributed
    from repro_torch.core.meta_index import _sample
    from repro_torch.data.vectors import load_dataset, worker_slice, write_fvecs
    from repro_torch.kernels import launch_counts
    x, cfg = state["x"], state["index"].config
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vectors_")
    try:
        path = os.path.join(tmp, "phase4.fvecs")
        t0 = time.perf_counter()
        write_fvecs(path, x)
        out["write_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        for workers in WORKER_READS:
            t0 = time.perf_counter()
            parts = [load_dataset(path, *worker_slice(len(x), r, workers))
                     for r in range(workers)]
            out[f"read_{workers}_s"] = time.perf_counter() - t0
            out[f"read_{workers}_rows"] = [len(p) for p in parts]
            if not np.array_equal(np.concatenate(parts), x):
                raise AssertionError(f"10b: {workers} workers read back "
                                     f"other rows")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the build's sample and number of centres, as plan_build draws them
    sample = _sample(x, cfg.sample_size, np.random.default_rng(cfg.seed))
    m = min(cfg.meta_size, max(cfg.num_shards, len(x) // 4))
    init = _init_centers(torch.as_tensor(sample), m, cfg.seed).numpy()
    before = launch_counts()["topk_distance"]
    (c_d, n_d), out["kmeans_distributed_s"] = synced(
        lambda: kmeans_distributed(sample, m, mesh, iters=cfg.kmeans_iters,
                                   init_centers=init))
    out["kmeans_distributed_topk_launches"] = \
        launch_counts()["topk_distance"] - before
    (c_1, n_1), out["kmeans_s"] = uncounted(checks, lambda: synced(
        lambda: kmeans(sample, m, iters=cfg.kmeans_iters, init_centers=init,
                       device=dev)))
    out.update(rows=len(sample), m=m, iters=cfg.kmeans_iters,
               max_center_diff=float(np.abs(c_d - c_1).max()),
               counts_equal=bool(np.array_equal(n_d, n_1)),
               empty_centres=int((n_d == 0).sum()))
    log(f"10b distributed build: wrote {out['file_bytes']} bytes in "
        f"{out['write_s']:.2f} s, read back by 1 and 4 workers in "
        f"{out['read_1_s']:.3f} / {out['read_4_s']:.3f} s (rows "
        f"{out['read_4_rows']}); kmeans_distributed on {len(sample)} x "
        f"{sample.shape[1]}, m {m}, {cfg.kmeans_iters} iterations: "
        f"{out['kmeans_distributed_s']:.3f} s, "
        f"{out['kmeans_distributed_topk_launches']} top-k launches; against "
        f"kmeans ({out['kmeans_s']:.3f} s): max centre diff "
        f"{out['max_center_diff']:.3g}, counts equal {out['counts_equal']}")
    if out["max_center_diff"] > 1e-4 or not out["counts_equal"] or \
            out["kmeans_distributed_topk_launches"] != cfg.kmeans_iters:
        raise AssertionError(f"10b: kmeans_distributed differs from kmeans: "
                             f"{out}")
    return out


def multi_device_path(state: dict) -> dict:
    """Phase 10: Pyramid's multi-device path on this card: a (1, 1) mesh
    from ``make_local_mesh("cuda")`` (NCCL at world size 1), the SPMD
    search over phase 4's index (10a) and the distributed build's reads
    and k-means (10b). The launch counts are set to 0 at its start and
    read at its end, less the launches of the checks' reference runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    res, checks = {}, {}
    reset_launch_counts()
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        mesh = make_local_mesh("cuda")
        res["mesh_s"] = time.perf_counter() - t0
        res["backend"] = dist.get_backend()
        res["world_size"] = dist.get_world_size()
        res["mesh"] = str(mesh)
        log(f"phase 10: {res['mesh']} on {res['backend']}, world size "
            f"{res['world_size']}, started in {res['mesh_s']:.2f} s")
        if res["backend"] != "nccl":
            raise AssertionError(f"phase 10: a cuda mesh on {res['backend']}")
        dev = torch.device("cuda")
        res["spmd"] = spmd_search(mesh, state, dev, checks)
        res["build"] = distributed_build(mesh, state, dev, checks)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    res["launches"] = {name: n - checks.get(name, 0)
                       for name, n in launch_counts().items()}
    res["check_launches"] = checks
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10: launches {res['launches']} (the checks' own "
        f"{checks} not counted); {res['phase_s']:.1f} s")
    missing = [name for name in PYRAMID_KERNELS if res["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"phase 10 never launched {missing}: "
                             f"{res['launches']}")
    if res["phase_s"] > PHASE10_LIMIT_S:
        raise AssertionError(f"phase 10 took {res['phase_s']:.1f} s, over "
                             f"its {PHASE10_LIMIT_S:.0f} s")
    return res


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

PHASE11_LIMIT_S = 120.0
# 11a and 11b: (arch, batch, seq, steps) at full width (bf16, synthetic
# parameters from a generator seeded 0 on the card), AdamW at the
# launcher's defaults for that many steps (lr 3e-3, warmup a tenth)
TRAIN_CELLS = (("mamba2-780m", 4, 640, 4), ("qwen3-1.7b", 8, 256, 3))
TRAIN_LR = 3e-3
# 11c: the card's train step against the CPU's on the reduced configs
# (float32): the losses of the first steps and the first step's gradients
# (as a share of each leaf's largest |g|) within TRAIN_CPU_TOL; both sum
# in float32, in another order; mamba2 at 80 rows is three chunks of 32,
# the last padded
TRAIN_CPU_TOL = 1e-4
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS = 8, 80, 3
# then the reference test's run (tests/test_training.py::
# test_train_loss_decreases): its optimizer, batch, sequence and criterion
REF_TEST_OPT = dict(lr=5e-3, warmup_steps=5, total_steps=120,
                    weight_decay=0.0)
LOSS_RUN = dict(steps=60, batch=8, seq=32, margin=0.1)
# 11d: the launcher in a subprocess
LAUNCHER_STEPS = 20


def _batch_on(b, dev) -> dict:
    import torch
    return {k: torch.from_numpy(getattr(b, k)).to(dev)
            for k in ("inputs", "targets", "mask")}


def _step_grads(params, cfg, b, dev) -> tuple:
    """(loss, {leaf path: gradient}) of ``loss_fn`` on one batch, by
    ``torch.autograd.grad`` over every leaf (a check's own run)."""
    import torch
    from repro_torch.train import tree as TT
    from repro_torch.train.train_step import loss_fn
    flat = TT.items(params)
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    live = TT.unflatten({k: v for (k, _), v in zip(flat, leaves)})
    total, (loss, _) = loss_fn(live, cfg, _batch_on(b, dev))
    grads = torch.autograd.grad(total, leaves)
    return float(loss.detach()), {k: g for (k, _), g in zip(flat, grads)}


def train_full_width(dev, arch: str, batch: int, seq: int,
                     steps: int) -> dict:
    """11a / 11b: ``train_step`` at full width. Losses and gradient norms
    finite, every leaf's gradient non-zero at step 1 (its first moment
    after the step, (1 - b1) times the clipped gradient), the launches of
    the port's kernels exact: under remat each Mamba2 layer runs the
    forward scan twice a step and its backward once, and nothing else. A
    bf16 slice of mamba2's trained parameters goes through a checkpoint
    and back, bit for bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.common.config import BlockKind
    from repro_torch.common.registry import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import launch_counts
    from repro_torch.models.transformer import init_params
    from repro_torch.train import tree as TT
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import train_step
    cfg = get_arch(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = init_opt_state(params)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(steps // 10, 1),
                      total_steps=steps)
    data = iter(SyntheticLM(cfg, batch=batch, seq_len=seq, seed=0))
    out = {"batch": batch, "seq": seq, "steps": steps, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in TT.leaves(params))}
    before = launch_counts()
    losses, norms, times = [], [], []
    for i in range(steps):
        b = _batch_on(next(data), dev)
        (params, state, m), t = synced(lambda: train_step(
            params, state, b, cfg=cfg, opt_cfg=opt))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(t)
        if i == 0:
            out["leaves"] = len(TT.leaves(state.mu))
            out["leaves_without_gradient"] = [
                k for k, mu in TT.items(state.mu)
                if not bool(mu.abs().max() > 0)]
    out["launches"] = {k: n - before[k] for k, n in launch_counts().items()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    mean_s = float(np.mean(times[1:]))
    out.update(losses=losses, grad_norms=norms, step_s=times,
               step_s_mean=mean_s, tokens_per_s=batch * seq / mean_s)
    mamba = sum(k == BlockKind.MAMBA2 for k in cfg.layer_kinds())
    want = {k: 0 for k in out["launches"]}
    want.update(ssd=2 * mamba * steps, ssd_backward=mamba * steps)
    if arch == "mamba2-780m":
        sub = {"embedding": params["embedding"][:4096],
               "blocks": {"mamba2": {k: v[:2] for k, v in
                                     params["blocks"]["mamba2"].items()}}}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
        try:
            save_checkpoint(tmp, sub, step=steps)
            back, _, step = load_checkpoint(tmp, sub)
            out["bf16_checkpoint_equal"] = step == steps and all(
                u.dtype == v.dtype and torch.equal(u, v)
                for u, v in zip(TT.leaves(back), TT.leaves(sub)))
            out["bf16_checkpoint_leaves"] = len(TT.leaves(sub))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    del params, state, m
    gc.collect()
    torch.cuda.empty_cache()
    log(f"11 {arch} full width ({out['params'] / 1e9:.3f} B params, "
        f"{cfg.dtype}, batch {batch} x {seq}): losses "
        f"{[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in norms]}; step {mean_s * 1e3:.1f} ms after "
        f"the first ({times[0] * 1e3:.1f} ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{ {k: v for k, v in out['launches'].items() if v} }; leaves "
        f"without gradient {out['leaves_without_gradient']} of "
        f"{out['leaves']}"
        + (f"; bf16 checkpoint of {out['bf16_checkpoint_leaves']} leaves "
           f"equal {out['bf16_checkpoint_equal']}" if "bf16_checkpoint_equal"
           in out else ""))
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()) \
            or out["leaves_without_gradient"] or out["launches"] != want \
            or not out.get("bf16_checkpoint_equal", True):
        raise AssertionError(f"11 {arch} full width: {out} (launches "
                             f"expected {want})")
    return out


def train_card_vs_cpu(dev, arch: str, mesh, checks: dict) -> dict:
    """11c: the reduced config trained on the card (the SSD kernels) and
    on the CPU (plain versions) from the same parameters and batches; then
    the reference test's 60-step run on the card through
    ``make_train_step`` and ``init_sharded`` on ``mesh``."""
    import torch
    from repro_torch.common.registry import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.transformer import init_params
    from repro_torch.train import tree as TT
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (init_sharded, make_train_step,
                                              train_step)
    cfg = get_arch(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = TT.map_tree(lambda t: t.to(dev, copy=True), cpu)
    data = iter(SyntheticLM(cfg, batch=TRAIN_CPU_BATCH,
                            seq_len=TRAIN_CPU_SEQ, seed=0))
    batches = [next(data) for _ in range(TRAIN_CPU_STEPS)]
    _, g_cpu = _step_grads(cpu, cfg, batches[0], "cpu")
    _, g_card = uncounted(checks, lambda: _step_grads(card, cfg, batches[0],
                                                      dev))
    shares = {k: float((g.cpu() - g_cpu[k]).abs().max())
              / float(g_cpu[k].abs().max()) for k, g in g_card.items()}
    zero = [k for k, g in g_card.items() if not bool(g.abs().max() > 0)]
    opt = AdamWConfig(**REF_TEST_OPT)
    runs = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        state = init_opt_state(params)
        losses = []
        for b in batches:
            params, state, m = train_step(params, state, _batch_on(b, d),
                                          cfg=cfg, opt_cfg=opt)
            losses.append(float(m["loss"]))
        runs[name] = losses
    loss_diff = float(np.abs(np.subtract(runs["card"], runs["cpu"])).max())
    step_fn, _ = make_train_step(mesh, cfg, opt)
    params, state = init_sharded(mesh, cfg, seed=0)
    data = iter(SyntheticLM(cfg, batch=LOSS_RUN["batch"],
                            seq_len=LOSS_RUN["seq"], seed=0))
    run, t = [], time.perf_counter()
    for _ in range(LOSS_RUN["steps"]):
        b = next(data)
        params, state, m = step_fn(params, state, {
            "inputs": b.inputs, "targets": b.targets, "mask": b.mask})
        run.append(float(m["loss"]))
    run_s = time.perf_counter() - t
    first, last = float(np.mean(run[:5])), float(np.mean(run[-5:]))
    out = {"max_grad_err_share": max(shares.values()),
           "grad_err_share": shares, "leaves_without_gradient": zero,
           "losses_cpu": runs["cpu"], "losses_card": runs["card"],
           "max_loss_diff": loss_diff, "run_losses": run,
           "run_first5_mean": first, "run_last5_mean": last,
           "run_s": run_s}
    log(f"11c {arch} reduced: card vs CPU losses {runs['card']} / "
        f"{runs['cpu']} (max diff {loss_diff:.3g}), step-1 gradients "
        f"within {out['max_grad_err_share']:.3g} of each leaf's largest "
        f"|g|, leaves without gradient {zero}; {LOSS_RUN['steps']} steps "
        f"on the card in {run_s:.2f} s: mean loss {first:.4f} -> "
        f"{last:.4f}")
    if loss_diff > TRAIN_CPU_TOL or out["max_grad_err_share"] > \
            TRAIN_CPU_TOL or zero or not np.isfinite(run).all() or \
            not last < first - LOSS_RUN["margin"]:
        raise AssertionError(f"11c {arch}: {out}")
    return out


def train_launcher(dev) -> dict:
    """11d: ``python -m repro_torch.launch.train`` in a subprocess on the
    card; its checkpoint loads back to the parameters and moments the
    process held (the digests it logged), with the manifest's step."""
    import shutil
    import tempfile
    from repro_torch.common.registry import get_arch
    from repro_torch.train.checkpoint import load_checkpoint, tree_digest
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import abstract_params
    arch = "mamba2-780m"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--reduced", "--steps", str(LAUNCHER_STEPS), "--ckpt", tmp,
             "--device", "cuda"], env=env, capture_output=True, text=True,
            timeout=300)
        run_s = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise AssertionError(f"11d: the launcher failed "
                                 f"({proc.returncode}):\n{text[-3000:]}")
        logged = re.search(r"params digest (\w+), mu (\w+), nu (\w+)", text)
        template = abstract_params(get_arch(arch).reduced())
        params, state, step = load_checkpoint(
            tmp, template, init_opt_state(template), device=dev)
        loaded = (tree_digest(params), tree_digest(state.mu),
                  tree_digest(state.nu))
        losses = [float(v) for v in re.findall(r"loss=([0-9.]+)", text)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"run_s": run_s, "step": step, "opt_step": int(state.step),
           "digests_equal": logged is not None and logged.groups() == loaded,
           "logged_losses": losses}
    log(f"11d launcher: {LAUNCHER_STEPS} steps of reduced {arch} in "
        f"{run_s:.1f} s (logged losses {losses}); checkpoint step {step}, "
        f"parameters and moments equal to the process's bit for bit: "
        f"{out['digests_equal']}")
    if not out["digests_equal"] or step != LAUNCHER_STEPS or \
            out["opt_step"] != LAUNCHER_STEPS:
        raise AssertionError(f"11d: {out}")
    return out


def training_path() -> dict:
    """Phase 11: training on the card. 11a and 11b at full width, 11c the
    reduced configs against the CPU and the reference test's run, 11d the
    launcher and checkpoints. The launch counts are set to 0 at its start
    and read at its end, less the launches of the checks' own runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda")
    res, checks = {}, {}
    reset_launch_counts()
    t_phase = time.perf_counter()
    for arch, batch, seq, steps in TRAIN_CELLS:
        res[arch] = train_full_width(dev, arch, batch, seq, steps)
    try:
        mesh = make_local_mesh("cuda")
        res["card_vs_cpu"] = {arch: train_card_vs_cpu(dev, arch, mesh,
                                                      checks)
                              for arch, *_ in TRAIN_CELLS}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    res["launcher"] = train_launcher(dev)
    res["launches"] = {name: n - checks.get(name, 0)
                       for name, n in launch_counts().items()}
    res["check_launches"] = checks
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: launches {res['launches']} (the checks' own {checks} "
        f"not counted); {res['phase_s']:.1f} s")
    missing = [k for k in ("ssd", "ssd_backward") if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"phase 11 never launched {missing}: "
                             f"{res['launches']}")
    if res["phase_s"] > PHASE11_LIMIT_S:
        raise AssertionError(f"phase 11 took {res['phase_s']:.1f} s, over "
                             f"its {PHASE11_LIMIT_S:.0f} s")
    return res


KERNELS = {    "beam_search": ("cuda", "src/repro_torch/csrc/beam_search.cu",
                    "src/repro/kernels/beam_search/kernel.py:188"),
    "merge_topk": ("cuda", "src/repro_torch/csrc/merge_topk.cu",
                   "src/repro/kernels/merge_topk/kernel.py:51"),
    "topk_distance": ("cuda", "src/repro_torch/csrc/topk_distance.cu",
                      "src/repro/kernels/topk_distance/kernel.py:99"),
    "quant_distance": ("cuda", "src/repro_torch/csrc/quant_distance.cu",
                       "src/repro/kernels/quant_distance/kernel.py:52"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:76"),
    "ssd": ("cuda", "src/repro_torch/csrc/ssd.cu",
            "src/repro/kernels/ssd/kernel.py:85"),
    # no Pallas counterpart: the JAX package differentiates the plain scan
    "ssd_backward": ("cuda", "src/repro_torch/csrc/ssd_backward.cu",
                     "none: JAX autodiff of src/repro/models/ssm.py:73"),
}


def summary_row(rows: list) -> dict:
    """A kernel's row for the summary line: of the rows with a library
    call, the one slowest against it; for a kernel without one, its first
    row (the main path's shape)."""
    timed = [r for r in rows if r["library_ms"] is not None]
    if not timed:
        return rows[0]
    return max(timed, key=lambda r: r["ms"] / r["library_ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000,
                    help="dataset rows of the Pyramid path (phase 4)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    result = {"environment": environment()}
    result["kernels"] = kernels_vs_plain(dev, args.n)
    result["small_index"] = small_index_agreement()
    result["main_path"], state = main_path(args.n, N_QUERIES,
                                           os.cpu_count() or 1)
    result["lm_float32_check"] = lm_float32_check(dev, "qwen3-1.7b")
    result["lm_path"] = lm_path(dev, "qwen3-1.7b")
    result["ssm_float32_check"] = lm_float32_check(dev, "mamba2-780m")
    # the examples run beside phase 6's host-bound datastore build
    examples = start_stream_examples()
    try:
        result["ssm_path"] = lm_path(dev, "mamba2-780m")
    except BaseException:
        for _, proc in examples.values():
            proc.kill()
        raise
    result["stream_examples"] = finish_stream_examples(examples)
    stream_s = (result["lm_float32_check"]["stream"]["seconds"]
                + result["lm_path"]["stream"]["seconds"]
                + result["ssm_path"]["stream"]["seconds"]
                + result["stream_examples"]["seconds"])
    log(f"streaming runs: {stream_s:.1f} s")
    if stream_s > STREAM_BUDGET_S:
        raise AssertionError(f"the streaming runs took {stream_s:.1f} s, "
                             f"past {STREAM_BUDGET_S} s")
    result["serving"] = serving_path(
        state, result["main_path"]["float32"]["recall@10"])
    result["store"], result["maintenance"] = store_path(state)
    result["multi_device"] = multi_device_path(state)
    result["training"] = training_path()
    result["lm_sliding"] = sliding_path(dev)
    result["wall_s"] = time.perf_counter() - t_start
    log(f"wall {result['wall_s']:.1f} s")

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        first = summary_row(result["kernels"][name])
        line.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": sum(result[phase]["launches"][name] for phase in
                            ("main_path", "lm_path", "ssm_path",
                             "serving", "store", "maintenance",
                             "multi_device", "training", "lm_sliding")),
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1,
                                                        default=str))
    log(result["environment"]["nvidia_smi"])
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
