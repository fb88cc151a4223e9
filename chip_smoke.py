"""Drive the PyTorch/CUDA port of the Pyramid index on one NVIDIA GPU.

    python3 chip_smoke.py [--n 100000]

Phases, each raising on failure (the script then exits non-zero):

  1. environment: the card's name and power limit, torch and CUDA
     versions, and the kernels' build from the sources in ``src/``
     (``nvcc`` for each CUDA source; Triton kernels compile at first
     launch);
  2. kernels against their plain PyTorch versions on the card, at the
     main path's shapes, with their times from CUDA events, their bounds
     and, where one exists, a PyTorch library call's time;
  3. a small index searched on the card and on the CPU (plain versions),
     float32, int8 and filtered: the answers must agree;
  4. the main path: ``build_pyramid_index_parallel`` on
     ``clustered_vectors(N, 128)`` with the paper's index parameters,
     then ``search_single_host`` on float32, int8 (rerank factor 4) and a
     filtered batch, each answer checked (well formed, exact scores of
     the rows returned, only alive rows under the filter), with recall@10
     against brute force, QPS, access rate, peak device memory and every
     kernel's launch count.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
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

# kernel vs plain: share of equal ids, and score tolerance on equal ids
# (the kernel sums each dot product in another order than cuBLAS)
IDS_EQUAL_MIN = 0.999
N_QUERIES = 1024
RTOL, ATOL = 1e-5, 1e-4


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
    for name in cuda_lib.sources():
        cuda_lib.load(name)
        usage = [ln.strip() for ln in cuda_lib.build_log(name).splitlines()
                 if "Used" in ln or "spill" in ln]
        log(f"nvcc {name}.cu: " + " | ".join(usage))
    build_s = time.perf_counter() - t0
    log(f"kernel build (nvcc): {build_s:.2f} s")
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc_build_s": build_s}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_beam(dev, metric: str, quantized: bool, *, s: int = 16,
               n: int = 65_536, c: int = 256, ef: int = 100,
               seed: int = 0) -> dict:
    """S graphs of n rows (16 x 65,536 is a 1M-row arena), d=128, M0=32,
    C query slots each, on random -1-padded graphs."""
    import torch
    from repro_torch.kernels.beam_search import (beam_search_cuda,
                                                 beam_search_ref)
    d, m0, max_iters = 128, 32, 400
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
    kw = dict(metric=metric, ef=ef, max_iters=max_iters, scale=scale,
              zero=zero)
    s_k, i_k = beam_search_cuda(x, bottom, q, e, **kw)
    s_r, i_r, expansions, scored, rows, adj_rows = beam_search_ref(
        x, bottom, q, e, return_work=True, **kw)
    out = compare(f"beam_search {metric} {'int8' if quantized else 'f32'} "
                  f"ef={ef}", i_k, i_r, s_k, s_r)
    out["ms"] = cuda_ms(lambda: beam_search_cuda(x, bottom, q, e, **kw), 3)
    out["plain_ms"] = cuda_ms(lambda: beam_search_ref(x, bottom, q, e, **kw),
                              1, warmup=0)
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


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    out["ms"] = cuda_ms(lambda: merge_topk_cuda(scores, ids, k=k), 20)
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


def kernels_vs_plain(dev) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"beam_search": [], "merge_topk": [], "topk_distance": []}
    # the shard walk's shape (ef=100), then the filtered shard walk's
    # (ef = 100 x the inflation cap 8, n near the main path's largest
    # shard) and the routing walk's over the meta-HNSW (1,000 centres)
    beams = [dict(metric=m, quantized=qz) for qz in (False, True)
             for m in ("l2", "ip", "angular")]
    beams += [dict(metric="l2", quantized=False, n=16_384, c=512, ef=800),
              dict(metric="l2", quantized=False, s=1, n=1000, c=1024, ef=64)]
    for kw in beams:
        r = check_beam(dev, **kw)
        res["beam_search"].append(r)
        log(f"beam_search {r['dtype']} {r['metric']} {r['shape']}: ids "
            f"equal {r['ids_equal']:.5f} max err {r['max_abs_err']:.3g} "
            f"kernel {r['ms']:.3f} ms plain {r['plain_ms']:.1f} ms "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    # the merges of a float32, an int8 (rerank factor 4) and a filtered
    # (inflation 8) batch: m = w * k_search over w = 16 shards
    for m, k in ((160, 10), (640, 40), (1280, 80)):
        r = check_merge(dev, 1024, m, k)
        res["merge_topk"].append(r)
        log(f"merge_topk m={m} k={k}: ids equal {r['ids_equal']:.5f} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms "
            f"bound {r['bound_ms']:.5f} ms")
    for k, metric in ((1, "l2"), (16, "ip")):
        r = check_topk(dev, 4096, 1000, 128, k, metric)
        res["topk_distance"].append(r)
        log(f"topk_distance k={k} {metric}: ids equal {r['ids_equal']:.5f} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"library {r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms")
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


def device_breakdown(fn, batch_s: float) -> dict:
    """Device time of one call under ``torch.profiler``: total kernel time,
    its share of the call's unprofiled wall time (the rest is the card
    idling on the host), and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1])
    device_us = sum(t for _, t in per_kernel)
    if device_us == 0:
        log("profiler saw no device time")
    return {"device_ms": device_us / 1e3,
            "busy_share": device_us / 1e6 / batch_s,
            "top_kernels_ms": {k[:80]: t / 1e3 for k, t in per_kernel[:8]}}


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
    for name, kw in runs.items():
        before = launch_counts()
        t0 = time.perf_counter()
        ids, scores, mask = search_single_host(index, q, k, **kw)
        first_s = time.perf_counter() - t0
        check_answer(name, ids, scores, x, q, k,
                     alive=(tags & 1) != 0 if name == "filtered" else None)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            ids2, _, _ = search_single_host(index, q, k, **kw)
        dt = (time.perf_counter() - t0) / reps
        if not np.array_equal(ids, ids2):
            raise AssertionError(f"{name}: repeated search differs")
        after = launch_counts()
        rec = recall_at(ids, truth_f if name == "filtered" else truth)
        res[name] = {"recall@10": rec, "qps": n_queries / dt,
                     "batch_s": dt, "first_call_s": first_s,
                     "access_rate": access_rate(torch.as_tensor(mask)),
                     "launches_per_batch": {
                         key: (after[key] - before[key]) // (reps + 1)
                         for key in after}}
        res[name]["device"] = device_breakdown(
            lambda: search_single_host(index, q, k, **kw), dt)
        log(f"search {name}: recall@10 {rec:.4f} QPS "
            f"{res[name]['qps']:.1f} ({dt * 1e3:.1f} ms / batch of "
            f"{n_queries}) access rate {res[name]['access_rate']:.4f} "
            f"launches per batch {res[name]['launches_per_batch']} device "
            f"{res[name]['device']}")
    res["launches"] = launch_counts()
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    log(f"main path launches {res['launches']} peak device memory "
        f"{res['peak_device_bytes'] / 2 ** 30:.2f} GiB")
    if any(v <= 0 for v in res["launches"].values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{res['launches']}")
    if res["float32"]["recall@10"] < 0.90:
        raise AssertionError("float32 recall@10 below 0.90")
    if res["int8"]["recall@10"] < res["float32"]["recall@10"] - 0.01:
        raise AssertionError("int8 recall@10 more than 0.01 below float32")
    return res


KERNELS = {
    "beam_search": ("cuda", "src/repro_torch/csrc/beam_search.cu",
                    "src/repro/kernels/beam_search/kernel.py:188"),
    "merge_topk": ("triton", "src/repro_torch/kernels/merge_topk/ops.py",
                   "src/repro/kernels/merge_topk/kernel.py:51"),
    "topk_distance": ("triton",
                      "src/repro_torch/kernels/topk_distance/ops.py",
                      "src/repro/kernels/topk_distance/kernel.py:99"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000,
                    help="dataset rows of the main path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    result = {"environment": environment()}
    result["kernels"] = kernels_vs_plain(dev)
    result["small_index"] = small_index_agreement()
    result["main_path"] = main_path(args.n, N_QUERIES, os.cpu_count() or 1)
    result["wall_s"] = time.perf_counter() - t_start
    log(f"wall {result['wall_s']:.1f} s")

    line = []
    for name, (route, source, replaces) in KERNELS.items():
        first = result["kernels"][name][0]
        line.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": result["main_path"]["launches"][name],
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
