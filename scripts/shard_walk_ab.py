"""Time ``search_single_host`` with the tree's ``shard_search`` against
another revision's, on one CUDA card, in one process.

    python3 scripts/shard_walk_ab.py --other FILE [--n 50000] [--rounds 3]

FILE is an earlier revision of ``src/repro_torch/core/arena.py``, saved
with ``git show REV:src/repro_torch/core/arena.py > _parent/arena.py``
(the directory is git-ignored; a copy of the repo that is not a git
repository cannot show it). The script builds ``chip_smoke.py``'s phase-4
index (``clustered_vectors(N, 128)``, ``PyramidConfig()``, the 5% tag
filter) once, then searches its 1,024 queries in float32, int8 (rerank
factor 4) and filtered, with the arena module's ``shard_search`` set to
the tree's or the other's in turn: the answers must be equal; each round
times 5 synced batches of each version, in the order other, tree, tree,
other. Then it profiles three int8 batches of each version on the host
(``cProfile``, top functions by own time). Prints the card's name and
power limit, one JSON object a search mode (least and median batch ms),
the profiles, and writes the rows to ``chiprun_out/shard_walk_ab.json``.
"""
from __future__ import annotations

import argparse
import cProfile
import importlib.util
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import repro_torch.core.arena as arena
    from repro_torch.build import build_pyramid_index_parallel
    from repro_torch.common.config import PyramidConfig
    from repro_torch.core.distributed import search_single_host
    from repro_torch.data.synthetic import clustered_vectors, query_set

    chip_smoke.environment()
    spec = importlib.util.spec_from_file_location("other_arena", args.other)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    fns = {"other": other.shard_search, "tree": arena.shard_search}

    n = args.n
    x = clustered_vectors(n, 128, 1000, seed=0)
    q = query_set(x, chip_smoke.N_QUERIES, seed=1)
    t0 = time.perf_counter()
    index = build_pyramid_index_parallel(x, PyramidConfig(), workers=8)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    tags = np.full(n, 2, np.int64)
    tags[rng.random(n) < 0.05] |= 1
    for g in index.subs:
        g.tags = tags[g.ids]
    index.invalidate_device_cache()

    modes = {"float32": dict(), "int8": dict(quantize=True, rerank_factor=4),
             "filtered": dict(filter_tags=1)}
    rows = []
    for name, kw in modes.items():
        answers = {}
        for v, fn in fns.items():
            arena.shard_search = fn
            answers[v] = search_single_host(index, q, 10, **kw)[0]
        if not np.array_equal(answers["other"], answers["tree"]):
            raise AssertionError(f"{name}: the two versions answer apart")
        times = {v: [] for v in fns}
        for _ in range(args.rounds):
            for v in ("other", "tree", "tree", "other"):
                arena.shard_search = fns[v]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    search_single_host(index, q, 10, **kw)
                torch.cuda.synchronize()
                times[v].append((time.perf_counter() - t0) / 5 * 1e3)
        row = {"mode": name}
        for v, t in times.items():
            row[f"{v}_min_ms"] = min(t)
            row[f"{v}_median_ms"] = float(np.median(t))
            row[f"{v}_rounds_ms"] = t
        print(json.dumps(row), flush=True)
        rows.append(row)
    for v, fn in fns.items():
        arena.shard_search = fn
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(3):
            search_single_host(index, q, 10, **modes["int8"])
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(6)
        print(f"{v}, three int8 batches on the host:\n{out.getvalue()}",
              flush=True)
    arena.shard_search = fns["tree"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "shard_walk_ab.json").write_text(json.dumps(
        {"device": smi, "n": n, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
