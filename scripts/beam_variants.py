"""Time the port's beam-walk kernel (src/repro_torch/csrc/beam_search.cu)
against another revision of its source on one CUDA card, in one process.

    python3 scripts/beam_variants.py --other FILE [--rounds 3] [--plans]
        [--profile]

FILE is an earlier revision of the source, saved with ``git show
REV:src/repro_torch/csrc/beam_search.cu > _parent/beam_search.cu`` (the
directory is git-ignored; a copy of the repo that is not a git
repository cannot show it). Both versions are built with nvcc for sm_90a
and called through ``beam_search_cuda`` at the beam_search rows of
``chip_smoke.py``'s phase 2 (``beam_rows``), each checked against the
plain version (share of ids equal) and timed with CUDA events, in rounds
that alternate the versions (tree, other, other, tree, ...); the least
round mean is kept. A revision whose launch takes warps a block, one walk
a warp, instead of the tree's block plan is launched with the most of 4,
2 and 1 warps whose shared memory fits, as its own wrapper chose.
``--plans`` adds the tree under other block plans: ``whole_rows``,
``half_rows`` and ``quarter_rows`` (all, a half or a quarter of an
expansion's rows a staging pass, one buffer: the less shared memory a
walk, the more walks an SM),
``one_warp`` and ``two_warps`` (one warp a walk, at least two, at every
S * C), and ``sliced`` (the staging a launch of more walks than SMs
gets: slices of d for rows too wide for 32 KB). ``--profile`` also builds the tree with ``-DBEAM_PROFILE`` and
reports, per row, the clock cycles an expansion spends in each phase of
warp 0 (select and visited test, the barrier after it, gather and score,
cut and sort, insertion search, in-place merge) and the share of
expansions whose adjacency row was prefetched. Prints the card's
name and power limit, then one JSON object a row, and writes them to
``chiprun_out/beam_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


class _WarpPerWalk:
    """A kernel library whose launch takes warps a block (one walk a
    warp): answers the tree's wrapper, which asks for its block plan's
    shared memory and launches with its plan."""

    def __init__(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.beam_search_launch.argtypes = [p, i, p, p, p, p, p, p, p, p] + \
            [i] * 9 + [p]
        lib.beam_search_launch.restype = i
        lib.beam_search_smem_bytes.argtypes = [i] * 7
        lib.beam_search_smem_bytes.restype = ctypes.c_longlong
        self.lib = lib

    def beam_search_smem_bytes(self, *args):
        from repro_torch.kernels.beam_search.ops import layout_bytes
        return layout_bytes(*args)

    def beam_search_launch(self, *args):
        from repro_torch.kernels.beam_search.ops import SMEM_MAX_BYTES
        quantized, vis, n, d, m0, efp = (args[1], args[9], args[11],
                                         args[12], args[13], args[15])
        words = (n + 31) // 32
        for warps in (4, 2, 1):
            if self.lib.beam_search_smem_bytes(
                    d, efp, m0, words, int(vis is None), quantized,
                    warps) <= SMEM_MAX_BYTES:
                break
        return self.lib.beam_search_launch(*args[:18], warps, args[-1])


PHASES = ("select_visit", "barrier", "gather_score", "cut_sort",
          "insert_search", "merge")


def build(src: str, out: Path, flags=()):
    from repro_torch.kernels import cuda_lib
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    so = out.with_suffix(".so")
    return subprocess.Popen([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, *flags,
                             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so: Path, src: str):
    lib = ctypes.CDLL(str(so))
    if "stage_rows" not in src:
        return _WarpPerWalk(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.beam_search_launch.argtypes = [p, i, p, p, p, p, p, p, p, p] + \
        [i] * 14 + [p]
    lib.beam_search_launch.restype = i
    lib.beam_search_smem_bytes.argtypes = [i] * 9
    lib.beam_search_smem_bytes.restype = ctypes.c_longlong
    return lib


def plan_variant(name: str):
    """``walk_plan`` under another block plan (see the module note)."""
    from repro_torch.kernels.beam_search import ops
    base = ops.walk_plan

    def plan(walks, n, d, efp, m0, quantized, sms):
        p = base(walks, n, d, efp, m0, quantized, sms)
        if name == "one_warp":
            return p._replace(warps=1)
        if name == "two_warps":
            return p._replace(warps=max(2, p.warps))
        if name == "sliced":
            return base(max(walks, sms + 1), n, d, efp, m0, quantized,
                        sms)._replace(warps=p.warps)
        if p.slice_cols != d:
            return p
        rows = -(-m0 // {"whole_rows": 1, "half_rows": 2,
                         "quarter_rows": 4}[name])
        words = (n + 31) // 32
        return p._replace(stage_rows=rows, smem_bytes=ops.layout_bytes(
            d, efp, m0, words, p.vis_shared, quantized, rows, p.slice_cols,
            1))
    return plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--n", type=int, default=50_000,
                    help="rows of chip_smoke.py's Pyramid path (sets the "
                         "executor row's shard)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import repro_torch.kernels.beam_search.ops as ops
    from repro_torch.kernels.beam_search import beam_search_cuda
    from repro_torch.kernels.beam_search import beam_search_ref
    tree = (ROOT / "src/repro_torch/csrc/beam_search.cu").read_text()
    sources = {"tree": tree, "other": args.other.read_text()}
    if args.profile:
        sources["profile"] = tree
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        started = {v: build(src, Path(tmp) / v, ["-DBEAM_PROFILE"]
                            if v == "profile" else [])
                   for v, src in sources.items()}
        libs = {}
        for v, (proc, so) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {v}:\n{out}")
            libs[v] = load(so, sources[v])
        prof = libs.pop("profile", None)
        plans = {v: ops.walk_plan for v in libs}
        if args.plans:
            for v in ("whole_rows", "half_rows", "quarter_rows", "one_warp",
                      "two_warps", "sliced"):
                libs[v] = libs["tree"]
                plans[v] = plan_variant(v)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(smi, flush=True)
        dev = torch.device("cuda")
        names = list(libs)
        for kw in chip_smoke.beam_rows(args.n):
            x, bottom, q, e, walk = chip_smoke.beam_inputs(dev, **kw)
            _, r_i = beam_search_ref(x, bottom, q, e, **walk)
            row = {"shape": f"S={x.shape[0]} n={x.shape[1]} d={x.shape[2]} "
                            f"M0={bottom.shape[2]} C={q.shape[1]} "
                            f"ef={walk['ef']}",
                   "dtype": "int8" if kw["quantized"] else "float32",
                   "metric": kw["metric"]}

            def call():
                return beam_search_cuda(x, bottom, q, e, **walk)

            def use(v):
                ops._lib, ops.walk_plan = libs[v], plans[v]
            for v in names:
                use(v)
                row[f"{v}_ids_equal"] = float((call()[1] == r_i).float()
                                              .mean())
                torch.cuda.synchronize()
            use("tree")
            reps = max(3, int(60.0 / max(chip_smoke.cuda_ms(call, 1), 0.01)))
            rounds = {v: [] for v in names}
            for _ in range(args.rounds):
                for v in names + names[::-1]:
                    use(v)
                    rounds[v].append(chip_smoke.cuda_ms(call, reps))
            for v in names:
                row[f"{v}_ms"] = min(rounds[v])
                row[f"{v}_rounds_ms"] = rounds[v]
            row["tree_over_other"] = row["tree_ms"] / row["other_ms"]
            if prof is not None:
                counts = (ctypes.c_ulonglong * 8)()
                ops._lib, ops.walk_plan = prof, plans["tree"]
                prof.beam_search_profile(counts)
                call()
                torch.cuda.synchronize()
                prof.beam_search_profile(counts)
                expansions = max(1, counts[7])
                row["expansions"] = counts[7]
                row["cycles_per_expansion"] = {
                    name: counts[i] / expansions
                    for i, name in enumerate(PHASES)}
                row["prefetch_hit_share"] = counts[6] / expansions
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, bottom, q, e
            torch.cuda.empty_cache()
        ops._lib, ops.walk_plan = None, plans["tree"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "beam_variants.json").write_text(json.dumps(
        {"device": smi, "rounds": args.rounds, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
