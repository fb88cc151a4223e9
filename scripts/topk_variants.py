"""Time the port's top-k scan kernel (src/repro_torch/csrc/topk_distance.cu)
against versions of it on one CUDA card, in one process.

Versions: ``tree``, the kernel as it stands; ``no_prefilter``, the same
source with the lower-bound cut of a tile's candidates (k <= 32) switched
off; and with ``--other FILE`` that file's kernel (an earlier revision,
taken with ``git show REV:src/repro_torch/csrc/topk_distance.cu``; its
``topk_launch`` may lack the slice arguments). Each is built with nvcc for
sm_90a and called through ``topk_similarity_cuda``, checked against the
plain version (share of ids equal), and timed with CUDA events, 50 calls
a round, in rounds that alternate the versions; the least round mean is
kept, beside one PyTorch call for the same function (``addmm`` or
``matmul``, then ``topk``). Prints the card's name and power limit, then
one JSON object a shape.

    python3 scripts/topk_variants.py [--other FILE] [--rounds 3]
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

PREFILTER = "if (K <= 32 && m > K) {"
SHAPES = ((4096, 1000, 128, 1, "l2"), (4096, 1000, 128, 16, "ip"),
          (4096, 1000, 128, 20, "l2"), (4096, 1000, 128, 256, "ip"),
          (20_000, 1000, 128, 16, "l2"), (400, 32, 2048, 1, "l2"),
          (400, 32, 2048, 16, "ip"))


class _NoSlices:
    """A kernel library whose ``topk_launch`` predates the slice
    arguments: drops them (the wrapper passes 1 slice where it has one
    database tile, so such a kernel walks all of d itself)."""

    def __init__(self, lib):
        self.lib = lib

    def topk_launch(self, *args):
        return self.lib.topk_launch(*args[:-3], args[-1])


def build(src: str, out: Path):
    from repro_torch.kernels import cuda_lib
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    so = out.with_suffix(".so")
    return subprocess.Popen([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                             str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def load(so: Path, src: str):
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    sliced = "int slices" in src
    lib.topk_launch.argtypes = [p] * 8 + [i] * (9 if sliced else 7) + [p]
    lib.topk_launch.restype = i
    return lib if sliced else _NoSlices(lib)


def cuda_ms(fn, reps: int) -> float:
    import torch
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.kernels.topk_distance.ops as ops
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = (ROOT / "src/repro_torch/csrc/topk_distance.cu").read_text()
    if tree.count(PREFILTER) != 1:
        raise SystemExit("the prefilter's line is not in the kernel")
    sources = {"tree": tree,
               "no_prefilter": tree.replace(PREFILTER,
                                            "if (false && " + PREFILTER[4:])}
    if args.other is not None:
        sources["other"] = args.other.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        started = {v: build(src, Path(tmp) / v) for v, src in sources.items()}
        libs = {}
        for v, (proc, so) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {v}:\n{out}")
            libs[v] = load(so, sources[v])
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        dev = torch.device("cuda")
        names = list(libs)
        for b, n, d, k, metric in SHAPES:
            g = torch.Generator(device=dev).manual_seed(2)
            q = torch.randn(b, d, device=dev, generator=g)
            x = torch.randn(n, d, device=dev, generator=g)
            _, r_i = ops.topk_similarity_ref(q, x, k=k, metric=metric)
            row = {"shape": f"B={b} n={n} d={d} k={k}", "metric": metric}

            def call():
                return ops.topk_similarity_cuda(q, x, k=k, metric=metric)
            rounds = {v: [] for v in names}
            for v in names:
                ops._lib = libs[v]
                row[f"{v}_ids_equal"] = float((call()[1] == r_i).float()
                                              .mean())
            for _ in range(args.rounds):
                for v in names + names[::-1]:
                    ops._lib = libs[v]
                    rounds[v].append(cuda_ms(call, 50))
            for v in names:
                row[f"{v}_ms"] = min(rounds[v])
            xn = -(x * x).sum(dim=1)
            if metric == "l2":
                def lib():
                    return torch.topk(torch.addmm(xn, q, x.T, alpha=2.0), k)
            else:
                def lib():
                    return torch.topk(q @ x.T, k)
            row["library_ms"] = min(cuda_ms(lib, 50)
                                    for _ in range(args.rounds))
            print(json.dumps(row), flush=True)
        ops._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
