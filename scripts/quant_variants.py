"""Time the port's int8 distance kernel (src/repro_torch/csrc/
quant_distance.cu) against another revision of its source, on one CUDA
card, in one process.

    python3 scripts/quant_variants.py [--other FILE ...] [--rounds 6]
        [--n 50000] [--check-only] [--profile] [--error-n N]

FILE is an earlier revision of the source, saved with ``git show
REV:src/repro_torch/csrc/quant_distance.cu > _parent/quant_distance.cu``
(the directory is git-ignored; a copy of the repo that is not a git
repository cannot show it). Both keep the C interface
``quant_distance_launch`` and are launched through the tree's wrapper
``quant_scores_cuda``. Each is built with nvcc for sm_90a, checked
against the plain version (``quant_scores_ref``) to chip_smoke.py's gate
(1e-5 of the largest |score|; the count of scores outside rtol = atol =
1e-5 is recorded) at the card tests' wide shapes and at phase 2's rows:
phase 4's brute-force scan (1,024 queries against ``--n`` rows of phase
4's data, d = 128), the reference's roofline shape (B = 256, n = 16,384)
and the ragged 37 x 53 x 8, each under l2, ip and angular. Then it is
timed there with CUDA events over back-to-back launches in rounds that
alternate the versions (tree, other, other, tree, ...), least and median
round kept, and by its device time a call from ``torch.profiler``; the
plain version, ``torch.matmul`` of the queries against the already
dequantized rows (a different input, the yardstick) and a fill of a
tensor the size of the output (the card's write rate) are timed once a row.
The ``--other`` files are named ``other``, ``other1``, ... .
``--profile`` also builds the tree with ``-DQUANT_PROFILE`` and reports
the cycles of each phase of its producer and consumer warps at phase 4's
shape. ``--check-only`` stops after the checks. ``--error-n N`` also runs each
version through chip_smoke.py's error row (``quant_error_row``: l2
scores against float64 on phase 4's data at N rows, on each query's top
10 rows and over all rows, and query 45's near tie) and records whether
it passes the row's gate. Prints the card's name and power limit, then one
JSON object a row, and writes them to
``chiprun_out/quant_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

METRICS = ("l2", "ip", "angular")
# shapes that cross the kernel's tiles and slices (tests/test_torch_cuda.py
# QUANT_SHAPES and QUANT_WIDE_SHAPES)
CHECK_SHAPES = ((5, 24, 8), (130, 70, 16), (1, 8, 4), (37, 53, 8),
                (65, 129, 3), (1, 1, 1), (130, 300, 16), (257, 129, 8),
                (129, 257, 130), (33, 65, 2048), (200, 300, 128),
                (1, 5, 2048), (3, 5, 8320), (70, 200, 130))


def build(src: str, out: Path, flags=()):
    from repro_torch.kernels import cuda_lib
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    so = out.with_suffix(".so")
    proc = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, *flags,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr


def launcher(lib):
    """``quant_scores_cuda`` over ``lib``."""
    from repro_torch.kernels.quant_distance import ops
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_distance_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.quant_distance_launch.restype = i

    def call(q, codes, scale, zero, metric):
        saved = ops._lib
        ops._lib = lib
        try:
            return ops.quant_scores_cuda(q, codes, scale, zero,
                                         metric=metric)
        finally:
            ops._lib = saved
    return call


def alternate(fns: dict, rounds: int, timed) -> dict:
    """{name: (least, median)} of ``timed(fn)`` over ``rounds`` rounds
    that alternate the order of the versions."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(timed(fns[n]))
    return {n: (min(t), statistics.median(t)) for n, t in times.items()}


def held(name, out, ref, shape, metric) -> dict:
    import torch
    import chip_smoke
    diff = (out - ref).abs()
    err = float(diff.max())
    top = float(ref.abs().max())
    outside = int((diff > 1e-5 + 1e-5 * ref.abs()).sum())
    if not (out.shape == ref.shape and bool(torch.isfinite(out).all())
            and err <= chip_smoke.QUANT_TOL * top):
        raise AssertionError(f"{name} disagrees at {shape} {metric}: max "
                             f"abs err {err:.3g}, |score| <= {top:.3g}")
    return {f"{name}_max_abs_err": err, f"{name}_rel_err": err / top,
            f"{name}_outside_rtol_atol_1e-5": outside}


def check_rows(variants: dict) -> list:
    import torch
    import chip_smoke
    from repro_torch.kernels.quant_distance import quant_scores_ref
    dev = torch.device("cuda")
    rows = []
    for b, n, d in CHECK_SHAPES:
        for metric in METRICS:
            q, codes, scale, zero = chip_smoke.quant_inputs(
                dev, b, n, d, seed=b * n + d, phase4=False)
            ref = quant_scores_ref(q, codes, scale, zero, metric=metric)
            row = {"shape": f"B={b} n={n} d={d}", "metric": metric}
            for name, fn in variants.items():
                out = fn(q, codes, scale, zero, metric)
                torch.cuda.synchronize()
                row.update(held(name, out, ref, row["shape"], metric))
            rows.append(row)
    chip_smoke.log(json.dumps({"checked": len(rows), "worst_rel_err": {
        name: max(r[f"{name}_rel_err"] for r in rows) for name in variants}}))
    return rows


def timed_rows(variants: dict, n: int, rounds: int) -> list:
    import torch
    import chip_smoke
    from repro_torch.kernels.quant_distance import (dequantize,
                                                    quant_scores_ref)
    dev = torch.device("cuda")
    rows = []
    for b, rows_n, d in ((chip_smoke.N_QUERIES, n, 128), (256, 16_384, 128),
                         (37, 53, 8)):
        phase4 = (b, rows_n) == (chip_smoke.N_QUERIES, n)
        q, codes, scale, zero = chip_smoke.quant_inputs(
            dev, b, rows_n, d, seed=6, phase4=phase4)
        reps = 20 if b * rows_n > 1e6 else 200
        for metric in METRICS:
            ref = quant_scores_ref(q, codes, scale, zero, metric=metric)
            row = {"shape": f"B={b} n={rows_n} d={d}", "metric": metric,
                   **chip_smoke.quant_bounds(b, rows_n, d)}
            calls = {}
            for name, fn in variants.items():
                out = fn(q, codes, scale, zero, metric)
                torch.cuda.synchronize()
                row.update(held(name, out, ref, row["shape"], metric))
                del out
                calls[name] = (lambda fn=fn, m=metric:
                               fn(q, codes, scale, zero, m))
            del ref
            for name, (least, med) in alternate(
                    calls, rounds,
                    lambda f: chip_smoke.cuda_ms(f, reps)).items():
                row[f"{name}_ms"], row[f"{name}_ms_median"] = least, med
            for name, f in calls.items():
                row[f"{name}_device_ms"] = chip_smoke.device_kernels_of(
                    f, reps, "quant_distance")[0]
            row["plain_ms"] = chip_smoke.cuda_ms(
                lambda m=metric: quant_scores_ref(q, codes, scale, zero,
                                                  metric=m), 5)
            out = torch.empty((b, rows_n), dtype=torch.float32, device=dev)
            row["fill_output_ms"] = chip_smoke.cuda_ms(
                lambda: out.fill_(0.0), reps)
            del out
            rows_f = dequantize(codes, scale, zero)
            row["matmul_yardstick_ms"] = chip_smoke.cuda_ms(
                lambda: torch.matmul(q, rows_f.T), reps)
            del rows_f
            torch.cuda.empty_cache()
            rows.append(row)
            chip_smoke.log(json.dumps(row))
    return rows


CONSUMER_WARPS = 8


def profile_rows(lib, n: int) -> list:
    """Phase cycles of one launch a metric at phase 4's shape, from a
    ``-DQUANT_PROFILE`` build: the mean over blocks of the mean over the
    consumer (and producer) warps of each phase's cycles."""
    import numpy as np
    import torch
    import chip_smoke
    lib.quant_distance_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.quant_distance_profile.restype = ctypes.c_int
    lib.quant_distance_profile_phases.restype = ctypes.c_int
    lib.quant_distance_profile_warps.restype = ctypes.c_int
    phases = lib.quant_distance_profile_phases()
    warps = lib.quant_distance_profile_warps()
    call = launcher(lib)
    dev = torch.device("cuda")
    b = chip_smoke.N_QUERIES
    q, codes, scale, zero = chip_smoke.quant_inputs(dev, b, n, 128, seed=6,
                                                    phase4=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qtiles = -(-b // 128)
    blocks = max(1, sms // qtiles) * qtiles
    buf = np.zeros((blocks, warps, phases), np.uint64)
    rows = []
    for metric in METRICS:
        call(q, codes, scale, zero, metric)
        torch.cuda.synchronize()
        lib.quant_distance_profile(buf.ctypes.data, blocks)     # zero them
        call(q, codes, scale, zero, metric)
        torch.cuda.synchronize()
        if lib.quant_distance_profile(buf.ctypes.data, blocks):
            raise RuntimeError("reading the profile failed")
        cyc = buf.astype(np.float64)
        cons = cyc[:, :CONSUMER_WARPS].mean(axis=1).mean(axis=0)
        prod = cyc[:, CONSUMER_WARPS:].mean(axis=1).mean(axis=0)
        row = {"shape": f"B={b} n={n} d=128", "metric": metric,
               "blocks": blocks,
               "consumer_cycles": {"wait": cons[0], "products": cons[1],
                                   "epilogue": cons[2], "kernel": cons[3]},
               "producer_cycles": {"wait": prod[0], "convert": prod[1],
                                   "copies": prod[2], "kernel": prod[3]},
               "kernel_cycles_max": float(cyc[:, :, 3].max())}
        rows.append(row)
        chip_smoke.log(json.dumps(row))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, nargs="+", default=[])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n", type=int, default=50_000,
                    help="rows of phase 4's brute-force scan shape")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--error-n", type=int, default=0,
                    help="rows of phase 4's data for the error row")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chip_smoke.log(smi)
    result = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory() as tmp:
        variants = {"tree": launcher(cuda_lib.load("quant_distance"))}
        result["ptxas"] = {"tree": cuda_lib.build_log("quant_distance")}
        for i, path in enumerate(args.other):
            name = f"other{i or ''}"
            lib, log = build(path.read_text(), Path(tmp) / name)
            variants[name] = launcher(lib)
            result["ptxas"][name] = log
        for name, text in result["ptxas"].items():
            chip_smoke.log(f"{name}: " + " | ".join(
                ln.strip() for ln in text.splitlines()
                if any(w in ln for w in ("registers", "spill", "arning"))))
        result["checks"] = check_rows(variants)
        if args.error_n:
            result["error_rows"] = {
                name: chip_smoke.quant_error_row(
                    torch.device("cuda"), args.error_n, scores=fn)
                for name, fn in variants.items()}
            chip_smoke.log(json.dumps({name: row["passes"] for name, row
                                       in result["error_rows"].items()}))
        if not args.check_only:
            result["rows"] = timed_rows(variants, args.n, args.rounds)
        if args.profile:
            src = (ROOT / "src/repro_torch/csrc/quant_distance.cu"
                   ).read_text()
            lib, _ = build(src, Path(tmp) / "profile_quant",
                           ["-DQUANT_PROFILE"])
            result["profile"] = profile_rows(lib, args.n)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "quant_variants.json").write_text(json.dumps(result,
                                                            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
