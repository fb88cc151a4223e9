"""Time the port's flash-decode kernel (``flash_decode_cuda``,
src/repro_torch/csrc/decode_attention.cu) and merge kernel
(``merge_topk_cuda``, src/repro_torch/csrc/merge_topk.cu) of this tree
against those of another checkout, on one CUDA card.

    git archive REV src/repro_torch | tar -x -C _parent   # git-ignored
    python3 scripts/decode_variants.py [--other _parent] [--tile T ...]
        [--rounds 6] [--profile]

Each checkout runs in a worker process of its own with its ``src`` first
on the path, so each is built from its own source and launched through
its own wrapper and C interface; ``--tile T`` adds a worker of the tree
whose plan takes tiles of T rows. At chip_smoke.py's phase-2 decode rows
(8 slots x 1,024 rows bf16 and float32 at random positions, 8 x 32,768
full, and phase 5's served positions) each version is held against the
plain version within ``DECODE_TOL``, then timed with CUDA events over
launches that rotate over copies of the cache (as ``check_decode`` does)
in rounds that alternate the versions (tree, other, other, tree, ...),
least and median round kept, and by its device time a call from
``torch.profiler``; the merge kernel the same way at phase 2's merge
rows, its ids and scores equal to the plain version's. ``--profile``
also runs the tree built with ``-DDECODE_PROFILE`` and reports, for one
launch a row, the blocks that found work, the spread of their start
times (from the card's global timer), and the mean and largest time of
each phase of a block: its rows, writing its output or partial, the
counter, and the merge of the last span. Prints the card's name and
power limit, then one JSON object a row, and writes them to
``chiprun_out/decode_variants.json``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import statistics
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke.check_decode's rows (decode_inputs keywords)
DECODE_ROWS = (dict(), dict(dtype="float32"), dict(s=32_768, pos="full"),
               dict(pos="served"))
MERGE_ROWS = ((1024, 160, 10), (1024, 640, 40), (1024, 1280, 80))
PHASES = ("rows", "output", "counter", "merge")

_row = {}   # a worker's row: the launch that rotates over its inputs


def use_checkout(src: str, tile_rows: int, profile_dir: str) -> None:
    """A worker's start: its checkout's package imported first, before
    ``chip_smoke`` puts this tree's on the path; with ``tile_rows``, its
    plans take tiles of that many rows; with ``profile_dir``, its kernel
    is built there with ``-DDECODE_PROFILE``."""
    import functools
    sys.path.insert(0, src)
    from repro_torch.kernels.decode_attention import ops
    import repro_torch.kernels.merge_topk  # noqa: F401
    if tile_rows:
        ops.decode_plan = functools.partial(ops.decode_plan,
                                            tile_rows=tile_rows)
    if profile_dir:
        import ctypes
        from repro_torch.kernels import cuda_lib
        so = Path(profile_dir) / "libdecode_profile.so"
        subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS,
                        "-DDECODE_PROFILE", "-o", str(so),
                        str(cuda_lib.CSRC_DIR / "decode_attention.cu")],
                       check=True, capture_output=True)
        lib = ops.bind(ctypes.CDLL(str(so)))
        lib.flash_decode_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.flash_decode_profile.restype = ctypes.c_int
        ops._lib = lib


def _shape(kw: dict, k) -> str:
    return (f"B={k.shape[0]} S={k.shape[1]} {kw.get('dtype', 'bfloat16')} "
            f"pos={kw.get('pos', 'random')}")


def prepare_decode(kw: dict) -> dict:
    """In a worker: the row's inputs, the checkout's kernel held to the
    plain version on them, its bytes bound, and the launch that the
    timings call."""
    import torch
    import chip_smoke
    from repro_torch.kernels.decode_attention import (decode_attention_ref,
                                                      flash_decode_cuda)
    _row.clear()
    torch.cuda.empty_cache()
    q, k, v, pos = chip_smoke.decode_inputs(torch.device("cuda"), **kw)
    out = flash_decode_cuda(q, k, v, pos)
    ref = decode_attention_ref(q, k, v, pos)
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=chip_smoke.DECODE_TOL,
                          atol=chip_smoke.DECODE_TOL):
        raise AssertionError(f"flash_decode disagrees at {_shape(kw, k)}: "
                             f"{err}")
    _row["launch"] = chip_smoke.rotating(
        k, v, lambda kk, vv: flash_decode_cuda(q, kk, vv, pos))[0]
    return {"shape": _shape(kw, k), "max_abs_err": err,
            **chip_smoke.decode_bound(k, pos, q.shape[0], q.shape[1])}


def prepare_merge(b: int, m: int, k: int) -> dict:
    """In a worker: the merge row's inputs, the checkout's kernel equal
    to the plain version on them, and the launch that the timings call."""
    import functools
    import torch
    from repro_torch.kernels.merge_topk import merge_topk_cuda, merge_topk_ref
    _row.clear()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    scores = torch.randn(b, m, device=dev, generator=g)
    ids = torch.randint(-1, 4 * m, (b, m), device=dev, generator=g,
                        dtype=torch.int32)
    s_, i_ = merge_topk_cuda(scores, ids, k=k)
    r_s, r_i = merge_topk_ref(scores, ids, k=k)
    if not (torch.equal(s_, r_s) and torch.equal(i_, r_i)):
        raise AssertionError(f"merge_topk differs at B={b} m={m} k={k}")
    _row["launch"] = functools.partial(merge_topk_cuda, scores, ids, k=k)
    return {"shape": f"B={b} m={m} k={k}"}


def time_once(reps: int) -> float:
    import chip_smoke
    return chip_smoke.cuda_ms(_row["launch"], reps)


def device_time(reps: int, kernel: str) -> float:
    import chip_smoke
    return chip_smoke.device_kernels_of(_row["launch"], reps, kernel)[0]


def timed_row(workers: dict, prepare, args: tuple, reps: int, kernel: str,
              rounds: int) -> dict:
    """One row: each worker's version prepared and checked, then timed in
    alternating rounds and by its device time."""
    import chip_smoke
    row = {}
    for name, w in workers.items():
        got = w.submit(prepare, *args).result()
        if "max_abs_err" in got:
            row[f"{name}_max_abs_err"] = got.pop("max_abs_err")
        row.update(got)
    names = list(workers)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(workers[n].submit(time_once, reps).result())
    for n, t in times.items():
        row[f"{n}_ms"], row[f"{n}_ms_median"] = min(t), statistics.median(t)
        row[f"{n}_device_ms"] = workers[n].submit(device_time, 20,
                                                  kernel).result()
    chip_smoke.log(json.dumps(row))
    return row


def profile_rows() -> list:
    """In the profiling worker: one launch a decode row with the stamps
    of its blocks."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.kernels.decode_attention import ops
    lib = ops._lib
    rows = []
    for kw in DECODE_ROWS:
        q, k, v, pos = chip_smoke.decode_inputs(torch.device("cuda"), **kw)
        b, h, hd = q.shape
        kvh = k.shape[2]
        plan = ops.plan_for(q, k)
        lay = ops.kernel_layout(h, kvh, hd, k.dtype == torch.bfloat16)
        blocks = b * kvh * lay.slices * plan.spans
        buf = np.zeros((blocks, 2 * (len(PHASES) + 1)), np.uint64)
        ops.flash_decode_cuda(q, k, v, pos)
        torch.cuda.synchronize()
        lib.flash_decode_profile(buf.ctypes.data, blocks)   # zero them
        ops.flash_decode_cuda(q, k, v, pos)
        torch.cuda.synchronize()
        if lib.flash_decode_profile(buf.ctypes.data, blocks):
            raise RuntimeError("reading the profile failed")
        ns = buf[:, 0::2].astype(np.float64)
        cyc = buf[:, 1::2].astype(np.float64)
        t0 = ns[:, 0].min()
        working = ns[:, 1] > 0           # blocks that read rows
        row = {"shape": _shape(kw, k), "plan": plan._asdict(),
               "blocks": blocks, "working_blocks": int(working.sum()),
               "start_spread_ns": float(ns[:, 0].max() - t0),
               "working_start_spread_ns": float(ns[working, 0].max() - t0),
               "last_end_ns": float(ns[:, 1:].max() - t0)}
        for i, name in enumerate(PHASES):
            done = cyc[:, i + 1] > 0
            if done.any():
                d_cyc = cyc[done, i + 1] - cyc[done, i]
                d_ns = ns[done, i + 1] - ns[done, i]
                row[name] = {"blocks": int(done.sum()),
                             "mean_cycles": float(d_cyc.mean()),
                             "max_cycles": float(d_cyc.max()),
                             "mean_ns": float(d_ns.mean()),
                             "max_ns": float(d_ns.max())}
        rows.append(row)
        chip_smoke.log(json.dumps(row))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout, whose src/ "
                                    "holds its repro_torch")
    ap.add_argument("--tile", type=int, nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    chip_smoke.log(smi)
    tree = str(ROOT / "src")
    specs = {"tree": (tree, 0, "")}
    if args.other:
        specs["other"] = (str(Path(args.other).resolve() / "src"), 0, "")
    for t in args.tile:
        specs[f"tree_T{t}"] = (tree, t, "")
    ctx = multiprocessing.get_context("spawn")
    result = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory() as tmp:
        if args.profile:
            specs["profile"] = (tree, 0, tmp)
        workers = {name: ProcessPoolExecutor(1, mp_context=ctx,
                                             initializer=use_checkout,
                                             initargs=spec)
                   for name, spec in specs.items()}
        timed = {n: w for n, w in workers.items() if n != "profile"}
        try:
            result["decode"] = [
                timed_row(timed, prepare_decode, (kw,), 100, "flash_decode",
                          args.rounds) for kw in DECODE_ROWS]
            result["merge"] = [
                timed_row(timed, prepare_merge, shape, 50, "merge",
                          args.rounds) for shape in MERGE_ROWS]
            if args.profile:
                result["profile"] = workers["profile"].submit(
                    profile_rows).result()
        finally:
            for w in workers.values():
                w.shutdown()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_variants.json").write_text(json.dumps(result,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
