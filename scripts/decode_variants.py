"""Time the port's flash-decode kernel (src/repro_torch/csrc/
decode_attention.cu) against another revision of its source, and the
merge kernel (src/repro_torch/csrc/merge_topk.cu) against another
revision of its wrapper, on one CUDA card, in one process.

    python3 scripts/decode_variants.py --other FILE [--tile T ...]
        [--merge-other FILE] [--rounds 6] [--profile]

FILE is an earlier revision of the source, saved with ``git show
REV:src/repro_torch/csrc/decode_attention.cu > _parent/decode_attention.cu``
(the directory is git-ignored; a copy of the repo that is not a git
repository cannot show it). Both versions are built with nvcc for sm_90a
and called at chip_smoke.py's phase-2 decode rows (8 slots x 1,024 rows
bf16 and float32 at random positions, 8 x 32,768 full, and phase 5's
served positions), each checked against the plain version, timed with
CUDA events over launches that rotate over copies of the cache (as
``check_decode`` does) in rounds that alternate the versions (tree,
other, other, tree, ...), least and median round kept, and their device
time a call read from ``torch.profiler``. A revision whose C interface
takes split scratch (``part_m``, ``part_l``, ``part_acc``) is launched as
its own wrapper did: its split count from the allocated cache and the
SM count, scratch allocated on every call. ``--tile T`` adds the tree
with tiles of T rows. ``--merge-other`` takes an earlier revision of
``src/repro_torch/kernels/merge_topk/ops.py`` (``git show
REV:src/repro_torch/kernels/merge_topk/ops.py > _parent/merge_ops.py``)
and times its ``merge_topk_cuda`` against the tree's at phase 2's merge
rows in the same way. ``--profile`` also builds the tree with
``-DDECODE_PROFILE`` and reports, for one launch a row, the blocks that
found work, the spread of their start times (from the card's global
timer), and the mean and largest time of each phase of a block: its
rows, writing its output or partial, the counter, and the merge of the
last span. Prints the card's name and
power limit, then one JSON object a row, and writes them to
``chiprun_out/decode_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# chip_smoke.check_decode's rows (decode_inputs keywords)
DECODE_ROWS = (dict(), dict(dtype="float32"), dict(s=32_768, pos="full"),
               dict(pos="served"))
MERGE_ROWS = ((1024, 160, 10), (1024, 640, 40), (1024, 1280, 80))


PHASES = ("rows", "output", "counter", "merge")


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
    return ctypes.CDLL(str(so))


def split_launcher(lib):
    """A call of a revision that combines splits in a second kernel, as
    its wrapper launched it."""
    import torch
    from repro_torch.common.device import sm_count
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.flash_decode_launch.restype = i

    def call(q, k, v, pos):
        b, h, hd = q.shape
        s, kvh = k.shape[1], k.shape[2]
        want = -(-4 * sm_count(k.device) // (b * kvh))
        splits = max(1, min(want, 64, -(-s // 256)))
        out = torch.empty((b, h, hd), dtype=torch.float32, device=k.device)
        g = h // kvh
        part_m = torch.empty((b * kvh, splits, g), dtype=torch.float32,
                             device=k.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((b * kvh, splits, g, hd),
                               dtype=torch.float32, device=k.device)
        err = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), b, s, h, kvh, hd,
            int(k.dtype == torch.bfloat16), splits,
            torch.cuda.current_stream(k.device).cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return call


def tree_launcher(lib, tile_rows: int = 0):
    """The tree's wrapper over ``lib``, with tiles of ``tile_rows`` rows
    (0: the tree's); ``call.plan(q, k)`` is the plan it launches."""
    from repro_torch.kernels.decode_attention import ops
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.flash_decode_launch.restype = i
    lib.flash_decode_blocks_per_sm.argtypes = [i] * 4
    lib.flash_decode_blocks_per_sm.restype = i
    plan = functools.partial(ops.decode_plan, tile_rows=tile_rows)

    def call(q, k, v, pos):
        saved = ops._lib, ops.decode_plan
        ops._lib, ops.decode_plan = lib, plan
        try:
            return ops.flash_decode_cuda(q, k, v, pos)
        finally:
            ops._lib, ops.decode_plan = saved

    def plan_of(q, k):
        saved = ops._lib, ops.decode_plan
        ops._lib, ops.decode_plan = lib, plan
        try:
            return ops.plan_for(q, k)
        finally:
            ops._lib, ops.decode_plan = saved
    call.plan = plan_of
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


def decode_rows(variants: dict, rounds: int) -> list:
    import torch
    import chip_smoke
    from repro_torch.kernels.decode_attention import decode_attention_ref
    dev = torch.device("cuda")
    rows = []
    for kw in DECODE_ROWS:
        q, k, v, pos = chip_smoke.decode_inputs(dev, **kw)
        ref = decode_attention_ref(q, k, v, pos)
        row = {"shape": f"B={k.shape[0]} S={k.shape[1]} "
                        f"{kw.get('dtype', 'bfloat16')} "
                        f"pos={kw.get('pos', 'random')}",
               **chip_smoke.decode_bound(k, pos, q.shape[0], q.shape[1])}
        launches = {}
        for name, fn in variants.items():
            out = fn(q, k, v, pos)
            torch.cuda.synchronize()
            row[f"{name}_max_abs_err"] = float((out - ref).abs().max())
            if not torch.allclose(out, ref, rtol=chip_smoke.DECODE_TOL,
                                  atol=chip_smoke.DECODE_TOL):
                raise AssertionError(f"{name} disagrees at {row['shape']}")
            launches[name] = chip_smoke.rotating(
                k, v, lambda kk, vv, fn=fn: fn(q, kk, vv, pos))[0]
        for name, (least, med) in alternate(
                launches, rounds,
                lambda f: chip_smoke.cuda_ms(f, 100)).items():
            row[f"{name}_ms"], row[f"{name}_ms_median"] = least, med
        for name, f in launches.items():
            row[f"{name}_device_ms"] = chip_smoke.device_kernels_of(
                f, 20, "flash_decode")[0]
        del launches
        torch.cuda.empty_cache()
        rows.append(row)
        chip_smoke.log(json.dumps(row))
    return rows


def profile_rows(lib) -> list:
    """One launch a decode row with the stamps of a profiling build."""
    import numpy as np
    import torch
    import chip_smoke
    lib.flash_decode_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flash_decode_profile.restype = ctypes.c_int
    call = tree_launcher(lib)
    dev = torch.device("cuda")
    rows = []
    for kw in DECODE_ROWS:
        q, k, v, pos = chip_smoke.decode_inputs(dev, **kw)
        b, h = q.shape[:2]
        plan = call.plan(q, k)
        blocks = b * k.shape[2] * plan.spans
        buf = np.zeros((blocks, 2 * (len(PHASES) + 1)), np.uint64)
        call(q, k, v, pos)
        torch.cuda.synchronize()
        lib.flash_decode_profile(buf.ctypes.data, blocks)   # zero them
        call(q, k, v, pos)
        torch.cuda.synchronize()
        if lib.flash_decode_profile(buf.ctypes.data, blocks):
            raise RuntimeError("reading the profile failed")
        ns = buf[:, 0::2].astype(np.float64)
        cyc = buf[:, 1::2].astype(np.float64)
        t0 = ns[:, 0].min()
        working = ns[:, 1] > 0           # blocks that read rows
        row = {"shape": f"B={b} S={k.shape[1]} "
                        f"{kw.get('dtype', 'bfloat16')} "
                        f"pos={kw.get('pos', 'random')}",
               "plan": plan._asdict(), "blocks": blocks,
               "working_blocks": int(working.sum()),
               "start_spread_ns": float(ns[:, 0].max() - t0),
               "working_start_spread_ns": float(ns[working, 0].max() - t0),
               "last_end_ns": float(ns[:, 1:].max() - t0)}
        for i, name in enumerate(PHASES):
            done = cyc[:, i + 1] > 0
            d_cyc = cyc[done, i + 1] - cyc[done, i]
            d_ns = ns[done, i + 1] - ns[done, i]
            if done.any():
                row[name] = {"blocks": int(done.sum()),
                             "mean_cycles": float(d_cyc.mean()),
                             "max_cycles": float(d_cyc.max()),
                             "mean_ns": float(d_ns.mean()),
                             "max_ns": float(d_ns.max())}
        rows.append(row)
        chip_smoke.log(json.dumps(row))
    return rows


def merge_rows(other_ops: Path, rounds: int) -> list:
    import torch
    import chip_smoke
    from repro_torch.kernels.merge_topk import merge_topk_cuda, merge_topk_ref
    spec = importlib.util.spec_from_file_location("other_merge_ops",
                                                  other_ops)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    dev = torch.device("cuda")
    variants = {"tree": merge_topk_cuda, "other": other.merge_topk_cuda}
    rows = []
    for b, m, k in MERGE_ROWS:
        g = torch.Generator(device=dev).manual_seed(1)
        scores = torch.randn(b, m, device=dev, generator=g)
        ids = torch.randint(-1, 4 * m, (b, m), device=dev, generator=g,
                            dtype=torch.int32)
        r_s, r_i = merge_topk_ref(scores, ids, k=k)
        row = {"shape": f"B={b} m={m} k={k}"}
        calls = {}
        for name, fn in variants.items():
            s_, i_ = fn(scores, ids, k=k)
            torch.cuda.synchronize()
            if not (torch.equal(s_, r_s) and torch.equal(i_, r_i)):
                raise AssertionError(f"merge {name} differs at {row['shape']}")
            calls[name] = functools.partial(fn, scores, ids, k=k)
        for name, (least, med) in alternate(
                calls, rounds, lambda f: chip_smoke.cuda_ms(f, 50)).items():
            row[f"{name}_ms"], row[f"{name}_ms_median"] = least, med
        for name, f in calls.items():
            row[f"{name}_device_ms"] = chip_smoke.device_kernels_of(
                f, 20, "merge")[0]
        rows.append(row)
        chip_smoke.log(json.dumps(row))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--tile", type=int, nargs="*", default=[])
    ap.add_argument("--merge-other", type=Path)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chip_smoke.log(smi)
    with tempfile.TemporaryDirectory() as tmp:
        tree = cuda_lib.load("decode_attention")
        other_src = args.other.read_text()
        other = build(other_src, Path(tmp) / "other_decode")
        variants = {"tree": tree_launcher(tree)}
        variants["other"] = (split_launcher(other) if "part_m" in other_src
                             else tree_launcher(other))
        for t in args.tile:
            variants[f"tree_T{t}"] = tree_launcher(tree, t)
        result = {"nvidia_smi": smi,
                  "decode": decode_rows(variants, args.rounds)}
        if args.profile:
            src = (ROOT / "src/repro_torch/csrc/decode_attention.cu"
                   ).read_text()
            result["profile"] = profile_rows(build(
                src, Path(tmp) / "profile_decode", ["-DDECODE_PROFILE"]))
    if args.merge_other:
        result["merge"] = merge_rows(args.merge_other, args.rounds)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_variants.json").write_text(json.dumps(result,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
