"""Time the SSD scan's backward (``ssd_backward_cuda``, src/repro_torch/
csrc/ssd_backward.cu) of this tree against that of another checkout, on
one CUDA card.

    git archive REV src/repro_torch | tar -x -C _parent   # git-ignored
    python3 scripts/ssd_backward_variants.py [--other _parent] [--rounds 4]

Each checkout runs in a worker process of its own with its ``src`` first
on the path, so each is built from its own source and launched through
its own wrapper and C interface. At phase 2's rows (mamba2-780m's layer
at B = 4, S = 640 in bf16 and float32; B = 1, S = 513 and B = 4,
S = 4,096 in bf16; inputs made as ``chip_smoke.check_ssd_backward``
makes them) each version is held to autograd through the plain scan on
float64 copies of the inputs, within ``SSD_BWD_TOL`` of each output's
largest |value| (``SSD_BWD_TOL_BF16`` for bf16 outputs), a second call
equal bit for bit. Then each is timed with CUDA events over launches that
rotate over copies of the inputs exceeding the L2 four times, in rounds
that alternate the versions (tree, other, other, tree, ...), least and
median kept, and by its device time a call and by stage from
``torch.profiler``. Prints the card's name and power limit, then one JSON
object a row, and writes them to ``chiprun_out/ssd_backward_variants.json``
(nvcc's report of the tree's build, registers and spills of each stage,
to ``chiprun_out/ssd_backward_build.log``).
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

# phase 2's rows: (B, S, dtype)
TIMED = ((4, 640, "bfloat16"), (1, 513, "bfloat16"), (4, 4096, "bfloat16"),
         (4, 640, "float32"))
H, P, N, CHUNK = 48, 64, 128, 256

_row = {}   # a worker's row: the launch that rotates over its inputs


def use_checkout(src: str) -> None:
    """A worker's start: its checkout's package imported first, before
    ``chip_smoke`` puts this tree's on the path."""
    sys.path.insert(0, src)
    import repro_torch.kernels.ssd  # noqa: F401


def prepare(b: int, s: int, dtype: str, seed: int = 5) -> dict:
    """In a worker: the row's inputs, the checkout's kernel held to
    float64 on them (each output's error share and whether it is bf16,
    whether a second call repeats), the row's bytes, and the launch that
    the timings call."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import ssd_backward_cuda, ssd_backward_ref
    import chip_smoke
    _row.clear()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    dt_ = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, s, H, P, device=dev, generator=g).to(dt_)
    dt = F.softplus(torch.randn(b, s, H, device=dev, generator=g))
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    bc = torch.randn(b, s, 2 * N, device=dev, generator=g).to(dt_)
    dy = torch.randn(b, s, H, P, device=dev, generator=g)

    def call(xx, dd, bb, yy):
        return ssd_backward_cuda(xx, dd, a, bb[..., :N], bb[..., N:], yy,
                                 chunk=CHUNK)
    out = call(x, dt, bc, dy)
    bcd = bc.double()
    truth = ssd_backward_ref(x.double(), dt.double(), a.double(),
                             bcd[..., :N], bcd[..., N:], dy.double(),
                             chunk=CHUNK)
    shares = [float((o.double() - t).abs().max()) / (float(t.abs().max())
                                                      or 1.0)
              for o, t in zip(out, truth)]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    again = call(x, dt, bc, dy)
    repeats = all(torch.equal(u, v) for u, v in zip(out, again))
    in_bytes = x.nbytes + dt.nbytes + bc.nbytes + dy.nbytes
    nbytes = in_bytes + a.nbytes + sum(o.nbytes for o in out)
    bf16 = [o.dtype == torch.bfloat16 for o in out]
    del out, again, truth, bcd
    torch.cuda.empty_cache()
    copies = max(1, -(-int(4 * chip_smoke.L2_BYTES) // in_bytes))
    pool = [(x, dt, bc, dy)] + [tuple(t.clone() for t in (x, dt, bc, dy))
                                for _ in range(copies - 1)]
    it = itertools.cycle(pool)
    _row["launch"] = lambda: call(*next(it))
    return {"err_share": shares, "bf16": bf16, "finite": finite,
            "repeats": repeats, "bytes": nbytes, "input_copies": copies}


def time_once(reps: int) -> float:
    import chip_smoke
    return chip_smoke.cuda_ms(_row["launch"], reps)


def device_time(reps: int):
    import chip_smoke
    return chip_smoke.device_kernels_of(_row["launch"], reps, "ssdb_kernel")


def timed_row(workers: dict, b: int, s: int, dtype: str,
              rounds: int) -> dict:
    import chip_smoke
    from repro_torch.kernels.ssd import SSD_BWD_TOL, SSD_BWD_TOL_BF16
    row = {"shape": f"B={b} S={s} H={H} P={P} N={N} chunk={CHUNK} {dtype}"}
    for name, w in workers.items():
        got = w.submit(prepare, b, s, dtype).result()
        ok = got["finite"] and got["repeats"] and all(
            e <= (SSD_BWD_TOL_BF16 if bf else SSD_BWD_TOL)
            for e, bf in zip(got["err_share"], got["bf16"]))
        if not ok:
            raise AssertionError(f"{name} {row['shape']}: {got}")
        row[f"{name}_err_share"] = dict(zip(
            ("dx", "ddt", "da", "db", "dc", "dinit"), got["err_share"]))
        row.update(bytes=got["bytes"], input_copies=got["input_copies"])
    reps = 5 if s > 1000 else 10
    times = {name: [] for name in workers}
    for r in range(rounds):
        for name in (list(workers) if r % 2 == 0 else list(workers)[::-1]):
            times[name].append(workers[name].submit(time_once, reps).result())
    for name, t in times.items():
        row[f"{name}_ms"], row[f"{name}_ms_median"] = \
            min(t), statistics.median(t)
        dev_ms, per_call, stages = workers[name].submit(
            device_time, max(3, reps // 2)).result()
        row[f"{name}_device_ms"] = dev_ms
        row[f"{name}_kernels_per_call"] = per_call
        row[f"{name}_stage_device_ms"] = stages
    ops = chip_smoke.ssd_backward_ops(b, s, H, P, N, CHUNK)
    nbytes = row["bytes"]
    row.update(ops=ops, **chip_smoke.bound(nbytes, ops,
                                           chip_smoke.ssd_flops(dtype)),
               bytes_bound_ms=nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
               fp32_fma_bound_ms=ops / chip_smoke.FP32_FLOPS * 1e3)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout, whose src/ "
                                    "holds its repro_torch")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import cuda_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    chip_smoke.log(smi)
    trees = {"tree": ROOT / "src"}
    if args.other:
        trees["other"] = Path(args.other).resolve() / "src"
    ctx = multiprocessing.get_context("spawn")
    workers = {name: ProcessPoolExecutor(1, mp_context=ctx,
                                         initializer=use_checkout,
                                         initargs=(str(src),))
               for name, src in trees.items()}
    rows = []
    try:
        for b, s, dtype in TIMED:
            rows.append(timed_row(workers, b, s, dtype, args.rounds))
            chip_smoke.log(json.dumps(rows[-1]))
    finally:
        for w in workers.values():
            w.shutdown()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ssd_backward_build.log").write_text(
        cuda_lib.build_log("ssd_backward"))
    (out_dir / "ssd_backward_variants.json").write_text(
        json.dumps({"device": smi, "timed": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
