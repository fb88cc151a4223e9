"""Profile full-width train steps on one CUDA card: where a step's time
goes, and whether the host holds the card back.

    python3 scripts/train_step_profile.py [--arch mamba2-780m] [--batch 4]
        [--seq 640] [--steps 3]

Sets up what ``chip_smoke.py`` phase 11 trains (bf16 synthetic parameters
from a generator seeded 0 on the card, ``SyntheticLM`` batches, AdamW at
the launcher's defaults), runs one step to warm up, times ``--steps``
steps on the host clock (synced), then runs ``--steps`` more under
``torch.profiler`` (CPU and CUDA activities). Prints the card's name and
power limit, then one JSON object: the unprofiled steps' time, the
device's busy time a step (the union of the CUDA kernels' intervals on
the profiled timeline) and its share of the unprofiled step (the
profiler slows the host, so its own wall time is reported beside), the
device time of the kernels grouped by kind (the port's SSD kernels
``ssd_kernel_*`` and ``ssdb_kernel_*``, cuBLAS GEMMs, the rest) and the
ten kernels with the most device time. Writes the same object to
``chiprun_out/train_step_profile.json``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def kind(name: str) -> str:
    if "ssdb_kernel" in name:
        return "ssd_backward"
    if "ssd_kernel" in name:
        return "ssd"
    if re.search(r"gemm|nvjet|sm90_xmma|cutlass|cublas", name, re.I):
        return "gemm"
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=640)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.common.registry import get_arch
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import train_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_lib.load_all()
    dev = torch.device("cuda")
    cfg = get_arch(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = init_opt_state(params)
    total = 2 * args.steps + 1
    opt = AdamWConfig(lr=3e-3, warmup_steps=max(total // 10, 1),
                      total_steps=total)
    data = iter(SyntheticLM(cfg, batch=args.batch, seq_len=args.seq, seed=0))

    def batch():
        b = next(data)
        return {k: torch.from_numpy(getattr(b, k)).to(dev)
                for k in ("inputs", "targets", "mask")}
    params, state, _ = train_step(params, state, batch(), cfg=cfg,
                                  opt_cfg=opt)
    batches = [batch() for _ in range(args.steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        params, state, m = train_step(params, state, b, cfg=cfg,
                                      opt_cfg=opt)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    batches = [batch() for _ in range(args.steps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            params, state, m = train_step(params, state, b, cfg=cfg,
                                          opt_cfg=opt)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_us(intervals) / 1e6
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "arch": cfg.name, "batch": args.batch, "seq": args.seq,
           "steps": args.steps, "step_ms": step_s * 1e3,
           "tokens_per_s": args.batch * args.seq / step_s,
           "profiled_step_ms": wall_s / args.steps * 1e3,
           "device_busy_ms_per_step": busy / args.steps * 1e3,
           "device_busy_share": busy / args.steps / step_s,
           "kernels": len(kernels),
           "kernels_per_step": len(kernels) / args.steps,
           "device_ms_per_step_by_kind": {k: v / args.steps
                                          for k, v in by_kind.items()},
           "top_kernels_ms_per_step": [(n[:120], v / args.steps)
                                       for n, v in top],
           "loss": float(m["loss"])}
    print(json.dumps(out), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_step_profile.json").write_text(json.dumps(out,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
