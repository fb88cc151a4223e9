"""Training launcher for the registered architectures (port of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch mamba2-780m --reduced \
        --steps 50 [--ckpt DIR] [--device cpu]

Synthetic parameters (a generator seeded 0 on the device) trained on
``SyntheticLM`` batches with AdamW (``--lr``, warmup a tenth of
``--steps``, cosine decay to the last step). It runs on the CUDA device
unless ``--device cpu`` is given (gloo), one rank per process, on a
(1, world) mesh from ``make_local_mesh``, or on the 16x16 mesh with
``--production-mesh`` (256 ranks). Alone it is world size 1; started as
several ranks (``torchrun``, or ``RANK`` and ``WORLD_SIZE`` in the
environment with ``--dist-init`` giving the rendezvous, e.g.
``file:///shared/path``) it joins their process group:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --device cpu --steps 5

With ``--ckpt`` the parameters and optimizer state are saved there at
the end (one checkpoint, written by rank 0), and the log gives their
``tree_digest`` (a reader can check a load against it bit for bit). The
log's last line lists every step's loss.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.registry import get_arch, list_archs
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import (BACKENDS, make_local_mesh,
                                     make_production_mesh)
from repro_torch.obs import get_logger
from repro_torch.train.checkpoint import save_checkpoint, tree_digest
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_sharded, make_train_step

log = get_logger(__name__)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the launcher; returns the loss of every step."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init method when WORLD_SIZE "
                         "is set (default env://, as torchrun sets it)")
    args = ap.parse_args(argv)
    _join_ranks(args.device, args.dist_init)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = (make_production_mesh(device=args.device) if args.production_mesh
            else make_local_mesh(args.device))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn, _ = make_train_step(mesh, cfg, opt_cfg)
    params, opt_state = init_sharded(mesh, cfg)
    data = iter(SyntheticLM(cfg, batch=args.batch, seq_len=args.seq))

    lead = not dist.is_initialized() or dist.get_rank() == 0
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        b = next(data)
        batch = {"inputs": b.inputs, "targets": b.targets, "mask": b.mask}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if lead and (i % 10 == 0 or i == args.steps - 1):
            log.info(f"[train:{cfg.name}] step {i:4d} "
                     f"loss={losses[-1]:.4f} lr={float(m['lr']):.2e} "
                     f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state, step=args.steps,
                        meta={"arch": cfg.name})
        digests = [tree_digest(t) for t in (params, opt_state.mu,
                                            opt_state.nu)]
        if lead:
            log.info(f"saved checkpoint to {args.ckpt} (params digest "
                     f"{digests[0]}, mu {digests[1]}, nu {digests[2]})")
    if lead:
        log.info(f"[train:{cfg.name}] losses {json.dumps(losses)}")
    return losses


def _join_ranks(device: str, init_method: str) -> None:
    """Join the process group of a multi-rank start (``WORLD_SIZE`` in the
    environment, as ``torchrun`` sets it): the device's backend, this
    process's ``RANK``, its CUDA device ``LOCAL_RANK``. Alone, the mesh
    starts a group of one."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    backend = BACKENDS["cuda" if device.startswith("cuda") else "cpu"]
    kw = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]), world_size=world,
                            **kw)


if __name__ == "__main__":
    main()
