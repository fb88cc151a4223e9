"""Training launcher for the registered architectures (port of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch mamba2-780m --reduced \
        --steps 50 [--ckpt DIR] [--device cpu]

Synthetic parameters (a generator seeded 0 on the device) trained on
``SyntheticLM`` batches with AdamW (``--lr``, warmup a tenth of
``--steps``, cosine decay to the last step). It runs on the CUDA device
unless ``--device cpu`` is given, on a (1, 1) mesh from
``make_local_mesh``; ``--production-mesh`` asks for the 16x16 mesh, which
needs 256 ranks (and training across ranks is not ported yet). With
``--ckpt`` the parameters and optimizer state are saved there at the end,
and the log gives their ``tree_digest`` (a reader can check a load
against it bit for bit).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

from repro_torch.common.registry import get_arch, list_archs
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
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
    args = ap.parse_args(argv)

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

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        b = next(data)
        batch = {"inputs": b.inputs, "targets": b.targets, "mask": b.mask}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            log.info(f"[train:{cfg.name}] step {i:4d} "
                     f"loss={losses[-1]:.4f} lr={float(m['lr']):.2e} "
                     f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state, step=args.steps,
                        meta={"arch": cfg.name})
        log.info(f"saved checkpoint to {args.ckpt} (params digest "
                 f"{tree_digest(params)}, mu {tree_digest(opt_state.mu)}, "
                 f"nu {tree_digest(opt_state.nu)})")
    return losses


if __name__ == "__main__":
    main()
