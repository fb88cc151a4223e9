"""End-to-end training example on the PyTorch port (twin of
``examples/train_lm.py``): train a reduced assigned architecture for a
few hundred steps on the synthetic LM pipeline with the train step of a
(1, 1) mesh, checkpointing included.

PYTHONPATH=src python examples/torch_train_lm.py [--arch qwen3-1.7b] \
    [--steps 200] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.common.registry import get_arch
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import tree as T
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_sharded, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args()

    cfg = get_arch(args.arch).reduced()
    mesh = make_local_mesh(args.device)       # world size 1
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                          weight_decay=0.01)
    step_fn, _ = make_train_step(mesh, cfg, opt_cfg)
    params, opt_state = init_sharded(mesh, cfg)
    data = iter(SyntheticLM(cfg, batch=args.batch, seq_len=args.seq))

    t0 = time.time()
    for i in range(args.steps):
        b = next(data)
        batch = {"inputs": b.inputs, "targets": b.targets, "mask": b.mask}
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={float(m['loss']):.4f}  "
                  f"lr={float(m['lr']):.2e}  "
                  f"gnorm={float(m['grad_norm']):.2f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    save_checkpoint(args.ckpt, params, opt_state,
                    step=args.steps, meta={"arch": cfg.name})
    print(f"checkpoint saved to {args.ckpt}")
    p2, _, step = load_checkpoint(args.ckpt, params, opt_state)
    ok = all(torch.equal(a, b) for (_, a), (_, b) in
             zip(T.items(params), T.items(p2)))
    print(f"checkpoint roundtrip verified (step={step}, match={ok})")
    assert ok and step == args.steps


if __name__ == "__main__":
    main()
