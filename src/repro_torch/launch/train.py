"""Training launcher for the port, on the CUDA card unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --tiny --steps 50 --batch 8 --seq 64 [--device cpu]

Mirrors ``repro.launch.train`` on one device: weights from seed 0, AdamW
with warmup min(20, steps // 5) and cosine decay over ``--steps``,
``SyntheticLM(seed=0)`` batches, a line of metrics every 10 steps and
the last, and the params saved to ``--ckpt`` at the end. The reference's
``--mesh`` (pjit data x model sharding) is not ported.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import build_train_step
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_train_step
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, tiny=args.tiny)
    model, _ = build_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, dtype=getattr(torch, args.dtype), device=device)
    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch,
                                  n_codebooks=cfg.n_codebooks, seed=0))
    it = data.batches()
    for step in range(args.steps):
        tokens, labels, mask = (torch.as_tensor(a, device=device)
                                for a in next(it))
        params, opt, metrics = step_fn(params, opt, tokens, labels, mask)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    if args.ckpt:
        path = save_checkpoint(args.ckpt, args.steps, params)
        print("checkpoint:", path)


if __name__ == "__main__":
    main()
