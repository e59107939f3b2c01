"""Launcher: ``--arch <id> --shape <shape> --mode train|serve``, on one device.

The JAX package's ``launch/train.py`` in PyTorch: it builds a config's
model (random weights from seed 0, drawn on the run's device) and either
trains it on the synthetic
Markov data through the fault-tolerant loop (:mod:`repro_torch.train.
loop`) or decodes greedily through the serve step.  It runs on the card
unless ``--device cpu`` is given.  The port has one device: no mesh, no
sharding rules; ``--distributed`` exits with an error (the distribution
slice, ROADMAP.md queue 1 item 5).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 10 --warmup 2 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
      --mode serve --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --reduced --mode serve --tokens 16 --device cpu

A full config runs at its own dtype, bf16 for every published config:
the card's norm and attention kernels have bf16 bodies, the params stay
bf16 and AdamW's moments fp32, as in the JAX package.  ``--reduced``
configs are fp32, as there.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
from repro_torch.device import resolve
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import make_serve_step
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mode", default="train", choices=["train", "serve"])
    ap.add_argument("--reduced", action="store_true",
                    help="run the reduced config (CPU-sized, fp32)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=100,
                    help="AdamW warmup steps (the reference's 100; a short "
                         "run needs fewer to move bf16 weights)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions "
                         "of the kernels)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host runs: not in the port yet")
    args = ap.parse_args(argv)

    if args.distributed:
        raise SystemExit("--distributed: multi-device training belongs to "
                         "the port's distribution slice (ROADMAP.md queue 1 "
                         "item 5); the launcher runs on one device")
    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "tokens" and args.mode == "train":
        raise SystemExit(f"{args.arch} uses an embeddings frontend stub; "
                         "train it through the dry-run cells")

    params, _ = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"[launch] {cfg.name} ({n / 1e6:.2f}M params, {cfg.dtype}) on "
          f"{dev}, mode={args.mode}")

    if args.mode == "train":
        if not args.resume:
            shutil.rmtree(args.ckpt_dir, ignore_errors=True)
        data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq)
        batcher = GlobalBatcher(data, device=dev)
        res = train_loop(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=args.warmup,
                             total_steps=args.steps),
            LoopConfig(total_steps=args.steps, ckpt_every=25,
                       ckpt_dir=args.ckpt_dir, log_every=10),
            params, batcher)
        print(f"[launch] final loss {res.losses[-1]:.4f} "
              f"restarts={res.restarts}")
        return res
    serve = make_serve_step(cfg)
    cache = T.init_cache(cfg, args.batch, args.tokens + 1, device=dev)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        for _ in range(args.tokens):
            logits, cache = serve(params, cache, {"tokens": tok})
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    print(f"[launch] decoded {args.tokens} tokens/seq, sample: "
          f"{tok[:4, 0].tolist()}")
    return tok


if __name__ == "__main__":
    main()
