"""Launcher: ``--arch <id> --shape <shape> --mode train|serve``, on one device
or (``--distributed``) on the ranks of a process group.

The JAX package's ``launch/train.py`` in PyTorch: it builds a config's
model (random weights from seed 0, drawn on the run's device) and either
trains it on the synthetic
Markov data through the fault-tolerant loop (:mod:`repro_torch.train.
loop`) or decodes greedily through the serve step.  It runs on the card
unless ``--device cpu`` is given.

``--distributed`` joins the process group the environment names, as
``torchrun`` sets it (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, and ``LOCAL_RANK`` for the card):
:func:`repro_torch.launch.distributed.init_runtime` over NCCL on the
card, gloo on the CPU.  The ranks form a ``('data', 'model')`` mesh
(:func:`repro_torch.launch.mesh.make_host_mesh`, every rank on 'data'),
the rules are ``make_rules(mesh, fsdp=False)`` as the
reference's launcher takes them, the params are each rank's blocks of
them and the batches its rows (``GlobalBatcher(data, mesh=mesh)``).
Without a process group in the environment it raises: it never runs as
one process quietly.  Without ``--distributed`` there is no mesh and no
rules.

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
  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch smollm-135m --reduced --steps 5 --device cpu --distributed

A full config runs at its own dtype, bf16 for every published config:
the card's norm and attention kernels have bf16 bodies, the params stay
bf16 and AdamW's moments fp32, as in the JAX package.  ``--reduced``
configs are fp32, as there.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.launch.distributed import init_runtime, is_main
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.rules import (make_rules,
                                        param_shardings_with_shapes, put,
                                        use_rules)
from repro_torch.train.step import make_serve_step
from repro_torch.tree import tree_leaves

#: The environment ``--distributed`` reads (``torchrun``'s names).
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def join_from_env(device) -> int:
    """Join the process group the environment names (:data:`DIST_ENV`)
    over NCCL on the card, gloo on the CPU; the card is ``LOCAL_RANK``'s.
    Returns this rank.  Raises where the environment names none."""
    missing = [k for k in DIST_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "--distributed needs a process group in the environment "
            f"({', '.join(DIST_ENV)}, as torchrun sets them); missing "
            f"{', '.join(missing)}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_runtime(
        f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        device=device)


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
                    help="join the process group of the environment "
                         "(torchrun's variables) and train on its mesh")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    if args.distributed:
        join_from_env(dev)
        try:
            return _run(args, dev)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    return _run(args, dev)


def _run(args, dev):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "tokens" and args.mode == "train":
        raise SystemExit(f"{args.arch} uses an embeddings frontend stub; "
                         "train it through the dry-run cells")

    params, axes = T.init_model(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)
    n = sum(x.numel() for x in tree_leaves(params))
    mesh = rules = None
    if args.distributed:
        mesh = make_host_mesh()
        rules = make_rules(mesh, fsdp=False)
        params = put(params, param_shardings_with_shapes(rules, axes,
                                                         params))
    where = f"mesh {dict(mesh.shape)}, rank {mesh.rank}" if mesh else ""
    print(f"[launch] {cfg.name} ({n / 1e6:.2f}M params, {cfg.dtype}) on "
          f"{dev}{', ' + where if where else ''}, mode={args.mode}")

    with use_rules(rules) if rules is not None else contextlib.nullcontext():
        if args.mode == "train":
            return _train(args, cfg, params, mesh, dev)
        return _serve(args, cfg, params, dev)


def _train(args, cfg, params, mesh, dev):
    if not args.resume and is_main():
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq)
    batcher = GlobalBatcher(data, mesh=mesh, device=dev)
    res = train_loop(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=args.warmup,
                         total_steps=args.steps),
        LoopConfig(total_steps=args.steps, ckpt_every=25,
                   ckpt_dir=args.ckpt_dir, log_every=10),
        params, batcher)
    last = f"{res.losses[-1]:.4f}" if res.losses else "-"
    print(f"[launch] final loss {last} restarts={res.restarts} "
          f"final_step={res.final_step}")
    return res


def _serve(args, cfg, params, dev):
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
