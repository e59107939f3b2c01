"""Fault-tolerant training loop.

The JAX package's ``train/loop.py`` in PyTorch.  The loop owns the train
step, the batches, periodic asynchronous checkpoints, the restart from
the newest complete checkpoint on a failure, and a step-deadline
watchdog for stragglers:

* **resume** — a run that finds a checkpoint in ``ckpt_dir`` starts from
  it;
* **restart** — a step that raises ``RuntimeError`` (a CUDA error,
  ``torch.cuda.OutOfMemoryError``, a simulated device loss from
  ``failure_hook``) reloads the last complete checkpoint and replays
  from there, up to ``max_restarts`` times; batch ``i`` is a pure
  function of ``i`` (:mod:`repro_torch.data.pipeline`), so the replay
  sees the same data;
* **watchdog** — a step longer than ``deadline_factor`` × the median of
  the recent steps counts as a straggler; ``max_stragglers_in_row`` of
  them in a row raise into the restart path;
* **checkpoints** — every ``ckpt_every`` steps and at the end, written
  in the background (:class:`repro_torch.checkpoint.ckpt.
  AsyncCheckpointer`).

The step updates params and moments in place, so the loop trains a copy
of the caller's params and leaves them as they were.

Under a mesh (the step's ambient rules, params that are this rank's
blocks) every rank runs the loop: checkpoints gather the blocks whole
and the main process writes them (:mod:`repro_torch.checkpoint.ckpt`),
every rank waits for that write before it reads the newest checkpoint,
and a resume or restart restores each rank's blocks of the params'
placements (an elastic restore).  A restart needs every rank's failure
at the same step (a failure hook that fires on every rank, as a device
loss stops the whole job); the watchdog reads the slowest rank's step
time, so every rank takes the same decision.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable

from repro_torch.checkpoint import ckpt as C
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding.rules import sharding_of, with_sharding
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map


def _world() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _barrier() -> None:
    """Every rank waits here (the main process's write has landed)."""
    if _world():
        import torch.distributed as dist
        dist.barrier()


def _slowest(dt: float, like) -> float:
    """The largest of the ranks' step times (``dt`` alone without a
    process group); ``like`` gives the device of the exchange."""
    if not _world():
        return dt
    import torch
    import torch.distributed as dist
    t = torch.tensor([dt], dtype=torch.float64, device=like.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _restore(ckpt_dir: str, step: int, like):
    """``like``'s tree from the checkpoint of ``step``: each leaf that
    carries a placement as this rank's block of it."""
    places = tree_map(sharding_of, like)
    return C.restore(ckpt_dir, step, like, shardings=places)


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    deadline_factor: float = 10.0
    max_stragglers_in_row: int = 3
    microbatches: int = 1


@dataclasses.dataclass
class LoopResult:
    losses: list
    restarts: int
    straggler_events: int
    final_step: int
    params: Any
    opt_state: Any
    #: seconds of each step that completed, in the order they ran (from
    #: its start to its loss on the host)
    step_s: list = dataclasses.field(default_factory=list)


def train_loop(cfg, opt_cfg: AdamWConfig, loop: LoopConfig, params, batch_fn,
               *, failure_hook: Callable[[int], None] | None = None,
               logger: Callable[[str], None] = print) -> LoopResult:
    """Run (and if needed re-run) training to ``loop.total_steps``.

    ``batch_fn(i)`` gives batch ``i`` on the params' device;
    ``failure_hook(step)`` runs before each step (a test's fault).
    ``losses`` holds every step's loss in the order they ran, a replayed
    step's again."""
    step_fn = make_train_step(cfg, opt_cfg, microbatches=loop.microbatches)
    saver = C.AsyncCheckpointer(loop.ckpt_dir, keep=loop.keep)
    params = tree_map(lambda t: with_sharding(t.detach().clone(),
                                              sharding_of(t)), params)
    anchor = tree_leaves(params)[0]
    opt_state = init_opt_state(params)
    losses: list[float] = []
    restarts = 0
    stragglers = 0
    step_times: list[float] = []

    start = C.latest_step(loop.ckpt_dir)
    if start is not None:
        state = _restore(loop.ckpt_dir, start,
                         {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        logger(f"[loop] resumed from step {start}")
    step = start or 0

    while step < loop.total_steps:
        try:
            t0 = time.perf_counter()
            if failure_hook is not None:
                failure_hook(step)
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = _slowest(time.perf_counter() - t0, anchor)
            # --- straggler watchdog -------------------------------------
            if len(step_times) >= 5:
                med = statistics.median(step_times[-20:])
                if dt > loop.deadline_factor * med:
                    stragglers += 1
                    logger(f"[loop] straggler at step {step}: "
                           f"{dt:.3f}s vs median {med:.3f}s")
                    if stragglers >= loop.max_stragglers_in_row:
                        raise RuntimeError("straggler threshold exceeded")
                else:
                    stragglers = 0
            step_times.append(dt)
            losses.append(loss)
            step += 1
            if step % loop.log_every == 0:
                logger(f"[loop] step {step} loss {loss:.4f} ({dt:.3f}s)")
            if step % loop.ckpt_every == 0 or step == loop.total_steps:
                saver.save(step, {"params": params, "opt": opt_state},
                           metadata={"loss": loss})
        except RuntimeError as e:
            restarts += 1
            logger(f"[loop] FAILURE at step {step}: {e} "
                   f"(restart {restarts}/{loop.max_restarts})")
            if restarts > loop.max_restarts:
                raise
            saver.wait()
            _barrier()
            last = C.latest_step(loop.ckpt_dir)
            if last is None:
                # no checkpoint yet: restart from scratch
                opt_state = init_opt_state(params)
                step = 0
            else:
                state = _restore(loop.ckpt_dir, last,
                                 {"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                step = last
            stragglers = 0

    saver.wait()
    _barrier()
    return LoopResult(losses=losses, restarts=restarts,
                      straggler_events=stragglers, final_step=step,
                      params=params, opt_state=opt_state,
                      step_s=step_times)
