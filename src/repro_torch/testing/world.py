"""A world of ranks on one machine: spawn, join, run, collect, time out.

:func:`run_world` starts ``world`` processes by the ``spawn`` method (each
a fresh interpreter), joins them into one ``torch.distributed`` process
group through :func:`repro_torch.launch.distributed.init_runtime` on a
free local port, runs ``fn(rank)`` in each and returns the ranks' results
in rank order (``args`` pass through: ``fn(rank, *args)``).  It is how
the mesh tests run four ``gloo`` ranks on the
CPU, and how ``chip_smoke.py`` runs four ``gloo`` ranks that share one
card, or one ``nccl`` rank.

The workers import ``torch`` and ``repro_torch`` only: ``jax`` is blocked
in them before ``fn``'s module is imported, so a worker that reaches for
the JAX package fails.  ``fn`` must be a module-level function (it is
named by module and qualified name); its result must pickle.

A hang must fail, not eat the caller's clock: at ``timeout`` seconds
every worker still running is killed and the call raises
:class:`WorldError` with each worker's exit code and the tail of its
output (each worker's stdout and stderr go to its own log file).  A
worker that raises fails the call the same way, with its traceback, once
the others have stopped or been killed.
"""
from __future__ import annotations

import importlib
import os
import queue as _queue
import shutil
import socket
import sys
import tempfile
import time
import traceback


class WorldError(RuntimeError):
    """A worker of :func:`run_world` failed, or the world timed out."""


def free_port() -> int:
    """A TCP port free on the loopback interface just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(target, args, rank, world, port, backend, device, log,
            results):
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        sys.modules["jax"] = None                 # the port stands alone
        import torch

        from repro_torch.launch.distributed import init_runtime

        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_runtime(f"tcp://127.0.0.1:{port}", world, rank, device=device,
                     backend=backend)
        module, name = target
        fn = importlib.import_module(module)
        for part in name.split("."):
            fn = getattr(fn, part)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:
        traceback.print_exc()
        results.put((rank, False, traceback.format_exc()))
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return "(no log)"


def run_world(fn, world: int, *, backend: str = "gloo", device="cpu",
              timeout: float = 120.0, args: tuple = ()) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each computed in its
    own rank of a ``world``-process group over ``backend`` on ``device``
    (ranks on the card share the cards round-robin).  Raises
    :class:`WorldError` on a worker's exception or exit, or at
    ``timeout`` seconds (every worker killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    logs = tempfile.mkdtemp(prefix="repro_world_")
    target = (fn.__module__, fn.__qualname__)
    procs = []
    for rank in range(world):
        log = os.path.join(logs, f"rank{rank}.log")
        p = ctx.Process(target=_worker, daemon=True,
                        args=(target, tuple(args), rank, world, port,
                              backend, str(device), log, results))
        p.start()
        procs.append((p, log))
    got: dict[int, tuple[bool, object]] = {}
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"timed out after {timeout:.0f} s"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, (p, _) in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    # a worker died without reporting (killed, crashed)
                    time.sleep(0.5)
                    if results.empty():
                        failure = f"rank {dead[0]} exited without a result"
                        break
                continue
            got[rank] = (ok, out)
            if not ok:
                failure = f"rank {rank} raised"
                # give the others a moment to fail or finish, then stop
                end = time.monotonic() + 5.0
                while len(got) < world and time.monotonic() < end:
                    try:
                        r, o, v = results.get(timeout=0.5)
                        got[r] = (o, v)
                    except _queue.Empty:
                        pass
                break
    finally:
        for p, _ in procs:
            if failure is not None and p.is_alive():
                p.kill()
        for p, _ in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if failure is not None:
        parts = [f"run_world: {failure}"]
        for rank, (p, log) in enumerate(procs):
            parts.append(f"--- rank {rank}: exit code {p.exitcode}")
            ok_out = got.get(rank)
            if ok_out is not None and not ok_out[0]:
                parts.append(str(ok_out[1]))
            parts.append(_tail(log))
        shutil.rmtree(logs, ignore_errors=True)
        raise WorldError("\n".join(parts))
    shutil.rmtree(logs, ignore_errors=True)
    return [got[r][1] for r in range(world)]
