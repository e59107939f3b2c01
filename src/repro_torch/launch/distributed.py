"""Process identity, publish gating and the distributed table build's
worker entry point.

The port's copy of the process half of the JAX package's
``repro.launch.distributed``: who am I in a multi-process job, who may
publish, and how a fleet of table-build workers runs on one machine.
Two modes share every code path:

* **``torch.distributed`` mode** — a multi-process job calls
  :func:`init_runtime` with a coordinator address
  (``tcp://host:port``); it joins the process group (``nccl`` on the
  card, ``gloo`` on the CPU) and identity comes from its rank.
* **Subprocess-worker mode** — the coordinator spawns plain
  subprocesses with ``REPRO_PROCESS_ID`` / ``REPRO_NUM_PROCESSES`` set
  (:func:`worker_env`); no process group is formed: coordination goes
  through a shared work directory (:mod:`repro_torch.core.dist_build`).

:func:`process_index` / :func:`process_count` / :func:`is_main` answer
identity questions from the standard library alone (explicit
:func:`init_runtime` state, then the environment, then the
single-process default), so the publish gates in
:mod:`repro_torch.core.table_cache` and :mod:`repro_torch.runtime.artifact`
cost one dictionary read and import nothing.

Failure semantics of the distributed table build
------------------------------------------------
* **Lease timeouts** — a worker claims a work item (one latency-probe
  bucket) by creating its lease file with ``O_CREAT|O_EXCL``; the lease
  expires ``lease_s`` seconds out and is renewed only between probe
  attempts, so a worker that is killed, wedged or stalled stops renewing
  and its leases expire.
* **Reassignment** — a live worker that finds an expired lease steals it
  (``os.replace`` and a read-back) and runs the item again; the steal is
  recorded in its shard.  Execution is at-least-once, attribution
  exactly-once: the merge reads shards in a fixed order and keeps the
  first record of each item, so the merged tables are a function of the
  shard set, bitwise a single-process build's under the analytic oracle.
  Items still open after every worker exited, and items whose shard
  record is corrupt, run inline in the coordinator.
* **At-most-once publish** — every durable publish (the table cache, the
  build journal, artifacts, :func:`publish_text` / :func:`publish_json`)
  is gated on :func:`is_main`.  Workers get a non-zero process index, so
  a worker that reaches a publish writes nothing; they write only their
  shards inside the work directory.

A worker's combined output is kept at ``<work_dir>/logs/w<idx>.log``
(:func:`repro_torch.core.dist_build.worker_log_path`); its last line is a
JSON object with its item count, its kernels' launch counts and its
start-up seconds.  The serving counterpart (a worker lost mid-decode:
drain, re-form, replay) is
:func:`repro_torch.runtime.serving.serve_with_failover`.

:func:`survivor_mesh` re-forms a 1-D mesh
(:class:`repro_torch.launch.mesh.HostMesh`) over the ranks that survive
a loss.

    # one worker (normally spawned by the coordinator)
    PYTHONPATH=src python -m repro_torch.launch.distributed --worker \\
        --dir WORK --host-spec '{"factory": \\
        "repro_torch.testing.hosts:tiny_resnet_host", "kwargs": {}}'
    # clean 2-worker build ≡ single-process build; the fault smoke
    PYTHONPATH=src python -m repro_torch.launch.distributed --smoke \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.distributed --fault-smoke \\
        [--device cpu]
"""
from __future__ import annotations

import json
import os
import time

_STATE = {"process_id": None, "num_processes": None}

ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"


def init_runtime(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None, *, device="cuda",
                 backend: str | None = None) -> int:
    """Initialize process identity; returns this process's index.

    With ``coordinator_address`` (``tcp://host:port``, or ``host:port``)
    this joins a ``torch.distributed`` process group of
    ``num_processes`` as rank ``process_id`` over ``backend`` — by
    default ``nccl`` when ``device`` is the card (the caller picks its
    card first, ``torch.cuda.set_device``) and ``gloo`` on the CPU;
    ``gloo`` on the card lets ranks share one card — and identity is the
    group's.  A failed join raises.  The JAX
    package's ``local_device_ids`` has no counterpart.  Without it,
    identity comes from the arguments or the ``REPRO_PROCESS_ID`` /
    ``REPRO_NUM_PROCESSES`` environment (subprocess-worker mode),
    defaulting to the single-process ``(0, 1)``.
    """
    if coordinator_address is not None:
        import torch
        import torch.distributed as dist

        cuda = torch.device(device).type == "cuda"
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        if backend is None:
            backend = "nccl" if cuda else "gloo"
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id)
        _STATE["process_id"] = dist.get_rank()
        _STATE["num_processes"] = dist.get_world_size()
        return _STATE["process_id"]
    _STATE["process_id"] = (
        process_id if process_id is not None
        else int(os.environ.get(ENV_PROCESS_ID, "0")))
    _STATE["num_processes"] = (
        num_processes if num_processes is not None
        else int(os.environ.get(ENV_NUM_PROCESSES, "1")))
    return _STATE["process_id"]


def process_index() -> int:
    """This process's index in the job (0: the coordinator, the publisher).

    Explicit :func:`init_runtime` state first, then ``REPRO_PROCESS_ID``,
    then 0; it never touches ``torch.distributed``."""
    if _STATE["process_id"] is not None:
        return _STATE["process_id"]
    return int(os.environ.get(ENV_PROCESS_ID, "0"))


def process_count() -> int:
    """Processes in the job (resolved as :func:`process_index` is)."""
    if _STATE["num_processes"] is not None:
        return _STATE["num_processes"]
    return int(os.environ.get(ENV_NUM_PROCESSES, "1"))


def is_main() -> bool:
    """True in the one process that may publish (process index 0): the
    I/O gate of artifact saves, table-cache publishes, build-journal
    appends and :func:`publish_text`."""
    return process_index() == 0


def publish_text(path: str, text: str) -> str | None:
    """:func:`is_main`-gated atomic text publish; the path, or None where
    this process does not publish (nothing is written)."""
    if not is_main():
        return None
    from repro_torch.checkpoint.ckpt import atomic_write_text

    return atomic_write_text(path, text)


def publish_json(path: str, payload) -> str | None:
    """:func:`is_main`-gated atomic JSON publish."""
    return publish_text(path, json.dumps(payload, indent=2))


def worker_env(worker_id: int, num_workers: int, *, device="cuda",
               faults_spec: str | None = None,
               extra: dict | None = None) -> dict:
    """Environment of worker ``worker_id`` of ``num_workers``.

    Workers get process index ``worker_id + 1`` (the coordinator is 0), so
    :func:`is_main` is False in every worker and gated writes are inert
    there.  ``device`` 'cpu' hides the card from the worker; otherwise it
    sees the cards its coordinator sees."""
    from repro_torch.testing.subproc import subprocess_env

    return subprocess_env(device=str(device), process_id=worker_id + 1,
                          num_processes=num_workers + 1,
                          faults_spec=faults_spec, extra=extra)


def survivor_mesh(exclude=(), axes: tuple[str, ...] = ("data",)):
    """Re-form a mesh over the ranks that survive a worker loss.

    ``exclude``: the ranks to drop (the lost workers').  The result is a
    :class:`~repro_torch.launch.mesh.HostMesh` over the remaining ranks
    of the default process group (or this one process), all on the first
    axis name (the data/slot axis serving shards over), every other axis
    of size 1.  Every rank of the group calls it (the groups are formed
    together); on a dropped rank the mesh holds no coordinates.  Raises
    when nothing survives."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import build_mesh

    excluded = set(int(r) for r in exclude)
    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    ranks = [r for r in range(n) if r not in excluded]
    if not ranks:
        raise RuntimeError("no surviving devices to re-form a mesh on")
    shape = {axes[0]: len(ranks), **{a: 1 for a in axes[1:]}}
    return build_mesh(shape, ranks)


# ---------------------------------------------------------------------------
# Worker entry point and the smokes
# ---------------------------------------------------------------------------

def _run_worker_cli(args, t_main: float) -> int:
    import torch

    from repro_torch import kernels
    from repro_torch.core import dist_build, probe_engine
    from repro_torch.device import resolve
    from repro_torch.launch import distributed as canonical

    t_imports = time.time()
    # the module the publish gates read (under ``python -m`` this function
    # runs in ``__main__``, another module object)
    canonical.init_runtime()
    host_spec = json.loads(args.host_spec)
    dev = resolve(host_spec.get("kwargs", {}).get("device", "cuda"))
    if dev.type == "cuda":               # the context, before the host
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    t_cuda = time.time()
    stats = probe_engine.EngineStats(engine=args.engine)
    try:
        host, params = dist_build.resolve_host_spec(host_spec)
        t_host = time.time()
        oracle = dist_build.resolve_oracle_spec(json.loads(args.oracle_spec))
        cfg = dist_build.resolve_probe_spec(
            json.loads(args.probe_spec) if args.probe_spec else None)
        done = dist_build.run_worker(
            args.dir, args.worker_id, host, params, oracle,
            engine=args.engine, method=args.method, probe_config=cfg,
            lease_s=args.lease_s, deadline_s=args.deadline_s, stats=stats)
    except dist_build.DistBuildError as e:
        print(f"worker {args.worker_id}: {e}", flush=True)
        return 3
    t0 = args.spawned_at if args.spawned_at is not None else t_main
    print(json.dumps({
        "worker": args.worker_id, "items_done": done,
        "device": str(host.device), "launches": kernels.launch_counts(),
        "retried": stats.num_probe_retries, "retimed": stats.num_retimed,
        "quarantined": stats.num_quarantined,
        # seconds from the spawn to: the interpreter running this module,
        # the imports, the card's context, the host built (ready to claim)
        "start_s": {"python": t_main - t0, "imports": t_imports - t0,
                    "cuda": t_cuda - t0, "host": t_host - t0},
        "run_s": time.time() - t_host}), flush=True)
    return 0


def dist_smoke(device="cuda") -> dict:
    """A clean 2-worker build of the smoke network ≡ the single-process
    build (``tiny_resnet_host`` on ``device``, the analytic oracle)."""
    import tempfile

    from repro_torch.core import build_tables, dist_build
    from repro_torch.testing import hosts

    host, params = hosts.tiny_resnet_host(device=device)
    reference = build_tables(host, params=params)
    with tempfile.TemporaryDirectory() as cache_dir:
        tables, rep = dist_build.dist_build_tables(
            host, params=params, cache_dir=cache_dir, workers=2,
            host_spec={"factory": "repro_torch.testing.hosts:tiny_resnet_host",
                       "kwargs": {"device": str(device)}},
            lease_s=5.0, worker_device=device)
    if tables.entries != reference.entries:
        raise AssertionError("distributed tables diverged from the "
                             "single-process build")
    if rep.dead_workers:
        raise AssertionError(f"workers died: {rep.as_dict()}")
    return {"device": str(device), "items": rep.items,
            "completed_by": rep.completed_by,
            "dead_workers": rep.dead_workers, "bit_identical": True}


def dist_fault_smoke(device="cuda") -> dict:
    """Coordinator + 2 workers, worker 0 killed mid-bucket holding a lease
    (``kill-worker:0@dist.item:2``): the merged tables must be bitwise a
    single-process build and the reassignment recorded.

    Workers start one after the other (``serial_spawn``), so the kill is
    deterministic: worker 0 always dies at its second item, and worker 1
    always finds that lease expired and steals it."""
    import tempfile

    from repro_torch.core import build_tables, dist_build
    from repro_torch.testing import faults, hosts

    host, params = hosts.tiny_resnet_host(device=device)
    reference = build_tables(host, params=params)
    with tempfile.TemporaryDirectory() as cache_dir:
        with faults.inject(faults.Fault("dist.item", "kill-worker",
                                        nth=2, widx=0)):
            tables, rep = dist_build.dist_build_tables(
                host, params=params, cache_dir=cache_dir, workers=2,
                host_spec={"factory":
                           "repro_torch.testing.hosts:tiny_resnet_host",
                           "kwargs": {"device": str(device)}},
                lease_s=0.5, serial_spawn=True, worker_device=device)
    if tables.entries != reference.entries:
        raise AssertionError("distributed tables diverged from the "
                             "single-process build")
    if tables.num_pruned != reference.num_pruned:
        raise AssertionError("distributed Pareto drops diverged")
    if rep.dead_workers != [0]:
        raise AssertionError(f"worker 0 alone was expected to die (exit "
                             f"17), report: {rep.as_dict()}")
    if not rep.reassigned:
        raise AssertionError(f"the killed worker's lease was never "
                             f"reassigned: {rep.as_dict()}")
    return {"device": str(device), "items": rep.items,
            "dead_workers": rep.dead_workers, "reassigned": rep.reassigned,
            "completed_by": rep.completed_by,
            "coordinator_items": rep.coordinator_items,
            "bit_identical": True}


def serve_failover_smoke(device="cuda") -> dict:
    """A worker lost mid-decode (``raise@serve.worker`` at the 3rd chunk):
    drain, re-form, replay — every request ends with a disposition and
    the tokens are bitwise an uninterrupted run's.  The model is the
    reference smoke's reduced SmolLM-135M (2 layers, d 64, 4/2 heads,
    head_dim 16, d_ff 128, vocab 128), weights from seed 0."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.testing import faults

    dev = resolve(device)
    cfg = dataclasses.replace(
        get_config("smollm-135m").reduced(), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device=dev)

    def step(cache, tokens):
        return T.decode_step(cfg, params, cache, {"tokens": tokens})

    def mk(b, s):
        return T.init_cache(cfg, b, s, device=dev)

    prompt = serving.random_prompts(0, 5, 5, cfg.vocab_size, device=dev)
    lens = torch.full((5,), 5, dtype=torch.int32)
    kw = dict(tokens=6, slots=2, chunk=3)
    clean = serving.serve_continuous(step, mk, prompt, lens,
                                     clock=faults.TickClock(), **kw)
    with faults.inject(faults.Fault("serve.worker", "raise", nth=3)):
        out = serving.serve_with_failover(step, mk, prompt, lens,
                                          clock=faults.TickClock(), **kw)
    rep = out.report
    if rep.failovers != 1 or not rep.replayed:
        raise AssertionError(f"expected one failover with replays, got "
                             f"failovers={rep.failovers} "
                             f"replayed={rep.replayed}")
    if sorted(rep.dispositions) != list(range(5)):
        raise AssertionError(f"request(s) lost in failover: dispositions="
                             f"{sorted(rep.dispositions)}")
    if not np.array_equal(np.asarray(out[0]), np.asarray(clean[0])):
        raise AssertionError("replayed tokens diverged from the "
                             "uninterrupted run")
    return {"device": str(dev), "failovers": rep.failovers,
            "lost_workers": rep.lost_workers, "replayed": rep.replayed,
            "completed": sorted(rep.completed), "bit_identical": True}


def main(argv=None):
    import argparse

    t_main = time.time()
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.distributed")
    ap.add_argument("--worker", action="store_true",
                    help="run one distributed-build worker loop")
    ap.add_argument("--dir", default=None, help="shared work directory")
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--host-spec", default=None,
                    help='JSON {"factory": "module:function", "kwargs": {}}')
    ap.add_argument("--oracle-spec", default='{"cls": "AnalyticOracle"}')
    ap.add_argument("--probe-spec", default=None,
                    help="JSON ProbeConfig fields (timeout_s, retries, ...)")
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "sequential"))
    ap.add_argument("--method", default="layermerge")
    ap.add_argument("--lease-s", type=float, default=30.0)
    ap.add_argument("--deadline-s", type=float, default=600.0)
    ap.add_argument("--spawned-at", type=float, default=None,
                    help=argparse.SUPPRESS)   # the coordinator's clock
    ap.add_argument("--device", default="cuda",
                    help="the smokes' device: the card by default; 'cpu' "
                         "runs the plain PyTorch versions")
    ap.add_argument("--smoke", action="store_true",
                    help="clean 2-worker build ≡ single-process build")
    ap.add_argument("--fault-smoke", action="store_true",
                    help="kill worker 0 mid-bucket; assert bitwise merged "
                         "tables and a recorded lease reassignment, then a "
                         "serve-failover replay with no request lost")
    args = ap.parse_args(argv)
    if args.worker:
        if not (args.dir and args.host_spec):
            ap.error("--worker requires --dir and --host-spec")
        raise SystemExit(_run_worker_cli(args, t_main))
    if args.fault_smoke:
        print(json.dumps(dist_fault_smoke(args.device), indent=2))
        print(json.dumps(serve_failover_smoke(args.device), indent=2))
        print("DIST_FAULT_SMOKE_OK")
        return
    if args.smoke:
        print(json.dumps(dist_smoke(args.device), indent=2))
        print("DIST_SMOKE_OK")
        return
    ap.print_help()


if __name__ == "__main__":
    main()
