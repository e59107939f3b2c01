"""Multi-pod dry run: every (arch × shape × mesh) cell's step run once on
``meta`` tensors, as one rank of a fake process group.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  Where
the reference lowers and compiles a jitted step for 256 or 512 forced
host devices and reads XLA's analyses, the port runs its own eager step
on tensors that have a shape and a dtype and no memory, as rank 0 of a
``torch.distributed`` group whose backend is ``"fake"`` (every
collective returns at once).  For each cell the dry run:

1. joins a fake process group of the mesh's size and builds the
   production mesh (:func:`repro_torch.launch.mesh.make_production_mesh`:
   16 × 16 ('data', 'model'), or 2 × 16 × 16 with 'pod') and its rules
   (:func:`repro_torch.sharding.rules.make_rules`);
2. builds this rank's blocks of the params, the optimizer state (ZeRO:
   the ``opt_state=True`` placements), the batch and the decode cache on
   ``meta`` (:mod:`repro_torch.launch.specs`);
3. runs the port's train, prefill or decode step
   (:mod:`repro_torch.train.step`) once on them under the rules, every
   kernel op running its plain version's shapes (a ``meta`` tensor is not
   a card's);
4. writes a record to ``<out>/<arch>__<shape>__<mesh>[__<tag>].json``.

Each record has the reference's keys where they mean the same thing
(``arch``, ``shape``, ``mesh``, ``mode``, ``seq_len``, ``global_batch``,
``options``, ``params``, ``active_params``, ``num_layers``,
``compression`` with ``--budget``, ``status``) and this rank's figures:

* ``memory.argument_size_in_bytes`` / ``output_size_in_bytes`` — the
  bytes of the step's arguments and results, exact from the block
  shapes;
* ``cost.flops`` — the step's floating-point operations, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions
  and attention; elementwise work is not counted);
* ``collectives`` — calls (``count``) and bytes per operation under the
  reference's names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``) and ``total_bytes``, from
  :func:`repro_torch.sharding.collectives.collective_counts`: the bytes
  are the payload this rank hands each call (an all-gather counts its
  input block, where the reference counts the result's shape);
  ``collective_ops`` keeps the port's own keys, each direction apart;
* ``lower_s`` — the seconds the step took on ``meta``.

Keys with no honest counterpart are left out: ``compile_s`` and
``hlo_bytes`` (nothing is compiled; the step is eager), and the temp and
peak memory (``meta`` tensors allocate nothing, so there is no
allocator to read).  ``--no-remat`` trains without rematerializing
(the published configs rematerialize, :func:`repro_torch.models.
transformer.remat_policy`): with remat the count holds the backward's
recomputed products, and under FSDP the collectives its gathers again.
The port keeps no ``--probe`` and ``--no-scan``: they exist because XLA
counts a scanned loop body once, and the port does not scan.
``--seq-parallel`` (and
the reference's automatic sequence split of prefill at 32k) names the
rules' 'seq' entry; the port's forward splits no sequence, so it is
recorded and changes no shape.  A step that reads a tensor's value on
the host fails on ``meta``: such a cell fails with the operation's
error, and nothing is faked around it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch a] [--shape s]
      [--mesh single|multi|both] [--out build/dryrun] [--no-fsdp]
      [--seq-parallel] [--microbatches N] [--flash-decode] [--no-remat]
      [--no-decode-kv-model] [--budget R] [--tag name]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --spec CELL.json

``--spec`` runs one cell of any mesh shape over a fake world of its size
(the JSON names ``arch``, config ``overrides``, a ``shape`` —
``{seq_len, global_batch, mode}`` — a ``mesh`` shape, ``options`` and an
optional ``units_spec``) and prints its record as the last line: how a
small mesh's dry run is held against a real world's step.  No card is
needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, LONG_CONTEXT_OK, SHAPES,
                                      ShapeConfig, get_config)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (build_mesh, make_production_mesh,
                                     mesh_info)
from repro_torch.models import transformer as T
from repro_torch.models import transformer_host as TH
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (make_rules,
                                        param_shardings_with_shapes, put,
                                        use_rules)
from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                    make_train_step)

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
#: The port's collective keys (:func:`repro_torch.sharding.collectives.
#: collective_counts`, a ``:bwd`` suffix stripped) by the reference's
#: operation names.
OP_NAMES = {"all_reduce_sum": "all-reduce", "all_reduce_max": "all-reduce",
            "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "collective_permute": "collective-permute"}


def collectives_record(counts: dict) -> dict:
    """:func:`collective_counts` under the reference's operation names,
    both directions summed, with ``total_bytes``."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_OPS}
    for key, v in counts.items():
        op = OP_NAMES[key.split(":")[0]]
        out[op]["count"] += v["calls"]
        out[op]["bytes"] += v["bytes"]
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def fake_world(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks
    (``torch.distributed`` backend ``"fake"``: collectives return at
    once); a fake group of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@dataclasses.dataclass
class CellOptions:
    fsdp: bool = True
    seq_parallel: bool = False
    microbatches: int = 1
    #: Rematerialize where the config does (``--no-remat``: never).
    remat: bool = True
    decode_kv_model: bool = True
    flash_decode: bool = False
    #: Run the LayerMerge-compressed network at this latency budget (its
    #: plan from the analytic tables, :func:`~repro_torch.models.
    #: transformer_host.abstract_plan`); train and prefill shapes.
    layermerge_budget: float | None = None


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def run_on_mesh(cfg, shape, mesh, opts: CellOptions = CellOptions(), *,
                arch: str | None = None, units_spec=None,
                device="meta") -> dict:
    """One cell on ``mesh`` (a :class:`~repro_torch.launch.mesh.HostMesh`
    of the process group this process is rank 0 of): ``cfg``'s step at
    ``shape`` (a name of ``SHAPES`` or a ``ShapeConfig``) under
    ``opts``, on ``device`` tensors (``meta``: shapes only).
    ``units_spec`` (:func:`~repro_torch.models.transformer_host.
    plan_units_spec`'s form) gives the compressed network's units
    directly, in place of ``opts.layermerge_budget``'s plan."""
    cfg = dataclasses.replace(cfg, decode_flash=opts.flash_decode,
                              remat=cfg.remat and opts.remat)
    shape = _shape(shape)
    seq_par = opts.seq_parallel or (shape.mode == "prefill"
                                    and shape.seq_len >= 32768)
    rules = make_rules(mesh, fsdp=opts.fsdp, seq_parallel=seq_par,
                       decode_kv_model=opts.decode_kv_model)
    chips = math.prod(mesh.shape.values())
    rec_plan = None
    if units_spec is None and opts.layermerge_budget is not None:
        env = TH.CostEnv(batch=shape.global_batch, seq=shape.seq_len,
                         chips=chips)
        cres = TH.abstract_plan(cfg, budget_ratio=opts.layermerge_budget,
                                env=env)
        if cres is None:
            raise RuntimeError("no feasible LayerMerge plan at this budget")
        units_spec = TH.plan_units_spec(cfg, cres.plan)
        rec_plan = {"budget": opts.layermerge_budget,
                    "predicted_speedup": cres.speedup}
    if units_spec is not None:
        units_spec = [tuple(u) for u in units_spec]
        rec_plan = {**(rec_plan or {}),
                    "units": [u[0] if u[0] == "merged" else u[2]
                              for u in units_spec],
                    "merged_ranks": [u[1] for u in units_spec
                                     if u[0] == "merged"]}
        if shape.mode == "decode":
            raise RuntimeError("compressed decode cells are out of scope; "
                               "use train/prefill shapes with --budget")
        whole = TH.init_compressed_model(cfg, units_spec, device=device)
        axes = TH.compressed_model_axes(cfg, units_spec)
    else:
        whole, axes = T.init_model(cfg, device=device)
    params = put(whole, param_shardings_with_shapes(rules, axes, whole))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_info(mesh),
           "mode": shape.mode, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "options": dataclasses.asdict(opts),
           "params": int(cfg.param_count()),
           "active_params": int(cfg.active_param_count()),
           "num_layers": cfg.num_layers}
    if rec_plan is not None:
        rec["compression"] = rec_plan
    batch_ax = S.batch_axes(cfg, shape, with_targets=shape.mode == "train")
    b_specs = {k: v.to(device) for k, v in S.batch_specs(
        cfg, shape, with_targets=shape.mode == "train").items()}
    batch = put(b_specs, {k: rules.named(batch_ax[k], tuple(v.shape))
                          for k, v in b_specs.items()})
    forward_fn = TH.spec_forward(cfg, units_spec) \
        if units_spec is not None else None
    with use_rules(rules):
        if shape.mode == "train":
            # optimizer moments always fully sharded (ZeRO; with
            # --no-fsdp the ZeRO-1 layout)
            o_rules = make_rules(mesh, fsdp=True, seq_parallel=seq_par,
                                 decode_kv_model=opts.decode_kv_model,
                                 opt_state=True)
            m_shard = param_shardings_with_shapes(o_rules, axes, whole)
            opt = init_opt_state(params, shardings=m_shard)
            step = make_train_step(cfg, AdamWConfig(),
                                   microbatches=opts.microbatches,
                                   forward_fn=forward_fn,
                                   grad_shardings=m_shard)
            args = (params, opt, batch)
        elif shape.mode == "prefill":
            step = forward_fn if forward_fn is not None \
                else make_prefill_step(cfg)
            args = (params, batch)
        else:
            cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=device)
            step = make_serve_step(cfg)
            args = (params, cache, batch)
        arg_bytes = tree_bytes(args)
        from torch.utils.flop_counter import FlopCounterMode
        C.reset_collective_counts()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        rec["lower_s"] = round(time.perf_counter() - t0, 2)
    counts = C.collective_counts()
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": tree_bytes(out)}
    rec["cost"] = {"flops": float(fc.get_total_flops())}
    rec["collectives"] = collectives_record(counts)
    rec["collective_ops"] = counts
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: CellOptions = CellOptions()) -> dict:
    """One production cell: a fake world of 256 (512 with ``multi_pod``)
    ranks, the production mesh, :func:`run_on_mesh`."""
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    return run_on_mesh(get_config(arch), shape_name, mesh, opts, arch=arch)


def run_spec(spec: dict) -> dict:
    """One cell from a ``--spec`` dict (see the module docstring)."""
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              **spec.get("overrides", {}))
    sh = spec["shape"]
    shape = ShapeConfig(sh.get("name", "spec"), int(sh["seq_len"]),
                        int(sh["global_batch"]), sh["mode"])
    mesh_shape = dict(spec["mesh"])
    n = math.prod(mesh_shape.values())
    fake_world(n)
    mesh = build_mesh(mesh_shape, range(n))
    rec = run_on_mesh(cfg, shape, mesh, CellOptions(**spec.get("options",
                                                               {})),
                      arch=spec["arch"], units_spec=spec.get("units_spec"))
    rec["status"] = "ok"
    return rec


def cell_list(args):
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for a in archs:
        for s in shapes:
            if s == "long_500k" and a not in LONG_CONTEXT_OK:
                continue  # the reference's documented skip
            for m in meshes:
                cells.append((a, s, m))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true",
                    help="train without rematerializing the layers")
    ap.add_argument("--no-decode-kv-model", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--flash-decode", action="store_true",
                    help="decode attention through the LSE combine")
    ap.add_argument("--budget", type=float, default=None,
                    help="run the LayerMerge-compressed net at this "
                         "latency-budget ratio (train/prefill shapes)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--spec", default=None, metavar="CELL.json",
                    help="one cell of any mesh from a JSON spec; its "
                         "record is the last line printed")
    args = ap.parse_args(argv)

    if args.spec:
        with open(args.spec) as f:
            rec = run_spec(json.load(f))
        print(json.dumps(rec))
        return 0
    os.makedirs(args.out, exist_ok=True)
    opts = CellOptions(fsdp=not args.no_fsdp,
                       seq_parallel=args.seq_parallel,
                       microbatches=args.microbatches,
                       remat=not args.no_remat,
                       decode_kv_model=not args.no_decode_kv_model,
                       flash_decode=args.flash_decode,
                       layermerge_budget=args.budget)
    failures = 0
    for arch, shape, multi in cell_list(args):
        mesh_tag = "multi" if multi else "single"
        name = f"{arch}__{shape}__{mesh_tag}"
        if args.tag:
            name += f"__{args.tag}"
        print(f"[dryrun] {name} ...", flush=True)
        try:
            rec = run_cell(arch, shape, multi, opts)
            rec["status"] = "ok"
            print(f"[dryrun] {name}: OK lower={rec['lower_s']}s "
                  f"flops={rec['cost']['flops']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"args={rec['memory']['argument_size_in_bytes']:.3e}B",
                  flush=True)
        except Exception as e:
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": "fail", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] {name}: FAIL {type(e).__name__}: {e}",
                  flush=True)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
