"""The ranks' side of ``tests/test_torch_mesh_train.py``.

Each ``world_*`` function runs in one rank of a
:func:`repro_torch.testing.world.run_world` world (``gloo`` on the CPU)
and returns plain numpy/python results; this module imports ``torch`` and
``repro_torch`` only (the world blocks ``jax``).  ``spec_path`` names the
JSON the test wrote: the ``.npz`` of the inputs and a scratch directory.

The single-device side of every comparison (:func:`train_single`,
:func:`grad_cases_whole`) is here too, so the test runs the same code in
its own process.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.data.pipeline import GlobalBatcher
from repro_torch.launch.mesh import build_mesh, make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models import transformer_host as TH
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (Placement, make_rules,
                                        param_shardings_with_shapes, put,
                                        use_rules)
from repro_torch.runtime import ir
from repro_torch.train.step import (make_compressed_forward, make_serve_step,
                                    make_train_step)
from repro_torch.tree import flatten_tree

ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "xlstm-125m")
#: name → (fsdp params, grad shardings from make_rules(fsdp=True,
#: opt_state=True), microbatches, batches from GlobalBatcher(mesh=))
PRESETS = {"fsdp": (True, True, 1, False),
           "tp_dp": (False, False, 1, True),
           "zero": (False, True, 2, False)}
STEPS = 3
B, S = 8, 16
#: eps 1e-6: Adam divides m by sqrt(v) + eps, so a gradient within eps
#: of 0 turns the last-bit noise of two summation orders into an O(lr)
#: update; at 1e-6 that noise stays far inside the 2e-4 tolerance.
OPT = AdamWConfig(lr=1e-3, eps=1e-6, warmup_steps=1, total_steps=10)


#: The world's data axis: the sharded step routes each data block of the
#: MoE's tokens as its own group (the reference's grouping), so the
#: single device routes in as many groups (``moe.grouped_routing``).
DATA = 2


def config(arch):
    """The reduced config, the MoE at its own capacity factor (1.25:
    tokens drop, by group)."""
    cfg = get_config(arch).reduced()
    if arch == "xlstm-125m":        # one sLSTM and one mLSTM layer
        cfg = dataclasses.replace(cfg, num_layers=2,
                                  temporal_pattern=("slstm", "mlstm"))
    return cfg


class Batches:
    """Batch ``i`` of the test's arrays, whole (int64 ids)."""

    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, i):
        return {"tokens": self.arrays[f"tok/{i}"],
                "targets": self.arrays[f"tgt/{i}"]}


def _whole_batch(arrays, i):
    return {k: torch.from_numpy(v) for k, v in
            Batches(arrays).batch_at(i).items()}


def train_single(arch, arrays, microbatches=1):
    """``(losses, grad norms, params)``: the port's single-device
    steps."""
    cfg = config(arch)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, OPT, microbatches=microbatches)
    losses, norms = [], []
    with MOE.grouped_routing(DATA):
        for i in range(STEPS):
            params, opt, m = step(params, opt, _whole_batch(arrays, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.numpy().copy()
                           for k, v in flatten_tree(params).items()}


def train_sharded(arch, preset, arrays, mesh):
    """``(losses, grad norms, whole params, collectives of the last step,
    moment shapes)`` of the sharded step under ``preset``."""
    fsdp, zero, micro, batcher = PRESETS[preset]
    cfg = config(arch)
    whole, axes = T.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rules = make_rules(mesh, fsdp=fsdp)
    params = put(whole, param_shardings_with_shapes(rules, axes, whole))
    gs = None
    if zero:
        gs = param_shardings_with_shapes(
            make_rules(mesh, fsdp=True, opt_state=True), axes, whole)
    opt = init_opt_state(params, shardings=gs)
    step = make_train_step(cfg, OPT, microbatches=micro, grad_shardings=gs)
    gb = GlobalBatcher(Batches(arrays), mesh=mesh, device="cpu")
    losses, norms = [], []
    with use_rules(rules):
        for i in range(STEPS):
            batch = gb(i) if batcher else _whole_batch(arrays, i)
            C.reset_collective_counts()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        coll = C.collective_counts()
        full = CK.gather_whole(params)
    mu = {k: tuple(v.shape) for k, v in flatten_tree(opt["mu"]).items()}
    return (losses, norms, {k: v.numpy().copy() for k, v in
                            flatten_tree(full).items()}, coll, mu)


# ---------------------------------------------------------------------------
# A LayerMerge-compressed network, trained sharded
# ---------------------------------------------------------------------------

#: The compressed network: the reduced smollm at 4 layers, its units
#: (``plan_units_spec``) the test's, in the spec JSON.
COMPRESSED_CFG = dict(num_layers=4)
#: name → (fsdp params, grad shardings from make_rules(fsdp=True,
#: opt_state=True), the forward: ``spec_forward`` over the spec's params
#: or ``make_compressed_forward`` over its unit graph's)
COMPRESSED_PRESETS = {"fsdp": (True, True, "spec"),
                      "tp_dp": (False, False, "graph")}


def compressed_config():
    return dataclasses.replace(config("smollm-135m"), **COMPRESSED_CFG)


def compressed_batch(arrays, i):
    """Batch ``i`` as the dry run's specs lay it out: int32 ``positions``,
    ``tokens`` and ``targets``."""
    b = _whole_batch(arrays, i)
    tok = b["tokens"].to(torch.int32)
    return {"positions": torch.arange(tok.shape[1], dtype=torch.int32)
            .expand(tok.shape).contiguous(), "tokens": tok,
            "targets": b["targets"].to(torch.int32)}


def _spec_params(units_spec):
    return TH.init_compressed_model(compressed_config(), units_spec,
                                    torch.Generator().manual_seed(4),
                                    device="cpu")


def _graph_as_spec(gp):
    """:func:`repro_torch.runtime.ir.graph_params` in the spec's tree."""
    return {"units": gp["units"], **gp["globals"]}


def train_compressed_single(arrays, units_spec):
    """``(losses, grad norms, params)``: the single device's steps through
    ``make_compressed_forward`` over the spec's unit graph."""
    cfg = compressed_config()
    graph = TH.spec_graph(cfg, units_spec, _spec_params(units_spec))
    params = ir.graph_params(graph)
    opt = init_opt_state(params)
    step = make_train_step(cfg, OPT, forward_fn=make_compressed_forward(
        graph, device="cpu"))
    losses, norms = [], []
    for i in range(STEPS):
        params, opt, m = step(params, opt, compressed_batch(arrays, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {k: v.numpy().copy() for k, v in flatten_tree(
        _graph_as_spec(params)).items()}


def train_compressed_sharded(preset, arrays, units_spec, mesh):
    """The sharded steps of the compressed network under ``preset``:
    ``(losses, grad norms, whole params in the spec's tree, collectives
    of the last step, argument bytes of the last step)``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import batch_axes
    from repro_torch.configs.base import ShapeConfig

    fsdp, zero, forward = COMPRESSED_PRESETS[preset]
    cfg = compressed_config()
    whole = _spec_params(units_spec)
    rules = make_rules(mesh, fsdp=fsdp)
    if forward == "spec":
        axes = TH.compressed_model_axes(cfg, units_spec)
        params = put(whole, param_shardings_with_shapes(rules, axes, whole))
        forward_fn = TH.spec_forward(cfg, units_spec)
    else:
        graph = TH.spec_graph(cfg, units_spec, whole)
        axes = ir.graph_axes(graph)
        whole = ir.graph_params(graph)
        params = put(whole, param_shardings_with_shapes(rules, axes, whole))
        forward_fn = make_compressed_forward(
            ir.bind_params(graph, params), device="cpu")
    gs = param_shardings_with_shapes(
        make_rules(mesh, fsdp=True, opt_state=True), axes, whole) \
        if zero else None
    opt = init_opt_state(params, shardings=gs)
    step = make_train_step(cfg, OPT, forward_fn=forward_fn,
                           grad_shardings=gs)
    shape = ShapeConfig("w", S, B, "train")
    bax = batch_axes(cfg, shape, with_targets=True)
    losses, norms = [], []
    with use_rules(rules):
        for i in range(STEPS):
            b = compressed_batch(arrays, i)
            batch = put(b, {k: rules.named(bax[k], tuple(v.shape))
                            for k, v in b.items()})
            arg_bytes = dryrun.tree_bytes((params, opt, batch))
            C.reset_collective_counts()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        coll = C.collective_counts()
        full = CK.gather_whole(params)
    if forward == "graph":
        full = _graph_as_spec(full)
    return (losses, norms, {k: v.numpy().copy() for k, v in
                            flatten_tree(full).items()}, coll, arg_bytes)


def _gpipe(arrays):
    """``gpipe_forward`` of the reference test's tanh stages on a pod-4
    mesh of the world's ranks, each rank handed its block of the stage
    weights; and the sends it counted."""
    mesh = build_mesh({"pod": 4}, range(4))
    idx = mesh.index("pod")
    wp = torch.from_numpy(arrays["gp_w"])
    C.reset_collective_counts()
    y = C.gpipe_forward(lambda w, xm: torch.tanh(xm @ w),
                        wp[idx:idx + 1], torch.from_numpy(arrays["gp_x"]),
                        mesh=mesh, axis="pod", num_micro=4)
    return y.numpy(), C.collective_counts()


# ---------------------------------------------------------------------------
# Each collective's gradient against autograd of its whole-tensor version
# ---------------------------------------------------------------------------

def _grad_inputs(arrays):
    return {k[len("g/"):]: torch.from_numpy(v) for k, v in arrays.items()
            if k.startswith("g/")}


def grad_cases_whole(arrays):
    """The whole-tensor versions' gradients (one process)."""
    a = _grad_inputs(arrays)
    out = {}
    # column- then row-parallel MLP: enter_split + all_reduce
    x, w1, w2, c = (a[k].clone().requires_grad_(k != "c")
                    for k in ("x", "w1", "w2", "c"))
    loss = torch.sum((torch.relu(x @ w1) @ w2) * c)
    out["mlp"] = [t.numpy() for t in torch.autograd.grad(loss, (x, w1, w2))]
    # all_gather of row blocks feeding a replicated loss
    t = a["t"].clone().requires_grad_(True)
    out["gather"] = torch.autograd.grad(torch.sum(torch.tanh(t) * a["ct"]),
                                        t)[0].numpy()
    # a weight used whole by every rank on its own rows (gather_weight)
    w = a["w"].clone().requires_grad_(True)
    loss = torch.sum(torch.square(a["xr"] @ w))
    out["weight"] = torch.autograd.grad(loss, w)[0].numpy()
    # two weights in one bucket, split along different dimensions
    w, u = (a[k].clone().requires_grad_(True) for k in ("w", "u"))
    loss = torch.sum(torch.square(a["xr"] @ w @ u))
    out["weights"] = [g.numpy() for g in torch.autograd.grad(loss, (w, u))]
    # the NLL of logits whose vocab is split (vocab_parallel_nll)
    z = a["z"].clone().requires_grad_(True)
    nll = T.token_nll(z, torch.from_numpy(arrays["g_tgt"]))
    out["vocab_nll"] = [nll.detach().numpy(), torch.autograd.grad(
        torch.sum(nll * a["cn"]), z)[0].numpy()]
    return out


def grad_cases_sharded(arrays, mesh):
    """This rank's gradients through the collectives (data 2 × model 2),
    each gathered whole for the comparison: an MLP whose hidden width is
    split over 'model' (``enter_split`` in, ``all_reduce`` out), row
    blocks over 'data' gathered into a replicated loss (``all_gather``),
    and a weight split over 'data' that each data rank uses whole on its
    own rows (``gather_weight``)."""
    a = _grad_inputs(arrays)
    d, m = mesh.index("data"), mesh.index("model")
    out = {}
    h = a["w1"].shape[1] // 2
    x = a["x"].clone().requires_grad_(True)
    w1 = a["w1"][:, m * h:(m + 1) * h].clone().requires_grad_(True)
    w2 = a["w2"][m * h:(m + 1) * h].clone().requires_grad_(True)
    y = C.all_reduce(torch.relu(C.enter_split(x, mesh, "model") @ w1) @ w2,
                     mesh, "model")
    gx, g1, g2 = torch.autograd.grad(torch.sum(y * a["c"]), (x, w1, w2))
    out["mlp"] = [gx.numpy(), C.all_gather(g1, mesh, "model", 1).numpy(),
                  C.all_gather(g2, mesh, "model", 0).numpy()]
    r = a["t"].shape[0] // 2
    t = a["t"][d * r:(d + 1) * r].clone().requires_grad_(True)
    tw = C.all_gather(t, mesh, "data", dim=0)
    g = torch.autograd.grad(torch.sum(torch.tanh(tw) * a["ct"]), t)[0]
    out["gather"] = C.all_gather(g, mesh, "data", 0).numpy()
    k = a["w"].shape[0] // 2
    w = a["w"][d * k:(d + 1) * k].clone().requires_grad_(True)
    rows = a["xr"].shape[0] // 2
    xr = a["xr"][d * rows:(d + 1) * rows]
    ww = C.gather_weight(w, mesh, "data", dim=0)
    g = torch.autograd.grad(torch.sum(torch.square(xr @ ww)), w)[0]
    out["weight"] = C.all_gather(g, mesh, "data", 0).numpy()
    q = a["u"].shape[1] // 2
    u = a["u"][:, d * q:(d + 1) * q].clone().requires_grad_(True)
    w = a["w"][d * k:(d + 1) * k].clone().requires_grad_(True)
    ww, uu = C.gather_weights([w, u], [0, 1], mesh, "data")
    gw, gu = torch.autograd.grad(torch.sum(torch.square(xr @ ww @ uu)),
                                 (w, u))
    out["weights"] = [C.all_gather(gw, mesh, "data", 0).numpy(),
                      C.all_gather(gu, mesh, "data", 1).numpy()]
    v = a["z"].shape[-1] // 2
    z = a["z"][..., m * v:(m + 1) * v].clone().requires_grad_(True)
    with use_rules(make_rules(mesh, fsdp=False)):
        nll = L.vocab_parallel_nll(z, torch.from_numpy(arrays["g_tgt"]))
    g = torch.autograd.grad(torch.sum(nll * a["cn"]), z)[0]
    out["vocab_nll"] = [nll.detach().numpy(),
                        C.all_gather(g, mesh, "model", -1).numpy()]
    out["counts"] = C.collective_counts()
    return out


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

def _moe(arrays, mesh):
    """The expert-parallel MoE of the reduced granite on this rank's rows
    (its experts, data block), gathered back to the whole batch; at the
    config's own capacity factor, so tokens drop."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = {k[len("moe/"):]: torch.from_numpy(v) for k, v in arrays.items()
         if k.startswith("moe/")}
    rules = make_rules(mesh, fsdp=False)
    axes = MOE.moe_axes()
    local = put(p, param_shardings_with_shapes(rules, axes, p))
    x = torch.from_numpy(arrays["moe_x"])
    r = x.shape[0] // mesh.shape["data"]
    d = mesh.index("data")
    with use_rules(rules):
        C.reset_collective_counts()
        y = MOE.moe_dispatch(local, x[d * r:(d + 1) * r], cfg,
                             capacity_factor=cfg.capacity_factor)
        coll = C.collective_counts()
        y = C.all_gather(y, mesh, "data", dim=0)
    return y.numpy(), tuple(local["w_gate"].shape), coll


def _xlstm_decode(arrays, mesh, new_tokens=4):
    """Greedy decode of the reduced xLSTM: under the mesh (heads split)
    and on one device, from the same prompt."""
    cfg = config("xlstm-125m")
    whole, axes = T.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompt = torch.from_numpy(arrays["tok/0"][:4, :6])
    step = make_serve_step(cfg)

    def run(params):
        cache = T.init_cache(cfg, prompt.shape[0], 16, device="cpu")
        toks, logits = [], None
        with torch.no_grad():
            for t in range(prompt.shape[1]):
                logits, cache = step(params, cache,
                                     {"tokens": prompt[:, t:t + 1]})
            for _ in range(new_tokens):
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                toks.append(tok)
                logits, cache = step(params, cache, {"tokens": tok})
        return torch.cat(toks, 1).numpy(), logits.numpy(), cache
    single = run(whole)
    rules = make_rules(mesh, fsdp=False)
    with use_rules(rules):
        local = put(whole, param_shardings_with_shapes(rules, axes, whole))
        sharded = run(local)
    state = {k: tuple(v.shape) for k, v in sharded[2][1].items()}
    return single[0], sharded[0], single[1], sharded[1], state


def _elastic(spec, mesh):
    """Save a 2 × 2 run's sharded tree; restore it on a data 1 × model 4
    mesh, and the test's one-process save onto the 2 × 2 mesh."""
    d = spec["dir"]
    a = torch.arange(64.0).reshape(8, 8)
    tree = {"w": a, "b": torch.arange(8.0), "n": torch.ones(3)}
    places = {"w": Placement(mesh, ("data", "model")),
              "b": Placement(mesh, ("model",)), "n": Placement(mesh, ())}
    blocks = put(tree, places)
    CK.save(os.path.join(d, "ck22"), 1, blocks)
    torch.distributed.barrier()
    m14 = make_host_mesh(model=4)
    p14 = {"w": Placement(m14, (None, "model")),
           "b": Placement(m14, ("model",)), "n": None}
    got = CK.restore(os.path.join(d, "ck22"), 1, tree, shardings=p14)
    back = CK.restore(os.path.join(d, "ck1"), 1, tree, shardings=places)
    return {"w14": got["w"].numpy(), "b14": got["b"].numpy(),
            "n14": got["n"].numpy(), "w22": back["w"].numpy(),
            "b22": back["b"].numpy(),
            "w22_spec": back["w"].sharding.spec}


def _loop_restart(spec, arrays, mesh):
    """``train_loop`` under the mesh (tp+dp, batches from
    ``GlobalBatcher(mesh=)``), 5 steps, checkpoints every 2: once with
    every rank's failure hook firing before step 3, once without.  The
    losses of both runs and the failed run's restarts and final step."""
    from repro_torch.train.loop import LoopConfig, train_loop
    cfg = config("smollm-135m")
    whole, axes = T.init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    rules = make_rules(mesh, fsdp=False)
    params = put(whole, param_shardings_with_shapes(rules, axes, whole))
    gb = GlobalBatcher(Batches(arrays), mesh=mesh, device="cpu")
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("simulated device loss at step 3")
    out = {}
    for key, failure in (("failed", hook), ("clean", None)):
        loop = LoopConfig(total_steps=5, ckpt_every=2, log_every=100,
                          ckpt_dir=os.path.join(spec["dir"], f"loop_{key}"))
        with use_rules(rules):
            res = train_loop(cfg, OPT, loop, params, lambda i: gb(i % STEPS),
                             failure_hook=failure, logger=lambda m: None)
        out[key] = {"losses": res.losses, "restarts": res.restarts,
                    "final_step": res.final_step,
                    "params": {k: v.numpy().copy() for k, v in flatten_tree(
                        CK.gather_whole(res.params)).items()}}
    return out


def world_train(rank, spec_path):
    """The data 2 × model 2 world: every train case, the collectives'
    gradients, compressed_allreduce, the sharded MoE, xLSTM decode and
    the elastic restore."""
    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    arrays = dict(np.load(spec["arrays"]))
    mesh = make_host_mesh(model=2)
    out = {"rank": rank, "coords": dict(mesh.coords)}
    out["train"] = {}
    for arch in ARCHS:
        for preset in PRESETS:
            losses, norms, params, coll, mu = train_sharded(
                arch, preset, arrays, mesh)
            out["train"][arch, preset] = (losses, norms, params if rank == 0
                                          else None, coll, mu)
    out["grads"] = grad_cases_sharded(arrays, mesh)
    g = torch.from_numpy(arrays["car_g"])
    n = g.shape[0] // 4
    codes = {}
    res = C.compressed_allreduce({"w": g[rank * n:(rank + 1) * n]},
                                 mesh=mesh, axis=("data", "model"))
    from repro_torch.optim.compress import compressed_psum
    compressed_psum({"w": g[rank * n:(rank + 1) * n]}, mesh,
                    ("data", "model"), codes=codes)
    out["car"] = (res["w"].numpy(), codes["w"].numpy())
    out["compressed"] = {
        preset: train_compressed_sharded(preset, arrays,
                                         spec["units_spec"], mesh)
        for preset in COMPRESSED_PRESETS}
    out["gpipe"] = _gpipe(arrays)
    out["moe"] = _moe(arrays, mesh)
    out["xlstm"] = _xlstm_decode(arrays, mesh)
    out["elastic"] = _elastic(spec, mesh)
    out["loop"] = _loop_restart(spec, arrays, mesh)
    return out
