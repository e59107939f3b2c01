"""The ranks' side of ``tests/test_torch_mesh.py``.

Each ``world_*`` function runs in one rank of a
:func:`repro_torch.testing.world.run_world` world (``gloo`` on the CPU)
and returns plain numpy/python results; this module imports ``torch`` and
``repro_torch`` only (the world blocks ``jax``).  ``spec_path`` names the
JSON the test wrote: artifact paths and the ``.npz`` of the inputs.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.configs import get_config
from repro_torch.kernels import quant
from repro_torch.launch.distributed import survivor_mesh
from repro_torch.launch.mesh import make_host_mesh, mesh_info
from repro_torch.models import transformer as T
from repro_torch.runtime import serving
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (logical_constraint, make_unit_rules,
                                        param_shardings_with_shapes, put,
                                        sharding_of, use_rules)
from repro_torch.train.step import make_serve_step
from repro_torch.tree import flatten_tree


class Codes:
    """Records the per-tensor int8 activation codes that
    ``quant.quantize_int8`` gives while active (w8a8 units, in order)."""

    def __enter__(self):
        self.codes = []
        self._orig = orig = quant.quantize_int8

        def quantize_int8(x, axis=None, **kw):
            q, s = orig(x, axis, **kw)
            if axis is None:
                self.codes.append(q.clone())
            return q, s
        quant.quantize_int8 = quantize_int8
        return self

    def __exit__(self, *exc):
        quant.quantize_int8 = self._orig


def code_flips(whole, local, mesh) -> tuple[int, int]:
    """(codes of the ranks' blocks that differ from the single device's,
    codes compared): each local code tensor is the block of the whole one
    at this rank's data index (rows) and model index (channels)."""
    assert len(whole) == len(local), (len(whole), len(local))
    flips = total = 0
    for w, l in zip(whole, local):
        blk = w
        if l.shape[0] < w.shape[0]:
            n = l.shape[0]
            blk = blk[mesh.index("data") * n:(mesh.index("data") + 1) * n]
        if l.shape[-1] < w.shape[-1]:
            c = l.shape[-1]
            i = mesh.index("model")
            blk = blk[..., i * c:(i + 1) * c]
        flips += int((blk != l).sum())
        total += l.numel()
    return flips, total


def truly_split(graph) -> bool:
    """Whether some weight is a proper block of a 'model' split."""
    for t in flatten_tree(runtime.graph_params(graph)).values():
        sp = sharding_of(t)
        if sp is not None and "model" in sp.spec \
                and tuple(t.shape) != sp.shape:
            return True
    return False


def _cnn(path, x, rules, mesh):
    single = runtime.load(path, device="cpu")
    with Codes() as c1:
        y1 = single.apply(x)
    art = runtime.load(path, rules=rules, device="cpu")
    ex = art.executor(rules)
    C.reset_collective_counts()
    with Codes() as c2:
        y2 = ex.apply(x)
    flips, total = code_flips(c1.codes, c2.codes, mesh)
    return {"y": y2.numpy(), "single": y1.numpy(), "flips": flips,
            "codes": total, "split": truly_split(ex.graph),
            "collectives": C.collective_counts()}


def _lm(path, prompt, rules, new_tokens):
    B, P = prompt.shape
    single = runtime.load(path, device="cpu")
    y1 = single.apply({"tokens": prompt})
    art = runtime.load(path, rules=rules, device="cpu")
    ex = art.executor(rules)
    y2 = ex.apply({"tokens": prompt})
    cache = ex.init_cache(B, P)
    steps = []
    for t in range(P):
        if t == P - 1:
            C.reset_collective_counts()
        logits, cache = ex.decode(cache, prompt[:, t:t + 1])
        steps.append(logits[:, 0])
    per_step = C.collective_counts()
    _, _, lg, seqs = serving.serve_loop_pertoken(
        ex.decode, lambda: ex.init_cache(B, P + new_tokens), prompt,
        new_tokens, rules=rules)
    _, _, lg1, seqs1 = serving.serve_loop_pertoken(
        single.decode, lambda: single.init_cache(B, P + new_tokens), prompt,
        new_tokens)
    local_cache = {k: tuple(v.shape) for k, v in cache[next(
        i for i, c in enumerate(cache) if "k" in c)].items()
        if isinstance(v, torch.Tensor)}
    return {"prefill": y2.numpy(), "single": y1.numpy(),
            "decode": torch.stack(steps, dim=1).numpy(),
            "served": seqs.numpy(), "served_single": seqs1.numpy(),
            "last_logits": lg.numpy(), "last_logits_single": lg1.numpy(),
            "split": truly_split(ex.graph), "decode_collectives": per_step,
            "cache_shapes": local_cache}


def _flash(arrays, mesh):
    q, k, v, valid = (torch.from_numpy(arrays[n])
                      for n in ("fd_q", "fd_k", "fd_v", "fd_valid"))
    b, s = valid.shape
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    r0, nr = C.block(b, mesh, "data") if b % n_data == 0 else (0, b)
    s0, ns = C.block(s, mesh, "model")
    out = C.flash_decode_attention(
        q[r0:r0 + nr], k[r0:r0 + nr, s0:s0 + ns],
        v[r0:r0 + nr, s0:s0 + ns], valid[r0:r0 + nr, s0:s0 + ns], mesh=mesh)
    if nr < b:
        out = C.all_gather(out, mesh, "data", dim=0)
    return out.numpy()


def _raises(fn) -> str | None:
    try:
        fn()
    except (NotImplementedError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _model_forward(arch, batch):
    cfg = get_config(arch).reduced()
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params, T.forward(cfg, params, batch)


def _split_forward(arch, toks, rules, mesh):
    """The reduced ``arch`` forward on this rank's blocks of its params
    (experts or heads split over 'model'), and the single device's on
    each data block's rows (an MoE routes each block as its own group),
    concatenated; the split weight's local shape."""
    cfg, params, _ = _model_forward(arch, {"tokens": toks})
    axes = T.model_axes(cfg)
    local = put(params, param_shardings_with_shapes(rules, axes, params))
    with use_rules(rules):
        y = T.forward(cfg, local, {"tokens": toks})
    half = toks.shape[0] // mesh.shape["data"]
    rows = torch.cat([T.forward(cfg, params, {"tokens": toks[i:i + half]})
                      for i in range(0, toks.shape[0], half)])
    leaf = local["groups"][0]["ffn" if cfg.is_moe else "temporal"]
    return y.numpy(), rows.numpy(), tuple(leaf["w_gate" if cfg.is_moe
                                               else "wo"].shape)


def world_2x2(rank, spec_path):
    """The ('data' 2, 'model' 2) world: host meshes, flash-decoding, the
    sharded CNN executor, the sharded SmolLM and RecurrentGemma
    artifacts, MoE and xLSTM split over 'model', and survivor_mesh."""
    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    arrays = dict(np.load(spec["arrays"]))
    out = {"rank": rank}
    out["mesh"] = {m: mesh_info(make_host_mesh(model=m))["shape"]
                   for m in (1, 2, 4)}
    try:
        make_host_mesh(model=3)
        out["mesh3"] = None
    except ValueError as e:
        out["mesh3"] = str(e)
    mesh = make_host_mesh(model=2)
    rules = make_unit_rules(mesh)
    out["coords"] = dict(mesh.coords)
    out["flash"] = _flash(arrays, mesh)
    out["cnn"] = {name: _cnn(path, torch.from_numpy(arrays[f"cnn_x/{name}"]),
                             rules, mesh)
                  for name, path in spec["cnn"].items()}
    prompt = torch.from_numpy(arrays["lm_prompt"])
    out["lm"] = {name: _lm(path, prompt, rules, spec["new_tokens"])
                 for name, path in spec["lm"].items()}
    toks = torch.from_numpy(arrays["lm_prompt"][:, :4] % 64)
    out["model_split"] = {arch: _split_forward(arch, toks, rules, mesh)
                          for arch in ("granite-moe-1b-a400m", "xlstm-125m")}
    x = torch.arange(24.0).reshape(4, 6)
    with use_rules(rules):
        blk = logical_constraint(x, ("batch", "ffn"))
        back = logical_constraint(blk, (None, None),
                                  current=("data", "model"))
    out["constraint"] = (blk.numpy(), back.numpy())
    sm = survivor_mesh(exclude=(3,))
    out["survivor"] = None if sm.coords is None else {
        "shape": dict(sm.shape),
        "sum": C.all_reduce(torch.ones(1), sm, "data").item()}
    out["survivor_none"] = _raises(lambda: survivor_mesh(
        exclude=(0, 1, 2, 3)))
    return out


def scheduler_config():
    """The reference scheduler test's config (tests/test_runtime_mesh.py)."""
    return dataclasses.replace(
        get_config("smollm-135m").reduced(), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)


def world_data(rank, spec_path):
    """The data-only world ('data' 4): the batched scheduler under the
    mesh, MoE and xLSTM running under it, and the captured serve_loop
    refusing gloo rules."""
    torch.set_num_threads(1)
    spec = json.load(open(spec_path))
    arrays = dict(np.load(spec["arrays"]))
    mesh = make_host_mesh()
    rules = make_unit_rules(mesh)
    out = {"rank": rank, "mesh": mesh_info(mesh)["shape"]}
    cfg = scheduler_config()
    params = _sched_params(arrays)
    step = make_serve_step(cfg)

    def serve(c, t):
        return step(params, c, {"tokens": t})

    def mk(b, s):
        return T.init_cache(cfg, b, s, device="cpu")
    mat = torch.from_numpy(arrays["sched_mat"])
    lens = torch.from_numpy(arrays["sched_lens"])
    g1 = serving.serve_requests(serve, mk, mat, lens, tokens=5, slots=4)[0]
    seen = {}

    def mk_seen(b, s):
        c = mk(b, s)
        seen["rows"] = c[0]["k"].shape[0]
        return c
    g2 = serving.serve_requests(serve, mk_seen, mat, lens, tokens=5,
                                slots=4, rules=rules)[0]
    out["sched"] = (g1.numpy(), g2.numpy(), seen["rows"])
    toks = torch.from_numpy(arrays["lm_prompt"][:, :4] % 64)
    for arch, key in (("granite-moe-1b-a400m", "moe"),
                      ("xlstm-125m", "xlstm")):
        cfg_a, params_a, whole = _model_forward(arch, {"tokens": toks})
        with use_rules(rules):
            y = T.forward(cfg_a, params_a, {"tokens": toks})
        rows = torch.cat([T.forward(cfg_a, params_a,
                                    {"tokens": toks[i:i + 1]})
                          for i in range(toks.shape[0])])
        out[key] = (y.numpy(), whole.numpy(), rows.numpy())
    prompt = torch.from_numpy(arrays["sched_mat"][:4, :3])
    out["serve_loop_raises"] = _raises(lambda: serving.serve_loop(
        serve, lambda: mk(4, 8), prompt, 2, rules=rules))
    out["engine_raises"] = _raises(lambda: serving.ContinuousEngine(
        serve, mk, slots=4, max_seq=8, rules=rules))
    return out


def _sched_params(arrays):
    """The scheduler config's params from the test's numpy tree."""
    flat = {k[len("sched/"):]: v for k, v in arrays.items()
            if k.startswith("sched/")}
    from repro_torch.tree import unflatten_tree
    return T.params_from_numpy(unflatten_tree(flat), device="cpu")


def imports_jax(rank) -> bool:
    """Whether ``import jax`` succeeds in a rank."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return False
    return True


def sleep_forever(rank):
    import time
    time.sleep(3600)
