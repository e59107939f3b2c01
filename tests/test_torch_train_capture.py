"""The captured train step and the loop around it, on the CPU.

``capture_train_step`` records :func:`repro_torch.train.step.train_body`
in a CUDA graph; here, with no card, the body runs eagerly and is held
against ``make_train_step``:

* three steps of the body equal three ``make_train_step`` steps
  **bitwise** (losses, grad norms, learning rates, every param, moment and
  the step counter), from the same params and zero moments: SmolLM-135M
  reduced, RecurrentGemma-2B reduced (its remat on), two microbatches,
  and a compressed graph (``make_compressed_forward`` over a port
  artifact of the reduced SmolLM-135M); AdamW writes the step counter in
  place with the params and moments;
* ``capture_train_step`` refuses the CPU and active sharding rules, each
  with its reason (gloo cannot be captured);
* ``tree_copy_`` and the loop's restore write the checkpoint into the
  live tensors: the same tensor objects hold the checkpoint's values
  after a restart, every step of the loop sees the same tensors, and a
  restart before any checkpoint starts again from the caller's params
  (its first loss repeats bitwise).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import runtime
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.compress import main as compress_main
from repro_torch.configs import get_config
from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import build_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as TA
from repro_torch.sharding.rules import make_rules, use_rules
from repro_torch.train import loop as TL
from repro_torch.train import step as TS
from repro_torch.tree import flatten_tree, tree_copy_, tree_map

OPT = TA.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                     weight_decay=0.1)


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _batches(cfg, n=3, rows=4, seq=16):
    batcher = GlobalBatcher(SyntheticTokens(cfg.vocab_size, rows, seq,
                                            seed=7), device="cpu")
    return [batcher(i) for i in range(n)]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "smollm.npz")
    compress_main(["--arch", "smollm-135m", "--device", "cpu", "--method",
                   "depth", "--budget-ratio", "0.7", "--out", path])
    return runtime.load(path, device="cpu")


def _case(name, artifact):
    """(config, params, step) of a case."""
    if name == "compressed":
        graph = artifact.graph
        cfg = graph.meta["config"]
        assert runtime.count_units(graph).get("lowrank", 0) > 0
        fwd = TS.make_compressed_forward(graph, device="cpu")
        return cfg, runtime.graph_params(graph), \
            TS.make_train_step(cfg, OPT, forward_fn=fwd)
    arch, kw, micro = {
        "smollm": ("smollm-135m", {}, 1),
        "recurrentgemma": ("recurrentgemma-2b", {"remat": True}, 1),
        "microbatches": ("smollm-135m", {}, 2)}[name]
    cfg = _cfg(arch, **kw)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    return cfg, params, TS.make_train_step(cfg, OPT, microbatches=micro)


@pytest.mark.parametrize("name", ["smollm", "recurrentgemma",
                                  "microbatches", "compressed"])
def test_captured_body_equals_the_eager_step(name, artifact):
    cfg, p0, step = _case(name, artifact)
    batches = _batches(cfg)
    runs = {}
    for way in ("step", "body"):
        params = tree_map(torch.clone, p0)
        state = TA.init_opt_state(params)
        ids = [id(t) for t in flatten_tree({"p": params, "s": state})
               .values()]
        metrics = []
        for b in batches:
            if way == "step":
                _, _, m = step(params, state, b)
            else:
                m = TS.train_body(step, params, state, b)
                assert sorted(m) == ["grad_norm", "loss", "lr"]
                assert all(v.ndim == 0 for v in m.values())
            metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        flat = flatten_tree({"p": params, "s": state})
        # every tensor written in place: the counter too
        assert [id(t) for t in flat.values()] == ids
        assert int(state["step"]) == len(batches)
        runs[way] = (metrics, flat)
    assert runs["body"][0] == runs["step"][0]
    assert all(np.isfinite(runs["body"][0]).ravel())
    for k, v in runs["step"][1].items():
        assert torch.equal(runs["body"][1][k], v), k


def test_capture_refuses_the_cpu():
    cfg = _cfg("smollm-135m")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    step = TS.make_train_step(cfg, OPT)
    with pytest.raises(RuntimeError, match="CUDA graph.*on cpu"):
        TS.capture_train_step(step, params, TA.init_opt_state(params),
                              _batches(cfg, 1)[0])


def test_capture_refuses_rules():
    cfg = _cfg("smollm-135m")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    step = TS.make_train_step(cfg, OPT)
    D.fake_world(4)
    try:
        rules = make_rules(build_mesh({"data": 2, "model": 2}, range(4)))
        with use_rules(rules), pytest.raises(RuntimeError,
                                             match="gloo cannot be captured"):
            TS.capture_train_step(step, params, TA.init_opt_state(params),
                                  _batches(cfg, 1)[0])
    finally:
        dist.destroy_process_group()


def test_tree_copy_writes_in_place():
    live = {"a": torch.zeros(3), "b": [torch.ones(2, 2)]}
    objs = [live["a"], live["b"][0]]
    tree_copy_(live, {"a": torch.arange(3.0), "b": [torch.full((2, 2), 5.0)]})
    assert live["a"] is objs[0] and live["b"][0] is objs[1]
    assert torch.equal(live["a"], torch.arange(3.0))
    assert torch.equal(live["b"][0], torch.full((2, 2), 5.0))
    with pytest.raises(ValueError, match="differ"):
        tree_copy_(live, {"a": torch.zeros(3)})


def _tiny():
    cfg = dataclasses.replace(
        get_config("smollm-135m"), num_layers=2, d_model=32, num_heads=2,
        num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
        dtype="float32", remat=True)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params, GlobalBatcher(SyntheticTokens(cfg.vocab_size, 4, 16,
                                                      seed=0), device="cpu")


def test_restart_restores_into_the_live_tensors(tmp_path, monkeypatch):
    """A device loss at step 7 (checkpoints every 5): the step after the
    restart sees the tensors of every other step, holding what step 5
    saved."""
    cfg, params, batcher = _tiny()
    seen = []
    made = TL.make_train_step

    def spying(*a, **kw):
        step = made(*a, **kw)

        def spy(p, s, b):
            seen.append(({k: (id(t), t.clone()) for k, t in
                          flatten_tree({"params": p, "opt": s}).items()}))
            return step(p, s, b)
        return spy
    monkeypatch.setattr(TL, "make_train_step", spying)
    fired = []

    def bomb(step):
        if step == 7 and not fired:
            fired.append(step)
            raise RuntimeError("simulated device loss")
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=10),
                        TL.LoopConfig(total_steps=10, ckpt_every=5,
                                      ckpt_dir=str(tmp_path), log_every=100),
                        params, batcher, failure_hook=bomb,
                        logger=lambda s: None)
    assert res.restarts == 1 and len(seen) == 12
    assert all({k: v[0] for k, v in s.items()}
               == {k: v[0] for k, v in seen[0].items()} for s in seen)
    like = flatten_tree({"params": res.params, "opt": res.opt_state})
    saved = flatten_tree(TCK.restore(str(tmp_path), 5, {
        "params": res.params, "opt": res.opt_state}))
    after = seen[7]                 # the first step after the restart
    for k, (obj, val) in after.items():
        assert obj == id(like[k]) and torch.equal(val, saved[k]), k
    assert res.losses[5:7] == res.losses[7:9]


def test_restart_before_a_checkpoint_starts_from_the_callers_params(
        tmp_path):
    cfg, params, batcher = _tiny()
    fired = []

    def bomb(step):
        if step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("simulated device loss")
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=4),
                        TL.LoopConfig(total_steps=4, ckpt_every=10,
                                      ckpt_dir=str(tmp_path), log_every=100),
                        params, batcher, failure_hook=bomb,
                        logger=lambda s: None)
    assert res.restarts == 1 and len(res.losses) == 6
    assert res.losses[:2] == res.losses[2:4]
