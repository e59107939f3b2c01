"""The port's LM training path (``lm_loss``, ``repro_torch.train``, the
launcher) against the JAX package's, on the CPU.

Configs: the reduced smollm-135m, recurrentgemma-2b (rglru, rglru,
attn_local with an 8-token window) and qwen2-vl-7b (embeddings frontend,
three distinct M-RoPE streams), fp32, with the same numpy params
(:func:`_torch_parity.np_lm_params`) and batches in both packages.

* ``lm_loss`` (with and without ``loss_mask``) and its gradient match
  ``jax.value_and_grad``: the loss within 1e-5 relative, every gradient
  leaf within 1e-4 · its max |g|;
* three ``make_train_step`` steps match the JAX package's: the loss and
  the pre-update gradients as above, and the updates (params after minus
  before) within 1e-3 · lr + 1e-3 · |update| wherever |g| > 1e-6 at every
  step so far (Adam divides m by sqrt(v), which amplifies the last-bit
  noise of a gradient near 0 into an O(lr) difference there);
* ``microbatches=2`` gives the loss of one batch (1e-6 relative) and its
  updates, compared as above;
* a compressed artifact written by the JAX package fine-tunes in the
  port: its first step's loss and gradients against the JAX package's
  as above, and the loss drops over five steps;
* the fault-tolerant loop, mirroring ``tests/test_ft.py`` (its elastic
  reshard is ``tests/test_torch_mesh_train.py``'s): it trains and
  checkpoints, a failure restarts from the last checkpoint and replays
  its steps bitwise, a killed run resumes, stragglers trip the
  watchdog, the caller's params are left as they were;
* ``python -m repro_torch.launch.train --reduced --device cpu`` trains,
  serves, and refuses ``--distributed`` where the environment names no
  process group.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import get_config as j_get_config
from repro.core import compress as j_compress
from repro.models import transformer as jT
from repro.models.transformer_host import CostEnv, TransformerHost
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch import runtime as trt
from repro_torch.checkpoint import ckpt as TCK
from repro_torch.configs import get_config as t_get_config
from repro_torch.data.pipeline import GlobalBatcher, SyntheticTokens
from repro_torch.models import transformer as tT
from repro_torch.optim import adamw as TA
from repro_torch.train import loop as TL
from repro_torch.train import step as TS
from repro_torch.tree import flatten_tree, tree_map

from _torch_parity import np_lm_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ARCHS = ("smollm-135m", "recurrentgemma-2b", "qwen2-vl-7b")


def _configs(arch):
    return j_get_config(arch).reduced(), t_get_config(arch).reduced()


def _streams(b, s):
    """(3, B, S) M-RoPE streams: a temporal arange, height and width of a
    2×3 patch grid over the first 6 positions, then the text position."""
    t = np.arange(s)
    h = np.where(t < 6, t // 3, t)
    w = np.where(t < 6, t % 3, t)
    return np.broadcast_to(np.stack([t, h, w])[:, None, :],
                           (3, b, s)).astype(np.int32).copy()


def _np_batch(cfg, b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (b, s)).copy()
    else:
        out["embeds"] = (0.3 * rng.standard_normal((b, s, cfg.d_model))) \
            .astype(np.float32)
        out["mrope_positions"] = _streams(b, s)
    return out


def _both(np_tree):
    return (tree_map(lambda x: torch.from_numpy(np.array(x)), np_tree),
            jax.tree.map(jnp.asarray, np_tree))


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_flat(tree):
    return {k: v.detach().numpy() for k, v in flatten_tree(tree).items()}


def _close_loss(t, j):
    assert float(t) == pytest.approx(float(j), rel=LOSS_RTOL)


def _close_grads(tg, jg):
    ft, fj = _torch_flat(tg), _jax_flat(jg)
    assert sorted(ft) == sorted(fj)
    for k, b in fj.items():
        a = ft[k]
        assert a.shape == b.shape, k
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= GRAD_RTOL * scale + 1e-12, \
            (k, float(np.abs(a - b).max()), scale)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg, tcfg = _configs(request.param)
    np_params = np_lm_params(jcfg, seed=1)
    tp, jp = _both(np_params)
    return jcfg, tcfg, tp, jp


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_grads_match_reference(model, masked):
    jcfg, tcfg, tp, jp = model
    nb = _np_batch(jcfg)
    if masked:
        nb["loss_mask"] = (np.random.default_rng(9).random(
            nb["targets"].shape) < 0.6).astype(np.float32)
    tb, jb = _both(nb)
    tl, tg = TS.value_and_grad(lambda p, b: tT.lm_loss(tcfg, p, b), tp, tb)
    jl, jg = jax.value_and_grad(lambda p, b: jT.lm_loss(jcfg, p, b))(jp, jb)
    _close_loss(tl, jl)
    _close_grads(tg, jg)
    assert np.isfinite(float(tl)) and float(tl) > 0


def test_loss_mask_selects_tokens():
    """A mask of ones is the plain mean; a mask that keeps one token is
    that token's NLL; an empty mask divides by 1, not 0."""
    _, tcfg = _configs("smollm-135m")
    tp, _ = _both(np_lm_params(_configs("smollm-135m")[0], seed=1))
    tb, _ = _both(_np_batch(tcfg))
    plain = tT.lm_loss(tcfg, tp, tb)
    ones = tT.lm_loss(tcfg, tp, dict(tb, loss_mask=torch.ones(2, 16)))
    assert torch.equal(plain, ones)
    one = torch.zeros(2, 16)
    one[1, 3] = 1
    nll = tT.token_nll(tT.forward(tcfg, tp, tb), tb["targets"])
    assert float(tT.lm_loss(tcfg, tp, dict(tb, loss_mask=one))) == \
        pytest.approx(float(nll[1, 3]), rel=1e-6)
    assert float(tT.lm_loss(tcfg, tp, dict(
        tb, loss_mask=torch.zeros(2, 16)))) == 0.0


def test_upcast_for_loss_keeps_the_cotangent_dtype():
    """bf16 logits: the view is fp32 and the cotangent comes back bf16,
    as the JAX package's custom VJP gives it; fp32 logits pass through."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16).requires_grad_(True)
    y = tT.upcast_for_loss(xb)
    assert y.dtype == torch.float32
    assert torch.equal(y, xb.detach().float())
    w = torch.linspace(-1, 1, 15).reshape(3, 5)
    (y * w).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert torch.equal(xb.grad, w.to(torch.bfloat16))
    _, vjp = jax.vjp(jT.upcast_for_loss, jnp.asarray(x, jnp.bfloat16))
    jgrad = vjp(jnp.asarray(w.numpy()))[0]
    assert jgrad.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jgrad.astype(jnp.float32)),
                                  xb.grad.float().numpy())
    x32 = x.clone()
    assert tT.upcast_for_loss(x32) is x32


OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _close_updates(t_before, t_after, j_before, j_after, live, lr):
    tb, ta = _torch_flat(t_before), _torch_flat(t_after)
    jb, ja = _jax_flat(j_before), _jax_flat(j_after)
    for k in jb:
        du_t, du_j = ta[k] - tb[k], ja[k] - jb[k]
        m = live[k]
        err = np.abs(du_t - du_j)[m]
        bound = 1e-3 * lr + 1e-3 * np.abs(du_j)[m]
        assert bool((err <= bound).all()), (k, float(err.max()))


def test_train_steps_match_reference(model):
    """Three steps: loss and pre-update gradients, then the updates where
    every gradient so far exceeded 1e-6 in magnitude."""
    jcfg, tcfg, tp, jp = model
    tp = tree_map(torch.clone, tp)
    tstep = TS.make_train_step(tcfg, TA.AdamWConfig(**OPT))
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**OPT)))
    ts, js = TA.init_opt_state(tp), JA.init_opt_state(jp)
    tloss, jloss = TS.make_loss_fn(tcfg), JS.make_loss_fn(jcfg)
    live = None
    for i in range(3):
        tb, jb = _both(_np_batch(jcfg, seed=20 + i))
        tl, tg = TS.value_and_grad(tloss, tp, tb)
        jl, jg = jax.value_and_grad(jloss)(jp, jb)
        _close_loss(tl, jl)
        _close_grads(tg, jg)
        big = {k: np.abs(v) > 1e-6 for k, v in _jax_flat(jg).items()}
        live = big if live is None else {k: live[k] & big[k] for k in big}
        t_before = tree_map(torch.clone, tp)
        tp, ts, tm = tstep(tp, ts, tb)
        j_before = jp
        jp, js, jm = jstep(jp, js, jb)
        _close_loss(tm["loss"], jm["loss"])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_RTOL)
        assert int(ts["step"]) == i + 1
        _close_updates(t_before, tp, j_before, jp, live, float(jm["lr"]))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-7b"])
def test_microbatches_match_one_batch(arch):
    """Two microbatches of 2 rows: the mean of their losses is the whole
    batch's, and the step's updates match the one-batch step's where the
    whole batch's |g| > 1e-6 (qwen2-vl's M-RoPE streams are cut on their
    second axis)."""
    jcfg, tcfg = _configs(arch)
    np_params = np_lm_params(jcfg, seed=2)
    nb = _np_batch(jcfg, b=4, s=12, seed=31)
    p0, _ = _both(np_params)
    tb, jb = _both(nb)
    _, g = TS.value_and_grad(TS.make_loss_fn(tcfg), p0, tb)
    live = {k: np.abs(v) > 1e-6 for k, v in _torch_flat(g).items()}
    out = []
    for mb in (1, 2):
        tp = tree_map(torch.clone, p0)
        step = TS.make_train_step(tcfg, TA.AdamWConfig(**OPT),
                                  microbatches=mb)
        out.append(step(tp, TA.init_opt_state(tp), tb))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    f0, f1, f2 = _torch_flat(p0), _torch_flat(p1), _torch_flat(p2)
    for k in f0:
        du1, du2 = (f1[k] - f0[k])[live[k]], (f2[k] - f0[k])[live[k]]
        assert bool((np.abs(du2 - du1) <= 1e-3 * OPT["lr"]
                     + 1e-3 * np.abs(du1)).all()), k
    # the JAX package's accumulated loss agrees too
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**OPT),
                                       microbatches=2))
    jp = jax.tree.map(jnp.asarray, np_params)
    _, _, jm = jstep(jp, JA.init_opt_state(jp), jb)
    _close_loss(m2["loss"], jm["loss"])


def test_split_batch_cuts_the_batch_axis():
    b = {"tokens": torch.arange(12).reshape(4, 3), "scalar": torch.tensor(1),
         "odd": torch.zeros(3, 2), "mrope_positions": torch.arange(
             24).reshape(3, 4, 2), "none": None}
    parts = TS.split_batch(b, 2)
    assert [p["tokens"].tolist() for p in parts] == [
        [[0, 1, 2], [3, 4, 5]], [[6, 7, 8], [9, 10, 11]]]
    assert parts[1]["mrope_positions"].shape == (3, 2, 2)
    assert torch.equal(parts[1]["mrope_positions"],
                       b["mrope_positions"][:, 2:])
    assert all(p["scalar"] is None and p["odd"] is None for p in parts)
    assert all("none" not in p for p in parts)


def test_grad_shardings_are_refused():
    """``grad_shardings`` needs the ambient rules; under them, on the one
    process's mesh (every collective a no-op), the ZeRO step is the plain
    step bitwise.  The four-rank step is ``tests/test_torch_mesh_train.py``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules as R
    _, tcfg = _configs("smollm-135m")
    with pytest.raises(ValueError, match="use_rules"):
        TS.make_train_step(tcfg, TA.AdamWConfig(), grad_shardings={})(
            *_one_step_inputs(tcfg))
    mesh = make_host_mesh()
    rules = R.make_rules(mesh, fsdp=True)
    params, opt, batch = _one_step_inputs(tcfg)
    axes = tT.model_axes(tcfg)
    gs = R.param_shardings_with_shapes(
        R.make_rules(mesh, fsdp=True, opt_state=True), axes, params)
    p1, o1, m1 = TS.make_train_step(tcfg, TA.AdamWConfig(lr=1e-2))(
        params, opt, batch)
    params, _, batch = _one_step_inputs(tcfg)
    params = R.put(params, R.param_shardings_with_shapes(rules, axes,
                                                         params))
    opt = TA.init_opt_state(params, shardings=gs)
    with R.use_rules(rules):
        p2, o2, m2 = TS.make_train_step(tcfg, TA.AdamWConfig(lr=1e-2),
                                        grad_shardings=gs)(params, opt, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for k, v in flatten_tree(p1).items():
        torch.testing.assert_close(flatten_tree(p2)[k], v, rtol=1e-6,
                                   atol=1e-7)


def _one_step_inputs(tcfg):
    params, _ = tT.init_model(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    nb = _np_batch(tcfg, b=2, s=8, seed=3)
    return params, TA.init_opt_state(params), {
        k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """smollm-135m reduced to 4 layers, compressed by the JAX package at
    budget 0.6 (``tests/test_runtime.py``'s fine-tune consumer), its
    artifact written by the JAX package."""
    jcfg = dataclasses.replace(j_get_config("smollm-135m").reduced(),
                               num_layers=4)
    params = jax.tree.map(jnp.asarray, np_lm_params(jcfg, seed=4))
    host = TransformerHost(jcfg, params, env=CostEnv(batch=2, seq=16))
    res = j_compress(host, budget_ratio=0.6, P=200)
    path = str(tmp_path_factory.mktemp("art") / "lm.npz")
    res.save(path)
    nb = _np_batch(jcfg, s=16, seed=41)
    return path, nb


def test_compressed_artifact_finetunes_in_the_port(compressed):
    path, nb = compressed
    jart = jrt.load(path)
    tart = trt.load(path, device="cpu")
    assert trt.count_units(tart.graph).get("lowrank", 0) >= 1
    tcfg = tart.graph.meta["config"]
    jcfg = jart.graph.meta["config"]
    tfwd = TS.make_compressed_forward(tart.graph, device="cpu")
    jfwd = JS.make_compressed_forward(jart.graph)
    tgp = trt.graph_params(tart.graph)
    jgp = jrt.graph_params(jart.graph)
    tb, jb = _both(nb)
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tcfg, tfwd), tgp, tb)
    jl, jg = jax.value_and_grad(JS.make_loss_fn(jcfg, jfwd))(jgp, jb)
    _close_loss(tl, jl)
    _close_grads(tg, jg)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    tstep = TS.make_train_step(tcfg, TA.AdamWConfig(**opt), forward_fn=tfwd)
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(**opt),
                                       forward_fn=jfwd))
    tgp = tree_map(torch.clone, tgp)
    tstate = TA.init_opt_state(tgp)
    _, _, jm = jstep(jgp, JA.init_opt_state(jgp), jb)
    losses = []
    for _ in range(5):
        tgp, tstate, tm = tstep(tgp, tstate, tb)
        losses.append(float(tm["loss"]))
    _close_loss(losses[0], jm["loss"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # the tuned params bind into a graph that runs
    tuned = trt.bind_params(tart.graph, tgp)
    y = trt.execute(tuned, tb, device="cpu")
    assert y.shape == (2, 16, tcfg.vocab_size)


# ---------------------------------------------------------------------------
# The fault-tolerant loop (tests/test_ft.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(
        t_get_config("smollm-135m"), num_layers=2, d_model=32, num_heads=2,
        num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
        dtype="float32", remat=False)
    params, _ = tT.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    data = SyntheticTokens(cfg.vocab_size, 4, 16, seed=0)
    return cfg, params, GlobalBatcher(data, device="cpu")


def _loop(tmp, total, **kw):
    return TL.LoopConfig(total_steps=total, ckpt_every=10,
                         ckpt_dir=str(tmp), log_every=100, **kw)


def test_loop_trains_and_checkpoints(tiny, tmp_path):
    cfg, params, batcher = tiny
    before = _torch_flat(params)
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=40),
                        _loop(tmp_path, 40), params, batcher,
                        logger=lambda s: None)
    assert res.final_step == 40 and res.restarts == 0
    assert TCK.latest_step(str(tmp_path)) == 40
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    for k, v in _torch_flat(params).items():         # the caller's params
        np.testing.assert_array_equal(v, before[k])
    saved = TCK.restore(str(tmp_path), 40, {"params": res.params,
                                            "opt": res.opt_state})
    for k, v in flatten_tree(saved).items():
        assert torch.equal(v, flatten_tree({"params": res.params,
                                            "opt": res.opt_state})[k])


def test_failure_restart_recovers(tiny, tmp_path):
    """A simulated device loss at step 23 restarts from the step-20
    checkpoint: the replayed steps 20-22 repeat their losses bitwise and
    the run ends where a failure-free run does."""
    cfg, params, batcher = tiny
    fired = {"done": False}

    def bomb(step):
        if step == 23 and not fired["done"]:
            fired["done"] = True
            raise RuntimeError("simulated device loss")

    logs = []
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=30),
                        _loop(tmp_path, 30), params, batcher,
                        failure_hook=bomb, logger=logs.append)
    assert res.restarts == 1 and res.final_step == 30
    assert any("FAILURE at step 23" in s for s in logs)
    assert len(res.losses) == 33
    assert res.losses[20:23] == res.losses[23:26]
    clean = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=30),
                          _loop(str(tmp_path) + "_clean", 30), params,
                          batcher, logger=lambda s: None)
    for k, v in _torch_flat(clean.params).items():
        np.testing.assert_allclose(_torch_flat(res.params)[k], v,
                                   rtol=1e-5, atol=1e-6)


def test_failures_beyond_max_restarts_raise(tiny, tmp_path):
    """With no checkpoint yet a failure restarts from step 0; past
    ``max_restarts`` the failure propagates."""
    cfg, params, batcher = tiny

    def always(step):
        if step == 3:
            raise RuntimeError("lost again")

    logs = []
    with pytest.raises(RuntimeError, match="lost again"):
        TL.train_loop(cfg, TA.AdamWConfig(total_steps=8),
                      _loop(tmp_path, 8, max_restarts=2), params, batcher,
                      failure_hook=always, logger=logs.append)
    assert sum("FAILURE" in s for s in logs) == 3


def test_resume_from_checkpoint(tiny, tmp_path):
    cfg, params, batcher = tiny
    TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=20),
                  _loop(tmp_path, 20), params, batcher, logger=lambda s: None)
    logs = []
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=35),
                        _loop(tmp_path, 35), params, batcher,
                        logger=logs.append)
    assert any("resumed from step 20" in s for s in logs)
    assert res.final_step == 35 and len(res.losses) == 15


def test_straggler_watchdog(tiny, tmp_path, monkeypatch):
    """Persistently slow steps trip the watchdog → restart path.  The
    loop reads its step times from a clock the test owns (the loop's
    ``time`` module replaced by one whose ``perf_counter`` reads it), and
    the failure hook, which runs inside each timed step, advances it:
    1 s a step, 20 s for the three slow ones.  So every step time the
    watchdog reads is fixed, whatever the host's load: on the wall
    clock a load spike of three eager steps (a neighbour test starting a
    four-rank world) once tripped it a second time."""
    import types
    cfg, params, batcher = tiny
    clock = {"t": 0.0}
    monkeypatch.setattr(TL, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["t"]))
    slow = {"n": 0}

    def laggard(step):
        if 25 <= step < 28 and slow["n"] < 3:
            slow["n"] += 1
            clock["t"] += 20.0
        else:
            clock["t"] += 1.0

    logs = []
    res = TL.train_loop(cfg, TA.AdamWConfig(lr=2e-3, total_steps=32),
                        _loop(tmp_path, 32, deadline_factor=6.0,
                              max_stragglers_in_row=3),
                        params, batcher, failure_hook=laggard,
                        logger=logs.append)
    assert any("straggler" in s for s in logs)
    assert res.restarts == 1 and res.final_step == 32


def _cli(*args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "ck")], env=env, capture_output=True,
        text=True, timeout=300)


def test_launcher_trains_and_serves_on_the_cpu(tmp_path):
    out = _cli("--arch", "smollm-135m", "--reduced", "--steps", "5",
               "--device", "cpu", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "restarts=0" in out.stdout
    assert TCK.latest_step(str(tmp_path / "ck")) == 5
    out = _cli("--arch", "recurrentgemma-2b", "--reduced", "--mode", "serve",
               "--tokens", "3", "--device", "cpu", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "decoded 3 tokens/seq" in out.stdout
    # --distributed joins the environment's process group; without one
    # it raises, and never runs as one process (the two-rank run is
    # tests/test_torch_mesh_train.py)
    out = _cli("--arch", "smollm-135m", "--reduced", "--distributed",
               "--device", "cpu", tmp_path=tmp_path)
    assert out.returncode != 0 and "process group" in out.stderr
    assert "final loss" not in out.stdout
