"""The port at bf16 against the JAX package at bf16, on the CPU.

Every published config is bf16; the port's norm and attention follow the
TPU kernels at that dtype (fp32 inside, one rounding to bf16 at the
end), where the JAX package's plain layers round in more places (its
``rms_norm`` rounds the rsqrt to bf16 first; its ``_sdpa`` rounds the
logits' product and the softmax weights to bf16).  Inputs are made with
numpy from a seed and handed to both packages.

* ``rmsnorm`` and ``flash_attention`` (grouped kv heads too): the port's
  plain version at bf16 against ``repro.kernels.ops`` in Pallas interpret
  mode, within one bf16 ulp of each output (both compute in fp32 and round
  once; the sums run in another order);
* a JAX bf16 params tree crosses to the port and back bit for bit
  (``params_from_numpy`` / ``params_to_numpy``, through a 16-bit view);
* ``forward`` and three ``decode_step`` calls of smollm-135m, gemma-7b,
  qwen2-7b and recurrentgemma-2b, reduced and switched to bf16 on both
  sides, with the same bf16 weights: max |Δ| ≤ 4e-2 · max |y| (measured
  here 0.051-0.136 at a max |y| of 3.0-4.5, up to 3.3 %: bf16 rounding in
  the products, on both sides), and the port no farther from the JAX
  package's fp32 run on the same (widened) weights than the JAX bf16 run
  is (measured: 0.46-0.90 of its distance);
* ``rms_norm`` at bf16 against the JAX layer: the deliberate divergence
  (the JAX layer's bf16 rsqrt) is at most 2 bf16 ulps of each output, and
  the port's norm is within one ulp of the JAX layer computed in fp32 and
  rounded once;
* one SmolLM train step at bf16 against the JAX step: the loss within
  1e-2 relative, each gradient leaf within 5e-2 · its max |g|, params
  bf16 and the AdamW moments fp32 on both sides;
* ``init_model`` (no JAX): layers drawn one by one into stacks allocated
  once give a CPU generator's values of drawing and stacking them all;
* the launcher trains the full SmolLM-135M config at bf16 on the CPU.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.configs import get_config as j_get_config
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch import kernels as tk
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.optim import adamw as TA
from repro_torch.train import step as TS
from repro_torch.tree import flatten_tree

from _torch_parity import np_lm_params

BF16 = ml_dtypes.bfloat16
#: Whole reduced models at bf16: max |Δ| over max |y|.
NET_RTOL = 4e-2
ARCHS = ("smollm-135m", "gemma-7b", "qwen2-7b", "recurrentgemma-2b")


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).astype(BF16)


def _t(a: np.ndarray) -> torch.Tensor:
    """A bf16 numpy array as a bf16 tensor, bit for bit."""
    return tT.params_from_numpy(_bf16(a))


def _j(a: np.ndarray):
    return jnp.asarray(_bf16(a))


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.detach().float().numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _ulp(y: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |y| (2^-7 of its binade; the smallest normal's
    ulp at 0)."""
    a = np.maximum(np.abs(y), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _within_ulps(y, yr, n: int = 1) -> None:
    y, yr = _f32(y), _f32(yr)
    assert y.shape == yr.shape
    err = np.abs(y - yr)
    bound = n * _ulp(np.maximum(np.abs(y), np.abs(yr)))
    assert bool((err <= bound).all()), float((err / bound).max())


# -- the kernels' plain versions against the Pallas kernels ------------------

@pytest.mark.parametrize("shape,g32", [((3, 5, 37), False), ((130, 64), True),
                                       ((1, 2561), False), ((8, 576), True),
                                       ((4, 2560), False)])
def test_rmsnorm_bf16_within_an_ulp_of_pallas(shape, g32):
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    g = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    gt = torch.from_numpy(g) if g32 else _t(g)
    y = tk.rmsnorm_op(_t(x), gt, eps=1e-6)
    assert y.dtype == torch.bfloat16
    yj = jk.rmsnorm_op(_j(x), jnp.asarray(g) if g32 else _j(g), eps=1e-6,
                       interpret=True)
    assert yj.dtype == jnp.bfloat16
    _within_ulps(y, yj)


ATTN = [((2, 7, 3, 16), 3), ((1, 37, 2, 8), 2), ((1, 16, 4, 64), 1),
        ((2, 9, 6, 32), 2)]


@pytest.mark.parametrize("shape,kvh", ATTN)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_within_an_ulp_of_pallas(shape, kvh, causal):
    """kvh < H: the port's op on grouped k and v against the Pallas
    kernel on k and v expanded to H heads (query head h reads kv head
    h // (H / KVH))."""
    rng = np.random.default_rng(sum(shape) + kvh + causal)
    b, s, h, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    y = tk.flash_attention_op(_t(q), _t(k), _t(v), causal)
    assert y.dtype == torch.bfloat16
    ke, ve = (np.repeat(a, h // kvh, axis=2) for a in (k, v))
    yj = jk.flash_attention_op(_j(q), _j(ke), _j(ve), causal, True)
    assert yj.dtype == jnp.bfloat16
    _within_ulps(y, yj)


def test_plain_versions_round_once():
    """The bf16 plain versions are the fp32 ones on the widened operands,
    rounded once to bf16: bitwise."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((5, 48)))
    g = _t(0.2 * rng.standard_normal(48))
    assert torch.equal(tk.rmsnorm_ref(x, g),
                       tk.rmsnorm_ref(x.float(), g.float()).bfloat16())
    q, k, v = (_t(rng.standard_normal((2, 6, 2, 16))) for _ in range(3))
    assert torch.equal(tk.flash_attention_ref(q, k, v),
                       tk.flash_attention_ref(q.float(), k.float(),
                                              v.float()).bfloat16())


# -- weights carried across ---------------------------------------------------

def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bf16_params_cross_both_ways_bitwise():
    cfg = dataclasses.replace(j_get_config("gemma-7b").reduced(),
                              dtype="bfloat16")
    jp, _ = jT.init_model(cfg, jax.random.PRNGKey(0))
    tp = tT.params_from_numpy(jax.tree.map(np.asarray, jp))
    ft, fj = flatten_tree(tp), _jax_flat(jp)
    assert sorted(ft) == sorted(fj)
    for key, a in fj.items():
        assert a.dtype == BF16 and ft[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(
            ft[key].view(torch.int16).numpy(), a.view(np.int16))
    back = flatten_tree(tT.params_to_numpy(tp))
    for key, a in fj.items():
        assert back[key].dtype == BF16, key
        np.testing.assert_array_equal(back[key].view(np.uint16),
                                      a.view(np.uint16))
    # other dtypes behave as before
    f = tT.params_from_numpy({"w": np.ones((2, 3), np.float32)})["w"]
    assert f.dtype == torch.float32
    assert tT.params_to_numpy({"w": f})["w"].dtype == np.float32


# -- the published configs, reduced, at bf16 ----------------------------------

def _configs(arch):
    return (dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="bfloat16"),
            dataclasses.replace(t_get_config(arch).reduced(),
                                dtype="bfloat16"))


def _bf16_params(jcfg, seed=0):
    np_params = jax.tree.map(_bf16, np_lm_params(jcfg, seed=seed))
    return (tT.params_from_numpy(np_params),
            jax.tree.map(jnp.asarray, np_params))


def _net_close(y, yj, y32) -> None:
    """``y`` (the port) within NET_RTOL of ``yj`` (the JAX package), both
    at bf16, and no farther from ``y32`` (the JAX package at fp32) than
    ``yj`` is."""
    y, yj, y32 = _f32(y), _f32(yj), _f32(y32)
    assert y.shape == yj.shape and np.isfinite(y).all()
    d = float(np.abs(y - yj).max())
    assert d <= NET_RTOL * float(np.abs(yj).max()), (d, np.abs(yj).max())
    assert float(np.abs(y - y32).max()) <= float(np.abs(yj - y32).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference_at_bf16(arch):
    jcfg, tcfg = _configs(arch)
    tp, jp = _bf16_params(jcfg)
    for t in flatten_tree(tp).values():
        assert t.dtype == torch.bfloat16
    j32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    y = tT.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    yj = jT.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    _net_close(y, yj, jT.forward(j32, jp32, {"tokens": jnp.asarray(toks)}))
    tc = tT.init_cache(tcfg, 2, 8, device="cpu")
    jc, jc32 = jT.init_cache(jcfg, 2, 8), jT.init_cache(j32, 2, 8)
    for t in range(3):
        step = toks[:, t:t + 1]
        lt, tc = tT.decode_step(tcfg, tp, tc, {"tokens":
                                               torch.from_numpy(step)})
        lj, jc = jT.decode_step(jcfg, jp, jc, {"tokens": jnp.asarray(step)})
        l32, jc32 = jT.decode_step(j32, jp32, jc32,
                                   {"tokens": jnp.asarray(step)})
        assert lt.dtype == torch.bfloat16
        _net_close(lt, lj, l32)


@pytest.mark.parametrize("d", [64, 576, 2560])
def test_rms_norm_divergence_from_the_jax_layer_is_bounded(d):
    """The port's ``rms_norm`` at bf16 is the JAX layer's formula computed
    in fp32 and rounded once (within one ulp: the sums run in another
    order); the JAX layer rounds the rsqrt to bf16 first, which moves y
    by at most 2 bf16 ulps (the rsqrt's half ulp, then the two bf16
    products' roundings)."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((16, d)) * 3).astype(np.float32)
    g = (0.2 * rng.standard_normal(d)).astype(np.float32)
    y = tL.rms_norm(_t(x), _t(g))
    yj = jL.rms_norm(_j(x), _j(g))
    _within_ulps(y, yj, n=2)
    exact = jL.rms_norm(jnp.asarray(_f32(_t(x))), jnp.asarray(_f32(_t(g))))
    _within_ulps(y, jnp.asarray(exact).astype(jnp.bfloat16))


# -- one train step at bf16 -------------------------------------------------

LOSS_RTOL = 1e-2
GRAD_SHARE = 5e-2


def test_train_step_matches_reference_at_bf16():
    jcfg, tcfg = _configs("smollm-135m")
    tp, jp = _bf16_params(jcfg, seed=1)
    rng = np.random.default_rng(5)
    nb = {k: rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
          for k in ("tokens", "targets")}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tl, tg = TS.value_and_grad(TS.make_loss_fn(tcfg), tp, tb)
    jl, jg = jax.value_and_grad(JS.make_loss_fn(jcfg))(jp, jb)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    ft, fj = flatten_tree(tg), _jax_flat(jg)
    for key, b in fj.items():
        assert ft[key].dtype == torch.bfloat16 and b.dtype == BF16, key
        a, b = _f32(ft[key]), b.astype(np.float32)
        assert float(np.abs(a - b).max()) <= \
            GRAD_SHARE * float(np.abs(b).max()) + 1e-12, key
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    tstate = TA.init_opt_state(tp)
    jstate = JA.init_opt_state(jp)
    tp, tstate, tm = TS.make_train_step(tcfg, TA.AdamWConfig(**opt))(
        tp, tstate, tb)
    jp, jstate, jm = JS.make_train_step(jcfg, JA.AdamWConfig(**opt))(
        jp, jstate, jb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=LOSS_RTOL)
    for t in flatten_tree(tp).values():
        assert t.dtype == torch.bfloat16
    for tree in (tstate["mu"], tstate["nu"]):
        for t in flatten_tree(tree).values():
            assert t.dtype == torch.float32
    for leaf in jax.tree.leaves(jstate["mu"]):
        assert leaf.dtype == jnp.float32


# -- weights drawn layer by layer into preallocated stacks ----------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-1b-a400m",
                                  "xlstm-125m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_model_draws_as_a_stack_of_layers(arch, dtype):
    """``init_model`` copies each layer into stacks allocated once; a CPU
    generator draws the values, in the order, of drawing every layer and
    stacking them, then the embeddings."""
    cfg = dataclasses.replace(t_get_config(arch).reduced(), dtype=dtype)
    params, _ = tT.init_model(cfg, torch.Generator().manual_seed(3),
                              device="cpu")
    gen = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    groups = [stack([tT._init_layer(cfg, g.kind, gen, dt)[0]
                     for _ in range(g.count)]) for g in tT.layer_groups(cfg)]
    got = flatten_tree(params)
    want = flatten_tree({"groups": groups})
    for key, t in want.items():
        assert got[key].dtype == dt and torch.equal(got[key], t), key
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen)
    assert torch.equal(got["embed"],
                       (table * (1.0 / math.sqrt(cfg.d_model))).to(dt))


def test_launcher_trains_a_full_config_at_bf16(tmp_path):
    """``launch.train`` without ``--reduced``: the published SmolLM-135M
    config trains at its own dtype (params bf16, moments fp32) and the
    loop reports each step's seconds."""
    from repro_torch.launch import train as launch
    from repro_torch.tree import tree_leaves
    threads = torch.get_num_threads()
    torch.set_num_threads(2)      # a full-size model beside other workers
    try:
        res = launch.main(["--arch", "smollm-135m", "--steps", "2",
                           "--warmup", "1", "--batch", "1", "--seq", "8",
                           "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "ck")])
    finally:
        torch.set_num_threads(threads)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert len(res.step_s) == 2 and all(s > 0 for s in res.step_s)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(res.params))
    assert all(t.dtype == torch.float32 for t in tree_leaves(
        [res.opt_state["mu"], res.opt_state["nu"]]))
