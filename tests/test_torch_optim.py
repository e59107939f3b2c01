"""The port's optimizer (``repro_torch.optim``) against the JAX package's,
on the CPU, on the same numpy inputs.

* ``cosine_lr`` at every phase of the schedule, ``clip_by_global_norm``
  and ``global_norm``, and five ``adamw_update`` steps (params, moments,
  step, grad norm, lr) agree to fp32 rounding: rtol 1e-6 on scalars,
  |Δ| ≤ 1e-6 · max|x| on the trees (sums and transcendental functions
  round in other orders; an Adam step divides two such values);
* ``ErrorFeedback`` gives bitwise the JAX package's compressed gradients
  and carried errors over 20 steps (one rounding rule, exact
  arithmetic around it);
* the port's own contracts, mirroring ``tests/test_substrates.py``: a
  quadratic is minimized, the clip bounds the update, the errors
  telescope, the update is written in place, a bf16 param stays bf16
  beside fp32 moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.tree import flatten_tree, tree_map

TREE_RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"w": a(6, 5), "nest": {"b": a(5), "c": a(3, 2, 2)},
            "lst": [a(4), a(2, 3)]}


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_trees(t_tree, j_tree, rtol=TREE_RTOL):
    ft = flatten_tree(t_tree)
    fj = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                   for p in path): np.asarray(leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    assert sorted(ft) == sorted(fj)
    for k, b in fj.items():
        a = ft[k].detach().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        scale = float(np.abs(b).max()) + 1e-30
        assert float(np.abs(a - b).max()) <= rtol * scale, \
            (k, float(np.abs(a - b).max()) / scale)


SCHEDULES = [JA.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100),
             JA.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=40,
                            min_lr_ratio=0.0)]


@pytest.mark.parametrize("which", range(len(SCHEDULES)))
@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 55, 99, 100, 150])
def test_cosine_lr_matches_reference(which, step):
    jcfg = SCHEDULES[which]
    tcfg = TA.AdamWConfig(**jcfg.__dict__)
    want = float(JA.cosine_lr(jcfg, step))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = TA.cosine_lr(tcfg, s)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_cosine_schedule_shape():
    cfg = TA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    assert float(TA.cosine_lr(cfg, 0)) == pytest.approx(0.0)
    assert float(TA.cosine_lr(cfg, 10)) == pytest.approx(1.0)
    assert float(TA.cosine_lr(cfg, 100)) == pytest.approx(0.1, abs=1e-6)
    assert float(TA.cosine_lr(cfg, 55)) < 1.0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _np_tree(3, scale=2.0)
    tg, tn = TA.clip_by_global_norm(_to_torch(g), max_norm)
    jg, jn = JA.clip_by_global_norm(_to_jax(g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(TA.global_norm(_to_torch(g))) == pytest.approx(
        float(JA.global_norm(_to_jax(g))), rel=1e-6)
    _close_trees(tg, jg)


def test_grad_clip_bounds_update():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = TA.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(TA.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("clip", [0.3, 100.0])
def test_adamw_update_matches_reference(clip):
    """Five steps from the same params on the same gradients: params,
    moments, step, grad norm and lr agree to fp32 rounding."""
    jcfg = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                          weight_decay=0.1, grad_clip=clip)
    tcfg = TA.AdamWConfig(**jcfg.__dict__)
    p0 = _np_tree(0)
    tp, jp = _to_torch(p0), _to_jax(p0)
    ts, js = TA.init_opt_state(tp), JA.init_opt_state(jp)
    for i in range(5):
        g = _np_tree(10 + i)
        tp, ts, tm = TA.adamw_update(tcfg, _to_torch(g), ts, tp)
        jp, js, jm = JA.adamw_update(jcfg, _to_jax(g), js, jp)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        _close_trees(tp, jp)
        _close_trees(ts["mu"], js["mu"])
        _close_trees(ts["nu"], js["nu"])


def test_adamw_reduces_quadratic():
    cfg = TA.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                         weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = TA.init_opt_state(params)
    for _ in range(60):
        params, state, _ = TA.adamw_update(cfg, {"w": 2 * params["w"]},
                                           state, params)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_update_is_in_place_and_keeps_dtypes():
    """The params and moments passed in are the ones written; a bf16
    param stays bf16 (updated in fp32 and cast back), its moments fp32."""
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    params = {"a": torch.ones(4), "b": torch.ones(3, dtype=torch.bfloat16)}
    state = TA.init_opt_state(params)
    assert state["mu"]["b"].dtype == torch.float32
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    ptrs = [t.data_ptr() for t in (params["a"], params["b"],
                                   state["mu"]["a"], state["nu"]["b"])]
    grads = {"a": torch.ones(4), "b": torch.ones(3, dtype=torch.bfloat16)}
    new_p, new_s, _ = TA.adamw_update(cfg, grads, state, params)
    assert [t.data_ptr() for t in (new_p["a"], new_p["b"], new_s["mu"]["a"],
                                   new_s["nu"]["b"])] == ptrs
    assert new_p["b"].dtype == torch.bfloat16
    assert bool((new_p["a"] < 1).all()) and bool((new_p["b"] < 1).all())
    assert TA.opt_state_axes({"a": ("embed",)}) == {
        "mu": {"a": ("embed",)}, "nu": {"a": ("embed",)}, "step": ()}


def test_error_feedback_is_bitwise_the_references():
    """The compressed gradients and the carried errors of 20 steps equal
    the JAX package's bit for bit."""
    rng = np.random.default_rng(0)
    zeros = {"w": np.zeros(32, np.float32),
             "m": [np.zeros((4, 8), np.float32), np.zeros(3, np.float32)]}
    te = TC.ErrorFeedback.init(_to_torch(zeros))
    je = JC.ErrorFeedback.init(_to_jax(zeros))
    for _ in range(20):
        g = {"w": rng.standard_normal(32).astype(np.float32) * 3,
             "m": [rng.standard_normal((4, 8)).astype(np.float32),
                   rng.standard_normal(3).astype(np.float32) * 1e-3]}
        tq, te = TC.ErrorFeedback.apply(_to_torch(g), te)
        jq, je = JC.ErrorFeedback.apply(_to_jax(g), je)
        for t_tree, j_tree in ((tq, jq), (te, je)):
            ft = flatten_tree(t_tree)
            fj = flatten_tree(jax.tree.map(np.asarray, j_tree))
            for k in fj:
                np.testing.assert_array_equal(ft[k].numpy(), fj[k])


def test_error_feedback_telescopes():
    """Σ compressed ≈ Σ true gradients (errors telescope, not accumulate)."""
    gen = torch.Generator().manual_seed(0)
    grads = [{"w": torch.randn(32, generator=gen)} for _ in range(50)]
    e = TC.ErrorFeedback.init(grads[0])
    total_c, total_t = torch.zeros(32), torch.zeros(32)
    for g in grads:
        gq, e = TC.ErrorFeedback.apply(g, e)
        total_c += gq["w"]
        total_t += g["w"]
    resid = float((total_c - total_t).abs().max())
    assert resid <= float(e["w"].abs().max()) + 1e-5


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 37.5),
                                        (3, 1e3)])
def test_int8_roundtrip_bound(seed, scale):
    x = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * scale
    q, s = TC.quantize_int8(x)
    err = (TC.dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6   # half-ulp bound
