"""The port's MoE block against the JAX package's, on the CPU.

The same numpy inputs go through ``repro.models.moe`` and
``repro_torch.models.moe``:

* ``route`` (gates and experts), ``capacity_positions`` against the JAX
  package's and against the one-hot-cumsum oracle of both packages, on
  seeded expert choices that overflow capacity;
* ``moe_ffn`` (one token group, the JAX package's single-device case) on
  reduced granite-moe-1b-a400m and qwen3-moe-30b-a3b at
  ``capacity_factor`` 1.25 (pairs dropped) and 8.0 (none dropped);
* ``aux_load_balance_loss``, and the forced-routing hook: the port fed
  the JAX package's routing gives its output even when its own router
  would choose otherwise.

Routing is discontinuous, so each comparison first asserts its premise:
the smallest gap between the k-th and the (k+1)-th gate on the inputs
exceeds 1e-5, far above fp32 reassociation.  A flip then shows as a
failed premise, never as a loosened tolerance.  Tolerance on outputs:
max |Δ| ≤ 1e-5 · max |y|.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jM
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import moe as tM

from _torch_parity import np_lm_params

RTOL = 1e-5
MARGIN = 1e-5
ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch).reduced(), **kw),
            dataclasses.replace(t_get_config(arch).reduced(), **kw))


def _moe_params(jc, seed=0):
    """Layer 0's MoE params (numpy), from the model's parameter filler."""
    params = np_lm_params(jc, seed=seed)
    return {k: np.asarray(v[0]) for k, v in params["groups"][0]["ffn"].items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _skewed(shape, seed):
    """Token rows sharing one common direction, so that the router
    favours some experts and capacity 1.25 overflows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1.5 * rng.standard_normal(shape[-1])
    return x.astype(np.float32)


def min_margin(p, xt, k):
    """Smallest gap between the k-th and (k+1)-th softmax gate of any
    token (numpy, float64)."""
    logits = xt.astype(np.float64) @ p["router"].astype(np.float64)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = np.sort(g / g.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((g[:, k - 1] - g[:, k]).min())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(arch):
    jc, tc = _cfgs(arch)
    p = _moe_params(jc, seed=3)
    xt = _x((40, jc.d_model), 4)
    assert min_margin(p, xt, jc.experts_per_token) > MARGIN
    tg, te = tM.route({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(xt), tc)
    jg, je = jM.route({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(xt), jc)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n,k,e,cap", [(24, 2, 4, 5), (24, 2, 4, 12),
                                       (13, 3, 8, 2), (64, 8, 32, 3)])
def test_capacity_positions_match(n, k, e, cap):
    """Seeded expert choices (k distinct experts a token, skewed towards
    low ids so that some experts overflow ``cap``)."""
    rng = np.random.default_rng(n + k)
    w = np.linspace(2.0, 0.5, e)
    top_e = np.stack([rng.choice(e, size=k, replace=False, p=w / w.sum())
                      for _ in range(n)]).astype(np.int64)
    tpos, tkeep = tM.capacity_positions(torch.from_numpy(top_e), e, cap)
    jpos, jkeep = jM.capacity_positions(jnp.asarray(top_e, jnp.int32), e,
                                        cap)
    cpos, ckeep = tM.capacity_positions_cumsum(torch.from_numpy(top_e), e,
                                               cap)
    jcpos, _ = jM.capacity_positions_cumsum(jnp.asarray(top_e, jnp.int32),
                                            e, cap)
    for pos in (jpos, cpos, jcpos):
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tkeep.numpy(), ckeep.numpy())
    counts = np.bincount(top_e.reshape(-1), minlength=e)
    assert (not tkeep.all()) == bool((counts > cap).any())


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches(arch, cf):
    jc, tc = _cfgs(arch, capacity_factor=cf)
    p = _moe_params(jc, seed=5)
    x = _skewed((2, 12, jc.d_model), 6)
    xt = x.reshape(-1, jc.d_model)
    assert min_margin(p, xt, jc.experts_per_token) > MARGIN
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y = tM.moe_ffn(tp, torch.from_numpy(x), tc, capacity_factor=cf)
    _close(y, jM.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), jc, capacity_factor=cf))
    # the premise of each factor: pairs dropped at 1.25, none at 8.0
    n, k, e = xt.shape[0], jc.experts_per_token, jc.num_experts
    cap = int(np.ceil(n * k / e * cf))
    _, keep = tM.capacity_positions(tM.route(tp, torch.from_numpy(xt),
                                             tc)[1], e, cap)
    assert bool(keep.all()) == (cf == 8.0)
    # dispatch through the model's entry point is the same function
    torch.testing.assert_close(
        tM.moe_dispatch(tp, torch.from_numpy(x), tc, capacity_factor=cf), y,
        rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches(arch):
    jc, tc = _cfgs(arch)
    p = _moe_params(jc, seed=9)
    x = _x((3, 7, jc.d_model), 10)
    a = tM.aux_load_balance_loss({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), tc)
    b = jM.aux_load_balance_loss({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jc)
    assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_forced_routing_replays_another_routing(monkeypatch):
    """The port, fed the JAX package's routing of ``x``, gives the JAX
    package's output on a perturbed ``x'`` whose own routing differs:
    the hook a CPU run uses to replay a card run's routing."""
    jc, tc = _cfgs(ARCHS[0], capacity_factor=1.25)
    p = _moe_params(jc, seed=11)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = _skewed((2, 12, jc.d_model), 12)
    xt = x.reshape(-1, jc.d_model)
    jg, je = jM.route(jp, jnp.asarray(xt), jc)
    forced = (torch.tensor(np.asarray(jg)), torch.tensor(np.asarray(je)))
    g, e = tM.route(tp, torch.from_numpy(xt), tc, forced=forced)
    assert g.dtype == torch.float32 and e.dtype == torch.long
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    # x' routes elsewhere on its own
    x2 = x + 0.5 * _x(x.shape, 13)
    own = tM.route(tp, torch.from_numpy(x2.reshape(-1, jc.d_model)), tc)[1]
    assert not torch.equal(own, e)
    orig = tM.route
    monkeypatch.setattr(tM, "route",
                        lambda p_, xt_, cfg_: orig(p_, xt_, cfg_,
                                                   forced=forced))
    y = tM.moe_ffn(tp, torch.from_numpy(x2), tc, capacity_factor=1.25)
    # the JAX package on x' under the same routing
    monkeypatch.setattr(jM, "route", lambda p_, xt_, cfg_: (jg, je))
    _close(y, jM.moe_ffn(jp, jnp.asarray(x2), jc, capacity_factor=1.25))
