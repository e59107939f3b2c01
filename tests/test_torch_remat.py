"""Remat under ``cfg.remat``: the port's ``forward_local`` against the JAX
package's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``, on
the CPU.

* every transformer id of the registry, reduced, ``remat=True`` on both
  sides, the same numpy params and batch: the loss and its gradient
  match ``jax.value_and_grad`` within ``tests/test_torch_train.py``'s
  tolerances (the loss 1e-5 relative, each gradient leaf 1e-4 · its max
  |g|);
* the port with remat equals the port without remat **bitwise**, the loss
  and every gradient leaf, MoE ids included (the recompute routes the
  same tokens to the same experts and drops the same ones);
* the policy: a rematerialized layer's autograd saves only its input
  outside the checkpoint (a ``saved_tensors_hooks`` count: 1, against
  dozens without remat), and the only tensors its forward leaves alive
  are the outputs of its ``mm`` / ``addmm`` products, one per product;
* the kernel ops inside a checkpointed region: their CUDA branches (run
  here with no-grad stand-ins, as ``tests/test_torch_op_grads.py`` runs
  them) launch each forward kernel again in the recompute, the scan's
  backward kernel once a scan, and give the gradients of no remat
  bitwise;
* a forward without gradients (serving, probes) does not checkpoint.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pt_leaves
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_config as j_get_config
from repro.models import transformer as jT
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.models import transformer as tT
from repro_torch.train import step as TS
from repro_torch.tree import flatten_tree, tree_leaves, tree_map

from _torch_parity import np_lm_params
from test_torch_op_grads import launches  # noqa: F401  (fixture)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LM_IDS = [a for a in ARCH_IDS
          if hasattr(t_get_config(a), "temporal_pattern")]


def _configs(arch, remat=True):
    return (dataclasses.replace(j_get_config(arch).reduced(), remat=remat),
            dataclasses.replace(t_get_config(arch).reduced(), remat=remat))


def _np_batch(cfg, b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, s))
           .astype(np.int32)}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
    else:
        out["embeds"] = (0.3 * rng.standard_normal((b, s, cfg.d_model))) \
            .astype(np.float32)
    if cfg.rope_kind == "mrope":
        t = np.arange(s)
        out["mrope_positions"] = np.broadcast_to(
            np.stack([t, t // 3, t % 3])[:, None, :],
            (3, b, s)).astype(np.int32).copy()
    return out


def _port(np_tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), np_tree)


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _loss_and_grads(cfg, params, batch):
    return TS.value_and_grad(TS.make_loss_fn(cfg), params, batch)


def test_the_published_configs_rematerialize():
    assert all(t_get_config(a).remat for a in LM_IDS)
    assert len(LM_IDS) == 10


@pytest.mark.parametrize("arch", LM_IDS)
def test_remat_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    np_params = np_lm_params(jcfg, seed=1)
    nb = _np_batch(jcfg)
    tl, tg = _loss_and_grads(tcfg, _port(np_params),
                             {k: torch.from_numpy(v) for k, v in nb.items()})
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jT.lm_loss(jcfg, p, b)))(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, nb))
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    ft = {k: v.numpy() for k, v in flatten_tree(tg).items()}
    fj = _jax_flat(jg)
    assert sorted(ft) == sorted(fj)
    for k, b in fj.items():
        assert ft[k].shape == b.shape, k
        scale = float(np.abs(b).max())
        assert float(np.abs(ft[k] - b).max()) <= GRAD_RTOL * scale + 1e-12, k


@pytest.mark.parametrize("arch", LM_IDS)
def test_remat_equals_no_remat_bitwise(arch):
    _, with_remat = _configs(arch, True)
    without = dataclasses.replace(with_remat, remat=False)
    params, _ = tT.init_model(with_remat, torch.Generator().manual_seed(2),
                              device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _np_batch(with_remat, seed=3).items()}
    l0, g0 = _loss_and_grads(without, params, batch)
    l1, g1 = _loss_and_grads(with_remat, params, batch)
    assert torch.equal(l0, l1)
    f0, f1 = flatten_tree(g0), flatten_tree(g1)
    assert sorted(f0) == sorted(f1)
    for k, v in f0.items():
        assert torch.equal(v, f1[k]), k


def test_remat_policy_saves_products_with_no_batch_dims():
    """``x @ W`` reaches the policy as ``mm`` (addmm with a bias), a
    batched product as ``bmm``; only the former is saved."""
    saved = {tT.remat_policy(None, op) for op in (torch.ops.aten.mm.default,
                                                  torch.ops.aten.addmm.default)}
    assert saved == {CheckpointPolicy.MUST_SAVE}
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.mul.Tensor,
               torch.ops.aten.rsqrt.default, torch.ops.aten._softmax.default):
        assert tT.remat_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


class _Outputs(TorchDispatchMode):
    """Every op's outputs, as (op, weakref of the storage)."""

    def __init__(self):
        super().__init__()
        self.made, self.ops = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(func)
        for t in pt_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made.append((func, weakref.ref(t.untyped_storage())))
        return out


def _first_layer(arch, remat):
    cfg = dataclasses.replace(t_get_config(arch).reduced(), remat=remat)
    params, _ = tT.init_model(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    gp = tree_map(lambda t: t.detach().requires_grad_(True),
                  params["groups"][0])
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    pos = tT.default_positions(x)
    fn = functools.partial(tT._layer_fn, cfg, tT.layer_groups(cfg)[0].kind,
                           pos, None)
    return cfg, fn, gp, x, pos


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m", "xlstm-125m"])
def test_a_rematerialized_layer_keeps_its_products_and_inputs(arch):
    kept = {}
    for remat in (False, True):
        cfg, fn, gp, x, pos = _first_layer(arch, remat)
        packed = []
        mode = _Outputs()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: packed.append(t) or t, lambda t: t):
            with mode:
                y = tT._run_layer(cfg, fn, gp, 0, x)
        gc.collect()
        outside = {t.untyped_storage().data_ptr()
                   for t in [x, pos, y, *tree_leaves(gp)]}
        first = {}
        for op, ref in mode.made:
            st = ref()
            if st is not None and st.data_ptr() not in outside:
                first.setdefault(id(st), op)
        products = sum(op in tT.SAVED_PRODUCTS for op in mode.ops)
        kept[remat] = (len(packed), list(first.values()), products)
        del y
    n_packed, alive, products = kept[True]
    # outside the checkpoint autograd saves the layer's input alone
    assert n_packed == 1
    assert products > 0 and len(alive) == products
    assert set(alive) <= tT.SAVED_PRODUCTS
    n_plain, alive_plain, _ = kept[False]
    assert n_plain > 10 * n_packed
    assert not set(alive_plain) <= tT.SAVED_PRODUCTS


def test_no_checkpoint_without_gradients():
    cfg, fn, gp, x, _ = _first_layer("smollm-135m", True)
    mode = _Outputs()
    with torch.no_grad(), mode:
        tT._run_layer(cfg, fn, gp, 0, x)
    plain = _Outputs()
    cfg0 = dataclasses.replace(cfg, remat=False)
    with torch.no_grad(), plain:
        tT._run_layer(cfg0, fn, gp, 0, x)
    assert mode.ops == plain.ops


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-135m"])
def test_kernel_ops_recompute_inside_the_checkpoint(launches, arch):  # noqa: F811
    """The reduced model through the ops' CUDA branches: with remat each
    forward kernel of a layer launches twice (the forward and the
    recompute; the final norm, outside the layers, once), the scan's
    backward once a scan, and every gradient equals the no-remat step's
    bitwise."""
    _, with_remat = _configs(arch, True)
    without = dataclasses.replace(with_remat, remat=False)
    params, _ = tT.init_model(with_remat, torch.Generator().manual_seed(4),
                              device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _np_batch(with_remat, seed=6).items()}
    counts = []
    grads = []
    for cfg in (without, with_remat):
        for k in launches:
            launches[k] = 0
        loss, g = _loss_and_grads(cfg, params, batch)
        counts.append(dict(launches))
        grads.append((loss, flatten_tree(g)))
    plain, remat = counts
    scans = sum(k == "rglru" for k in with_remat.layer_kinds())
    assert plain["rglru_scan"] == plain["rglru_scan_bwd"] == scans
    assert remat["rglru_scan"] == 2 * scans
    assert remat["rglru_scan_bwd"] == scans
    assert plain["rmsnorm"] > 1
    assert remat["rmsnorm"] == 2 * (plain["rmsnorm"] - 1) + 1
    assert remat["flash_attention"] == 2 * plain["flash_attention"]
    if arch == "smollm-135m":
        assert plain["flash_attention"] == with_remat.num_layers
    assert torch.equal(grads[0][0], grads[1][0])
    for k, v in grads[0][1].items():
        assert torch.equal(v, grads[1][1][k]), k
