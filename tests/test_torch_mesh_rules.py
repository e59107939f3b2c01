"""The mesh's pure parts, in one process: sharding rules, axes trees,
placements, v1 artifacts, the one-rank mesh and ``merged_ffn``'s residual
switch — held against ``repro`` where it computes.

``repro``'s ``ShardingRules.spec`` and ``make_rules`` read only
``mesh.shape``, so a stand-in object with that dict stands for a mesh of
any size: no JAX devices are needed.
"""
import dataclasses
import itertools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.runtime import executor as jex
from repro.runtime import ir as jir
from repro.sharding import collectives as jcoll
from repro.sharding import rules as jrules
from repro_torch import runtime as trt
from repro_torch.configs import get_config
from repro_torch.core.compress import compress
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_host_mesh, mesh_info
from repro_torch.models import cnn, layers as L, transformer as T, zoo
from repro_torch.models.cnn_host import CNNHost
from repro_torch.models.transformer_host import CostEnv, TransformerHost
from repro_torch.runtime import executor as tex
from repro_torch.sharding import collectives as tcoll
from repro_torch.sharding import rules as trules

MESHES = {
    "1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
    "8x1": {"data": 8, "model": 1}, "1x8": {"data": 1, "model": 8},
    "4x2": {"data": 4, "model": 2},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
}

PRESETS = {
    **{f"rules-fsdp{a:d}-sp{b:d}-kv{c:d}-opt{d:d}":
       (jrules.make_rules, trules.make_rules,
        dict(fsdp=a, seq_parallel=b, decode_kv_model=c, opt_state=d))
       for a, b, c, d in itertools.product((True, False), repeat=4)},
    **{f"unit-kv{c:d}": (jrules.make_unit_rules, trules.make_unit_rules,
                         dict(decode_kv_model=c)) for c in (True, False)},
}

#: Axes tuples of the models' params and states, beside every single name.
AXES = [
    ("embed", "heads", "head"), ("embed", "kv", "head"),
    ("heads", "head", "embed"), ("embed", "ffn"), ("ffn", "embed"),
    ("vocab", "embed"), ("embed", "vocab"), ("embed", "rank"),
    ("rank", "embed"), ("batch", "kv_seq", "kv", "head"),
    ("batch", "ffn"), ("batch", None, "ffn"), ("ffn", "ffn_in"),
    (None, "ffn"), (None, None, "conv_in", "conv_out"),
    (None, None, None, "conv_out"), ("conv_in", "vocab"),
    ("batch", None, None, "act_channels"), ("batch", "seq", "act_embed"),
    ("experts", "expert_embed", "expert_ffn"), ("moe_group", "experts"),
    ("batch", "heads", None, None), ("layers", "embed", "heads", "head"),
]

SHAPES = [(8, 9, 64), (12, 3, 16), (512, 2048), (6, 5), (64, 16, 3, 7),
          (1, 32, 128), (256, 16), (4, 4, 4, 4)]


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", list(PRESETS))
def test_spec_matches_reference(mesh, preset):
    jmake, tmake, kw = PRESETS[preset]
    m = _mesh(MESHES[mesh])
    jr, tr = jmake(m, **kw), tmake(m, **kw)
    assert dict(jr.rules) == dict(tr.rules)
    names = [(n,) for n in jr.rules] + AXES
    checked = 0
    for ax in names:
        assert tr.spec(ax) == tuple(jr.spec(ax)), ax
        for shape in SHAPES:
            shape = tuple(shape[:len(ax)]) + (7,) * (len(ax) - len(shape))
            assert tr.spec(ax, shape) == tuple(jr.spec(ax, shape)), \
                (ax, shape)
            checked += 1
    assert checked > 100
    assert trules.ShardingRules(None, tr.rules).spec(("batch",)) == ()
    tree = {"a": [("embed", "ffn"), None], "b": ("batch", "kv_seq")}
    placed = trules.param_shardings(tr, tree)
    assert placed["a"][0].spec == tuple(jr.spec(("embed", "ffn")))
    assert placed["a"][1].spec == ()
    assert placed["b"].spec == tuple(jr.spec(("batch", "kv_seq")))


# ---------------------------------------------------------------------------
# Axes trees over real artifacts
# ---------------------------------------------------------------------------

def _lm_path(cfg, path, budget):
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    host = TransformerHost(cfg, params, env=CostEnv(batch=4, seq=16),
                           device="cpu")
    compress(host, budget_ratio=budget, P=200).save(path)
    return path


@pytest.fixture(scope="module")
def lm_artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("axes")
    return {
        "smollm": _lm_path(dataclasses.replace(
            get_config("smollm-135m").reduced(), num_layers=4),
            str(d / "lm.npz"), 0.6),
        "recurrentgemma": _lm_path(get_config("recurrentgemma-2b").reduced(),
                                   str(d / "rg.npz"), 0.9),
    }


def _same_tree(a, b):
    """Trees of dicts/lists with names tuples (or None) as leaves."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a, b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert (None if a is None else tuple(a)) == \
            (None if b is None else tuple(b)), (a, b)


@pytest.mark.parametrize("name", ["smollm", "recurrentgemma"])
def test_axes_trees_match_reference(lm_artifacts, name):
    path = lm_artifacts[name]
    jart, tart = jrt.load(path), trt.load(path, device="cpu")
    _same_tree(jir.graph_axes(jart.graph), trt.graph_axes(tart.graph))
    for ju, tu in zip(jart.graph.units, tart.graph.units):
        _same_tree(jir.unit_axes(ju), trt.unit_axes(tu))
    _same_tree(jex.cache_axes(jart.graph), tex.cache_axes(tart.graph))


@pytest.mark.parametrize("name", ["smollm", "recurrentgemma"])
@pytest.mark.parametrize("mesh", ["1x1", "2x2", "4x2", "1x8"])
def test_param_shardings_match_reference(lm_artifacts, name, mesh):
    """Every leaf's placement is the spec ``repro`` resolves for it (with
    the divisibility fallback); on a one-device JAX mesh the reference's
    own NamedShardings."""
    path = lm_artifacts[name]
    jart, tart = jrt.load(path), trt.load(path, device="cpu")
    m = _mesh(MESHES[mesh])
    jr, tr = jrules.make_unit_rules(m), trules.make_unit_rules(m)
    tp = list(_leaves(trules.param_shardings_with_shapes(
        tr, trt.graph_axes(tart.graph), trt.graph_params(tart.graph))))
    jaxes = jir.graph_axes(jart.graph)
    jparams = jrt.graph_params(jart.graph)
    is_names = lambda x: isinstance(x, tuple) or x is None  # noqa: E731
    jspecs = jax.tree.map(
        lambda ax, a: [() if ax is None else tuple(jr.spec(ax, a.shape))],
        jaxes, jparams, is_leaf=is_names)
    flat_j = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, list)
                             and len(x) == 1 and isinstance(x[0], tuple))
    assert len(flat_j) == len(tp) == len(jax.tree.leaves(jparams)) > 0
    assert [j[0] for j in flat_j] == [p.spec for p in tp]
    assert any("model" in p.spec for p in tp)
    if mesh == "1x1":
        real = jax.make_mesh((1, 1), ("data", "model"))
        named = jrules.param_shardings_with_shapes(
            jrules.make_unit_rules(real), jaxes, jparams)
        assert [tuple(n.spec) for n in jax.tree.leaves(named)] == \
            [p.spec for p in tp]


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_tree_forms_and_the_single_device_executor(lm_artifacts):
    """``jit_apply``, ``make_serve_step`` and ``GraphExecutor`` without
    rules are the single-device path, bit for bit."""
    art = trt.load(lm_artifacts["smollm"], device="cpu")
    toks = torch.randint(0, 64, (2, 5),
                         generator=torch.Generator().manual_seed(2))
    want = art.apply({"tokens": toks})
    fn, params = trt.jit_apply(art.graph, device="cpu")
    torch.testing.assert_close(fn(params, {"tokens": toks}), want,
                               rtol=0, atol=0)
    ex = art.executor()
    assert ex.rules is None
    torch.testing.assert_close(ex.apply({"tokens": toks}), want,
                               rtol=0, atol=0)
    step, p = art.make_serve_step()
    c1, c2, c3 = (art.init_cache(2, 5), art.init_cache(2, 5),
                  ex.init_cache(2, 5))
    for t in range(5):
        l1, c1 = step(p, c1, {"tokens": toks[:, t:t + 1]})
        l2, c2 = art.decode(c2, toks[:, t:t + 1])
        l3, c3 = ex.decode(c3, toks[:, t:t + 1])
        torch.testing.assert_close(l1, l2, rtol=0, atol=0)
        torch.testing.assert_close(l3, l2, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# v1 artifacts, one-rank meshes, placements
# ---------------------------------------------------------------------------

def _rewrite_as_v1(path):
    """Strip the v2 sharding contract: format 1, no axes records."""
    from repro_torch.runtime import artifact as A

    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    spec = json.loads(data.pop("__spec__").item())
    data.pop("__fingerprint__")
    spec["format"] = 1
    spec.pop("global_axes", None)
    for u in spec["units"]:
        u.pop("axes", None)
    arrays = {k: np.asarray(v) for k, v in data.items()}
    with open(path, "wb") as f:
        np.savez(f, __spec__=np.array(json.dumps(spec)),
                 __fingerprint__=np.array(A._digest(spec, arrays)), **arrays)


def test_v1_artifact_loads_fully_replicated(tmp_path):
    net = zoo.tiny_resnet(num_classes=4, in_hw=8, width=4, blocks=(2,))
    params = cnn.init_params(net, torch.Generator().manual_seed(0))
    host = CNNHost(net, params, batch=2, device="cpu")
    x = torch.randn((2, 8, 8, net.in_ch), generator=torch.Generator()
                    .manual_seed(1))
    path = os.path.join(str(tmp_path), "v1.npz")
    compress(host, budget_ratio=0.7, P=100).save(path)
    y2 = trt.load(path, device="cpu").apply(x)

    _rewrite_as_v1(path)
    art = trt.load(path, device="cpu")
    assert all(not u.axes for u in art.graph.units)
    assert art.graph.axes == {}
    torch.testing.assert_close(art.apply(x), y2, rtol=0, atol=0)
    rules = trules.make_unit_rules(make_host_mesh())      # one rank here
    art_r = trt.load(path, rules=rules, device="cpu")
    for t in trt.ir.graph_params(art_r.graph)["units"]:
        for v in tex.flatten_tree(t).values():
            assert all(p is None for p in v.sharding.spec)
    torch.testing.assert_close(art_r.executor(rules).apply(x), y2,
                               rtol=0, atol=0)
    # and the reference loads the same v1 file to the same logits
    np.testing.assert_allclose(np.asarray(jrt.load(path).apply(
        jnp.asarray(x.numpy()))), y2.numpy(), rtol=1e-5, atol=1e-5)


def test_one_rank_host_mesh():
    """No process group: the one-rank mesh, whose collectives have
    nothing to exchange; ``model`` must divide the one device."""
    m = make_host_mesh()
    assert mesh_info(m) == {"shape": {"data": 1, "model": 1}, "devices": 1,
                            "axis_names": ["data", "model"]}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=2)
    t = torch.arange(4.0)
    assert tcoll.all_reduce(t, m, "model") is t
    assert tcoll.all_gather(t, m, ("data", "model")) is t


def test_flash_decode_on_one_rank_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 6, 8)).astype(np.float32)
    k = rng.standard_normal((3, 10, 3, 8)).astype(np.float32)
    v = rng.standard_normal((3, 10, 3, 8)).astype(np.float32)
    valid = np.arange(10)[None, :] < np.array([[1], [5], [10]])
    ref_j = np.asarray(jcoll.flash_decode_reference(*map(jnp.asarray,
                                                         (q, k, v, valid))))
    tq, tk, tv, tva = map(torch.from_numpy, (q, k, v, valid))
    np.testing.assert_allclose(
        tcoll.flash_decode_reference(tq, tk, tv, tva).numpy(), ref_j,
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcoll.flash_decode_attention(
        tq, tk, tv, tva, mesh=make_host_mesh()).numpy(), ref_j,
        rtol=1e-5, atol=1e-6)


def test_placement_take_and_logical_constraint():
    """A placement's block and the re-layout of a whole tensor; outside
    ``use_rules`` the constraint is the identity."""
    x = torch.arange(24.0).reshape(4, 6)
    assert trules.logical_constraint(x, ("batch", "ffn")) is x
    m = make_host_mesh()
    rules = trules.make_unit_rules(m)
    p = rules.named(("batch", "ffn"), x.shape)
    assert p.spec == ("data", "model")
    blk = p.take(x)
    assert torch.equal(blk, x) and blk.sharding.shape == (4, 6)
    with trules.use_rules(rules):
        assert torch.equal(trules.logical_constraint(x, ("batch", "ffn")), x)
    fake = types.SimpleNamespace(shape={"data": 2, "model": 3},
                                 index=lambda a: {"data": 1, "model": 2}[a])
    pl = trules.Placement(fake, ("data", "model"))
    assert pl.slices((4, 6)) == (slice(2, 4), slice(4, 6))
    assert pl.local_shape((4, 6)) == (2, 2)
    assert torch.equal(pl.take(x), x[2:4, 4:6])


def test_init_cache_under_rules_is_the_local_block():
    """Under a mesh a KV cache is allocated as this rank's block; one rank
    holds the whole cache and no 'kv_seq' record."""
    cfg = get_config("smollm-135m").reduced()
    with trules.use_rules(trules.make_unit_rules(make_host_mesh())):
        c = L.init_cache(cfg, 4, 16, torch.float32)
    assert c["k"].shape == (4, 16, cfg.num_kv_heads, cfg.head_dim)
    assert "kv_seq" in c and c["kv_seq"] == (0, 16)


# ---------------------------------------------------------------------------
# A rank's block launched with the whole product's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (8, 114, 114, 3, 3, 3, 32, 2), (8, 58, 58, 96, 1, 1, 24, 1),
    (8, 16, 16, 320, 1, 1, 1280, 1), (8, 34, 34, 256, 3, 3, 128, 1),
    (2, 9, 9, 64, 3, 3, 10, 1)])
@pytest.mark.parametrize("x_type,w_type", [(0, 0), (1, 1)])
def test_block_plan_keeps_the_whole_products_order(shape, x_type, w_type):
    """``plan_as_block``: the whole product's tile, splits and k-chunk
    (the order each output sums in) over the block's rows and columns,
    every output of the block summed once over the whole reduction."""
    from repro_torch.kernels import merged_conv as mc
    n, h, w, cin, kh, kw, cout, s = shape
    whole = mc.launch_plan(n, h, w, cin, kh, kw, cout, s, x_type, w_type)
    nb, cb = max(n // 2, 1), -(-cout // 2)
    blk = mc.plan_as_block((n, cout), nb, h, w, cin, kh, kw, cb, s, x_type,
                           w_type)
    assert (blk.bm, blk.bn, blk.splits, blk.k_chunk, blk.dense, blk.s8,
            blk.a_vec) == (whole.bm, whole.bn, whole.splits, whole.k_chunk,
                           whole.dense, whole.s8, whole.a_vec)
    ho, wo = (h - kh) // s + 1, (w - kw) // s + 1
    assert (blk.m, blk.cout, blk.k) == (nb * ho * wo, cb, kh * kw * cin)
    assert blk.b_vec == mc.copy_width(cb, 4 if w_type == 0 else 1, True)
    covered = np.zeros((blk.m, blk.cout), np.int64)
    gx, gy = blk.grid
    for bx in range(gx):
        for by in range(gy):
            (r0, r1), (c0, c1), (k0, k1) = blk.block_outputs(bx, by)
            covered[r0:r1, c0:c1] += k1 - k0
    assert (covered == blk.k).all()


# ---------------------------------------------------------------------------
# merged_ffn's residual switch
# ---------------------------------------------------------------------------

def test_merged_ffn_plain_without_residual():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 24), generator=g)
    u = torch.randn((24, 6), generator=g)
    v = torch.randn((6, 24), generator=g)
    want = (x @ u) @ v
    torch.testing.assert_close(ref.merged_ffn_ref(x, u, v, residual=False),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(ops.merged_ffn_op(x, u, v, residual=False),
                               want, rtol=0, atol=0)
    torch.testing.assert_close(ops.merged_ffn_op(x, u, v),
                               ref.merged_ffn_ref(x, u, v), rtol=0, atol=0)
    from repro_torch.kernels import quant
    uq, us = quant.quantize_int8(u, axis=1)
    vq, vs = quant.quantize_int8(v, axis=1)
    for aq in ("none", "w8a8"):
        full = ops.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                                 act_quant=aq)
        part = ops.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                                 act_quant=aq, residual=False)
        torch.testing.assert_close(part + x, full, rtol=1e-6, atol=1e-6)
