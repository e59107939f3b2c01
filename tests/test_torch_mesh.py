"""Sharded serving on a ('data', 'model') mesh — four ``gloo`` ranks on the
CPU, held against the port's single device and against ``repro``.

The reference's own mesh tests (``tests/test_runtime_mesh.py``) run
forced host devices under XLA; three of the four are red on the
installed jax (ROADMAP.md queue 3), so the sharded port is held against
the port's single-device path (which the other port tests hold against
``repro``), and directly against ``repro`` where ``repro`` still
computes: ``runtime.execute`` on the same artifact, the scheduler's
greedy ids and ``flash_decode_reference``.

Two worlds of four ranks run once for the module
(:func:`repro_torch.testing.world.run_world`, 120 s each at most): a
``data 2 × model 2`` world and a data-only world of 4.  The ranks run
``tests/_torch_mesh_world.py`` (no JAX); the artifacts and inputs are
made here.  Each check below reads its part of the ranks' results.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import get_config as j_get_config
from repro.models import transformer as jT
from repro.runtime import serving as jserving
from repro.sharding.collectives import flash_decode_reference
from repro.train.step import make_serve_step as j_make_serve_step
from repro_torch.core.compress import compress
from repro_torch.configs import get_config
from repro_torch.models import cnn, transformer as T, zoo
from repro_torch.models.cnn_host import CNNHost
from repro_torch.models.transformer_host import CostEnv, TransformerHost
from repro_torch.testing.world import run_world
from repro_torch.tree import flatten_tree

import _torch_mesh_world as W

B, P, NEW = 4, 16, 4


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-9))


def _cnn_artifact(net, path, **kw):
    """A compressed artifact of ``net``, priced at batch 8 (where the
    H100 roofline makes two w8a8 depthwise units pay at ``quantize``)."""
    params = cnn.init_params(net, torch.Generator().manual_seed(0))
    host = CNNHost(net, params, batch=8, device="cpu")
    compress(host, budget_ratio=0.6, P=200, **kw).save(path)
    return {"path": path, "in_ch": net.in_ch}


def _lm_artifact(cfg, path, **kw):
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    host = TransformerHost(cfg, params, env=CostEnv(batch=B, seq=P),
                           device="cpu")
    compress(host, P=200, **kw).save(path)
    return path


def _flash_inputs(rng):
    """GQA (8 heads on 2 kv heads) over a cache of 16 split in two: rows
    whose second slice, or first slice, has no valid entry."""
    q = rng.standard_normal((B, 8, 16)).astype(np.float32)
    k = rng.standard_normal((B, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, 16, 2, 16)).astype(np.float32)
    s = np.arange(16)
    valid = np.stack([s < 3, s < 8, s < 12, s >= 10])
    return q, k, v, valid


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    cnns = {
        "tiny_mobilenet": _cnn_artifact(
            zoo.tiny_mobilenet(num_classes=4, in_hw=16, width=8),
            str(d / "mb.npz")),
        "tiny_mobilenet_w8a8": _cnn_artifact(
            zoo.tiny_mobilenet(num_classes=4, in_hw=16, width=8),
            str(d / "mbq.npz"), quantize="w8a8"),
        "tiny_resnet": _cnn_artifact(
            zoo.tiny_resnet(num_classes=4, in_hw=16, width=8, blocks=(2,)),
            str(d / "rn.npz")),
        "tiny_unet": _cnn_artifact(zoo.tiny_unet(in_hw=16, base=8),
                                   str(d / "un.npz")),
    }
    lms = {
        "smollm": _lm_artifact(
            dataclasses.replace(get_config("smollm-135m").reduced(),
                                num_layers=4),
            str(d / "lm.npz"), budget_ratio=0.6),
        "recurrentgemma": _lm_artifact(
            get_config("recurrentgemma-2b").reduced(), str(d / "rg.npz"),
            budget_ratio=0.9),
    }
    q, k, v, valid = _flash_inputs(rng)
    scfg = W.scheduler_config()
    jcfg = dataclasses.replace(
        j_get_config("smollm-135m").reduced(), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
    jparams, _ = jT.init_model(jcfg, jax.random.PRNGKey(0))
    srng = np.random.RandomState(0)
    sprompts = [srng.randint(0, 128, size=n).astype(np.int32)
                for n in (5, 9, 3, 7, 6, 8)]
    mat, lens = jserving.pad_prompts([jnp.asarray(p) for p in sprompts])
    arrays = {
        **{f"cnn_x/{name}": rng.standard_normal(
            (B, 16, 16, c["in_ch"])).astype(np.float32)
           for name, c in cnns.items()},
        "lm_prompt": rng.integers(0, 64, (B, P)).astype(np.int64),
        "fd_q": q, "fd_k": k, "fd_v": v, "fd_valid": valid,
        "sched_mat": np.asarray(mat).astype(np.int64),
        "sched_lens": np.asarray(lens).astype(np.int64),
    }
    arrays.update({f"sched/{kk}": np.asarray(vv) for kk, vv in
                   flatten_tree(jax.tree.map(np.asarray, jparams)).items()})
    np.savez(str(d / "arrays.npz"), **arrays)
    spec = {"arrays": str(d / "arrays.npz"),
            "cnn": {name: c["path"] for name, c in cnns.items()}, "lm": lms,
            "new_tokens": NEW}
    spec_path = str(d / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    assert scfg.num_heads == jcfg.num_heads
    r2 = run_world(W.world_2x2, 4, backend="gloo", device="cpu",
                   timeout=120, args=(spec_path,))
    rd = run_world(W.world_data, 4, backend="gloo", device="cpu",
                   timeout=120, args=(spec_path,))
    jstep = j_make_serve_step(jcfg)
    jg, _ = jserving.serve_requests(
        jstep, jparams, lambda b, s: jT.init_cache(jcfg, b, s), mat, lens,
        tokens=5, slots=4)
    return {"spec": spec, "arrays": arrays, "r2": r2, "rd": rd,
            "sched_ref": np.asarray(jg)}


def test_host_mesh_model_split(worlds):
    for out in worlds["r2"]:
        assert out["mesh"] == {1: {"data": 4, "model": 1},
                               2: {"data": 2, "model": 2},
                               4: {"data": 1, "model": 4}}
        assert "does not divide" in out["mesh3"]
    assert [o["coords"] for o in worlds["r2"]] == [
        {"data": i // 2, "model": i % 2} for i in range(4)]
    assert all(o["mesh"] == {"data": 4, "model": 1} for o in worlds["rd"])


def test_flash_decode_matches_reference(worlds):
    a = worlds["arrays"]
    ref = np.asarray(flash_decode_reference(
        jnp.asarray(a["fd_q"]), jnp.asarray(a["fd_k"]), jnp.asarray(a["fd_v"]),
        jnp.asarray(a["fd_valid"])))
    for out in worlds["r2"]:
        assert np.isfinite(out["flash"]).all()
        np.testing.assert_allclose(out["flash"], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny_mobilenet", "tiny_mobilenet_w8a8",
                                  "tiny_resnet", "tiny_unet"])
def test_sharded_cnn_executor_matches_single_device(worlds, name):
    x = worlds["arrays"][f"cnn_x/{name}"]
    ref = np.asarray(jrt.load(worlds["spec"]["cnn"][name]).apply(
        jnp.asarray(x)))
    for out in (o["cnn"][name] for o in worlds["r2"]):
        assert out["y"].shape == out["single"].shape == ref.shape
        assert _rel(out["y"], out["single"]) < 1e-5, name
        assert _rel(out["y"], ref) < 1e-5, name
        assert out["split"], name
        assert out["collectives"].get("all_gather", {}).get("calls", 0) > 0
        if name.endswith("w8a8"):
            assert out["codes"] > 0 and out["flips"] == 0, out


def test_sharded_cnn_codes_are_the_single_devices(worlds):
    """w8a8: every rank's int8 activation codes are bitwise its block of
    the single device's (the amax reduced over the split axes)."""
    for o in worlds["r2"]:
        q = o["cnn"]["tiny_mobilenet_w8a8"]
        assert q["codes"] > 0 and q["flips"] == 0, q
        maxes = q["collectives"].get("all_reduce_max", {}).get("calls", 0)
        assert maxes > 0


def _lm_checks(worlds, name):
    prompt = worlds["arrays"]["lm_prompt"]
    jart = jrt.load(worlds["spec"]["lm"][name])
    ref = np.asarray(jrt.execute(jart.graph, {"tokens": jnp.asarray(prompt)}))
    for out in (o["lm"][name] for o in worlds["r2"]):
        assert out["prefill"].shape == out["single"].shape == ref.shape
        assert _rel(out["prefill"], out["single"]) < 1e-5
        assert _rel(out["prefill"], ref) < 1e-5
        # decode through the prompt ≡ prefill (the reference's bar)
        assert _rel(out["decode"], out["prefill"]) < 2e-4
        np.testing.assert_array_equal(out["served"], out["served_single"])
        assert _rel(out["last_logits"], out["last_logits_single"]) < 2e-4
        assert out["split"]
    return [o["lm"][name] for o in worlds["r2"]]


def test_sharded_smollm_artifact(worlds):
    outs = _lm_checks(worlds, "smollm")
    for out in outs:
        # the cache: rows of the data block, the sequence split in two
        assert out["cache_shapes"]["k"][:2] == (B // 2, P // 2)
        coll = out["decode_collectives"]
        assert coll["all_reduce_max"]["calls"] > 0     # flash-decoding


def test_sharded_recurrentgemma_artifact(worlds):
    outs = _lm_checks(worlds, "recurrentgemma")
    for out in outs:
        assert out["decode_collectives"]["all_reduce_sum"]["calls"] > 0


def test_batched_scheduler_under_data_mesh_matches_unsharded(worlds):
    for out in worlds["rd"]:
        g1, g2, rows = out["sched"]
        np.testing.assert_array_equal(g1, worlds["sched_ref"])
        np.testing.assert_array_equal(g2, g1)
        assert rows == 1            # 4 slots over 4 data ranks


def test_moe_and_xlstm_run_under_a_data_only_mesh(worlds):
    for out in worlds["rd"]:
        y, whole, rows = out["moe"]
        np.testing.assert_allclose(y, rows, rtol=1e-5, atol=1e-6)
        y, whole, _ = out["xlstm"]
        np.testing.assert_allclose(y, whole, rtol=1e-5, atol=1e-6)


def test_what_must_raise_under_the_mesh(worlds):
    for out in worlds["rd"]:
        assert "gloo" in out["serve_loop_raises"]
        assert "gloo" in out["engine_raises"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-125m"])
def test_moe_and_xlstm_run_under_a_model_split(worlds, arch):
    """The expert-parallel MoE (2 of 4 experts a rank) and xLSTM with its
    heads split give the single device's logits (an MoE's per data
    block: each block routes as its own group)."""
    for out in worlds["r2"]:
        y, rows, shape = out["model_split"][arch]
        assert shape[1] == 1 if arch == "xlstm-125m" else shape[1] == 2
        np.testing.assert_allclose(y, rows, rtol=1e-5, atol=1e-5)


def test_logical_constraint_slices_and_gathers(worlds):
    """A whole tensor re-laid out to ('batch', 'ffn') is the rank's block;
    laid back out to whole from ('data', 'model') it is the tensor."""
    x = np.arange(24.0).reshape(4, 6)
    for out in worlds["r2"]:
        d, m = out["coords"]["data"], out["coords"]["model"]
        blk, back = out["constraint"]
        np.testing.assert_array_equal(blk, x[2 * d:2 * d + 2,
                                             3 * m:3 * m + 3])
        np.testing.assert_array_equal(back, x)


def test_survivor_mesh_drops_and_raises(worlds):
    outs = worlds["r2"]
    for out in outs[:3]:
        assert out["survivor"] == {"shape": {"data": 3}, "sum": 3.0}
    assert outs[3]["survivor"] is None
    assert all("no surviving" in o["survivor_none"] for o in outs)


def test_world_runs_without_jax():
    """The ranks import no JAX: the world blocks it."""
    assert run_world(W.imports_jax, 2, timeout=60) == [False, False]


def test_world_fails_on_a_hang():
    from repro_torch.testing.world import WorldError
    with pytest.raises(WorldError, match="timed out"):
        run_world(W.sleep_forever, 2, timeout=10)
