"""Sharded training on a ('data', 'model') mesh — four ``gloo`` ranks on
the CPU, held against the port's single device and against ``repro``.

One data 2 × model 2 world runs once for the module
(:func:`repro_torch.testing.world.run_world`, 240 s at most); its ranks
run ``tests/_torch_mesh_train_world.py`` (no JAX).  Each check reads its
part of the ranks' results:

* the sharded train step of the reduced smollm-135m, granite-moe (its
  experts split over 'model') and xlstm-125m (its heads split), 3 steps
  under three presets — FSDP params with ZeRO gradient shardings,
  FSDP-free params with batches from ``GlobalBatcher(mesh=)``, and
  FSDP-free params with ZeRO gradient shardings and 2 microbatches — has
  the single device's losses, gradient norms and parameters within 2e-4
  (the reference's tolerance for its SPMD check,
  ``tests/test_distributed.py``);
* each collective's backward against ``torch.autograd`` of its
  whole-tensor version (and the vocab-parallel NLL's against
  ``token_nll``'s);
* ``compressed_allreduce`` bitwise the reference's on 4 forced host
  devices;
* the expert-parallel MoE against ``repro``'s grouped ``moe_ffn`` with a
  group per data block;
* xLSTM decode with its heads split gives the single device's tokens;
* the elastic restore, bitwise (mirroring ``tests/test_ft.py``), and
  ``train_loop``'s restart under the mesh;
* ``python -m repro_torch.launch.train --distributed`` at 2 gloo ranks.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jM
from repro.testing.subproc import run_code
from repro_torch.checkpoint import ckpt as CK
from repro_torch.models import transformer as T
from repro_torch.testing.world import run_world
from repro_torch.tree import flatten_tree

import _torch_mesh_train_world as W

TOL = 2e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshtrain")
    rng = np.random.default_rng(0)
    arrays = {}
    for i in range(W.STEPS):
        arrays[f"tok/{i}"] = rng.integers(0, 64, (W.B, W.S)).astype(np.int64)
        arrays[f"tgt/{i}"] = rng.integers(0, 64, (W.B, W.S)).astype(np.int64)
    for k, shape in {"x": (4, 6), "w1": (6, 8), "w2": (8, 5), "c": (4, 5),
                     "t": (6, 3), "ct": (6, 3), "w": (6, 4), "u": (4, 6),
                     "xr": (8, 6), "z": (3, 5, 8), "cn": (3, 5)}.items():
        arrays[f"g/{k}"] = rng.standard_normal(shape).astype(np.float32)
    arrays["g_tgt"] = rng.integers(0, 8, (3, 5)).astype(np.int64)
    arrays["car_g"] = rng.standard_normal((8, 64)).astype(np.float32)
    cfg = W.config("granite-moe-1b-a400m")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    for k, v in params["groups"][0]["ffn"].items():
        arrays[f"moe/{k}"] = v[0].numpy()
    arrays["moe_x"] = rng.standard_normal((4, 6, cfg.d_model)) \
        .astype(np.float32)
    arrays["gp_w"] = (rng.standard_normal((4, 8, 8)) * 0.4) \
        .astype(np.float32)
    arrays["gp_x"] = rng.standard_normal((8, 8)).astype(np.float32)
    np.savez(str(d / "arrays.npz"), **arrays)
    tree = {"w": torch.arange(64.0).reshape(8, 8) * 3,
            "b": torch.arange(8.0) - 4, "n": torch.ones(3)}
    CK.save(str(d / "ck1"), 1, tree)
    units_spec = _compressed_spec()
    spec = {"arrays": str(d / "arrays.npz"), "dir": str(d),
            "units_spec": units_spec}
    spec_path = str(d / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    ranks = run_world(W.world_train, 4, backend="gloo", device="cpu",
                      timeout=240, args=(spec_path,))
    single = {(arch, micro): W.train_single(arch, arrays, micro)
              for arch in W.ARCHS for micro in (1, 2)}
    return {"arrays": arrays, "ranks": ranks, "single": single, "dir": d,
            "saved": {k: v.numpy() for k, v in tree.items()},
            "units_spec": units_spec,
            "compressed": W.train_compressed_single(arrays, units_spec)}


def _compressed_spec():
    """The compressed network's units: the reduced 4-layer smollm's
    abstract plan at budget 0.6 under the JAX package's oracle constants
    (the spec ``tests/test_torch_forward_compressed.py`` holds equal to
    ``repro``'s), with a merged unit."""
    from repro.core import latency as jlat
    from repro_torch.core.latency import AnalyticOracle
    from repro_torch.models import transformer_host as TH
    cfg = W.compressed_config()
    res = TH.abstract_plan(cfg, budget_ratio=0.6,
                           env=TH.CostEnv(batch=2, seq=16),
                           latency_oracle=AnalyticOracle(
                               peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6))
    spec = [list(u) for u in TH.plan_units_spec(cfg, res.plan)]
    assert any(u[0] == "merged" for u in spec)
    return spec


@pytest.mark.parametrize("preset", list(W.PRESETS))
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_step_matches_single_device(world, arch, preset):
    micro = W.PRESETS[preset][2]
    losses1, norms1, params1 = world["single"][arch, micro]
    for out in world["ranks"]:
        losses, norms, _, coll, _ = out["train"][arch, preset]
        np.testing.assert_allclose(losses, losses1, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(norms, norms1, rtol=TOL, atol=TOL)
        # the backward exchanged something: the split inputs' sums
        assert any(k.endswith(":bwd") for k in coll), coll
    params = world["ranks"][0]["train"][arch, preset][2]
    assert params.keys() == params1.keys()
    for k, v in params1.items():
        np.testing.assert_allclose(params[k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)
    # the params moved by far more than the tolerance
    start = {k: v.numpy() for k, v in flatten_tree(T.init_model(
        W.config(arch), torch.Generator().manual_seed(0),
        device="cpu")[0]).items()}
    assert max(float(np.abs(params1[k] - start[k]).max())
               for k in start) > 10 * TOL


@pytest.mark.parametrize("preset", list(W.COMPRESSED_PRESETS))
def test_compressed_sharded_step_matches_single_device(world, preset):
    """A LayerMerge-compressed network trained sharded: FSDP params with
    ZeRO gradient shardings through ``forward_compressed_spec``, and
    FSDP-free params through ``make_compressed_forward`` (the executor's
    unit loops), against the single device's ``make_compressed_forward``
    steps, within 2e-4."""
    losses1, norms1, params1 = world["compressed"]
    for out in world["ranks"]:
        losses, norms, params, coll, _ = out["compressed"][preset]
        np.testing.assert_allclose(losses, losses1, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(norms, norms1, rtol=TOL, atol=TOL)
        # the merged unit's input entered its split rank: summed backward
        assert coll["all_reduce_sum:bwd"]["calls"] > 0, coll
        assert params.keys() == params1.keys()
        for k, v in params1.items():
            np.testing.assert_allclose(params[k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)
    # the params moved by far more than the tolerance
    start = {k: v.numpy() for k, v in flatten_tree(
        W._spec_params(world["units_spec"])).items()}
    assert max(float(np.abs(params1[k] - start[k]).max())
               for k in start) > 10 * TOL


def test_gpipe_matches_sequential_and_repro(world):
    """``gpipe_forward`` over pod 4 (the reference test's tanh stages,
    4 microbatches) against the stages run in sequence and against
    ``repro``'s ``gpipe_forward`` on 8 forced host devices, within 1e-5;
    each stage but the last sends once a tick."""
    a = world["arrays"]
    ref = a["gp_x"]
    for i in range(4):
        ref = np.tanh(ref @ a["gp_w"][i])
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.sharding.collectives import gpipe_forward
        mesh = jax.make_mesh((4, 2), ("pod", "model"))
        wp = jnp.asarray(np.array({a["gp_w"].tolist()!r}, np.float32))
        x = jnp.asarray(np.array({a["gp_x"].tolist()!r}, np.float32))
        y = gpipe_forward(lambda w, xm: jnp.tanh(xm @ w), wp, x, mesh=mesh,
                          axis="pod", num_micro=4)
        np.save({str(world["dir"] / "gpipe.npy")!r}, np.asarray(y))
        print("GPIPE_OK")
    """)
    r = run_code(code, devices=8, timeout=300)
    assert "GPIPE_OK" in r.stdout, r.stdout + r.stderr
    jref = np.load(world["dir"] / "gpipe.npy")
    for rank, out in enumerate(world["ranks"]):
        y, counts = out["gpipe"]
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, jref, rtol=1e-5, atol=1e-5)
        sends = counts.get("collective_permute", {"calls": 0})["calls"]
        assert sends == (7 if rank < 3 else 0)


def test_dryrun_fake_world_matches_real_world(world, tmp_path):
    """The dry run of the compressed FSDP step (``python -m
    repro_torch.launch.dryrun --spec``: a fake world of 4, data 2 × model
    2, every tensor on ``meta``) issues exactly the collectives, calls
    and bytes each way, that rank 0's real step issued, on exactly its
    argument bytes."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = W.compressed_config()
    base = get_config("smollm-135m")
    overrides = {f.name: getattr(cfg, f.name) for f in
                 dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(base, f.name)}
    spec = {"arch": "smollm-135m", "overrides": overrides,
            "shape": {"seq_len": W.S, "global_batch": W.B,
                      "mode": "train"},
            "mesh": {"data": 2, "model": 2}, "options": {"fsdp": True},
            "units_spec": world["units_spec"]}
    path = tmp_path / "cell.json"
    path.write_text(json.dumps(spec))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--spec",
         str(path)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH="src"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    _, _, _, coll, arg_bytes = world["ranks"][0]["compressed"]["fsdp"]
    assert rec["status"] == "ok" and rec["mesh"]["devices"] == 4
    assert rec["collective_ops"] == coll
    assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
    assert rec["collectives"]["total_bytes"] == sum(
        v["bytes"] for v in coll.values())
    assert rec["cost"]["flops"] > 0


def test_single_device_step_matches_repro(world):
    """The port's single-device losses (the sharded steps' yardstick)
    against ``repro``'s jitted step from the same params and batches."""
    from repro.optim import adamw as JA
    from repro.train import step as JS
    arch = "smollm-135m"
    jcfg = j_get_config(arch).reduced()
    params, _ = T.init_model(W.config(arch),
                             torch.Generator().manual_seed(0), device="cpu")
    jp = jax.tree.map(jnp.asarray, T.params_to_numpy(params))
    opt = W.OPT
    jstep = jax.jit(JS.make_train_step(jcfg, JA.AdamWConfig(
        lr=opt.lr, eps=opt.eps, warmup_steps=opt.warmup_steps,
        total_steps=opt.total_steps)))
    jstate = JA.init_opt_state(jp)
    losses = []
    for i in range(W.STEPS):
        b = {k: jnp.asarray(v.astype(np.int32)) for k, v in
             W.Batches(world["arrays"]).batch_at(i).items()}
        jp, jstate, m = jstep(jp, jstate, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(world["single"][arch, 1][0], losses,
                               rtol=1e-5)


def test_zero_moments_are_the_grad_shardings_blocks(world):
    """ZeRO: the moments are this rank's blocks of the grad shardings —
    the experts' 'expert_embed' over 'data' on top of the params' split,
    and every 'embed' dim over 'data' for FSDP-free params."""
    cfg = W.config("granite-moe-1b-a400m")
    for out in world["ranks"]:
        for preset in ("fsdp", "zero"):
            mu = out["train"]["granite-moe-1b-a400m", preset][4]
            e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_dff
            assert mu["groups/0/ffn/w_gate"] == (cfg.num_layers, e // 2,
                                                 d // 2, f)
        mu = out["train"]["smollm-135m", "zero"][4]
        assert mu["groups/0/ffn/w_up"][1] == W.config(
            "smollm-135m").d_model // 2
        mu = out["train"]["smollm-135m", "tp_dp"][4]
        assert mu["groups/0/ffn/w_up"][1] == W.config(
            "smollm-135m").d_model


@pytest.mark.parametrize("case", ["mlp", "gather", "weight", "weights",
                                  "vocab_nll"])
def test_collective_backward_matches_autograd(world, case):
    whole = W.grad_cases_whole(world["arrays"])[case]
    for out in world["ranks"]:
        got = out["grads"][case]
        pairs = zip(got, whole) if isinstance(whole, list) \
            else [(got, whole)]
        for g, w in pairs:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    counts = world["ranks"][0]["grads"]["counts"]
    assert counts["all_reduce_sum:bwd"]["calls"] >= 1       # enter_split
    assert counts["reduce_scatter:bwd"]["calls"] >= 1       # gather_weight


def test_compressed_allreduce_bitwise_repro(world):
    g = world["arrays"]["car_g"]
    code = textwrap.dedent(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.sharding.collectives import compressed_allreduce
        mesh = jax.make_mesh((4,), ("data",))
        g = jnp.asarray(np.array({g.tolist()!r}, np.float32))
        out = compressed_allreduce({{"w": g}}, mesh=mesh, axis="data")
        np.save({str(world["dir"] / "car.npy")!r}, np.asarray(out["w"]))
        print("CAR_OK")
    """)
    r = run_code(code, devices=4, timeout=300)
    assert "CAR_OK" in r.stdout, r.stdout + r.stderr
    ref = np.load(world["dir"] / "car.npy")
    n = g.shape[0] // 4
    exact = g.reshape(4, n, -1).sum(0)
    for rank, out in enumerate(world["ranks"]):
        res, codes = out["car"]
        np.testing.assert_array_equal(res, ref[rank * n:(rank + 1) * n])
        assert codes.dtype == np.int32 and np.abs(codes).max() <= 4 * 127
        assert float(np.abs(res - exact).max()) < 0.05 * np.abs(exact).max()


def test_sharded_moe_matches_repro_grouped(world):
    a = world["arrays"]
    cfg = j_get_config("granite-moe-1b-a400m").reduced()
    p = {k[len("moe/"):]: jnp.asarray(v) for k, v in a.items()
         if k.startswith("moe/")}
    x = a["moe_x"]
    # routing flips under reassociation: every top-k choice has a margin
    gates = jax.nn.softmax(np.asarray(x).reshape(-1, cfg.d_model)
                           @ np.asarray(p["router"]), axis=-1)
    top = np.sort(np.asarray(gates), axis=-1)[:, ::-1]
    assert float((top[:, cfg.experts_per_token - 1]
                  - top[:, cfg.experts_per_token]).min()) > 1e-5
    ref = np.asarray(jM.moe_ffn(p, jnp.asarray(x), cfg,
                                capacity_factor=cfg.capacity_factor,
                                num_groups=2))
    for out in world["ranks"]:
        y, w_shape, coll = out["moe"]
        assert w_shape[0] == cfg.num_experts // 2
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
        assert coll["all_reduce_sum"]["calls"] == 1


def test_xlstm_decode_with_heads_split(world):
    cfg = W.config("xlstm-125m")
    for out in world["ranks"]:
        toks1, toks2, lg1, lg2, state = out["xlstm"]
        np.testing.assert_array_equal(toks2, toks1)
        np.testing.assert_allclose(lg2, lg1, rtol=1e-4, atol=1e-4)
        hd = cfg.d_model // cfg.num_heads
        # the mLSTM state: this rank's rows (batch 4 over data 2), heads
        assert state["C"] == (2, cfg.num_heads // 2, hd, hd)


def test_elastic_restore_bitwise(world):
    """A 2 × 2 run's save restores on a data 1 × model 4 mesh and on one
    process; a one-process save restores on the 2 × 2 mesh."""
    saved = world["saved"]
    whole = CK.restore(str(world["dir"] / "ck22"), 1,
                       {"w": torch.zeros(8, 8), "b": torch.zeros(8),
                        "n": torch.zeros(3)})
    base = {"w": np.arange(64.0).reshape(8, 8), "b": np.arange(8.0),
            "n": np.ones(3)}
    for k, v in base.items():
        np.testing.assert_array_equal(whole[k].numpy(), v.astype(np.float32))
    for rank, out in enumerate(world["ranks"]):
        e = out["elastic"]
        np.testing.assert_array_equal(e["w14"], base["w"][:, 2 * rank:
                                                          2 * rank + 2])
        np.testing.assert_array_equal(e["b14"], base["b"][2 * rank:
                                                          2 * rank + 2])
        np.testing.assert_array_equal(e["n14"], base["n"])
        d, m = divmod(rank, 2)
        np.testing.assert_array_equal(
            e["w22"], saved["w"][4 * d:4 * d + 4, 4 * m:4 * m + 4])
        np.testing.assert_array_equal(e["b22"], saved["b"][4 * m:4 * m + 4])
        assert e["w22_spec"] == ("data", "model")


def test_loop_restarts_under_the_mesh(world):
    """Every rank's failure hook fires before step 3: each restores its
    blocks from the step-2 checkpoint (written by the main process alone)
    and replays step 2 bitwise; the run ends where a clean one does,
    bitwise."""
    for out in world["ranks"]:
        failed, clean = out["loop"]["failed"], out["loop"]["clean"]
        assert failed["restarts"] == 1 and failed["final_step"] == 5
        assert clean["restarts"] == 0 and len(clean["losses"]) == 5
        assert failed["losses"][3] == failed["losses"][2]
        assert failed["losses"][:3] + failed["losses"][4:] == clean["losses"]
        for k, v in clean["params"].items():
            np.testing.assert_array_equal(failed["params"][k], v, err_msg=k)


def _launch(tmp_path, *extra, nproc=2):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", "repro_torch.launch.train",
         "--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--distributed", "--ckpt-dir", str(tmp_path / "ck"), *extra],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_launcher_distributed_two_gloo_ranks(tmp_path):
    out = _launch(tmp_path, "--steps", "5", "--warmup", "1")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("restarts=0") == 2, out.stdout
    assert "'data': 2" in out.stdout
    assert CK.latest_step(str(tmp_path / "ck")) == 5
    # both ranks report the global loss: the one process's at 4 decimals
    losses = {l.split("final loss ")[1].split()[0]
              for l in out.stdout.splitlines() if "final loss" in l}
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--reduced", "--device", "cpu", "--steps", "5",
         "--warmup", "1", "--ckpt-dir", str(tmp_path / "one")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH="src"),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert one.returncode == 0, one.stderr
    assert losses == {one.stdout.split("final loss ")[1].split()[0]}
    out = _launch(tmp_path, "--steps", "7", "--warmup", "1", "--resume")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resumed from step 5" in out.stdout
    assert CK.latest_step(str(tmp_path / "ck")) == 7
