"""The port's main path against the JAX package's, end to end on the CPU.

On ``tiny_resnet``, ``tiny_mobilenet`` and ``tiny_unet`` (BN, GN,
attention, pool, upsample, concat and projection shortcuts between them)
with the same numpy parameters in both packages:

* ``apply_replaced`` and ``lower_plan`` + ``execute`` agree under the
  JAX package's plans;
* artifacts cross both ways with their fingerprints verified and equal
  specs, and give the same outputs;
* ``python -m repro_torch.compress --device cpu`` writes an artifact the
  JAX package loads.

Tolerance: max |Δ| ≤ 1e-5 · max |y| (fp32 convolutions summed in other
orders, merged kernels composed by different convolution code).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import compress as jax_compress
from repro.core.plan import identity_plan
from repro.models import cnn as jcnn
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro_torch import runtime as trt
from repro_torch.core.compress import CompressResult
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import zoo as tzoo

from _torch_parity import ZOO, np_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


@pytest.fixture(scope="module", params=sorted(ZOO))
def setup(request):
    name = request.param
    jnet = getattr(jzoo, name)(**ZOO[name])
    tnet = getattr(tzoo, name)(**ZOO[name])
    params = np_params(jnet, seed=3)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = tcnn.params_from_numpy(params, "cpu")
    jh = jhost.CNNHost(jnet, jparams, batch=2)
    th = thost.CNNHost(tnet, tparams, batch=2, device="cpu")
    x = np.random.default_rng(7).standard_normal(
        (2, jnet.in_hw, jnet.in_hw, jnet.in_ch)).astype(np.float32)
    plans, res = [identity_plan(jnet.L, jh.descs())], None
    for ratio in (0.6, 0.8):
        r = jax_compress(jh, budget_ratio=ratio, P=100)
        if r is not None:
            plans.append(r.plan)
            res = r
    assert res is not None
    return name, jh, th, x, plans, res


def test_params_round_trip(setup):
    _, jh, th, _, _, _ = setup
    back = tcnn.params_to_numpy(th.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jh.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_replaced_and_merged_forwards_match(setup):
    name, jh, th, x, plans, _ = setup
    xt = torch.from_numpy(x)
    for plan in plans:
        y_rep = tcnn.apply_replaced(th.net, th.params, xt, plan)
        _close(y_rep, jcnn.apply_replaced(jh.net, jh.params, jnp.asarray(x),
                                          plan))
        tgraph = th.lower_plan(plan)
        y_merged = trt.execute(tgraph, x, device="cpu")
        _close(y_merged, jrt.execute(jh.lower_plan(plan), jnp.asarray(x)))
        # merge exactness inside the port
        _close(y_merged, y_rep)
        mod = trt.GraphModule(tgraph)
        np.testing.assert_array_equal(mod(xt).numpy(), y_merged.numpy())


def test_jax_artifact_loads_in_port(setup, tmp_path):
    name, jh, th, x, plans, res = setup
    path = str(tmp_path / f"{name}.npz")
    fp = res.save(path)
    art = trt.load(path, device="cpu")
    assert art.fingerprint == fp
    # the spec the port rebuilds from what it loaded is the stored one
    assert trt.fingerprint(art.graph, art.plan, art.meta) == fp
    assert art.plan.to_json() == res.plan.to_json()
    _close(art.apply(x), jrt.load(path).apply(jnp.asarray(x)))


def test_port_artifact_loads_in_jax(setup, tmp_path):
    name, jh, th, x, plans, res = setup
    tres = CompressResult(plan=res.plan, tables=None,
                          original_latency=res.original_latency,
                          compressed_latency=res.compressed_latency,
                          dp_seconds=0.0, host=th, params=th.params)
    path = str(tmp_path / f"{name}_port.npz")
    fp = tres.save(path, extra_meta={"source": {"arch": name}})
    jart = jrt.load(path)
    assert jart.fingerprint == fp
    assert jart.plan.to_json() == res.plan.to_json()
    y_port = trt.load(path, device="cpu").apply(x)
    _close(y_port, jart.apply(jnp.asarray(x)))
    # the same plan lowered by each package publishes the same spec and
    # the same array keys, shapes and dtypes
    paths = [str(tmp_path / "j.npz"), str(tmp_path / "t.npz")]
    meta = {"source": {"arch": name}}
    jrt.save(paths[0], jh.lower_plan(res.plan), plan=res.plan, meta=meta)
    trt.save(paths[1], th.lower_plan(res.plan), plan=res.plan, meta=meta)
    (js, ja), (ts, ta) = (_spec_and_arrays(p) for p in paths)
    assert js == ts
    assert {k: (v.shape, v.dtype) for k, v in ja.items()} == \
        {k: (v.shape, v.dtype) for k, v in ta.items()}


def _spec_and_arrays(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    spec = json.loads(data.pop("__spec__").item())
    data.pop("__fingerprint__")
    return spec, data


def test_corrupt_artifact_is_refused(tmp_path):
    net = tzoo.tiny_mobilenet(**ZOO["tiny_mobilenet"])
    host = thost.CNNHost(net, tcnn.init_params(net), device="cpu")
    path = str(tmp_path / "a.npz")
    trt.save(path, host.lower_plan(identity_plan(net.L, host.descs())))
    data = dict(np.load(path))
    data["u0000/w"] = data["u0000/w"] + 1.0
    np.savez(path, **data)
    with pytest.raises(trt.ArtifactError, match="fingerprint"):
        trt.load(path, device="cpu")


def test_cli_artifact_loads_in_jax(tmp_path):
    out = str(tmp_path / "tm.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.compress", "--arch",
         "tiny_mobilenet", "--device", "cpu", "--budget-ratio", "0.7",
         "--out", out], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"predicted_speedup"' in proc.stdout
    jart = jrt.load(out)
    tart = trt.load(out, device="cpu")
    assert jart.fingerprint == tart.fingerprint
    assert any(u.kind == "conv" and u.depthwise for u in tart.graph.units)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    _close(tart.apply(x), jart.apply(jnp.asarray(x)))
