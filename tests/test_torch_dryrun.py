"""The port's dry run (``repro_torch.launch.dryrun``), its production mesh
and its input specs, on the CPU.

* ``make_production_mesh`` over a fake process group of 256 and 512
  ranks: axis names, shape, and the members of rank 0's group of each
  axis set;
* ``launch.specs`` against ``repro.launch.specs`` for every id × shape:
  the batch's shapes and dtype names, the params' (abstract on both
  sides), and the decode cache's (the port's one state per layer against
  the reference's stacked groups);
* one production cell end to end, ``--arch smollm-135m --shape
  decode_32k --mesh both``, which reports ``0 failures``, as the
  reference's own test does; and one ``--budget 0.6 --shape train_4k``
  cell.

The fake world of 4 held against a real world's step, exactly, is in
``tests/test_torch_mesh_train.py`` (it reads that module's world).
"""
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import specs as jS
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models import transformer as T


@pytest.fixture
def fake_group():
    """The fake process group the dry run joins, torn down afterwards so
    no later test of this process sees a process group."""
    yield D.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def _members(mesh, axes):
    return dist.get_process_group_ranks(mesh.group(axes))


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh(fake_group, multi):
    n = 512 if multi else 256
    with pytest.raises(ValueError, match=f"{n} ranks"):
        M.make_production_mesh(multi_pod=multi)
    fake_group(n)
    mesh = M.make_production_mesh(multi_pod=multi)
    names = ("pod", "data", "model") if multi else ("data", "model")
    assert mesh.axis_names == names
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                          else {"data": 16, "model": 16})
    assert M.mesh_info(mesh)["devices"] == n
    assert mesh.ranks == tuple(range(n)) and mesh.rank == 0
    assert mesh.coords == {a: 0 for a in names}
    assert _members(mesh, "model") == list(range(16))
    assert _members(mesh, "data") == list(range(0, 256, 16))
    assert _members(mesh, ("data", "model")) == list(range(256))
    if multi:
        assert _members(mesh, "pod") == [0, 256]
        assert _members(mesh, ("pod", "data")) == list(range(0, 512, 16))
        assert _members(mesh, ("pod", "data", "model")) == list(range(512))


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _same(port, ref):
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(port[k].shape) == tuple(v.shape), k
        assert _dtype(port[k]) == str(v.dtype), k
        assert port[k].device.type == "meta", k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_repro(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    params, axes = S.param_specs(tc)
    jparams, jaxes = jS.param_specs(jc)
    _same(_flat(params), _flat(jparams))
    assert _flat(axes) == _flat(jaxes)
    assert set(SHAPES) == set(J_SHAPES)
    for name, shape in SHAPES.items():
        for targets in (False, True):
            b = S.batch_specs(tc, shape, with_targets=targets)
            _same(b, jS.batch_specs(jc, J_SHAPES[name],
                                    with_targets=targets))
            assert S.batch_axes(tc, shape, with_targets=targets) == \
                jS.batch_axes(jc, J_SHAPES[name], with_targets=targets)
        assert S.input_specs(tc, shape).keys() == \
            jS.input_specs(jc, J_SHAPES[name]).keys()
        if shape.mode != "decode" or shape.seq_len > 32768:
            continue
        # the port's cache, one state per layer, against the reference's
        # stacked per layer group
        cache = S.cache_specs(tc, shape)
        jcache = jS.cache_specs(jc, J_SHAPES[name])
        li = 0
        for g, jg in zip(T.layer_groups(tc), jcache):
            for _ in range(g.count):
                st = {k: v for k, v in cache[li].items()
                      if isinstance(v, torch.Tensor)}
                _same(st, {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                           for k, v in jg.items()})
                li += 1
        assert li == len(cache) == tc.num_layers


def test_production_decode_cell_end_to_end(fake_group, tmp_path, capsys):
    """The reference's own dry-run cell at 256 and 512 ranks."""
    rc = D.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "done, 0 failures" in out, out
    for mesh, n in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"smollm-135m__decode_32k__{mesh}"
                          ".json").read_text())
        assert rec["status"] == "ok" and rec["mesh"]["devices"] == n
        assert rec["mode"] == "decode" and rec["num_layers"] == 30
        assert "compile_s" not in rec and "hlo_bytes" not in rec
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["cost"]["flops"] > 0
        # flash-decoding's combine over 'model' and the embedding's sum
        assert rec["collectives"]["all-reduce"]["count"] > 0
        assert rec["collectives"]["total_bytes"] == sum(
            v["bytes"] for k, v in rec["collectives"].items()
            if k != "total_bytes")
    single = json.loads((tmp_path / "smollm-135m__decode_32k__single.json")
                        .read_text())
    multi = json.loads((tmp_path / "smollm-135m__decode_32k__multi.json")
                       .read_text())
    # twice the ranks, each with half the rows of the batch and its cache
    assert multi["memory"]["argument_size_in_bytes"] < \
        single["memory"]["argument_size_in_bytes"]


def test_budget_train_cell(fake_group, tmp_path, capsys):
    rc = D.main(["--arch", "smollm-135m", "--shape", "train_4k", "--mesh",
                 "single", "--budget", "0.6", "--tag", "lm",
                 "--out", str(tmp_path)])
    assert rc == 0, capsys.readouterr().out
    rec = json.loads((tmp_path / "smollm-135m__train_4k__single__lm.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mode"] == "train"
    comp = rec["compression"]
    assert comp["budget"] == 0.6 and comp["predicted_speedup"] > 1.0
    assert len(comp["units"]) < 2 * 30
    ops = rec["collective_ops"]
    # FSDP: the weights' gathers forward, their reduce-scatters backward
    assert ops["all_gather"]["calls"] > 0
    assert ops["reduce_scatter:bwd"]["calls"] > 0
    assert np.isfinite(rec["cost"]["flops"]) and rec["cost"]["flops"] > 0
