"""The port's data pipeline and pytree checkpoints against the JAX
package's, on the CPU.

* ``MarkovLM`` tables and ``SyntheticTokens`` batches are bitwise the JAX
  package's for the same ``(seed, index)``;
* a checkpoint written by either package restores in the other bitwise
  (fp32, int32, nested dicts and lists, a 0-d step; bf16 both ways);
* the port's own contracts, mirroring ``tests/test_substrates.py``:
  determinism, prefetch order, device batches (and a mesh's rows),
  round trip (and a restore onto a mesh's placements), ``keep`` and the
  ``.tmp`` crash contract, the asynchronous writer.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro.data import pipeline as JP
from repro_torch.checkpoint import ckpt as TC
from repro_torch.data import pipeline as TP
from repro_torch.tree import flatten_tree


@pytest.mark.parametrize("vocab,batch,seq,seed", [
    (64, 4, 32, 0), (49152, 2, 17, 7), (256000, 1, 5, 3), (5, 3, 64, 11)])
def test_synthetic_tokens_are_bitwise_the_references(vocab, batch, seq, seed):
    t = TP.SyntheticTokens(vocab, batch, seq, seed=seed)
    j = JP.SyntheticTokens(vocab, batch, seq, seed=seed)
    np.testing.assert_array_equal(t.lm.table, j.lm.table)
    for index in (0, 1, 25):
        tb, jb = t.batch_at(index), j.batch_at(index)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])


def test_data_determinism_and_structure():
    src = TP.SyntheticTokens(vocab_size=64, batch=4, seq=32, seed=7)
    b1, b2 = src.batch_at(5), src.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(src.batch_at(6)["tokens"], b1["tokens"])
    assert b1["targets"].max() < 64
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_prefetch_yields_in_order():
    src = TP.SyntheticTokens(vocab_size=16, batch=2, seq=8)
    it = TP.prefetch(lambda i: src.batch_at(i), start=3, depth=2)
    assert next(it)[0] == 3
    assert next(it)[0] == 4
    it.close()


def test_global_batcher_gives_device_tensors():
    src = TP.SyntheticTokens(vocab_size=64, batch=2, seq=8, seed=1)
    out = TP.GlobalBatcher(src, device="cpu")(4)
    host = src.batch_at(4)
    for k, v in host.items():
        assert out[k].dtype == torch.int32 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)
    # on a mesh: this rank's rows, carrying their placement (the one
    # process's mesh holds every row); a batch the axes do not divide
    # stays whole and unmarked
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()
    rows = TP.GlobalBatcher(src, mesh=mesh, device="cpu")(4)
    for k, v in host.items():
        np.testing.assert_array_equal(rows[k].numpy(), v)
        assert rows[k].sharding.spec == ("data",)
        assert rows[k].sharding.shape == v.shape
    odd = TP.GlobalBatcher(src, mesh=mesh, batch_axes=("pod",),
                           device="cpu")(4)
    assert getattr(odd["tokens"], "sharding", None) is None


def _np_state():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "groups": [{"a": rng.standard_normal(5)
                                   .astype(np.float32)},
                                  {"a": np.arange(4, dtype=np.int32)}]},
            "opt": {"step": np.array(7, np.int32),
                    "mu": [rng.standard_normal((2, 2)).astype(np.float32)]}}


def _torch_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoints_cross_both_ways_bitwise(tmp_path, writer):
    state = _np_state()
    jtree = jax.tree.map(jnp.asarray, state)
    ttree = _torch_tree(state)
    if writer == "repro":
        JC.save(str(tmp_path), 20, jtree, metadata={"loss": 1.5})
        assert TC.latest_step(str(tmp_path)) == 20
        out = flatten_tree(TC.restore(str(tmp_path), 20, ttree))
        want = _jax_flat(jtree)
        got = {k: v.numpy() for k, v in out.items()}
    else:
        TC.save(str(tmp_path), 20, ttree, metadata={"loss": 1.5})
        assert JC.latest_step(str(tmp_path)) == 20
        got = _jax_flat(JC.restore(str(tmp_path), 20, jtree))
        want = {k: v.numpy() for k, v in flatten_tree(ttree).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    meta = json.load(open(tmp_path / "step_20" / "meta.json"))
    assert meta["step"] == 20 and meta["metadata"] == {"loss": 1.5}
    assert meta["keys"] == sorted(want)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_bf16_checkpoints_cross_both_ways(tmp_path, writer):
    """numpy has no bfloat16: the port writes a bf16 leaf widened to fp32
    and reads the JAX package's raw 2-byte records; either way the
    restored leaf is bitwise the saved one."""
    x = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    assert torch.equal(tx.float(), want)
    if writer == "repro":
        JC.save(str(tmp_path), 1, {"w": jx})
        got = TC.restore(str(tmp_path), 1, {"w": torch.zeros(
            4, 3, dtype=torch.bfloat16)})["w"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), want)
    else:
        TC.save(str(tmp_path), 1, {"w": tx})
        got = JC.restore(str(tmp_path), 1, {"w": jx})["w"]
        assert got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got.astype(jnp.float32)),
                                      want.numpy())


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nest": {"b": torch.ones(4, dtype=torch.int32)},
            "lst": [torch.zeros(2), torch.full((3,), 7.0)]}
    TC.save(str(tmp_path), 10, tree)
    assert TC.latest_step(str(tmp_path)) == 10
    out = TC.restore(str(tmp_path), 10, tree)
    for k, v in flatten_tree(tree).items():
        assert torch.equal(flatten_tree(out)[k], v)
    with pytest.raises(KeyError, match="missing"):
        TC.restore(str(tmp_path), 10, {"zz": torch.zeros(1)})
    # elastic restore onto a mesh: each leaf this rank's block of its
    # placement (the one process's mesh: the whole leaf), carrying it
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import Placement
    mesh = make_host_mesh()
    places = {"a": Placement(mesh, ("data", "model")),
              "nest": {"b": None}, "lst": [Placement(mesh, ()), None]}
    out = TC.restore(str(tmp_path), 10, tree, shardings=places)
    assert out["a"].sharding.spec == ("data", "model")
    assert out["a"].sharding.shape == (2, 3)
    for k, v in flatten_tree(tree).items():
        assert torch.equal(flatten_tree(out)[k], v)


def test_checkpoint_gc_and_atomicity(tmp_path):
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        TC.save(str(tmp_path), s, tree, keep=2)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    assert steps == [4, 5]
    # a stale .tmp dir (simulated crash) is ignored and cleaned
    os.makedirs(tmp_path / "step_99.tmp", exist_ok=True)
    assert TC.latest_step(str(tmp_path)) == 5
    TC.save(str(tmp_path), 6, tree, keep=2)
    assert not (tmp_path / "step_99.tmp").exists()
    assert TC.latest_step(str(tmp_path / "none")) is None


def test_async_checkpointer(tmp_path):
    """The host copy is taken at save(): overwriting the tensor afterwards
    does not change the checkpoint."""
    w = torch.arange(4.0)
    with TC.AsyncCheckpointer(str(tmp_path)) as saver:
        saver.save(3, {"w": w})
        w.zero_()
    out = TC.restore(str(tmp_path), 3, {"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.arange(4.0))


def test_async_checkpointer_joins_on_error_and_surfaces_save_errors(tmp_path):
    with pytest.raises(ValueError, match="body"):
        with TC.AsyncCheckpointer(str(tmp_path)) as saver:
            saver.save(1, {"w": torch.ones(2)})
            raise ValueError("body")
    assert TC.latest_step(str(tmp_path)) == 1        # the save landed
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = TC.AsyncCheckpointer(str(blocker))
    saver.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        saver.wait()
