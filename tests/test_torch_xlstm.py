"""The port's xLSTM blocks against the JAX package's, on the CPU, and the
serving resets that a fresh xLSTM state needs.

The same numpy parameters and inputs go through ``repro.models.xlstm``
and ``repro_torch.models.xlstm``:

* ``mlstm_block`` with one chunk and with several (the state carried
  across chunks), ``mlstm_decode`` step by step (its state too), and
  ``slstm_block`` / ``slstm_decode``;
* xlstm-125m reduced to CI size (12 layers of d 32, sLSTM at 3 and 9):
  prefill logits against the JAX package's, and decode logits at every
  position against the JAX package's decode and the port's prefill.

The reset repair: a fresh xLSTM state has its stabilizer ``m`` at
``-1e30``, not 0, so the serving paths must copy a fresh state in place
rather than zero it.  ``serve_requests`` over three rounds and the
continuous engine admitting requests mid-stream must give every request
the tokens of an eager greedy decode of its prompt alone on a fresh cache
(``serve_loop_pertoken``, which never resets).  A tree whose resets zero
the state fails both.

Tolerance: max |Δ| ≤ 1e-5 · max |y|.  The chunkwise prefill and the
one-step decode sum the same recurrence in other orders (fp32
reassociation), in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jT
from repro.models import xlstm as jX
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as tT
from repro_torch.models import xlstm as tX
from repro_torch.runtime import serving as tserving

from _torch_parity import np_lm_params

RTOL = 1e-5
M0 = float(np.float32(-1e30))         # a fresh stabilizer, in fp32
JC = j_get_config("xlstm-125m").reduced()
TC = t_get_config("xlstm-125m").reduced()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def _block(kind, seed=0):
    """The first ``kind`` layer's temporal params (numpy)."""
    params = np_lm_params(JC, seed=seed)
    for g, gp in zip(jT.layer_groups(JC), params["groups"]):
        if g.kind == kind:
            return {k: np.asarray(v[0]) for k, v in gp["temporal"].items()}
    raise AssertionError(kind)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def test_reduced_config_keeps_the_pattern():
    kinds = TC.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [3, 9]
    assert len(kinds) == 12 and (TC.d_model, TC.num_heads) == (32, 2)
    assert dataclasses.asdict(TC) == dataclasses.asdict(JC)


@pytest.mark.parametrize("s,chunk", [(8, 64), (16, 4), (12, 3)])
def test_mlstm_block_matches(s, chunk):
    """One chunk (S ≤ 64) and several (the state carried over)."""
    tp, jp = _both(_block("mlstm", seed=s))
    x = _x((2, s, 32), s)
    _close(tX.mlstm_block(tp, torch.from_numpy(x), TC, chunk=chunk),
           jX.mlstm_block(jp, jnp.asarray(x), JC, chunk=chunk))


def test_mlstm_chunk_must_divide():
    tp, _ = _both(_block("mlstm"))
    with pytest.raises(AssertionError):
        tX.mlstm_block(tp, torch.zeros(1, 10, 32), TC, chunk=4)


def test_mlstm_decode_matches():
    tp, jp = _both(_block("mlstm", seed=3))
    x = _x((2, 9, 32), 3)
    y = tX.mlstm_block(tp, torch.from_numpy(x), TC)
    ts, js = tX.init_mlstm_state(TC, 2), jX.init_mlstm_state(JC, 2)
    assert float(ts["m"].max()) == M0
    step = jax.jit(lambda xt, st: jX.mlstm_decode(jp, xt, JC, st))
    ptrs = {k: v.data_ptr() for k, v in ts.items()}
    for t in range(9):
        yt, ts = tX.mlstm_decode(tp, torch.from_numpy(x[:, t:t + 1]), TC, ts)
        yj, js = step(jnp.asarray(x[:, t:t + 1]), js)
        _close(yt, yj)
        for k in ("C", "n", "m"):
            _close(ts[k], js[k])
        _close(yt[:, 0], y[:, t])          # decode follows prefill
    assert {k: v.data_ptr() for k, v in ts.items()} == ptrs   # in place


def test_slstm_block_and_decode_match():
    tp, jp = _both(_block("slstm", seed=4))
    x = _x((2, 7, 32), 4)
    y = tX.slstm_block(tp, torch.from_numpy(x), TC)
    _close(y, jX.slstm_block(jp, jnp.asarray(x), JC))
    ts, js = tX.init_slstm_state(TC, 2), jX.init_slstm_state(JC, 2)
    step = jax.jit(lambda xt, st: jX.slstm_decode(jp, xt, JC, st))
    for t in range(7):
        yt, ts = tX.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1]), TC, ts)
        yj, js = step(jnp.asarray(x[:, t:t + 1]), js)
        _close(yt, yj)
        for k in ("c", "n", "m"):
            _close(ts[k], js[k])
        _close(yt[:, 0], y[:, t])


@pytest.fixture(scope="module")
def model():
    params = np_lm_params(JC, seed=1)
    return (tT.params_from_numpy(params),
            jax.tree.map(jnp.asarray, params))


def test_model_forward_and_decode_match(model):
    tp, jp = model
    toks = np.random.default_rng(2).integers(0, JC.vocab_size, (2, 8))
    y = tT.forward(TC, tp, {"tokens": torch.from_numpy(toks)})
    _close(y, jT.forward(JC, jp, {"tokens": jnp.asarray(toks)}))
    tcache = tT.init_cache(TC, 2, 8, device="cpu")
    jcache = jT.init_cache(JC, 2, 8)
    jstep = jax.jit(lambda c, t: jT.decode_step(JC, jp, c, {"tokens": t}))
    for t in range(8):
        lt, tcache = tT.decode_step(TC, tp, tcache, {
            "tokens": torch.from_numpy(toks[:, t:t + 1])})
        lj, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]))
        _close(lt, lj)
        _close(lt[:, 0], y[:, t])          # decode follows prefill


# ---------------------------------------------------------------------------
# The reset repair
# ---------------------------------------------------------------------------

def _prompts():
    return tserving.ragged_prompts(3, 5, 2, 6, TC.vocab_size)


def _solo(step, make_cache, prompt, tokens):
    """Greedy tokens of ``prompt`` alone, eagerly, on a fresh cache."""
    p = prompt.long()[None, :]
    return tserving.serve_loop_pertoken(
        step, lambda: make_cache(1, p.shape[1] + tokens), p, tokens)[3][0]


def _step_and_cache(model):
    tp, _ = model

    def step(c, t):
        return tT.decode_step(TC, tp, c, {"tokens": t})

    def make_cache(b, s):
        return tT.init_cache(TC, b, s, device="cpu")
    return step, make_cache


def test_serve_requests_resets_to_a_fresh_state(model):
    """Three rounds of two slots: every round starts from the fresh state
    (``m`` at -1e30), so each request equals its prompt served alone."""
    step, make_cache = _step_and_cache(model)
    prompts = _prompts()
    mat, lens = tserving.pad_prompts(prompts)
    served = tserving.serve_requests(step, make_cache, mat, lens, tokens=6,
                                     slots=2)
    assert served.report.rounds == 3 and served.report.ok
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(served[0][i].numpy(),
                                      _solo(step, make_cache, p, 6).numpy())


def test_continuous_engine_resets_an_admitted_slot(model):
    """Two slots, five requests: three are admitted mid-stream into a
    slot another request used, whose rows are reset to the fresh state."""
    step, make_cache = _step_and_cache(model)
    prompts = _prompts()
    out = tserving.serve_continuous(step, make_cache, prompts, tokens=6,
                                    slots=2, chunk=4)
    assert out.report.ok and out.report.admitted == 5
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(out[0][i].numpy(),
                                      _solo(step, make_cache, p, 6).numpy())


def test_restore_copies_a_fresh_state_in_place():
    cache = tT.init_cache(TC, 3, 4, device="cpu")
    fresh = tserving.fresh_rows(cache)
    ptrs = [t.data_ptr() for t in tserving._tensors(cache)]
    for t in tserving._tensors(cache):
        t.fill_(7.0)
    tserving.restore(cache, fresh, row=1)
    m = cache[0]["m"]
    assert float(m[1].max()) == M0 and float(m[0].min()) == 7.0
    tserving.restore(cache, fresh)
    for t, f in zip(tserving._tensors(cache),
                    tserving._tensors(tT.init_cache(TC, 3, 4, device="cpu"))):
        assert torch.equal(t, f)
    assert [t.data_ptr() for t in tserving._tensors(cache)] == ptrs
