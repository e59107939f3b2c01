"""The port's serving layer against the JAX package's, on the CPU.

Every test of ``tests/test_serving.py`` has a counterpart here, at the
same small config (2 layers, d 64, 4 heads over 2 kv heads, head_dim 16,
d_ff 128, vocab 128), with parameters made with numpy from a seed and
handed to both packages.  On the CPU the port's captured step runs
eagerly.  Both packages serve the same prompts: token ids, dispositions
and ``fail_idx`` must be equal, logits within ``RTOL`` of the largest
(``test_torch_transformer.py``'s tolerance: fp32 sums in other orders).
Two RecurrentGemma cases (the reduced config: rglru, rglru, attn_local
with an 8-token window) serve ragged prompts past the window's wrap.
The decode-state tests pin the capture contract: ``pos`` is a device
tensor advanced in place, every state tensor keeps its storage, and a
serve call longer than its cache raises before the first step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jT
from repro.runtime import serving as jserving
from repro.testing import faults as jfaults
from repro.train.step import make_serve_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import transformer as tT
from repro_torch.runtime import serving
from repro_torch.testing import faults as tfaults

from _torch_parity import np_lm_params, rg_configs

RTOL = 1e-5
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=128)


class Model:
    """One model in both packages: the port's step and cache factory and
    the reference's step, params and cache factory."""

    def __init__(self, jc, tc, seed=0):
        params = np_lm_params(jc, seed=seed)
        self.jc, self.tc = jc, tc
        self.jp = jax.tree.map(jnp.asarray, params)
        self.jstep = make_serve_step(jc)
        self.tp = tT.params_from_numpy(params)

    def step(self, cache, tokens):
        return tT.decode_step(self.tc, self.tp, cache, {"tokens": tokens})

    def cache(self, b, s):
        return tT.init_cache(self.tc, b, s, device="cpu")

    def jcache(self, b, s):
        return jT.init_cache(self.jc, b, s)


@pytest.fixture(scope="module")
def lm():
    return Model(dataclasses.replace(
                     j_get_config("smollm-135m").reduced(), **SMALL),
                 dataclasses.replace(
                     t_get_config("smollm-135m").reduced(), **SMALL))


@pytest.fixture(scope="module")
def rg():
    return Model(*rg_configs(), seed=3)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def _ids(x):
    return np.asarray(x).astype(np.int64)


def _prompts(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _ragged(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve_both(m, mat, lens, **kw):
    """``serve_requests`` of the port and of the reference on the same
    padded prompts; the hooks and clocks are given per package."""
    jkw = {k[2:]: v for k, v in kw.items() if k.startswith("j_")}
    tkw = {k[2:]: v for k, v in kw.items() if k.startswith("t_")}
    kw = {k: v for k, v in kw.items() if k[:2] not in ("j_", "t_")}
    out = serving.serve_requests(m.step, m.cache, torch.as_tensor(mat),
                                 torch.as_tensor(lens), **kw, **tkw)
    jout = jserving.serve_requests(m.jstep, m.jp, m.jcache, jnp.asarray(mat),
                                   jnp.asarray(lens), **kw, **jkw)
    return out, jout


def _same_outcome(out, jout):
    np.testing.assert_array_equal(_ids(out[0]), _ids(jout[0]))
    r, jr = out.report, jout.report
    assert r.dispositions == jr.dispositions
    assert (r.aborted, r.unserved, r.deadline_miss, r.rounds,
            r.tokens_per_request, r.deadline_hit) == \
        (jr.aborted, jr.unserved, jr.deadline_miss, jr.rounds,
         jr.tokens_per_request, jr.deadline_hit)


def _solo(m, prompt, n):
    """Single-prompt serving of a 1-D prompt at batch 1 (the port)."""
    p = torch.as_tensor(prompt)[None, :]
    return serving.serve_loop(m.step, lambda: m.cache(1, p.shape[1] + n),
                              p, n, warm=False)[3][0]


# ---------------------------------------------------------------------------
# Counterparts of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_scan_loop_matches_pertoken(lm):
    """The captured loop's step ≡ the per-token loop, and both ≡ the
    reference's scan loop: same ids, same last-prompt-position logits."""
    B, P, N = 3, 10, 6
    prompt = _prompts(lm.tc.vocab_size, (B, P), 1)
    _, _, lg1, s1 = serving.serve_loop(
        lm.step, lambda: lm.cache(B, P + N), torch.from_numpy(prompt), N)
    _, _, lg2, s2 = serving.serve_loop_pertoken(
        lm.step, lambda: lm.cache(B, P + N), torch.from_numpy(prompt), N)
    *_, jlg, js = jserving.serve_loop(
        lm.jstep, lm.jp, lm.jcache(B, P + N), jnp.asarray(prompt), N,
        warm=False)
    assert s1.shape == (B, N)
    np.testing.assert_array_equal(_ids(s1), _ids(s2))
    np.testing.assert_array_equal(_ids(s1), _ids(js))
    _close(lg1, lg2)
    _close(lg1, jlg)


def test_single_token_generation(lm):
    """tokens=1 degenerates to prefill + argmax (no decode step)."""
    prompt = _prompts(lm.tc.vocab_size, (2, 5), 2)
    _, _, logits, seqs = serving.serve_loop(
        lm.step, lambda: lm.cache(2, 6), torch.from_numpy(prompt), 1)
    *_, jlogits, jseqs = jserving.serve_loop(
        lm.jstep, lm.jp, lm.jcache(2, 6), jnp.asarray(prompt), 1, warm=False)
    assert seqs.shape == (2, 1)
    np.testing.assert_array_equal(_ids(seqs[:, 0]),
                                  _ids(torch.argmax(logits, dim=-1)))
    np.testing.assert_array_equal(_ids(seqs), _ids(jseqs))
    _close(logits, jlogits)


def test_scheduler_exact_on_ragged_prompts(lm):
    """Every slot of the fused mixed-length pass reproduces
    single-prompt serving, and the reference's scheduler."""
    N = 6
    prompts = _ragged(lm.tc.vocab_size, (5, 9, 3, 7, 6), 0)
    mat, lens = serving.pad_prompts(prompts)
    assert mat.shape == (5, 9) and lens.tolist() == [5, 9, 3, 7, 6]
    out, jout = _serve_both(lm, mat, lens, tokens=N, slots=2)
    assert out[0].shape == (5, N)
    _same_outcome(out, jout)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(_ids(out[0][i]), _ids(_solo(lm, p, N)))


def test_scheduler_slot_count_invariance(lm):
    """Greedy generations must not depend on the slot partitioning."""
    prompt = _prompts(lm.tc.vocab_size, (4, 8), 3)
    lens = np.full((4,), 8, np.int32)
    outs = [serving.serve_requests(lm.step, lm.cache, prompt, lens,
                                   tokens=5, slots=k)[0] for k in (1, 3, 4)]
    np.testing.assert_array_equal(_ids(outs[0]), _ids(outs[1]))
    np.testing.assert_array_equal(_ids(outs[0]), _ids(outs[2]))
    jgen = jserving.serve_requests(lm.jstep, lm.jp, lm.jcache,
                                   jnp.asarray(prompt), jnp.asarray(lens),
                                   tokens=5, slots=3)[0]
    np.testing.assert_array_equal(_ids(outs[0]), _ids(jgen))


def test_prompt_glue():
    p = serving.random_prompts(0, 3, 7, 32, device="cpu")
    assert p.shape == (3, 7) and int(p.max()) < 32 and int(p.min()) >= 0
    assert serving.decode_tok_s(10, 4, 2.0) == 20.0
    assert serving.decode_tok_s(10, 4, 0.0) > 0          # no div-by-zero
    tok = serving.greedy_token(torch.tensor([[[0.0, 2.0, 1.0]]]))
    assert tok.shape == (1,) and int(tok[0]) == 1
    # ragged prompts are the reference's own ids
    mine = serving.ragged_prompts(0, 6, 4, 32, 128)
    theirs = jserving.ragged_prompts(0, 6, 4, 32, 128)
    assert [len(p) for p in mine] == [len(p) for p in theirs]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="min_len"):
        serving.ragged_prompts(0, 2, 5, 4, 128)


def test_zero_prompts_returns_empty(lm):
    out = serving.serve_requests(lm.step, lm.cache, [], tokens=4)
    gen, secs = out                                      # still unpacks
    assert gen.shape == (0, 4)
    assert secs >= 0.0
    assert out.report.ok and out.report.rounds == 0
    jout = jserving.serve_requests(lm.jstep, lm.jp, lm.jcache, [], tokens=4)
    assert dataclasses.asdict(out.report) == dataclasses.asdict(jout.report)


def test_prompt_longer_than_pad_window_rejected(lm):
    """A prompt that exceeds the pinned pad window raises up front."""
    prompts = _ragged(lm.tc.vocab_size, (3, 12), 4)
    with pytest.raises(ValueError, match="longest"):
        serving.pad_prompts(prompts, pad_to=8)
    mat, lens = serving.pad_prompts(prompts, pad_to=12)
    jmat, jlens = jserving.pad_prompts([jnp.asarray(p) for p in prompts],
                                       pad_to=12)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    out, jout = _serve_both(lm, mat, lens, tokens=4, slots=2)
    _same_outcome(out, jout)
    np.testing.assert_array_equal(_ids(out[0][1]),
                                  _ids(_solo(lm, prompts[1], 4)))


def test_all_slots_retired_early(lm):
    """Fewer requests than slots: the round pads with filler, retires
    every real request in one pass, and reports them all completed."""
    prompts = [torch.from_numpy(_prompts(lm.tc.vocab_size, (6,), 5))]
    out = serving.serve_requests(lm.step, lm.cache, prompts, tokens=5,
                                 slots=8)
    gen, _ = out
    assert gen.shape == (1, 5)
    assert out.report.completed == [0] and out.report.rounds == 1
    jgen = jserving.serve_requests(lm.jstep, lm.jp, lm.jcache,
                                   [jnp.asarray(prompts[0].numpy())],
                                   tokens=5, slots=8)[0]
    np.testing.assert_array_equal(_ids(gen), _ids(jgen))


def test_nan_slot_aborts_alone_others_token_identical(lm):
    """Poisoning one slot's logits mid-decode retires that slot (zeroed
    from the failure index) while every other request is token-identical
    to the fault-free run; the reference reports the same."""
    N = 6
    prompt = _prompts(lm.tc.vocab_size, (4, 5), 7)
    lens = np.full((4,), 5, np.int32)
    clean = serving.serve_requests(lm.step, lm.cache, prompt, lens,
                                   tokens=N, slots=4)[0]
    # step 6 = generation index 2 for length-5 prompts
    out, jout = _serve_both(lm, prompt, lens, tokens=N, slots=4,
                            t_logit_hook=tfaults.nan_logits_hook(1, 6),
                            j_logit_hook=jfaults.nan_logits_hook(1, 6))
    gen = out[0]
    assert out.report.aborted == {1: 2}
    assert sorted(out.report.completed) == [0, 2, 3]
    for r in (0, 2, 3):
        np.testing.assert_array_equal(_ids(gen[r]), _ids(clean[r]))
    np.testing.assert_array_equal(_ids(gen[1, :2]), _ids(clean[1, :2]))
    assert gen[1, 2:].tolist() == [0] * (N - 2)
    _same_outcome(out, jout)


def test_nan_during_prefill_aborts_whole_slot(lm):
    prompt = _prompts(lm.tc.vocab_size, (2, 5), 8)
    lens = np.full((2,), 5, np.int32)
    out, jout = _serve_both(lm, prompt, lens, tokens=4, slots=2,
                            t_logit_hook=tfaults.nan_logits_hook(0, 1),
                            j_logit_hook=jfaults.nan_logits_hook(0, 1))
    assert out.report.aborted == {0: 0}                  # clipped to 0
    assert out[0][0].tolist() == [0, 0, 0, 0]
    _same_outcome(out, jout)


def test_token_budget_caps_generation(lm):
    prompt = _prompts(lm.tc.vocab_size, (3, 6), 9)
    lens = np.full((3,), 6, np.int32)
    full = serving.serve_requests(lm.step, lm.cache, prompt, lens, tokens=6,
                                  slots=3)[0]
    out, jout = _serve_both(lm, prompt, lens, tokens=6, slots=3,
                            token_budget=3)
    gen, _ = out
    assert gen.shape == (3, 3)
    assert out.report.tokens_per_request == 3
    np.testing.assert_array_equal(_ids(gen), _ids(full[:, :3]))
    _same_outcome(out, jout)


def test_time_budget_drains_cleanly(lm):
    prompt = _prompts(lm.tc.vocab_size, (3, 5), 10)
    lens = np.full((3,), 5, np.int32)
    out = serving.serve_requests(lm.step, lm.cache, prompt, lens, tokens=4,
                                 slots=1, warm=False, time_budget_s=0.0)
    gen, _ = out
    assert gen.shape == (3, 4)                           # shape preserved
    assert out.report.deadline_hit
    assert out.report.unserved == [0, 1, 2]
    assert gen.tolist() == [[0] * 4] * 3
    ok, jok = _serve_both(lm, prompt, lens, tokens=4, slots=1,
                          time_budget_s=60.0)
    assert ok.report.ok and ok.report.rounds == 3
    _same_outcome(ok, jok)


def test_deadline_enforced_per_chunk(lm):
    """With a clock that ticks once a read, a 12-step round under
    ``deadline_chunk=4`` stops after the second segment: the in-flight
    request keeps its 5 tokens as a ``deadline_miss``, the queued one is
    unserved — in both packages."""
    mat, lens = serving.pad_prompts(_ragged(lm.tc.vocab_size, (4, 4), 12))
    full = serving.serve_requests(lm.step, lm.cache, mat, lens, tokens=9,
                                  slots=1)[0]
    # clock reads: t0=0; round-0 admission check t=1 (<=2.5); segment
    # checks t=2 (ok), t=3 (> 2.5 ⇒ stop after 8 of 12 steps)
    out, jout = _serve_both(lm, mat, lens, tokens=9, slots=1, warm=False,
                            time_budget_s=2.5, deadline_chunk=4,
                            t_clock=tfaults.TickClock(),
                            j_clock=jfaults.TickClock())
    gen = out[0].numpy()
    assert out.report.deadline_hit
    assert out.report.deadline_miss == {0: 5}    # 8 steps - (4-1) prompt
    assert out.report.unserved == [1]
    assert out.report.rounds == 1
    np.testing.assert_array_equal(gen[0, :5], _ids(full[0, :5]))
    assert gen[0, 5:].tolist() == [0] * 4
    assert gen[1].tolist() == [0] * 9
    _same_outcome(out, jout)


def test_chunked_deadline_path_matches_unchunked(lm):
    """Cutting a round into deadline segments changes no token when the
    budget is generous."""
    prompt = _prompts(lm.tc.vocab_size, (4, 8), 3)
    lens = np.full((4,), 8, np.int32)
    plain = serving.serve_requests(lm.step, lm.cache, prompt, lens, tokens=5,
                                   slots=2)
    chunked, jchunked = _serve_both(lm, prompt, lens, tokens=5, slots=2,
                                    time_budget_s=60.0, deadline_chunk=3)
    np.testing.assert_array_equal(_ids(plain[0]), _ids(chunked[0]))
    assert chunked.report.ok
    assert sorted(chunked.report.completed) == sorted(
        plain.report.completed)
    _same_outcome(chunked, jchunked)


def test_legacy_serve_output_shape_pinned(lm):
    """``(gen, seconds)`` unpacking and the reference's report fields."""
    prompt = _prompts(lm.tc.vocab_size, (2, 4), 2)
    lens = np.full((2,), 4, np.int32)
    out = serving.serve_requests(lm.step, lm.cache, prompt, lens, tokens=3,
                                 slots=2)
    assert isinstance(out, tuple) and len(out) == 2
    gen, seconds = out                                   # tuple unpacking
    assert gen.shape == (2, 3) and seconds >= 0.0
    rep = out.report
    assert rep.completed == [0, 1]
    assert rep.aborted == {} and rep.unserved == []
    assert rep.rounds == 1 and rep.tokens_per_request == 3
    assert rep.deadline_hit is False and rep.ok
    assert rep.shed == [] and rep.deadline_miss == {}
    assert rep.quarantined_slots == [] and rep.queue_peak == 0
    assert rep.engine == "fixed"
    assert rep.dispositions == {0: "completed", 1: "completed"}
    assert serving.DISPOSITIONS == jserving.DISPOSITIONS
    assert [f.name for f in dataclasses.fields(serving.ServeReport)] == \
        [f.name for f in dataclasses.fields(jserving.ServeReport)]
    lost = serving.WorkerLost("gone", lost=[3])
    assert isinstance(lost, RuntimeError) and lost.lost == [3]


# ---------------------------------------------------------------------------
# generate_fused, and RecurrentGemma past its window's wrap
# ---------------------------------------------------------------------------

def _fused_both(m, prompts, tokens, t_hook=None, j_hook=None):
    mat, lens = serving.pad_prompts(prompts)
    B, P = mat.shape
    gen, _, fail = serving.generate_fused(
        m.step, m.cache(B, P + tokens), mat, lens, tokens,
        logit_hook=t_hook, with_report=True)
    jgen, _, jfail = jserving.generate_fused(
        m.jstep, m.jp, m.jcache(B, P + tokens), jnp.asarray(mat.numpy()),
        jnp.asarray(lens.numpy()), tokens, logit_hook=j_hook,
        with_report=True)
    np.testing.assert_array_equal(_ids(gen), _ids(jgen))
    np.testing.assert_array_equal(_ids(fail), _ids(jfail))
    return gen, fail


def test_generate_fused_matches_reference_with_report(lm):
    """Ragged prompts in one pass, one slot poisoned after its prefill:
    the same tokens and ``fail_idx`` as the reference, the other slots
    equal to single-prompt serving."""
    prompts = _ragged(lm.tc.vocab_size, (4, 7, 2), 13)
    gen, fail = _fused_both(lm, prompts, 5, tfaults.nan_logits_hook(2, 3),
                            jfaults.nan_logits_hook(2, 3))
    assert fail.tolist() == [5, 5, 2]
    assert gen[2, 2:].tolist() == [0, 0, 0]
    for i in (0, 1):
        np.testing.assert_array_equal(_ids(gen[i]),
                                      _ids(_solo(lm, prompts[i], 5)))


def test_generate_fused_recurrentgemma_past_the_window(rg):
    """RG-LRU state and the 8-token local ring buffer: ragged prompts
    whose prefill and decode run past the window's wrap (14 steps)."""
    assert rg.tc.local_window == 8
    prompts = _ragged(rg.tc.vocab_size, (3, 9, 6), 14)
    gen, fail = _fused_both(rg, prompts, 6)
    assert fail.tolist() == [6, 6, 6]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(_ids(gen[i]), _ids(_solo(rg, p, 6)))


def test_serve_requests_recurrentgemma_short_final_round(rg):
    """Five ragged requests in slots of two: the third round re-admits
    request 0 as filler; the reference's tokens and dispositions."""
    prompts = _ragged(rg.tc.vocab_size, (5, 9, 3, 7, 6), 15)
    mat, lens = serving.pad_prompts(prompts)
    out, jout = _serve_both(rg, mat, lens, tokens=7, slots=2)
    assert out.report.rounds == 3 and out.report.completed == [0, 1, 2, 3, 4]
    _same_outcome(out, jout)
    np.testing.assert_array_equal(_ids(out[0][4]),
                                  _ids(_solo(rg, prompts[4], 7)))


# ---------------------------------------------------------------------------
# The decode-state contract a captured step relies on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["lm", "rg"])
def test_decode_state_keeps_its_storage(which, request):
    """``pos`` is a 0-d int32 tensor on the cache's device, advanced in
    place; every state tensor (KV cache, RG-LRU ``h`` and ``conv``) keeps
    its storage over three decode steps while its values change."""
    m = request.getfixturevalue(which)
    cache = m.cache(2, 5)
    tensors = [(i, k, t) for i, st in enumerate(cache) for k, t in st.items()
               if isinstance(t, torch.Tensor)]
    kinds = {k for _, k, _ in tensors}
    assert kinds == ({"k", "v", "pos", "h", "conv"} if which == "rg"
                     else {"k", "v", "pos"})
    ptrs = [t.data_ptr() for _, _, t in tensors]
    toks = torch.from_numpy(_prompts(m.tc.vocab_size, (2, 3), 16))
    for s in range(3):
        _, out = m.step(cache, toks[:, s:s + 1])
        assert out is cache
    assert [t.data_ptr() for _, _, t in tensors] == ptrs
    assert [cache[i][k] is t for i, k, t in tensors] == [True] * len(tensors)
    for st in cache:
        if "pos" in st:
            assert st["pos"].shape == () and st["pos"].dtype == torch.int32
            assert st["pos"].device == st["k"].device
            assert int(st["pos"]) == 3
    assert all(float(t.abs().sum()) > 0 for _, k, t in tensors
               if k in ("k", "h", "conv"))


def test_serving_past_the_cache_raises_before_the_first_step(lm):
    calls = []

    def step(cache, tokens):
        calls.append(1)
        return lm.step(cache, tokens)
    prompt = torch.from_numpy(_prompts(lm.tc.vocab_size, (2, 6), 17))
    for serve in (serving.serve_loop, serving.serve_loop_pertoken):
        with pytest.raises(ValueError, match="exceeds a KV cache of 9"):
            serve(step, lambda: lm.cache(2, 9), prompt, 4)
    with pytest.raises(ValueError, match="exceeds a KV cache of 9"):
        serving.generate_fused(step, lm.cache(2, 9), prompt,
                               torch.full((2,), 6), 4)
    assert calls == []
    # ten positions fit a cache of ten
    serving.serve_loop(step, lambda: lm.cache(2, 10), prompt, 4, warm=False)
    assert len(calls) == 9
