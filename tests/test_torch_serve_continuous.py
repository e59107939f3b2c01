"""The port's continuous-batching engine against the JAX package's, on
the CPU.

Every test of ``tests/test_serve_continuous.py`` has a counterpart here,
at its small config (2 layers, d 64, 4 heads over 2 kv heads, head_dim 16,
d_ff 128, vocab 128), with parameters made with numpy from a seed and
handed to both packages.  Both engines serve the same prompts, arrivals
and :class:`TickClock`, each under its own package's fault plan: token
ids, dispositions, ``aborted`` indices, ``shed``, ``deadline_miss``,
``unserved``, ``queue_peak``, ``admitted``, ``quarantined_slots``,
latencies and the failover fields must be equal; logits within ``RTOL``
of the largest (fp32 sums in other orders).  On the CPU the port's
captured chunk step runs eagerly.

The port's slots are the batch axis of one step (the reference ``vmap``s
a batch-1 step), so the per-row decode tests hold ``attention_decode``
with a position per row, and the whole step at per-slot positions with
slot resets, against the reference's ``vmap`` row by row; a plain cache
clamps a row past its end as the reference does.  A RecurrentGemma case
(rglru, rglru, attn_local with an 8-token window) wraps the window at
different positions per slot, and the capture contract (every state
tensor keeps its storage across steps, resets and chunks) is pinned.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.runtime import serving as jserving
from repro.testing import faults as jfaults
from repro.train.step import make_serve_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.runtime import serving
from repro_torch.testing import faults as tfaults

from _torch_parity import np_lm_params, rg_configs

RTOL = 1e-5
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=128)
ARRIVALS = [0.0, 0.5, 1.0, 2.5, 4.0]


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


def _ragged(vocab, lens=(5, 9, 3, 7, 6), seed=0):
    """The reference test's ragged requests: ``(prompts, mat, lens)``."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]
    mat, ln = serving.pad_prompts(prompts)
    return prompts, mat.numpy(), ln.numpy()


def _uniform(vocab, n, length, seed):
    """``n`` prompts of ``length`` ids: ``(mat, lens)``."""
    mat = np.random.default_rng(seed).integers(0, vocab, (n, length))
    return mat.astype(np.int32), np.full((n,), length, np.int32)


def _both(m, mat, lens, fn="serve_continuous", faults=(), **kw):
    """``fn`` of the port and of the reference on the same prompts, each
    on a fresh :class:`TickClock` (unless ``kw`` pins one) and under the
    ``faults`` rules in its own package's plan."""
    tkw = {k[2:]: v for k, v in kw.items() if k.startswith("t_")}
    jkw = {k[2:]: v for k, v in kw.items() if k.startswith("j_")}
    kw = {k: v for k, v in kw.items() if k[:2] not in ("t_", "j_")}
    tkw.setdefault("clock", tfaults.TickClock())
    jkw.setdefault("clock", jfaults.TickClock())
    with tfaults.inject(*faults):
        out = getattr(serving, fn)(m.step, m.cache, torch.as_tensor(mat),
                                   torch.as_tensor(lens), **kw, **tkw)
    jfaults_rules = [jfaults.Fault(**dataclasses.asdict(f)) for f in faults]
    with jfaults.inject(*jfaults_rules):
        jout = getattr(jserving, fn)(m.jstep, m.jp, m.jcache,
                                     jnp.asarray(mat), jnp.asarray(lens),
                                     **kw, **jkw)
    return out, jout


REPORT_FIELDS = ("completed", "aborted", "unserved", "tokens_per_request",
                 "deadline_hit", "shed", "deadline_miss", "latency_s",
                 "queue_peak", "admitted", "quarantined_slots", "engine",
                 "failovers", "lost_workers", "replayed")


def _same_outcome(out, jout):
    np.testing.assert_array_equal(_ids(out[0]), _ids(jout[0]))
    r, jr = out.report, jout.report
    assert r.dispositions == jr.dispositions
    assert {f: getattr(r, f) for f in REPORT_FIELDS} == \
        {f: getattr(jr, f) for f in REPORT_FIELDS}
    if r.engine == "continuous":          # virtual time on both sides
        assert r.sustained_tok_s == jr.sustained_tok_s


def _solo(m, prompt, n):
    """Single-prompt serving of a 1-D prompt at batch 1 (the port)."""
    p = torch.as_tensor(np.asarray(prompt)).long()[None, :]
    return serving.serve_loop(m.step, lambda: m.cache(1, p.shape[1] + n),
                              p, n, warm=False)[3][0]


def _fault(point, action, **kw):
    return tfaults.Fault(point, action, **kw)


def _ref_layers(m, jstate):
    """The reference's stacked transformer state (leaves ``(slots,
    count, ...)`` per layer group) as the port's per-layer list, each
    leaf ``(slots, ...)``: row ``b`` of layer ``i`` of a group is the
    reference's ``[b, i]``."""
    out = []
    for g, jst in zip(jT.layer_groups(m.jc), jstate):
        for i in range(g.count):
            out.append({k: np.asarray(t)[:, i] for k, t in jst.items()})
    return out


def _same_rows(state, ref_layers):
    for st, jst in zip(state, ref_layers, strict=True):
        assert st.keys() - {"ring"} == jst.keys()
        for k, t in jst.items():
            if k == "pos":
                assert st[k].tolist() == t.tolist()
            else:
                _close(st[k], t.reshape(st[k].shape))


# ---------------------------------------------------------------------------
# Exactness under churn
# ---------------------------------------------------------------------------

def test_exact_vs_single_prompt_under_arrival_trace(lm):
    """5 ragged requests through 2 slots, chunk 3, admitted mid-stream as
    slots vacate: token for token the reference's engine and serving
    each prompt alone."""
    N = 6
    prompts, mat, lens = _ragged(lm.tc.vocab_size)
    out, jout = _both(lm, mat, lens, tokens=N, slots=2, chunk=3,
                      arrivals=ARRIVALS)
    gen = out[0]
    assert gen.shape == (5, N)
    assert out.report.engine == "continuous"
    assert out.report.ok and sorted(out.report.completed) == list(range(5))
    assert out.report.admitted == 5
    _same_outcome(out, jout)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(_ids(gen[i]), _ids(_solo(lm, p, N)))
    assert sorted(out.report.latency_s) == list(range(5))
    assert out.report.sustained_tok_s > 0


def test_matches_fixed_scheduler_and_slot_count_invariant(lm):
    N = 6
    _, mat, lens = _ragged(lm.tc.vocab_size)
    fixed, _ = serving.serve_requests(lm.step, lm.cache, mat, lens,
                                      tokens=N, slots=2)
    outs = [serving.serve_continuous(
        lm.step, lm.cache, mat, lens, tokens=N, slots=k, chunk=3,
        arrivals=ARRIVALS, clock=tfaults.TickClock())[0] for k in (2, 4)]
    np.testing.assert_array_equal(_ids(outs[0]), _ids(fixed))
    np.testing.assert_array_equal(_ids(outs[0]), _ids(outs[1]))
    jgen = jserving.serve_continuous(
        lm.jstep, lm.jp, lm.jcache, jnp.asarray(mat), jnp.asarray(lens),
        tokens=N, slots=4, chunk=3, arrivals=ARRIVALS,
        clock=jfaults.TickClock())[0]
    np.testing.assert_array_equal(_ids(outs[1]), _ids(jgen))


def test_token_budget_prefix_stable(lm):
    _, mat, lens = _ragged(lm.tc.vocab_size)
    full = serving.serve_continuous(lm.step, lm.cache, mat, lens, tokens=6,
                                    slots=2, chunk=3,
                                    clock=tfaults.TickClock())
    capped, jcapped = _both(lm, mat, lens, tokens=6, token_budget=3,
                            slots=2, chunk=3)
    gen = capped[0]
    assert gen.shape == (5, 3)
    assert capped.report.tokens_per_request == 3
    np.testing.assert_array_equal(_ids(gen), _ids(full[0])[:, :3])
    _same_outcome(capped, jcapped)


def test_eos_retires_slot_early(lm):
    N = 6
    _, mat, lens = _ragged(lm.tc.vocab_size)
    clean = _ids(serving.serve_continuous(
        lm.step, lm.cache, mat, lens, tokens=N, slots=2, chunk=3,
        clock=tfaults.TickClock())[0])
    eos = int(clean[0, 2])                  # retire request 0 mid-decode
    out, jout = _both(lm, mat, lens, tokens=N, slots=2, chunk=3,
                      eos_id=eos)
    gen = _ids(out[0])
    assert sorted(out.report.completed) == list(range(5))
    row = clean[0].tolist()
    cut = row.index(eos) + 1
    assert gen[0].tolist() == row[:cut] + [0] * (N - cut)
    for r in range(1, 5):                   # rows without eos: untouched
        if eos not in clean[r].tolist():
            np.testing.assert_array_equal(gen[r], clean[r])
    _same_outcome(out, jout)


# ---------------------------------------------------------------------------
# Failure isolation
# ---------------------------------------------------------------------------

def test_injected_nan_isolated_to_one_stream(lm):
    N = 6
    mat, lens = _uniform(lm.tc.vocab_size, 4, 5, 7)
    kw = dict(tokens=N, slots=2, chunk=3, arrivals=[0.0, 0.5, 1.0, 1.5])
    clean = serving.serve_continuous(lm.step, lm.cache, mat, lens,
                                     clock=tfaults.TickClock(), **kw)
    out, jout = _both(lm, mat, lens,
                      faults=[_fault("serve.nan", "nan", rid=1, at=2)], **kw)
    gen, cg = _ids(out[0]), _ids(clean[0])
    assert out.report.aborted == {1: 2}
    assert not out.report.ok
    assert out.report.dispositions[1] == "aborted"
    assert sorted(out.report.completed) == [0, 2, 3]
    for r in (0, 2, 3):
        np.testing.assert_array_equal(gen[r], cg[r])
    np.testing.assert_array_equal(gen[1, :2], cg[1, :2])
    assert gen[1, 2:].tolist() == [0] * (N - 2)
    _same_outcome(out, jout)


def test_nan_during_prefill_aborts_at_zero(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 2, 5, 8)
    # generation index -2 ⇒ global step L-3: mid-prefill
    out, jout = _both(lm, mat, lens, tokens=4, slots=2, chunk=3,
                      faults=[_fault("serve.nan", "nan", rid=0, at=-2)])
    assert out.report.aborted == {0: 0}
    assert out[0][0].tolist() == [0, 0, 0, 0]
    _same_outcome(out, jout)


def test_circuit_breaker_quarantines_slot(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 3, 5, 7)
    out, jout = _both(lm, mat, lens, tokens=6, slots=1, chunk=3,
                      slot_nan_limit=2,
                      faults=[_fault("serve.nan", "nan", rid=0, at=1),
                              _fault("serve.nan", "nan", rid=1, at=1)])
    assert out.report.dispositions == {0: "aborted", 1: "aborted",
                                       2: "unserved"}
    assert out.report.quarantined_slots == [0]
    assert not out.report.ok
    _same_outcome(out, jout)


# ---------------------------------------------------------------------------
# Overload safety: shedding, deadlines, queue bound, drain
# ---------------------------------------------------------------------------

def test_deadline_aware_shedding(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 2, 5, 10)
    kw = dict(tokens=5, slots=1, chunk=4, arrivals=[0.0, 3.0])
    # rate = 4 steps/tick; request 1 needs 9 steps ⇒ eta 3 + 2.25 > 3 + 2
    shed, jshed = _both(lm, mat, lens, deadlines=[None, 2.0], **kw)
    assert shed.report.dispositions == {0: "completed", 1: "shed"}
    assert shed[0][1].tolist() == [0] * 5                  # zeroed row
    _same_outcome(shed, jshed)
    ok, jok = _both(lm, mat, lens, deadlines=[None, 50.0], **kw)
    assert ok.report.dispositions == {0: "completed", 1: "completed"}
    _same_outcome(ok, jok)


def test_deadline_miss_mid_serve_keeps_partial_tokens(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 1, 5, 11)
    kw = dict(tokens=6, slots=1, chunk=2)
    full = _ids(serving.serve_continuous(lm.step, lm.cache, mat, lens,
                                         clock=tfaults.TickClock(),
                                         **kw)[0])
    out, jout = _both(lm, mat, lens, deadlines=[3.0], **kw)
    assert out.report.deadline_miss == {0: 4}
    assert out.report.dispositions[0] == "deadline_miss"
    gen = _ids(out[0])
    np.testing.assert_array_equal(gen[0, :4], full[0, :4])
    assert gen[0, 4:].tolist() == [0, 0]
    _same_outcome(out, jout)


def test_bounded_queue_sheds_overflow(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 4, 5, 7)
    out, jout = _both(lm, mat, lens, tokens=6, slots=1, chunk=2,
                      max_queue=1)
    d = out.report.dispositions
    assert d[0] == "completed"
    assert [d[r] for r in (1, 2, 3)] == ["shed"] * 3
    assert out.report.queue_peak == 1
    _same_outcome(out, jout)


def test_time_budget_drains_cleanly(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 3, 5, 10)
    out, jout = _both(lm, mat, lens, tokens=4, slots=2, warm=False,
                      time_budget_s=0.0)
    gen, _ = out
    assert gen.shape == (3, 4)
    assert out.report.deadline_hit
    assert out.report.unserved == [0, 1, 2]
    assert gen.tolist() == [[0] * 4] * 3
    _same_outcome(out, jout)


def _drain(engine, mat, lens, N):
    """Submit five requests, admit two, drain (the reference test's
    protocol, on either package's engine)."""
    for r in range(5):
        engine.submit(mat[r, :lens[r]], tokens=N, rid=r)
    engine._pending.sort(key=lambda q: (q.arrival, q.rid))
    now = engine._now = engine._clock()
    engine._ingest(now)
    engine._admit(now)                       # requests 0 and 1 in flight
    return engine.drain()


def test_engine_drain_finishes_in_flight_only(lm):
    N = 6
    prompts, mat, lens = _ragged(lm.tc.vocab_size)
    eng = serving.ContinuousEngine(
        lm.step, lm.cache, slots=2, max_seq=int(mat.shape[1]) + N, chunk=3,
        clock=tfaults.TickClock())
    report = _drain(eng, mat, lens, N)
    assert sorted(report.completed) == [0, 1]
    assert sorted(report.unserved) == [2, 3, 4]
    for i in (0, 1):
        assert eng.requests[i].tokens == _solo(lm, prompts[i], N).tolist()
    jeng = jserving.ContinuousEngine(
        lm.jstep, lm.jp, lm.jcache, slots=2, max_seq=int(mat.shape[1]) + N,
        chunk=3, clock=jfaults.TickClock())
    jreport = _drain(jeng, mat, lens, N)
    assert report.dispositions == jreport.dispositions
    assert {r: q.tokens for r, q in eng.requests.items()} == \
        {r: q.tokens for r, q in jeng.requests.items()}


# ---------------------------------------------------------------------------
# API edges
# ---------------------------------------------------------------------------

def test_submit_validation(lm):
    eng = serving.ContinuousEngine(lm.step, lm.cache, slots=1, max_seq=8,
                                   warm=False)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(5), tokens=4)   # 5 + 4 > 8
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,)), tokens=2)
    with pytest.raises(ValueError, match="tokens"):
        eng.submit(np.arange(3), tokens=0)
    eng.submit(np.arange(3), tokens=2, rid=7)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(np.arange(3), tokens=2, rid=7)
    assert eng.submit(torch.arange(2), tokens=2) == 8   # next free rid
    with pytest.raises(ValueError, match="slot"):
        serving.ContinuousEngine(lm.step, lm.cache, slots=0, max_seq=8,
                                 warm=False)
    with pytest.raises(ValueError, match="chunk"):
        serving.ContinuousEngine(lm.step, lm.cache, slots=1, max_seq=8,
                                 chunk=0, warm=False)


def test_zero_requests(lm):
    out = serving.serve_continuous(lm.step, lm.cache, [], tokens=4)
    gen, secs = out
    assert gen.shape == (0, 4) and secs >= 0.0
    assert out.report.ok and out.report.engine == "continuous"
    jout = jserving.serve_continuous(lm.jstep, lm.jp, lm.jcache, [],
                                     tokens=4)
    assert dataclasses.asdict(out.report) == dataclasses.asdict(jout.report)


@pytest.mark.parametrize("which", ["lm", "rg"])
def test_stack_cache_per_slot_positions(which, request):
    """Every tensor gains the slot rows on its batch axis; ``pos`` becomes
    ``(slots,)``; the ring flag stays a Python value.  Stacked after
    three batch-1 steps, row ``b`` equals the reference's ``[b, 0]``."""
    m = request.getfixturevalue(which)
    cache, jcache = m.cache(1, 12), m.jcache(1, 12)
    toks = np.random.default_rng(6).integers(0, m.tc.vocab_size, (1, 3))
    for s in range(3):
        m.step(cache, torch.from_numpy(toks[:, s:s + 1]))
        _, jcache = m.jstep(m.jp, jcache, {"tokens": jnp.asarray(
            toks[:, s:s + 1])})
    stacked = serving.stack_cache(cache, 3)
    for base, slot in zip(cache, stacked):
        assert base.keys() == slot.keys()
        for k, t in base.items():
            if not isinstance(t, torch.Tensor):
                assert slot[k] == t
            elif t.ndim == 0:
                assert slot[k].shape == (3,) and slot[k].dtype == t.dtype
            else:
                assert slot[k].shape == (3,) + t.shape[1:]
            if isinstance(t, torch.Tensor):
                assert slot[k].data_ptr() != t.data_ptr()
    _same_rows(stacked, _ref_layers(m, jserving.stack_cache(jcache, 3)))


def test_dispositions_cover_every_request():
    assert serving.DISPOSITIONS == jserving.DISPOSITIONS
    rep = serving.ServeReport(completed=[0], aborted={1: 2}, shed=[3],
                              deadline_miss={4: 1}, unserved=[5])
    assert rep.dispositions == {0: "completed", 1: "aborted", 3: "shed",
                                4: "deadline_miss", 5: "unserved"}
    assert not rep.ok
    assert serving.ServeReport(completed=[0]).ok


# ---------------------------------------------------------------------------
# Failover: worker loss, replay, zero lost requests
# ---------------------------------------------------------------------------

def test_worker_loss_failover_replays_bit_identical(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 5, 5, 0)
    kw = dict(tokens=6, slots=2, chunk=3)
    clean = serving.serve_continuous(lm.step, lm.cache, mat, lens,
                                     clock=tfaults.TickClock(), **kw)
    out, jout = _both(lm, mat, lens, fn="serve_with_failover",
                      faults=[_fault("serve.worker", "raise", nth=3)], **kw)
    rep = out.report
    assert rep.engine == "continuous+failover"
    assert rep.failovers == 1 and len(rep.lost_workers) == 1
    assert rep.replayed
    assert sorted(rep.dispositions) == list(range(5))
    assert sorted(rep.completed) == list(range(5))
    np.testing.assert_array_equal(_ids(out[0]), _ids(clean[0]))
    _same_outcome(out, jout)


def test_worker_loss_uncaught_leaves_no_disposition(lm):
    eng = serving.ContinuousEngine(
        lm.step, lm.cache, slots=1, max_seq=16, chunk=3,
        clock=tfaults.TickClock(), health_check=lambda: [2])
    eng.submit(np.arange(1, 6), tokens=4, rid=0)
    with pytest.raises(serving.WorkerLost) as ei:
        eng.run()
    assert ei.value.lost == [2]
    assert eng.requests[0].disposition is None
    jeng = jserving.ContinuousEngine(
        lm.jstep, lm.jp, lm.jcache, slots=1, max_seq=16, chunk=3,
        clock=jfaults.TickClock(), health_check=lambda: [2])
    jeng.submit(np.arange(1, 6), tokens=4, rid=0)
    with pytest.raises(jserving.WorkerLost) as jei:
        jeng.run()
    assert jei.value.lost == ei.value.lost


def test_failover_exhaustion_reports_unserved(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 3, 5, 1)
    out, jout = _both(lm, mat, lens, fn="serve_with_failover", tokens=6,
                      slots=2, chunk=3, max_failovers=1,
                      faults=[_fault("serve.worker", "raise", nth=1,
                                     times=99)])
    rep = out.report
    assert rep.failovers == 2                # initial + one re-formation
    assert sorted(rep.dispositions) == [0, 1, 2]
    assert sorted(rep.unserved) == [0, 1, 2]
    assert out[0].tolist() == [[0] * 6] * 3
    _same_outcome(out, jout)


def _flaky_health():
    calls = {"n": 0}

    def health():
        calls["n"] += 1
        return [1] if calls["n"] == 2 else []
    return health


def _survivor_factory(seen):
    def factory(attempt):
        kws = {"slots": max(1, 2 >> attempt)}
        seen.append(kws["slots"])
        if attempt > 0:
            kws["health_check"] = lambda: []     # survivors are healthy
        return kws
    return factory


def test_health_check_failover_and_survivor_slots(lm):
    mat, lens = _uniform(lm.tc.vocab_size, 4, 5, 2)
    kw = dict(tokens=6, slots=2, chunk=3)
    clean = serving.serve_continuous(lm.step, lm.cache, mat, lens,
                                     clock=tfaults.TickClock(), **kw)
    seen, jseen = [], []
    out, jout = _both(lm, mat, lens, fn="serve_with_failover",
                      t_health_check=_flaky_health(),
                      j_health_check=_flaky_health(),
                      t_engine_factory=_survivor_factory(seen),
                      j_engine_factory=_survivor_factory(jseen), **kw)
    rep = out.report
    assert rep.failovers == 1 and rep.lost_workers == [1]
    assert seen == jseen == [2, 1]
    assert sorted(rep.completed) == list(range(4))
    np.testing.assert_array_equal(_ids(out[0]), _ids(clean[0]))
    _same_outcome(out, jout)


def test_failover_clean_run_untouched(lm):
    _, mat, lens = _ragged(lm.tc.vocab_size)
    clean = serving.serve_continuous(lm.step, lm.cache, mat, lens, tokens=6,
                                     slots=2, chunk=3, arrivals=ARRIVALS,
                                     clock=tfaults.TickClock())
    out, jout = _both(lm, mat, lens, fn="serve_with_failover", tokens=6,
                      slots=2, chunk=3, arrivals=ARRIVALS)
    rep = out.report
    assert rep.failovers == 0 and not rep.replayed and not rep.lost_workers
    assert rep.ok and sorted(rep.completed) == list(range(5))
    np.testing.assert_array_equal(_ids(out[0]), _ids(clean[0]))
    _same_outcome(out, jout)


# ---------------------------------------------------------------------------
# A compressed artifact behind the engine
# ---------------------------------------------------------------------------

def test_graph_executor_continuous_engine(tmp_path):
    """The reference compresses a 4-layer reduced SmolLM-135M and writes
    the artifact; the port loads it and serves it through its engine
    (``CompressedArtifact.decode`` / ``init_cache``): the reference
    ``GraphExecutor.continuous_engine``'s tokens and the artifact's own
    single-prompt serving.  ``slot_state`` widens every per-unit state,
    ``{}`` units included, and its rows are the reference's."""
    from repro import runtime as jrt
    from repro.configs import get_config as j_get_config
    from repro.core import compress
    from repro.models.transformer_host import CostEnv, TransformerHost
    from repro_torch import runtime as trt

    cfg = dataclasses.replace(j_get_config("smollm-135m").reduced(),
                              num_layers=4)
    params = jax.tree.map(jnp.asarray, np_lm_params(cfg, seed=4))
    host = TransformerHost(cfg, params, env=CostEnv(batch=2, seq=16))
    res = compress(host, budget_ratio=0.6, P=200)
    graph = host.lower_plan(res.plan)
    path = str(tmp_path / "lm.npz")
    jrt.save(path, graph, plan=res.plan)
    art = trt.load(path, device="cpu")
    N, P = 5, 6
    base = art.init_cache(1, P + N)
    state = trt.slot_state(art.graph, 2, P + N)
    jstate = jrt.slot_state(graph, 2, P + N)
    assert len(state) == len(jstate) == len(art.graph.units)
    assert any(st == {} for st in state)
    for b0, st in zip(base, state):
        for k, t in st.items():
            if isinstance(t, torch.Tensor):
                want = (2,) + tuple(b0[k].shape[1:]) if b0[k].ndim else (2,)
                assert tuple(t.shape) == want
    _same_rows(state, [{k: np.asarray(t) for k, t in jst.items()}
                       for jst in jstate])

    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, P))

    def step(cache, tokens):
        return art.decode(cache, tokens)
    eng = serving.ContinuousEngine(step, art.init_cache, slots=2,
                                   max_seq=P + N, chunk=3,
                                   clock=tfaults.TickClock())
    jeng = jrt.GraphExecutor(graph).continuous_engine(
        slots=2, max_seq=P + N, chunk=3, clock=jfaults.TickClock())
    for e in (eng, jeng):
        for r in range(3):
            e.submit(prompts[r], tokens=N, arrival=0.5 * r, rid=r)
    report, jreport = eng.run(), jeng.run()
    assert sorted(report.completed) == [0, 1, 2]
    assert report.dispositions == jreport.dispositions
    for r in range(3):
        assert eng.requests[r].tokens == jeng.requests[r].tokens
        solo = serving.serve_loop(step, lambda: art.init_cache(1, P + N),
                                  torch.as_tensor(prompts[r])[None], N,
                                  warm=False)[3][0]
        assert eng.requests[r].tokens == solo.tolist()


# ---------------------------------------------------------------------------
# RecurrentGemma: slots wrapping the local window at different positions
# ---------------------------------------------------------------------------

def test_recurrentgemma_slots_wrap_the_window_apart(rg):
    """RG-LRU state and the 8-token local ring buffer under churn: ragged
    requests of 14-19 positions admitted at staggered arrivals into 2
    slots, so each slot wraps its window at its own step; the reference's
    tokens and report, and each prompt served alone."""
    assert rg.tc.local_window == 8
    N = 8
    prompts, mat, lens = _ragged(rg.tc.vocab_size, (6, 11, 9, 7), seed=21)
    out, jout = _both(rg, mat, lens, tokens=N, slots=2, chunk=3,
                      arrivals=[0.0, 1.5, 2.0, 3.5])
    assert out.report.ok and out.report.admitted == 4
    _same_outcome(out, jout)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(_ids(out[0][i]),
                                      _ids(_solo(rg, p, N)))


# ---------------------------------------------------------------------------
# Per-row decode: the batch is the slot axis
# ---------------------------------------------------------------------------

def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    shapes = {"wq": (d, h, hd), "wk": (d, kvh, hd), "wv": (d, kvh, hd),
              "wo": (h, hd, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0] if k != "wo"
                                                  else h * hd)
                ).astype(np.float32) for k, s in shapes.items()}


def _attn_rows(m, size, pos, window, seed):
    """``attention_decode`` of the port at a ``(B,)`` position against
    the reference's ``vmap`` of its batch-1 call, on the same random
    cache: ``(port y, k, v, pos; reference y, k, v, pos; old k)``."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    cfg = m.tc
    p = _attn_params(cfg, seed)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, size, cfg.num_kv_heads, cfg.head_dim)
                              ).astype(np.float32) for _ in range(2)]
    cache = {"k": torch.from_numpy(kv[0].copy()),
             "v": torch.from_numpy(kv[1].copy()),
             "pos": torch.tensor(pos, dtype=torch.int32)}
    y, out = tL.attention_decode({k: torch.from_numpy(v) for k, v in
                                  p.items()}, torch.from_numpy(x), cfg,
                                 cache, window=window)
    assert out is cache
    jp = jax.tree.map(jnp.asarray, p)

    def one(k, v, ps, xx):
        return jL.attention_decode(jp, xx[None], m.jc,
                                   {"k": k[None], "v": v[None], "pos": ps},
                                   window=window)
    jy, jc = jax.vmap(one)(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                           jnp.asarray(pos, jnp.int32), jnp.asarray(x))
    return (y, cache, jy[:, 0], {k: np.asarray(t) for k, t in jc.items()},
            kv)


@pytest.mark.parametrize("size,pos,window", [
    (8, [0, 3, 7, 5], 0),                 # plain cache, rows apart
    (4, [0, 2, 5, 11], 4),                # ring buffer, wrapped apart
    (6, [1, 4, 6, 9], 8),                 # windowed cache shorter than it
])
def test_attention_decode_position_per_row(lm, size, pos, window):
    y, cache, jy, jc, _ = _attn_rows(lm, size, pos, window, seed=size)
    _close(y, jy)
    _close(cache["k"], jc["k"][:, 0])
    _close(cache["v"], jc["v"][:, 0])
    assert cache["pos"].tolist() == jc["pos"].tolist() == \
        [q + 1 for q in pos]


def test_plain_cache_clamps_a_row_past_the_end(lm):
    """Rows at or past the end of a plain 6-entry cache write only its
    last entry (the reference's ``dynamic_update_slice`` clamp); the
    other entries of every row, and the row in range, are untouched."""
    pos = [2, 6, 9, 40]
    y, cache, jy, jc, (k0, _) = _attn_rows(lm, 6, pos, 0, seed=5)
    _close(y, jy)
    _close(cache["k"], jc["k"][:, 0])
    k = cache["k"].numpy()
    for b, q in enumerate(pos):
        written = min(q, 5)
        keep = [i for i in range(6) if i != written]
        np.testing.assert_array_equal(k[b, keep], k0[b, keep])
        assert not np.array_equal(k[b, written], k0[b, written])
    assert cache["pos"].tolist() == [3, 7, 10, 41]


@pytest.mark.parametrize("which", ["lm", "rg"])
def test_step_at_slot_positions_matches_vmapped_reference(which, request):
    """The whole decode step at batch ``slots`` over :func:`stack_cache`
    state against the reference's ``vmap`` of its batch-1 step over its
    stacked state: 12 steps with slot 1 reset after step 3 and slot 2
    after step 7 (the engine's admissions), so the slots sit at three
    positions; logits within ``RTOL`` and the state row by row."""
    m = request.getfixturevalue(which)
    B, S = 3, 10
    state = serving.stack_cache(m.cache(1, S), B)
    jstate = jserving.stack_cache(m.jcache(1, S), B)
    jfresh = m.jcache(1, S)
    toks = np.random.default_rng(9).integers(0, m.tc.vocab_size, (12, B))
    vstep = jax.jit(jax.vmap(lambda c, t: m.jstep(
        m.jp, c, {"tokens": t[None, None]})))
    for s in range(12):
        for b, at in ((1, 4), (2, 8)):
            if s == at:
                for t in serving._tensors(state):
                    t[b].zero_()
                jstate = jax.tree.map(lambda f, x, b=b: f.at[b].set(x),
                                      jstate, jfresh)
        lg, _ = m.step(state, torch.from_numpy(toks[s])[:, None])
        jlg, jstate = vstep(jstate, jnp.asarray(toks[s], jnp.int32))
        _close(lg, np.asarray(jlg)[:, 0])
    _same_rows(state, _ref_layers(m, jstate))
    assert all(st["pos"].tolist() == [12, 8, 4] for st in state
               if "pos" in st)


def test_capture_contract_storage_kept_across_chunks_and_resets(rg):
    """The engine's state, feed and output buffers keep their storage
    through admissions (slot resets), chunks and retirements: the
    addresses a captured step replays against."""
    N = 6
    _, mat, lens = _ragged(rg.tc.vocab_size, (5, 9, 3, 7, 6), seed=2)
    eng = serving.ContinuousEngine(rg.step, rg.cache, slots=2,
                                   max_seq=int(mat.shape[1]) + N, chunk=3,
                                   clock=tfaults.TickClock())
    g = eng._graph
    tensors = [(i, k, t) for i, st in enumerate(eng.state)
               for k, t in st.items() if isinstance(t, torch.Tensor)]
    assert {k for _, k, _ in tensors} == {"k", "v", "pos", "h", "conv"}
    assert all(t.shape[0] == 2 for _, _, t in tensors)
    bufs = [g.ctl, g.prev, g.out]
    ptrs = [t.data_ptr() for _, _, t in tensors] + \
        [t.data_ptr() for t in bufs]
    for r in range(5):
        eng.submit(mat[r, :lens[r]], tokens=N, arrival=float(r), rid=r)
    report = eng.run()
    assert sorted(report.completed) == list(range(5))
    assert report.admitted == 5
    assert [t.data_ptr() for _, _, t in tensors] + \
        [t.data_ptr() for t in bufs] == ptrs
    assert all(eng.state[i][k] is t for i, k, t in tensors)
