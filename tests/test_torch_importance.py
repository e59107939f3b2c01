"""The port's Eq. 4 importance against the JAX package's, on the CPU.

The same numpy inputs and parameters go through ``repro`` and
``repro_torch``: the few-step Adam fine-tune (scalar and vmapped), the
``exp(ΔPerf)`` scoring, the Dirac stand-ins of the span batch, the tables
and plans of ``build_tables`` / ``compress`` with an ``ImportanceSpec``,
and a reduced SmolLM through ``TransformerHost.replaced_apply``.

Tolerances (fp32 gradients summed in other orders by XLA and PyTorch):

* tuned parameters: ``|Δ| ≤ 2e-6 + 1e-5·|p|`` per leaf.  Adam's first
  step moves a leaf by about ±lr whatever its gradient's size, so a leaf
  whose gradient is at rounding level in both (|g| < 1e-6 of the leaf's
  largest gradient) may move the other way: such leaves are named by the
  test (``_noise_leaves``) and held to ``2·lr·steps``, never a looser
  bound for the rest;
* importances: ``accuracy_perf`` exact wherever the tuned network's eval
  margin (top logit minus runner-up) is above 1e-4 — at a tie the two
  packages may pick different classes — up to the ulp by which the two
  packages' fp32 ``exp`` differ; ``neg_loss_perf`` and the distill scorer
  within ``rtol 1e-5``;
* the port's batched engine against its sequential one: ``rtol 1e-6,
  atol 1e-7`` (the reference's own bar, ``tests/test_probe_engine.py``);
* plans: identical to ``repro``'s, the DP given the same latency column
  (the JAX package's analytic constants injected, bit-identical).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as j_compress
from repro.core import importance as jimp
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.core.tables import enumerate_probes as j_enumerate_probes
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn as jcnn
from repro.models import cnn_host as jhost
from repro.models import transformer as jT
from repro.models import transformer_host as jthost
from repro.models import zoo as jzoo
from repro_torch.core import compress as t_compress
from repro_torch.core import importance as timp
from repro_torch.core import latency as tlat
from repro_torch.core import one_segment_plan, probe_engine
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.core.tables import enumerate_probes
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as tthost
from repro_torch.models import zoo as tzoo

from _torch_parity import lm_configs, np_lm_params, np_params

TINY = dict(num_classes=4, in_hw=8, width=4, blocks=(2,))
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-5
TIE = 1e-4
# The same accuracy delta through each package's fp32 exp: XLA's and
# PyTorch's differ by up to an ulp (exp(0.375): 1.45499134 in XLA,
# 1.45499146 correctly rounded in PyTorch).
EXP_ULP = 2.0 ** -22


def _jax_oracle_in_port():
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


def _hosts(seed=0, **kw):
    cfg = dict(TINY, **kw)
    jnet, tnet = jzoo.tiny_resnet(**cfg), tzoo.tiny_resnet(**cfg)
    params = np_params(jnet, seed)
    jh = jhost.CNNHost(jnet, jax.tree.map(jnp.asarray, params), batch=4)
    th = thost.CNNHost(tnet, tcnn.params_from_numpy(params, "cpu"), batch=4,
                       dtype_bytes=2, tile_budget=_VMEM_BUDGET, device="cpu")
    return jh, th


def _toy_data(seed, n, hw):
    """The reference's quadrant-mean task from a numpy seed."""
    x = np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)
    q = hw // 2
    means = np.stack([x[:, :q, :q].mean((1, 2, 3)),
                      x[:, :q, q:].mean((1, 2, 3)),
                      x[:, q:, :q].mean((1, 2, 3)),
                      x[:, q:, q:].mean((1, 2, 3))], axis=1)
    return x, means.argmax(1).astype(np.int32)


def _specs(kind, jh, th, steps=3, n=8):
    """``(JAX spec, port spec, base_perf)`` on the same numpy batches:
    ``acc`` (xent fine-tune, accuracy scorer), ``negloss`` (xent, −loss)
    or ``distill`` (the pre-trained net as teacher, −distill loss,
    base 0)."""
    xtr, ytr = _toy_data(1, n, jh.net.in_hw)
    xev, yev = _toy_data(2, n, jh.net.in_hw)
    jtr, jev = (jnp.asarray(xtr), jnp.asarray(ytr)), \
        (jnp.asarray(xev), jnp.asarray(yev))
    ttr = (torch.from_numpy(xtr), torch.from_numpy(ytr).long())
    tev = (torch.from_numpy(xev), torch.from_numpy(yev).long())
    j_apply0 = lambda p, x: jcnn.apply_replaced(jh.net, p, x)  # noqa: E731
    t_apply0 = lambda p, x: tcnn.apply_replaced(th.net, p, x)  # noqa: E731
    if kind == "distill":
        jl = jimp.distill_loss(jax.jit(lambda x: j_apply0(jh.params, x)))
        tl = timp.distill_loss(lambda x: t_apply0(th.params, x))
        js = jimp.ImportanceSpec(jl, jimp.neg_loss_perf(jl), [jtr[0]],
                                 [jev[0]], steps=steps, lr=1e-3)
        ts = timp.ImportanceSpec(tl, timp.neg_loss_perf(tl), [ttr[0]],
                                 [tev[0]], steps=steps, lr=1e-3)
        return js, ts, 0.0
    jperf = jimp.accuracy_perf if kind == "acc" else \
        jimp.neg_loss_perf(jimp.xent_loss)
    tperf = timp.accuracy_perf if kind == "acc" else \
        timp.neg_loss_perf(timp.xent_loss)
    js = jimp.ImportanceSpec(jimp.xent_loss, jperf, [jtr], [jev],
                             steps=steps, lr=1e-3)
    ts = timp.ImportanceSpec(timp.xent_loss, tperf, [ttr], [tev],
                             steps=steps, lr=1e-3)
    return js, ts, jperf(j_apply0, jh.params, [jev])


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{n}": v for k in tree for n, v in
                _flat(tree[k]).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{n}": v for i, t in enumerate(tree) for n, v in
                _flat(t).items()}
    return {"": np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                           else tree)}


def _noise_leaves(loss_fn, apply_fn, params, batch):
    """Leaves (keypaths, element masks) whose gradient at ``params`` is at
    rounding level: below 1e-6 of the leaf's largest |g| and not 0."""
    g = jax.grad(lambda p: loss_fn(apply_fn, p, batch))(params)
    out = {}
    for k, v in _flat(g).items():
        a = np.abs(v)
        out[k] = (a > 0) & (a < 1e-6 * max(float(a.max()), 1e-30))
    return out


def _assert_tuned_close(t_tuned, j_tuned, noise, lr, steps):
    for k, want in _flat(j_tuned).items():
        got = _flat(t_tuned)[k]
        bad = np.abs(got - want) > PARAM_ATOL + PARAM_RTOL * np.abs(want)
        bad &= ~noise.get(k, np.zeros_like(bad))
        assert not bad.any(), (k, float(np.abs(got - want).max()))
        assert (np.abs(got - want) <= 2 * lr * steps + PARAM_ATOL).all(), k


# ---------------------------------------------------------------------------
# The fine-tune and the scoring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["acc", "distill"])
def test_adam_finetune_matches_reference(kind):
    jh, th = _hosts()
    js, ts, _ = _specs(kind, jh, th)
    j_apply = lambda p, x: jcnn.apply_replaced(jh.net, p, x)  # noqa: E731
    t_apply = lambda p, x: tcnn.apply_replaced(th.net, p, x)  # noqa: E731
    noise = _noise_leaves(js.loss_fn, j_apply, jh.params,
                          js.train_batches[0])
    j_tuned = jimp._adam_finetune(j_apply, jh.params, js)
    t_tuned = timp._adam_finetune(t_apply, th.params, ts)
    _assert_tuned_close(t_tuned, j_tuned, noise, ts.lr, ts.steps)
    # the input tree is left as it was
    assert all(np.array_equal(a, b) for a, b in zip(
        _flat(th.params).values(), _flat(jh.params).values()))
    # the scorers on the tuned networks
    jp = js.perf_fn(j_apply, j_tuned, js.eval_batches)
    tp = ts.perf_fn(t_apply, t_tuned, ts.eval_batches)
    assert tp == pytest.approx(jp, rel=1e-5, abs=1e-7)


def test_adam_finetune_batched_singleton_equals_scalar():
    """The vmapped masked Adam on a one-lane stack reproduces the scalar
    fine-tune (the reference's bar), and both the JAX package's batched
    result."""
    jh, th = _hosts()
    js, ts, _ = _specs("acc", jh, th)
    t_apply = lambda p, x: tcnn.apply_replaced(th.net, p, x)  # noqa: E731
    j_apply = lambda p, x: jcnn.apply_replaced(jh.net, p, x)  # noqa: E731
    scalar = timp._adam_finetune(t_apply, th.params, ts)
    stacked = thost._stack([th.params])     # a one-lane probe axis
    batched = timp.adam_finetune_batched(t_apply, stacked, ts)
    for k, a in _flat(scalar).items():
        np.testing.assert_allclose(_flat(batched)[k][0], a, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    j_batched = jimp.adam_finetune_batched(
        j_apply, jax.tree.map(lambda x: x[None], jh.params), js)
    noise = _noise_leaves(js.loss_fn, j_apply, jh.params,
                          js.train_batches[0])
    _assert_tuned_close(jax.tree.map(lambda x: x[0], batched),
                        jax.tree.map(lambda x: x[0], j_batched), noise,
                        ts.lr, ts.steps)


@pytest.mark.parametrize("normalize", [False, True])
def test_perf_to_importance_matches_reference(normalize):
    js = jimp.ImportanceSpec(None, None, [], [], normalize_by_base=normalize)
    ts = timp.ImportanceSpec(None, None, [], [], normalize_by_base=normalize)
    for perf, base in [(0.5, 0.75), (0.9, 0.25), (-3.1, -2.9), (1.0, 1.0),
                       (45.0, 0.0), (-45.0, 0.0), (100.0, -2.0),
                       (-100.0, 2.0), (0.1, 0.0), (1e-3, -1e-3)]:
        got = timp.perf_to_importance(perf, base, ts)
        assert got == pytest.approx(jimp.perf_to_importance(perf, base, js),
                                    rel=EXP_ULP, abs=0), (perf, base)
        assert np.exp(-30.0) * 0.999 <= got <= np.exp(30.0) * 1.001


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_dirac_like_is_an_exact_identity(depthwise, k):
    rng = np.random.default_rng(k)
    c = 6
    w = rng.standard_normal((k, k, 1 if depthwise else c, c)
                            ).astype(np.float32)
    td = thost._dirac_like(torch.from_numpy(w), depthwise)
    np.testing.assert_array_equal(
        td.numpy(), np.asarray(jhost._dirac_like(jnp.asarray(w), depthwise)))
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, c)).astype(np.float32))
    y = tcnn._conv(x, td, 1, depthwise)
    lo = (k - 1) // 2
    assert torch.equal(y, x[:, lo:9 - lo, lo:9 - lo, :])


# ---------------------------------------------------------------------------
# Tables, the engines, plans
# ---------------------------------------------------------------------------

def _same_plan(a, b):
    """Identical segments, budget and latency; the objective (a sum of
    importances) to the tolerance of its terms."""
    da, db = json.loads(a.to_json()), json.loads(b.to_json())
    oa, ob = da.pop("objective"), db.pop("objective")
    assert da == db
    assert oa == pytest.approx(ob, rel=1e-5)


def _tuned_margin(th, seg, ts):
    """The smallest top-1 minus runner-up logit over the eval batches of
    the port's tuned replaced network for ``seg``."""
    apply_fn, p = th.replaced_apply(one_segment_plan(th, seg))
    tuned = timp._adam_finetune(apply_fn, p, ts)
    with torch.no_grad():
        top = torch.topk(apply_fn(tuned, ts.eval_batches[0][0]), 2).values
    return float((top[:, 0] - top[:, 1]).min())


def _assert_importances_match(kind, th, t_entries, j_entries, ts):
    """Every entry of the port's table against the same (i, j, k) of the
    JAX package's unpruned table."""
    probes = {(p[0], p[1], p[2]): p[5] for p in enumerate_probes(th)}
    for span, row in t_entries.items():
        for k, (imp, lat, kept) in row.items():
            jimp_, jlat_, jkept = j_entries[span][k]
            assert lat == jlat_ and kept == jkept, (span, k)
            if kind != "acc":
                assert imp == pytest.approx(jimp_, rel=1e-5), (span, k)
            elif imp != pytest.approx(jimp_, rel=EXP_ULP, abs=0):
                margin = _tuned_margin(th, probes[(*span, k)], ts)
                assert margin < TIE, (span, k, imp, jimp_, margin)


@pytest.fixture(scope="module", params=["acc", "negloss", "distill"])
def tables(request):
    """Both packages' Eq. 4 tables on tiny_resnet: the JAX package's
    sequential build pruned and unpruned, the port's under both engines."""
    kind = request.param
    jh, th = _hosts()
    js, ts, base = _specs(kind, jh, th, steps=2)
    ora = jlat.AnalyticTPUOracle()
    j_full = j_build_tables(jh, latency_oracle=ora, importance=js,
                            base_perf=base, prune=False, engine="sequential")
    j_pruned = j_build_tables(jh, latency_oracle=ora, importance=js,
                              base_perf=base, engine="sequential")
    out = {engine: t_build_tables(th, latency_oracle=_jax_oracle_in_port(),
                                  importance=ts, base_perf=base,
                                  engine=engine)
           for engine in probe_engine.ENGINES}
    return kind, jh, th, ts, base, j_full, j_pruned, out


def test_build_tables_match_reference(tables):
    kind, jh, th, ts, base, j_full, j_pruned, out = tables
    for engine, tt in out.items():
        assert tt.stats.num_importance_probes == sum(
            1 for p in enumerate_probes(th) if not p[5].original)
        _assert_importances_match(kind, th, tt.entries, j_full.entries, ts)
        assert {sp: set(r) for sp, r in tt.entries.items()} == \
            {sp: set(r) for sp, r in j_pruned.entries.items()}, engine
    assert out["batched"].stats.num_importance_batches > 0
    assert out["sequential"].stats.num_importance_batches == 0


def test_batched_engine_equals_sequential(tables):
    *_, out = tables
    bat, seq = out["batched"], out["sequential"]
    assert bat.stats.num_importance_sequential < \
        seq.stats.num_importance_sequential
    for sp, row in seq.entries.items():
        for k, (imp, lat, kept) in row.items():
            np.testing.assert_allclose(bat.entries[sp][k][0], imp,
                                       rtol=1e-6, atol=1e-7)
            assert bat.entries[sp][k][1:] == (lat, kept)


def test_plans_identical_to_reference(tables):
    """The DP on the port's tables gives the JAX package's plan at every
    budget (the columns agree within the tolerances above)."""
    kind, jh, th, ts, base, j_full, j_pruned, out = tables
    from repro.core import dp as jdp
    from repro_torch.core import dp as tdp
    L = jh.net.L
    t_orig = sum(lat for (i, j), row in j_full.entries.items() if j - i == 1
                 for k, (imp, lat, kept) in row.items()
                 if k == jh.original_k(j))
    for ratio in (0.5, 0.7, 0.9):
        b = jdp.solve_dp(L, j_pruned.fn(), ratio * t_orig, 100,
                         original_k=jh.original_k)
        for tt in out.values():
            a = tdp.solve_dp(L, tt.fn(), ratio * t_orig, 100,
                             original_k=th.original_k)
            assert (a is None) == (b is None)
            if a is not None:
                _same_plan(a.plan, b.plan)


def test_normed_host_declines_the_batch_and_still_matches():
    """BN inside every span: the host declines, the engine falls back to
    scalar fine-tunes (counted), and the column equals the sequential
    engine's and the JAX package's."""
    jh, th = _hosts(blocks=(1,), norm="bn")
    js, ts, base = _specs("negloss", jh, th, steps=2)
    segs = [p[5] for p in enumerate_probes(th) if not p[5].original]
    assert all(th.importance_batch([s], None) is None for s in segs)
    stats = probe_engine.EngineStats()
    bat = probe_engine.measure_importances(th, segs, ts, base, stats=stats,
                                           force_batching=True)
    seq = probe_engine.measure_importances(th, segs, ts, base,
                                           engine="sequential")
    assert stats.num_importance_batches == 0
    assert stats.num_importance_sequential == len(segs)
    np.testing.assert_allclose(bat, seq, rtol=1e-6, atol=1e-7)
    jsegs = [p[5] for p in j_enumerate_probes(jh) if not p[5].original]
    from repro.core.probe_engine import measure_importances as j_measure
    want = j_measure(jh, jsegs, js, base, engine="sequential")
    np.testing.assert_allclose(bat, want, rtol=1e-5)


@pytest.mark.parametrize("method", ["layermerge", "layeronly"])
def test_compress_with_measured_importance_matches_reference(method):
    jh, th = _hosts()
    js, ts, base = _specs("negloss", jh, th, steps=2)
    for ratio in (0.6, 0.8):
        b = j_compress(jh, budget_ratio=ratio, P=100, method=method,
                       importance=js, base_perf=base)
        a = t_compress(th, budget_ratio=ratio, P=100, method=method,
                       latency_oracle=_jax_oracle_in_port(), importance=ts,
                       base_perf=base)
        assert (a is None) == (b is None)
        if a is None:
            continue
        _same_plan(a.plan, b.plan)
        if method == "layeronly":
            assert a.tables is None


def test_finetune_recovers_accuracy():
    """The port of ``tests/test_compress.py::test_finetune_recovers_accuracy``:
    fine-tuning the replaced network lowers the toy-task loss, and both
    losses equal the JAX package's on the same data."""
    jh, th = _hosts()
    xtr, ytr = _toy_data(1, 64, 8)
    ttr = (torch.from_numpy(xtr), torch.from_numpy(ytr).long())
    jtr = (jnp.asarray(xtr), jnp.asarray(ytr))
    res = t_compress(th, budget_ratio=0.6, P=100,
                     latency_oracle=_jax_oracle_in_port())
    jres = j_compress(jh, budget_ratio=0.6, P=100)
    _same_plan(res.plan, jres.plan)
    ra, _ = th.replaced_apply(res.plan)
    jra, _ = jh.replaced_apply(jres.plan)
    ts = timp.ImportanceSpec(timp.xent_loss, timp.accuracy_perf, [ttr] * 8,
                             [ttr], steps=25, lr=3e-3)
    js = jimp.ImportanceSpec(jimp.xent_loss, jimp.accuracy_perf, [jtr] * 8,
                             [jtr], steps=25, lr=3e-3)
    before = float(timp.xent_loss(ra, th.params, ttr))
    tuned = timp._adam_finetune(ra, th.params, ts)
    after = float(timp.xent_loss(ra, tuned, ttr))
    assert after < before
    assert before == pytest.approx(
        float(jimp.xent_loss(jra, jh.params, jtr)), rel=1e-5)
    j_after = float(jimp.xent_loss(
        jra, jimp._adam_finetune(jra, jh.params, js), jtr))
    assert after == pytest.approx(j_after, rel=1e-4)


# ---------------------------------------------------------------------------
# A reduced SmolLM through replaced_apply
# ---------------------------------------------------------------------------

def _lm_hosts():
    """``examples/compress_transformer.py``'s smollm-mini sizes (6 layers,
    d 96, 4 heads over 2 kv heads of 24, SwiGLU 256, vocab 256, fp32)."""
    jbase, tbase = lm_configs()["reduced"]
    kw = dict(name="smollm-mini", num_layers=6, d_model=96, num_heads=4,
              num_kv_heads=2, head_dim=24, d_ff=256, vocab_size=256)
    jc, tc = dataclasses.replace(jbase, **kw), dataclasses.replace(tbase, **kw)
    params = np_lm_params(jc, seed=1)
    jh = jthost.TransformerHost(jc, jax.tree.map(jnp.asarray, params),
                                env=jthost.CostEnv(batch=4, seq=16))
    th = tthost.TransformerHost(tc, tT.params_from_numpy(params),
                                env=tthost.CostEnv(batch=4, seq=16),
                                device="cpu")
    return jh, th


def _lm_specs(jh, th, kind):
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, jh.cfg.vocab_size, (4, 17)) for _ in range(2)]
    jb = [{"tokens": jnp.asarray(t[:, :-1]), "targets": jnp.asarray(t[:, 1:])}
          for t in toks]
    tb = [{"tokens": torch.from_numpy(t[:, :-1]),
           "targets": torch.from_numpy(t[:, 1:])} for t in toks]
    if kind == "distill":
        jl = jimp.distill_loss(jax.jit(
            lambda b: jT.forward(jh.cfg, jh.params, b)))
        tl = timp.distill_loss(lambda b: tT.forward(th.cfg, th.params, b))
        return (jimp.ImportanceSpec(jl, jimp.neg_loss_perf(jl), jb[:1],
                                    jb[1:], steps=8, lr=1e-3),
                timp.ImportanceSpec(tl, timp.neg_loss_perf(tl), tb[:1],
                                    tb[1:], steps=8, lr=1e-3), 0.0)

    def jloss(apply_fn, p, batch):
        logp = jax.nn.log_softmax(apply_fn(p, batch))
        return -jnp.mean(jnp.take_along_axis(
            logp, batch["targets"][..., None], axis=-1))

    def tloss(apply_fn, p, batch):
        logp = torch.log_softmax(apply_fn(p, batch), dim=-1)
        return -torch.mean(torch.take_along_dim(
            logp, batch["targets"][..., None].long(), dim=-1))
    js = jimp.ImportanceSpec(jloss, jimp.neg_loss_perf(jloss), jb[:1],
                             jb[1:], steps=8, lr=1e-3)
    ts = timp.ImportanceSpec(tloss, timp.neg_loss_perf(tloss), tb[:1],
                             tb[1:], steps=8, lr=1e-3)
    base = js.perf_fn(lambda p, b: jT.forward(jh.cfg, p, b), jh.params,
                      js.eval_batches)
    return js, ts, base


@pytest.mark.parametrize("kind", ["negloss", "distill"])
def test_lm_importances_through_replaced_apply(kind):
    """``method="depth"`` tables of the reduced SmolLM: every fine-tune
    runs ``replaced_apply`` (the executor, ``merged_ffn_op``,
    ``rmsnorm_op`` and ``flash_attention_op``) in both packages."""
    jh, th = _lm_hosts()
    js, ts, base = _lm_specs(jh, th, kind)
    jt = j_build_tables(jh, method="depth", prune=False, importance=js,
                        base_perf=base, latency_oracle=jlat.AnalyticTPUOracle())
    tt = t_build_tables(th, method="depth", importance=ts, base_perf=base,
                        latency_oracle=_jax_oracle_in_port())
    assert tt.stats.num_importance_sequential == \
        tt.stats.num_importance_probes > 0
    _assert_importances_match(kind, th, tt.entries, jt.entries, ts)
