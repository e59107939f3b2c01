"""The RG-LRU scan's gradient and its kernels' launch plan on the CPU (no
card, no ``nvcc``).

* ``ref.rglru_scan_bwd_ref`` (the backward kernel's plain version, the
  reverse loop) against autograd of ``ref.rglru_scan_ref``: bitwise
  (``torch.equal``), at ragged S and C.  Autograd's sums of two terms
  commute and its zero-filled slices add exactly, so the two round alike.
* The same gradients against ``jax.vjp`` of the JAX package's sequential
  ``repro.kernels.ref.rglru_scan_ref`` (``lax.scan``) within 1e-6 of each
  gradient's largest element (the same recurrence; XLA may round a step
  otherwise), and of its model's ``repro.models.rglru.rglru_scan``
  (``lax.associative_scan``) within 1e-5 (fp32 reassociation).
* The model's ``rglru_scan(a, gated, h0=None)`` (``h0`` folded into the
  first step) against ``repro``'s, values and gradients (``dh0`` too),
  within 1e-5 of the largest element (the same reassociation).
* ``launch_plan``: every channel and every step covered once in each
  direction, the chunk order of each direction, the ring's shared memory
  within 227 KB, at least 132 blocks at (8, S, 2560), S = 1 and ragged C
  taken; and the source's chunk and ring indexing, replayed here step by
  step on the plain arithmetic, bitwise the plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import rglru as jRG
from repro_torch.kernels import cuda_build, ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import rglru as tRG

SOURCE = cuda_build.CSRC / "rglru_scan.cu"


def _inputs(b, s, c, seed=0):
    """a in (0.5, 1), gated and the output's gradient standard normal."""
    rng = np.random.default_rng(seed + s * 7 + c)
    a = rng.uniform(0.5, 1.0, (b, s, c)).astype(np.float32)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    g = rng.standard_normal((b, s, c)).astype(np.float32)
    return a, x, g


def _autograd(fn, a, x, g, *extra):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (a, x, *extra)]
    h = fn(*leaves)
    return h.detach(), torch.autograd.grad(h, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("s", [1, 7, 33, 130])
@pytest.mark.parametrize("c", [1, 32, 2561])
def test_bwd_ref_is_autograd_of_the_scan_bitwise(s, c):
    a, x, g = _inputs(2, s, c)
    h, (ga, gx) = _autograd(ref.rglru_scan_ref, a, x, g)
    da, db = ref.rglru_scan_bwd_ref(torch.from_numpy(a), h,
                                    torch.from_numpy(g))
    assert torch.equal(da, ga) and torch.equal(db, gx)


def _held(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("b,s,c", [(2, 7, 32), (1, 130, 37), (2, 33, 2561),
                                   (3, 1, 5)])
def test_gradients_match_jax(b, s, c):
    a, x, g = _inputs(b, s, c, seed=1)
    h, _ = _autograd(ref.rglru_scan_ref, a, x, g)
    da, db = ref.rglru_scan_bwd_ref(torch.from_numpy(a), h,
                                    torch.from_numpy(g))
    for fn, rtol in ((jref.rglru_scan_ref, 1e-6), (jRG.rglru_scan, 1e-5)):
        hj, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(x))
        ja, jx = vjp(jnp.asarray(g))
        _held(h.numpy(), hj, rtol)
        _held(da.numpy(), ja, rtol)
        _held(db.numpy(), jx, rtol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,c", [(2, 9, 16), (1, 1, 7), (2, 64, 33)])
def test_model_scan_with_h0_matches_repro(b, s, c, with_h0):
    a, x, g = _inputs(b, s, c, seed=2)
    h0 = np.random.default_rng(s).standard_normal((b, c)).astype(np.float32)
    extra = (h0,) if with_h0 else ()
    h, grads = _autograd(tRG.rglru_scan, a, x, g, *extra)
    hj, vjp = jax.vjp(jRG.rglru_scan, jnp.asarray(a), jnp.asarray(x),
                      *(jnp.asarray(t) for t in extra))
    _held(h.numpy(), hj, 1e-5)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        _held(got.numpy(), want, 1e-5)
    if not with_h0:
        assert torch.equal(h, ref.rglru_scan_ref(torch.from_numpy(a),
                                                 torch.from_numpy(x)))


#: (B, S, C) of the path (RecurrentGemma-2B's probes and training at S
#: 128, its prompts at 16, a decode-sized S 1), phase 3's sweep and
#: ragged or narrow shapes.
PLAN_SHAPES = [(8, s, 2560) for s in (1, 16, 128, 512)] + [
    (b, s, c) for b in (1, 8) for s in (1, 7, 128, 512)
    for c in (32, 256, 2561)] + [(4, 512, 256), (2, 33, 1), (3, 130, 37),
                                 (1, 1, 1), (16, 64, 4096)]


def _cover(plan):
    """How often each (batch, step, channel) is taken by the plan's
    blocks, threads and chunks; asserts each chain's order of steps."""
    seen = np.zeros((plan.b, plan.s, plan.c), dtype=np.int32)
    for y in range(plan.b):
        for x in range(-(-plan.c // plan.ct)):
            chans = plan.block_channels(x)
            assert 0 < len(chans) <= plan.ct
            steps = [t for k in range(plan.chunks)
                     for t in plan.chunk_steps(k)]
            want = list(range(plan.s))
            assert steps == (want if plan.direction == "forward"
                             else want[::-1])
            for k in range(plan.chunks):
                assert 0 < len(plan.chunk_steps(k)) <= plan.tc
            seen[y, :, chans.start:chans.stop] += 1
    return seen


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("b,s,c", PLAN_SHAPES)
def test_plan_covers_each_chain_once(b, s, c, direction):
    plan = rg.launch_plan(b, s, c, direction)
    assert (_cover(plan) == 1).all()
    assert plan.ct in rg.CHANNEL_TILES
    assert plan.smem <= rg.SMEM_MAX
    assert 1 <= plan.stages <= rg.STAGES[direction] <= 4
    assert plan.stages >= min(3, plan.chunks)
    assert plan.vec == (4 if c % 4 == 0 else 1)
    assert rg.launch_plan(b, s, c, direction, aligned=False).vec == 1
    if (b, c) == (8, 2560):
        assert plan.blocks >= 132
    if s <= rg.CHUNK:
        assert plan.chunks == 1          # the whole sequence at once
    assert plan.args() == (plan.ct, plan.tc, plan.stages, plan.vec)


def test_plan_spreads_recurrentgemma_over_the_sms():
    """RecurrentGemma-2B's 8 × 2560 chains: 64 a block, 320 blocks, two or
    three on every SM of the 132, with the ring of every block resident
    at once (three blocks' shared memory on one SM)."""
    for direction in ("forward", "backward"):
        plan = rg.launch_plan(8, 128, 2560, direction)
        assert (plan.ct, plan.blocks, plan.tc) == (64, 320, 32)
        assert 3 * (plan.smem + 1024) <= 228 * 1024
        assert plan.stages == rg.STAGES[direction]
    assert rg.launch_plan(8, 16, 2560).smem <= 48 * 1024


def test_source_takes_the_plans_instances():
    text = SOURCE.read_text()
    for entry in ("rglru_scan_f32", "rglru_scan_bwd_f32"):
        assert f'extern "C" int {entry}(' in text
    for ct in rg.CHANNEL_TILES:
        for vec in (1, 4):
            assert f"<{ct}, {vec}>" in text
    assert f"SMEM_MAX = {rg.SMEM_MAX}" in text
    assert f"CHUNK = {rg.CHUNK}" in text
    assert f"MAX_STAGES = {max(rg.STAGES.values())}" in text


def _replay(plan, a, b_or_h, g=None):
    """The source's kernels replayed on the CPU, chunk by chunk through a
    ring of ``plan.stages`` tiles as the blocks fill and drain it (a chunk
    loaded ``stages`` ahead of the one consumed, into the stage that chunk
    frees), each step the plain arithmetic over a block's channels."""
    tc, S = plan.tc, plan.s
    fwd = plan.direction == "forward"
    outs = [torch.full_like(a, float("nan")) for _ in range(1 if fwd else 2)]
    for x in range(-(-plan.c // plan.ct)):
        ch = plan.block_channels(x)
        cs = slice(ch.start, ch.stop)
        ring = [None] * plan.stages

        def load(k):
            if k >= plan.chunks:
                return
            if fwd:
                t0 = k * tc
                rows = slice(t0, min(t0 + tc, S))
                ring[k % plan.stages] = (k, a[:, rows, cs], b_or_h[:, rows, cs])
                return
            t1 = S - k * tc
            t0 = max(t1 - tc, 0)
            hs = torch.zeros((a.shape[0], t1 - t0, len(ch)))
            if t0 > 0:
                hs[:] = b_or_h[:, t0 - 1:t1 - 1, cs]
            else:
                hs[:, 1:] = b_or_h[:, 0:t1 - 1, cs]
            ring[k % plan.stages] = (k, a[:, t0:t1, cs], g[:, t0:t1, cs], hs)
        for k in range(plan.stages):
            load(k)
        hv = torch.zeros((a.shape[0], len(ch)))
        d = an = None
        for k in range(plan.chunks):
            tile = ring[k % plan.stages]
            assert tile[0] == k
            if fwd:
                for r, t in enumerate(plan.chunk_steps(k)):
                    hv = tile[1][:, r] * hv + tile[2][:, r]
                    outs[0][:, t, cs] = hv
            else:
                t0 = plan.chunk_steps(k)[-1]
                for t in plan.chunk_steps(k):
                    r = t - t0
                    gt = tile[2][:, r]
                    d = gt if t == S - 1 else gt + an * d
                    outs[1][:, t, cs] = d
                    outs[0][:, t, cs] = d * tile[3][:, r]
                    an = tile[1][:, r]
            load(k + plan.stages)
    return outs


@pytest.mark.parametrize("b,s,c", [(2, 1, 5), (1, 7, 70), (2, 33, 64),
                                   (1, 130, 37), (2, 200, 96)])
def test_source_indexing_replayed_is_the_plain_version(b, s, c):
    a, x, g = (torch.from_numpy(t) for t in _inputs(b, s, c, seed=3))
    h = ref.rglru_scan_ref(a, x)
    (got,) = _replay(rg.launch_plan(b, s, c), a, x)
    assert torch.equal(got, h)
    da, db = _replay(rg.launch_plan(b, s, c, "backward"), a, h, g)
    want = ref.rglru_scan_bwd_ref(a, h, g)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])


def test_scan_op_backward_is_one_kernel_launch(monkeypatch):
    """The op's CUDA branch on the CPU with no-grad stand-ins for the two
    kernels: the forward saves a and h (not b), the backward makes one
    launch of the backward kernel with them and the output's gradient and
    recomputes nothing; gradients bitwise the plain version's autograd."""
    calls = []

    def fwd(a, b):
        calls.append("forward")
        with torch.no_grad():
            return ref.rglru_scan_ref(a, b)

    def bwd(a, h, g):
        calls.append("backward")
        assert torch.equal(h, ref.rglru_scan_ref(a, b_in))
        return ref.rglru_scan_bwd_ref(a, h, g)
    monkeypatch.setattr(ops, "_on_cuda", lambda x, name: True)
    monkeypatch.setattr(rg, "rglru_scan", fwd)
    monkeypatch.setattr(rg, "rglru_scan_bwd", bwd)
    a_np, x_np, g_np = _inputs(2, 19, 24, seed=4)
    a_in, b_in = torch.from_numpy(a_np), torch.from_numpy(x_np)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        leaves = [a_in.clone().requires_grad_(), b_in.clone().requires_grad_()]
        h = ops.rglru_scan_op(*leaves)
    assert calls == ["forward"] and len(saved) == 2
    assert torch.equal(saved[1], h.detach())
    g = torch.from_numpy(g_np)
    got = torch.autograd.grad(h, leaves, g)
    assert calls == ["forward", "backward"]
    _, want = _autograd(ref.rglru_scan_ref, a_np, x_np, g_np)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    # only b requiring a gradient: db still bitwise
    lb = b_in.clone().requires_grad_()
    (gb,) = torch.autograd.grad(ops.rglru_scan_op(a_in, lb), [lb], g)
    assert torch.equal(gb, want[1])


def test_scan_ab_needs_the_card():
    """The two-checkout timing tool refuses to run without a card."""
    from repro_torch.testing import scan_ab
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    assert scan_ab.main([".", "."]) == 2
