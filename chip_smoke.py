#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # card, build and kernel checks only

Phases, each printing its own line with the seconds it took:

1. card    — ``nvidia-smi`` name and power limit; TF32 off.
2. build   — the six hand-written kernel sources from
             ``src/repro_torch/kernels/csrc`` with ``nvcc`` (in parallel;
             the three merged-segment kernels with their fp32 and
             quantized entry points), with ``-Xptxas -v`` resources.
3. kernels — each kernel against its plain PyTorch version on the card:
             the convs over strides {1,2,3} × k {1,2,3,5,7,11}, ragged
             shapes, every activation, no bias, and the depthwise /
             channel-multiplier / grouped cases (``DW_CASES``: the
             depthwise kernel's scalar and vector paths); merged_ffn over
             M {1,8,37,1024} × D {32,96,576} × R {1,24,576,1152,1536}
             (1536: the replaced path's unmerged SmolLM FFN), at
             D 2560 × R {24,2560,7680} × M {8,1024} (RecurrentGemma), at
             D 2561 (rows not 16-byte aligned) × M {1,8,63,64,65,129,1024}
             (both tiles and their boundary) × R {24,2560} and R 7680 at
             M 8, and twice on the same inputs at D 2560, M {8,1024}:
             bitwise equal (the split reductions sum in a fixed order).
             Then the
             quantized variants in int8, w8a8 and fp8 against ``*_qref``:
             the convs over strides {1,2,3} × k {1,3,5,7} with the same
             cases, merged_ffn over M {1,8,37,1024} × D {96,576} ×
             R {24,576} and its four type pairs (fp32 or int8 panel × int8
             or e4m3 factors) at D 2560 × M {8,1024} × R {24,2560},
             within the same tolerance over the dequantized
             operands; ``quant.quantize_int8`` on the card bitwise
             equal to the CPU's; rmsnorm over M {1,8,37,1024} ×
             D {32,512,576,2560,2561}; rglru_scan over B {1,8} ×
             S {1,7,128,512} × C {32,256,2560,2561} (also bitwise);
             flash_attention over BH {1,8,80} × S {1,7,16,128,256,1000} ×
             D {32,64,256}, causal and not, with grouped and multi-query
             kv heads; ``benchmarks/run.py``'s three shapes; the
             gradient of ``flash_attention_op`` through the kernel; and
             twice on the same inputs, bitwise equal, flash_attention at
             the path's four shapes, depthwise_conv (fp32 and w8a8) at
             three MobileNetV2 units and merged_conv (fp32 and w8a8) at
             four, two of them split.  merged_conv and its four quantized
             type pairs also run ``CONV_CASES``, which must reach every
             instance of its launch plan (each tile, copy width, the
             dense panel, a split reduction, the int8 mma and int8 x int8
             in TF32), at the same tolerance.
4. compress — the main path: ``python -m repro_torch.compress`` on
             MobileNetV2 at full width (224², width 1.0, 1000 classes,
             batch 8, ``--max-span 6``, budget 0.6), latency tables timed
             on the card through the kernels (wall-clock oracle).
5. serve   — the artifact loaded on the card classifies seeded batches
             through ``execute``; every batch's logits are held against the
             same artifact on the CPU (plain versions) and against
             ``apply_replaced`` of the plan (merge exactness); CUDA-event
             latency of the original against the merged network, and
             their device times as CUDA-graph replays beside the
             predicted speedup.  The kernels' launch counts of phases 4-5
             (counted from zero) must both be > 0.
6. main-path kernels — each conv unit of the merged MobileNetV2 graph, at
             its shape and weights: kernel against plain version, and the
             time of kernel, plain version and the one-call library
             yardstick (``F.conv2d``, cuDNN, TF32 off) beside the bound
             and, for merged_conv, the launch plan it took (per unit in
             ``units.json``).
             Times are device times with a cold L2: 50 calls, each after
             a read that evicts the L2, captured in a CUDA graph and
             replayed, less the evicting reads alone (:func:`kernel_time`);
             so the inputs come from HBM, as the byte bound prices them.
7. resnet34 — ResNet34 at full width with the analytic oracle: lower,
             execute on the card (pool, projection shortcuts, the 7×7
             stride-2 stem), and hold against the CPU port; then each of
             its merged_conv units at batch 8 as in phase 6 (no plain
             version), against cuDNN (``resnet34.json``).
8. lm compress — the transformer path: SmolLM-135M at full width in fp32
             (random weights, seed 0), ``CostEnv(batch=8, seq=128)``,
             ``method="depth"``, latency tables timed on the card (the
             lowrank probes through merged_ffn), budgets 0.6, 0.7, ... up
             to the first whose plan merges an FFN; that artifact is
             saved.  The ``layermerge`` 0.6 plan's census is printed
             beside it.
9. lm serve — the artifact loaded on the card serves 8 seeded prompts of
             16 tokens with 32 greedy tokens (KV cache) through the
             captured ``serve_loop`` (one CUDA-graph replay per prompt
             position and per generated token) and through
             ``serve_loop_pertoken`` (eager), which must give the same
             tokens, the captured decode no slower (:func:`serve_both`:
             prefill ms and decode tok/s of both loops, the capture's
             seconds, launches per step counted at the capture, and the
             captured decode's device-busy share from torch.profiler);
             every step's logits, teacher-forced with the card's tokens,
             are held against the same artifact on the CPU, and the
             prefill forward against ``replaced_apply``; the original
             model is served the same way.  merged_ffn's launch count
             over phases 8-9 (counted from zero) must be > 0.
10. merged_ffn shapes — the kernel at the path's shapes (each lowrank
             unit at M = 8, one decode step; one at M = 1024, a probe):
             kernel, plain version, ``torch.addmm(x, x @ U, V)`` (two
             cuBLAS calls) and the bound, as device times (phase 6), and
             the host microseconds an eager call takes.  merged_ffn's
             operations are priced at the tensor-core rate that gives its
             accuracy (``TC_RATES``: 3xTF32 for fp32 × fp32), as are
             merged_conv's and flash_attention's, every other kernel's at
             the fp32 FFMA rate; each row names its rate.
11. q serve — the quantized CNN path: MobileNetV2 as in phase 4 through
             the CLI with ``--quantize w8a8`` and phase 4's oracle (no
             signature timed twice), budgets 0.6, 0.5, 0.4 until the plan
             quantizes a dense and a depthwise unit; the v3 artifact
             classifies the seeded batches on the card, held against (a)
             the CPU port of the same artifact within NET_RTOL + 2·δ, δ
             being the CPU port's own activation rounding (its logits
             against the same artifact with w8a8 units run as int8): an
             activation code can differ by one step between the two
             devices where fp32 reassociation moved a value across a
             rounding boundary, and each device's rounding error is of
             δ's size, so the two differ by at most about 2·δ; (a') the
             CPU port fed the card's activation codes (:class:`ActCodes`)
             within NET_RTOL; (b) the fp lowering of the same plan within
             0.25 (the reference's criterion).  Launch counts of the
             quantized kernels over this phase must be > 0.
12. quantized conv units — each quantized unit of one forward, on its
             card input: kernel against plain version (phase-3
             tolerance), and the kernel, the activation quantization pass,
             the whole op, the fp32 kernel, the plain version and
             ``F.conv2d`` on the dequantized operands beside the bound at
             narrow widths, as device times.
13. lm q serve — SmolLM-135M w8a8 with ``method="depth"`` under the
             decode-shaped ``CostEnv(batch=8, seq=1)`` (phase 8's env
             prices every segment compute-bound and gets no sibling); if
             the DP picks no w8a8 lowrank unit at any budget, phase 8's
             plan with its lowrank segments set to w8a8.  The v3 artifact
             serves the prompts of phase 9 through both loops as phase 9
             does; every step's logits,
             teacher-forced, are held against the CPU port as in phase 11
             (a) and (a'), and each unit of the last step against its
             plain version on its card input; merged_ffn_q's launches over
             this phase must be > 0; decode tok/s beside the fp plan's.
14. merged_ffn_q shapes — each quantized lowrank unit at M = 8 timed as
             in phase 12 (``torch.addmm`` on the dequantized operands),
             and one unit's kernel alone in each variant (fp32, int8,
             w8a8, fp8).

15. rg compress — RecurrentGemma-2B at full size in fp32 (26 layers:
             rglru, rglru, attn_local; d 2560, 10 heads over 1 kv head,
             GeGLU 7680, vocab 256000; random weights, seed 0),
             ``CostEnv(batch=8, seq=128)``, ``method="depth"``, tables
             timed on the card (probes through rmsnorm, rglru_scan,
             flash_attention and merged_ffn), phase 8's budget ladder to
             the first plan that merges an FFN; the artifact is saved.
             Where the card's tables merge no FFN at any budget the phase
             fails, naming the ladder (a slow merged_ffn shows there).
16. rg serve — the artifact on the card serves phase 9's protocol (8
             prompts x 16 tokens, 32 greedy tokens, RG-LRU state and the
             local KV ring buffer; both loops, as in phase 9); every
             step's logits, teacher-forced,
             against the CPU port of the artifact, and the prefill
             forward against ``replaced_apply``; CUDA-event prefill and
             decode beside the original model; launches per decode step
             (counted at the capture) and per prefill forward.  The launches of rmsnorm,
             rglru_scan, flash_attention and merged_ffn over phases 15-16
             (counted from zero) must each be > 0.
17. rg kernels — rmsnorm, rglru_scan and flash_attention at the path's
             shapes (and SmolLM's), merged_ffn at D 2560: kernel, plain
             version, library yardstick (``F.rms_norm``,
             ``F.scaled_dot_product_attention``, ``addmm``; none for the
             scan) and bound (attention's operations at the 3xTF32
             rate), as device times; the new kernels' rows of
             the ``kernels`` line are their probe shapes.
18. lm requests — phase 8's SmolLM-135M artifact serves
             ``ragged_prompts(0, 24, 4, 32, vocab)`` and phase 15's
             RecurrentGemma-2B artifact 8 such prompts through
             ``serve_requests(slots=8, tokens=32)``: sustained tok/s,
             rounds and dispositions; every request's tokens must equal
             ``serve_loop`` of its prompt alone at batch 1, and the last
             round served again with one slot's logits made NaN at
             generation index 2 must report that request alone aborted
             at 2, every other token-identical to the clean run.
19. lm continuous — the same artifacts and prompts through the
             continuous engine (``serve_continuous(slots=8, chunk=8,
             tokens=32)``, one captured chunk step, a position per
             slot): (a) all arriving at 0 on the real clock, sustained
             tok/s beside phase 18's, chunks and admissions; (b) a
             seeded Poisson trace at 20 requests/s, p50 and p99 latency;
             (c) on a ``TickClock``, ``nan@serve.nan`` on a request
             admitted mid-stream with ``delay@serve.arrival`` and
             ``delay@serve.chunk`` rules; (d) ``raise@serve.worker`` at
             the 3rd chunk through ``serve_with_failover``.  Every
             request's tokens must equal phase 18's single-prompt
             ``serve_loop``, the poisoned one alone aborted at 2, both
             delay rules fired, one failover replayed bit-identically,
             one graph replay per step, and the launches of (a), counted
             from zero, show ``rmsnorm`` and ``merged_ffn``; a
             torch.profiler trace of four chunks gives the captured
             step's device time and (a)'s busy share.

Any failed check raises, so the script exits non-zero.  Per-unit shapes,
times, bounds and launch plans land in ``build/chip_smoke/units.json``
(MobileNetV2), ``resnet34.json``, ``qunits.json`` and ``qffn.json`` (the
quantized phases), RecurrentGemma's in ``rg.json``, the serving numbers
of phases 9, 13, 16, 18 and 19 in ``serve.json``.  It exits non-zero
without a result where ``torch.cuda.is_available()`` is false or the repo's
``src/`` is missing.  The last lines are the ``kernels`` JSON line, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores, data sheet
H100_TF32_FLOPS = 495e12         # TF32 tensor cores, dense, data sheet
H100_FP16_FLOPS = 989e12         # fp16 tensor cores, dense, data sheet
H100_INT8_OPS = 1979e12          # int8 tensor cores, dense, data sheet
H100_HBM_BW = 3.35e12            # bytes/s, data sheet
H100_L2_BYTES = 50 * 2**20       # data sheet

# Kernel vs plain version: |y − ref| ≤ RTOL · (|x| ⋆ |w| + |b|) + ATOL per
# output.  Both sides accumulate in fp32 in different orders (the kernel
# sequentially over (u, v, c); cuDNN by its own algorithm), so their error
# is a few ulps of Σ|x·w| in practice and at most ~Ktot·2⁻²⁴ of it; an
# indexing fault is O(1) of it.
RTOL, ATOL = 1e-4, 1e-6
# Whole networks (50+ layers of fp32 reassociation): max |Δ| over max |y|.
NET_RTOL = 1e-4
# Depth-compression budgets tried for SmolLM-135M, tightest first.
LM_BUDGETS = (0.6, 0.7, 0.8, 0.9, 1.0)
# w8a8 MobileNetV2 budgets, until the plan quantizes a dense and a
# depthwise unit.
Q_BUDGETS = (0.6, 0.5, 0.4)
# Quantized network vs the fp lowering of the same plan: the reference's
# own criterion (tests/test_quant_pipeline.py), max |Δ| / max |y| < 0.25.
Q_FP_RTOL = 0.25
# The products of merged_ffn, merged_conv and flash_attention priced at
# the tensor-core rate that gives the result's accuracy, by operand types
# (the activation or panel, the weight or factor): fp32 x fp32 as 3xTF32,
# fp32 x narrow as 2xTF32 (a narrow value is exact in TF32), int8 x int8
# at the int8 rate, int8 x e4m3 at fp16's (both exact in fp16).
TC_RATES = {("fp32", "fp32"): (H100_TF32_FLOPS / 3, "3xTF32"),
             ("fp32", "narrow"): (H100_TF32_FLOPS / 2, "2xTF32"),
             ("int8", "int8"): (H100_INT8_OPS, "int8"),
             ("int8", "e4m3"): (H100_FP16_FLOPS, "fp16")}
# The rate every other kernel's operations are priced at.
FFMA_RATE = f"fp32 FFMA, {H100_FP32_FLOPS / 1e12:g} TFLOP/s"
# Per-unit timings of the quantized kernels summed over a forward / step.
Q_FIELDS = ("ms", "plain_ms", "library_ms", "fp32_ms", "op_ms", "qpass_ms",
            "flops_ms", "bytes_ms", "bound_ms")

IMPORT_ERROR = ("chip_smoke.py runs from a checkout of the repository: "
                "src/repro_torch is missing")


def log(phase: str, t0: float, msg: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s {msg}".rstrip(),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


_L2_EVICT = []


def l2_evict():
    """Read a buffer of four times the L2, so that nothing an earlier call
    left there is still cached."""
    import torch
    if not _L2_EVICT:
        # fp32: 4 bytes an element, so four L2s of bytes
        _L2_EVICT.append(torch.ones(H100_L2_BYTES, device="cuda"))
    return _L2_EVICT[0].sum()


def kernel_time(fn) -> float:
    """Device milliseconds per call of ``fn`` with a cold L2: 50 calls,
    each after :func:`l2_evict`, captured in a CUDA graph and replayed 10
    times (the wall-clock oracle's protocol, so that host dispatch does
    not hide a kernel's own time), less the same for the evicting reads
    alone.  Each call then reads its inputs from HBM, as the byte bound
    (``H100_HBM_BW``) prices them; replaying warm inputs would let L2
    serve inputs under 50 MB and beat that bound."""
    from repro_torch.core import WallClockOracle
    oracle = WallClockOracle(warmup=3, iters=500, groups=10)
    both = oracle.time_callable(lambda: (l2_evict(), fn()))
    alone = oracle.time_callable(l2_evict)
    return (both - alone) * 1e3


def check_bound(name: str, ms: float, bound_ms: float) -> None:
    """A kernel cannot beat its bound: a share above 1 means the byte or
    operation count, or the timing, is wrong."""
    check(bound_ms <= ms, f"{name}: {ms:.5f} ms is under its bound "
          f"{bound_ms:.5f} ms (share {bound_ms / ms:.3f})")


def cuda_time(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events
    around eager calls: host dispatch included)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Kernel against plain version
# ---------------------------------------------------------------------------

def held(name, y, yr, scale, case) -> tuple[float, float]:
    """|y − yr| ≤ RTOL · scale + ATOL per output on the same card inputs;
    returns (max |Δ|, max |Δ| / scale)."""
    import torch
    torch.cuda.synchronize()
    check(y.shape == yr.shape, f"{name} {case}: shape {tuple(y.shape)} vs "
          f"{tuple(yr.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name} {case}: non-finite output")
    err = (y - yr).abs()
    rel = float((err / (scale + ATOL)).max())
    check(not bool((err > RTOL * scale + ATOL).any()),
          f"{name} {case}: max|Δ|={float(err.max()):.3g} rel={rel:.3g} "
          f"beyond rtol={RTOL}")
    return float(err.max()), rel


#: (groups, cin_g, cout_g) of the depthwise kernel's sweeps: the scalar
#: path (13 channels; a channel multiplier with 18 outputs; general
#: grouped) and the vector path (16 channels; a multiplier with 8).
DW_CASES = ((13, 1, 1), (6, 1, 3), (3, 4, 5), (16, 1, 1), (4, 1, 2))


def compare_kernel(kind, x, w, b, stride, groups=None, activation=None):
    """Run the kernel op and its plain version on the same card inputs;
    returns (max |Δ|, max |Δ| / scale); raises beyond the tolerance."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    if kind == "merged_conv":
        y = kernels.merged_conv_op(x, w, b, stride=stride,
                                   activation=activation)
        yr = ref.merged_conv_ref(x, w, b, stride=stride)
        scale = ref.merged_conv_ref(x.abs(), w.abs(),
                                    None if b is None else b.abs(),
                                    stride=stride)
    else:
        y = kernels.depthwise_conv_op(x, w, b, stride=stride, groups=groups,
                                      activation=activation)
        yr = ref.depthwise_conv_ref(x, w, b, stride=stride, groups=groups)
        scale = ref.depthwise_conv_ref(x.abs(), w.abs(),
                                       None if b is None else b.abs(),
                                       stride=stride, groups=groups)
    return held(kind, y, ref.apply_activation(yr, activation), scale,
                f"x={tuple(x.shape)} w={tuple(w.shape)} s={stride} "
                f"g={groups} act={activation}")


# ---------------------------------------------------------------------------
# Quantized kernels against their plain versions
# ---------------------------------------------------------------------------

#: Quantized sweep modes: weight dtype of ``quant.quantize_weight`` and the
#: op's ``act_quant``.  fp8 is not a CLI mode, but the kernels take it.
QMODES = {"int8": ("int8", "none"), "w8a8": ("int8", "w8a8"),
          "fp8": ("fp8", "none")}


def print_profile(label, fn, arg, ms) -> None:
    """One line: device-busy share of ``fn(arg)`` against ``ms`` (its
    measured time per call) and its heaviest kernels (torch.profiler)."""
    busy_us, rows = device_kernels(lambda: fn(arg))
    if not rows:
        print(f"  {label}, torch.profiler: no device activity seen (busy "
              "share not measured)", flush=True)
        return
    print(f"  {label}, torch.profiler: device busy {busy_us:.1f} us per "
          f"call = {busy_us / (ms * 1e3):.3f} of its {ms:.3f} ms; by kernel: "
          + "; ".join(f"{name[:60]} {us:.1f}us x{n}"
                      for us, n, name in rows[:8]), flush=True)


def dequantized_input(x, act_quant):
    """The activation the quantized kernel sees, dequantized: the codes
    ``quant.quantize_int8`` gives for ``x`` on its device times their
    scale under w8a8 (the op quantizes the same ``x`` with the same
    function, so both sides see the same integers), else ``x``."""
    from repro_torch.kernels import quant
    if act_quant != "w8a8":
        return x
    return quant.dequantize(*quant.quantize_int8(x))


def compare_qkernel(kind, x, wq, ws, b, stride, act_quant, groups=None,
                    activation=None):
    """The quantized conv op against its plain version (``*_qref``) on the
    same card inputs: |Δ| ≤ RTOL · (|x̂| ⋆ |ŵ| + |b|) + ATOL per output,
    over the dequantized operands; returns (max |Δ|, max |Δ| / scale)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref

    xd, wd = dequantized_input(x, act_quant), quant.dequantize(wq, ws, axis=3)
    bb = None if b is None else b.abs()
    if kind == "merged_conv":
        y = kernels.merged_conv_op(x, wq, b, stride=stride, w_scale=ws,
                                   act_quant=act_quant, activation=activation)
        yr = ref.merged_conv_qref(x, wq, b, ws, stride=stride,
                                  act_quant=act_quant)
        scale = ref.merged_conv_ref(xd.abs(), wd.abs(), bb, stride=stride)
    else:
        y = kernels.depthwise_conv_op(x, wq, b, stride=stride, groups=groups,
                                      w_scale=ws, act_quant=act_quant,
                                      activation=activation)
        yr = ref.depthwise_conv_qref(x, wq, b, ws, stride=stride,
                                     groups=groups, act_quant=act_quant)
        scale = ref.depthwise_conv_ref(xd.abs(), wd.abs(), bb, stride=stride,
                                       groups=groups)
    check(y.dtype == torch.float32, f"{kind} quantized: {y.dtype} output")
    return held(f"{kind} quantized", y, ref.apply_activation(yr, activation),
                scale, f"x={tuple(x.shape)} w={tuple(wq.shape)} {wq.dtype} "
                f"s={stride} g={groups} act={activation} "
                f"act_quant={act_quant}")


def qkernel_sweep(dev) -> dict:
    """Each quantized conv kernel over modes × strides {1,2,3} × k
    {1,3,5,7}, ragged shapes, every activation, no bias on a third, and the
    depthwise / channel-multiplier / grouped cases."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    acts = [None, "relu", "relu6", "silu"]
    worst = {"merged_conv_q": [0.0, 0.0, 0], "depthwise_conv_q": [0.0, 0.0, 0]}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    n = 0
    for mode, (wmode, aq) in QMODES.items():
        for s in (1, 2, 3):
            for k in (1, 3, 5, 7):
                act = acts[n % 4]
                hw = (k + 5 * s + 1, k + 3 * s + 2)
                for cin, cout in ((5, 3), (19, 70), (64, 129)):
                    bias = None if n % 3 == 0 else rnd(cout)
                    wq, ws = quant.quantize_weight(
                        rnd(k, k, cin, cout) / (k * cin ** 0.5), wmode, axis=3)
                    note("merged_conv_q", compare_qkernel(
                        "merged_conv", rnd(2, *hw, cin), wq, ws, bias, s, aq,
                        activation=act))
                    n += 1
                for groups, cin_g, cout_g in DW_CASES:
                    cout = groups * cout_g
                    bias = None if n % 3 == 0 else rnd(cout)
                    wq, ws = quant.quantize_weight(
                        rnd(k, k, cin_g, cout) / k, wmode, axis=3)
                    note("depthwise_conv_q", compare_qkernel(
                        "depthwise_conv", rnd(2, *hw, groups * cin_g), wq, ws,
                        bias, s, aq, groups=groups, activation=act))
                    n += 1
    return worst


def compare_qffn(x, uq, us, vq, vs, act_quant):
    """The quantized merged_ffn op against ``merged_ffn_qref`` on the same
    card inputs: |Δ| ≤ RTOL · (|x| + (|x̂|·|Û|)·|V̂|) + ATOL per output,
    over the dequantized operands; returns (max |Δ|, max |Δ| / scale)."""
    from repro_torch import kernels
    from repro_torch.kernels import quant, ref

    y = kernels.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                              act_quant=act_quant)
    yr = ref.merged_ffn_qref(x, uq, vq, us, vs, act_quant=act_quant)
    scale = x.abs() + (dequantized_input(x, act_quant).abs()
                       @ quant.dequantize(uq, us, axis=1).abs()
                       ) @ quant.dequantize(vq, vs, axis=1).abs()
    return held("merged_ffn quantized", y, yr, scale,
                f"x={tuple(x.shape)} u={tuple(uq.shape)} {uq.dtype} "
                f"act_quant={act_quant}")


#: The quantized merged_ffn's four type pairs (the panel feeding P x the
#: narrow factors): the weight mode and the op's ``act_quant``.
QPAIRS = {"fp32 x int8": ("int8", "none"), "int8 x int8": ("int8", "w8a8"),
          "fp32 x e4m3": ("fp8", "none"), "int8 x e4m3": ("fp8", "w8a8")}


def qffn_sweep(dev):
    """Quantized merged_ffn over modes × M {1,8,37,1024} × D {96,576} ×
    R {24,576}, and each of the four type pairs at RecurrentGemma's
    D 2560 × M {8,1024} × R {24,2560}."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(5)
    worst = [0.0, 0.0, 0]
    cases = [(wmode, aq, m, d, r) for wmode, aq in QMODES.values()
             for m in (1, 8, 37, 1024) for d in (96, 576) for r in (24, 576)]
    cases += [(wmode, aq, m, 2560, r) for wmode, aq in QPAIRS.values()
              for m in (8, 1024) for r in (24, 2560)]
    for wmode, aq, m, d, r in cases:
        x = torch.randn(m, d, generator=g).to(dev)
        uq, us = quant.quantize_weight(
            (torch.randn(d, r, generator=g) / d ** 0.5).to(dev), wmode, axis=1)
        vq, vs = quant.quantize_weight(
            (torch.randn(r, d, generator=g) / r ** 0.5).to(dev), wmode, axis=1)
        err, rel = compare_qffn(x, uq, us, vq, vs, aq)
        worst = [max(worst[0], err), max(worst[1], rel), worst[2] + 1]
    return worst


def quantize_matches_cpu(dev) -> int:
    """``quant.quantize_int8`` on the card gives bitwise the CPU's codes
    and scale for the same fp32 input (per tensor and per channel);
    returns the number of inputs checked."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(6)
    n = 0
    for shape in ((8, 576), (8, 58, 58, 144), (37, 96), (3, 3, 96, 24)):
        x = torch.randn(*shape, generator=g) * 3.0
        for axis in (None, len(shape) - 1):
            q_c, s_c = quant.quantize_int8(x, axis=axis)
            q_d, s_d = quant.quantize_int8(x.to(dev), axis=axis)
            check(torch.equal(q_d.cpu(), q_c) and torch.equal(s_d.cpu(), s_c),
                  f"quantize_int8 {shape} axis={axis}: the card's codes or "
                  "scale differ from the CPU's")
            n += 1
    return n


def kernel_sweep(dev) -> dict:
    import torch
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    acts = [None, "relu", "relu6", "silu"]
    worst = {"merged_conv": [0.0, 0.0, 0], "depthwise_conv": [0.0, 0.0, 0]}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    n = 0
    for s in (1, 2, 3):
        for k in (1, 2, 3, 5, 7, 11):
            act = acts[n % 4]
            hw = (k + 5 * s + 1, k + 3 * s + 2)          # ragged Ho / Wo
            for cin, cout in ((5, 3), (19, 70), (64, 129)):
                bias = None if n % 3 == 0 else rnd(cout)
                note("merged_conv", compare_kernel(
                    "merged_conv", rnd(2, *hw, cin), rnd(k, k, cin, cout)
                    / (k * (cin ** 0.5)), bias, s, activation=act))
                n += 1
            for groups, cin_g, cout_g in DW_CASES:
                cout = groups * cout_g
                bias = None if n % 3 == 0 else rnd(cout)
                note("depthwise_conv", compare_kernel(
                    "depthwise_conv", rnd(2, *hw, groups * cin_g),
                    rnd(k, k, cin_g, cout) / k, bias, s, groups=groups,
                    activation=act))
                n += 1
    return worst


#: merged_conv's instances: (x shape, w shape, stride) that reach each
#: tile (128 x 16 at MobileNetV2's Cin 3 stride-2 stem, Cout 16 and 24
#: and a split 14x14 unit; 128 x 32 at its merged 5x5 unit; 64 x 64 and
#: 128 x 128 at deep 3x3 units), the dense 1x1 panel, the 16-, 8- and
#: 4-byte and the element gathers, element copies of a ragged weight, and
#: split reductions; ``CONV_DEEP`` is deep enough (K = 2^17) that
#: int8 x int8 takes the TF32 instance, not the int8 mma.
CONV_CASES = (((8, 17, 17, 3), (3, 3, 3, 32), 2),
              ((2, 30, 31, 32), (1, 1, 32, 16), 1),
              ((2, 23, 21, 16), (3, 3, 16, 24), 2),
              ((2, 19, 18, 24), (1, 1, 24, 144), 1),
              ((2, 12, 11, 12), (3, 3, 12, 20), 1),
              ((8, 14, 14, 384), (1, 1, 384, 64), 1),
              ((8, 7, 7, 576), (1, 1, 576, 160), 1),
              ((8, 60, 60, 24), (5, 5, 24, 32), 2),
              ((8, 30, 30, 128), (3, 3, 128, 128), 1),
              ((4, 58, 58, 256), (3, 3, 256, 256), 1),
              ((2, 9, 8, 19), (2, 2, 19, 70), 3))
CONV_DEEP = ((1, 1, 3, 2 ** 17), (1, 1, 2 ** 17, 16), 1)


def conv_instance_sweep(dev) -> dict:
    """merged_conv and merged_conv_q (its four type pairs, ``QPAIRS``) over
    ``CONV_CASES`` (and ``CONV_DEEP`` in int8 x int8) against their plain
    versions, each relu6 with a bias; fails unless the plans taken reach
    every instance: each tile, the dense panel, each copy width of each
    operand type, a split reduction, the int8 mma and int8 x int8 in
    TF32."""
    import torch
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(7)
    worst = {"merged_conv": [0.0, 0.0, 0], "merged_conv_q": [0.0, 0.0, 0]}
    seen = set()
    cases = [(c, pair) for c in CONV_CASES for pair in (None, *QPAIRS)]
    cases.append((CONV_DEEP, "int8 x int8"))
    for (xs, ws, st), mode in cases:
        x = torch.randn(*xs, generator=g).to(dev)
        w = (torch.randn(*ws, generator=g) / (ws[0] * ws[2] ** 0.5)).to(dev)
        b = torch.randn(ws[3], generator=g).to(dev)
        if mode is None:
            res = compare_kernel("merged_conv", x, w, b, st,
                                 activation="relu6")
            kind, xk, wk = "merged_conv", x, w
        else:
            wmode, aq = QPAIRS[mode]
            wq, wsc = quant.quantize_weight(w, wmode, axis=3)
            res = compare_qkernel("merged_conv", x, wq, wsc, b, st, aq,
                                  activation="relu6")
            kind, wk = "merged_conv_q", wq
            xk = quant.quantize_int8(x)[0] if aq == "w8a8" else x
        plan = conv_plan(xk, wk, st)
        types = f"{xk.dtype}x{wk.dtype}"
        seen |= {("tile", tuple(plan["tile"])), ("a_vec", str(xk.dtype),
                                                 plan["a_vec"]),
                 ("b_vec", str(wk.dtype), plan["b_vec"]),
                 ("dense", plan["dense"]), ("split", plan["splits"] > 1),
                 ("s8", types, plan["s8"])}
        w_ = worst[kind]
        w_[0], w_[1], w_[2] = max(w_[0], res[0]), max(w_[1], res[1]), w_[2] + 1
    i8 = "torch.int8"
    need = {("tile", t) for t in ((128, 16), (128, 32), (64, 64), (128, 128))}
    need |= {("dense", True), ("split", True), ("s8", f"{i8}x{i8}", True),
             ("s8", f"{i8}x{i8}", False),
             ("s8", f"{i8}xtorch.float8_e4m3fn", False)}
    need |= {("a_vec", "torch.float32", v) for v in (16, 4)}
    need |= {("a_vec", i8, v) for v in (16, 8, 4, 1)}
    need |= {("b_vec", "torch.float32", v) for v in (16, 4)}
    check(need <= seen, f"merged_conv instances not reached: "
          f"{sorted(map(str, need - seen))}")
    return worst


def conv_determinism(dev) -> int:
    """Two calls of merged_conv, fp32 and w8a8, on the same inputs give
    bitwise the same y (the split reductions sum in a fixed order) at
    MobileNetV2 unit shapes: the stem, a 56x56 1x1 unit, and the split
    14x14 and 7x7 units; returns the cases checked."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(11)
    n = 0
    for xs, ws, st in (((8, 226, 226, 3), (3, 3, 3, 32), 2),
                       ((8, 56, 56, 24), (1, 1, 24, 144), 1),
                       ((8, 14, 14, 384), (1, 1, 384, 64), 1),
                       ((8, 7, 7, 576), (1, 1, 576, 160), 1)):
        x = torch.randn(*xs, generator=g).to(dev)
        w = (torch.randn(*ws, generator=g) / ws[2] ** 0.5).to(dev)
        b = torch.randn(ws[3], generator=g).to(dev)
        wq, wsc = quant.quantize_weight(w, "int8", axis=3)
        for kw in ({}, {"w_scale": wsc, "act_quant": "w8a8"}):
            y1, y2 = (kernels.merged_conv_op(
                x, wq if kw else w, b, stride=st, activation="relu6", **kw)
                for _ in range(2))
            torch.cuda.synchronize()
            check(torch.equal(y1, y2), f"merged_conv {xs}x{ws} "
                  f"{'w8a8' if kw else 'fp32'}: two calls on the same inputs "
                  "differ bitwise")
            n += 1
    return n


# ---------------------------------------------------------------------------
# rmsnorm, rglru_scan, flash_attention: sweeps against the plain versions
# ---------------------------------------------------------------------------

def compare_attention(q, k, v, causal):
    """flash_attention kernel vs the plain version on k, v expanded to q's
    heads; the scale is the same softmax applied to |v|, which bounds
    every output."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    return held("flash_attention", kernels.flash_attention_op(q, k, v, causal),
                ops._attention_plain(q, k, v, causal),
                ops._attention_plain(q, k, v.abs(), causal),
                f"q={tuple(q.shape)} kv={tuple(k.shape)} causal={causal}")


def norm_scan_attention_sweep(dev) -> dict:
    """rmsnorm over M {1,8,37,1024} × D {32,512,576,2560,2561}; rglru_scan
    over B {1,8} × S {1,7,128,512} × C {32,256,2560,2561} with a in
    (0.5, 1), also held bitwise; flash_attention over BH {1,8,80} ×
    S {1,7,16,128,256,1000} × D {32,64,256}, causal and not (BH 8 as
    B 2 × H 4 over 2 kv heads, BH 80 as B 8 × H 10 over 1, the MQA of
    RecurrentGemma); ``benchmarks/run.py``'s three shapes; and the
    gradient of ``flash_attention_op`` through the kernel's forward."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(7)
    worst = {k: [0.0, 0.0, 0] for k in ("rmsnorm", "rglru_scan",
                                        "flash_attention")}

    def note(kind, res):
        w = worst[kind]
        w[0], w[1], w[2] = max(w[0], res[0]), max(w[1], res[1]), w[2] + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    for m, d in [(m, d) for m in (1, 8, 37, 1024)
                 for d in (32, 512, 576, 2560, 2561)]:
        x, w = rnd(m, d) * 3.0, rnd(d) * 0.2
        yr = ref.rmsnorm_ref(x, w, 1e-6)
        note("rmsnorm", held("rmsnorm", kernels.rmsnorm_op(x, w, eps=1e-6),
                             yr, yr.abs(), f"x={(m, d)}"))
    scans = [(b, s, c) for b in (1, 8) for s in (1, 7, 128, 512)
             for c in (32, 256, 2560, 2561)] + [(4, 512, 256)]
    for b, s, c in scans:
        a = (torch.rand(b, s, c, generator=g) * 0.5 + 0.5).to(dev)
        x = rnd(b, s, c) * 0.1
        h, hr = kernels.rglru_scan_op(a, x), ref.rglru_scan_ref(a, x)
        note("rglru_scan", held("rglru_scan", h, hr,
                                ref.rglru_scan_ref(a, x.abs()),
                                f"a={(b, s, c)}"))
        check(torch.equal(h, hr), f"rglru_scan {(b, s, c)}: the kernel and "
              "its plain version round alike, yet differ bitwise")
    heads = {1: (1, 1, 1), 8: (2, 4, 2), 80: (8, 10, 1)}
    for bh, (b, h, kvh) in heads.items():
        for s in (1, 7, 16, 128, 256, 1000):
            for d in (32, 64, 256):
                q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
                for causal in (True, False):
                    note("flash_attention", compare_attention(q, k, v, causal))
    q, k, v = (rnd(2, 256, 4, 64) for _ in range(3))      # benchmarks/run.py
    note("flash_attention", compare_attention(q, k, v, True))
    # the gradient: the op's backward is the plain version's, recomputed
    q, k, v, w = (rnd(2, 19, 2, 64) for _ in range(4))
    grads = []
    for fn in (lambda *t: kernels.flash_attention_op(*t, True),
               lambda *t: ref.flash_attention_ref(*t, causal=True)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*args) * w).sum().backward()
        grads.append([t.grad for t in args])
    for name, got, want in zip("qkv", *grads):
        note("flash_attention", held(
            "flash_attention", got, want, want.abs().amax(),
            f"gradient wrt {name}"))
    return worst


# ---------------------------------------------------------------------------
# Main-path unit shapes, timing and bounds
# ---------------------------------------------------------------------------

def unit_inputs(graph, batch: int, hw: int, cin: int):
    """(unit, padded input shape) of every conv unit of a CNN graph."""
    h = w = hw
    c = cin
    saved = {0: (h, w, c)}
    out = []
    for u in graph.units:
        if u.kind == "conv":
            K = u.params["w"].shape[0]
            out.append((u, (batch, h + K - 1, w + K - 1, c)))
            h, w = -(-h // u.stride), -(-w // u.stride)
            c = u.params["w"].shape[3]
        elif u.kind == "pool":
            h, w = -(-h // u.stride), -(-w // u.stride)
        elif u.kind == "upsample":
            h, w = h * u.factor, w * u.factor
        if getattr(u, "concat_from", None) is not None:
            c += saved[u.concat_from][2]
        if u.save_at is not None:
            saved[u.save_at] = (h, w, c)
    return out


def conv_plan(x, w, stride) -> dict:
    """The launch plan merged_conv takes for these operands (the wrapper's
    own arithmetic), as the JSON rows record it."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_conv as mc_mod
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    codes = (0, 0) if w.dtype == torch.float32 else (
        cuda_build.X_TYPES[x.dtype], cuda_build.W_TYPES[w.dtype])
    plan = mc_mod.launch_plan(
        n, h, wd, cin, kh, kw, cout, stride, *codes,
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
        cuda_build.sm_count(x.device))
    return {"tile": [plan.bm, plan.bn], "splits": plan.splits,
            "k_chunk": plan.k_chunk, "a_vec": plan.a_vec,
            "b_vec": plan.b_vec, "dense": plan.dense, "s8": plan.s8,
            "blocks": plan.blocks}


def time_main_path_kernels(graph, dev, batch: int, plain: bool = True,
                           label: str = "") -> dict:
    """Per-kernel sums over a CNN graph's conv units (worst error, kernel /
    plain / library milliseconds, FLOPs, bytes and bound) and, under
    ``rows``, each unit's shapes, times, bound, share and (merged_conv)
    the launch plan it took.  merged_conv's operations are priced at
    3xTF32 (``TC_RATES``), depthwise_conv's at the fp32 FFMA rate.
    ``plain=False`` leaves out the plain versions' times."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(1)
    rates = {"merged_conv": (TC_RATES["fp32", "fp32"][0],
                             tc_rate_label(("fp32", "fp32"))),
             "depthwise_conv": (H100_FP32_FLOPS, FFMA_RATE)}
    tot = {k: {"units": 0, "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "flops_ms": 0.0, "bound_rate": rates[k][1], "rows": []}
           for k in ("merged_conv", "depthwise_conv")}
    for u, shape in unit_inputs(graph, batch, 224, 3):
        x = torch.randn(*shape, generator=g).to(dev)
        w, b, s = u.params["w"], u.params["b"], u.stride
        kh, kw, cin_g, cout = w.shape
        groups = shape[3] // cin_g if u.depthwise else 1
        kind = "depthwise_conv" if u.depthwise else "merged_conv"
        err, rel = compare_kernel(kind, x, w, b, s, groups=groups)
        if u.depthwise:
            def run():
                return kernels.depthwise_conv_op(x, w, b, stride=s,
                                                 groups=groups)

            def plain_fn():
                return ref.depthwise_conv_ref(x, w, b, stride=s,
                                              groups=groups)
        else:
            def run():
                return kernels.merged_conv_op(x, w, b, stride=s)

            def plain_fn():
                return ref.merged_conv_ref(x, w, b, stride=s)
        x_cl = x.permute(0, 3, 1, 2)              # NHWC viewed channels_last
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(x_cl, w_oihw, b, stride=s, groups=groups)
        n, hp, wp, _ = shape
        ho, wo = (hp - kh) // s + 1, (wp - kw) // s + 1
        flops = 2.0 * n * ho * wo * cout * kh * kw * cin_g
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + n * ho * wo * cout)
        f_ms = flops / rates[kind][0] * 1e3
        b_ms = nbytes / H100_HBM_BW * 1e3
        row = {"x": list(shape), "w": list(w.shape), "stride": s,
               "ms": kernel_time(run),
               "plain_ms": kernel_time(plain_fn) if plain else None,
               "library_ms": kernel_time(library), "flops_ms": f_ms,
               "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
               "max_abs_err": err}
        row["share"] = row["bound_ms"] / row["ms"]
        if not u.depthwise:
            row["plan"] = conv_plan(x, w, s)
        check_bound(f"{label}{kind} {tuple(shape)}x{tuple(w.shape)}",
                    row["ms"], row["bound_ms"])
        t = tot[kind]
        for k in ("ms", "plain_ms", "library_ms", "flops_ms", "bytes_ms",
                  "bound_ms"):
            t[k] += row[k] or 0.0
        t["flops"] += flops
        t["bytes"] += nbytes
        t["units"] += 1
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["max_rel_err"] = max(t["max_rel_err"], rel)
        t["rows"].append(row)
    return tot


def device_kernels(fn, reps: int = 5):
    """(device µs per call, [(µs per call, launches per call, name)]) of
    the kernels ``fn`` runs, from a torch.profiler trace of ``reps``
    calls; (0.0, []) where the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us / reps, n // reps, name)
                   for name, (us, n) in by_name.items()), reverse=True)
    return sum(r[0] for r in rows), rows


# ---------------------------------------------------------------------------
# merged_ffn: sweep, main-path shapes, the transformer path
# ---------------------------------------------------------------------------

def compare_ffn(x, u, v):
    """merged_ffn kernel vs ``merged_ffn_ref`` on the same card inputs:
    |Δ| ≤ RTOL · (|x| + (|x|·|U|)·|V|) + ATOL per output; returns
    (max |Δ|, max |Δ| / scale)."""
    from repro_torch import kernels
    from repro_torch.kernels import ref

    return held("merged_ffn", kernels.merged_ffn_op(x, u, v),
                ref.merged_ffn_ref(x, u, v),
                ref.merged_ffn_ref(x.abs(), u.abs(), v.abs()),
                f"x={tuple(x.shape)} u={tuple(u.shape)}")


def ffn_sweep(dev):
    """merged_ffn against its plain version over ragged M, D and R; at
    RecurrentGemma's D = 2560 with R 24, 2560 (a merged unit) and 7680
    (the replaced path's unmerged FFN) at M 8 and 1024; at D 2561 (rows
    not 16-byte aligned: the element-wise copies) over M {1, 8, 63, 64,
    65, 129, 1024}, across the small / large tile boundary, with R 24 and
    2560, and R 7680 at M 8."""
    import torch
    g = torch.Generator().manual_seed(2)
    worst = [0.0, 0.0, 0]
    cases = [(m, d, r) for m in (1, 8, 37, 1024) for d in (32, 96, 576)
             for r in (1, 24, 576, 1152, 1536)]
    cases += [(m, 2560, r) for m in (8, 1024) for r in (24, 2560, 7680)]
    cases += [(m, 2561, r) for m in (1, 8, 63, 64, 65, 129, 1024)
              for r in (24, 2560)] + [(8, 2561, 7680)]
    for m, d, r in cases:
        x = torch.randn(m, d, generator=g).to(dev)
        u = (torch.randn(d, r, generator=g) / d ** 0.5).to(dev)
        v = (torch.randn(r, d, generator=g) / r ** 0.5).to(dev)
        err, rel = compare_ffn(x, u, v)
        worst = [max(worst[0], err), max(worst[1], rel), worst[2] + 1]
    return worst


def ffn_bound(m: int, d: int, r: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of x + (x@U)@V in fp32: 4·M·D·R FLOPs at
    the 3xTF32 rate; x, U, V read once and y written once at the HBM rate
    (P is not counted: the function does not need it)."""
    flops = 4.0 * m * d * r
    nbytes = 4.0 * (2 * m * d + 2 * d * r)
    return (flops / TC_RATES["fp32", "fp32"][0] * 1e3,
            nbytes / H100_HBM_BW * 1e3)


def tc_rate_label(*pairs) -> str:
    """The rate(s) a merged_ffn row's operations are priced at."""
    return ", ".join(
        f"{TC_RATES[p][1]} {TC_RATES[p][0] / 1e12:.6g} "
        + ("TOP/s" if TC_RATES[p][1] == "int8" else "TFLOP/s")
        for p in pairs)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per eager call of ``fn``: the time to enqueue
    ``calls`` calls, the device left to catch up afterwards."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def host_split(x, u, v) -> dict:
    """Host microseconds of one eager merged_ffn call at each layer: the op
    (reshapes and the wrapper), the wrapper (checks, plan, the output and
    workspace allocations, the launch), ``cuda_build.launch`` and the bare
    C call (its two kernel launches)."""
    from repro_torch import kernels
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_ffn as mf_mod
    import torch
    m, d = x.shape
    r = u.shape[1]
    plan = mf_mod.launch_plan(m, d, r, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    y, p = kernels.merged_ffn_op(x, u, v), x.new_empty(plan.workspace)
    args = (x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(),
            p.data_ptr(), m, d, r, *plan.args())
    fn = cuda_build.kernel("merged_ffn")
    stream = torch.cuda.current_stream().cuda_stream
    return {"op": host_us(lambda: kernels.merged_ffn_op(x, u, v)),
            "wrapper": host_us(lambda: mf_mod.merged_ffn(x, u, v)),
            "launch": host_us(lambda: cuda_build.launch(
                "merged_ffn", x.device, *args)),
            "c_call": host_us(lambda: fn(*args, stream))}


def ffn_slots() -> tuple[dict, bool]:
    """Blocks of each merged_ffn tile resident at once by cluster size (1
    up to its most splits), as this card reports them
    (``cudaOccupancyMaxActiveClusters``), and whether they are the launch
    plan's model of an H100 (``merged_ffn.H100_SLOTS``; another SM count
    takes the generic model, so it is not compared)."""
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import merged_ffn as mf_mod
    fn = cuda_build.kernel("merged_ffn_slots")
    out = {}
    for name, tile in (("small", mf_mod.SMALL), ("large", mf_mod.LARGE)):
        got = [fn(tile[0], tile[1], s) for s in range(1, tile[3] + 1)]
        check(min(got) > 0, f"merged_ffn_slots {name}: error {-min(got)}")
        out[name] = got
    same = (torch.cuda.get_device_properties(0).multi_processor_count != 132
            or all(tuple(out[n]) == mf_mod.H100_SLOTS[t] for n, t in
                   (("small", mf_mod.SMALL), ("large", mf_mod.LARGE))))
    return out, same


def ffn_determinism(dev) -> int:
    """Two calls of merged_ffn on the same inputs give bitwise the same y
    (the split reductions sum in a fixed order): a D 2560 unit at M 8 (the
    decode splits) and at M 1024; returns the cases checked."""
    import torch
    from repro_torch import kernels
    g = torch.Generator().manual_seed(9)
    for m in (8, 1024):
        x = torch.randn(m, 2560, generator=g).to(dev)
        u = (torch.randn(2560, 2560, generator=g) / 2560 ** 0.5).to(dev)
        v = (torch.randn(2560, 2560, generator=g) / 2560 ** 0.5).to(dev)
        y1, y2 = kernels.merged_ffn_op(x, u, v), kernels.merged_ffn_op(x, u, v)
        torch.cuda.synchronize()
        check(torch.equal(y1, y2), f"merged_ffn {(m, 2560, 2560)}: two "
              "calls on the same inputs differ bitwise")
    return 2


def attn_dw_determinism(dev) -> int:
    """Two calls of flash_attention (the path's four shapes) and of
    depthwise_conv, fp32 and w8a8 (three MobileNetV2 units), on the same
    inputs give bitwise the same output (every sum in a fixed order);
    returns the cases checked."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(10)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    n = 0
    for b, s, h, kvh, d in ((8, 128, 10, 1, 256), (8, 16, 10, 1, 256),
                            (8, 128, 9, 3, 64), (8, 16, 9, 3, 64)):
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        o1, o2 = (kernels.flash_attention_op(q, k, v, True)
                  for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(o1, o2), f"flash_attention {(b, s, h, kvh, d)}: "
              "two calls on the same inputs differ bitwise")
        n += 1
    for hw, c, s in ((112, 32, 1), (28, 192, 2), (7, 960, 1)):
        x, w, b = rnd(8, hw + 2, hw + 2, c), rnd(3, 3, 1, c) / 3, rnd(c)
        wq, ws = quant.quantize_weight(w, "int8", axis=3)
        for kw in ({}, {"w_scale": ws, "act_quant": "w8a8"}):
            y1, y2 = (kernels.depthwise_conv_op(
                x, wq if kw else w, b, stride=s, groups=c,
                activation="relu6", **kw) for _ in range(2))
            torch.cuda.synchronize()
            check(torch.equal(y1, y2), f"depthwise_conv {(hw, c, s)} "
                  f"{'w8a8' if kw else 'fp32'}: two calls on the same inputs "
                  "differ bitwise")
            n += 1
    return n


def time_ffn(x, u, v) -> dict:
    """Kernel, plain and library ms of one merged_ffn shape, beside its
    bound.  The library yardstick is ``torch.addmm(x, x @ U, V)``: two
    cuBLAS calls (TF32 off), timed here and used nowhere in the port."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref

    err, rel = compare_ffn(x, u, v)
    f_ms, b_ms = ffn_bound(x.shape[0], x.shape[1], u.shape[1])
    row = {"m": x.shape[0], "d": x.shape[1], "r": u.shape[1],
           "max_abs_err": err, "max_rel_err": rel,
           "ms": kernel_time(lambda: kernels.merged_ffn_op(x, u, v)),
           "plain_ms": kernel_time(lambda: ref.merged_ffn_ref(x, u, v)),
           "library_ms": kernel_time(lambda: torch.addmm(x, x @ u, v)),
           "eager_ms": cuda_time(lambda: kernels.merged_ffn_op(x, u, v)),
           "host_us": host_us(lambda: kernels.merged_ffn_op(x, u, v)),
           "flops_ms": f_ms, "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
           "bound_rate": tc_rate_label(("fp32", "fp32"))}
    check_bound(f"merged_ffn {tuple(x.shape)}x{tuple(u.shape)}", row["ms"],
                row["bound_ms"])
    return row


def forced_logits(step, cache, tokens):
    """``(B, T, V)`` logits of feeding ``tokens`` (B, T) one at a time."""
    import torch
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(cache, tokens[:, t:t + 1])
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


class CountCalls:
    """Counts the calls of the method ``owner.name`` while active (it is
    wrapped): CUDA-graph replays, the engine's chunks."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.n = 0
        self._orig = orig = getattr(self.owner, self.name)

        def counted(*args, **kw):
            self.n += 1
            return orig(*args, **kw)
        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)


def serve_both(label, step, new_cache, prompt, new_tokens, pertoken=None):
    """Serve ``prompt`` through the captured ``serve_loop`` and, on the
    same step, through ``serve_loop_pertoken`` (inside the context
    ``pertoken``, when given): the two must give the same tokens, the
    captured loop one graph replay per prompt position and per generated
    token, and a decode no slower than the per-token loop's.  Then one
    more capture of the same step gives the capture's seconds, the
    launches it counted (one step's) and, from a torch.profiler trace of
    its decode replays, the device-busy share of the captured decode."""
    import contextlib

    import torch
    from repro_torch.runtime import serving

    B, P = prompt.shape
    N = new_tokens
    with CountCalls(torch.cuda.CUDAGraph, "replay") as rp:
        pre, dec, lg, seqs = serving.serve_loop(step, new_cache, prompt, N)
    with pertoken or contextlib.nullcontext():
        pre_pt, dec_pt, lg_pt, seqs_pt = serving.serve_loop_pertoken(
            step, new_cache, prompt, N)
    steps = P + N - 1
    run = serving._StepGraph(step, new_cache(), B, steps)
    lengths = torch.full((B,), P)
    run.prepare(prompt, lengths)
    run.reset(prompt, lengths)
    run.advance(P + 1)
    busy_us, rows = device_kernels(lambda: run.advance(1), reps=N - 3)
    res = {"prefill_ms": pre * 1e3, "decode_ms": dec * 1e3,
           "tok_s": serving.decode_tok_s(N - 1, B, dec),
           "pertoken_prefill_ms": pre_pt * 1e3,
           "pertoken_decode_ms": dec_pt * 1e3,
           "pertoken_tok_s": serving.decode_tok_s(N - 1, B, dec_pt),
           "replays_per_token": rp.n / (2 * steps),
           "capture_s": run.capture_s, "launches_per_step": run.launches,
           "busy_us": busy_us, "busy_share": busy_us * 1e-6 / (dec / (N - 1)),
           "logits_vs_pertoken": rel_diff(lg, lg_pt),
           "logits_bitwise": bool(torch.equal(lg, lg_pt))}
    print(f"  {label}: captured prefill {res['prefill_ms']:.3f} ms, decode "
          f"{res['decode_ms']:.3f} ms ({res['tok_s']:.1f} tok/s); per-token "
          f"prefill {res['pertoken_prefill_ms']:.3f} ms, decode "
          f"{res['pertoken_decode_ms']:.3f} ms ({res['pertoken_tok_s']:.1f} "
          f"tok/s); {res['tok_s'] / res['pertoken_tok_s']:.3f}x; capture "
          f"{res['capture_s']:.3f}s; graph replays per prompt position and "
          f"generated token {res['replays_per_token']:.3f}; launches per "
          f"step (counted at the capture) {json.dumps(run.launches)}; "
          f"captured decode, torch.profiler: device busy {busy_us:.1f} us "
          f"per step = {res['busy_share']:.3f} of its served step; by "
          "kernel: " + ("; ".join(f"{name[:60]} {us:.1f}us x{n}"
                                  for us, n, name in rows[:6])
                        or "no device activity seen")
          + f"; last prefill logits captured vs per-token "
          f"{res['logits_vs_pertoken']:.3g} (bitwise "
          f"{res['logits_bitwise']})", flush=True)
    check(bool(torch.equal(seqs, seqs_pt)), f"{label}: the captured and the "
          "per-token loop give different tokens")
    check(rp.n == 2 * steps, f"{label}: {rp.n} graph replays for 2 x "
          f"{steps} steps")
    check(res["decode_ms"] <= res["pertoken_decode_ms"], f"{label}: the "
          f"captured decode ({res['decode_ms']:.3f} ms) is slower than the "
          f"per-token loop's ({res['pertoken_decode_ms']:.3f} ms)")
    return pre, dec, lg, seqs, res


def unit_census(graph) -> str:
    from repro_torch import runtime
    return json.dumps(runtime.count_units(graph), sort_keys=True)


# ---------------------------------------------------------------------------
# The quantized path: captured units, bounds, timing
# ---------------------------------------------------------------------------

class QuantCalls:
    """Records every quantized op call the executor makes while active
    (the package attributes it calls through are wrapped), with its
    arguments and output, so that each quantized unit can be checked and
    timed on the input it had on the main path."""

    NAMES = ("merged_conv_op", "depthwise_conv_op", "merged_ffn_op")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch import kernels
        self._orig = {n: getattr(kernels, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(kernels, n, self._wrap(n, self._orig[n]))
        return self

    def _wrap(self, name, fn):
        def op(*args, **kw):
            y = fn(*args, **kw)
            if kw.get("w_scale") is not None or kw.get("u_scale") is not None:
                self.calls.append((name, args, kw, y))
            return y
        return op

    def __exit__(self, *exc):
        from repro_torch import kernels
        for n, fn in self._orig.items():
            setattr(kernels, n, fn)


class ActCodes:
    """While active, records the per-tensor int8 activation codes and
    scales that ``quant.quantize_int8`` gives (w8a8 units), or — given a
    record — replays them in the same order in place of the codes it
    computes, counting the codes that differ (``flips``): a CPU run of an
    artifact fed the card's activation codes computes what the card did,
    up to fp32 reassociation."""

    def __init__(self, replay=None):
        self.codes = [] if replay is None else replay
        self.replay = replay is not None
        self.used = self.flips = self.total = 0

    def __enter__(self):
        from repro_torch.kernels import quant
        self._orig = orig = quant.quantize_int8

        def quantize_int8(x, axis=None):
            q, s = orig(x, axis)
            if axis is not None:                     # a weight's channels
                return q, s
            if not self.replay:
                self.codes.append((q.cpu(), s.cpu()))
                return q, s
            qr, sr = self.codes[self.used]
            self.used += 1
            # (the card's op flattens leading axes, the plain version not)
            check(qr.numel() == q.numel(), "replayed activation codes out "
                  "of step with the run")
            qr = qr.reshape(q.shape)
            self.flips += int((qr != q.cpu()).sum())
            self.total += q.numel()
            return qr.to(q.device), sr.to(s.device)
        quant.quantize_int8 = quantize_int8
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import quant
        quant.quantize_int8 = self._orig


def act_unquantized(art):
    """``art`` with its w8a8 units run as int8 ones (narrow weights, fp32
    activations): the same network without activation rounding."""
    import dataclasses
    units = tuple(dataclasses.replace(u, quant="int8")
                  if getattr(u, "quant", "none") == "w8a8" else u
                  for u in art.graph.units)
    return dataclasses.replace(art, graph=dataclasses.replace(
        art.graph, units=units))


def rel_diff(a, b) -> float:
    """max |a − b| / max |b|, on the CPU."""
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max() / b.abs().max())


def conv_call_parts(name, args, kw):
    """(kind, x, wq, ws, b, stride, groups, act_quant) of a recorded conv
    op call (the executor passes x, w, b positionally)."""
    x, wq, b = args
    kind = "depthwise_conv" if name == "depthwise_conv_op" else "merged_conv"
    groups = x.shape[-1] // wq.shape[2] if kind == "depthwise_conv" else 1
    return (kind, x, wq, kw["w_scale"], b, kw.get("stride", 1), groups,
            kw.get("act_quant", "none"))


def time_qconv(kind, x, wq, ws, b, stride, groups, aq) -> dict:
    """One quantized conv unit at its main-path shape: the kernel alone
    (on the codes and folded scale the op computes), the eager activation
    quantization pass, the whole op, the fp32 kernel on the dequantized
    weight, the plain version, and the library yardstick (one ``F.conv2d``
    on the dequantized operands: no PyTorch call takes int8 weights with a
    channel-scale epilogue), beside the bound at narrow widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import depthwise_conv as dw_mod
    from repro_torch.kernels import merged_conv as mc_mod
    from repro_torch.kernels import quant, ref

    xq, folded = x, ws
    if aq == "w8a8":
        xq, xs = quant.quantize_int8(x)
        folded = (ws * xs).contiguous()
    wd = quant.dequantize(wq, ws, axis=3)
    xd = dequantized_input(x, aq)
    if kind == "depthwise_conv":
        def run():
            return dw_mod.depthwise_conv(xq, wq, b, stride=stride,
                                         groups=groups, w_scale=folded)

        def op():
            return kernels.depthwise_conv_op(x, wq, b, stride=stride,
                                             groups=groups, w_scale=ws,
                                             act_quant=aq)

        def fp32():
            return kernels.depthwise_conv_op(x, wd, b, stride=stride,
                                             groups=groups)

        def plain():
            return ref.depthwise_conv_qref(x, wq, b, ws, stride=stride,
                                           groups=groups, act_quant=aq)
    else:
        def run():
            return mc_mod.merged_conv(xq, wq, b, stride=stride,
                                      w_scale=folded)

        def op():
            return kernels.merged_conv_op(x, wq, b, stride=stride,
                                          w_scale=ws, act_quant=aq)

        def fp32():
            return kernels.merged_conv_op(x, wd, b, stride=stride)

        def plain():
            return ref.merged_conv_qref(x, wq, b, ws, stride=stride,
                                        act_quant=aq)
    x_cl = xd.permute(0, 3, 1, 2)
    w_oihw = wd.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def library():
        return F.conv2d(x_cl, w_oihw, b, stride=stride, groups=groups)
    n, hp, wp, _ = x.shape
    kh, kw, cin_g, cout = wq.shape
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    flops = 2.0 * n * ho * wo * cout * kh * kw * cin_g
    nbytes = (x.numel() * (1 if aq == "w8a8" else 4) + wq.numel()
              + 4.0 * (ws.numel() + (0 if b is None else b.numel()))
              + 4.0 * n * ho * wo * cout)
    if kind == "merged_conv":
        # priced at the tensor-core rate of the instance's operand types
        pair = (("int8", "int8" if wq.dtype == torch.int8 else "e4m3")
                if aq == "w8a8" else ("fp32", "narrow"))
        rate, rate_label = TC_RATES[pair][0], tc_rate_label(pair)
    else:
        rate, rate_label = H100_FP32_FLOPS, FFMA_RATE
    out = {"kind": kind, "x": list(x.shape), "w": list(wq.shape),
           "w_dtype": str(wq.dtype), "stride": stride, "act_quant": aq,
           "ms": kernel_time(run), "plain_ms": kernel_time(plain),
           "library_ms": kernel_time(library), "fp32_ms": kernel_time(fp32),
           "op_ms": kernel_time(op),
           "qpass_ms": (kernel_time(lambda: quant.quantize_int8(x))
                        if aq == "w8a8" else 0.0),
           "flops_ms": flops / rate * 1e3,
           "bytes_ms": nbytes / H100_HBM_BW * 1e3, "bound_rate": rate_label}
    out["bound_ms"] = max(out["flops_ms"], out["bytes_ms"])
    out["share"] = out["bound_ms"] / out["ms"]
    if kind == "merged_conv":
        out["plan"] = conv_plan(xq, wq, stride)
    return out


def time_qffn(x, uq, us, vq, vs, aq) -> dict:
    """One quantized merged_ffn unit at M = x.shape[0]: the kernel alone,
    the activation quantization pass, the whole op, the fp32 kernel on the
    dequantized factors, the plain version and ``torch.addmm(x, x̂ @ Û,
    V̂)`` on the dequantized operands (two cuBLAS calls), beside the
    bound at narrow widths."""
    from repro_torch import kernels
    from repro_torch.kernels import merged_ffn as mf_mod
    from repro_torch.kernels import quant, ref
    import torch

    xq, folded = None, us
    if aq == "w8a8":
        xq, xs = quant.quantize_int8(x)
        folded = (us * xs).contiguous()
    ud, vd = quant.dequantize(uq, us, axis=1), quant.dequantize(vq, vs, axis=1)
    xd = dequantized_input(x, aq)
    err, rel = compare_qffn(x, uq, us, vq, vs, aq)
    m, d = x.shape
    r = uq.shape[1]
    nbytes = (4.0 * 2 * m * d + (m * d if aq == "w8a8" else 0)
              + uq.numel() + vq.numel() + 4.0 * (r + d))
    # phase A: the panel x U, phase B: fp32 P x V
    pair_a = (("int8", "int8" if uq.dtype == torch.int8 else "e4m3")
              if aq == "w8a8" else ("fp32", "narrow"))
    pair_b = ("fp32", "narrow")
    flops_ms = sum(2.0 * m * d * r / TC_RATES[p][0] * 1e3
                   for p in (pair_a, pair_b))
    out = {"m": m, "d": d, "r": r, "w_dtype": str(uq.dtype), "act_quant": aq,
           "max_abs_err": err, "max_rel_err": rel,
           "ms": kernel_time(lambda: mf_mod.merged_ffn(
               x, uq, vq, u_scale=folded, v_scale=vs, xq=xq)),
           "op_ms": kernel_time(lambda: kernels.merged_ffn_op(
               x, uq, vq, u_scale=us, v_scale=vs, act_quant=aq)),
           "qpass_ms": (kernel_time(lambda: quant.quantize_int8(x))
                        if aq == "w8a8" else 0.0),
           "fp32_ms": kernel_time(lambda: kernels.merged_ffn_op(x, ud, vd)),
           "plain_ms": kernel_time(lambda: ref.merged_ffn_qref(
               x, uq, vq, us, vs, act_quant=aq)),
           "library_ms": kernel_time(lambda: torch.addmm(x, xd @ ud, vd)),
           "flops_ms": flops_ms, "bytes_ms": nbytes / H100_HBM_BW * 1e3,
           "bound_rate": tc_rate_label(pair_a, pair_b)}
    out["bound_ms"] = max(out["flops_ms"], out["bytes_ms"])
    return out


def cnn_quant_phases(compress_main, cnn_argv, oracle, host, batches,
                     orig_graph, dev, out_shape):
    """Phases 11-12: the w8a8 MobileNetV2 path (compress through the CLI
    with phase 4's oracle, artifact, served batches held against the CPU
    port and the plan's fp lowering), then each quantized unit checked and
    timed at its card input.  Returns (totals by kernel, launches)."""
    import torch
    from repro_torch import kernels, runtime

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    q_path = os.path.join(WORK, "mobilenetv2_w8a8.npz")
    ladder = []
    for ratio in Q_BUDGETS:
        summary = compress_main(cnn_argv + [
            "--budget-ratio", str(ratio), "--quantize", "w8a8", "--out",
            q_path], latency_oracle=oracle)
        art = runtime.load(q_path, device=dev)
        census = quant_census(art.graph)
        ladder.append(f"{ratio}: {json.dumps(census, sort_keys=True)}, "
                      f"predicted {summary['predicted_speedup']:.4f}")
        if census.get("conv_w8a8") and census.get("dwconv_w8a8"):
            break
    check(bool(census.get("conv_w8a8") and census.get("dwconv_w8a8")),
          f"w8a8: no budget in {Q_BUDGETS} gives a plan with a quantized "
          f"dense and depthwise unit ({'; '.join(ladder)})")
    with QuantCalls() as qcalls, ActCodes() as codes:
        outs = [art.apply(xb.to(dev)) for xb in batches]
        torch.cuda.synchronize()
    launch = kernels.launch_counts()
    art_cpu = runtime.load(q_path, device="cpu")
    fp_graph = host.lower_plan(fp_plan(art.plan))
    d_cpu = d_rep = d_act = d_fp = 0.0
    with ActCodes(codes.codes) as replay:
        rep_outs = [art_cpu.apply(xb) for xb in batches]
    for xb, y, y_rep in zip(batches, outs, rep_outs):
        check(tuple(y.shape) == out_shape and bool(torch.isfinite(y).all()),
              f"quantized network: logits {tuple(y.shape)} or non-finite")
        y_cpu = art_cpu.apply(xb)
        d_cpu = max(d_cpu, rel_diff(y, y_cpu))
        d_rep = max(d_rep, rel_diff(y, y_rep))
        d_act = max(d_act, rel_diff(y_cpu, act_unquantized(art_cpu).apply(xb)))
        d_fp = max(d_fp, rel_diff(y, runtime.execute(fp_graph, xb.to(dev),
                                                     device=dev)))
    n_fwd = len(qcalls.calls) // len(batches)
    parts = [conv_call_parts(name, args, kw)
             for name, args, kw, _ in qcalls.calls[:n_fwd]]
    bound = NET_RTOL + 2.0 * d_act
    xb = batches[0].to(dev)
    ms_q = cuda_time(lambda: art.apply(xb), iters=20)
    ms_fp = cuda_time(lambda: runtime.execute(fp_graph, xb, device=dev),
                      iters=20)
    ms_o = cuda_time(lambda: runtime.execute(orig_graph, xb, device=dev),
                     iters=20)
    log("q serve", t0, f"w8a8 budgets {'; '.join(ladder)}; census "
        f"{json.dumps(census, sort_keys=True)}; {len(batches)} batches, "
        f"worst logits vs CPU port {d_cpu:.3g} (bound {bound:.3g}: "
        f"{NET_RTOL} + 2 x {d_act:.3g}, the CPU port's activation rounding;"
        f" {replay.flips} of {replay.total} activation codes differ), vs "
        f"the CPU port fed the card's codes {d_rep:.3g} (limit {NET_RTOL}),"
        f" vs the fp lowering of the plan {d_fp:.3g} (limit {Q_FP_RTOL}); "
        f"forward quantized "
        f"{ms_q:.3f} ms, fp plan {ms_fp:.3f} ms, original {ms_o:.3f} ms "
        f"(measured {ms_o / ms_q:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x); launches phase 11 {launch}")
    print_profile("quantized forward", art.apply, xb, ms_q)
    check(d_cpu <= bound, f"quantized network: card vs CPU port differ by "
          f"{d_cpu} > {bound}")
    check(replay.used == len(codes.codes) and d_rep <= NET_RTOL,
          f"quantized network: card vs CPU port on the card's activation "
          f"codes differ by {d_rep} > {NET_RTOL}")
    check(d_fp < Q_FP_RTOL, f"quantized network: vs fp lowering {d_fp} >= "
          f"{Q_FP_RTOL}")
    for k in ("merged_conv_q", "depthwise_conv_q"):
        check(launch[k] > 0, f"kernel {k} never launched on the quantized "
              "path")

    # 12. each quantized unit of one forward, at its card input
    t0 = time.perf_counter()
    units = []
    for kind, x, wq, ws, b, st, g, aq in parts:
        err, rel = compare_qkernel(kind, x, wq, ws, b, st, aq, groups=g)
        units.append(dict(time_qconv(kind, x, wq, ws, b, st, g, aq),
                          max_abs_err=err, max_rel_err=rel))
    tot = {}
    for k, kind in (("merged_conv_q", "merged_conv"),
                    ("depthwise_conv_q", "depthwise_conv")):
        rows = [r for r in units if r["kind"] == kind]
        tot[k] = {f: sum(r[f] for r in rows) for f in Q_FIELDS}
        tot[k]["units"] = len(rows)
        tot[k]["max_abs_err"] = max((r["max_abs_err"] for r in rows),
                                    default=0.0)
        tot[k]["bound_rate"] = "; ".join(sorted({r["bound_rate"]
                                                 for r in rows}))
        for r in rows:
            check_bound(f"{k} {tuple(r['x'])}x{tuple(r['w'])}", r["ms"],
                        r["bound_ms"])
    with open(os.path.join(WORK, "qunits.json"), "w") as f:
        json.dump(units, f, indent=1)
    log("quantized conv units", t0, " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} (fp32 kernel "
        f"{v['fp32_ms']:.4f}; activation quantization {v['qpass_ms']:.4f}; "
        f"op {v['op_ms']:.4f}) plain={v['plain_ms']:.4f} "
        f"library(F.conv2d, dequantized)={v['library_ms']:.4f} "
        f"bound={v['bound_ms']:.4f} max|Δ|={v['max_abs_err']:.3g};"
        for k, v in tot.items()))
    return tot, launch


def lm_quant_phases(host, fp_res, oracle, lm_source, prompt, new_tokens,
                    fp_decode_s, dev):
    """Phases 13-14: the w8a8 transformer path under the decode-shaped
    ``CostEnv(batch=B, seq=1)`` (depth ladder; phase 8's plan with its
    lowrank segments set to w8a8 if the DP picks no w8a8 unit), the v3
    artifact served and held against the CPU port step by step, then each
    quantized merged_ffn unit timed at decode.  Returns (decode-step
    totals, launches, the serving numbers of :func:`serve_both`)."""
    import dataclasses

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.core import compress
    from repro_torch.core.tables import build_tables, quant_sibling_entries
    from repro_torch.kernels import merged_ffn as mf_mod
    from repro_torch.kernels import quant
    from repro_torch.models.transformer_host import CostEnv, TransformerHost
    from repro_torch.runtime import serving

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    B, P = prompt.shape
    N = new_tokens
    cfg = host.cfg
    sib_fp = quant_sibling_entries(host, fp_res.tables.entries, "w8a8")[1]
    host_q = TransformerHost(cfg, host.params, env=CostEnv(batch=B, seq=1),
                             device=dev)
    wide, sib = quant_sibling_entries(host_q, build_tables(
        host_q, method="depth", latency_oracle=oracle).entries, "w8a8")
    ratios = [row[k][1] / row[k[0]][1] for row in wide.values()
              for k in row if isinstance(k, tuple)]
    res, ladder = None, []
    for ratio in LM_BUDGETS:
        r = compress(host_q, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle, quantize="w8a8")
        n_q = 0 if r is None else quant_census(r.lower()).get(
            "lowrank_w8a8", 0)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_q} w8a8 lowrank, predicted "
                                      f"{r.speedup:.4f}"))
        if n_q:
            res = r
            break
    if res is not None:
        plan, chosen = res.plan, f"chosen by the DP, predicted " \
            f"{res.speedup:.4f}"
    else:
        # The DP picked no w8a8 unit: serve phase 8's plan with its lowrank
        # segments set to w8a8 (a plan is data; lower_plan takes it).
        # (a segment has a merged rank map where it has a quantized cost)
        plan = dataclasses.replace(fp_res.plan, segments=tuple(
            dataclasses.replace(sg, quant="w8a8")
            if host_q.segment_cost(sg, quant="w8a8") is not None else sg
            for sg in fp_res.plan.segments))
        chosen = "not chosen by the DP: phase 8's plan, lowrank set to w8a8"
    path = os.path.join(WORK, "smollm135m_w8a8.npz")
    runtime.save(path, host_q.lower_plan(plan), plan=plan, meta={
        "source": lm_source, "quantized_units": sum(
            1 for sg in plan.segments if sg.quant != "none")})
    art = runtime.load(path, device=dev)

    def step(c, t):
        return art.decode(c, t)
    calls = QuantCalls()
    q_pre, q_dec, _, seqs, q_serve = serve_both(
        "w8a8 compressed", step, lambda: art.init_cache(B, P + N), prompt, N,
        pertoken=calls)
    launch = kernels.launch_counts()
    check(tuple(seqs.shape) == (B, N), f"served ids {tuple(seqs.shape)}")
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    with ActCodes() as codes:
        lg = forced_logits(step, art.init_cache(B, P + N), fed)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "non-finite quantized logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "quantized served ids are not the argmax of the forced logits")

    def cpu_logits(a):
        return forced_logits(lambda c, t: a.decode(c, t),
                             a.init_cache(B, P + N), fed.cpu())

    def worst_step(a, b):
        return float(((a.cpu() - b).abs().amax(dim=(0, 2))
                      / b.abs().amax(dim=(0, 2))).max())
    art_cpu = runtime.load(path, device="cpu")
    lg_cpu = cpu_logits(art_cpu)
    with ActCodes(codes.codes) as replay:
        lg_rep = cpu_logits(art_cpu)
    d_cpu, d_rep = worst_step(lg, lg_cpu), worst_step(lg, lg_rep)
    d_act = worst_step(lg_cpu, cpu_logits(act_unquantized(art_cpu)))
    bound = NET_RTOL + 2.0 * d_act
    # (c): each w8a8 unit of the last served step, on its card input
    n_units = sum(1 for u in art.graph.units if u.kind == "lowrank")
    unit_err = max(compare_qffn(x, uq, kw["u_scale"], vq, kw["v_scale"],
                                kw["act_quant"])[1]
                   for _, (x, uq, vq), kw, _ in calls.calls[-n_units:])
    n_qlr = quant_census(art.graph).get("lowrank_w8a8", 0)
    steps = N - 1
    log("lm q serve", t0, f"w8a8, CostEnv(batch={B}, seq=1): {sib} w8a8 "
        f"siblings (T_q / T_fp {min(ratios, default=1):.4f}-"
        f"{max(ratios, default=1):.4f}; phase 8's seq=128 env: {sib_fp}); "
        f"depth budgets {'; '.join(ladder)}; served: {n_qlr} w8a8 lowrank "
        f"units, {chosen}; {B} prompts x {P} tokens, {N} new; worst step "
        f"logits vs CPU port {d_cpu:.3g} (bound {bound:.3g}: {NET_RTOL} + "
        f"2 x {d_act:.3g}, the CPU port's activation rounding; "
        f"{replay.flips} of {replay.total} activation codes differ), vs "
        f"the CPU port fed the card's codes {d_rep:.3g} (limit {NET_RTOL});"
        f" units of the last step vs plain versions on their card inputs: "
        f"max |Δ| / scale {unit_err:.3g} (limit {RTOL}); decode "
        f"{q_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, q_dec):.1f} tok/s) against the "
        f"fp plan's {fp_decode_s * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, fp_decode_s):.1f} tok/s); "
        f"prefill {q_pre * 1e3:.3f} ms; launches per decode step (counted "
        f"at the capture) {json.dumps(q_serve['launches_per_step'])}; "
        f"launches phase 13 {launch}")
    check(n_qlr >= 1, "the served plan has no w8a8 lowrank unit")
    check(d_cpu <= bound, f"quantized lm: card vs CPU port differ by "
          f"{d_cpu} > {bound}")
    check(replay.used == len(codes.codes) and d_rep <= NET_RTOL,
          f"quantized lm: card vs CPU port on the card's activation codes "
          f"differ by {d_rep} > {NET_RTOL}")
    check(launch["merged_ffn_q"] > 0,
          "merged_ffn_q never launched on the quantized transformer path")

    # 14. each quantized merged_ffn unit at decode (M = B)
    t0 = time.perf_counter()
    x = torch.randn(B, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).to(dev)
    rows = [time_qffn(x, u.params["u"], u.params["u_scale"], u.params["v"],
                      u.params["v_scale"], u.quant)
            for u in art.graph.units
            if u.kind == "lowrank" and u.quant != "none"]
    tot = {f: sum(r[f] for r in rows) for f in Q_FIELDS}
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    tot["bound_rate"] = " / ".join(sorted({r["bound_rate"] for r in rows}))
    # the first unit's factors in each variant the kernel takes, alone
    u0 = next(u for u in art.graph.units if u.kind == "lowrank")
    ud = quant.dequantize(u0.params["u"], u0.params["u_scale"], axis=1)
    vd = quant.dequantize(u0.params["v"], u0.params["v_scale"], axis=1)
    variants = {"fp32": kernel_time(lambda: mf_mod.merged_ffn(x, ud, vd))}
    xq, xs = quant.quantize_int8(x)
    for name, wmode, panel in (("int8", "int8", None), ("w8a8", "int8", xq),
                               ("fp8", "fp8", None)):
        uq, us = quant.quantize_weight(ud, wmode, axis=1)
        vq, vs = quant.quantize_weight(vd, wmode, axis=1)
        if panel is not None:
            us = us * xs
        variants[name] = kernel_time(lambda: mf_mod.merged_ffn(
            x, uq, vq, u_scale=us, v_scale=vs, xq=panel))
    with open(os.path.join(WORK, "qffn.json"), "w") as f:
        json.dump({"decode_units": rows, "decode_step": tot,
                   "variants_ms": variants}, f, indent=1)
    r = rows[0]
    log("merged_ffn_q shapes", t0, f"M={r['m']} D={r['d']} R={r['r']} "
        f"{r['w_dtype']} {r['act_quant']}: ms={r['ms']:.4f} (fp32 kernel "
        f"{r['fp32_ms']:.4f}; activation quantization {r['qpass_ms']:.4f}; "
        f"op {r['op_ms']:.4f}) plain={r['plain_ms']:.4f} "
        f"library(addmm, dequantized)={r['library_ms']:.4f} "
        f"bound={r['bound_ms']:.5f}; decode step ({len(rows)} units): "
        f"ms={tot['ms']:.4f} op={tot['op_ms']:.4f} "
        f"fp32={tot['fp32_ms']:.4f} plain={tot['plain_ms']:.4f} "
        f"library={tot['library_ms']:.4f} bound={tot['bound_ms']:.5f}; one "
        f"unit's kernel by variant (ms): {json.dumps(variants)}")
    return tot, launch, q_serve


def quant_census(graph) -> dict:
    """Units by precision, and the quantized ones by kind."""
    out = {"fp": 0, "int8": 0, "w8a8": 0}
    for u in graph.units:
        q = getattr(u, "quant", "none")
        out["fp" if q == "none" else q] += 1
        if q != "none":
            key = ("dwconv" if u.kind == "conv" and u.depthwise
                   else u.kind) + "_" + q
            out[key] = out.get(key, 0) + 1
    return out


def fp_plan(plan):
    """The same plan with every segment at full precision."""
    import dataclasses
    return dataclasses.replace(plan, segments=tuple(
        dataclasses.replace(s, quant="none") for s in plan.segments))


# ---------------------------------------------------------------------------
# RecurrentGemma-2B: compress, serve, the path's kernel shapes
# ---------------------------------------------------------------------------

def merged_segments(host, plan) -> int:
    """Segments of ``plan`` that lower to a lowrank unit, counted without
    lowering (at d 2560 each merged segment costs an SVD to lower)."""
    return sum(1 for sg in plan.segments
               if not sg.original and host._rank(sg) > 0)


def norm_bound(m: int, d: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of rmsnorm on (M, D): 5 FLOPs an element;
    x read and y written once, g read once."""
    return (5.0 * m * d / H100_FP32_FLOPS * 1e3,
            4.0 * (2 * m * d + d) / H100_HBM_BW * 1e3)


def scan_bound(b: int, s: int, c: int) -> tuple[float, float]:
    """rglru_scan on (B, S, C): a multiply and an add an element; a and b
    read once, h written once."""
    return (2.0 * b * s * c / H100_FP32_FLOPS * 1e3,
            12.0 * b * s * c / H100_HBM_BW * 1e3)


def attention_bound(b, s, h, kvh, d, causal=True) -> tuple[float, float]:
    """flash_attention: 4·D FLOPs (q·k and p·v) for each (query, key) pair
    the mask keeps, S(S+1)/2 per head when causal, at the 3xTF32 rate of
    its fp32 × fp32 products (``TC_RATES``); q and o at H heads, k and v
    at the KVH heads the kernel reads."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return (4.0 * b * h * d * pairs / TC_RATES[("fp32", "fp32")][0] * 1e3,
            4.0 * (2 * b * s * h * d + 2 * b * s * kvh * d) / H100_HBM_BW
            * 1e3)


def time_row(kernel, shape, run, plain, library, bound, err,
             rate=FFMA_RATE) -> dict:
    """Device times of the kernel op, its plain version and the library
    yardstick (None: no one PyTorch call computes the function); ``rate``
    names the operations' rate of the bound."""
    f_ms, b_ms = bound
    row = {"kernel": kernel, "shape": shape, "max_abs_err": err,
           "ms": kernel_time(run), "plain_ms": kernel_time(plain),
           "library_ms": None if library is None else kernel_time(library),
           "flops_ms": f_ms, "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms),
           "bound_rate": rate}
    check_bound(f"{kernel} {shape}", row["ms"], row["bound_ms"])
    return row


def time_rg_kernels(dev, cfg, art, host) -> list:
    """rmsnorm, rglru_scan and flash_attention at RecurrentGemma-2B's
    shapes (probe: batch 8 × seq 128; prefill: 8 × 16; decode: 8 rows)
    and SmolLM-135M's, and merged_ffn at D 2560 (each served lowrank unit
    at M 8, 128, 1024; the replaced path's R 7680 unit at M 128): the
    kernel, the plain version and the library yardstick
    (``F.rms_norm``; ``F.scaled_dot_product_attention`` on k, v expanded,
    TF32 off; ``torch.addmm(x, x @ U, V)``), as device times, beside the
    bound.  The first row of each kernel is the probe shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(8)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    rows = []
    eps = cfg.norm_eps
    for m, d in ((1024, cfg.d_model), (128, cfg.d_model), (8, cfg.d_model),
                 (1024, 576)):
        x, w = rnd(m, d), rnd(d) * 0.2
        w1 = 1.0 + w
        yr = ref.rmsnorm_ref(x, w, eps)
        err = held("rmsnorm", kernels.rmsnorm_op(x, w, eps=eps), yr,
                   yr.abs(), f"x={(m, d)}")[0]
        rows.append(time_row(
            "rmsnorm", [m, d], lambda: kernels.rmsnorm_op(x, w, eps=eps),
            lambda: ref.rmsnorm_ref(x, w, eps),
            lambda: F.rms_norm(x, (d,), w1, eps), norm_bound(m, d), err))
    dr = cfg.rnn_width or cfg.d_model
    for b, s in ((8, 128), (8, 16)):
        a = (torch.rand(b, s, dr, generator=g) * 0.5 + 0.5).to(dev)
        x = rnd(b, s, dr) * 0.1
        err = held("rglru_scan", kernels.rglru_scan_op(a, x),
                   ref.rglru_scan_ref(a, x), ref.rglru_scan_ref(a, x.abs()),
                   f"a={(b, s, dr)}")[0]
        rows.append(time_row(
            "rglru_scan", [b, s, dr], lambda: kernels.rglru_scan_op(a, x),
            lambda: ref.rglru_scan_ref(a, x), None, scan_bound(b, s, dr),
            err))
    for b, s, h, kvh, d in ((8, 128, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim),
                            (8, 16, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim),
                            (8, 128, 9, 3, 64), (8, 16, 9, 3, 64)):
        q, k, v = rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d)
        err = compare_attention(q, k, v, True)[0]
        qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2)
                      .transpose(1, 2) for t in (q, k, v))
        rows.append(time_row(
            "flash_attention", [b, s, h, kvh, d],
            lambda: kernels.flash_attention_op(q, k, v, True),
            lambda: ops._attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            attention_bound(b, s, h, kvh, d), err,
            tc_rate_label(("fp32", "fp32"))))
    units = [u for u in art.graph.units if u.kind == "lowrank"]
    shapes = sorted({tuple(u.params["u"].shape) for u in units})
    for m in (1024, 128, 8):
        for shp in shapes:
            u = next(u for u in units if tuple(u.params["u"].shape) == shp)
            r = time_ffn(rnd(m, cfg.d_model), u.params["u"], u.params["v"])
            rows.append(dict(r, kernel="merged_ffn", shape=[m, *shp]))
    sub = next(s for s in host.subparams if s is not None
               and s["kind"] == "ffn")
    uf, vf = host._linear_factors(sub)
    r = time_ffn(rnd(128, cfg.d_model), uf.contiguous(), vf.contiguous())
    rows.append(dict(r, kernel="merged_ffn", shape=[128, *uf.shape],
                     note="replaced path: one linearized FFN, unmerged"))
    return rows


def rg_phases(dev, build_host):
    """Phases 15-17: RecurrentGemma-2B at full size in fp32 compressed on
    card-timed tables, its artifact served and held against the CPU port
    and ``replaced_apply``, and the path's kernels at its shapes.
    Returns (rows of :func:`time_rg_kernels`, launches over 15-16)."""
    import shutil

    import torch
    from repro_torch import kernels, runtime
    from repro_torch.core import WallClockOracle, compress
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.runtime.artifact import flatten_tree

    # 15. RecurrentGemma-2B compress --------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # 26 layers (rglru, rglru, attn_local; window 2048), d 2560, 10 heads
    # over 1 kv head of 256, GeGLU 7680, vocab 256000, tied embeddings:
    # full size, fp32, weights from seed 0; costed and probed at batch 8 x
    # seq 128 (probes at M = 1024)
    host, source = build_host("recurrentgemma-2b", seed=0, batch=8, seq=128,
                              full=True, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cfg = host.cfg
    n_params = sum(t.numel() for t in flatten_tree(host.params).values())
    oracle = WallClockOracle()
    res, ladder, served = None, [], ""
    for ratio in LM_BUDGETS:
        r = compress(host, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle)
        n_m = 0 if r is None else merged_segments(host, r.plan)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_m} merged, predicted speedup "
                                      f"{r.speedup:.4f}"))
        if n_m:
            res, served = r, f"card-timed tables, budget {ratio}"
            break
    t_tables = time.perf_counter() - t0 - t_init
    print("  signature timings (device, CUDA graph): " + "; ".join(
        f"{sig[1]} rank {sig[2]} {sec * 1e3:.4f} ms"
        for sig, sec in oracle.measured.items()), flush=True)
    check(res is not None, f"recurrentgemma-2b depth: the card-timed tables "
          f"merge no FFN at any budget ({'; '.join(ladder)})")
    free_gb = shutil.disk_usage(WORK).free / 1e9
    rg_path = os.path.join(WORK, "recurrentgemma2b_depth.npz")
    t_save = time.perf_counter()
    res.save(rg_path, extra_meta={"source": source})
    t_save = time.perf_counter() - t_save
    build_launches = kernels.launch_counts()
    st = res.tables.stats
    log("rg compress", t0, f"recurrentgemma-2b fp32 full size, "
        f"{n_params / 1e9:.3f} B parameters (init {t_init:.2f}s, tables and "
        f"DP {t_tables:.2f}s); depth budgets {'; '.join(ladder)}; served: "
        f"{served}, {len(res.plan.segments)} segments, "
        f"{merged_segments(host, res.plan)} merged, {st.num_latency_probes} "
        f"probes in {st.num_latency_buckets} signatures, "
        f"{len(oracle.measured)} timed on the card, predicted speedup "
        f"{res.speedup:.4f}; artifact {os.path.getsize(rg_path) / 1e9:.2f} "
        f"GB saved in {t_save:.2f}s ({free_gb:.1f} GB free before); table "
        f"builds' launches {build_launches}")

    # 16. RecurrentGemma-2B serve -----------------------------------------------
    t0 = time.perf_counter()
    art = runtime.load(rg_path, device="cuda")
    t_load = time.perf_counter() - t0
    census = runtime.count_units(art.graph)
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(11, B, P, cfg.vocab_size, device=dev)

    def c_step(c, t):
        return art.decode(c, t)

    def o_step(c, t):
        return T.decode_step(cfg, host.params, c, {"tokens": t})
    c_pre, c_dec, c_logits, seqs, c_serve = serve_both(
        "rg compressed", c_step, lambda: art.init_cache(B, P + N), prompt, N)
    o_pre, o_dec, _, _, o_serve = serve_both(
        "rg original", o_step, lambda: T.init_cache(cfg, B, P + N, device=dev),
        prompt, N)
    check(tuple(seqs.shape) == (B, N), f"rg served ids {tuple(seqs.shape)}")
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    lg = forced_logits(c_step, art.init_cache(B, P + N), fed)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "rg: non-finite served logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "rg: served ids are not the argmax of the teacher-forced logits")
    d_fed = rel_diff(lg[:, P - 1], c_logits)
    check(d_fed <= 1e-6, f"rg: prefill logits of serve_loop and the forced "
          f"run differ by {d_fed}")
    y_merged = art.apply({"tokens": prompt})
    fn, p = host.replaced_apply(res.plan)
    y_rep = fn(p, {"tokens": prompt})
    check(tuple(y_merged.shape) == (B, P, cfg.vocab_size)
          and bool(torch.isfinite(y_merged).all()),
          f"rg prefill logits {tuple(y_merged.shape)}")
    d_rep = rel_diff(y_merged, y_rep)
    rg_launches = kernels.launch_counts()
    per_step = c_serve["launches_per_step"]
    kernels.reset_launch_counts()
    art.apply({"tokens": prompt})
    per_prefill = {k: n for k, n in kernels.launch_counts().items() if n}
    t_cpu = time.perf_counter()
    cpu = runtime.load(rg_path, device="cpu")
    lg_cpu = forced_logits(lambda c, t: cpu.decode(c, t),
                           cpu.init_cache(B, P + N), fed.cpu())
    t_cpu = time.perf_counter() - t_cpu
    del cpu
    d_steps = ((lg.cpu() - lg_cpu).abs().amax(dim=(0, 2))
               / lg_cpu.abs().amax(dim=(0, 2)))
    d_cpu, d_last = float(d_steps.max()), float(d_steps[-1])
    steps = N - 1
    log("rg serve", t0, f"artifact loaded on the card in {t_load:.2f}s, "
        f"units {json.dumps(census, sort_keys=True)}; {B} prompts x {P} "
        f"tokens, {N} new; worst step logits vs CPU port {d_cpu:.3g} (last "
        f"step {d_last:.3g}; {B} prompts x {P + N - 1} steps on the CPU in "
        f"{t_cpu:.2f}s), prefill forward vs replaced_apply {d_rep:.3g} "
        f"(limit {NET_RTOL}); compressed prefill {c_pre * 1e3:.3f} ms, "
        f"decode {c_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, c_dec):.1f} tok/s); original "
        f"prefill {o_pre * 1e3:.3f} ms, decode {o_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, o_dec):.1f} tok/s); decode "
        f"speedup {o_dec / c_dec:.3f}x (predicted {res.speedup:.4f}x); "
        f"launches per decode step {per_step} (counted at the capture), "
        f"per prefill forward {per_prefill}; phases 15-16 launches "
        f"{rg_launches}")
    check(census.get("lowrank", 0) >= 1, "rg: the served plan merges nothing")
    check(d_cpu <= NET_RTOL, f"rg: card vs CPU port differ by {d_cpu}")
    check(d_rep <= NET_RTOL, f"rg: merged vs replaced differ by {d_rep}")
    for k in ("rmsnorm", "rglru_scan", "flash_attention", "merged_ffn"):
        check(rg_launches[k] > 0, f"kernel {k} never launched on the "
              "RecurrentGemma path")

    # 17. the path's kernels at its shapes --------------------------------------
    t0 = time.perf_counter()
    rows = time_rg_kernels(dev, cfg, art, host)
    with open(os.path.join(WORK, "rg.json"), "w") as f:
        json.dump({"rows": rows, "launches_per_decode_step": per_step,
                   "launches_per_prefill_forward": per_prefill,
                   "launches_phases_15_16": rg_launches,
                   "ladder": ladder, "served": served}, f, indent=1)
    log("rg kernels", t0, " ".join(
        f"{r['kernel']} {r['shape']}: ms={r['ms']:.4f} "
        f"plain={r['plain_ms']:.4f} library="
        + ("none" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        + f" bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f})"
        + (f" host {r['host_us']:.1f} us a call;" if "host_us" in r else ";")
        for r in rows))
    return rows, rg_launches, art, {"recurrentgemma-2b compressed": c_serve,
                                    "recurrentgemma-2b original": o_serve}


def poison_hook(slot: int, step: int):
    """A ``logit_hook`` that makes ``slot``'s logits NaN at step ``step``
    of a round (``t`` is a device tensor: the hook runs in the graph)."""
    import torch

    def hook(logits, t):
        rows = torch.arange(logits.shape[0], device=logits.device) == slot
        bad = rows.view(-1, *([1] * (logits.ndim - 1))) & (t == step)
        return torch.where(bad, torch.nan, logits)
    return hook


def request_phase(dev, arts) -> tuple[dict, dict]:
    """Phase 18: each artifact serves ragged requests through
    ``serve_requests`` (8 slots, 32 tokens): every request's tokens
    against ``serve_loop`` of its prompt alone at batch 1, then the last
    round's requests again (the same padded width) with one slot's
    logits poisoned at generation index 2: that request alone is aborted
    at 2 and every other is token-identical to the clean run.  Returns
    the rows and, per label, the single-prompt tokens ``(n, 32)``."""
    import torch
    from repro_torch import kernels
    from repro_torch.runtime import serving

    out, solos = {}, {}
    for label, art, n_req in arts:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cfg = art.graph.meta["config"]
        T_NEW, SLOTS = 32, 8
        prompts = serving.ragged_prompts(0, n_req, 4, 32, cfg.vocab_size)
        mat, lens = serving.pad_prompts(prompts)

        def step(c, t):
            return art.decode(c, t)
        served = serving.serve_requests(step, art.init_cache, mat, lens,
                                        tokens=T_NEW, slots=SLOTS)
        gen, secs = served
        rep = served.report
        launch = kernels.launch_counts()
        t_solo = time.perf_counter()
        differ, solo_rows = [], []
        for i, p in enumerate(prompts):
            p = p.long().to(dev)[None, :]
            solo = serving.serve_loop(
                step, lambda: art.init_cache(1, p.shape[1] + T_NEW), p,
                T_NEW, warm=False)[3][0].cpu()
            solo_rows.append(solo)
            if not torch.equal(solo, gen[i]):
                differ.append(i)
        solos[label] = torch.stack(solo_rows)
        t_solo = time.perf_counter() - t_solo
        start = (n_req - 1) // SLOTS * SLOTS
        r = 1
        hook = poison_hook(r, int(lens[start + r]) - 1 + 2)
        bad = serving.serve_requests(step, art.init_cache, mat[start:],
                                     lens[start:], tokens=T_NEW, slots=SLOTS,
                                     logit_hook=hook)
        others = [i for i in range(n_req - start) if i != r]
        same = all(torch.equal(bad[0][i], gen[start + i]) for i in others)
        poisoned_ok = (torch.equal(bad[0][r, :2], gen[start + r, :2])
                       and not bool(bad[0][r, 2:].any()))
        row = {"requests": n_req, "slots": SLOTS, "tokens": T_NEW,
               "prompt_lengths": lens.tolist(), "seconds": secs,
               "sustained_tok_s": serving.decode_tok_s(T_NEW, n_req, secs),
               "rounds": rep.rounds, "dispositions": rep.dispositions,
               "differ_from_single_prompt": differ,
               "poisoned_aborted": bad.report.aborted,
               "poisoned_dispositions": bad.report.dispositions,
               "others_identical": same, "launches": launch}
        out[label] = row
        log("lm requests", t0, f"{label}: {n_req} ragged prompts (lengths "
            f"{min(row['prompt_lengths'])}-{max(row['prompt_lengths'])}) x "
            f"{T_NEW} tokens in {SLOTS} slots: {rep.rounds} rounds in "
            f"{secs * 1e3:.3f} ms, sustained {row['sustained_tok_s']:.1f} "
            f"tok/s; dispositions {json.dumps(rep.dispositions)}; tokens "
            f"against single-prompt serve_loop at batch 1: "
            f"{n_req - len(differ)} of {n_req} equal ({t_solo:.2f}s); request "
            f"{start + r} poisoned at generation index 2: aborted "
            f"{bad.report.aborted} (relative to the round), the other "
            f"{len(others)} token-identical {same}; launches {launch}")
        check(rep.completed == list(range(n_req)) and rep.ok,
              f"{label} requests: dispositions {rep.dispositions}")
        check(not differ, f"{label} requests {differ} differ from serving "
              "their prompt alone")
        check(bad.report.aborted == {r: 2} and same and poisoned_ok,
              f"{label} requests: the poisoned run reports "
              f"{bad.report.aborted}, others identical {same}, poisoned "
              f"row kept its first 2 tokens and zeros after {poisoned_ok}")
        for k in ("rmsnorm", "merged_ffn"):
            check(launch[k] > 0, f"{label} requests: {k} never launched")
    return out, solos


def continuous_phase(arts, solos, fixed) -> dict:
    """Phase 19: each artifact serves phase 18's ragged prompts through
    the continuous engine (8 slots, chunks of 8 steps, 32 tokens):
    (a) all arriving at 0 on the real clock, beside phase 18's
    ``serve_requests``; (b) a seeded Poisson trace at 20 requests/s (the
    reference bench's recipe), p50/p99 latency; (c) on a ``TickClock``
    with staggered arrivals, ``nan@serve.nan`` on a request admitted
    mid-stream plus ``delay@serve.arrival`` and ``delay@serve.chunk``;
    (d) ``raise@serve.worker`` at the 3rd chunk through
    ``serve_with_failover``.  Every request's tokens must equal phase
    18's ``serve_loop`` of its prompt alone at batch 1 (``solos``), but
    the poisoned one, aborted at 2 alone; the failover replays
    bit-identically; the launch counts of (a), zeroed just before it,
    show ``merged_ffn`` and ``rmsnorm`` in the captured chunk step, and
    the chunks take one graph replay per step.  A torch.profiler trace
    of chunks of the captured step gives its device time a step, and
    with (a)'s steps and wall its busy share (0 where the profiler sees
    no device activity)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.runtime import serving
    from repro_torch.testing import faults

    T_NEW, SLOTS, CHUNK, RATE = 32, 8, 8, 20.0
    out = {}
    for label, art, n_req in arts:
        t0 = time.perf_counter()
        cfg = art.graph.meta["config"]
        prompts = serving.ragged_prompts(0, n_req, 4, 32, cfg.vocab_size)
        mat, lens = serving.pad_prompts(prompts)
        solo = solos[label]

        def step(c, t):
            return art.decode(c, t)

        def serve(fn=serving.serve_continuous, **kw):
            return fn(step, art.init_cache, mat, lens, tokens=T_NEW,
                      slots=SLOTS, chunk=CHUNK, **kw)

        def differ(gen, skip=()):
            return [i for i in range(n_req)
                    if i not in skip and not torch.equal(gen[i], solo[i])]

        # (a) throughput: every request arrives at 0, real clock
        kernels.reset_launch_counts()
        with CountCalls(serving._ChunkGraph, "run") as chunks, \
                CountCalls(torch.cuda.CUDAGraph, "replay") as rp:
            a = serve()
        launch = kernels.launch_counts()
        tok_s = serving.decode_tok_s(T_NEW, n_req, a[1])
        # where (a)'s time goes: the device time of a step of the captured
        # chunk (torch.profiler over 4 chunks of idle slots; the shapes,
        # and so the work, are those of every step) against (a)'s wall.
        # A chunk goes through `run`, which rewinds the step counter.
        eng = serving.ContinuousEngine(step, art.init_cache, slots=SLOTS,
                                       chunk=CHUNK,
                                       max_seq=int(mat.shape[1]) + T_NEW)
        idle = eng._build_feed()
        busy_us, krows = device_kernels(lambda: eng._graph.run(idle),
                                        reps=4)
        busy_us /= CHUNK
        krows = [(us / CHUNK, n // CHUNK, name) for us, n, name in krows]
        del eng
        steps = chunks.n * CHUNK
        # (b) a seeded Poisson arrival trace, real clock
        arrivals = np.cumsum(np.random.RandomState(11).exponential(
            1.0 / RATE, size=n_req)).tolist()
        b = serve(arrivals=arrivals)
        lat = sorted(b.report.latency_s.values())
        # (c) faults on a virtual clock; request R arrives at 0.5 R ticks,
        # after the first chunk, so it is admitted mid-stream
        R = n_req - 2
        spec = (f"nan@serve.nan:rid={R},t=2;delay@serve.arrival:2~0.02;"
                "delay@serve.chunk:3~0.02")
        with faults.inject(*faults.parse_env_spec(spec).rules) as plan:
            c = serve(arrivals=[0.5 * r for r in range(n_req)],
                      clock=faults.TickClock())
        delays = sorted({p for p, _, act in plan.fired if act == "delay"})
        poisoned_ok = (torch.equal(c[0][R, :2], solo[R, :2])
                       and not bool(c[0][R, 2:].any()))
        # (d) a worker lost before the 3rd chunk
        with faults.inject(faults.Fault("serve.worker", "raise", nth=3)):
            d = serve(fn=serving.serve_with_failover,
                      clock=faults.TickClock())
        row = {"requests": n_req, "slots": SLOTS, "chunk": CHUNK,
               "tokens": T_NEW, "seconds": a[1], "sustained_tok_s": tok_s,
               "engine_tok_s": a.report.sustained_tok_s,
               "fixed_tok_s": fixed[label]["sustained_tok_s"],
               "chunks": chunks.n, "admitted": a.report.admitted,
               "replays_per_step": rp.n / max(steps, 1),
               "busy_share": busy_us * 1e-6 * steps / a[1],
               "device_ms_per_step": busy_us * 1e-3,
               "served_ms_per_step": a[1] * 1e3 / max(steps, 1),
               "device_kernels": [(us, n, name[:80])
                                  for us, n, name in krows[:8]],
               "launches": launch, "differ": differ(a[0]),
               "trace_rate_req_s": RATE, "trace_seconds": b[1],
               "trace_tok_s": serving.decode_tok_s(T_NEW, n_req, b[1]),
               "trace_p50_s": float(np.percentile(lat, 50)),
               "trace_p99_s": float(np.percentile(lat, 99)),
               "trace_queue_peak": b.report.queue_peak,
               "trace_differ": differ(b[0]),
               "nan_rid": R, "nan_aborted": c.report.aborted,
               "nan_dispositions": c.report.dispositions,
               "nan_differ": differ(c[0], skip=(R,)),
               "delay_points_fired": delays,
               "failovers": d.report.failovers,
               "failover_replayed": d.report.replayed,
               "failover_completed": sorted(d.report.completed),
               "failover_identical": bool(torch.equal(d[0], a[0]))}
        out[label] = row
        log("lm continuous", t0, f"{label}: {n_req} ragged prompts x "
            f"{T_NEW} tokens, {SLOTS} slots, chunks of {CHUNK}: (a) "
            f"{a[1] * 1e3:.3f} ms, sustained {tok_s:.1f} tok/s (engine's "
            f"clock {a.report.sustained_tok_s:.1f}) against serve_requests' "
            f"{row['fixed_tok_s']:.1f} (phase 18), {chunks.n} chunks, "
            f"{a.report.admitted} admissions, {row['replays_per_step']:.3f} "
            f"graph replays per step, launches (warm-up + capture) "
            f"{json.dumps(launch)}; served {row['served_ms_per_step']:.3f} "
            f"ms a step, device (torch.profiler over 4 chunks) "
            f"{row['device_ms_per_step']:.3f} ms a step, busy "
            f"{row['busy_share']:.3f}; by kernel: " + "; ".join(
                f"{name[:60]} {us:.1f}us x{n}" for us, n, name in
                row["device_kernels"][:5]) + f"; (b) Poisson {RATE:g} req/s: "
            f"{b[1] * 1e3:.3f} ms, {row['trace_tok_s']:.1f} tok/s, latency "
            f"p50 {row['trace_p50_s'] * 1e3:.3f} ms p99 "
            f"{row['trace_p99_s'] * 1e3:.3f} ms, queue peak "
            f"{b.report.queue_peak}; tokens against single-prompt "
            f"serve_loop: (a) {n_req - len(row['differ'])} and (b) "
            f"{n_req - len(row['trace_differ'])} of {n_req} equal; (c) "
            f"request {R} poisoned at generation index 2: aborted "
            f"{c.report.aborted}, the other {n_req - 1} equal "
            f"{not row['nan_differ']}, delay rules fired at {delays}; (d) "
            f"worker lost at chunk 3: failovers {d.report.failovers}, "
            f"replayed {d.report.replayed}, tokens identical to (a) "
            f"{row['failover_identical']}")
        check(a.report.ok and sorted(a.report.completed) == list(
            range(n_req)), f"{label} continuous: {a.report.dispositions}")
        check(not row["differ"], f"{label} continuous: requests "
              f"{row['differ']} differ from serving their prompt alone")
        check(b.report.ok and not row["trace_differ"], f"{label} "
              f"continuous, Poisson trace: {b.report.dispositions}, "
              f"requests {row['trace_differ']} differ")
        check(c.report.aborted == {R: 2} and poisoned_ok
              and not row["nan_differ"] and len(c.report.completed)
              == n_req - 1, f"{label} continuous, NaN at request {R}: "
              f"aborted {c.report.aborted}, others differ "
              f"{row['nan_differ']}, truncated {poisoned_ok}")
        check(delays == ["serve.arrival", "serve.chunk"], f"{label} "
              f"continuous: delay rules fired at {delays}")
        check(d.report.failovers == 1 and d.report.replayed
              and row["failover_completed"] == list(range(n_req))
              and row["failover_identical"], f"{label} failover: "
              f"{d.report.failovers} failovers, completed "
              f"{row['failover_completed']}, identical "
              f"{row['failover_identical']}")
        check(row["replays_per_step"] == 1.0, f"{label} continuous: "
              f"{rp.n} graph replays for {chunks.n} chunks of {CHUNK}")
        for k in ("rmsnorm", "merged_ffn"):
            check(launch[k] > 0, f"{label} continuous: {k} never launched")
    return out


# ---------------------------------------------------------------------------

def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import kernels, runtime
        from repro_torch.compress import build_host, main as compress_main
        from repro_torch.core import WallClockOracle, compress
        from repro_torch.core.plan import identity_plan
        from repro_torch.device import resolve
        from repro_torch.kernels import cuda_build
        from repro_torch.models import cnn
    except ImportError as e:
        print(f"{IMPORT_ERROR} ({e})", file=sys.stderr)
        return 2
    quick = "--quick" in argv
    os.makedirs(WORK, exist_ok=True)
    t_all = time.perf_counter()

    # 1. card ------------------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    dev = resolve("cuda")
    name = torch.cuda.get_device_name(0)
    log("card", t0, f"{name} | {smi_line} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | tf32 cudnn="
        f"{torch.backends.cudnn.allow_tf32} matmul="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    builds = cuda_build.build()
    for b in builds.values():
        res = [ln.strip() for ln in b.log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"  {b.name}: {b.seconds:.1f}s cached={b.cached} "
              f"{' | '.join(res)}", flush=True)
    log("build", t0, f"{len(builds)} kernels")

    # 3. kernel sweep -----------------------------------------------------------
    t0 = time.perf_counter()
    sweep = kernel_sweep(dev)
    sweep["merged_ffn"] = ffn_sweep(dev)
    sweep.update(qkernel_sweep(dev))
    conv_inst = conv_instance_sweep(dev)
    for k, v in conv_inst.items():
        sweep[k] = [max(sweep[k][0], v[0]), max(sweep[k][1], v[1]),
                    sweep[k][2] + v[2]]
    sweep["merged_ffn_q"] = qffn_sweep(dev)
    sweep.update(norm_scan_attention_sweep(dev))
    n_q = quantize_matches_cpu(dev)
    n_det = ffn_determinism(dev)
    n_det_ad = attn_dw_determinism(dev)
    n_det_conv = conv_determinism(dev)
    slots, slots_model = ffn_slots()
    log("kernels", t0, json.dumps(
        {k: {"cases": v[2], "max_abs_err": v[0], "max_rel_err": v[1]}
         for k, v in sweep.items()}) + f"; quantize_int8 card == CPU "
        f"bitwise on {n_q} inputs; merged_ffn bitwise run to run on "
        f"{n_det} inputs, flash_attention and depthwise_conv on "
        f"{n_det_ad}, merged_conv (fp32 and w8a8) on {n_det_conv} "
        f"(instance cases {json.dumps({k: v[2] for k, v in conv_inst.items()})}"
        f"); merged_ffn resident blocks by cluster size "
        f"{json.dumps(slots)} ("
        + ("launch_plan's model" if slots_model else "NOT launch_plan's "
           "H100_SLOTS: its splits are planned for another card") + ")")
    if quick:
        print(smi_line)
        return 0

    # 4. main path: compress ----------------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    art_path = os.path.join(WORK, "mobilenetv2.npz")
    argv_c = ["--arch", "mobilenetv2", "--oracle", "wallclock",
              "--max-span", "6", "--budget-ratio", "0.6", "--batch", "8",
              "--out", art_path]
    # One oracle times each MobileNetV2 signature once, for this phase and
    # the quantized compress of phase 11.
    cnn_oracle = WallClockOracle()
    summary = compress_main(argv_c, latency_oracle=cnn_oracle)
    log("compress", t0, f"plan: {summary['segments']} segments, "
        f"{summary['kept_layers']}/{summary['layers']} layers kept, "
        f"{summary['latency_probes']} probes in "
        f"{summary['latency_signatures']} signatures, "
        f"{summary['signatures_timed']} timed on the card, predicted "
        f"speedup {summary['predicted_speedup']:.4f}")

    # 5. serve -----------------------------------------------------------------
    t0 = time.perf_counter()
    art = runtime.load(art_path, device="cuda")
    census = runtime.count_units(art.graph)
    gen = torch.Generator().manual_seed(1234)
    batches = [torch.randn(8, 224, 224, 3, generator=gen) for _ in range(3)]
    outs = []
    for xb in batches:
        y = art.apply(xb.to(dev))
        torch.cuda.synchronize()
        check(tuple(y.shape) == (8, 1000), f"logits shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "non-finite logits")
        outs.append(y)
    art_cpu = runtime.load(art_path, device="cpu")
    cnn_h, _ = build_host("mobilenetv2", seed=0, batch=8, max_span=6,
                          device="cuda")
    d_cpu = d_rep = 0.0                 # worst over the served batches
    for xb, y in zip(batches, outs):
        y_cpu = art_cpu.apply(xb)
        d_cpu = max(d_cpu, float((y.cpu() - y_cpu).abs().max()
                                 / y_cpu.abs().max()))
        y_rep = cnn.apply_replaced(cnn_h.net, cnn_h.params, xb.to(dev),
                                   art.plan)
        d_rep = max(d_rep, float((y - y_rep).abs().max()
                                 / y_rep.abs().max()))
    orig_graph = cnn_h.lower_plan(identity_plan(cnn_h.net.L, cnn_h.descs()))
    xb = batches[0].to(dev)
    ms_merged = cuda_time(lambda: art.apply(xb), iters=20)
    ms_orig = cuda_time(lambda: runtime.execute(orig_graph, xb), iters=20)
    # the same forwards as device time (CUDA-graph replays, as the tables
    # time each segment): eager dispatch leaves the card mostly idle, so
    # the CUDA-event times measure the host as much as the card
    fwd_oracle = WallClockOracle()
    dev_merged = fwd_oracle.time_callable(lambda: art.apply(xb)) * 1e3
    dev_orig = fwd_oracle.time_callable(
        lambda: runtime.execute(orig_graph, xb)) * 1e3
    busy_us, busy_rows = device_kernels(lambda: art.apply(xb))
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    art.apply(xb)
    per_forward = kernels.launch_counts()
    log("serve", t0, f"units {census}; {len(batches)} batches, worst logits "
        f"vs CPU port {d_cpu:.3g}, vs apply_replaced {d_rep:.3g} (limit "
        f"{NET_RTOL}); batch-8 forward "
        f"original {ms_orig:.3f} ms, merged {ms_merged:.3f} ms "
        f"({ms_orig / ms_merged:.3f}x); device time (CUDA graph) original "
        f"{dev_orig:.4f} ms, merged {dev_merged:.4f} ms "
        f"({dev_orig / dev_merged:.3f}x, predicted "
        f"{summary['predicted_speedup']:.4f}x); launches phases 4-5 "
        f"{launches}, per "
        f"merged forward {per_forward}")
    if busy_rows:
        print(f"  merged forward, torch.profiler: device busy {busy_us:.1f} "
              f"us per forward = {busy_us / (ms_merged * 1e3):.3f} of its "
              "CUDA-event time; by kernel: " + "; ".join(
                  f"{name[:60]} {us:.1f}us x{n}"
                  for us, n, name in busy_rows[:8]), flush=True)
    else:
        print("  merged forward, torch.profiler: no device activity seen "
              "(busy share not measured)", flush=True)
    check(d_cpu <= NET_RTOL, f"card vs CPU port logits differ by {d_cpu}")
    check(d_rep <= NET_RTOL, f"merged vs apply_replaced differ by {d_rep}")
    for k in ("merged_conv", "depthwise_conv"):
        check(launches[k] > 0, f"kernel {k} never launched on the main path")

    # 6. main-path kernels ------------------------------------------------------
    t0 = time.perf_counter()
    tot = time_main_path_kernels(art.graph, dev, 8)
    # what the cold-L2 protocol charges the smallest kernel: one launch
    # that writes one element
    one = torch.zeros(1, device=dev)
    floor_ms = kernel_time(one.zero_)
    tot["merged_conv"]["floor_ms"] = floor_ms
    with open(os.path.join(WORK, "units.json"), "w") as f:
        json.dump(tot, f, indent=1)
    log("main-path kernels", t0, f"timing floor (a one-element fill) "
        f"{floor_ms:.4f} ms; " + " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} plain={v['plain_ms']:.4f} "
        f"library={v['library_ms']:.4f} bound={v['bound_ms']:.4f} "
        f"({v['bound_rate']}); units slower than the library "
        f"{sum(r['ms'] > r['library_ms'] for r in v['rows'])};"
        for k, v in tot.items()))

    # 7. resnet34 -----------------------------------------------------------------
    t0 = time.perf_counter()
    r_path = os.path.join(WORK, "resnet34.npz")
    compress_main(["--arch", "resnet34", "--oracle", "analytic",
                   "--budget-ratio", "0.6", "--batch", "8", "--out", r_path])
    r_art = runtime.load(r_path, device="cuda")
    units = r_art.graph.units
    check(any(u.kind == "pool" for u in units), "resnet34: no pool unit")
    check(any("proj" in u.params for u in units if u.kind == "conv"),
          "resnet34: no projection shortcut")
    check(any(u.kind == "conv" and u.params["w"].shape[0] >= 7
              and u.stride == 2 for u in units), "resnet34: no K>=7 s2 unit")
    xr = torch.randn(2, 224, 224, 3, generator=gen)
    kernels.reset_launch_counts()
    yr = r_art.apply(xr.to(dev))
    torch.cuda.synchronize()
    r_launch = kernels.launch_counts()
    yr_cpu = runtime.load(r_path, device="cpu").apply(xr)
    d_r = float((yr.cpu() - yr_cpu).abs().max() / yr_cpu.abs().max())
    log("resnet34", t0, f"units {runtime.count_units(r_art.graph)}; logits "
        f"vs CPU port {d_r:.3g}; launches {r_launch}")
    check(bool(torch.isfinite(yr).all()), "resnet34: non-finite logits")
    check(d_r <= NET_RTOL, f"resnet34: card vs CPU port differ by {d_r}")
    # its merged_conv units at batch 8, against cuDNN: 3x3 and larger
    # merged kernels, where operations bound the kernel
    t0 = time.perf_counter()
    r_tot = time_main_path_kernels(r_art.graph, dev, 8, plain=False,
                                   label="resnet34 ")["merged_conv"]
    with open(os.path.join(WORK, "resnet34.json"), "w") as f:
        json.dump(r_tot, f, indent=1)
    log("resnet34 units", t0, f"merged_conv: {r_tot['units']} units "
        f"ms={r_tot['ms']:.4f} library(cuDNN)={r_tot['library_ms']:.4f} "
        f"bound={r_tot['bound_ms']:.4f} ({r_tot['bound_rate']}); by unit "
        "(w, ms, cuDNN ms, share): " + "; ".join(
            f"{r['w']} s{r['stride']} {r['ms']:.4f} {r['library_ms']:.4f} "
            f"{r['share']:.3f}" for r in r_tot["rows"]))

    # 8. transformer compress ---------------------------------------------------
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # SmolLM-135M at full width in fp32 (30 layers, d 576, 9/3 heads,
    # SwiGLU 1536, vocab 49152, tied embeddings), costed and probed at
    # batch 8 x seq 128
    host, lm_source = build_host("smollm-135m", seed=0, batch=8, seq=128,
                                 full=True, device="cuda")
    t_init = time.perf_counter() - t0
    # Start at 0.6, where the analytic model merges 20 FFNs.  Tables timed
    # on the card decide what fits: depth compression can only replace
    # FFN sublayers, so the tightest budget it meets is bounded by the
    # attention sublayers' share.  One oracle times each signature once
    # for every rung; the first rung whose plan merges an FFN is served.
    oracle = WallClockOracle()
    res, ladder = None, []
    for ratio in LM_BUDGETS:
        r = compress(host, budget_ratio=ratio, method="depth",
                     latency_oracle=oracle)
        n_lr = 0 if r is None else \
            runtime.count_units(r.lower()).get("lowrank", 0)
        ladder.append(f"{ratio}: " + ("infeasible" if r is None else
                                      f"{n_lr} lowrank, predicted speedup "
                                      f"{r.speedup:.4f}"))
        if n_lr:
            res, budget = r, ratio
            break
    print("  signature timings (device, CUDA graph): " + "; ".join(
        f"{sig[1]} rank {sig[2]} {sec * 1e3:.4f} ms"
        for sig, sec in oracle.measured.items()), flush=True)
    check(res is not None, f"smollm-135m depth: no budget in {LM_BUDGETS} "
          f"gives a plan with a lowrank unit ({'; '.join(ladder)})")
    lm_path = os.path.join(WORK, "smollm135m_depth.npz")
    res.save(lm_path, extra_meta={"source": lm_source})
    build_launches = kernels.launch_counts()
    graph = res.lower()
    n_lowrank = runtime.count_units(graph).get("lowrank", 0)
    st = res.tables.stats
    lm_res = compress(host, budget_ratio=0.6, method="layermerge",
                      latency_oracle=oracle)
    lm_census = unit_census(host.lower_plan(lm_res.plan)) \
        if lm_res is not None else "infeasible"
    log("lm compress", t0, f"smollm-135m fp32 full width (init "
        f"{t_init:.2f}s), depth budgets {'; '.join(ladder)}; served depth "
        f"{budget}: {len(res.plan.segments)} segments, units "
        f"{unit_census(graph)}, {st.num_latency_probes} probes in "
        f"{st.num_latency_buckets} signatures, predicted speedup "
        f"{res.speedup:.4f}; {len(oracle.measured)} signatures timed on "
        f"the card for every plan of this phase; table builds' "
        f"launches {build_launches}; layermerge 0.6 (tables timed in this "
        f"run): units {lm_census}" + (
            f", predicted speedup {lm_res.speedup:.4f}" if lm_res else ""))
    check(n_lowrank >= 1, "depth plan has no lowrank unit")
    check(build_launches["merged_ffn"] > 0,
          "merged_ffn never launched in the table build")

    # 9. transformer serve ------------------------------------------------------
    t0 = time.perf_counter()
    lm_art = runtime.load(lm_path, device="cuda")
    cfg = lm_art.graph.meta["config"]
    B, P, N = 8, 16, 32
    prompt = serving.random_prompts(7, B, P, cfg.vocab_size, device=dev)

    def c_step(c, t):
        return lm_art.decode(c, t)

    def o_step(c, t):
        return T.decode_step(cfg, host.params, c, {"tokens": t})
    c_pre, c_dec, c_logits, seqs, c_serve = serve_both(
        "compressed", c_step, lambda: lm_art.init_cache(B, P + N), prompt, N)
    o_pre, o_dec, _, _, o_serve = serve_both(
        "original", o_step, lambda: T.init_cache(cfg, B, P + N, device=dev),
        prompt, N)
    lm_launches = kernels.launch_counts()
    check(tuple(seqs.shape) == (B, N), f"served ids {tuple(seqs.shape)}")
    # every step's logits, teacher-forced with the card's own tokens, on
    # the card and on the CPU port of the same artifact
    fed = torch.cat([prompt, seqs[:, :-1]], dim=1)
    lg = forced_logits(c_step, lm_art.init_cache(B, P + N), fed)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg).all()), "non-finite served logits")
    check(bool((lg[:, P - 1:].argmax(-1) == seqs).all()),
          "served ids are not the argmax of the teacher-forced logits")
    d_fed = float((lg[:, P - 1] - c_logits).abs().max()
                  / c_logits.abs().max())
    check(d_fed <= 1e-6, f"prefill logits of serve_loop and the forced run "
          f"differ by {d_fed}")
    lm_cpu = runtime.load(lm_path, device="cpu")
    lg_cpu = forced_logits(lambda c, t: lm_cpu.decode(c, t),
                           lm_cpu.init_cache(B, P + N), fed.cpu())
    d_steps = ((lg.cpu() - lg_cpu).abs().amax(dim=(0, 2))
               / lg_cpu.abs().amax(dim=(0, 2)))
    d_lm_cpu, d_last = float(d_steps.max()), float(d_steps[-1])
    y_merged = lm_art.apply({"tokens": prompt})
    fn, p = host.replaced_apply(res.plan)
    y_rep = fn(p, {"tokens": prompt})
    d_lm_rep = float((y_merged - y_rep).abs().max() / y_rep.abs().max())
    per_step = c_serve["launches_per_step"].get("merged_ffn", 0)
    steps = N - 1
    log("lm serve", t0, f"{B} prompts x {P} tokens, {N} new; worst step "
        f"logits vs CPU port {d_lm_cpu:.3g} (last step {d_last:.3g}), "
        f"prefill vs replaced_apply {d_lm_rep:.3g} (limit {NET_RTOL}); "
        f"compressed prefill {c_pre * 1e3:.3f} ms, decode {c_dec * 1e3:.3f} "
        f"ms ({serving.decode_tok_s(steps, B, c_dec):.1f} tok/s); original "
        f"prefill {o_pre * 1e3:.3f} ms, decode {o_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, o_dec):.1f} tok/s); decode "
        f"speedup {o_dec / c_dec:.3f}x (predicted {res.speedup:.4f}x); "
        f"merged_ffn launches per decode step {per_step} (counted at the "
        f"capture); phases 8-9 launches {lm_launches}")
    serve_rows = {"smollm-135m compressed": c_serve,
                  "smollm-135m original": o_serve}
    check(d_lm_cpu <= NET_RTOL, f"lm card vs CPU port differ by {d_lm_cpu}")
    check(d_lm_rep <= NET_RTOL, f"lm merged vs replaced differ by {d_lm_rep}")
    check(lm_launches["merged_ffn"] > 0,
          "merged_ffn never launched on the transformer path")

    # 10. merged_ffn at the path's shapes ----------------------------------------
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(3)
    ffn_units = [u for u in lm_art.graph.units if u.kind == "lowrank"]
    d_model = cfg.d_model
    x8 = torch.randn(B, d_model, generator=g).to(dev)
    x1024 = torch.randn(8 * 128, d_model, generator=g).to(dev)
    per_unit = [time_ffn(x8, u.params["u"], u.params["v"])
                for u in ffn_units]
    probe = time_ffn(x1024, ffn_units[0].params["u"],
                     ffn_units[0].params["v"])
    step_tot = {k: sum(r[k] for r in per_unit)
                for k in ("ms", "plain_ms", "library_ms", "flops_ms",
                          "bytes_ms", "bound_ms")}
    step_tot["max_abs_err"] = max(r["max_abs_err"] for r in per_unit)
    step_tot["bound_rate"] = per_unit[0]["bound_rate"]
    split = host_split(x8, ffn_units[0].params["u"], ffn_units[0].params["v"])
    with open(os.path.join(WORK, "ffn.json"), "w") as f:
        json.dump({"decode_units": per_unit, "decode_step": step_tot,
                   "probe_m1024": probe, "host_us_m8": split}, f, indent=1)
    d1 = per_unit[0]
    log("merged_ffn shapes", t0, " ".join(
        f"M={r['m']} D={r['d']} R={r['r']}: ms={r['ms']:.4f} (eager "
        f"call {r['eager_ms']:.4f}, host {r['host_us']:.1f} us a call) "
        f"plain={r['plain_ms']:.4f} "
        f"library(addmm, 2 cuBLAS calls)="
        f"{r['library_ms']:.4f} bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f});" for r in (d1, probe))
        + f" decode step ({len(per_unit)} units): ms={step_tot['ms']:.4f} "
        f"plain={step_tot['plain_ms']:.4f} "
        f"library={step_tot['library_ms']:.4f} "
        f"bound={step_tot['bound_ms']:.5f}; host us a call at M=8 by layer: "
        + json.dumps({k: round(t, 1) for k, t in split.items()}))
    tot["merged_ffn"] = step_tot
    launches["merged_ffn"] = lm_launches["merged_ffn"]

    # 11-12. the quantized CNN path ---------------------------------------------
    q_tot, q_launch = cnn_quant_phases(
        compress_main, ["--arch", "mobilenetv2", "--oracle", "wallclock",
                        "--max-span", "6", "--batch", "8"],
        cnn_oracle, cnn_h, batches, orig_graph, dev, (8, 1000))
    tot.update(q_tot)
    launches.update({k: q_launch[k] for k in q_tot})

    # 13-14. the quantized transformer path -------------------------------------
    tot["merged_ffn_q"], lq_launch, serve_rows["smollm-135m w8a8"] = \
        lm_quant_phases(host, res, oracle, lm_source, prompt, N, c_dec, dev)
    launches["merged_ffn_q"] = lq_launch["merged_ffn_q"]

    # 15-17. RecurrentGemma-2B ----------------------------------------------------
    rg_rows, rg_launch, rg_art, rg_serve = rg_phases(dev, build_host)
    serve_rows.update(rg_serve)

    # 18. ragged requests through the slot scheduler ----------------------------
    lm_arts = (("smollm-135m", lm_art, 24), ("recurrentgemma-2b", rg_art, 8))
    req_rows, solos = request_phase(dev, lm_arts)

    # 19. the continuous engine ----------------------------------------------
    cont_rows = continuous_phase(lm_arts, solos, req_rows)
    del rg_art, lm_arts
    with open(os.path.join(WORK, "serve.json"), "w") as f:
        json.dump({"loops": serve_rows, "requests": req_rows,
                   "continuous": cont_rows}, f, indent=1)
    for k in ("rmsnorm", "rglru_scan", "flash_attention"):
        tot[k] = next(r for r in rg_rows if r["kernel"] == k)
        launches[k] = rg_launch[k]
    sweep_err = {k: v[0] for k, v in sweep.items()}

    srcs = {"merged_conv": ("src/repro_torch/kernels/csrc/merged_conv.cu",
                            "src/repro/kernels/merged_conv.py:347"),
            "depthwise_conv": ("src/repro_torch/kernels/csrc/"
                               "depthwise_conv.cu",
                               "src/repro/kernels/depthwise_conv.py:280"),
            "merged_ffn": ("src/repro_torch/kernels/csrc/merged_ffn.cu",
                           "src/repro/kernels/merged_ffn.py:128"),
            "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:32"),
            "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                           "src/repro/kernels/rglru_scan.py:45"),
            "flash_attention": ("src/repro_torch/kernels/csrc/"
                                "flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:78")}
    for k in ("merged_conv", "depthwise_conv", "merged_ffn"):
        srcs[k + "_q"] = srcs[k]          # the same pallas_call, quant=True
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k][0],
        "replaces": srcs[k][1], "launches": launches[k],
        "max_abs_err": max(v["max_abs_err"], sweep_err[k]),
        "ms": v["ms"], "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"],
        "bound_by": "bytes" if v["bytes_ms"] >= v["flops_ms"]
        else "operations", "bound_rate": v.get("bound_rate", FFMA_RATE),
        "library_ms": v["library_ms"]} for k, v in tot.items()]}
    for v in line["kernels"]:
        check_bound(v["name"], v["ms"], v["bound_ms"])
    print(f"[total] {time.perf_counter() - t_all:.2f}s", flush=True)
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
