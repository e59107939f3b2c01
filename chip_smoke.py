#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # card, build and kernel checks only

Phases, each printing its own line with the seconds it took:

1. card    — ``nvidia-smi`` name and power limit; TF32 off.
2. build   — the three hand-written kernels from
             ``src/repro_torch/kernels/csrc`` with ``nvcc`` (in parallel),
             with ``-Xptxas -v`` resources.
3. kernels — each kernel against its plain PyTorch version on the card:
             the convs over strides {1,2,3} × k {1,2,3,5,7,11}, ragged
             shapes, every activation, no bias, and the depthwise /
             channel-multiplier / grouped cases; merged_ffn over
             M {1,8,37,1024} × D {32,96,576} × R {1,24,576,1152,1536}
             (1536: the replaced path's unmerged SmolLM FFN).
4. compress — the main path: ``python -m repro_torch.compress`` on
             MobileNetV2 at full width (224², width 1.0, 1000 classes,
             batch 8, ``--max-span 6``, budget 0.6), latency tables timed
             on the card through the kernels (wall-clock oracle).
5. serve   — the artifact loaded on the card classifies seeded batches
             through ``execute``; every batch's logits are held against the
             same artifact on the CPU (plain versions) and against
             ``apply_replaced`` of the plan (merge exactness); CUDA-event latency of the original
             against the merged network.  The kernels' launch counts of
             phases 4-5 (counted from zero) must both be > 0.
6. main-path kernels — each conv unit of the merged MobileNetV2 graph, at
             its shape and weights: kernel against plain version, and the
             time of kernel, plain version and the one-call library
             yardstick (``F.conv2d``, cuDNN, TF32 off) beside the bound.
             Times are device times: 50 calls captured in a CUDA graph
             and replayed (:func:`kernel_time`).
7. resnet34 — ResNet34 at full width with the analytic oracle: lower,
             execute on the card (pool, projection shortcuts, the 7×7
             stride-2 stem), and hold against the CPU port.
8. lm compress — the transformer path: SmolLM-135M at full width in fp32
             (random weights, seed 0), ``CostEnv(batch=8, seq=128)``,
             ``method="depth"``, latency tables timed on the card (the
             lowrank probes through merged_ffn), budgets 0.6, 0.7, ... up
             to the first whose plan merges an FFN; that artifact is
             saved.  The ``layermerge`` 0.6 plan's census is printed
             beside it.
9. lm serve — the artifact loaded on the card serves 8 seeded prompts of
             16 tokens with 32 greedy tokens (``serve_loop``, KV cache);
             every step's logits, teacher-forced with the card's tokens,
             are held against the same artifact on the CPU, and the
             prefill forward against ``replaced_apply``; CUDA-event
             prefill/decode time against the original model.  merged_ffn's
             launch count over phases 8-9 (counted from zero) must be > 0.
10. merged_ffn shapes — the kernel at the path's shapes (each lowrank
             unit at M = 8, one decode step; one at M = 1024, a probe):
             kernel, plain version, ``torch.addmm(x, x @ U, V)`` (two
             cuBLAS calls) and the bound, as device times (phase 6).

Any failed check raises, so the script exits non-zero.  It exits non-zero
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
H100_HBM_BW = 3.35e12            # bytes/s, data sheet

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

IMPORT_ERROR = ("chip_smoke.py runs from a checkout of the repository: "
                "src/repro_torch is missing")


def log(phase: str, t0: float, msg: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s {msg}".rstrip(),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def kernel_time(fn) -> float:
    """Device milliseconds per call of ``fn``: 50 calls captured in a
    CUDA graph and replayed 5 times (the wall-clock oracle's protocol), so
    that host dispatch does not hide a kernel's own time."""
    from repro_torch.core import WallClockOracle
    return WallClockOracle(warmup=3, iters=250, groups=5).time_callable(
        fn) * 1e3


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

def compare_kernel(kind, x, w, b, stride, groups=None, activation=None):
    """Run the kernel op and its plain version on the same card inputs;
    returns (max |Δ|, max |Δ| / scale); raises beyond the tolerance."""
    import torch
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
    yr = ref.apply_activation(yr, activation)
    torch.cuda.synchronize()
    check(y.shape == yr.shape, f"{kind}: shape {tuple(y.shape)} vs "
          f"{tuple(yr.shape)}")
    check(bool(torch.isfinite(y).all()), f"{kind}: non-finite output")
    err = (y - yr).abs()
    bad = err > RTOL * scale + ATOL
    rel = float((err / (scale + ATOL)).max())
    check(not bool(bad.any()),
          f"{kind} x={tuple(x.shape)} w={tuple(w.shape)} s={stride} "
          f"g={groups} act={activation}: max|Δ|={float(err.max()):.3g} "
          f"rel={rel:.3g} beyond rtol={RTOL}")
    return float(err.max()), rel


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
            for groups, cin_g, cout_g in ((13, 1, 1), (6, 1, 3), (3, 4, 5)):
                cout = groups * cout_g
                bias = None if n % 3 == 0 else rnd(cout)
                note("depthwise_conv", compare_kernel(
                    "depthwise_conv", rnd(2, *hw, groups * cin_g),
                    rnd(k, k, cin_g, cout) / k, bias, s, groups=groups,
                    activation=act))
                n += 1
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


def time_main_path_kernels(graph, dev, batch: int) -> dict:
    """Per-kernel sums over the merged graph's conv units: worst error,
    kernel / plain / library milliseconds, FLOPs, bytes and bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(1)
    tot = {k: {"units": 0, "max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
               "bytes": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "flops_ms": 0.0, "shapes": []}
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

            def plain():
                return ref.depthwise_conv_ref(x, w, b, stride=s,
                                              groups=groups)
        else:
            def run():
                return kernels.merged_conv_op(x, w, b, stride=s)

            def plain():
                return ref.merged_conv_ref(x, w, b, stride=s)
        x_cl = x.permute(0, 3, 1, 2)              # NHWC viewed channels_last
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(x_cl, w_oihw, b, stride=s, groups=groups)
        t = tot[kind]
        t["ms"] += kernel_time(run)
        t["plain_ms"] += kernel_time(plain)
        t["library_ms"] += kernel_time(library)
        n, hp, wp, _ = shape
        ho, wo = (hp - kh) // s + 1, (wp - kw) // s + 1
        flops = 2.0 * n * ho * wo * cout * kh * kw * cin_g
        nbytes = 4.0 * (x.numel() + w.numel() + b.numel() + n * ho * wo * cout)
        t["flops"] += flops
        t["bytes"] += nbytes
        f_ms, b_ms = flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BW * 1e3
        t["flops_ms"] += f_ms
        t["bytes_ms"] += b_ms
        t["bound_ms"] += max(f_ms, b_ms)
        t["units"] += 1
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["max_rel_err"] = max(t["max_rel_err"], rel)
        t["shapes"].append({"x": list(shape), "w": list(w.shape),
                            "stride": s})
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
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref

    y = kernels.merged_ffn_op(x, u, v)
    yr = ref.merged_ffn_ref(x, u, v)
    scale = ref.merged_ffn_ref(x.abs(), u.abs(), v.abs())
    torch.cuda.synchronize()
    check(y.shape == yr.shape, f"merged_ffn: shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "merged_ffn: non-finite output")
    err = (y - yr).abs()
    rel = float((err / (scale + ATOL)).max())
    check(not bool((err > RTOL * scale + ATOL).any()),
          f"merged_ffn x={tuple(x.shape)} u={tuple(u.shape)}: max|Δ|="
          f"{float(err.max()):.3g} rel={rel:.3g} beyond rtol={RTOL}")
    return float(err.max()), rel


def ffn_sweep(dev):
    """merged_ffn against its plain version over ragged M, D and R."""
    import torch
    g = torch.Generator().manual_seed(2)
    worst = [0.0, 0.0, 0]
    for m in (1, 8, 37, 1024):
        for d in (32, 96, 576):
            for r in (1, 24, 576, 1152, 1536):
                x = torch.randn(m, d, generator=g).to(dev)
                u = (torch.randn(d, r, generator=g) / d ** 0.5).to(dev)
                v = (torch.randn(r, d, generator=g) / r ** 0.5).to(dev)
                err, rel = compare_ffn(x, u, v)
                worst = [max(worst[0], err), max(worst[1], rel), worst[2] + 1]
    return worst


def ffn_bound(m: int, d: int, r: int) -> tuple[float, float]:
    """(operations ms, bytes ms) of x + (x@U)@V: 4·M·D·R FLOPs at the fp32
    peak; x, U, V read once and y written once at the HBM rate."""
    flops = 4.0 * m * d * r
    nbytes = 4.0 * (2 * m * d + 2 * d * r)
    return flops / H100_FP32_FLOPS * 1e3, nbytes / H100_HBM_BW * 1e3


def time_ffn(x, u, v) -> dict:
    """Kernel, plain and library ms of one merged_ffn shape, beside its
    bound.  The library yardstick is ``torch.addmm(x, x @ U, V)``: two
    cuBLAS calls (TF32 off), timed here and used nowhere in the port."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ref

    err, rel = compare_ffn(x, u, v)
    f_ms, b_ms = ffn_bound(x.shape[0], x.shape[1], u.shape[1])
    return {"m": x.shape[0], "d": x.shape[1], "r": u.shape[1],
            "max_abs_err": err, "max_rel_err": rel,
            "ms": kernel_time(lambda: kernels.merged_ffn_op(x, u, v)),
            "plain_ms": kernel_time(lambda: ref.merged_ffn_ref(x, u, v)),
            "library_ms": kernel_time(lambda: torch.addmm(x, x @ u, v)),
            "eager_ms": cuda_time(lambda: kernels.merged_ffn_op(x, u, v)),
            "flops_ms": f_ms, "bytes_ms": b_ms, "bound_ms": max(f_ms, b_ms)}


def forced_logits(step, cache, tokens):
    """``(B, T, V)`` logits of feeding ``tokens`` (B, T) one at a time."""
    import torch
    out = []
    for t in range(tokens.shape[1]):
        logits, cache = step(cache, tokens[:, t:t + 1])
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def unit_census(graph) -> str:
    from repro_torch import runtime
    return json.dumps(runtime.count_units(graph), sort_keys=True)


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
    log("kernels", t0, json.dumps(
        {k: {"cases": v[2], "max_abs_err": v[0], "max_rel_err": v[1]}
         for k, v in sweep.items()}))
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
    summary = compress_main(argv_c)
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
    host, _ = build_host("mobilenetv2", seed=0, batch=8, max_span=6,
                         device="cuda")
    d_cpu = d_rep = 0.0                 # worst over the served batches
    for xb, y in zip(batches, outs):
        y_cpu = art_cpu.apply(xb)
        d_cpu = max(d_cpu, float((y.cpu() - y_cpu).abs().max()
                                 / y_cpu.abs().max()))
        y_rep = cnn.apply_replaced(host.net, host.params, xb.to(dev),
                                   art.plan)
        d_rep = max(d_rep, float((y - y_rep).abs().max()
                                 / y_rep.abs().max()))
    orig_graph = host.lower_plan(identity_plan(host.net.L, host.descs()))
    xb = batches[0].to(dev)
    ms_merged = cuda_time(lambda: art.apply(xb), iters=20)
    ms_orig = cuda_time(lambda: runtime.execute(orig_graph, xb), iters=20)
    busy_us, busy_rows = device_kernels(lambda: art.apply(xb))
    launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    art.apply(xb)
    per_forward = kernels.launch_counts()
    log("serve", t0, f"units {census}; {len(batches)} batches, worst logits "
        f"vs CPU port {d_cpu:.3g}, vs apply_replaced {d_rep:.3g} (limit "
        f"{NET_RTOL}); batch-8 forward "
        f"original {ms_orig:.3f} ms, merged {ms_merged:.3f} ms "
        f"({ms_orig / ms_merged:.3f}x); launches phases 4-5 {launches}, per "
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
    with open(os.path.join(WORK, "units.json"), "w") as f:
        json.dump(tot, f, indent=1)
    log("main-path kernels", t0, " ".join(
        f"{k}: {v['units']} units ms={v['ms']:.4f} plain={v['plain_ms']:.4f} "
        f"library={v['library_ms']:.4f} bound={v['bound_ms']:.4f}"
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

    # 8. transformer compress ---------------------------------------------------
    from repro_torch.core import WallClockOracle, compress
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
    c_pre, c_dec, c_logits, seqs = serving.serve_loop(
        c_step, lambda: lm_art.init_cache(B, P + N), prompt, N)
    o_pre, o_dec, _, _ = serving.serve_loop(
        o_step, lambda: T.init_cache(cfg, B, P + N, device=dev), prompt, N)
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
    kernels.reset_launch_counts()
    lm_art.decode(lm_art.init_cache(B, P + N), prompt[:, :1])
    per_step = kernels.launch_counts()["merged_ffn"]
    steps = N - 1
    log("lm serve", t0, f"{B} prompts x {P} tokens, {N} new; worst step "
        f"logits vs CPU port {d_lm_cpu:.3g} (last step {d_last:.3g}), "
        f"prefill vs replaced_apply {d_lm_rep:.3g} (limit {NET_RTOL}); "
        f"compressed prefill {c_pre * 1e3:.3f} ms, decode {c_dec * 1e3:.3f} "
        f"ms ({serving.decode_tok_s(steps, B, c_dec):.1f} tok/s); original "
        f"prefill {o_pre * 1e3:.3f} ms, decode {o_dec * 1e3:.3f} ms "
        f"({serving.decode_tok_s(steps, B, o_dec):.1f} tok/s); decode "
        f"speedup {o_dec / c_dec:.3f}x (predicted {res.speedup:.4f}x); "
        f"merged_ffn launches per decode step {per_step}; phases 8-9 "
        f"launches {lm_launches}")
    for label, step, cache, dec_s in (
            ("compressed", c_step, lm_art.init_cache(B, P + N), c_dec),
            ("original", o_step, T.init_cache(cfg, B, P + N, device=dev),
             o_dec)):
        tok = prompt[:, :1]
        busy_us, rows = device_kernels(lambda: step(cache, tok))
        share = busy_us * 1e-6 / (dec_s / steps)
        print(f"  {label} decode step, torch.profiler: device busy "
              f"{busy_us:.1f} us per step = {share:.3f} of its served step "
              "time; by kernel: " + "; ".join(
                  f"{name[:60]} {us:.1f}us x{n}" for us, n, name in rows[:6]),
              flush=True)
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
    with open(os.path.join(WORK, "ffn.json"), "w") as f:
        json.dump({"decode_units": per_unit, "decode_step": step_tot,
                   "probe_m1024": probe}, f, indent=1)
    d1 = per_unit[0]
    log("merged_ffn shapes", t0, " ".join(
        f"M={r['m']} D={r['d']} R={r['r']}: ms={r['ms']:.4f} (eager "
        f"call {r['eager_ms']:.4f}) plain={r['plain_ms']:.4f} "
        f"library(addmm, 2 cuBLAS calls)="
        f"{r['library_ms']:.4f} bound={r['bound_ms']:.5f} ("
        f"{'bytes' if r['bytes_ms'] >= r['flops_ms'] else 'operations'}, "
        f"share {r['bound_ms'] / r['ms']:.3f});" for r in (d1, probe))
        + f" decode step ({len(per_unit)} units): ms={step_tot['ms']:.4f} "
        f"plain={step_tot['plain_ms']:.4f} "
        f"library={step_tot['library_ms']:.4f} "
        f"bound={step_tot['bound_ms']:.5f}")
    tot["merged_ffn"] = step_tot
    launches["merged_ffn"] = lm_launches["merged_ffn"]
    sweep_err = {k: v[0] for k, v in sweep.items()}

    srcs = {"merged_conv": ("src/repro_torch/kernels/csrc/merged_conv.cu",
                            "src/repro/kernels/merged_conv.py:347"),
            "depthwise_conv": ("src/repro_torch/kernels/csrc/"
                               "depthwise_conv.cu",
                               "src/repro/kernels/depthwise_conv.py:280"),
            "merged_ffn": ("src/repro_torch/kernels/csrc/merged_ffn.cu",
                           "src/repro/kernels/merged_ffn.py:128")}
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k][0],
        "replaces": srcs[k][1], "launches": launches[k],
        "max_abs_err": max(v["max_abs_err"], sweep_err[k]),
        "ms": v["ms"], "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"],
        "bound_by": "bytes" if v["bytes_ms"] >= v["flops_ms"]
        else "operations",
        "library_ms": v["library_ms"]} for k, v in tot.items()]}
    print(f"[total] {time.perf_counter() - t_all:.2f}s", flush=True)
    print(json.dumps(line))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
