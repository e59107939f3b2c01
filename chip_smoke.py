#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # card, build and kernel checks only

Phases, each printing its own line with the seconds it took:

1. card    — ``nvidia-smi`` name and power limit; TF32 off.
2. build   — both hand-written kernels from ``src/repro_torch/kernels/csrc``
             with ``nvcc`` (in parallel), with ``-Xptxas -v`` resources.
3. kernels — each kernel against its plain PyTorch version on the card over
             strides {1,2,3} × k {1,2,3,5,7,11}, ragged shapes, every
             activation, no bias, and the depthwise / channel-multiplier /
             grouped cases.
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
7. resnet34 — ResNet34 at full width with the analytic oracle: lower,
             execute on the card (pool, projection shortcuts, the 7×7
             stride-2 stem), and hold against the CPU port.

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

IMPORT_ERROR = ("chip_smoke.py runs from a checkout of the repository: "
                "src/repro_torch is missing")


def log(phase: str, t0: float, msg: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s {msg}".rstrip(),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_time(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
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
        t["ms"] += cuda_time(run)
        t["plain_ms"] += cuda_time(plain)
        t["library_ms"] += cuda_time(library)
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
    for k, v in launches.items():
        check(v > 0, f"kernel {k} never launched on the main path")

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

    srcs = {"merged_conv": ("src/repro_torch/kernels/csrc/merged_conv.cu",
                            "src/repro/kernels/merged_conv.py:347"),
            "depthwise_conv": ("src/repro_torch/kernels/csrc/"
                               "depthwise_conv.cu",
                               "src/repro/kernels/depthwise_conv.py:280")}
    line = {"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k][0],
        "replaces": srcs[k][1], "launches": launches[k],
        "max_abs_err": max(v["max_abs_err"], sweep[k][0]),
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
