"""One-command compression + artifact export, on the card.

Runs the pipeline (tables → DP → merge) on a CNN of the zoo and publishes
a merged-model artifact in the JAX package's ``.npz`` format:

  PYTHONPATH=src python -m repro_torch.compress --arch mobilenetv2 \
      --oracle wallclock --max-span 6 --budget-ratio 0.6 --out a.npz

``--oracle wallclock`` times every distinct merged-segment shape on the
card through the hand-written kernels; ``--oracle analytic`` prices them
with the H100 roofline model.  ``--device cpu`` runs the plain PyTorch
versions instead (the default, ``cuda``, raises where there is no card).
Parameters are seed-initialised: the command demonstrates the
plan→artifact path, a production run would load trained weights.
"""
from __future__ import annotations

import argparse
import json

CNN_ARCHS = {
    "tiny_resnet": lambda zoo: zoo.tiny_resnet(
        num_classes=4, in_hw=16, width=8, blocks=(2, 2)),
    "tiny_mobilenet": lambda zoo: zoo.tiny_mobilenet(
        num_classes=4, in_hw=16, width=8),
    "tiny_unet": lambda zoo: zoo.tiny_unet(in_hw=16, base=8),
    "resnet34": lambda zoo: zoo.resnet34(),
    "mobilenetv2": lambda zoo: zoo.mobilenetv2(),
    "ddpm_unet": lambda zoo: zoo.ddpm_unet(),
}


def build_host(arch: str, *, seed: int = 0, batch: int = 8,
               max_span: int | None = None, device="cuda"):
    """(host, source-dict) for a named CNN of the zoo, parameters drawn
    from ``torch.Generator().manual_seed(seed)``."""
    import torch

    from repro_torch.device import resolve
    from repro_torch.models import cnn, cnn_host, zoo

    if arch not in CNN_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port has the CNN zoo "
                         f"({', '.join(CNN_ARCHS)})")
    dev = resolve(device)
    net = CNN_ARCHS[arch](zoo)
    params = cnn.init_params(net, torch.Generator().manual_seed(seed),
                             device=dev)
    host = cnn_host.CNNHost(net, params, batch=batch, max_span=max_span,
                            device=dev)
    return host, {"arch": arch, "seed": seed, "family": "cnn"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compress",
        description="LayerMerge compression → merged-model artifact")
    ap.add_argument("--arch", required=True, choices=tuple(CNN_ARCHS))
    ap.add_argument("--budget-ratio", type=float, default=0.6)
    ap.add_argument("--method", default="layermerge",
                    choices=("layermerge", "depth", "layeronly"))
    ap.add_argument("--oracle", default="analytic",
                    choices=("analytic", "wallclock"))
    ap.add_argument("--P", type=int, default=200,
                    help="latency discretization steps (Algorithm 1)")
    ap.add_argument("--out", required=True, help="artifact path (.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-span", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)

    from repro_torch.core import WallClockOracle, compress

    host, source = build_host(args.arch, seed=args.seed, batch=args.batch,
                              max_span=args.max_span, device=args.device)
    oracle = WallClockOracle() if args.oracle == "wallclock" else None
    res = compress(host, budget_ratio=args.budget_ratio, P=args.P,
                   method=args.method, latency_oracle=oracle)
    if res is None:
        raise SystemExit(
            f"[repro_torch.compress] infeasible: no plan fits "
            f"budget_ratio={args.budget_ratio} for {args.arch}")
    fp = res.save(args.out, extra_meta={"source": source})
    plan = res.plan
    stats = res.tables.stats if res.tables is not None else None
    summary = {
        "arch": args.arch,
        "method": args.method,
        "oracle": args.oracle,
        "device": str(host.device),
        "budget_ratio": args.budget_ratio,
        "layers": plan.num_layers,
        "kept_layers": len(plan.C),
        "segments": len(plan.segments),
        "latency_probes": stats.num_latency_probes if stats else 0,
        "latency_signatures": stats.num_latency_buckets if stats else 0,
        "signatures_timed": stats.num_timings if stats else 0,
        "original_latency_s": res.original_latency,
        "compressed_latency_s": res.compressed_latency,
        "predicted_speedup": res.speedup,
        "artifact": args.out,
        "fingerprint": fp[:16],
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
