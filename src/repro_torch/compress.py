"""One-command compression + artifact export, on the card.

Runs the pipeline (tables → DP → merge) on a CNN of the zoo or a
transformer config and publishes a merged-model artifact in the JAX
package's ``.npz`` format:

  PYTHONPATH=src python -m repro_torch.compress --arch mobilenetv2 \
      --oracle wallclock --max-span 6 --budget-ratio 0.6 --out a.npz
  PYTHONPATH=src python -m repro_torch.compress --arch smollm-135m \
      --method depth --out lm.npz
  PYTHONPATH=src python -m repro_torch.compress --arch recurrentgemma-2b \
      --device cpu --method depth --budget-ratio 0.9 --out rg.npz
  PYTHONPATH=src python -m repro_torch.compress \
      --arch granite-moe-1b-a400m --device cpu --method layermerge \
      --budget-ratio 0.9 --out g.npz
  PYTHONPATH=src python -m repro_torch.compress --arch tiny_mobilenet \
      --device cpu --quantize w8a8 --budget-ratio 0.5 --out q.npz
  PYTHONPATH=src python -m repro_torch.compress --arch mobilenetv2 \
      --oracle wallclock --max-span 6 --cache-dir tables/ \
      --probe-timeout 2 --probe-retries 2 --out a.npz
  PYTHONPATH=src python -m repro_torch.compress --arch mobilenetv2 \
      --oracle wallclock --max-span 6 --cache-dir tables/ --workers 2 \
      --out a.npz

Transformer ids (all ten of the JAX package's) resolve through
:func:`repro_torch.configs.get_config`, reduced to the CPU-sized toy
variant unless ``--full``: the full width and depth, in fp32 (the
published configs are bf16, which rank merging cannot factor yet:
ROADMAP.md queue 3).  A chain with no FFN (the MoE and xLSTM configs)
has nothing to merge: ``--method depth`` keeps every sublayer there,
``layermerge`` prunes.
``--oracle wallclock`` times every distinct merged-segment shape on the
card through the hand-written kernels; ``--oracle analytic`` prices them
with the H100 roofline model (transformers: the JAX package's cost
model).  ``--quantize int8|w8a8`` lets the DP choose per-unit precision
(int8 weights, or int8 weights and activations); the units it picks run
the kernels' quantized variants.  ``--cache-dir`` keeps the tables in a
content-addressed cache (a second run with the same inputs reads them and
times nothing) and journals a build while it runs, so a killed run
resumes where it stopped (``--no-resume`` starts it over);
``--probe-timeout`` and ``--probe-retries`` bound each card timing, and
a probe that keeps failing gets the analytic estimate, flagged in the
artifact's ``probe_provenance``.  ``--workers N`` fans the latency probes
out over N worker processes on the same device
(:mod:`repro_torch.core.dist_build`: leases, shard merge, a killed
worker's items reassigned; needs ``--cache-dir``, coordinates in
``--work-dir``, under the cache by default); the summary's ``"dist"``
block reports the fan-out, and a failed fan-out exits 3.
``--device cpu`` runs the plain PyTorch
versions instead (the default, ``cuda``, raises where there is no card).
Parameters are seed-initialised: the command demonstrates the
plan→artifact path, a production run would load trained weights.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def build_host(arch: str, *, seed: int = 0, batch: int = 8, seq: int = 128,
               full: bool = False, max_span: int | None = None,
               device="cuda"):
    """(host, source-dict) for a named CNN of the zoo or a transformer
    config id, parameters drawn from ``torch.Generator().manual_seed(seed)``."""
    import torch

    from repro_torch.device import resolve

    dev = resolve(device)
    gen = torch.Generator().manual_seed(seed)
    source = {"arch": arch, "seed": seed}
    if arch in CNN_ARCHS:
        from repro_torch.models import cnn, cnn_host, zoo

        net = CNN_ARCHS[arch](zoo)
        params = cnn.init_params(net, gen, device=dev)
        host = cnn_host.CNNHost(net, params, batch=batch, max_span=max_span,
                                device=dev)
        source["family"] = "cnn"
        return host, source
    from repro_torch.configs import ArchConfig, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer_host import CostEnv, TransformerHost

    try:
        cfg = get_config(arch)
    except KeyError as e:
        raise ValueError(f"unknown arch {arch!r}; the port has the CNN zoo "
                         f"({', '.join(CNN_ARCHS)}) and {e}") from None
    if not isinstance(cfg, ArchConfig):
        raise ValueError(f"arch {arch!r} names a CNN config; the command "
                         f"takes CNNs by their zoo names "
                         f"({', '.join(CNN_ARCHS)})")
    cfg = dataclasses.replace(cfg, dtype="float32", remat=False) if full \
        else cfg.reduced()
    params, _ = T.init_model(cfg, gen, device=dev)
    host = TransformerHost(cfg, params, env=CostEnv(batch=batch, seq=seq),
                           max_span=max_span, device=dev)
    source.update(family="transformer", reduced=not full)
    return host, source


def main(argv=None, *, latency_oracle=None) -> dict:
    """Run the command; ``latency_oracle`` replaces the one ``--oracle``
    names (a caller's ``WallClockOracle`` then times each signature once
    for several runs)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compress",
        description="LayerMerge compression → merged-model artifact")
    ap.add_argument("--arch", required=True,
                    help=f"CNN zoo ({', '.join(CNN_ARCHS)}) or a "
                         "transformer config id (smollm-135m, "
                         "granite-moe-1b-a400m, xlstm-125m, qwen2-vl-7b, "
                         "...: configs.ARCH_IDS)")
    ap.add_argument("--budget-ratio", type=float, default=0.6)
    ap.add_argument("--method", default="layermerge",
                    choices=("layermerge", "depth", "layeronly"))
    ap.add_argument("--oracle", default="analytic",
                    choices=("analytic", "wallclock"))
    ap.add_argument("--P", type=int, default=200,
                    help="latency discretization steps (Algorithm 1)")
    ap.add_argument("--quantize", default="none",
                    choices=("none", "int8", "w8a8"),
                    help="let the DP pick per-unit precision: widens the "
                         "tables with int8-weight (int8) or int8-weight+"
                         "activation (w8a8) candidates; chosen segments "
                         "lower to narrow-weight units (artifact v3)")
    ap.add_argument("--out", required=True, help="artifact path (.npz)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length for the transformer cost env")
    ap.add_argument("--max-span", type=int, default=None)
    ap.add_argument("--full", action="store_true",
                    help="transformer: full config in fp32, not .reduced()")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--cache-dir", default=None,
                    help="lookup-table cache directory (optional)")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="resume an interrupted table build from its "
                         "write-ahead journal in --cache-dir (default on; "
                         "--no-resume discards a stale journal)")
    ap.add_argument("--probe-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="per-probe time budget; a probe over budget "
                         "retries, then gets the analytic estimate")
    ap.add_argument("--probe-retries", type=int, default=2,
                    help="attempts per failing probe before quarantine")
    ap.add_argument("--workers", type=int, default=0,
                    help="fan the latency probes out over N worker "
                         "processes with lease-based reassignment (needs "
                         "--cache-dir; the tables are the workers' "
                         "records)")
    ap.add_argument("--work-dir", default=None,
                    help="shared coordination directory for --workers "
                         "(default: under --cache-dir)")
    args = ap.parse_args(argv)

    from repro_torch.core import (DistBuildError, ProbeConfig,
                                  WallClockOracle, compress)

    host, source = build_host(args.arch, seed=args.seed, batch=args.batch,
                              seq=args.seq, full=args.full,
                              max_span=args.max_span, device=args.device)
    oracle = latency_oracle
    if oracle is None and args.oracle == "wallclock":
        oracle = WallClockOracle()
    timed = getattr(oracle, "num_timed", 0)
    host_spec = {"factory": "repro_torch.testing.hosts:cli_host",
                 "kwargs": {"arch": args.arch, "seed": args.seed,
                            "batch": args.batch, "seq": args.seq,
                            "full": args.full, "max_span": args.max_span,
                            "device": str(host.device)}}
    try:
        res = compress(host, budget_ratio=args.budget_ratio, P=args.P,
                       method=args.method, latency_oracle=oracle,
                       quantize=args.quantize, cache_dir=args.cache_dir,
                       probe_config=ProbeConfig(
                           timeout_s=args.probe_timeout,
                           retries=args.probe_retries),
                       resume=args.resume, workers=args.workers,
                       host_spec=host_spec, work_dir=args.work_dir)
    except DistBuildError as e:
        print(f"[repro_torch.compress] distributed build failed: {e}")
        raise SystemExit(3)
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
        # signatures timed on the card by this run, T_orig's included
        "signatures_timed": getattr(oracle, "num_timed", 0) - timed,
        "cache_hit": bool(stats and stats.cache_hit),
        "journal_hits": stats.num_journal_hits if stats else 0,
        "retried": stats.num_probe_retries if stats else 0,
        "retimed": stats.num_retimed if stats else 0,
        "quarantined": stats.num_quarantined if stats else 0,
        "original_latency_s": res.original_latency,
        "compressed_latency_s": res.compressed_latency,
        "predicted_speedup": res.speedup,
        "quantize": args.quantize,
        "quantized_units": sum(1 for s in plan.segments
                               if s.quant != "none"),
        "artifact": args.out,
        "fingerprint": fp[:16],
    }
    if res.dist_report is not None:
        rep = res.dist_report
        summary["dist"] = {"workers": rep.workers, "items": rep.items,
                           "reassigned": len(rep.reassigned),
                           "dead_workers": rep.dead_workers,
                           "cache_hit": rep.cache_hit,
                           "completed_by": rep.completed_by,
                           "coordinator_items": rep.coordinator_items,
                           "wall_s": rep.wall_s,
                           "worker_lines": rep.worker_lines}
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
