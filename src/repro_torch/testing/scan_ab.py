"""Time two checkouts' RG-LRU scan kernels on the card in one process, in
turns.

    PYTHONPATH=src python -m repro_torch.testing.scan_ab PARENT . [--reps N]

Each root is a checkout of the repository (a parent unpacked with ``git
archive`` into a gitignored directory, and this one).  Each root's
``repro_torch`` is imported under a package name of its own, so the two
checkouts' kernels (each built from its own source into its own
``build/``) run side by side on the same inputs, and every repetition
times them in the order A, B, B, A with this checkout's
``chip_smoke.kernel_time`` (cold L2, CUDA-graph replays).  Shapes are
RecurrentGemma-2B's scans (``SHAPES``: the probe and training 8 × 128, the
prompts' 8 × 16, one step).  Each checkout's forward op is held bitwise
against the plain version first, and its backward kernel, where it has
one, against ``rglru_scan_bwd_ref``.  Beside them, once a repetition,
``torch.add(a, b)`` on the same operands (the forward's bytes, two read
and one written, not its function: one elementwise launch of PyTorch on
them) and, at 8 × 128, each checkout's gradient through the op as a train
step takes it (CUDA events around eager ``torch.autograd.grad`` calls).
Prints the card's name and power limit, then one JSON line: every sample
and the median of each, by shape and checkout.  Needs the card.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

#: (B, S, C): RecurrentGemma-2B's scans on the path.
SHAPES = ((8, 128, 2560), (8, 16, 2560), (8, 1, 2560))


def load_kernels(root: str, alias: str):
    """``repro_torch.kernels`` of the checkout at ``root``, imported as the
    package ``alias`` (its relative imports stay inside that checkout)."""
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(alias + ".kernels")


def main(argv) -> int:
    reps = 3
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("scan_ab times the card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.device import resolve
    from repro_torch.kernels import ref

    dev = resolve("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ks = {r: load_kernels(r, f"_scan_ab{n}") for n, r in enumerate(argv)}
    for k in ks.values():
        importlib.import_module(k.__name__ + ".cuda_build").build(
            ["rglru_scan"])
    g = torch.Generator().manual_seed(28)
    out: dict = {}
    for b, s, c in SHAPES:
        a = (torch.rand(b, s, c, generator=g) * 0.5 + 0.5).to(dev)
        x = (torch.randn(b, s, c, generator=g) * 0.1).to(dev)
        w = torch.randn(b, s, c, generator=g).to(dev)
        h = ref.rglru_scan_ref(a, x)
        want = ref.rglru_scan_bwd_ref(a, h, w)
        runs = {}
        for r, k in ks.items():
            if not torch.equal(k.rglru_scan_op(a, x), h):
                raise SystemExit(f"{r}: rglru_scan {(b, s, c)} is not "
                                 "bitwise the plain version")
            runs[f"{r} forward"] = (lambda k=k: k.rglru_scan_op(a, x))
            bwd = getattr(importlib.import_module(k.__name__ + ".rglru_scan"),
                          "rglru_scan_bwd", None)
            if bwd is not None:
                da, db = bwd(a, h, w)
                if not (torch.equal(da, want[0]) and torch.equal(db, want[1])):
                    raise SystemExit(f"{r}: rglru_scan_bwd {(b, s, c)} is not "
                                     "bitwise the plain version")
                runs[f"{r} backward"] = (lambda bwd=bwd: bwd(a, h, w))
        row = out.setdefault(str((b, s, c)), {})
        order = list(argv) + list(argv)[::-1]
        for _ in range(reps):
            for r in order:
                for name, fn in runs.items():
                    if name.startswith(r + " "):
                        row.setdefault(name, []).append(cs.kernel_time(fn))
            row.setdefault("add", []).append(
                cs.kernel_time(lambda: torch.add(a, x)))
        if s == 128:
            for r, k in ks.items():
                leaves = [a.clone().requires_grad_(),
                          x.clone().requires_grad_()]
                row[f"{r} op gradient eager"] = [cs.cuda_time(
                    lambda: torch.autograd.grad(k.rglru_scan_op(*leaves),
                                                leaves, w),
                    iters=5, warmup=2)]
        for name in list(row):
            row[name] = {"median_ms": statistics.median(row[name]),
                         "ms": row[name]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
