"""Deterministic fault injection for the serving engine.

The port's copy of the serving half of the JAX package's
``repro.testing.faults``, with its names, semantics and environment
interface (``REPRO_FAULTS``).  Production code calls :func:`hit(point)`
at a named injection point (and :func:`mangle(point, data)` around a
guarded write); with no plan active both are one ``is None`` check, so
the hooks stay in shipping code.  A test activates a :class:`FaultPlan`
through the :func:`inject` context manager, or a separate process
through ``REPRO_FAULTS``.  Rules are counted per point: ``Fault(point,
action, nth=3, times=2)`` fires on the 3rd and 4th hit of ``point`` only.

Actions: ``"raise"`` (a retryable :class:`FaultError`), ``"kill"`` (a
:class:`FaultKill`, an in-process stand-in for SIGKILL that derives
:class:`BaseException` so no retry loop swallows it), ``"exit"``
(``os._exit``, a real crash), ``"delay"`` (``time.sleep``), ``"torn"``
and ``"garble"`` (a truncated or unparsable guarded write, through
:func:`mangle`), and ``"nan"`` (the declarative ``serve.nan`` rule).

Injection points the port wires:

=====================  =====================================================
``serve.arrival``      per request ingested by the continuous engine
                       (``delay`` ⇒ a stalled frontend or network)
``serve.admit``        per request admitted into a decode slot
``serve.chunk``        before each multi-slot chunk dispatch (``delay`` ⇒
                       a slow-decode straggler chunk)
``serve.nan``          *declarative*: ``nan@serve.nan:rid=R,t=G`` poisons
                       request ``R``'s logits at generation index ``G``
                       inside the captured chunk step (read through
                       :func:`serve_nan_spec`, never :func:`hit`)
``serve.worker``       before each chunk dispatch, raised as
                       :class:`~repro_torch.runtime.serving.WorkerLost`
                       (a lost serving process ⇒ drain, re-form, replay)
=====================  =====================================================

The table-build points of the JAX package (``probe.*``, ``tables.*``,
``journal.*``, ``table_cache.*``, ``dist.*``), its kill-and-resume smoke
and the process-level actions that target a worker subprocess
(``kill-worker``, ``stall-worker``, ``corrupt-shard``) come with the
table cache and build journal (ROADMAP.md queue 1, item 3).

NaN injection cannot go through :func:`hit` (it runs inside a captured
step): :func:`nan_logits_hook` builds a ``logit_hook`` for the fixed-slot
scheduler, and the continuous engine reads request-targeted ``nan``
rules through :func:`serve_nan_spec`.  :class:`TickClock` is the virtual
clock that makes the engine's deadlines and shedding deterministic.

    PYTHONPATH=src python -m repro_torch.testing.faults --serve-smoke \\
        [--device cpu]
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

ACTIONS = ("raise", "kill", "exit", "delay", "torn", "nan", "garble")

#: What a ``garble`` rule leaves on disk: a complete (newline-terminated)
#: but unparsable line.
GARBLED_LINE = b"#garbled journal record#\n"


class FaultError(RuntimeError):
    """An injected *retryable* failure."""


class FaultKill(BaseException):
    """In-process stand-in for SIGKILL.

    Derives :class:`BaseException` so ``except Exception`` retry loops in
    the code under test can never swallow it.
    """


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection rule: at hits ``nth .. nth+times-1`` of ``point``,
    perform ``action``."""

    point: str
    action: str
    nth: int = 1            # 1-based hit index the rule first fires on
    times: int = 1          # consecutive hits it stays armed for
    seconds: float = 0.0    # "delay": sleep duration
    keep_bytes: int = 8     # "torn": bytes of the write that reach disk
    exit_code: int = 17     # "exit": status for the hard crash
    rid: int = -1           # "nan": target request id (serve.nan)
    at: int = -1            # "nan": generation index to poison

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown action {self.action!r}; "
                             f"expected one of {ACTIONS}")

    def armed(self, n: int) -> bool:
        return self.nth <= n < self.nth + self.times


def _fire(rule: Fault, point: str) -> None:
    if rule.action == "raise":
        raise FaultError(f"injected failure at {point}")
    if rule.action == "kill":
        raise FaultKill(f"injected kill at {point}")
    if rule.action == "exit":                # pragma: no cover — dies
        os._exit(rule.exit_code)
    if rule.action == "delay":
        time.sleep(rule.seconds)


class FaultPlan:
    """A set of :class:`Fault` rules with per-point hit counters.

    Thread-safe (counters are guarded).  ``fired`` records ``(point,
    hit_index, action)`` for assertions in tests.
    """

    def __init__(self, *rules: Fault):
        self.rules = tuple(rules)
        self.fired: list[tuple[str, int, str]] = []
        self._counts: dict[str, int] = {}
        self._pending_kill: set[str] = set()
        self._lock = threading.Lock()

    def _arm(self, point: str) -> Fault | None:
        """Count one hit of ``point`` and return the rule it arms."""
        n = self._counts[point] = self._counts.get(point, 0) + 1
        for rule in self.rules:
            if rule.point == point and rule.armed(n):
                self.fired.append((point, n, rule.action))
                return rule
        return None

    def hit(self, point: str) -> None:
        with self._lock:
            rule = self._arm(point)
            kill_pending = point in self._pending_kill
            if kill_pending:
                self._pending_kill.discard(point)
        if kill_pending:                     # completes a torn write
            raise FaultKill(f"torn write at {point}")
        if rule is not None:
            _fire(rule, point)

    def mangle(self, point: str, data: bytes) -> bytes:
        """Apply a ``torn`` or ``garble`` rule to the bytes of a guarded
        write.  The truncated bytes ARE written by the caller; the
        matching ``<point>.done`` hit then kills the process."""
        with self._lock:
            rule = self._arm(point)
            if rule is not None and rule.action == "torn":
                self._pending_kill.add(point + ".done")
                return data[: rule.keep_bytes]
        if rule is None:
            return data
        if rule.action == "garble":
            return GARBLED_LINE
        _fire(rule, point)                   # other rules act as in hit()
        return data


_ACTIVE: FaultPlan | None = None
_ENV_PLAN: FaultPlan | None = None
_ENV_PARSED = False

ENV_VAR = "REPRO_FAULTS"


def parse_env_spec(spec: str) -> FaultPlan:
    """``"action@point:nth[xtimes][~seconds]"`` items, ``;``-separated.

    Examples: ``raise@serve.worker:3`` (lose a worker at the 3rd chunk),
    ``delay@serve.chunk:1x2~0.5`` (0.5 s stragglers on the first two
    chunks).  Request-targeted serve rules use key=value counts instead:
    ``nan@serve.nan:rid=1,t=2`` poisons request 1's logits at generation
    index 2 (see :func:`serve_nan_spec`).
    """
    rules = []
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        action, _, rest = item.partition("@")
        point, _, counts = rest.partition(":")
        if not (action and point):
            raise ValueError(f"bad {ENV_VAR} item {item!r} "
                             "(want action@point[:nth[xtimes][~seconds]])")
        if "=" in counts:                    # key=value form (serve.nan)
            kv = dict(p.split("=", 1) for p in counts.split(","))
            rules.append(Fault(point=point, action=action,
                               rid=int(kv.get("rid", -1)),
                               at=int(kv.get("t", kv.get("at", -1)))))
            continue
        counts, _, seconds = (counts or "1").partition("~")
        nth, _, times = counts.partition("x")
        rules.append(Fault(point=point, action=action, nth=int(nth or 1),
                           times=int(times or 1),
                           seconds=float(seconds or 0.0)))
    return FaultPlan(*rules)


def active() -> FaultPlan | None:
    """The plan in effect: an :func:`inject` context, else ``REPRO_FAULTS``."""
    global _ENV_PLAN, _ENV_PARSED
    if _ACTIVE is not None:
        return _ACTIVE
    if not _ENV_PARSED:
        _ENV_PARSED = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            _ENV_PLAN = parse_env_spec(spec)
    return _ENV_PLAN


def env_reload() -> FaultPlan | None:
    """Re-parse ``REPRO_FAULTS`` after the lazy parse already ran (the
    serve smoke flips it between its clean and faulted passes); returns
    the now-active plan."""
    global _ENV_PLAN, _ENV_PARSED
    _ENV_PLAN = None
    _ENV_PARSED = False
    return active()


def hit(point: str) -> None:
    """Injection point: no-op unless an active plan has a rule for it."""
    plan = active()
    if plan is not None:
        plan.hit(point)


def mangle(point: str, data: bytes) -> bytes:
    """Write-guard injection point: may truncate ``data`` (torn write)."""
    plan = active()
    return data if plan is None else plan.mangle(point, data)


def serve_nan_spec() -> dict[int, int]:
    """Request-targeted NaN rules of the active plan: ``{rid: gen_idx}``.

    The continuous engine reads this per chunk and poisons request
    ``rid``'s logits at generation index ``gen_idx`` inside the captured
    chunk step (the slot↔request binding is dynamic, so the rule names
    the request, not the slot).
    """
    plan = active()
    if plan is None:
        return {}
    return {r.rid: r.at for r in plan.rules
            if r.point == "serve.nan" and r.action == "nan" and r.rid >= 0}


class TickClock:
    """Deterministic virtual clock: every call returns the current time,
    then advances it by ``dt``.  The continuous engine reads its clock
    once per chunk, so under this clock a chunk always "takes" ``dt``
    seconds and shedding and deadline misses are reproducible."""

    def __init__(self, dt: float = 1.0, t0: float = 0.0):
        self.dt = float(dt)
        self.t = float(t0)

    def __call__(self) -> float:
        t = self.t
        self.t += self.dt
        return t


@contextlib.contextmanager
def inject(*rules: Fault):
    """Activate a fault plan for the dynamic extent of the context."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, FaultPlan(*rules)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def nan_logits_hook(slot: int, step: int):
    """A ``logit_hook`` that makes ``slot``'s logits NaN at step ``step``.
    ``t`` is a 0-d device tensor and the hook reads nothing on the host,
    so it runs inside a captured step."""
    import torch

    def hook(logits, t):
        rows = torch.arange(logits.shape[0], device=logits.device) == slot
        bad = rows.view(-1, *([1] * (logits.ndim - 1))) & (t == step)
        return torch.where(bad, torch.nan, logits)
    return hook


# ---------------------------------------------------------------------------
# Continuous-serving fault smoke: one arrival trace served clean, then
# again under a REPRO_FAULTS spec combining a request-targeted NaN, a
# delayed arrival and a slow-decode straggler chunk.
# ---------------------------------------------------------------------------

def serve_fault_smoke(device="cuda") -> dict:
    """Continuous-engine fault smoke (in-process, deterministic).

    Serves four staggered requests on two slots clean, then again under
    ``nan@serve.nan:rid=1,t=2`` + ``delay@serve.arrival`` +
    ``delay@serve.chunk``: request 1 must abort at generation index 2
    while requests 0, 2 and 3 complete with tokens bit-identical to the
    fault-free run, and both delay rules must fire.  The model is the
    reference smoke's (reduced SmolLM-135M: 2 layers, d 64, 4/2 heads,
    head_dim 16, d_ff 128, vocab 128) with weights from seed 0, on
    ``device`` (the card by default).

    The env plan is (re)loaded on the canonical
    ``repro_torch.testing.faults`` module — the one the serving code
    imports — because under ``python -m`` this function runs in
    ``__main__``, another module object.
    """
    import dataclasses as _dc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    from repro_torch.models import transformer as T
    from repro_torch.runtime import serving
    from repro_torch.testing import faults as canonical

    dev = resolve(device)
    cfg = _dc.replace(
        get_config("smollm-135m").reduced(), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                             device=dev)

    def step(cache, tokens):
        return T.decode_step(cfg, params, cache, {"tokens": tokens})

    def mk(b, s):
        return T.init_cache(cfg, b, s, device=dev)

    N = 6
    prompt = serving.random_prompts(7, 4, 5, cfg.vocab_size, device=dev)
    lens = torch.full((4,), 5, dtype=torch.int32)
    kw = dict(tokens=N, slots=2, chunk=3, arrivals=[0.0, 0.5, 1.0, 1.5])
    spec = ("nan@serve.nan:rid=1,t=2;delay@serve.arrival:2~0.02;"
            "delay@serve.chunk:3~0.02")
    prev_env = os.environ.get(ENV_VAR)
    os.environ.pop(ENV_VAR, None)
    canonical.env_reload()
    try:
        clean = serving.serve_continuous(
            step, mk, prompt, lens, clock=canonical.TickClock(), **kw)
        os.environ[ENV_VAR] = spec
        plan = canonical.env_reload()
        out = serving.serve_continuous(
            step, mk, prompt, lens, clock=canonical.TickClock(), **kw)
    finally:
        if prev_env is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = prev_env
        canonical.env_reload()
    gen, cg = np.asarray(out[0]), np.asarray(clean[0])
    report = out.report
    if report.aborted != {1: 2}:
        raise AssertionError(f"expected request 1 aborted at generation "
                             f"index 2, got {report.aborted}")
    if sorted(report.completed) != [0, 2, 3]:
        raise AssertionError(f"expected requests 0/2/3 completed, got "
                             f"{sorted(report.completed)}")
    for r in (0, 2, 3):
        if not (gen[r] == cg[r]).all():
            raise AssertionError(
                f"surviving request {r} diverged from the fault-free run: "
                f"{gen[r].tolist()} vs {cg[r].tolist()}")
    if not (gen[1, :2] == cg[1, :2]).all() or not (gen[1, 2:] == 0).all():
        raise AssertionError(f"aborted request 1 not truncated at index 2: "
                             f"{gen[1].tolist()}")
    delays = [f for f in plan.fired if f[2] == "delay"]
    if len(delays) < 2:
        raise AssertionError(f"expected the delayed-arrival AND straggler-"
                             f"chunk rules to fire, saw {plan.fired}")
    return {
        "device": str(dev),
        "dispositions": report.dispositions,
        "aborted": report.aborted,
        "queue_peak": report.queue_peak,
        "delay_rules_fired": [f"{p}:{n}" for p, n, _ in delays],
        "survivors_bit_identical": True,
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m repro_torch.testing.faults")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="continuous-serving fault smoke: NaN + straggler "
                         "under REPRO_FAULTS, survivor exactness asserted")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.serve_smoke:
        print(json.dumps(serve_fault_smoke(args.device), indent=2))
        print("SERVE_FAULT_SMOKE_OK")
        return
    ap.print_help()


if __name__ == "__main__":
    main()
