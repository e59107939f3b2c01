"""Deterministic fault injection for the table build and the serving
engine.

The port's copy of the JAX package's ``repro.testing.faults``, with its
names, semantics and environment interface (``REPRO_FAULTS``).  Production code calls :func:`hit(point)`
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

**Process-level actions** target a worker subprocess of the distributed
table build by index: ``kill-worker:<idx>@<point>``,
``stall-worker:<idx>@<point>~seconds`` and
``corrupt-shard:<idx>@<point>``.  They never fire in the process that
holds the plan: the coordinator translates them into each worker's
``REPRO_FAULTS`` through :func:`worker_env_spec` (``kill-worker`` →
``exit``, a real crash with status 17; ``stall-worker`` → ``delay``;
``corrupt-shard`` → ``garble``), so "kill worker 0 at its 40th claimed
item" is one rule on the coordinator.

Injection points the port wires:

=====================  =====================================================
``probe.prepare``      before a latency probe is built and run once
``probe.time``         before each timing of a probe (``delay`` ⇒ a
                       straggler, ``raise`` ⇒ a flaky probe)
``tables.bucket``      after a latency bucket's result is journaled (a kill
                       here ⇒ the resume replays the journal)
``tables.importance``  after an importance probe or span batch is journaled
``journal.append``     ``mangle`` over a journal line's bytes (``torn`` or
                       ``garble`` ⇒ a torn or corrupt record)
``journal.append.done``after the journal line is fsync'd
``table_cache.publish``before built tables are published atomically
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
``dist.claim``         after a distributed worker claims a work-item lease
``dist.item``          after the claim, before the item runs (a kill here
                       dies holding the lease with no result: the
                       canonical mid-bucket worker death)
``dist.done``          after an item's done marker is written
``dist.shard.append``  ``mangle`` over a worker's shard line (``garble`` or
                       ``torn`` ⇒ a corrupt or torn shard record;
                       ``dist.shard.append.done`` after the fsync)
=====================  =====================================================

NaN injection cannot go through :func:`hit` (it runs inside a captured
step): :func:`nan_logits_hook` builds a ``logit_hook`` for the fixed-slot
scheduler, and the continuous engine reads request-targeted ``nan``
rules through :func:`serve_nan_spec`.  :class:`TickClock` is the virtual
clock that makes the engine's deadlines and shedding deterministic.

    PYTHONPATH=src python -m repro_torch.testing.faults --smoke \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.testing.faults --serve-smoke \\
        [--device cpu]
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

ACTIONS = ("raise", "kill", "exit", "delay", "torn", "nan", "garble",
           "kill-worker", "stall-worker", "corrupt-shard")

#: Actions that target a worker subprocess: they carry a worker index and
#: are translated into that worker's environment by
#: :func:`worker_env_spec` instead of firing where the plan is held.
PROCESS_ACTIONS = ("kill-worker", "stall-worker", "corrupt-shard")

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
    widx: int = -1          # process actions: target worker index

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
        """Count one hit of ``point`` and return the rule it arms.
        Worker-targeted rules (``widx >= 0``) never arm here: they are
        directives for :func:`worker_env_spec`, and the coordinator hits
        the same points itself on its inline fallback."""
        n = self._counts[point] = self._counts.get(point, 0) + 1
        for rule in self.rules:
            if rule.widx >= 0:
                continue
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
    index 2 (see :func:`serve_nan_spec`).  Process actions carry the
    target worker's index on the action token:
    ``kill-worker:0@dist.item:40`` kills worker 0 at its 40th claimed
    item.
    """
    rules = []
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        action, _, rest = item.partition("@")
        point, _, counts = rest.partition(":")
        widx = -1
        base, sep, wid = action.partition(":")
        if sep and base in PROCESS_ACTIONS:
            action, widx = base, int(wid)
        if not (action and point):
            raise ValueError(f"bad {ENV_VAR} item {item!r} "
                             "(want action@point[:nth[xtimes][~seconds]])")
        if "=" in counts:                    # key=value form (serve.nan)
            kv = dict(p.split("=", 1) for p in counts.split(","))
            rules.append(Fault(point=point, action=action, widx=widx,
                               rid=int(kv.get("rid", -1)),
                               at=int(kv.get("t", kv.get("at", -1)))))
            continue
        counts, _, seconds = (counts or "1").partition("~")
        nth, _, times = counts.partition("x")
        rules.append(Fault(point=point, action=action, widx=widx,
                           nth=int(nth or 1), times=int(times or 1),
                           seconds=float(seconds or 0.0)))
    return FaultPlan(*rules)


def worker_env_spec(widx: int, plan: FaultPlan | None = None) -> str | None:
    """The ``REPRO_FAULTS`` spec for worker ``widx``, or None.

    Translates the plan's process-level rules that target this worker
    into worker-local ones: ``kill-worker`` → ``exit`` (a real crash,
    status 17), ``stall-worker`` → ``delay`` (the worker lives on but its
    leases expire), ``corrupt-shard`` → ``garble`` at ``dist.shard.append``
    (the record lands complete but unparsable).  The coordinator calls it
    for every worker it starts; ``plan`` defaults to the active one.
    """
    plan = plan if plan is not None else active()
    if plan is None:
        return None
    parts = []
    for r in plan.rules:
        if r.widx != widx:
            continue
        counts = f"{r.nth}x{r.times}"
        if r.action == "kill-worker":
            parts.append(f"exit@{r.point}:{counts}")
        elif r.action == "stall-worker":
            parts.append(f"delay@{r.point}:{counts}~{r.seconds}")
        elif r.action == "corrupt-shard":
            parts.append(f"garble@{r.point or 'dist.shard.append'}:{counts}")
    return ";".join(parts) or None


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
# Kill-and-resume smoke: a real child process crashes mid-build (a hard
# ``os._exit``), and the build resumes here from its journal.
# ---------------------------------------------------------------------------

def _smoke_host(device="cuda", arch: str | None = None, batch: int = 4,
                max_span: int | None = None):
    """The smoke's host, parameters from seed 0: the JAX package's smoke
    network (``tiny_resnet(4, in_hw 8, width 4, blocks (2,))`` at batch
    4), or a network of the command line (``arch``, e.g. MobileNetV2)."""
    import torch

    from repro_torch.models import cnn, cnn_host, zoo

    if arch is not None:
        from repro_torch.compress import build_host
        return build_host(arch, seed=0, batch=batch, max_span=max_span,
                          device=device)[0]
    net = zoo.tiny_resnet(num_classes=4, in_hw=8, width=4, blocks=(2,))
    params = cnn.init_params(net, torch.Generator().manual_seed(0),
                             device=device)
    return cnn_host.CNNHost(net, params, batch=batch, device=device)


def _smoke_oracle(oracle: str):
    from repro_torch.core import AnalyticOracle, WallClockOracle
    return WallClockOracle() if oracle == "wallclock" else AnalyticOracle()


def _smoke_build(cache_dir: str | None, host, oracle):
    from repro_torch.core import build_tables
    return build_tables(host, latency_oracle=oracle, cache_dir=cache_dir)


def kill_resume_smoke(kill_at_bucket: int = 4, *, device="cuda",
                      oracle: str = "analytic", arch: str | None = None,
                      batch: int = 4, max_span: int | None = None,
                      work_dir: str | None = None) -> dict:
    """Crash a child's table build at its ``kill_at_bucket``-th journaled
    bucket (``exit@tables.bucket``: status 17, no cleanup), then resume it
    in this process and hold the resume to the journal.

    The child is ``python -m repro_torch.testing.faults --child DIR`` on
    ``device`` (the card by default) with ``oracle`` ('analytic' or
    'wallclock': the card) at the host of ``arch`` / ``batch`` /
    ``max_span`` (:func:`_smoke_host`).  Checks: no probe of either
    process was quarantined; exactly one journal is left; the resume
    replays at least
    ``kill_at_bucket - 1`` buckets; every journaled signature's seconds
    are bitwise those of the resumed tables and of the ``T_orig`` priced
    after them by the same oracle; the journal is gone after the publish;
    a third build is a cache hit equal to the resumed tables; and under
    the analytic oracle the resumed tables equal an uninterrupted build.
    ``work_dir`` (default: a temporary directory) holds the cache."""
    import glob
    import json
    import tempfile

    from repro_torch.core import Segment, enumerate_probes, layer_latencies
    from repro_torch.core.probe_engine import PROBE_QUARANTINED, _signature

    from .subproc import run_module, subprocess_env

    with tempfile.TemporaryDirectory(dir=work_dir) as d:
        args = ["--child", d, "--device", str(device), "--oracle", oracle,
                "--batch", str(batch)]
        if arch is not None:
            args += ["--arch", arch]
        if max_span is not None:
            args += ["--max-span", str(max_span)]
        t0 = time.perf_counter()
        r = run_module("repro_torch.testing.faults", *args, check=False,
                       env=subprocess_env(
                           device=str(device),
                           faults_spec=f"exit@tables.bucket:{kill_at_bucket}"))
        child_s = time.perf_counter() - t0
        if r.returncode != 17:
            raise AssertionError(
                f"child was expected to die at bucket {kill_at_bucket} "
                f"(exit 17), got {r.returncode}:\n{r.stdout}{r.stderr}")
        journals = glob.glob(os.path.join(d, "*.journal"))
        if len(journals) != 1:
            raise AssertionError(f"expected 1 journal after the crash, "
                                 f"found {journals}")
        with open(journals[0]) as f:
            records = {rec["k"]: rec["v"] for rec in map(json.loads, f)}

        host = _smoke_host(device, arch, batch, max_span)
        ora = _smoke_oracle(oracle)
        t0 = time.perf_counter()
        resumed = _smoke_build(d, host, ora)
        resume_s = time.perf_counter() - t0
        def journaled(seg):
            return records.get(f"latb:{_signature(host, seg)!r}")

        checked = 0
        for i, j, k, _, _, seg in enumerate_probes(host):
            want, row = journaled(seg), resumed.entries.get((i, j), {})
            if want is not None and k in row:
                if row[k][1] != want:
                    raise AssertionError(
                        f"entry ({i},{j}] k={k}: {row[k][1]!r} is not the "
                        f"journaled {want!r}")
                checked += 1
        layer_segs = [Segment(i=l - 1, j=l, k=host.original_k(l),
                              kept=(l,), original=True)
                      for l in range(1, len(host.descs()) + 1)]
        layers = layer_latencies(host, ora)          # T_orig's terms
        failed = [ijk for ijk, f in resumed.provenance.items()
                  if f == PROBE_QUARANTINED] + [
            sig for sig, f in getattr(ora, "flags", {}).items()
            if f == PROBE_QUARANTINED]
        if failed:
            raise AssertionError(f"probes failed and were quarantined to "
                                 f"the analytic estimate: {failed}")
        for seg, val in zip(layer_segs, layers):
            want = journaled(seg)
            if want is not None and val != want:
                raise AssertionError(
                    f"T_orig priced layer {seg.j} at {val!r}, not the "
                    f"journaled {want!r}")
        hits = resumed.stats.num_journal_hits
        if hits < kill_at_bucket - 1:
            raise AssertionError(f"resume replayed only {hits} journaled "
                                 f"buckets (expected >= {kill_at_bucket - 1})")
        if glob.glob(os.path.join(d, "*.journal")):
            raise AssertionError("journal not cleaned up after publish")
        again = _smoke_build(d, host, _smoke_oracle(oracle))
        if not again.stats.cache_hit or again.entries != resumed.entries:
            raise AssertionError("the third build is not a cache hit equal "
                                 "to the resumed tables")
        if oracle == "analytic":
            reference = _smoke_build(None, host, ora)
            if (resumed.entries != reference.entries
                    or resumed.num_pruned != reference.num_pruned):
                raise AssertionError("resumed tables diverged from the "
                                     "uninterrupted build")
        return {
            "device": str(device),
            "oracle": oracle,
            "killed_at_bucket": kill_at_bucket,
            "journal_records": len(records),
            "journal_hits_on_resume": hits,
            "entries_checked_against_journal": checked,
            "t_orig_layers_journaled": sum(
                journaled(seg) is not None for seg in layer_segs),
            "t_orig_s": sum(layers),
            "signatures_timed_on_resume": getattr(ora, "num_timed", 0),
            "entries": resumed.num_entries,
            "child_s": child_s,
            "resume_s": resume_s,
            "bit_identical": True,
        }


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
    ap.add_argument("--smoke", action="store_true",
                    help="kill-and-resume table-build smoke: a child "
                         "process dies mid-build, the build resumes")
    ap.add_argument("--serve-smoke", action="store_true",
                    help="continuous-serving fault smoke: NaN + straggler "
                         "under REPRO_FAULTS, survivor exactness asserted")
    ap.add_argument("--child", metavar="CACHE_DIR", default=None,
                    help=argparse.SUPPRESS)   # the build that is crashed
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' runs the plain "
                         "PyTorch versions")
    ap.add_argument("--oracle", default="analytic",
                    choices=("analytic", "wallclock"),
                    help="the smoke's latency oracle (wallclock: the card)")
    ap.add_argument("--arch", default=None,
                    help="the smoke's network (a CLI arch, e.g. "
                         "mobilenetv2); default: the JAX package's tiny "
                         "smoke network")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-span", type=int, default=None)
    args = ap.parse_args(argv)
    if args.child is not None:
        _smoke_build(args.child, _smoke_host(args.device, args.arch,
                                             args.batch, args.max_span),
                     _smoke_oracle(args.oracle))
        print("CHILD_COMPLETED")               # only reached if not killed
        return
    if args.smoke:
        print(json.dumps(kill_resume_smoke(
            device=args.device, oracle=args.oracle,
            arch=args.arch, batch=args.batch, max_span=args.max_span),
            indent=2))
        print("FAULT_SMOKE_OK")
        return
    if args.serve_smoke:
        print(json.dumps(serve_fault_smoke(args.device), indent=2))
        print("SERVE_FAULT_SMOKE_OK")
        return
    ap.print_help()


if __name__ == "__main__":
    main()
