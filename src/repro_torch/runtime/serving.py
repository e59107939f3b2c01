"""Serving: captured prefill and decode, fused ragged prompts, slot
batching and the continuous-batching engine.

The port of the JAX package's :mod:`repro.runtime.serving`.  ``step(
cache, tokens) → (logits, cache)`` is any one-token step — the original
stack's (:func:`repro_torch.models.transformer.decode_step`) or a
compressed artifact's (:meth:`~repro_torch.runtime.artifact.
CompressedArtifact.decode`) — that writes the cache's tensors in place
and reads nothing on the host; ``new_cache()`` and ``make_cache(batch,
seq_len)`` build zeroed caches.  Both stacks are served and measured the
same way.

Where the reference jit-compiles a ``lax.scan`` of the step, the port
captures ONE step of the fused prefill+decode body in a CUDA graph and
replays it once per prompt position and once per generated token.
Static buffers hold the feed, the lengths, the step counter ``t``, the
previous token, the last logits and the per-step samples and ``ok``
flags; the greedy argmax and its feedback stay on the device, and the
host reads nothing between steps.  Before the capture the body runs once
eagerly on a side stream (so every kernel instance is loaded and its
attributes are set at the capture's shapes) and the cache is reset in
place.  On the CPU the same body runs eagerly: that is the tests' path.
A capture that fails raises; nothing retries it eagerly.

* :func:`serve_loop` — single-batch prefill + greedy decode: ``P``
  teacher-forced replays, then ``tokens - 1`` decode replays.
  :func:`serve_loop_pertoken` keeps the eager loop (hundreds of launches
  a token) as the dispatch-bound yardstick.
* :func:`generate_fused` — one pass over a slot batch with per-slot
  prompt lengths: slot ``b`` is teacher-forced ``prompt[b, t]`` while
  ``t < lengths[b]`` and fed its own previous greedy token afterwards,
  so no pad token enters a cache.  A slot whose logits go non-finite
  feeds a pinned token 0 back and is aborted alone.
* :func:`serve_requests` — the fixed-slot scheduler: up to ``slots``
  prompts a round, one captured step serving every segment of every
  round (the step indices are runtime data), the deadline checked per
  ``deadline_chunk`` steps, one cache per call reset in place per round.
* :class:`ContinuousEngine`, :func:`serve_continuous` — per-slot state
  (:func:`stack_cache`: a position per slot), mid-stream admission and
  retirement, arrivals, deadlines, shedding, a bounded queue and a NaN
  circuit breaker; one captured chunk step (:class:`_ChunkGraph`)
  replayed ``chunk`` times a chunk serves every admission.
  :func:`serve_with_failover` re-forms the engine on a
  :class:`WorkerLost` and replays the requests in flight.  The engine
  hits the ``serve.*`` points of :mod:`repro_torch.testing.faults`.

The single-batch paths check a cache's length on the host before the
first step: a prompt plus tokens longer than a KV cache raises
(:func:`check_room`).  The engine's idle and finished slots run past
their cache by design; a plain cache clamps their writes to its last
entry, as the reference does
(:func:`repro_torch.models.layers.attention_decode`).  Sharding
(``rules=``) is not ported (ROADMAP.md queue 5).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import launch_counts
from repro_torch.testing import faults as _faults


def greedy_token(logits):
    """Greedy sampling: ``(B, S, V)`` logits → ``(B,)`` next-token ids."""
    return torch.argmax(logits[:, -1], dim=-1)


def random_prompts(seed: int, batch: int, prompt_len: int, vocab_size: int,
                   device="cuda"):
    """``(B, P)`` random token ids drawn on the CPU from
    ``torch.Generator(seed)``, then moved to ``device`` (the card by
    default; raises without one)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab_size, (batch, prompt_len),
                         generator=gen).to(resolve(device))


def ragged_prompts(seed: int, n: int, min_len: int, max_len: int,
                   vocab_size: int):
    """``n`` random prompts of random lengths in ``[min_len, max_len]``,
    drawn from ``np.random.RandomState(seed)`` in the reference's order
    (so the ids are the reference's own): a list of 1-D int32 tensors on
    the host; feed them through :func:`pad_prompts`."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"need 1 <= min_len <= max_len, got "
                         f"[{min_len}, {max_len}]")
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randint(
        0, vocab_size, size=rng.randint(min_len, max_len + 1)
    ).astype(np.int32)) for _ in range(n)]


def decode_tok_s(tokens: int, batch: int, seconds: float) -> float:
    """Decode throughput; guards the div by tiny timings."""
    return tokens * batch / max(seconds, 1e-9)


# ---------------------------------------------------------------------------
# Decode state and its room
# ---------------------------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def check_room(cache, positions: int) -> None:
    """Raise unless every KV cache of ``cache`` (a list of per-layer
    states) takes ``positions`` tokens.  A ring buffer of a whole local
    window (``"ring"``) takes any number; the RG-LRU state has no length.
    """
    for st in cache:
        if "k" in st and not st.get("ring", False) \
                and st["k"].shape[1] < positions:
            raise ValueError(f"a prompt plus tokens of {positions} "
                             f"positions exceeds a KV cache of "
                             f"{st['k'].shape[1]}")


class _Timer:
    """Seconds of the work between ``start`` and ``stop``: CUDA events on
    the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._ev.elapsed_time(end) / 1e3
        return time.perf_counter() - self._t0


# ---------------------------------------------------------------------------
# The fused prefill+decode step, captured once and replayed per step
# ---------------------------------------------------------------------------

def _capture(device, body, reset):
    """Capture one call of ``body`` in a CUDA graph: run it once eagerly
    on a side stream at the capture's shapes (so every kernel instance is
    loaded and its attributes are set), ``reset()`` the state it wrote,
    and capture it.  Returns ``(graph, launches)``, ``launches`` the
    kernel launches the capture counted (one call's).  A capture that
    fails raises; nothing retries it eagerly."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)
    reset()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    after = launch_counts()
    return graph, {k: n - before[k] for k, n in after.items()
                   if n != before[k]}


class _StepGraph:
    """One step of the fused prefill+decode body over ``batch`` slots and
    up to ``steps`` steps: the port of the reference's scan bodies and of
    its ``_make_segment_fn``.

    At step ``t`` (a device counter) slot ``b`` consumes ``feed[b, t]``
    while ``t < lengths[b]`` and its previous greedy token afterwards;
    ``logit_hook(logits, t)`` (``t`` a 0-d device tensor) runs before the
    argmax; a slot whose logits are not all finite feeds token 0 back.
    The sample and ``ok`` flag of step ``t`` land in column ``t`` of
    ``samples`` and ``ok``, the last logits in ``logits``.

    :meth:`prepare` captures the step in a CUDA graph on the card (and
    records ``capture_s``, the seconds of warm-up and capture, and
    ``launches``, the kernel launches the capture counted: one step's);
    :meth:`reset` loads a round and zeroes the cache in place;
    :meth:`advance` runs ``n`` steps, each one replay on the card and
    one eager call of the body on the CPU.
    """

    def __init__(self, step, cache, batch: int, steps: int, logit_hook=None):
        self.step, self.cache, self.hook = step, cache, logit_hook
        self.steps = steps
        self.device = next(_tensors(cache)).device
        dev = self.device
        self.feed = torch.zeros((batch, steps), dtype=torch.long, device=dev)
        self.lengths = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.t = torch.zeros((), dtype=torch.long, device=dev)
        self.prev = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.samples = torch.zeros((batch, steps), dtype=torch.long,
                                   device=dev)
        self.ok = torch.ones((batch, steps), dtype=torch.bool, device=dev)
        self.logits = None
        self.graph = None
        self.done = 0
        self.capture_s = 0.0
        self.launches: dict[str, int] = {}

    def _body(self):
        idx = self.t.reshape(1)
        tok = self.feed.index_select(1, idx)[:, 0]
        inp = torch.where(self.t < self.lengths, tok, self.prev)
        logits, _ = self.step(self.cache, inp[:, None])
        if self.hook is not None:
            logits = self.hook(logits, self.t)
        ok = torch.isfinite(logits).flatten(1).all(dim=1)
        nxt = torch.where(ok, greedy_token(logits), 0)
        self.samples.index_copy_(1, idx, nxt[:, None])
        self.ok.index_copy_(1, idx, ok[:, None])
        self.prev.copy_(nxt)
        if self.logits is None:
            self.logits = torch.empty_like(logits[:, -1])
        self.logits.copy_(logits[:, -1])
        self.t.add_(1)

    def reset(self, feed, lengths) -> None:
        """Zero the cache and the step's buffers in place, then load
        ``feed`` (B, ≤ steps) and ``lengths`` (B,)."""
        for t in _tensors(self.cache):
            t.zero_()
        self.feed.zero_()
        self.feed[:, :feed.shape[1]].copy_(feed)
        self.lengths.copy_(lengths)
        self.t.zero_()
        self.prev.zero_()
        self.samples.zero_()
        self.ok.fill_(True)
        self.done = 0

    def prepare(self, feed, lengths) -> None:
        """On the card: run the body once eagerly on a side stream at the
        capture's shapes, reset, and capture one step (:func:`_capture`).
        On the CPU there is nothing to prepare."""
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        self.reset(feed, lengths)
        self.graph, self.launches = _capture(
            self.device, self._body, lambda: self.reset(feed, lengths))
        self.capture_s = time.perf_counter() - t0

    def advance(self, n: int) -> None:
        """Run ``n`` more steps (no host read between them)."""
        if self.done + n > self.steps:
            raise ValueError(f"{self.done} + {n} steps exceed the "
                             f"{self.steps} this step was built for")
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._body()
        self.done += n

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _check_lengths(lengths, P: int) -> None:
    if len(lengths) and (int(lengths.min()) < 1 or int(lengths.max()) > P):
        raise ValueError(f"prompt lengths must lie in [1, {P}], got "
                         f"[{int(lengths.min())}, {int(lengths.max())}]")


# ---------------------------------------------------------------------------
# Single-batch serve loops
# ---------------------------------------------------------------------------

def serve_loop(step, new_cache, prompt, tokens: int, *, warm: bool = True):
    """Prefill ``prompt`` (B, P) and decode ``tokens`` greedy tokens.

    ``new_cache()`` returns a zeroed cache; one is built per call.  On
    the card the step is captured once (:class:`_StepGraph`); prefill is
    ``P`` teacher-forced replays and decode ``tokens - 1`` replays, each
    phase timed with CUDA events.  With ``warm`` the whole loop runs
    once unmeasured first, so the times are steady-state serving.
    Returns ``(prefill_s, decode_s, last_logits (B, V), seqs (B,
    tokens))`` where ``seqs[:, 0]`` is the prefill's greedy token.
    """
    B, P = prompt.shape
    if P < 1 or tokens < 1:
        raise ValueError(f"serve_loop needs a prompt and a token, got P={P},"
                         f" tokens={tokens}")
    cache = new_cache()
    check_room(cache, P + tokens)
    run = _StepGraph(step, cache, B, P + tokens - 1)
    lengths = torch.full((B,), P, dtype=torch.long)
    run.prepare(prompt, lengths)
    timer = _Timer(run.device)
    for _ in range(2 if warm else 1):
        run.reset(prompt, lengths)
        timer.start()
        run.advance(P)
        prefill_s = timer.stop()
        logits = run.logits.clone()
        timer.start()
        run.advance(tokens - 1)
        decode_s = timer.stop()
    return prefill_s, decode_s, logits, run.samples[:, P - 1:].clone()


def _prefill(step, cache, prompt):
    """Feed the prompt one position at a time; last-position logits
    ``(B, V)`` and the filled cache."""
    logits = None
    for t in range(prompt.shape[1]):
        logits, cache = step(cache, prompt[:, t:t + 1])
    return logits[:, -1], cache


def _decode(step, cache, tok, n: int):
    """``n`` greedy tokens from ``tok`` ``(B,)`` on → ``(B, n)``."""
    out = []
    for _ in range(n):
        logits, cache = step(cache, tok[:, None])
        tok = greedy_token(logits)
        out.append(tok)
    if not out:
        return tok.new_zeros((tok.shape[0], 0))
    return torch.stack(out, dim=1)


def serve_loop_pertoken(step, new_cache, prompt, tokens: int):
    """:func:`serve_loop` as an eager Python loop: a host round trip and
    every kernel launch of the step per prompt position and per token.
    Kept, as the reference keeps it, as the dispatch-bound yardstick the
    captured loop is measured against.  The whole loop runs once
    unmeasured first; the return is :func:`serve_loop`'s."""
    cache = new_cache()
    check_room(cache, prompt.shape[1] + tokens)
    logits, cache = _prefill(step, cache, prompt)
    _decode(step, cache, greedy_token(logits[:, None]), tokens - 1)
    timer = _Timer(prompt.device)
    timer.start()
    logits, cache = _prefill(step, new_cache(), prompt)
    prefill_s = timer.stop()
    tok = greedy_token(logits[:, None])
    timer.start()
    out = _decode(step, cache, tok, tokens - 1)
    decode_s = timer.stop()
    return prefill_s, decode_s, logits, torch.cat([tok[:, None], out], dim=1)


# ---------------------------------------------------------------------------
# Fused ragged-prompt generation
# ---------------------------------------------------------------------------

def generate_fused(step, cache, prompts, lengths, tokens: int, *,
                   logit_hook=None, with_report: bool = False):
    """One pass over a padded slot batch with per-slot prompt lengths.

    ``prompts``: ``(B, P)`` right-padded ids; ``lengths``: ``(B,)`` with
    ``1 <= lengths[b] <= P``.  At step ``t`` slot ``b`` consumes
    ``prompts[b, t]`` while ``t < lengths[b]`` (teacher-forced prefill)
    and its own previous greedy token afterwards (decode), so every
    slot's cache holds exactly its own sequence.  ``cache`` (zeroed, on
    the serving device) must take ``P + tokens`` positions; it is used,
    and on the card reset, in place.  Returns ``(gen (B, tokens),
    cache)`` on the cache's device.

    Non-finite guard: a slot whose logits go non-finite feeds a pinned
    token 0 back, so the other slots are untouched.  With
    ``with_report`` the return gains ``fail_idx (B,)``: the generation
    index at which each slot first saw non-finite logits (``tokens`` =
    never), the slot's tokens zeroed from there on; a failure during the
    slot's prefill clips to 0.  ``logit_hook(logits, t) → logits`` runs
    inside the captured step just before the argmax, ``t`` a 0-d device
    tensor.
    """
    prompts = torch.as_tensor(prompts)
    lengths = torch.as_tensor(lengths).long()
    B, P = prompts.shape
    _check_lengths(lengths, P)
    steps = P + tokens - 1
    check_room(cache, P + tokens)
    run = _StepGraph(step, cache, B, steps, logit_hook)
    run.prepare(prompts, lengths)
    run.reset(prompts, lengths)
    run.advance(steps)
    ln = run.lengths
    ar = torch.arange(tokens, device=run.device)
    gen = run.samples.gather(1, (ln - 1)[:, None] + ar[None, :])
    if not with_report:
        return gen, cache
    bad = ~run.ok
    first_bad = torch.where(bad.any(dim=1), bad.int().argmax(dim=1), steps)
    fail_idx = torch.clamp(first_bad - (ln - 1), 0, tokens)
    keep = ar[None, :] < fail_idx[:, None]
    return torch.where(keep, gen, 0), cache, fail_idx


# ---------------------------------------------------------------------------
# Request encoding and reporting
# ---------------------------------------------------------------------------

def pad_prompts(prompts, pad_to: int | None = None):
    """Encode a list of 1-D id arrays as ``(R, P)`` padded int32 ids and
    ``(R,)`` lengths.  ``pad_to`` pins ``P``; it must cover the longest
    prompt."""
    rows = [torch.as_tensor(p).to(torch.int32) for p in prompts]
    lengths = torch.tensor([len(p) for p in rows], dtype=torch.int32)
    longest = int(lengths.max())
    P = longest if pad_to is None else pad_to
    if P < longest:
        raise ValueError(f"pad_to={pad_to} shorter than the longest "
                         f"prompt ({longest} tokens)")
    mat = torch.stack([torch.nn.functional.pad(p, (0, P - len(p)))
                       for p in rows])
    return mat, lengths.to(mat.device)


def _normalize_requests(prompts, lengths):
    """``(prompts (R, P), lengths (R,))`` as int64 tensors from either a
    padded matrix + lengths or a list of 1-D prompts (zero requests
    OK)."""
    if lengths is None:
        if getattr(prompts, "ndim", None) == 2:
            # a padded matrix has no recoverable lengths: deriving them
            # would teacher-force pad tokens into the caches
            raise ValueError("pass lengths= with a padded (R, P) matrix "
                             "(or pass the list of 1-D prompts)")
        if len(prompts) == 0:
            return (torch.zeros((0, 1), dtype=torch.long),
                    torch.zeros((0,), dtype=torch.long))
        prompts, lengths = pad_prompts(prompts)
    return torch.as_tensor(prompts).long(), torch.as_tensor(lengths).long()


#: Every per-request outcome a :class:`ServeReport` can assign.
DISPOSITIONS = ("completed", "aborted", "shed", "deadline_miss", "unserved")


@dataclasses.dataclass
class ServeReport:
    """Per-request outcome accounting for one serve call (the reference's
    record, field for field).

    ``aborted`` maps a request index to the generation index at which its
    logits first went non-finite (its tokens are zeroed from there on);
    ``unserved`` lists requests never admitted because the wall-clock
    budget expired (their rows are all zeros); ``deadline_miss`` maps a
    request cut short by the deadline to the tokens it kept; everything
    else ``completed``.  ``tokens_per_request`` is the generation length
    after the token budget.  ``shed``, ``latency_s``, ``queue_peak``,
    ``admitted``, ``quarantined_slots``, ``sustained_tok_s`` and the
    failover fields (``failovers``, ``lost_workers``, ``replayed``) are
    filled by the continuous engine and :func:`serve_with_failover`, and
    stay empty for the fixed scheduler; ``engine`` is ``"fixed"``,
    ``"continuous"`` or ``"continuous+failover"``.
    """

    completed: list[int] = dataclasses.field(default_factory=list)
    aborted: dict[int, int] = dataclasses.field(default_factory=dict)
    unserved: list[int] = dataclasses.field(default_factory=list)
    rounds: int = 0
    tokens_per_request: int = 0
    deadline_hit: bool = False
    shed: list[int] = dataclasses.field(default_factory=list)
    deadline_miss: dict[int, int] = dataclasses.field(default_factory=dict)
    latency_s: dict[int, float] = dataclasses.field(default_factory=dict)
    queue_peak: int = 0
    admitted: int = 0
    quarantined_slots: list[int] = dataclasses.field(default_factory=list)
    sustained_tok_s: float = 0.0
    engine: str = "fixed"
    failovers: int = 0
    lost_workers: list = dataclasses.field(default_factory=list)
    replayed: list[int] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.aborted or self.unserved or self.shed
                    or self.deadline_miss or self.quarantined_slots)

    @property
    def dispositions(self) -> dict[int, str]:
        """request index → one of :data:`DISPOSITIONS`."""
        d: dict[int, str] = {r: "completed" for r in self.completed}
        d.update({r: "aborted" for r in self.aborted})
        d.update({r: "shed" for r in self.shed})
        d.update({r: "deadline_miss" for r in self.deadline_miss})
        d.update({r: "unserved" for r in self.unserved})
        return d


class ServeOutput(tuple):
    """``(gen, seconds)`` (unpacks as a pair) carrying the
    :class:`ServeReport` on ``.report``."""

    report: ServeReport

    def __new__(cls, gen, seconds, report):
        out = super().__new__(cls, (gen, seconds))
        out.report = report
        return out


class WorkerLost(RuntimeError):
    """A serving worker (process or device) died mid-decode; carries the
    lost worker ids on ``.lost``.  :class:`ContinuousEngine` raises it
    before a chunk (``health_check`` or the ``serve.worker`` fault point);
    :func:`serve_with_failover` catches it."""

    def __init__(self, msg: str, lost=()):
        super().__init__(msg)
        self.lost = list(lost)


# ---------------------------------------------------------------------------
# Fixed-slot batched request scheduler (round barrier, per-chunk deadline)
# ---------------------------------------------------------------------------

def serve_requests(step, make_cache, prompts, lengths=None, *, tokens: int,
                   slots: int | None = None, warm: bool = True,
                   token_budget: int | None = None,
                   time_budget_s: float | None = None, logit_hook=None,
                   deadline_chunk: int = 8, clock=None):
    """Serve many prompts through fixed-size slot batching.

    ``prompts``: ``(R, P)`` padded ids with ``lengths``, or a list of 1-D
    id arrays.  Up to ``slots`` prompts are admitted a round into a
    padded batch and served by the fused prefill+decode step (a short
    final round re-admits request 0 as filler and drops its results);
    then the round retires and the next is admitted.  ``make_cache(
    batch_size, seq_len)`` is called once: the one cache is reset in
    place each round, and the step is captured once for the call (before
    the clock starts).  Returns a :class:`ServeOutput`: ``(gen (R, T) on
    the host, seconds)`` with the :class:`ServeReport` on ``.report``;
    ``seconds`` is steady-state with ``warm`` (one unmeasured segment of
    round 0 first).

    ``token_budget`` caps the tokens per request (``T = min(tokens,
    token_budget)``).  ``time_budget_s`` bounds the measured wall clock,
    checked after every ``deadline_chunk`` steps (the round runs as equal
    segments, padded with discarded tail steps): on a hit the round stops
    at its segment — slots cut short are ``deadline_miss`` with the
    tokens they generated, finished ones complete — and requests never
    admitted come back zeroed and ``unserved``.  A slot whose logits go
    non-finite is ``aborted`` at that token (see :func:`generate_fused`)
    and the other slots of its round are untouched.  ``logit_hook`` runs
    inside the step; ``clock`` (default ``time.perf_counter``) injects a
    virtual clock for deterministic deadline tests.
    """
    prompts, lengths = _normalize_requests(prompts, lengths)
    R, P = prompts.shape
    eff_tokens = tokens if token_budget is None \
        else max(1, min(tokens, token_budget))
    report = ServeReport(tokens_per_request=eff_tokens)
    if R == 0:
        return ServeOutput(torch.zeros((0, eff_tokens), dtype=torch.long),
                           0.0, report)
    ln_host = lengths.cpu()
    _check_lengths(ln_host, P)
    slots = min(slots or R, R)
    clk = clock if clock is not None else time.perf_counter

    # One round = `steps` steps; with a wall-clock budget the round is cut
    # into equal `seg`-step segments (padded with discarded tail steps) so
    # that the host checks the deadline between segments.
    steps = P + eff_tokens - 1
    seg = steps if time_budget_s is None \
        else max(1, min(deadline_chunk, steps))
    nseg = -(-steps // seg)
    pad_steps = nseg * seg
    cache = make_cache(slots, P + eff_tokens + (pad_steps - steps))
    run = _StepGraph(step, cache, slots, pad_steps, logit_hook)

    def round_idx(start):
        # short final round: re-admit request 0 as filler, results dropped
        return [start + i if start + i < R else 0 for i in range(slots)]

    def round_batch(start):
        idx = torch.tensor(round_idx(start))
        return prompts[idx.to(prompts.device)], lengths[idx.to(
            lengths.device)]

    run.prepare(*round_batch(0))
    if warm:
        run.reset(*round_batch(0))
        run.advance(seg)
        run.synchronize()

    rounds_data = []                    # (start, n, done, samples, oks)
    deadline_hit = False
    t0 = clk()
    for start in range(0, R, slots):
        if deadline_hit or (time_budget_s is not None
                            and clk() - t0 > time_budget_s):
            report.deadline_hit = True
            report.unserved.extend(range(start, R))
            break
        run.reset(*round_batch(start))
        executed = 0
        for _ in range(nseg):
            run.advance(seg)
            executed += seg
            if time_budget_s is not None:
                run.synchronize()
                if clk() - t0 > time_budget_s and executed < pad_steps:
                    deadline_hit = True
                    break
        rounds_data.append((start, min(slots, R - start),
                            min(executed, steps), run.samples.clone(),
                            run.ok.clone()))
        report.rounds += 1
    run.synchronize()
    seconds = clk() - t0
    if deadline_hit:
        report.deadline_hit = True
        # never-admitted requests after a mid-round deadline hit
        tail = rounds_data[-1][0] + slots if rounds_data else 0
        report.unserved.extend(r for r in range(tail, R)
                               if r not in report.unserved)

    gen = np.zeros((R, eff_tokens), np.int64)
    for start, n, done, samples, oks in rounds_data:
        sm = samples[:, :done].cpu().numpy()               # (slots, done)
        bad_all = ~oks[:, :done].cpu().numpy()
        for b in range(n):
            rid = start + b
            L = int(ln_host[rid])
            served = int(np.clip(done - (L - 1), 0, eff_tokens))
            bad = bad_all[b]
            first_bad = int(np.argmax(bad)) if bad.any() else done
            fail = int(np.clip(first_bad - (L - 1), 0, eff_tokens))
            keep = min(fail, served)
            if keep > 0:
                gen[rid, :keep] = sm[b, (L - 1) + np.arange(keep)]
            if fail < min(served, eff_tokens):
                report.aborted[rid] = fail
            elif served < eff_tokens:
                report.deadline_miss[rid] = served
            else:
                report.completed.append(rid)
    return ServeOutput(torch.from_numpy(gen), seconds, report)


# ---------------------------------------------------------------------------
# Continuous-batching engine: per-slot state, mid-stream admission
# ---------------------------------------------------------------------------

def stack_cache(cache, slots: int):
    """Widen one fresh single-request cache into the engine's per-slot
    state: every tensor of the batch-1 cache ``cache`` (the port's list of
    per-layer dicts) is repeated along its batch axis to ``slots`` rows,
    and a 0-d ``pos`` becomes ``(slots,)`` — each slot carries its OWN
    sequence position, which is what makes mid-stream admission exact.
    Other values (the ``"ring"`` flag) are kept.

    The reference gives every leaf an extra leading ``(slots,)`` axis and
    ``vmap``s the batch-1 step over it; a step that launches ctypes-bound
    CUDA kernels cannot be ``vmap``ped, so here the batch IS the slot
    axis and the step runs once at batch ``slots``.  Row ``b`` of this
    state equals leaf ``[b, 0]`` of the reference's (``[b]`` for ``pos``).
    """
    def widen(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim == 0:
            return x.reshape(1).repeat(slots)
        return x.repeat(slots, *([1] * (x.ndim - 1)))
    return [{k: widen(v) for k, v in st.items()} for st in cache]


class _ChunkGraph:
    """One step of the engine's multi-slot chunk body over the live
    per-slot state: the port of the reference's ``_make_chunk_fn``, whose
    ``lax.scan`` over ``chunk`` steps becomes ``chunk`` replays of one
    captured step (the body runs eagerly on the CPU).

    Static buffers: ``ctl`` ``(C + 4, B)`` holds, row by row, ``feed``
    (``C`` rows: the prompt tokens of slots still prefilling), ``fp``
    (the leading steps each slot teacher-forces this chunk; ``C`` for
    idle slots, which decode a dummy sequence that admission resets),
    ``poison`` (the local step at which a slot's logits are forced NaN,
    -1 = never: the ``serve.nan`` fault), ``t0`` (the engine-global index
    of the chunk's step 0, handed to ``logit_hook`` as ``t0 + i``) and
    the chunk-local step counter ``i`` (both read from column 0).  The
    host loads a chunk with one copy into ``ctl``, which also rewinds
    ``i``.  ``prev (B,)`` is each slot's last greedy token; ``out`` ``(2,
    C, B)`` the tokens and ``ok`` flags of the chunk's steps, read back
    with one copy after the last replay.

    The capture (:meth:`prepare`) runs against the live state and zeroes
    all of it afterwards: it must happen before the first chunk, while
    every slot is still fresh.  Chunks go through :meth:`run`, which
    rewinds ``i``: a replay past ``C`` steps would index past ``feed``.
    """

    def __init__(self, step, state, slots: int, chunk: int,
                 logit_hook=None):
        self.step, self.state, self.hook = step, state, logit_hook
        self.chunk = chunk
        self.device = next(_tensors(state)).device
        C, B, dev = chunk, slots, self.device
        self.ctl = torch.zeros((C + 4, B), dtype=torch.long, device=dev)
        self.feed, self.fp, self.poison = (self.ctl[:C], self.ctl[C],
                                           self.ctl[C + 1])
        self.t0, self.i = self.ctl[C + 2, 0], self.ctl[C + 3, 0]
        self.prev = torch.zeros((B,), dtype=torch.long, device=dev)
        self.out = torch.zeros((2, C, B), dtype=torch.long, device=dev)
        self.graph = None
        self.launches: dict[str, int] = {}

    def _body(self):
        i = self.i
        idx = i.reshape(1)
        tok = self.feed.index_select(0, idx)[0]
        inp = torch.where(i < self.fp, tok, self.prev)
        logits, _ = self.step(self.state, inp[:, None])    # (B, 1, V)
        if self.hook is not None:
            logits = self.hook(logits, self.t0 + i)
        logits = torch.where((i == self.poison)[:, None, None], torch.nan,
                             logits)
        ok = torch.isfinite(logits).flatten(1).all(dim=1)
        nxt = torch.where(ok, greedy_token(logits), 0)
        self.out[0].index_copy_(0, idx, nxt[None])
        self.out[1].index_copy_(0, idx, ok.long()[None])
        self.prev.copy_(nxt)
        self.ctl[self.chunk + 3].add_(1)

    def _zero(self):
        for t in _tensors(self.state):
            t.zero_()
        self.prev.zero_()
        self.out.zero_()
        self.ctl.zero_()

    def prepare(self) -> None:
        """Capture the step on the card (once); nothing on the CPU."""
        if self.device.type == "cuda" and self.graph is None:
            self.graph, self.launches = _capture(self.device, self._body,
                                                 self._zero)

    def reset_slot(self, b: int) -> None:
        """Zero slot ``b``'s rows of every state tensor (``pos[b] = 0``)
        in place: the fresh cache of an admitted request."""
        for t in _tensors(self.state):
            t[b].zero_()

    def run(self, ctl):
        """Load ``ctl`` (host ``(C + 4, B)`` int64), run the chunk's
        ``C`` steps, and return its tokens and ``ok`` flags, each ``(C,
        B)`` on the host."""
        self.ctl.copy_(torch.from_numpy(ctl))
        for _ in range(self.chunk):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._body()
        out = self.out.cpu().numpy()
        return out[0], out[1].astype(bool)


@dataclasses.dataclass
class _Request:
    """Host-side lifecycle record of one submitted request."""

    rid: int
    prompt: np.ndarray                 # 1-D int32 token ids
    budget: int                        # tokens to generate
    arrival: float
    deadline: float | None = None      # absolute (arrival + deadline_s)
    admitted_at: float | None = None
    finished_at: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    disposition: str | None = None


@dataclasses.dataclass
class _Slot:
    """Host-side view of one device slot."""

    rid: int = -1                      # -1 = idle
    consumed: int = 0                  # steps run for this request
    aborts: int = 0                    # NaN aborts since construction
    quarantined: bool = False


class ContinuousEngine:
    """Persistent continuous-batching decode loop over ``slots`` slots.

    ``step(cache, tokens) → (logits, cache)`` is the one-token protocol
    every other entry point uses; ``make_cache(batch_size, seq_len)``
    builds the matching fresh cache (the engine builds ONE
    ``make_cache(1, max_seq)`` cache and widens it per slot with
    :func:`stack_cache`).

    Lifecycle: :meth:`submit` requests (with arrival times and optional
    per-request deadlines), then :meth:`run` — the host loop ingests due
    arrivals into a bounded queue (overflow → ``shed``), admits queued
    requests into idle slots (deadline-aware shedding: a request whose
    prompt and budget cannot finish by its deadline at the observed
    decode rate is shed up front), dispatches one ``chunk``-step
    multi-slot chunk (``chunk`` replays of the captured step), and
    retires slots individually on EOS / budget / deadline / NaN-abort.
    A slot that NaN-aborts ``slot_nan_limit`` times is quarantined
    (circuit breaker).  :meth:`drain` finishes in-flight requests without
    admitting more.  ``health_check()`` (when given) returns the ids of
    lost workers before each chunk; a loss, or the ``serve.worker`` fault
    point, raises :class:`WorkerLost`.

    ``clock`` (default ``time.perf_counter``) injects a virtual clock —
    :class:`repro_torch.testing.faults.TickClock` makes shedding and
    deadlines deterministic (the loop reads the clock once per chunk).
    With a virtual clock the engine never sleeps while waiting for
    arrivals; virtual time advances one tick per idle iteration.

    The state lives on the cache's device and is written in place: the
    chunk step is captured once (with ``warm``, in the constructor, else
    at the first chunk), an admitted slot's rows are zeroed in place,
    and each chunk is one host-to-device copy of the feed, ``chunk``
    replays and one device-to-host read of the tokens.  The rate
    estimate reads the clock after that read.
    """

    def __init__(self, step, make_cache, *, slots: int, max_seq: int,
                 chunk: int = 8, eos_id=None, logit_hook=None, clock=None,
                 max_queue: int | None = None, slot_nan_limit: int = 2,
                 warm: bool = True, health_check=None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if chunk < 1:
            raise ValueError(f"need chunk >= 1, got {chunk}")
        self.slots = slots
        self.chunk = chunk
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._clock = clock if clock is not None else time.perf_counter
        self._virtual = clock is not None
        self._max_queue = max_queue
        self._nan_limit = slot_nan_limit
        self._health_check = health_check
        self._graph = _ChunkGraph(step,
                                  stack_cache(make_cache(1, max_seq), slots),
                                  slots, chunk, logit_hook)
        self._slots = [_Slot() for _ in range(slots)]
        self.requests: dict[int, _Request] = {}
        self._pending: list[_Request] = []     # not yet arrived
        self._queue: list[_Request] = []       # arrived, awaiting a slot
        self._rate: float | None = None        # EWMA decode steps/s
        self._next_rid = 0
        self._now: float | None = None
        self._epoch: float | None = None
        self._t_global = 0
        self._total_tokens = 0
        self.report = ServeReport(engine="continuous")
        if warm:
            self._graph.prepare()

    @property
    def state(self):
        """The per-slot decode state (:func:`stack_cache` layout)."""
        return self._graph.state

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, *, tokens: int, arrival: float = 0.0,
               deadline_s: float | None = None, rid: int | None = None):
        """Queue one request; returns its request id.

        ``arrival`` is the (clock-relative) time the request becomes
        visible to the engine; ``deadline_s`` is relative to arrival.
        """
        prompt = np.asarray(torch.as_tensor(prompt).cpu(),
                            np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if tokens < 1:
            raise ValueError(f"need tokens >= 1, got {tokens}")
        if len(prompt) + tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + tokens ({tokens}) exceeds the "
                f"engine window max_seq={self.max_seq}")
        if rid is None:
            rid = self._next_rid
        if rid in self.requests:
            raise ValueError(f"duplicate request id {rid}")
        self._next_rid = max(self._next_rid, rid + 1)
        req = _Request(rid=rid, prompt=prompt, budget=int(tokens),
                       arrival=float(arrival),
                       deadline=None if deadline_s is None
                       else float(arrival) + float(deadline_s))
        if self._epoch is not None:      # mid-run submit: anchor now
            req.arrival += self._epoch
            if req.deadline is not None:
                req.deadline += self._epoch
        self.requests[rid] = req
        self._pending.append(req)
        return rid

    def _anchor(self):
        """Pin clock-relative arrivals and deadlines to the clock's frame:
        the first ``run``/``drain`` shifts every pending timestamp by the
        first clock read (latencies stay epoch-relative)."""
        if self._now is not None:
            return
        self._now = self._epoch = self._clock()
        if self._epoch:
            for req in self._pending:
                req.arrival += self._epoch
                if req.deadline is not None:
                    req.deadline += self._epoch

    # -- main loop ----------------------------------------------------------

    def run(self, *, time_budget_s: float | None = None) -> ServeReport:
        """Serve every submitted request (or until the budget expires)."""
        self._pending.sort(key=lambda r: (r.arrival, r.rid))
        self._anchor()
        start = self._now
        while True:
            now = self._now
            if time_budget_s is not None and now - start >= time_budget_s:
                self._drain_live()
                self._flush_waiting(deadline_hit=True)
                break
            self._ingest(now)
            self._admit(now)
            if not any(s.rid >= 0 for s in self._slots):
                if not self._queue and not self._pending:
                    break
                if all(s.quarantined for s in self._slots):
                    self._flush_waiting()
                    break
                if not self._virtual and self._pending:
                    wait = self._pending[0].arrival - now
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                self._now = self._clock()
                continue
            self._run_chunk()
        elapsed = max(self._now - start, 1e-9)
        self.report.sustained_tok_s = self._total_tokens / elapsed
        return self.report

    def drain(self) -> ServeReport:
        """Finish in-flight requests, admit nothing new; waiting requests
        are reported ``unserved`` (graceful shutdown)."""
        self._anchor()
        self._drain_live()
        self._flush_waiting()
        return self.report

    # -- internal: admission ------------------------------------------------

    def _ingest(self, now):
        while self._pending and self._pending[0].arrival <= now:
            req = self._pending.pop(0)
            _faults.hit("serve.arrival")
            if self._max_queue is not None \
                    and len(self._queue) >= self._max_queue:
                self._finish(req, "shed", now)
                continue
            self._queue.append(req)
            self.report.queue_peak = max(self.report.queue_peak,
                                         len(self._queue))

    def _shed(self, req, now) -> bool:
        """Deadline-aware load shedding: reject up front what cannot be
        served in time at the sustained decode rate (optimistic when no
        rate estimate exists yet)."""
        if req.deadline is None:
            return False
        if now >= req.deadline:
            return True
        if self._rate:
            steps = len(req.prompt) - 1 + req.budget
            if now + steps / self._rate > req.deadline:
                return True
        return False

    def _admit(self, now):
        for b in range(self.slots):
            slot = self._slots[b]
            if slot.rid >= 0 or slot.quarantined:
                continue
            while self._queue:
                req = self._queue.pop(0)
                if self._shed(req, now):
                    self._finish(req, "shed", now)
                    continue
                _faults.hit("serve.admit")
                slot.rid = req.rid
                slot.consumed = 0
                req.admitted_at = now
                self.report.admitted += 1
                self._graph.reset_slot(b)
                break

    # -- internal: chunk dispatch + retirement ------------------------------

    def _build_feed(self):
        """The chunk's ``ctl`` rows (see :class:`_ChunkGraph`): feed, fp,
        poison, t0 and the step counter 0."""
        C, B = self.chunk, self.slots
        ctl = np.zeros((C + 4, B), np.int64)
        feed, fp, poison = ctl[:C], ctl[C], ctl[C + 1]
        fp[:] = C                               # idle slots: inert zeros
        poison[:] = -1
        ctl[C + 2] = self._t_global
        spec = _faults.serve_nan_spec()
        for b, slot in enumerate(self._slots):
            if slot.rid < 0:
                continue
            req = self.requests[slot.rid]
            L = len(req.prompt)
            left = max(0, L - slot.consumed)
            fp[b] = left
            if left > 0:
                k = min(C, left)
                feed[:k, b] = req.prompt[slot.consumed:slot.consumed + k]
            if spec and req.rid in spec:
                # poison at generation index g ⇒ global step (L - 1 + g)
                i = (L - 1 + spec[req.rid]) - slot.consumed
                if 0 <= i < C:
                    poison[b] = i
        return ctl

    def _check_workers(self):
        """Surface a worker loss BEFORE dispatching the next chunk: the
        ``serve.worker`` fault point or a ``health_check`` that names lost
        workers raises :class:`WorkerLost`; in-flight slots keep their
        partial state so the failover layer can replay their requests."""
        try:
            _faults.hit("serve.worker")
        except _faults.FaultError as e:
            raise WorkerLost(str(e)) from e
        if self._health_check is not None:
            lost = self._health_check()
            if lost:
                raise WorkerLost(f"worker(s) lost: {sorted(lost)}",
                                 lost=lost)

    def _run_chunk(self):
        self._check_workers()
        _faults.hit("serve.chunk")
        self._graph.prepare()
        toks, oks = self._graph.run(self._build_feed())
        self._t_global += self.chunk
        before = self._now
        self._now = self._clock()
        obs = self.chunk / max(self._now - before, 1e-9)
        self._rate = obs if self._rate is None \
            else 0.5 * self._rate + 0.5 * obs
        self._retire(toks, oks, self._now)

    def _retire(self, toks, oks, now):
        for b, slot in enumerate(self._slots):
            if slot.rid < 0:
                continue
            req = self.requests[slot.rid]
            L = len(req.prompt)
            c0 = slot.consumed
            finished = None
            for i in range(self.chunk):
                s = c0 + i
                if not oks[i, b]:
                    # abort at generation index (clipped to 0 while the
                    # failure happened during this slot's prefill)
                    g_bad = min(max(s - (L - 1), 0), req.budget)
                    del req.tokens[g_bad:]
                    finished = "aborted"
                    break
                if s >= L - 1:
                    req.tokens.append(int(toks[i, b]))
                    if self.eos_id is not None \
                            and req.tokens[-1] == self.eos_id:
                        finished = "completed"
                        break
                    if len(req.tokens) >= req.budget:
                        finished = "completed"
                        break
            slot.consumed = c0 + self.chunk
            if finished is None and req.deadline is not None \
                    and now > req.deadline:
                finished = "deadline_miss"
            if finished is None:
                continue
            slot.rid = -1
            slot.consumed = 0
            if finished == "aborted":
                slot.aborts += 1
                if slot.aborts >= self._nan_limit and not slot.quarantined:
                    slot.quarantined = True
                    self.report.quarantined_slots.append(b)
            self._finish(req, finished, now)

    def _drain_live(self):
        while any(s.rid >= 0 for s in self._slots):
            self._run_chunk()

    def _flush_waiting(self, deadline_hit: bool = False):
        now = self._now if self._now is not None else 0.0
        for req in self._queue + self._pending:
            self._finish(req, "unserved", now)
        self._queue.clear()
        self._pending.clear()
        if deadline_hit:
            self.report.deadline_hit = True

    def _finish(self, req, disposition, now):
        req.disposition = disposition
        req.finished_at = now
        r = self.report
        if disposition == "completed":
            r.completed.append(req.rid)
        elif disposition == "aborted":
            r.aborted[req.rid] = len(req.tokens)
        elif disposition == "shed":
            r.shed.append(req.rid)
        elif disposition == "deadline_miss":
            r.deadline_miss[req.rid] = len(req.tokens)
        else:
            r.unserved.append(req.rid)
        if disposition in ("completed", "aborted", "deadline_miss"):
            r.latency_s[req.rid] = now - req.arrival
            self._total_tokens += len(req.tokens)


def serve_continuous(step, make_cache, prompts, lengths=None, *,
                     tokens: int, slots: int | None = None, chunk: int = 8,
                     warm: bool = True, token_budget: int | None = None,
                     time_budget_s: float | None = None, eos_id=None,
                     logit_hook=None, arrivals=None, deadlines=None,
                     max_queue: int | None = None, slot_nan_limit: int = 2,
                     clock=None, max_seq: int | None = None):
    """Serve many prompts through the continuous-batching engine.

    The counterpart of :func:`serve_requests` (same request encoding,
    same :class:`ServeOutput` return: ``(gen (R, T) on the host,
    seconds)``, rows zero-padded to the effective token count ``T``)
    built on :class:`ContinuousEngine`: requests are admitted into slots
    as they vacate mid-stream, so one long request never stalls the
    others.  Extras over the fixed scheduler: ``arrivals`` (per-request
    arrival times), ``deadlines`` (per-request ``deadline_s`` relative to
    arrival; enables shedding and ``deadline_miss``), ``eos_id``
    (per-request early retirement), ``max_queue`` / ``slot_nan_limit`` /
    ``clock`` (see :class:`ContinuousEngine`), and ``chunk`` (steps per
    engine iteration, the deadline and admission granularity).
    ``max_seq`` pins the engine window (default ``P + T``).
    """
    prompts, lengths = _normalize_requests(prompts, lengths)
    R, P = prompts.shape
    eff = tokens if token_budget is None else max(1, min(tokens,
                                                         token_budget))
    if R == 0:
        return ServeOutput(torch.zeros((0, eff), dtype=torch.long), 0.0,
                           ServeReport(tokens_per_request=eff,
                                       engine="continuous"))
    n_slots = min(slots or min(4, R), R)
    window = max_seq if max_seq is not None else P + eff
    eng = ContinuousEngine(step, make_cache, slots=n_slots, max_seq=window,
                           chunk=chunk, eos_id=eos_id, logit_hook=logit_hook,
                           clock=clock, max_queue=max_queue,
                           slot_nan_limit=slot_nan_limit, warm=warm)
    pn, ln = prompts.cpu().numpy(), lengths.cpu().numpy()
    for r in range(R):
        eng.submit(pn[r, :int(ln[r])], tokens=eff,
                   arrival=0.0 if arrivals is None else float(arrivals[r]),
                   deadline_s=None if deadlines is None
                   else deadlines[r], rid=r)
    t0 = time.perf_counter()
    report = eng.run(time_budget_s=time_budget_s)
    seconds = time.perf_counter() - t0
    report.tokens_per_request = eff
    gen = np.zeros((R, eff), np.int64)
    for r in range(R):
        tk = eng.requests[r].tokens[:eff]
        gen[r, :len(tk)] = tk
    return ServeOutput(torch.from_numpy(gen), seconds, report)


def serve_with_failover(step, make_cache, prompts, lengths=None, *,
                        tokens: int, slots: int | None = None,
                        chunk: int = 8, warm: bool = True,
                        token_budget: int | None = None,
                        time_budget_s: float | None = None, eos_id=None,
                        logit_hook=None, arrivals=None, deadlines=None,
                        max_queue: int | None = None,
                        slot_nan_limit: int = 2, clock=None,
                        max_seq: int | None = None, max_failovers: int = 2,
                        health_check=None, engine_factory=None):
    """:func:`serve_continuous` with failover.

    Runs the continuous engine; when a worker loss surfaces
    (:class:`WorkerLost`, from ``health_check`` or the ``serve.worker``
    fault point) the coordinator keeps what finished, **re-forms** the
    engine on surviving capacity, and **replays** every in-flight request
    from its recorded prompt under its original rid.  Decode is
    deterministic and slots are batch-independent, so replayed tokens are
    bit-identical to an uninterrupted run.  Each re-formed engine builds
    its own state and capture; the lost engine's are released first.

    ``engine_factory(attempt) -> dict`` customizes the re-formed engine
    (any :class:`ContinuousEngine` keyword); the default halves the slot
    count per failover.  After ``max_failovers`` re-formations the
    remaining in-flight requests are reported ``unserved`` — every rid
    always carries a disposition.  The merged report records
    ``failovers``, ``lost_workers`` and ``replayed`` (rids, with repeats
    if a request was replayed more than once).  A replayed request
    restarts its latency and deadline clock at the re-formed engine's
    epoch.
    """
    prompts, lengths = _normalize_requests(prompts, lengths)
    R, P = prompts.shape
    eff = tokens if token_budget is None else max(1, min(tokens,
                                                         token_budget))
    master = ServeReport(tokens_per_request=eff,
                         engine="continuous+failover")
    if R == 0:
        return ServeOutput(torch.zeros((0, eff), dtype=torch.long), 0.0,
                           master)
    base_slots = min(slots or min(4, R), R)
    window = max_seq if max_seq is not None else P + eff
    pn, ln = prompts.cpu().numpy(), lengths.cpu().numpy()

    def default_factory(attempt: int) -> dict:
        # survivor capacity stand-in: half the slots per failover (slots
        # are batch-independent, so shrinking never changes tokens)
        return {"slots": max(1, base_slots >> attempt)}

    factory = engine_factory or default_factory
    outstanding = list(range(R))
    tokens_final: dict[int, list[int]] = {}
    seconds = 0.0
    attempt = 0
    while outstanding:
        kw = dict(factory(attempt))
        n_slots = max(1, min(int(kw.pop("slots", base_slots)),
                             len(outstanding)))
        eng = ContinuousEngine(
            step, make_cache, slots=n_slots,
            max_seq=kw.pop("max_seq", window), chunk=kw.pop("chunk", chunk),
            eos_id=kw.pop("eos_id", eos_id),
            logit_hook=kw.pop("logit_hook", logit_hook),
            clock=kw.pop("clock", clock),
            max_queue=kw.pop("max_queue", max_queue),
            slot_nan_limit=kw.pop("slot_nan_limit", slot_nan_limit),
            warm=kw.pop("warm", warm),
            health_check=kw.pop("health_check", health_check), **kw)
        replaying = attempt > 0
        for r in outstanding:
            eng.submit(pn[r, :int(ln[r])], tokens=eff,
                       arrival=0.0 if (replaying or arrivals is None)
                       else float(arrivals[r]),
                       deadline_s=None if deadlines is None
                       else deadlines[r], rid=r)
        t0 = time.perf_counter()
        lost = None
        try:
            eng.run(time_budget_s=time_budget_s)
        except WorkerLost as e:
            # keep the ids, not the exception: its traceback holds the
            # engine, whose state and capture are released below
            lost = e.lost or [attempt]
        seconds += time.perf_counter() - t0
        rep = eng.report
        master.completed.extend(rep.completed)
        master.aborted.update(rep.aborted)
        master.shed.extend(rep.shed)
        master.deadline_miss.update(rep.deadline_miss)
        master.unserved.extend(rep.unserved)
        master.latency_s.update(rep.latency_s)
        master.queue_peak = max(master.queue_peak, rep.queue_peak)
        master.admitted += rep.admitted
        master.deadline_hit = master.deadline_hit or rep.deadline_hit
        master.quarantined_slots.extend(rep.quarantined_slots)
        still = []
        for r in outstanding:
            req = eng.requests[r]
            if req.disposition is None:        # in flight at the loss
                still.append(r)
            else:
                tokens_final[r] = list(req.tokens)[:eff]
        outstanding = still
        del eng
        if lost is None:
            break                              # clean run: all disposed
        master.failovers += 1
        master.lost_workers.extend(lost)
        master.replayed.extend(outstanding)
        attempt += 1
        if attempt > max_failovers:
            for r in outstanding:              # give up, but never drop
                master.unserved.append(r)
                tokens_final[r] = []
            outstanding = []
    gen = np.zeros((R, eff), np.int64)
    total = 0
    for r, tk in tokens_final.items():
        gen[r, :len(tk)] = tk
        total += len(tk)
    master.sustained_tok_s = total / max(seconds, 1e-9)
    return ServeOutput(torch.from_numpy(gen), seconds, master)
