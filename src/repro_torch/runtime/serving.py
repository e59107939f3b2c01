"""Serving: captured prefill and decode, fused ragged prompts, slot batching.

The port of the JAX package's :mod:`repro.runtime.serving`, its
single-batch and fixed-slot layers.  ``step(cache, tokens) → (logits,
cache)`` is any one-token step — the original stack's
(:func:`repro_torch.models.transformer.decode_step`) or a compressed
artifact's (:meth:`~repro_torch.runtime.artifact.CompressedArtifact.
decode`) — that writes the cache's tensors in place and reads nothing
on the host; ``new_cache()`` and ``make_cache(batch, seq_len)`` build
zeroed caches.  Both stacks are served and measured the same way.

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

A cache's length is checked on the host before the first step: a prompt
plus tokens longer than a KV cache raises (:func:`check_room`), where the
reference clamps the slot.  Sharding (``rules=``), the continuous engine
and failover are not ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import launch_counts


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
        capture's shapes, reset, and capture one step.  On the CPU there
        is nothing to prepare."""
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        self.reset(feed, lengths)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._body()
        main.wait_stream(side)
        self.reset(feed, lengths)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        self.graph = graph
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
    failover fields belong to the continuous engine (not ported) and
    stay empty here; ``engine`` is ``"fixed"``.
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
    lost worker ids on ``.lost``.  The reference's failover catches it;
    the port has no failover yet (ROADMAP.md queue 1), so nothing here
    raises it."""

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
