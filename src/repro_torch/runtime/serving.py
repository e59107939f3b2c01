"""Single-batch greedy serving: per-token prefill, then greedy decode.

The port of the JAX package's :func:`repro.runtime.serving.serve_loop`
protocol.  ``step(cache, tokens) → (logits, cache)`` is any one-token
step — the original stack's (:func:`repro_torch.models.transformer.
decode_step`) or a compressed artifact's
(:meth:`~repro_torch.runtime.artifact.CompressedArtifact.decode`) — so
both are measured the same way.  Prefill feeds the prompt token by token
through ``step`` (so every lowrank unit sees M = batch rows); decode
issues ``tokens - 1`` greedy steps.  Both are Python loops of eager
launches; CUDA graphs are ROADMAP.md queue 1.

Caches are updated in place, so :func:`serve_loop` takes a factory of
fresh caches.  On the card the two phases are timed with CUDA events;
on the CPU with the host clock.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve


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


def decode_tok_s(tokens: int, batch: int, seconds: float) -> float:
    """Decode throughput; guards the div by tiny timings."""
    return tokens * batch / max(seconds, 1e-9)


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


def serve_loop(step, new_cache, prompt, tokens: int):
    """Prefill ``prompt`` (B, P) and decode ``tokens`` greedy tokens.

    ``new_cache()`` returns a fresh cache.  The whole loop runs once
    unmeasured first, so the times are steady-state serving.
    Returns ``(prefill_s, decode_s, last_logits (B, V), seqs (B, tokens))``
    where ``seqs[:, 0]`` is the prefill's greedy token.
    """
    logits, cache = _prefill(step, new_cache(), prompt)
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
