"""Deterministic synthetic data pipeline — prefetched and resumable.

The port's own copy of the JAX package's ``data/pipeline.py``: the same
numpy generator, so batch ``i`` of a seed is bitwise the JAX package's.
Token streams come from an order-2 Markov language over the vocab with a
low-entropy transition table, so a model can learn it and a falling loss
means something.

* **Determinism / resumability** — batch ``i`` is a pure function of
  ``(seed, i)``: a restart from the checkpoint at step ``s`` replays the
  exact stream, with no iterator state to save.
* **Device batches** — :class:`GlobalBatcher` hands each batch back as
  tensors on the port's device; under a mesh, this rank's rows of it,
  each tensor carrying its placement (the JAX package's
  ``make_array_from_callback`` onto a batch-sharded ``NamedSharding``).
* **Prefetch** — :func:`prefetch` keeps a depth-``k`` queue filled from a
  background thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.sharding.rules import Placement, with_sharding


class MarkovLM:
    """Order-2 synthetic language with a low-entropy transition table."""

    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        self.table = rng.integers(0, vocab_size,
                                  size=(vocab_size, branching)).astype(np.int32)

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        branch = rng.integers(0, self.table.shape[1], size=(batch, seq))
        for t in range(seq):
            toks[:, t + 1] = self.table[toks[:, t], branch[:, t]]
        return toks


class SyntheticTokens:
    """batch(i) → {'tokens','targets','positions'} — pure in (seed, i)."""

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0):
        self.lm = MarkovLM(vocab_size, seed)
        self.batch, self.seq, self.seed = batch, seq, seed

    def batch_at(self, index: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        toks = self.lm.sample(rng, self.batch, self.seq)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "positions": np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                             (self.batch, self.seq)).copy()}


class GlobalBatcher:
    """``batcher(i)``: ``source.batch_at(i)`` as int32 tensors on
    ``device`` (the card by default; raises where there is none).

    With a ``mesh`` (a :class:`~repro_torch.launch.mesh.HostMesh`) each
    tensor is this rank's block of rows over ``batch_axes`` (those the
    mesh has), carrying its :class:`~repro_torch.sharding.rules.Placement`
    so the model takes it as a block and does not cut it again
    (:func:`repro_torch.models.transformer.local_batch`).  A batch the
    axes do not divide stays whole on every rank, as the rules keep
    it."""

    def __init__(self, source, mesh=None, batch_axes=("data",), *,
                 device="cuda"):
        self.source = source
        self.mesh = mesh
        self.batch_axes = batch_axes
        self.device = resolve(device)

    def __call__(self, index: int) -> dict[str, torch.Tensor]:
        host = self.source.batch_at(index)
        place = self._placement(host)
        out = {}
        for k, v in host.items():
            if place is not None:
                v = v[place.slices(v.shape[:1])]
            t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            if place is not None:
                with_sharding(t, Placement(place.mesh, place.spec,
                                           tuple(host[k].shape)))
            out[k] = t
        return out

    def _placement(self, host):
        """The rows' placement, or None (no mesh, or a whole batch)."""
        if self.mesh is None:
            return None
        axes = tuple(a for a in self.batch_axes if a in self.mesh.shape)
        n = len(next(iter(host.values())))
        if not axes or n % self.mesh.axis_size(axes):
            return None
        return Placement(self.mesh, (axes if len(axes) > 1 else axes[0],))


def prefetch(batch_fn, start: int, depth: int = 2) -> Iterator:
    """Depth-k background prefetch of batch_fn(start), batch_fn(start+1)…"""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        i = start
        while not stop.is_set():
            try:
                q.put((i, batch_fn(i)), timeout=0.5)
                i += 1
            except queue.Full:
                continue
    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
