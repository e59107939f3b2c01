"""Pytree checkpoints, atomic single-file publishes and the write-ahead
journal.

The port's copy of the JAX package's ``repro.checkpoint.ckpt``.  Crash
contracts:

* **checkpoints** — :func:`save` writes ``<dir>/step_<N>.tmp/`` with
  ``arrays.npz`` (host arrays flattened by key path, ``a/b/0/c``:
  :func:`flatten_leaves`, the layout merged-model artifacts share) and
  ``meta.json`` (step, keys, caller metadata), fsyncs both and renames
  the directory to ``step_<N>``; :func:`latest_step` sees only complete
  checkpoints, a crash mid-write leaves a ``.tmp`` directory that the
  next save removes, and ``keep`` bounds how many stay.
  :class:`AsyncCheckpointer` copies the tree to the host on the caller's
  thread and writes it on a background thread, one save in flight.
  :func:`restore` rebuilds a tree shaped like ``like`` on its leaves'
  devices and dtypes.  The layout and keys are the JAX package's, so a
  checkpoint written by either package restores in the other bitwise.
  numpy has no bfloat16: a bf16 leaf is written widened to fp32 (exact)
  and a JAX-written bf16 leaf (stored as raw 2-byte ``|V2`` records) is
  read back from its bits; both restore to ``like``'s dtype.  Under a
  mesh a tree of rank blocks (tensors carrying a
  :class:`~repro_torch.sharding.rules.Placement`) is gathered whole on
  every rank and only the main process writes it, in the single-device
  format; :func:`restore` with ``shardings=`` gives each rank its block
  of the placements of the mesh it runs on, whatever mesh saved it
  (elastic restore).
* **atomic publish** — :func:`atomic_write_text`, :func:`atomic_writer`
  and :func:`atomic_write_bytes` write ``path + '.tmp'``, flush and fsync
  it, then rename it over ``path``: a reader sees the old file or the new
  one, never a torn write, and an interrupted write leaves only a
  ``.tmp`` orphan.  The table cache (:mod:`repro_torch.core.table_cache`)
  and the merged-model artifacts (:mod:`repro_torch.runtime.artifact`)
  publish through them.
* **journal** — :func:`append_journal_line` appends one fsync'd,
  newline-terminated record; :func:`read_journal_lines` returns the
  complete records and truncates a torn tail (a record whose newline
  never reached the disk) before anything parses it or appends after it.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.launch.distributed import is_main
from repro_torch.testing import faults
from repro_torch.tree import flatten_tree, tree_map, tree_map_with_path


def atomic_write_text(path: str, text: str) -> str:
    """Atomic publish of a text file (see :func:`atomic_writer`)."""
    return atomic_write_bytes(path, text.encode())


@contextlib.contextmanager
def atomic_writer(path: str):
    """A binary file object open on ``path + '.tmp'``; on a clean exit the
    data is flushed and fsync'd and renamed over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        yield f
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Atomic single-shot binary publish (see :func:`atomic_writer`)."""
    with atomic_writer(path) as f:
        f.write(data)
    return path


def append_journal_line(path: str, text: str, *,
                        point: str = "journal.append") -> str:
    """Crash-safe append of one journal record.

    ``text`` (newlines squashed) is written as one ``\\n``-terminated
    line, flushed and fsync'd before return: once this returns, the record
    survives a SIGKILL.  A crash during the write leaves a tail with no
    newline, which :func:`read_journal_lines` truncates on the next open.
    Fault points: ``point`` (a :func:`~repro_torch.testing.faults.mangle`
    over the line's bytes: torn or garbled writes) and ``point + '.done'``
    (after the fsync).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = faults.mangle(point, (text.replace("\n", " ") + "\n").encode())
    with open(path, "ab") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    faults.hit(point + ".done")
    return path


def read_journal_lines(path: str) -> list[str]:
    """Every complete line of a journal; heals a torn tail.

    A record is complete when its newline reached the disk.  Trailing
    bytes with no newline are truncated off the file before returning, so
    later appends never concatenate onto them.  A missing file is an
    empty journal.
    """
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return []
    cut = raw.rfind(b"\n") + 1               # 0 when there is no newline
    if cut != len(raw):
        with open(path, "r+b") as f:
            f.truncate(cut)
        raw = raw[:cut]
    return raw.decode(errors="replace").splitlines()


# ---------------------------------------------------------------------------
# Pytree checkpoints
# ---------------------------------------------------------------------------

def _to_host(x) -> np.ndarray:
    """A host copy of ``x`` that nothing else writes (a CPU tensor's
    ``numpy()`` would share its memory)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:         # numpy has no bfloat16
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # JAX's bf16
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def gather_whole(tree):
    """``tree`` with every tensor that carries a split placement (a rank's
    block) all-gathered whole over the placement's axes, dimension by
    dimension; other leaves as they are.  Every rank of the placements'
    mesh must call it, in the same order."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import sharding_of

    def one(t):
        place = sharding_of(t) if isinstance(t, torch.Tensor) else None
        if place is None or not place.split_dims():
            return t
        t = t.detach()
        for d in place.split_dims():
            t = C.all_gather(t, place.mesh, place.spec[d], dim=d)
        return t
    return tree_map(one, tree)


def flatten_leaves(tree) -> dict:
    """Host arrays keyed by key path (``a/b/0/c``): the on-disk layout of
    checkpoints, shared with the merged-model artifacts."""
    return {k: _to_host(v) for k, v in flatten_tree(tree).items()}


def _write_synced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree, *, metadata: dict | None = None,
         keep: int = 3) -> str:
    """Synchronous atomic save of ``tree`` as ``<ckpt_dir>/step_<step>``;
    prunes all but the newest ``keep`` complete checkpoints.  A tree of
    rank blocks is gathered whole first (:func:`gather_whole`, on every
    rank); only the main process writes (the path comes back on every
    rank)."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tree = gather_whole(tree)
    if not is_main():
        return final
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = flatten_leaves(tree)
    _write_synced(os.path.join(tmp, "arrays.npz"),
                  lambda f: np.savez(f, **leaves))
    meta = json.dumps({"step": step, "keys": sorted(leaves),
                       "metadata": metadata or {}})
    _write_synced(os.path.join(tmp, "meta.json"),
                  lambda f: f.write(meta.encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Saves on a background thread, one in flight.

    :meth:`save` waits for the previous save, copies the tree to the host
    (so the caller may overwrite its tensors as soon as it returns) and
    writes it in the background.  As a context manager, ``__exit__``
    joins the save in flight, on a clean exit and on an exception, so an
    interrupted run never leaves its newest checkpoint half-written; a
    save's error is raised by the next :meth:`wait` (never over the
    body's own exception)::

        with AsyncCheckpointer(ckpt_dir) as ckpt:
            for step in ...:
                ckpt.save(step, state)
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None

    def save(self, step: int, tree, metadata=None):
        """Gathers a tree of rank blocks whole on the caller's thread (a
        collective: every rank calls it); only the main process writes."""
        self.wait()
        tree = gather_whole(tree)
        if not is_main():
            return
        host_tree = tree_map(_to_host, tree)

        def run():
            try:
                save(self.ckpt_dir, step, host_tree, metadata=metadata,
                     keep=self.keep)
            except Exception as e:        # raised by the next wait()
                self.error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.wait()                      # surface any save error
        else:
            try:                             # still join the writer, but
                self.wait()                  # never mask the body's error
            except Exception:
                pass
        return False


def _complete_steps(ckpt_dir: str) -> list[int]:
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            steps.append(int(m.group(1)))
    return steps


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, *, shardings=None):
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    on the device and in the dtype of ``like``'s tensor there (a leaf
    that is not a tensor gives a CPU tensor of the stored dtype).

    ``shardings``: a matching tree of
    :class:`~repro_torch.sharding.rules.Placement` objects on the mesh
    this rank runs on (None leaves: whole): each leaf comes back as this
    rank's block of the saved whole array, carrying its placement
    (``like``'s tensors may be blocks or whole; only their device and
    dtype are read).  The checkpoint needs no record of the mesh that
    wrote it."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    places = flatten_tree(shardings) if shardings is not None else {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}

    def one(key, leaf):
        if key not in data:
            raise KeyError(f"checkpoint missing {key}")
        t = _from_host(data[key])
        place = places.get(key)
        if place is not None:
            t = place.take(t)
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        if place is not None:
            from repro_torch.sharding.rules import with_sharding
            t = with_sharding(t, _with_shape(place, data[key].shape))
        return t
    return tree_map_with_path(one, like)


def _with_shape(place, shape):
    """``place`` with the saved array's global ``shape``."""
    return type(place)(place.mesh, place.spec, tuple(shape))


def _gc(ckpt_dir: str, keep: int):
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    for s in sorted(_complete_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
