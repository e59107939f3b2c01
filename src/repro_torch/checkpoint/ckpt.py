"""Atomic single-file publishes and the write-ahead journal.

The port's copy of the journal and atomic-write helpers of the JAX
package's ``repro.checkpoint.ckpt`` (its pytree checkpoints are not
ported yet).  Two crash contracts:

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
import os

from repro_torch.testing import faults


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
