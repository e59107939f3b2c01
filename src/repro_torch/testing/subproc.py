"""Child processes for the crash tests: a pinned environment and
``python -m``.

The kill-and-resume smoke (:func:`repro_torch.testing.faults.
kill_resume_smoke`) crashes a real child process mid-build; the child
needs this package on ``PYTHONPATH`` (it may be started from any
directory) and the fault plan in ``REPRO_FAULTS``; a child on the CPU
sees no card.  Standard library only.
"""
from __future__ import annotations

import os
import subprocess
import sys

from . import faults

#: The ``src`` tree this module was imported from.
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: ``src``'s parent, the child's default working directory.
REPO_ROOT = os.path.dirname(SRC_ROOT)

def subprocess_env(*, device: str = "cuda", faults_spec: str | None = None,
                   extra: dict | None = None) -> dict:
    """The child's environment: the caller's, with ``PYTHONPATH`` led by
    this package's ``src``, ``REPRO_FAULTS`` set to ``faults_spec``
    (removed when None), and no card visible when ``device`` is 'cpu'
    (the card's visibility is the caller's otherwise); ``extra`` merges
    last."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_ROOT + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else "")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop(faults.ENV_VAR, None)
    if faults_spec is not None:
        env[faults.ENV_VAR] = faults_spec
    env.update(extra or {})
    return env


def run_module(module: str, *args: str, env: dict | None = None,
               timeout: float = 600, check: bool = True,
               cwd: str | None = None) -> subprocess.CompletedProcess:
    """``python -m module args...`` in the environment ``env`` (default
    :func:`subprocess_env`); with ``check`` a non-zero exit raises with
    the end of the child's output."""
    r = subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=timeout,
        env=env if env is not None else subprocess_env(),
        cwd=cwd or REPO_ROOT)
    if check and r.returncode != 0:
        raise AssertionError(f"{module} exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return r
