"""Child processes for the crash tests and the distributed table build:
a pinned environment, ``python -c`` and ``python -m``.

The kill-and-resume smoke (:func:`repro_torch.testing.faults.
kill_resume_smoke`) crashes a real child process mid-build, and the
distributed build (:mod:`repro_torch.core.dist_build`) spawns its
workers here.  A child needs this package on ``PYTHONPATH`` (it may be
started from any directory), the fault plan in ``REPRO_FAULTS`` and, as
a worker, its identity in ``REPRO_PROCESS_ID`` / ``REPRO_NUM_PROCESSES``
(:mod:`repro_torch.launch.distributed`); a child on the CPU sees no card.
The JAX package's forced host-device count
(``--xla_force_host_platform_device_count``) has no PyTorch counterpart
and is left out: a child sees the cards its parent sees, or none.
Standard library only.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

from repro_torch.launch.distributed import ENV_NUM_PROCESSES, ENV_PROCESS_ID

from . import faults

#: The ``src`` tree this module was imported from.
SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: ``src``'s parent, the child's default working directory.
REPO_ROOT = os.path.dirname(SRC_ROOT)

def subprocess_env(*, device: str = "cuda", process_id: int | None = None,
                   num_processes: int | None = None,
                   faults_spec: str | None = None,
                   extra: dict | None = None) -> dict:
    """The child's environment: the caller's, with ``PYTHONPATH`` led by
    this package's ``src``, ``REPRO_PROCESS_ID`` / ``REPRO_NUM_PROCESSES``
    set to ``process_id`` / ``num_processes`` and ``REPRO_FAULTS`` to
    ``faults_spec`` (each removed when None), and no card visible when
    ``device`` is 'cpu' (the card's visibility is the caller's
    otherwise); ``extra`` merges last."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_ROOT + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else "")
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    for var, val in ((ENV_PROCESS_ID, process_id),
                     (ENV_NUM_PROCESSES, num_processes),
                     (faults.ENV_VAR, faults_spec)):
        env.pop(var, None)
        if val is not None:
            env[var] = str(val)
    env.update(extra or {})
    return env


def run_code(code: str, *, env: dict | None = None, timeout: float = 600,
             check: bool = True,
             cwd: str | None = None) -> subprocess.CompletedProcess:
    """Run a dedented Python snippet in a child interpreter in the
    environment ``env`` (default :func:`subprocess_env`); with ``check`` a
    non-zero exit raises with the end of the child's output."""
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
        text=True, timeout=timeout,
        env=env if env is not None else subprocess_env(),
        cwd=cwd or REPO_ROOT)
    if check and r.returncode != 0:
        raise AssertionError(f"subprocess exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return r


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
