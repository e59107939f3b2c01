"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Every kernel source under ``csrc/`` exposes a plain C function, so it builds
in seconds without PyTorch's headers.  A library is built at first use into
``build/repro_torch/`` at the root of the checkout — or, for an installed
package, into ``$XDG_CACHE_HOME/repro_torch`` (``~/.cache/repro_torch``) —
named by a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused.  :func:`build` starts one ``nvcc``
per missing library and waits for all of them, which is how the smoke run
builds both kernels in parallel.

Nothing here runs at import time: the CPU tests import every module of the
package, and this machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C entry point and argument types of each kernel library.
SIGNATURES = {
    # x, w, bias, y, n, h, w, cin, kh, kw, cout, stride, ho, wo, act, stream
    "merged_conv": ("merged_conv_f32",
                    [_P, _P, _P, _P] + [_I] * 11 + [_P]),
    # x, w, bias, y, n, h, w, cin, kh, kw, cin_g, cout, groups, stride, ho,
    # wo, act, stream
    "depthwise_conv": ("depthwise_conv_f32",
                       [_P, _P, _P, _P] + [_I] * 13 + [_P]),
}


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float            # 0.0 when the library was already built
    log: str                  # nvcc's output (``-Xptxas -v`` resource lines)
    cached: bool


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file() and (root / "src").is_dir():
        return root / "build" / "repro_torch"           # a source checkout
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, BuildResult]:
    """Build the named kernel libraries (all by default), in parallel."""
    names = list(SIGNATURES if names is None else names)
    out: dict[str, BuildResult] = {}
    procs = []
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = BuildResult(name, path, 0.0, "", True)
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = BuildResult(name, path, secs, log, False)
    if failed:
        raise BuildError("\n".join(failed))
    return out


_LIBS: dict[str, ctypes.CDLL] = {}


def kernel(name: str):
    """The bound C entry point of kernel ``name`` (built on first use)."""
    if name not in _LIBS:
        path = build([name])[name].path
        _LIBS[name] = ctypes.CDLL(str(path))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(_LIBS[name], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


#: Epilogue activation codes shared by every kernel's C interface.
ACT_CODES = {None: 0, "none": 0, "relu": 1, "relu6": 2, "silu": 3}

_INT32_MAX = 2 ** 31 - 1


def check_operands(name: str, *tensors) -> None:
    """Raise unless every given tensor is fp32, contiguous, on one CUDA
    device, and small enough for the kernels' 32-bit offsets."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the kernel's "
                             "32-bit indexing")


def launch(name: str, device, *args) -> None:
    """Call kernel ``name`` on ``device``'s current stream; raise on a
    refused launch (the C function returns ``cudaGetLastError()``)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
