"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Every kernel source under ``csrc/`` exposes plain C functions (an fp32
entry point and, for the three merged-segment kernels, its quantized
variant; for the norm, a bf16 body; for the scan, its gradient; the
attention's bf16 body is a source of its own), so it builds in seconds without PyTorch's headers.  None
links a library beyond the CUDA runtime: the bf16 attention finds
libcuda's tensor-map encoder through the runtime's entry-point query.
A library is built at first use into ``build/repro_torch/`` at the root
of the checkout — or, for an installed
package, into ``$XDG_CACHE_HOME/repro_torch`` (``~/.cache/repro_torch``) —
named by a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per missing library and waits for all of
them, which is how the smoke run builds every kernel in parallel.  One library holds every entry point of
its source.

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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Each kernel entry point: its source (``csrc/<source>.cu``, one library),
#: its C function and the C function's argument types.
SIGNATURES = {
    # x, w, bias, y, n, h, w, cin, kh, kw, cout, stride, ho, wo, act, then
    # the plan (bm, bn, splits, k_chunk, a_vec, b_vec, dense, s8), stream
    "merged_conv": ("merged_conv", "merged_conv_f32",
                    [_P, _P, _P, _P] + [_I] * 19 + [_P]),
    # x, w, scale, bias, y, n, h, w, cin, kh, kw, cout, stride, ho, wo, act,
    # x_type, w_type, the plan as above, stream
    "merged_conv_q": ("merged_conv", "merged_conv_q",
                      [_P, _P, _P, _P, _P] + [_I] * 21 + [_P]),
    # x, w, bias, y, n, h, w, cin, kh, kw, cin_g, cout, groups, stride, ho,
    # wo, act, then the plan (vec, k_t, s_t, threads), stream
    "depthwise_conv": ("depthwise_conv", "depthwise_conv_f32",
                       [_P, _P, _P, _P] + [_I] * 17 + [_P]),
    # x, w, scale, bias, y, n, h, w, cin, kh, kw, cin_g, cout, groups,
    # stride, ho, wo, act, x_type, w_type, the plan as above, stream
    "depthwise_conv_q": ("depthwise_conv", "depthwise_conv_q",
                         [_P, _P, _P, _P, _P] + [_I] * 19 + [_P]),
    # x, u, v, y, p, m, d, r, then the plan of each phase (bm, bn,
    # splits, k_chunk: A, then B), residual (0 or 1), stream
    "merged_ffn": ("merged_ffn", "merged_ffn_f32",
                   [_P] * 5 + [_I] * 12 + [_P]),
    # x, xq, u, v, u_scale, v_scale, y, p, m, d, r, xq_type, w_type, the
    # plan as above, residual, stream
    "merged_ffn_q": ("merged_ffn", "merged_ffn_q",
                     [_P] * 8 + [_I] * 14 + [_P]),
    # bm, bn, splits: resident blocks in clusters of splits (no stream)
    "merged_ffn_slots": ("merged_ffn", "merged_ffn_slots", [_I] * 3),
    # x, g, y, m, d, eps, then the plan (path, wr, nc), stream
    "rmsnorm": ("rmsnorm", "rmsnorm_f32",
                [_P] * 3 + [_I, _I, _F, _I, _I, _I, _P]),
    # the bf16 body: x, g, y, m, d, eps, g_f32, the plan as above, stream
    "rmsnorm_bf16": ("rmsnorm", "rmsnorm_bf16",
                     [_P] * 3 + [_I, _I, _F, _I, _I, _I, _I, _P]),
    # a, b, h, batch, s, c, then the plan (ct, tc, stages, vec), stream
    "rglru_scan": ("rglru_scan", "rglru_scan_f32", [_P] * 3 + [_I] * 7 + [_P]),
    # its gradient: a, h, g, da, db, batch, s, c, the plan as above, stream
    "rglru_scan_bwd": ("rglru_scan", "rglru_scan_bwd_f32",
                       [_P] * 5 + [_I] * 7 + [_P]),
    # q, k, v, o, b, s, h, kvh, d, causal, then the plan (wr, dsplit),
    # stream
    "flash_attention": ("flash_attention", "flash_attention_f32",
                        [_P] * 4 + [_I] * 8 + [_P]),
    # the bf16 body (a Hopper kernel of its own): q, k, v, o, b, s, h,
    # kvh, d, causal, then the plan (cw, dsplit), stream
    "flash_attention_bf16": ("flash_attention_bf16", "flash_attention_bf16",
                             [_P] * 4 + [_I] * 8 + [_P]),
}

#: The kernel sources, one library each.
SOURCES = tuple(sorted({src for src, _, _ in SIGNATURES.values()}))

#: Element-type codes of the quantized entry points' ``x_type`` (the
#: activation: fp32, or int8 under w8a8) and ``w_type`` (narrow weights).
X_TYPES = {torch.float32: 0, torch.int8: 1}
W_TYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}


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
    """Path of the library built from ``csrc/<name>.cu`` (its hash covers
    the shared headers ``csrc/*.cuh`` too)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, BuildResult]:
    """Build the named kernel libraries (``SOURCES`` by default), in
    parallel."""
    names = list(SOURCES if names is None else names)
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
_FNS: dict[str, object] = {}


def kernel(name: str):
    """The C entry point ``name`` of ``SIGNATURES``, its argument types
    bound once (its library built on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        src, fn_name, argtypes = SIGNATURES[name]
        if src not in _LIBS:
            path = build([src])[src].path
            _LIBS[src] = ctypes.CDLL(str(path))
        fn = getattr(_LIBS[src], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


#: Epilogue activation codes shared by every kernel's C interface.
ACT_CODES = {None: 0, "none": 0, "relu": 1, "relu6": 2, "silu": 3}

INT32_MAX = 2 ** 31 - 1


def check_operands(name: str, *tensors, dtypes=None) -> None:
    """Raise unless every given tensor is contiguous, on one CUDA device,
    small enough for the kernels' 32-bit offsets, and fp32 — or, where
    ``dtypes`` (one entry per tensor) is given, of a dtype in its entry."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        allowed = (torch.float32,) if dtypes is None else tuple(dtypes[i])
        if t.dtype not in allowed:
            raise TypeError(f"{name}: the CUDA kernel takes "
                            f"{' or '.join(str(d)[6:] for d in allowed)} "
                            f"for operand {i}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.numel() > INT32_MAX:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the kernel's "
                             "32-bit indexing")


_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (what the launch plans fill), read once."""
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return n


def launch(name: str, device, *args) -> None:
    """Call kernel ``name`` on ``device``'s current stream; raise on a
    refused launch (the C function returns ``cudaGetLastError()``).  The
    device is made current only where it is not already, and the stream's
    handle is read without building a ``torch.cuda.Stream``."""
    fn = _FNS.get(name) or kernel(name)
    current = torch.cuda.current_device()
    if device.index is None or device.index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
