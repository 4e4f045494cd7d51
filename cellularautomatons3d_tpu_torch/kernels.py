"""Build and load the port's hand-written CUDA kernels.

The sources are ``csrc/ca_step.cu`` and ``csrc/render_fast.cu``.  At first
use they are compiled with ``nvcc`` into one shared library with a plain C
interface and loaded with :mod:`ctypes`; no PyTorch headers are involved,
so a build takes seconds.  The library goes to
``build/cellularautomatons3d_tpu_torch/`` beside the package, named by a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false`` and the
default IEEE division and square root (no ``--use_fast_math``).  The render
kernel must keep the reference's float rounding: an FMA in ``ox + tm*dx``
can move a probe across a cell boundary and change a hit.

Nothing here runs at import: :func:`library` builds and loads on its first
call, which only the CUDA paths make.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "NVCC_FLAGS", "BUILD_DIR", "SOURCES",
    "build", "library", "require", "stream_of", "check",
]

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = (
    PACKAGE_DIR / "csrc" / "ca_step.cu",
    PACKAGE_DIR / "csrc" / "render_fast.cu",
)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cellularautomatons3d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build() -> Path:
    """Compile the kernels (if this source set is not built yet); return
    the library path.  The compiler's output, with ``-Xptxas -v``'s
    register and spill counts, is kept beside it as ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libca3d_kernels_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ca3d_error_string.argtypes = [_I]
        lib.ca3d_error_string.restype = ctypes.c_char_p
        lib.ca3d_ca_step.argtypes = [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.ca3d_ca_step.restype = _I
        lib.ca3d_render_fast.argtypes = [
            _I, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.ca3d_render_fast.restype = _I
        _lib = lib
    return _lib


def require(t, name: str, dtype, shape) -> None:
    """Validate a kernel operand: a contiguous CUDA tensor of the given
    dtype and shape.  The kernels take nothing else, and a CPU tensor is a
    caller error here, not a reason to fall back."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().ca3d_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
