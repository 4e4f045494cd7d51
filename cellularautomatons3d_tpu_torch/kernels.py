"""Build and load the port's hand-written CUDA kernels.

The sources are ``csrc/ca_step.cu`` (the CA step, on the whole grid or on
one shard of a sharded grid), ``csrc/render_fast.cu``
(K1), ``csrc/shadow_sweep.cu`` (K2), ``csrc/cell_state.cu`` (K3),
``csrc/primary_sweep.cu`` (K4), ``csrc/shadow_multi.cu`` (K5),
``csrc/prepass.cu`` (K6), ``csrc/occupied_box.cu`` (the occupied box of
a given mip, alone), ``csrc/coarse_occupancy.cu`` (the 8³ mip every frame
path rebuilds, with the occupied box K2, K4 and K5 clip to and the plane mip
of K1's mip1 descent in the same launch), ``csrc/compose.cu`` (a fast
frame's composition: the temporal EMA, static or with the moved camera's
history reprojection, the light cube, the f16 history, the depth overlay
and gamma), ``csrc/lighting_queries.cu`` (an
extended-lighting frame's occlusion queries: its hit geometry, soft-shadow
jitter and GI slot geometry as K2's operands, and in its level mode a
deeper level of the multi-bounce GI tree) and
``csrc/lighting_shade.cu`` (the frame's shading: the occlusion quotient,
the GI of one bounce or of the tree, the sliced frame's direct light and
the fused loop's composition); all but the CA step and K3
share the traversal and float helpers in ``csrc/sweep.cuh``
(the occupancy rebuild its ``OccBox`` and ``make_box``), K6 and K1 the
patch mask of ``csrc/prepass.cuh``, the rebuild above 256³ the block row of
``csrc/block_mip.cuh``, the two lighting kernels, K1's composition and the
frame's composition the geometry and BRDF of ``csrc/shading.cuh``,
and K5 and K3 read their per-query operands through the tables of
``csrc/queries.cuh``.
At first use each source is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with :mod:`ctypes`; no PyTorch headers are involved,
so a build takes seconds.
The library goes to ``build/cellularautomatons3d_tpu_torch/`` beside the
package, named by a hash of the sources, the header and the flags, so an
edited source builds anew and an unchanged one is reused.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false`` and the
default IEEE division and square root (no ``--use_fast_math``).  The render
kernels must keep the reference's float rounding: an FMA in ``ox + tm*dx``
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
    "NVCC_FLAGS", "BUILD_DIR", "SOURCES", "HEADERS",
    "build", "library", "loaded", "require", "stream_of", "check", "work_counts",
]

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = (
    PACKAGE_DIR / "csrc" / "ca_step.cu",
    PACKAGE_DIR / "csrc" / "render_fast.cu",
    PACKAGE_DIR / "csrc" / "shadow_sweep.cu",
    PACKAGE_DIR / "csrc" / "cell_state.cu",
    PACKAGE_DIR / "csrc" / "primary_sweep.cu",
    PACKAGE_DIR / "csrc" / "shadow_multi.cu",
    PACKAGE_DIR / "csrc" / "prepass.cu",
    PACKAGE_DIR / "csrc" / "occupied_box.cu",
    PACKAGE_DIR / "csrc" / "coarse_occupancy.cu",
    PACKAGE_DIR / "csrc" / "compose.cu",
    PACKAGE_DIR / "csrc" / "lighting_queries.cu",
    PACKAGE_DIR / "csrc" / "lighting_shade.cu",
)
HEADERS = tuple(PACKAGE_DIR / "csrc" / h
                for h in ("sweep.cuh", "queries.cuh", "prepass.cuh", "block_mip.cuh",
                          "shading.cuh"))
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cellularautomatons3d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
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
    the library path.  One ``nvcc -c`` per source runs in parallel, then
    one link.  The compilers' output, with ``-Xptxas -v``'s register and
    spill counts, is kept beside the library as ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libca3d_kernels_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} (exit code {proc.returncode}):\n{stderr[-4000:]}")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit code {proc.returncode}):\n{proc.stderr[-4000:]}")
    for o in objs:
        o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ca3d_error_string.argtypes = [_I]
        lib.ca3d_error_string.restype = ctypes.c_char_p
        lib.ca3d_ca_step.argtypes = [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P]
        lib.ca3d_ca_step.restype = _I
        lib.ca3d_age_masks.argtypes = [_I, _P, _I, _I, _P, _P, _P]
        lib.ca3d_age_masks.restype = _I
        lib.ca3d_ca_step_multistate.argtypes = [
            _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P,
        ]
        lib.ca3d_ca_step_multistate.restype = _I
        lib.ca3d_ca_step_slab.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
            _I, _I, _P,
        ]
        lib.ca3d_ca_step_slab.restype = _I
        lib.ca3d_render_fast.argtypes = [
            _I, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
            _P, _I, _I, _I, _P, _I, _I, _P,
        ]
        lib.ca3d_render_fast.restype = _I
        lib.ca3d_shadow_sweep.argtypes = [
            _I, _P, _P, _I, ctypes.c_float, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P,
            _I, _I, _P,
        ]
        lib.ca3d_shadow_sweep.restype = _I
        lib.ca3d_cell_state.argtypes = [_I, _P, _I, _I, _I, _I, _P, _P, _P]
        lib.ca3d_cell_state.restype = _I
        lib.ca3d_primary_sweep.argtypes = [_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.ca3d_primary_sweep.restype = _I
        lib.ca3d_primary_sweep_ages.argtypes = [
            _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P,
        ]
        lib.ca3d_primary_sweep_ages.restype = _I
        lib.ca3d_shadow_multi.argtypes = [
            _I, _P, _P, _I, ctypes.c_float, _I, _I, _I, _P, _P, _P, _P,
        ]
        lib.ca3d_shadow_multi.restype = _I
        lib.ca3d_prepass.argtypes = [_I, _P, _I, _I, _I, _P, _P, _P]
        lib.ca3d_prepass.restype = _I
        lib.ca3d_occupied_box.argtypes = [_I, _P, _I, _P, _P]
        lib.ca3d_occupied_box.restype = _I
        lib.ca3d_coarse_occupancy.argtypes = [_I, _P, _I, _P, _P, _P, _P, _P]
        lib.ca3d_coarse_occupancy.restype = _I
        lib.ca3d_coarse_occupancy_scratch_words.argtypes = []
        lib.ca3d_coarse_occupancy_scratch_words.restype = _I
        lib.ca3d_compose.argtypes = [
            _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.ca3d_compose.restype = _I
        lib.ca3d_lighting_queries.argtypes = [
            _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.ca3d_lighting_queries.restype = _I
        lib.ca3d_lighting_level.argtypes = [
            _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        ]
        lib.ca3d_lighting_level.restype = _I
        lib.ca3d_lighting_shade.argtypes = [
            _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
        ]
        lib.ca3d_lighting_shade.restype = _I
        for name, _ in _COUNTERS:
            getattr(lib, name).argtypes = [_I, ctypes.POINTER(ctypes.c_ulonglong)]
            getattr(lib, name).restype = _I
        _lib = lib
    return _lib


def loaded() -> bool:
    """Whether :func:`library` has loaded the kernels (no kernel ran before)."""
    return _lib is not None


# The work counters (utils.profiling.work_counts): the C function that
# copies each out, and the counter's name.
_COUNTERS = (("ca3d_shadow_sweep_lanes", "occlusion_lanes"),
             ("ca3d_lighting_shade_lanes", "occlusion_lanes_read"))


def work_counts(device: int) -> dict[str, int]:
    """The kernels' work counters on CUDA device ``device``, each copied
    from the device once (after the work queued before it)."""
    lib = library()
    out = {}
    for fn, name in _COUNTERS:
        v = ctypes.c_ulonglong()
        err = getattr(lib, fn)(device, ctypes.byref(v))
        if err != 0:
            msg = lib.ca3d_error_string(err).decode()
            raise RuntimeError(f"reading {name} failed: CUDA error {err} ({msg})")
        out[name] = v.value
    return out


def require(t, name: str, dtype, shape, align: int = 0) -> None:
    """Validate a kernel operand: a contiguous CUDA tensor of the given
    dtype and shape (and, with ``align``, an address that is a multiple of
    it).  The kernels take nothing else, and a CPU tensor is a caller error
    here, not a reason to fall back."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().ca3d_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
