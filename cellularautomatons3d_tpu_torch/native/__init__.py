"""The host-side frame codec: ``native/framesink.c`` built at first use.

The same C source the JAX package's ``setup.py`` builds (PNG encoding
with zlib, and the checkpoint bit codecs), compiled by the host C compiler
with ``-lz`` the first time something asks for it, into
``build/cellularautomatons3d_tpu_torch/`` beside the package, named by a
hash of the source, the flags and the interpreter's extension suffix, and
imported as the extension module ``framesink``.  It runs on the host: it
is a codec, not a device kernel.

``HAVE_NATIVE`` says whether the extension loaded; when it did not,
``BUILD_ERROR`` says why and ``utils.image`` encodes with its pure-Python
writer, as the reference does without its extension.  Reading either name,
or ``framesink``, builds on first access; importing this module runs
nothing.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "load", "framesink", "HAVE_NATIVE", "BUILD_ERROR"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "framesink.c"
BUILD_DIR = _ROOT / "build" / "cellularautomatons3d_tpu_torch"
CFLAGS = ("-O2", "-shared", "-fPIC")

_loaded: tuple | None = None  # (module or None, error or None), once per process


def _compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler: set CC or put cc on PATH")
    return cc


def _build() -> Path:
    """Compile the extension unless this source is built already; return
    its path."""
    if not SOURCE.is_file():
        raise RuntimeError(f"{SOURCE} not found (the codec builds from a checkout)")
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(" ".join(CFLAGS).encode() + suffix.encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"framesink_{h.hexdigest()[:16]}{suffix}"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CFLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{' '.join(cmd)} failed (exit code {proc.returncode}): {proc.stderr[-2000:]}"
        )
    os.replace(tmp, out)  # atomic: concurrent builds agree on one file
    return out


def _import(path: Path):
    spec = importlib.util.spec_from_file_location("framesink", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load():
    """(the ``framesink`` module or None, the reason it is None or None),
    building and importing it on the first call."""
    global _loaded
    if _loaded is None:
        try:
            _loaded = (_import(_build()), None)
        except (OSError, RuntimeError, ImportError, subprocess.SubprocessError) as e:
            _loaded = (None, f"{type(e).__name__}: {e}")
    return _loaded


def __getattr__(name):
    if name == "framesink":
        return load()[0]
    if name == "HAVE_NATIVE":
        return load()[0] is not None
    if name == "BUILD_ERROR":
        return load()[1]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
