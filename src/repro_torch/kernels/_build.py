"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel is one source ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher.  It is compiled at first use, on the machine with the card, into
a shared library under ``<package>/_build/`` (listed in ``.gitignore``),
keyed by a hash of the source and the flags so an unchanged kernel is not
rebuilt.  The flags pin the numerics: ``--fmad=false`` (no contraction of
``a*b+c`` into an FMA) and ``-prec-div=true``; ``--use_fast_math`` is never
passed.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda)")


def library_path(name: str) -> Path:
    """Where the built library of kernel ``name`` lives (content-keyed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is built already and
    return the library's path.  Raises :class:`KernelBuildError` with the
    compiler's output on failure and leaves no partial library behind."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed for {name}.cu "
                               f"(rc {out.returncode}):\n{out.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
