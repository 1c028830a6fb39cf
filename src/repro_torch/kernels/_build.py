"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel is one source ``csrc/<name>.cu`` with a plain ``extern "C"``
launcher; device code shared between kernels lives in ``csrc/*.cuh``.  It
is compiled at first use, on the machine with the card, into a shared
library under ``<package>/_build/`` (listed in ``.gitignore``), keyed by a
hash of the source, the headers and the flags so an unchanged kernel is
not rebuilt.  :func:`build_all` starts one nvcc per source at once, so
the kernels build in parallel.  The flags pin the numerics: ``--fmad=false``
(no contraction of ``a*b+c`` into an FMA) and ``-prec-div=true``;
``--use_fast_math`` is never passed.  ``-Xptxas=-v`` makes the compiler
report each kernel's registers, shared memory and spills.  Nothing here
runs at import time: the CPU tests import every module of the port on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

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
    """Where the built library of kernel ``name`` lives, keyed by the
    contents of its source, of every header in ``csrc/`` (a source may
    include any of them) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a temporary library file, its
    output going to an anonymous temporary file (never a pipe that could
    fill while the caller waits on another build)."""
    cmd = [find_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = tempfile.TemporaryFile(mode="w+")
    try:
        proc = subprocess.Popen(cmd + ["-o", tmp, str(CSRC / f"{name}.cu")],
                                stdout=log, stderr=subprocess.STDOUT)
    except OSError as e:
        log.close()
        os.unlink(tmp)
        raise KernelBuildError(f"could not start nvcc for {name}.cu: {e}") from e
    return proc, tmp, log


def kernel_names() -> list[str]:
    """Every kernel of the port: the stems of ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names=None) -> dict[str, tuple[Path, float, str]]:
    """Compile every kernel in ``names`` (default: :func:`kernel_names`)
    whose library is not built yet, one nvcc per source, all started before
    any is waited on.  Returns
    ``{name: (library path, seconds, compiler output)}``; a library that was
    built already takes 0.0 s and has no output.  Raises
    :class:`KernelBuildError` with the compiler's output if any build fails,
    and leaves no partial library behind."""
    out: dict[str, tuple[Path, float, str]] = {}
    running = {}
    errors = []
    t0 = time.perf_counter()
    try:
        for name in kernel_names() if names is None else names:
            lib = library_path(name)
            if lib.exists():
                out[name] = (lib, 0.0, "")
            else:
                running[name] = _nvcc(name)
        for name in list(running):
            proc, tmp, log = running[name]
            proc.wait()
            del running[name]
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed for {name}.cu "
                              f"(rc {proc.returncode}):\n{text}")
                continue
            lib = library_path(name)
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all
            out[name] = (lib, time.perf_counter() - t0, text)  # or nothing
    finally:   # interrupted while others build: stop them, leave nothing
        for proc, tmp, log in running.values():
            proc.kill()
            proc.wait()
            log.close()
            os.unlink(tmp)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return out


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is built already and
    return the library's path (see :func:`build_all`)."""
    return build_all([name])[name][0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
