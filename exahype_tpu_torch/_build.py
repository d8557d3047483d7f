"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain ``extern "C"`` interface: ``nvcc`` compiles them
into one shared library under ``build/exahype_tpu_torch/`` in the checkout,
and :func:`library` loads it with ``ctypes``.  No PyTorch headers are
involved, so a build takes seconds.  The library's name carries a hash of
the sources and flags, so an edited source is rebuilt at first use.

A *generated* source (the spec kernels of ``backends/cuda_backend.py``) is
written under the same directory and compiled, with the same flags and
``csrc/`` on the include path, into a library of its own, named by the hash
of the source, the headers and the flags (:func:`compile_generated`,
:func:`generated_library`).

Nothing here runs at import: the CPU tests import every module, and a
CPU-only install has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "exahype_tpu_torch"

#: ``-O3`` without ``--use_fast_math``: division and sqrt stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, gamma,
# g0, g1, g2, stream
_PREDICTOR_VOLUME = (
    _P, _P, _P, _P, ctypes.c_double, _P, _P, ctypes.c_int, ctypes.c_int,
    ctypes.c_double, _LL, _LL, _LL, _P,
)
# state, faces, dt_ptr, dt_val, ops, dx, order, gamma, g0, g1, g2, stream
_FACE_SURFACE = (
    _P, _P, _P, ctypes.c_double, _P, _P, ctypes.c_int, ctypes.c_double,
    _LL, _LL, _LL, _P,
)
_SIGNATURES = {
    f"exahype_aderdg_{kernel}_{suffix}": argtypes
    for kernel, argtypes in (
        ("predictor_volume", _PREDICTOR_VOLUME),
        ("face_surface", _FACE_SURFACE),
    )
    for suffix in ("f32", "f64")
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(*texts: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for text in texts:
        h.update(text.encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libexahype_tpu_torch_{_digest()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _compile(sources: list[pathlib.Path], out: pathlib.Path) -> dict:
    """nvcc ``sources`` into the library ``out``.

    Returns ``{"path", "seconds", "log"}``; ``log`` is nvcc's output,
    ``-Xptxas -v`` lines (registers, spills, shared memory) included.  The
    library is written to a temporary name and renamed, so a concurrent
    build never loads a half-written file.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return {"path": str(out), "seconds": seconds, "log": log}


def compile_library() -> dict:
    """Compile ``csrc/*.cu`` now, whether or not a library is cached (see
    :func:`_compile` for what it returns)."""
    return _compile(_sources(), library_path())


def generated_path(stem: str, source: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{stem}_{_digest(source)}.so"


def compile_generated(stem: str, source: str) -> dict:
    """Write a generated source beside its library and compile it now (see
    :func:`_compile` for what it returns)."""
    out = generated_path(stem, source)
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    fd, tmp = tempfile.mkstemp(suffix=".cu", dir=out.parent)
    with os.fdopen(fd, "w") as f:
        f.write(source)
    os.replace(tmp, src)
    return _compile([src], out)


@functools.lru_cache(maxsize=None)
def generated_library(stem: str, source: str, signatures: tuple) -> ctypes.CDLL:
    """The loaded library of a generated source (built at first use if not
    cached); ``signatures`` is ``((symbol, argtypes), ...)``, each symbol
    returning a CUDA error code."""
    path = generated_path(stem, source)
    if not path.exists():
        compile_generated(stem, source)
    return _load(path, signatures)


def _load(path: pathlib.Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.exahype_cuda_error_string.argtypes = [ctypes.c_int]
    lib.exahype_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use if not cached)."""
    path = library_path()
    if not path.exists():
        compile_library()
    return _load(path, _SIGNATURES.items())


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.exahype_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
