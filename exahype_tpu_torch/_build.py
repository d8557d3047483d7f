"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain ``extern "C"`` interface: ``nvcc`` compiles each
into an object file, one process per source, all started together, and
links them into one shared library under ``build/exahype_tpu_torch/`` in the
checkout; :func:`library` loads it with ``ctypes``.  No PyTorch headers are
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
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "exahype_tpu_torch"

#: ``-O3`` without ``--use_fast_math``: division and sqrt stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
# u, out, faces, dt_ptr, dt_val, ops, dx, order, picard_iters, physics,
# params, g0, g1, g2, stream
_PREDICTOR_VOLUME = (
    _P, _P, _P, _P, ctypes.c_double, _P, _P, _INT, _INT, _INT, _P,
    _LL, _LL, _LL, _P,
)
# u, out, faces, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1,
# g2, stream
_CK_PREDICTOR_VOLUME = (
    _P, _P, _P, _P, ctypes.c_double, _P, _P, _INT, _INT, _P, _LL, _LL, _LL, _P,
)
# faces, fhat, ops, dx, order, physics, params, g0, g1, g2, stream
_FACE_FLUX = (_P, _P, _P, _P, _INT, _INT, _P, _LL, _LL, _LL, _P)
# state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1, g2,
# stream
_SURFACE_UPDATE = (
    _P, _P, _P, ctypes.c_double, _P, _P, _INT, _INT, _P, _LL, _LL, _LL, _P,
)
# kernel, f64, physics, out (5 ints)
_KERNEL_INFO = (_INT, _INT, _INT, _P)
# s, ghost_lo, ghost_hi, s_new, g_lo, g_hi, dt_ptr, dt_val, h, gamma, dim,
# n_sub, n_vars, d, n_kl, stream
_ROW_SWEEP = (
    _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, ctypes.c_double,
    ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    _LL, _P,
)
# q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1, kappa2,
# stream
_RHS_ALL = (
    _P, _P, _P, _P, _P, _LL, _INT, _LL, _INT, ctypes.c_double, ctypes.c_double,
    ctypes.c_double, ctypes.c_double, _P,
)
_SIGNATURES = {
    f"exahype_{kernel}_{suffix}": argtypes
    for kernel, argtypes in (
        ("aderdg_predictor_volume", _PREDICTOR_VOLUME),
        ("aderdg_ck_predictor_volume", _CK_PREDICTOR_VOLUME),
        ("aderdg_face_flux", _FACE_FLUX),
        ("aderdg_surface_update", _SURFACE_UPDATE),
        ("subcell_row_sweep", _ROW_SWEEP),
        ("rhs_all_z4", _RHS_ALL),
    )
    for suffix in ("f32", "f64")
}
_SIGNATURES["exahype_aderdg_kernel_info"] = _KERNEL_INFO


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


def _run(cmd: list[str]) -> tuple[str, float]:
    """Run one nvcc command; its output and seconds, or raise."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr, time.perf_counter() - t0


def _compile(sources: list[pathlib.Path], out: pathlib.Path) -> dict:
    """nvcc ``sources`` into the library ``out``: one object per source,
    compiled in parallel, then one link.

    Returns ``{"path", "seconds", "log", "sources"}``; ``log`` is nvcc's
    output, ``-Xptxas -v`` lines (registers, spills, shared memory)
    included, and ``sources`` maps each source's name to its compile
    seconds.  The library is written to a temporary name and renamed, so a
    concurrent build never loads a half-written file.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objects = [pathlib.Path(tmpdir) / f"{i}_{src.stem}.o" for i, src in enumerate(sources)]
        cmds = [
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)
        ]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            compiled = list(pool.map(_run, cmds))
        tmp = pathlib.Path(tmpdir) / out.name
        link_log, _ = _run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)])
        os.replace(tmp, out)
    log = "".join(text for text, _ in compiled) + link_log
    out.with_suffix(".log").write_text(log)
    return {
        "path": str(out),
        "seconds": time.perf_counter() - t0,
        "log": log,
        "sources": {src.name: sec for src, (_, sec) in zip(sources, compiled)},
    }


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
