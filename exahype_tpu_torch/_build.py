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
# K2 a, the CK predictor with the sponge: the same, then before the stream
# sigma (the sponge's rate of each cell).
_CK_PREDICTOR_VOLUME_SPONGE = _CK_PREDICTOR_VOLUME[:-1] + (_P, _P)
# faces, fhat, ops, dx, order, physics, params, g0, g1, g2, stream
_FACE_FLUX = (_P, _P, _P, _P, _INT, _INT, _P, _LL, _LL, _LL, _P)
# state, fhat, dt_ptr, dt_val, ops, dx, order, physics, params, g0, g1, g2,
# stream
_SURFACE_UPDATE = (
    _P, _P, _P, ctypes.c_double, _P, _P, _INT, _INT, _P, _LL, _LL, _LL, _P,
)
# The wall variant: the same, then before the stream wall_mask, wall_mode,
# wall_table, wall_rows, fwall, wall_off, wall_side (face flux) or
# wall_mask, fwall, wall_off (update); the face flux last the viscous-only
# wall planes of a viscous solver (null for the others).
_FACE_FLUX_WALLS = _FACE_FLUX[:-1] + (_INT, _INT, _P, _P, _P, _P, _LL, _P, _P)
# The viscous predictor: the Picard predictor's, then before the stream
# wall_mask, fv_planes, wall_off, wall_side (the viscous-only wall planes;
# mask 0 and null pointers without walls).
_PREDICTOR_VOLUME_VISC = _PREDICTOR_VOLUME[:-1] + (_INT, _P, _P, _LL, _P)
_SURFACE_UPDATE_WALLS = _SURFACE_UPDATE[:-1] + (_INT, _P, _P, _P)
# K1 e, the sharded face flux: the wall variant's arguments without fwall
# (wall_mask, wall_mode, wall_table, wall_rows, wall_off, wall_side), then
# modes, planes, fside, side_off and the stream.
_FACE_FLUX_EXCHANGED = _FACE_FLUX[:-1] + (_INT, _INT, _P, _P, _P, _LL, _P, _P, _P, _P, _P)
# The Z4 face stages (csrc/aderdg_z4*.cu): the periodic entries' arguments
# with the NCP half-fluctuations fhalf after fhat.
_FACE_FLUX_Z4 = _FACE_FLUX[:2] + (_P,) + _FACE_FLUX[2:]
_SURFACE_UPDATE_Z4 = _SURFACE_UPDATE[:2] + (_P,) + _SURFACE_UPDATE[2:]
# kernel, f64, physics, out (5 ints)
_KERNEL_INFO = (_INT, _INT, _INT, _P)
# s, s_out, ghost_lo, ghost_hi, g_lo, g_hi, dt_ptr, dt_val, h, gamma, dim,
# n_sub, n_vars, d, n_active, n_slots, L, stream
_ROW_SWEEP = (
    _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, ctypes.c_double,
    ctypes.c_double, _INT, _INT, _INT, _INT, _P, _LL, _LL, _P,
)
# The Z4+GRHD sweep (csrc/subcell_z4_matter*.cu): the same with the
# system's parameter array in place of gamma.
_ROW_SWEEP_Z4_MATTER = _ROW_SWEEP[:9] + (_P,) + _ROW_SWEEP[10:]
# f64, d, out (6 ints)
_SUBCELL_INFO = (_INT, _INT, _P)
# q, g0, g1, g2, out, n_lead, n_vars, n_grid, slicing, f, m, kappa1, kappa2,
# stream
_RHS_ALL = (
    _P, _P, _P, _P, _P, _LL, _INT, _LL, _INT, ctypes.c_double, ctypes.c_double,
    ctypes.c_double, ctypes.c_double, _P,
)
# K5 b, the 2-D instance: the same without g2.
_RHS_ALL_2D = _RHS_ALL[:3] + _RHS_ALL[4:]
# The shifted instance: the same, then before the stream shift, f_b, eta.
_RHS_ALL_SHIFT = _RHS_ALL[:-1] + (_INT, ctypes.c_double, ctypes.c_double, _P)
# K5 b's 2-D shifted instance: the shifted instance's arguments without g2.
_RHS_ALL_SHIFT_2D = _RHS_ALL_SHIFT[:3] + _RHS_ALL_SHIFT[4:]
# The Z4+GRHD instance: the same, then before the stream gamma, iters.
_RHS_ALL_MATTER = _RHS_ALL[:-1] + (ctypes.c_double, _INT, _P)
# K5 b's 2-D Z4+GRHD instance: the Z4+GRHD instance's arguments without g2.
_RHS_ALL_MATTER_2D = _RHS_ALL_MATTER[:3] + _RHS_ALL_MATTER[4:]
# The Z4+GRMHD instance: the same, then before the stream gamma, iters, c_h,
# glm_kappa.
_RHS_ALL_GRMHD = _RHS_ALL[:-1] + (ctypes.c_double, _INT, ctypes.c_double, ctypes.c_double, _P)
# K5 b's 2-D Z4+GRMHD instance: the Z4+GRMHD instance's arguments without g2.
_RHS_ALL_GRMHD_2D = _RHS_ALL_GRMHD[:3] + _RHS_ALL_GRMHD[4:]
_SIGNATURES = {
    f"exahype_{kernel}_{suffix}": argtypes
    for kernel, argtypes in (
        ("aderdg_predictor_volume", _PREDICTOR_VOLUME),
        ("aderdg_predictor_volume_visc", _PREDICTOR_VOLUME_VISC),
        ("aderdg_ck_predictor_volume", _CK_PREDICTOR_VOLUME),
        ("aderdg_ck_predictor_volume_sponge", _CK_PREDICTOR_VOLUME_SPONGE),
        ("aderdg_ck_predictor_volume_p2", _CK_PREDICTOR_VOLUME),
        ("aderdg_ck_predictor_volume_2d", _CK_PREDICTOR_VOLUME),
        ("aderdg_face_flux_p2", _FACE_FLUX),
        ("aderdg_surface_update_p2", _SURFACE_UPDATE),
        ("aderdg_face_flux", _FACE_FLUX),
        ("aderdg_surface_update", _SURFACE_UPDATE),
        ("aderdg_face_flux_walls", _FACE_FLUX_WALLS),
        ("aderdg_surface_update_walls", _SURFACE_UPDATE_WALLS),
        ("aderdg_face_flux_exchanged", _FACE_FLUX_EXCHANGED),
        ("aderdg_predictor_volume_z4", _PREDICTOR_VOLUME),
        ("aderdg_face_flux_z4", _FACE_FLUX_Z4),
        ("aderdg_surface_update_z4", _SURFACE_UPDATE_Z4),
        ("aderdg_predictor_volume_z4_shift", _PREDICTOR_VOLUME),
        ("aderdg_face_flux_z4_shift", _FACE_FLUX_Z4),
        ("aderdg_surface_update_z4_shift", _SURFACE_UPDATE_Z4),
        ("aderdg_predictor_volume_z4_matter", _PREDICTOR_VOLUME),
        ("aderdg_face_flux_z4_matter", _FACE_FLUX_Z4),
        ("aderdg_surface_update_z4_matter", _SURFACE_UPDATE_Z4),
        ("aderdg_predictor_volume_z4_grmhd", _PREDICTOR_VOLUME),
        ("aderdg_face_flux_z4_grmhd", _FACE_FLUX_Z4),
        ("aderdg_surface_update_z4_grmhd", _SURFACE_UPDATE_Z4),
        # The vacuum system's per-axis predictor (3-D) and its 2-D steps at
        # orders 2 and 3 (csrc/aderdg_z4_per_axis*.cu, aderdg_z4_2d*.cu).
        ("aderdg_predictor_volume_per_axis_z4", _PREDICTOR_VOLUME),
        *((f"aderdg_{kernel}{order}_2d_z4", argtypes) for order in ("", "_p3")
          for kernel, argtypes in (
              ("predictor_volume", _PREDICTOR_VOLUME),
              ("predictor_volume_per_axis", _PREDICTOR_VOLUME),
              ("face_flux", _FACE_FLUX_Z4), ("surface_update", _SURFACE_UPDATE_Z4))),
        # The Z4+GRHD system's per-axis predictor (3-D) and its 2-D step at
        # order 2 (csrc/aderdg_z4_matter_per_axis*.cu, aderdg_z4_matter_2d*.cu).
        ("aderdg_predictor_volume_per_axis_z4_matter", _PREDICTOR_VOLUME),
        *((f"aderdg_{kernel}_2d_z4_matter", argtypes) for kernel, argtypes in (
            ("predictor_volume", _PREDICTOR_VOLUME),
            ("predictor_volume_per_axis", _PREDICTOR_VOLUME),
            ("face_flux", _FACE_FLUX_Z4), ("surface_update", _SURFACE_UPDATE_Z4))),
        # The Z4+GRMHD and shifted systems', the same
        # (csrc/aderdg_z4_grmhd_per_axis*.cu, aderdg_z4_grmhd_2d*.cu,
        # aderdg_z4_shift_per_axis*.cu, aderdg_z4_shift_2d*.cu).
        *(entry for system in ("grmhd", "shift") for entry in (
            (f"aderdg_predictor_volume_per_axis_z4_{system}", _PREDICTOR_VOLUME),
            *((f"aderdg_{kernel}_2d_z4_{system}", argtypes) for kernel, argtypes in (
                ("predictor_volume", _PREDICTOR_VOLUME),
                ("predictor_volume_per_axis", _PREDICTOR_VOLUME),
                ("face_flux", _FACE_FLUX_Z4), ("surface_update", _SURFACE_UPDATE_Z4))))),
        *((f"aderdg_{kernel}_p{order}", argtypes) for order in (4, 5, 7)
          for kernel, argtypes in (
              ("predictor_volume", _PREDICTOR_VOLUME), ("face_flux", _FACE_FLUX),
              ("surface_update", _SURFACE_UPDATE), ("face_flux_walls", _FACE_FLUX_WALLS),
              ("surface_update_walls", _SURFACE_UPDATE_WALLS))),
        ("aderdg_predictor_volume_2d", _PREDICTOR_VOLUME),
        # The 2-D viscous predictors take the wall planes as the 3-D one does;
        # the 2-D Navier–Stokes step at order 2 has entries of its own
        # (csrc/aderdg_2d.cu).
        *((f"aderdg_{kernel}{order}_2d", argtypes) for order in ("", "_p2")
          for kernel, argtypes in (
              ("predictor_volume_visc", _PREDICTOR_VOLUME_VISC), ("face_flux", _FACE_FLUX),
              ("surface_update", _SURFACE_UPDATE), ("face_flux_walls", _FACE_FLUX_WALLS),
              ("surface_update_walls", _SURFACE_UPDATE_WALLS))),
        ("subcell_row_sweep", _ROW_SWEEP),
        ("subcell_row_sweep_z4_matter", _ROW_SWEEP_Z4_MATTER),
        ("rhs_all_z4", _RHS_ALL),
        ("rhs_all_z4_2d", _RHS_ALL_2D),
        ("rhs_all_z4_shift", _RHS_ALL_SHIFT),
        ("rhs_all_z4_shift_2d", _RHS_ALL_SHIFT_2D),
        ("rhs_all_z4_matter", _RHS_ALL_MATTER),
        ("rhs_all_z4_matter_2d", _RHS_ALL_MATTER_2D),
        ("rhs_all_z4_grmhd", _RHS_ALL_GRMHD),
        ("rhs_all_z4_grmhd_2d", _RHS_ALL_GRMHD_2D),
    )
    for suffix in ("f32", "f64")
}
_SIGNATURES["exahype_aderdg_kernel_info"] = _KERNEL_INFO
_SIGNATURES["exahype_subcell_kernel_info"] = _SUBCELL_INFO
_SIGNATURES["exahype_subcell_z4_matter_kernel_info"] = _SUBCELL_INFO


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
