"""K4 on Hopper: one CUDA kernel generated from a spec's statement list.

Port of ``exahype_tpu/backends/pallas_backend.py::PallasPrinter``, which
fuses a :class:`KernelBuilder` statement list into one ``pallas_call``.
:class:`CudaPrinter` prints CUDA C++ (``sm_90a``) that computes the same
function; the plain PyTorch version is
:class:`~exahype_tpu_torch.backends.torch_backend.TorchPrinter`, whose
semantics (regions, var cut, operation order, refusals) it shares.

Design (the note at the head of the generated source says the same):

- one block owns a tile of ``P_t`` patches; every item of those patches
  (the state and each temp) lives in dynamic shared memory as
  ``[item][cell][var][patch-in-tile]``, patch fastest, so that the loads
  and stores of the patch-contiguous SoA-P state are whole sectors;
  ``P_t`` is the largest power of two whose items fit the 227 KB a block
  may use (:meth:`CudaPrinter.tile_patches`);
- each statement is a loop of the block's threads over its region × vars ×
  patches, with ``__syncthreads()`` between statements, so read-after-write
  order is kept exactly; a typed call runs its ``cuda_source`` once per
  cell on the cell's variable vector;
- expressions are printed in the plain evaluator's order (ordered terms
  and factors, folded from the left), literals cast to the kernel's type;
- the state is read once and written once, in place: halos are padding and
  patches are independent within a step.

The kernel is built at first use (``_build.generated_library``), never at
import.  The wrapper :class:`CudaSpecKernel` launches it for a CUDA tensor
and takes the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import math
import re

import sympy
import torch
from sympy.core.function import AppliedUndef

from exahype_tpu_torch import _build
from exahype_tpu_torch.backends.base import CodePrinter
from exahype_tpu_torch.backends.torch_backend import (
    TorchPrinter,
    access_offsets,
    bare_call_parts,
    check_assignment,
    check_spec,
    item_vars,
    statement_region,
)
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.frontend.statements import StatementKind
from exahype_tpu_torch.utils.errors import LoweringError

#: Shared memory one block may use on the H100 (sm_90): 227 KB.
SMEM_PER_BLOCK = 232_448
#: Threads per block: 16 warps, so one block's loads keep the SM busy.
THREADS = 512
#: Largest tile: a warp's width of patches.
MAX_TILE = 32
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# state, n_patches, scalar pointers, scalar values, stream
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)
_SCALAR, _FIELD, _VFIELD = "scalar", "field", "vfield"
_AXES = ("c0", "c1", "c2")


class CudaPrinter(CodePrinter):
    """Print a kernel spec as one CUDA kernel; ``code`` holds the source.

    ``build()`` returns a :class:`CudaSpecKernel`, ``fn(Q, *scalars) -> Q``
    over the SoA-P state ``[*extent, n_vars, *patch_tail]``.  A spec the
    kernel cannot compute raises :class:`LoweringError` here.
    """

    def __init__(self, kernel: KernelBuilder, function_name: str = "time_step"):
        super().__init__(kernel, function_name=function_name)
        check_spec(kernel)
        self.tiles = {dtype: self.tile_patches(dtype) for dtype in _SUFFIX}
        self.symbol = f"exahype_spec_{function_name}"
        self.code = _Generator(kernel, self.tiles, self.symbol).source()

    # ----------------------------------------------------------- tile sizing

    def bytes_per_patch(self, dtype: torch.dtype) -> int:
        """Shared memory one patch needs: the state and every temp item."""
        kb = self._kernel
        cells = kb.config.extent ** kb.config.dim
        names = [kb.inputs[0], *kb.temp_items()]
        itemsize = torch.empty((), dtype=dtype).element_size()
        return cells * sum(item_vars(kb, n) for n in names) * itemsize

    def tile_patches(self, dtype: torch.dtype) -> int:
        """Patches per block: the largest power of two (at most
        :data:`MAX_TILE`) whose items fit :data:`SMEM_PER_BLOCK`."""
        per_patch = self.bytes_per_patch(dtype)
        if per_patch > SMEM_PER_BLOCK:
            raise LoweringError(
                f"one patch needs {per_patch} bytes of shared memory in "
                f"{dtype}, more than the {SMEM_PER_BLOCK} a block may use"
            )
        fit = SMEM_PER_BLOCK // per_patch
        return min(MAX_TILE, 1 << (fit.bit_length() - 1))

    # ----------------------------------------------------------------- build

    def compile(self) -> dict:
        """Compile the source now (``{"path", "seconds", "log", "sources"}``)."""
        return _build.compile_generated(self.symbol, self.code)

    def library(self) -> ctypes.CDLL:
        signatures = tuple(
            (f"{self.symbol}_{suffix}", _ARGTYPES) for suffix in _SUFFIX.values()
        )
        return _build.generated_library(self.symbol, self.code, signatures)

    def build(self) -> "CudaSpecKernel":
        return CudaSpecKernel(self)


class CudaSpecKernel:
    """The spec kernel's wrapper: ``fn(Q, *scalars) -> Q``, in place.

    A CUDA tensor launches the generated kernel (or raises); a CPU tensor
    takes the plain version (:attr:`plain`).  Updating ``Q`` in place is
    safe because halos are padding and patches are independent within a
    step: every block reads and writes only its own patches.  A scalar goes
    by value as a Python float and by device pointer as a tensor (no
    ``.item()``).  :attr:`launches` counts the kernel's launches.
    """

    def __init__(self, printer: CudaPrinter):
        self.printer = printer
        self.plain = TorchPrinter(printer.kernel(), printer.functionName()).build()
        self.launches = 0

    def __call__(self, Q, *scalars):
        if not Q.is_cuda:
            return self.plain(Q, *scalars)
        kb = self.printer.kernel()
        cfg = kb.config
        n_scalars = len(kb.inputs) - 1
        if len(scalars) != n_scalars:
            raise TypeError(
                f"{self.printer.functionName()} expects {n_scalars} scalar "
                f"argument(s) {kb.inputs[1:]}"
            )
        if Q.dtype not in _SUFFIX:
            raise LoweringError(f"dtype {Q.dtype} is not float32/float64")
        lead = (cfg.extent,) * cfg.dim + (cfg.n_vars,)
        if tuple(Q.shape[: cfg.dim + 1]) != lead or Q.dim() <= cfg.dim + 1:
            raise LoweringError(
                f"state shape {tuple(Q.shape)} is not [*{lead}, *patch_tail]"
            )
        if not Q.is_contiguous():
            raise LoweringError("the state must be contiguous")
        n_patches = math.prod(Q.shape[cfg.dim + 1:])
        held, ptrs, vals = [], [], []
        for s in scalars:
            if isinstance(s, torch.Tensor):
                if s.numel() != 1:
                    raise LoweringError("a kernel scalar must have one element")
                s = s.to(device=Q.device, dtype=Q.dtype).reshape(())
                held.append(s)  # alive until the launch is enqueued
                ptrs.append(s.data_ptr())
                vals.append(0.0)
            else:
                ptrs.append(0)
                vals.append(float(s))
        n = max(1, n_scalars)
        c_ptrs = (ctypes.c_uint64 * n)(*ptrs)
        c_vals = (ctypes.c_double * n)(*vals)
        lib = self.printer.library()
        name = f"{self.printer.symbol}_{_SUFFIX[Q.dtype]}"
        with torch.cuda.device(Q.device):
            stream = torch.cuda.current_stream(Q.device).cuda_stream
            err = getattr(lib, name)(
                Q.data_ptr(), n_patches, ctypes.addressof(c_ptrs),
                ctypes.addressof(c_vals), stream,
            )
        _build.check(lib, err, name)
        self.launches += 1
        return Q


# ---------------------------------------------------------------- printing


def _literal(value) -> str:
    value = float(value)
    if not math.isfinite(value):
        raise LoweringError(f"non-finite literal {value}")
    return f"T({value!r})"


class _Generator:
    """Prints one spec as a CUDA translation unit."""

    def __init__(self, kb: KernelBuilder, tiles: dict, symbol: str):
        self.kb = kb
        self.cfg = kb.config
        self.tiles = tiles
        self.symbol = symbol
        self.cells = self.cfg.extent ** self.cfg.dim
        # Shared-memory layout: the state first, then the temps.
        self.items = [kb.inputs[0], *kb.temp_items()]
        self.offset = {}
        at = 0
        for name in self.items:
            self.offset[name] = at
            at += self.cells * item_vars(kb, name)
        self.values_per_patch = at
        self.scalars = {name: f"s_{name}" for name in kb.inputs[1:]}
        self._tmp = 0

    # ------------------------------------------------------------ top level

    def source(self) -> str:
        kb, cfg = self.kb, self.cfg
        body = []
        env = {name: code for name, code in self.scalars.items()}
        env.update({k: _literal(v) for k, v in kb.literal_values.items()})
        used = []
        for k, stmt in enumerate(kb.statements):
            if stmt.kind is StatementKind.CONST_ASSIGN:
                env[str(stmt.lhs)] = _literal(stmt.rhs)
                continue
            body.append(self._statement(k, stmt, env))
            for call in stmt.lhs.atoms(AppliedUndef) | (
                stmt.rhs.atoms(AppliedUndef) if stmt.rhs is not None else set()
            ):
                typed = kb.functions[type(call).__name__]
                if typed not in used:
                    used.append(typed)
        functions = []
        for typed in sorted(used, key=lambda t: t.name):
            if typed.cuda_source is None:
                raise LoweringError(
                    f"function {typed.name!r} has no cuda_source; supply one "
                    "via kernel.function(..., cuda_source=...)"
                )
            if f"spec_{typed.name}" not in typed.cuda_source:
                raise LoweringError(
                    f"the cuda_source of {typed.name!r} must define "
                    f"spec_{typed.name}"
                )
            functions.append(typed.cuda_source.rstrip() + "\n")
        n_scalars = max(1, len(self.scalars))
        read_scalars = "".join(
            f"  const T {code} = sc.ptr[{i}] != nullptr ? *sc.ptr[{i}] : sc.val[{i}];\n"
            for i, code in enumerate(self.scalars.values())
        )
        pointers = "".join(
            f"  T* const it_{name} = sm + {self.offset[name]} * PT;"
            f"  // [{self.cells}][{item_vars(kb, name)}][PT]\n"
            for name in self.items
        )
        state_values = self.cells * cfg.n_vars
        temp_values = self.values_per_patch - state_values
        zero = (
            f"  for (int e = threadIdx.x; e < {temp_values} * PT; e += kThreads) "
            f"sm[{state_values} * PT + e] = T(0);\n"
            if temp_values else ""
        )
        return _TEMPLATE.format(
            note=_note(kb, self.tiles, self.values_per_patch),
            functions="\n".join(functions),
            threads=THREADS,
            n_scalars=n_scalars,
            pointers=pointers,
            read_scalars=read_scalars,
            state_values=state_values,
            zero=zero,
            statements="\n".join(body),
            values_per_patch=self.values_per_patch,
            symbol=self.symbol,
            tile_f32=self.tiles[torch.float32],
            tile_f64=self.tiles[torch.float64],
        )

    # ------------------------------------------------------------ statements

    def _statement(self, k, stmt, env) -> str:
        kb, cfg = self.kb, self.cfg
        spatial, vb = statement_region(kb, stmt)
        pre: list[str] = []
        if isinstance(stmt.lhs, AppliedUndef):
            typed, out_arg, in_args = bare_call_parts(kb, stmt)
            out_name, out_axes, _ = access_offsets(kb, out_arg, spatial)
            for a in in_args:
                if (
                    isinstance(a, sympy.Indexed)
                    and str(a.base.label) == out_name
                    and any(off for *_, off in access_offsets(kb, a, spatial)[1])
                ):
                    raise LoweringError(
                        f"call {stmt.lhs} writes {out_name!r} and reads it at a "
                        "shifted index: one kernel pass cannot keep its order"
                    )
            n_out = item_vars(kb, out_name)
            args = [self._call_arg(a, spatial, env, pre) for a in in_args]
            args.insert(typed.out_param, "o")
            pre.append(f"T o[{n_out}];")
            pre.append(f"spec_{typed.name}<T>({', '.join(args)});")
            pre.append("#pragma unroll")
            pre.append(
                f"for (int w = 0; w < {n_out}; ++w) "
                f"{self._index(out_name, out_axes, 'w')} = o[w];"
            )
            lanes = 1
        else:
            check_assignment(kb, stmt, vb)
            lhs_name, lhs_axes, lhs_vars = access_offsets(kb, stmt.lhs, spatial)
            lanes = 1 if lhs_vars is None else min(vb, lhs_vars)
            _, value = self._expr(stmt.rhs, spatial, vb, lanes, env, pre)
            var = "v" if lhs_vars is not None else None
            pre.append(f"{self._index(lhs_name, lhs_axes, var)} = {value};")
        return self._loop(k, stmt, spatial, lanes, pre)

    def _loop(self, k, stmt, spatial, lanes, lines) -> str:
        dim = self.cfg.dim
        sizes = [hi - lo for lo, hi in spatial]
        region = " ".join(
            f"{_AXES[d]} in [{lo},{hi})" for d, (lo, hi) in enumerate(spatial)
        )
        text = str(stmt.lhs) if stmt.rhs is None else f"{stmt.lhs} = {stmt.rhs}"
        out = [
            f"  // [{k}] {text}",
            f"  //     {region}, var in [0,{lanes})",
            f"  for (int e = threadIdx.x; e < {math.prod(sizes) * lanes} * PT; "
            "e += kThreads) {",
            "    const int p = e % PT;",
            "    int r = e / PT;",
        ]
        if lanes > 1:
            out.append(f"    const int v = r % {lanes};")
            out.append(f"    r /= {lanes};")
        elif any(re.search(r"\bv\b", line) for line in lines):
            out.append("    const int v = 0;")
        for d in reversed(range(dim)):
            lo, n = spatial[d][0], sizes[d]
            if d == 0:
                out.append(f"    const int {_AXES[d]} = {lo} + r;")
            else:
                out.append(f"    const int {_AXES[d]} = {lo} + r % {n};")
                out.append(f"    r /= {n};")
        out.append("    if (p >= np) continue;")
        out.extend(f"    {line}" for line in lines)
        out.append("  }")
        out.append("  __syncthreads();")
        return "\n".join(out)

    def _index(self, name, axes, var) -> str:
        """``it_name[...]`` of one access; ``var`` is None for a field."""
        e = self.cfg.extent
        cell = None
        for d, (_, _, off) in enumerate(axes):
            c = _AXES[d] if off == 0 else f"({_AXES[d]} {'+' if off > 0 else '-'} {abs(off)})"
            cell = c if cell is None else f"({cell} * {e} + {c})"
        if var is None:
            return f"it_{name}[{cell} * PT + p]"
        nv = item_vars(self.kb, name)
        return f"it_{name}[({cell} * {nv} + {var}) * PT + p]"

    # ------------------------------------------------------------ expression

    def _expr(self, expr, spatial, vb, lanes, env, pre):
        """``(kind, code)`` of an expression, in the plain evaluator's order."""
        if expr is None:
            raise LoweringError("missing RHS")
        if expr.is_Number:
            return _SCALAR, _literal(expr)
        if isinstance(expr, sympy.Symbol):
            name = str(expr)
            if name not in env:
                raise LoweringError(f"unbound symbol {name!r}")
            return _SCALAR, env[name]
        if isinstance(expr, sympy.Indexed):
            return self._read(expr, spatial, vb, lanes)
        if isinstance(expr, AppliedUndef):
            typed = self.kb.functions.get(type(expr).__name__)
            if typed is None:
                raise LoweringError(f"unknown function {type(expr).__name__}")
            if typed.out_param is not None:
                raise LoweringError(f"{typed.name} writes through an argument; "
                                    "call it as a statement of its own")
            args = [self._call_arg(a, spatial, env, pre) for a in expr.args]
            return _FIELD, f"spec_{typed.name}<T>({', '.join(args)})"
        if isinstance(expr, sympy.Add):
            vals = [self._expr(a, spatial, vb, lanes, env, pre)
                    for a in expr.as_ordered_terms()]
            return _fold(vals, "({} + {})")
        if isinstance(expr, sympy.Mul):
            vals = [self._expr(a, spatial, vb, lanes, env, pre)
                    for a in expr.as_ordered_factors()]
            return _fold(vals, "({} * {})")
        if isinstance(expr, sympy.Pow):
            bk, bv = self._expr(expr.base, spatial, vb, lanes, env, pre)
            if expr.exp == sympy.Integer(-1):
                return bk, f"(T(1) / {bv})"
            if expr.exp == sympy.Integer(2):
                return bk, f"({bv} * {bv})"
            if expr.exp == sympy.Rational(1, 2):
                return bk, f"dsqrt({bv})"
            ek, ev = self._expr(expr.exp, spatial, vb, lanes, env, pre)
            if ek != _SCALAR:
                raise LoweringError("array-valued exponents unsupported")
            return bk, f"dpow({bv}, {ev})"
        if isinstance(expr, (sympy.Max, sympy.Min)):
            fn = "dmax" if isinstance(expr, sympy.Max) else "dmin"
            vals = [self._expr(a, spatial, vb, lanes, env, pre) for a in expr.args]
            return _fold(vals, fn + "({}, {})")
        if isinstance(expr, sympy.Abs):
            k, v = self._expr(expr.args[0], spatial, vb, lanes, env, pre)
            return k, f"dabs({v})"
        raise LoweringError(f"cannot lower {type(expr).__name__}: {expr}")

    def _read(self, access, spatial, vb, lanes):
        name, axes, nvars = access_offsets(self.kb, access, spatial)
        if nvars is None:
            return _FIELD, self._index(name, axes, None)
        take = nvars if vb is None else min(vb, nvars)
        if take == lanes:
            var = "v"
        elif take == 1 or lanes == 1:
            # One variable broadcasts over the var loop; a target without
            # variables takes variable 0 of the value.
            var = "0"
        else:
            raise LoweringError(
                f"{access} reads {take} variables where the statement "
                f"writes {lanes}"
            )
        return _VFIELD, self._index(name, axes, var)

    def _call_arg(self, a, spatial, env, pre) -> str:
        """One argument of a typed call: a struct item is gathered into a
        local vector (passed as ``const T*``), a field read or a scalar is
        passed as ``T``."""
        if isinstance(a, sympy.Indexed):
            name, axes, nvars = access_offsets(self.kb, a, spatial)
            if nvars is None:
                return self._index(name, axes, None)
            arg = f"a{self._tmp}"
            self._tmp += 1
            pre.append(f"T {arg}[{nvars}];")
            pre.append("#pragma unroll")
            pre.append(
                f"for (int w = 0; w < {nvars}; ++w) "
                f"{arg}[w] = {self._index(name, axes, 'w')};"
            )
            return arg
        kind, code = self._expr(a, spatial, 1, 1, env, pre)
        if kind != _SCALAR:
            raise LoweringError(f"argument {a} must be scalar")
        return code


def _fold(vals, pattern):
    kinds = {k for k, _ in vals}
    kind = _VFIELD if _VFIELD in kinds else (_FIELD if _FIELD in kinds else _SCALAR)
    out = vals[0][1]
    for _, v in vals[1:]:
        out = pattern.format(out, v)
    return kind, out


def _note(kb, tiles, values_per_patch) -> str:
    cfg = kb.config
    state = cfg.extent**cfg.dim * cfg.n_vars
    return (
        f"// Spec: dim={cfg.dim}, patch_size={cfg.patch_size}, "
        f"halo_size={cfg.halo_size}, n_real={cfg.n_real}, n_aux={cfg.n_aux}; "
        f"{len(kb.statements)} statements.\n"
        f"// State per patch: {state} values, read once and written once.\n"
        f"// Shared memory per patch: {values_per_patch} values "
        f"({values_per_patch * 4} B in float32, {values_per_patch * 8} B in "
        f"float64); tiles of\n// {tiles[torch.float32]} (float32) and "
        f"{tiles[torch.float64]} (float64) patches per block."
    )


_TEMPLATE = """\
// Generated by exahype_tpu_torch/backends/cuda_backend.py::CudaPrinter.
//
// Replaces the TPU kernel exahype_tpu/backends/pallas_backend.py::
// PallasPrinter.build (its pallas_call): the whole KernelBuilder statement
// list fused into one kernel over the SoA-P state [*extent, n_vars, patches].
// The plain version is exahype_tpu_torch/backends/torch_backend.py.
//
// What bounds it on the H100: bytes.  A statement does a few dozen flops per
// cell against the state, so the least work is reading the cells its
// stencils reach (for a face stencil, the interior and the face halos) and
// writing the interior.  This design reads and writes the whole padded
// state once and keeps everything else on chip: a block owns a
// tile of PT patches and holds the state and every temp of those patches in
// shared memory as [item][cell][var][patch], patch fastest, so the state's
// loads and stores (patch-contiguous in device memory) are whole sectors and
// no temp touches device memory.  Each statement is one loop of the block's
// threads over its region x vars x patches, with __syncthreads() between
// statements, which keeps the statement list's read-after-write order; a
// typed call runs once per cell on the cell's variable vector.  The state is
// updated in place (halos are padding; patches are independent within a
// step).  Not yet done: overlapping one tile's loads with another's work
// (one block per SM at this shared-memory size), keeping the directional
// temps in registers, writing back only the interior.
{note}

#include <cuda_runtime.h>

#include "device_math.cuh"

{functions}
namespace {{

constexpr int kThreads = {threads};
constexpr int kScalars = {n_scalars};
constexpr int kValuesPerPatch = {values_per_patch};

template <typename T>
struct Scalars {{
  const T* ptr[kScalars];  // a device scalar, or null: use val
  T val[kScalars];
}};

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
spec_kernel(T* __restrict__ state, long long n_patches, const Scalars<T> sc) {{
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
{pointers}  const long long p0 = static_cast<long long>(blockIdx.x) * PT;
  const int np = static_cast<int>(n_patches - p0 < PT ? n_patches - p0 : PT);
{read_scalars}
  // Load the tile's state; zero every temp.
  for (int e = threadIdx.x; e < {state_values} * PT; e += kThreads) {{
    const int p = e % PT;
    if (p < np) sm[e] = state[static_cast<long long>(e / PT) * n_patches + p0 + p];
  }}
{zero}  __syncthreads();

{statements}

  // Store the tile's state.
  for (int e = threadIdx.x; e < {state_values} * PT; e += kThreads) {{
    const int p = e % PT;
    if (p < np) state[static_cast<long long>(e / PT) * n_patches + p0 + p] = sm[e];
  }}
}}

template <typename T, int PT>
cudaError_t launch(T* state, long long n_patches, const unsigned long long* ptrs,
                   const double* vals, void* stream) {{
  if (n_patches <= 0) return cudaErrorInvalidValue;
  Scalars<T> sc;
  for (int i = 0; i < kScalars; ++i) {{
    sc.ptr[i] = reinterpret_cast<const T*>(ptrs[i]);
    sc.val[i] = static_cast<T>(vals[i]);
  }}
  const size_t smem = static_cast<size_t>(kValuesPerPatch) * PT * sizeof(T);
  // The opt-in above 48 KB of shared memory, once per instantiation (the
  // port launches on one card).
  static const cudaError_t attr = cudaFuncSetAttribute(
      spec_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = (n_patches + PT - 1) / PT;
  spec_kernel<T, PT><<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(state, n_patches, sc);
  return cudaGetLastError();
}}

}}  // namespace

extern "C" {{

// Each entry enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess).  ptrs/vals: one device pointer (or 0) and
// one value per scalar input, in the spec's order.
int {symbol}_f32(float* state, long long n_patches,
                 const unsigned long long* ptrs, const double* vals, void* stream) {{
  return launch<float, {tile_f32}>(state, n_patches, ptrs, vals, stream);
}}

int {symbol}_f64(double* state, long long n_patches,
                 const unsigned long long* ptrs, const double* vals, void* stream) {{
  return launch<double, {tile_f64}>(state, n_patches, ptrs, vals, stream);
}}

const char* exahype_cuda_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}

}}  // extern "C"
"""
