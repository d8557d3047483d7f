"""K4 on Hopper: one CUDA kernel generated from a spec's statement list.

Port of ``exahype_tpu/backends/pallas_backend.py::PallasPrinter``, which
fuses a :class:`KernelBuilder` statement list into one ``pallas_call``.
:class:`CudaPrinter` prints CUDA C++ (``sm_90a``) that computes the same
function; the plain PyTorch version is
:class:`~exahype_tpu_torch.backends.torch_backend.TorchPrinter`, whose
semantics (regions, var cut, operation order, refusals) it shares.

Design (the note at the head of the generated source says the same):

- at print time, :mod:`.spec_plan` finds what the output needs: each
  statement runs only on the elements whose value a later statement or the
  final state reads, the kernel loads only the state values some statement
  reads before they are overwritten (:attr:`CudaPrinter.read_cells`) and
  stores only those some statement writes (:attr:`CudaPrinter.write_cells`);
- one block owns a tile of ``PT`` patches, 32 bytes of patches a row (8 in
  float32, 4 in float64) where they fit, else the largest power of two that
  does (:meth:`CudaPrinter.tile_patches`); every item lives
  in dynamic shared memory over the bounding box of the cells it touches, as
  ``[cell][var][patch-in-tile]``, patch fastest, so that the loads and stores
  of the patch-contiguous SoA-P state are whole sectors;
- statements run as loops of the block's threads over their demanded
  elements x patches; statements with no value crossing threads between
  them share a barrier phase, and statements over the same elements whose
  values stay in their thread share a loop; a typed call runs its
  ``cuda_source`` once per cell on the cell's variable vector;
- expressions are printed in the plain evaluator's order (ordered terms
  and factors, folded from the left), literals cast to the kernel's type,
  so every value the kernel computes is bitwise the plain evaluation's up to
  the card's contraction of multiply-adds;
- the state is updated in place: patches are independent within a step,
  and a value the statement list does not write is neither loaded for
  nothing nor stored.

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
from exahype_tpu_torch.backends import spec_plan
from exahype_tpu_torch.backends.base import CodePrinter
from exahype_tpu_torch.backends.torch_backend import (
    TorchPrinter,
    access_offsets,
    bare_call_parts,
    check_spec,
    item_vars,
)
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.frontend.statements import StatementKind
from exahype_tpu_torch.utils.errors import LoweringError

#: Shared memory one block may use on the H100 (sm_90): 227 KB.
SMEM_PER_BLOCK = 232_448
#: Shared memory of one SM (sm_90): 228 KB, and what each resident block
#: reserves of it.
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
#: Threads per block: 16 warps.
THREADS = 512
#: Resident blocks an SM the register cap asks for (at most 64 registers a
#: thread), where shared memory leaves room for them.
MIN_BLOCKS = 2
#: Bytes of patches in a row of a tile: one 32-byte sector.
TILE_BYTES = 32
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# state, n_patches, scalar pointers, scalar values, stream
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)
# f64, out (5 ints)
_INFO_ARGTYPES = (ctypes.c_int, ctypes.c_void_p)
_SCALAR, _FIELD, _VFIELD = "scalar", "field", "vfield"
_AXES = ("c0", "c1", "c2")


class CudaPrinter(CodePrinter):
    """Print a kernel spec as one CUDA kernel; ``code`` holds the source.

    ``build()`` returns a :class:`CudaSpecKernel`, ``fn(Q, *scalars) -> Q``
    over the SoA-P state ``[*extent, n_vars, *patch_tail]``.  A spec the
    kernel cannot compute raises :class:`LoweringError` here.

    ``read_cells`` and ``write_cells`` are the ``(cell, var)`` pairs of one
    patch's state that the kernel loads and stores (``cell`` a tuple of
    padded coordinates); every other value of the state is left as it is.
    """

    def __init__(self, kernel: KernelBuilder, function_name: str = "time_step"):
        super().__init__(kernel, function_name=function_name)
        check_spec(kernel)
        self.plan = spec_plan.plan(kernel)
        self.read_cells = self.plan.read_cells
        self.write_cells = self.plan.write_cells
        self.tiles = {dtype: self.tile_patches(dtype) for dtype in _SUFFIX}
        launch = {dtype: (self.tiles[dtype], self.min_blocks(dtype)) for dtype in _SUFFIX}
        self.symbol = f"exahype_spec_{function_name}"
        self.code = _Generator(kernel, self.plan, launch, self.symbol).source()

    # ----------------------------------------------------------- tile sizing

    def bytes_per_patch(self, dtype: torch.dtype) -> int:
        """Shared memory one patch needs: every item over its box."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        return self.plan.values_per_patch(self._kernel) * itemsize

    def tile_patches(self, dtype: torch.dtype) -> int:
        """Patches per block: one 32-byte sector of patches a row (8 in
        float32, 4 in float64) where their items fit :data:`SMEM_PER_BLOCK`,
        else the largest power of two that fits (a spec with large patches
        then reads part sectors rather than being refused)."""
        per_patch = self.bytes_per_patch(dtype)
        if per_patch > SMEM_PER_BLOCK:
            raise LoweringError(
                f"one patch needs {per_patch} bytes of shared memory in "
                f"{dtype}, more than the {SMEM_PER_BLOCK} a block may use"
            )
        sector = TILE_BYTES // torch.empty((), dtype=dtype).element_size()
        fit = SMEM_PER_BLOCK // per_patch
        return min(sector, 1 << (fit.bit_length() - 1))

    def min_blocks(self, dtype: torch.dtype) -> int:
        """Resident blocks an SM the kernel's register cap asks for: up to
        :data:`MIN_BLOCKS`, as many as the tile's shared memory leaves room
        for."""
        need = self.tiles[dtype] * self.bytes_per_patch(dtype) + SMEM_RESERVED
        return max(1, min(MIN_BLOCKS, SMEM_PER_SM // need))

    def moved_bytes(self, n_patches: int, dtype: torch.dtype) -> int:
        """Bytes of the state the kernel reads and writes in one launch."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        return (len(self.read_cells) + len(self.write_cells)) * itemsize * n_patches

    # ----------------------------------------------------------------- build

    def compile(self) -> dict:
        """Compile the source now (``{"path", "seconds", "log", "sources"}``)."""
        return _build.compile_generated(self.symbol, self.code)

    def library(self) -> ctypes.CDLL:
        signatures = tuple(
            (f"{self.symbol}_{suffix}", _ARGTYPES) for suffix in _SUFFIX.values()
        ) + ((f"{self.symbol}_info", _INFO_ARGTYPES),)
        return _build.generated_library(self.symbol, self.code, signatures)

    def build(self) -> "CudaSpecKernel":
        return CudaSpecKernel(self)


class CudaSpecKernel:
    """The spec kernel's wrapper: ``fn(Q, *scalars) -> Q``, in place.

    A CUDA tensor launches the generated kernel (or raises); a CPU tensor
    takes the plain version (:attr:`plain`).  Updating ``Q`` in place is
    safe because patches are independent within a step: every block reads
    and writes only its own patches.  A scalar goes by value as a Python
    float and by device pointer as a tensor (no ``.item()``).
    :attr:`launches` counts the kernel's launches.
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

    def kernel_info(self, dtype) -> dict:
        """Registers, resident blocks per SM, threads, dynamic shared memory
        and local (spill) bytes of the kernel as it launches (on the current
        card)."""
        lib = self.printer.library()
        out = (ctypes.c_int * 5)()
        err = getattr(lib, f"{self.printer.symbol}_info")(
            int(dtype == torch.float64), ctypes.addressof(out))
        _build.check(lib, err, f"{self.printer.symbol}_info")
        return dict(zip(("registers", "blocks_per_sm", "threads", "smem", "local"), out))


# ---------------------------------------------------------------- printing


def _literal(value) -> str:
    value = float(value)
    if not math.isfinite(value):
        raise LoweringError(f"non-finite literal {value}")
    return f"T({value!r})"


def _plus(lo: int, term: str) -> str:
    return term if lo == 0 else f"{lo} + {term}"


def _chain(sizes, blocks, indent) -> list[str]:
    """``blocks`` (lists of lines) chosen by ranges of r of the given
    sizes: an if-else chain that rebases r to each block's start."""
    if len(blocks) == 1:
        return [indent + x for x in blocks[0]]
    out, start = [], 0
    for i, (n, block) in enumerate(zip(sizes, blocks)):
        if i == 0:
            out.append(f"{indent}if (r < {n}) {{")
        elif i < len(blocks) - 1:
            out.append(f"{indent}}} else if (r < {start + n}) {{")
        else:
            out.append(f"{indent}}} else {{")
        if i > 0:
            out.append(f"{indent}  r -= {start};")
        out.extend(f"{indent}  {x}" for x in block)
        start += n
    out.append(f"{indent}}}")
    return out


def _text(stmt) -> str:
    return str(stmt.lhs) if stmt.rhs is None else f"{stmt.lhs} = {stmt.rhs}"


def _box_text(box) -> str:
    return " x ".join(f"[{lo},{hi})" for lo, hi in box)


class _Generator:
    """Prints one spec, under its plan, as a CUDA translation unit."""

    def __init__(self, kb: KernelBuilder, plan: spec_plan.Plan, launch: dict, symbol: str):
        self.kb = kb
        self.cfg = kb.config
        self.plan = plan
        self.launch = launch  # dtype -> (patches a tile, resident blocks an SM)
        self.symbol = symbol
        # Shared-memory layout: each item over its box, the state first.
        state = kb.inputs[0]
        self.items = [state] + [n for n in kb.temp_items() if n in plan.boxes]
        self.offset = {}
        at = 0
        for name in self.items:
            self.offset[name] = at
            at += spec_plan.box_size(plan.boxes[name]) * item_vars(kb, name)
        self.values_per_patch = at
        self.scalars = {name: f"s_{name}" for name in kb.inputs[1:]}
        self._tmp = 0
        self._gathers = None  # the shared gathers of the group being printed

    # ------------------------------------------------------------ top level

    def source(self) -> str:
        kb, cfg, plan = self.kb, self.cfg, self.plan
        env = {name: code for name, code in self.scalars.items()}
        env.update({k: _literal(v) for k, v in kb.literal_values.items()})
        envs = {}
        for k, stmt in enumerate(kb.statements):
            if stmt.kind is StatementKind.CONST_ASSIGN:
                env[str(stmt.lhs)] = _literal(stmt.rhs)
            else:
                envs[k] = dict(env)
        # Every statement is printed, run or not, so that the kernel refuses
        # what the plain version refuses; the phases print those that run.
        for lp in plan.loops:
            if not lp.pieces:
                self._body(lp, envs[lp.index])
        used = []
        for stmt in kb.statements:
            if stmt.kind is StatementKind.CONST_ASSIGN:
                continue
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
        phases = []
        for n, phase in enumerate(plan.phases):
            title = [f"  // Phase {n}: one loop over {len(phase)} group(s), then a barrier."]
            parts = []
            for group in phase:
                title += [f"  // [{lp.index}] {_text(lp.stmt)}" for lp in group]
                parts.append(self._group(group, envs))
            phases.append(self._loop(title, parts) + "\n  __syncthreads();")
        n_scalars = max(1, len(self.scalars))
        read_scalars = "".join(
            f"  const T {code} = sc.ptr[{i}] != nullptr ? *sc.ptr[{i}] : sc.val[{i}];\n"
            for i, code in enumerate(self.scalars.values())
        )
        pointers = "".join(
            f"  T* const it_{name} = sm + {self.offset[name]} * PT;"
            f"  // {_box_text(self.plan.boxes[name])} x {item_vars(kb, name)} vars x PT\n"
            for name in self.items
        )
        state = kb.inputs[0]
        gcell = None
        for d in range(cfg.dim):
            gcell = _AXES[d] if gcell is None else f"({gcell} * {cfg.extent} + {_AXES[d]})"
        glob = f"state[static_cast<long long>({gcell} * {cfg.n_vars} + v) * n_patches + p0 + p]"
        local = self._index(state, [(0, 0, 0)] * cfg.dim, "v")
        load = self._loop(["  // Load the read set of the state, asynchronously: every thread",
                           "  // keeps its copies in flight, none waits on one."],
                          [(spec_plan.pieces(plan.read_cells), [],
                            [f"copy_async(&{local}, &{glob});"])])
        store = self._loop(["  // Store the write set of the state."],
                           [(spec_plan.pieces(plan.write_cells), [], [f"{glob} = {local};"])])
        zero = "".join(
            f"  for (int e = threadIdx.x; e < "
            f"{spec_plan.box_size(plan.boxes[name]) * item_vars(kb, name)} * PT; "
            f"e += kThreads) it_{name}[e] = T(0);  // read before it is written\n"
            for name in plan.zeroed
        )
        (tile_f32, mb_f32), (tile_f64, mb_f64) = (self.launch[t] for t in _SUFFIX)
        return _TEMPLATE.format(
            note=_note(kb, plan, self.launch, self.values_per_patch),
            functions="\n".join(functions),
            threads=THREADS,
            n_scalars=n_scalars,
            pointers=pointers,
            read_scalars=read_scalars,
            load=load,
            zero=zero,
            phases="\n\n".join(phases),
            store=store,
            values_per_patch=self.values_per_patch,
            symbol=self.symbol,
            tile_f32=tile_f32,
            tile_f64=tile_f64,
            min_blocks_f32=mb_f32,
            min_blocks_f64=mb_f64,
        )

    # ------------------------------------------------------------ statements

    def _body(self, lp: spec_plan.Loop, env) -> list[str]:
        """The lines one element of a loop statement runs."""
        kb, stmt, spatial = self.kb, lp.stmt, lp.spatial
        pre: list[str] = []
        if lp.call:
            typed, out_arg, in_args = bare_call_parts(kb, stmt)
            out_name, out_axes, _ = access_offsets(kb, out_arg, spatial)
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
            return pre
        lhs_name, lhs_axes, lhs_vars = access_offsets(kb, stmt.lhs, spatial)
        _, value = self._expr(stmt.rhs, spatial, lp.vb, lp.lanes, env, pre)
        var = "v" if lhs_vars is not None else None
        pre.append(f"{self._index(lhs_name, lhs_axes, var)} = {value};")
        return pre

    def _group(self, group, envs):
        """``(pieces, hoisted, body)`` of a fused group: its statements' lines
        for one element, and the lines run once per cell before them (and
        before the loop over the cell's variables): the gathers of call
        arguments from items the group does not write, one a cell for all
        the group's calls, and the values that read no variable and no item
        the group writes."""
        self._gathers = {"written": {lp.target for lp in group}, "args": {}, "values": {},
                         "lines": []}
        body = []
        for lp in group:
            body += ["{", *(f"  {x}" for x in self._body(lp, envs[lp.index])), "}"]
        hoisted = self._gathers["lines"]
        self._gathers = None
        return group[0].pieces, hoisted, body

    def _loop(self, title, parts) -> str:
        """One loop of the block's threads over the cells of ``parts``
        (``(pieces, hoisted, body)`` each: a statement group) x the tile's
        patches.  Element e is patch e % PT of cell r = e / PT, which
        selects a part and decodes, through its pieces, into (c0, c1[, c2]);
        the body then runs for each variable v of the piece's range, the
        hoisted lines once before."""
        out = list(title)
        sizes = [sum(spec_plan.box_size(box) for box, _ in pieces) for pieces, _, _ in parts]
        out += [
            f"  for (int e = threadIdx.x; e < {sum(sizes)} * PT; e += kThreads) {{",
            "    const int p = e % PT;",
            "    if (p >= np) continue;",
            "    int r = e / PT;",
        ]
        out += _chain(sizes, [self._part(*part) for part in parts], "    ")
        out.append("  }")
        return "\n".join(out)

    def _part(self, pieces, hoisted, body) -> list[str]:
        dim = self.cfg.dim
        need_v = any(re.search(r"\bv\b", line) for line in body)
        ranges = {rng for _, rng in pieces}

        def lanes(lo, hi):
            if not need_v:
                return list(hoisted) + list(body)
            if hi - lo == 1:
                return [f"const int v = {lo};", *hoisted, *body]
            return [*hoisted, "#pragma unroll", f"for (int v = {lo}; v < {hi}; ++v) {{",
                    *(f"  {x}" for x in body), "}"]

        decodes = []
        for box, (lo, hi) in pieces:
            decode = []
            for d in reversed(range(dim)):
                blo, bhi = box[d]
                n = bhi - blo
                if d == 0:
                    decode.append(f"{_AXES[d]} = {_plus(blo, 'r')};")
                elif n == 1:
                    decode.append(f"{_AXES[d]} = {blo};")
                else:
                    decode.append(f"{_AXES[d]} = {_plus(blo, f'r % {n}')};")
                    decode.append(f"r /= {n};")
            if len(ranges) > 1:
                decode += lanes(lo, hi)
            decodes.append(decode)
        sizes = [spec_plan.box_size(box) for box, _ in pieces]
        head = ["int " + ", ".join(_AXES[:dim]) + ";"]
        tail = lanes(*ranges.pop()) if len(ranges) == 1 else []
        return head + _chain(sizes, decodes, "") + tail

    def _index(self, name, axes, var) -> str:
        """``it_name[...]`` of one access over the item's storage box;
        ``var`` is None for a field."""
        box = self.plan.boxes[name]
        cell = None
        for d, (_, _, off) in enumerate(axes):
            k = off - box[d][0]
            c = _AXES[d] if k == 0 else f"({_AXES[d]} {'+' if k > 0 else '-'} {abs(k)})"
            size = box[d][1] - box[d][0]
            cell = c if cell is None else f"({cell} * {size} + {c})"
        if var is None:
            return f"it_{name}[{cell} * PT + p]"
        nv = item_vars(self.kb, name)
        return f"it_{name}[({cell} * {nv} + {var}) * PT + p]"

    # ------------------------------------------------------------ expression

    def _expr(self, expr, spatial, vb, lanes, env, pre):
        """``(kind, code)`` of an expression, in the plain evaluator's order.

        Inside a group, a value that reads items but no variable of them
        (kind ``_FIELD``) and no item the group writes is the same for every
        variable of a cell: it is computed once per cell, before the loop
        over the variables (the same operations on the same values)."""
        kind, code = self._value(expr, spatial, vb, lanes, env, pre)
        g = self._gathers
        if (g is None or kind != _FIELD
                or {str(a.base.label) for a in expr.atoms(sympy.Indexed)} & g["written"]):
            return kind, code
        if code not in g["values"]:
            g["values"][code] = f"h{len(g['values'])}"
            g["lines"].append(f"const T {g['values'][code]} = {code};")
        return kind, g["values"][code]

    def _value(self, expr, spatial, vb, lanes, env, pre):
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
            source = self._index(name, axes, "w")
            g = self._gathers
            shared = g is not None and name not in g["written"]
            if shared and source in g["args"]:
                return g["args"][source]  # one gather a cell for the group
            arg = f"a{self._tmp}"
            self._tmp += 1
            lines = g["lines"] if shared else pre
            lines.append(f"T {arg}[{nvars}];")
            lines.append("#pragma unroll")
            lines.append(f"for (int w = 0; w < {nvars}; ++w) {arg}[w] = {source};")
            if shared:
                g["args"][source] = arg
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


def _note(kb, plan, launch, values_per_patch) -> str:
    cfg = kb.config
    state = cfg.extent**cfg.dim * cfg.n_vars
    run = sum(len(phase) for phase in plan.phases)
    return (
        f"// Spec: dim={cfg.dim}, patch_size={cfg.patch_size}, "
        f"halo_size={cfg.halo_size}, n_real={cfg.n_real}, n_aux={cfg.n_aux}; "
        f"{len(kb.statements)} statements, {len(plan.loops)} of them loops,\n"
        f"// run as {run} loop(s) in {len(plan.phases)} barrier phase(s).\n"
        f"// State per patch: {state} values; {len(plan.read_cells)} read, "
        f"{len(plan.write_cells)} written.\n"
        f"// Shared memory per patch: {values_per_patch} values "
        f"({values_per_patch * 4} B in float32, {values_per_patch * 8} B in "
        f"float64); tiles of\n// {launch[torch.float32][0]} (float32) and "
        f"{launch[torch.float64][0]} (float64) patches per block."
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
// cell against the state, so the least work is reading the state values the
// output depends on and writing those the statement list changes.  The
// printer's demand analysis (backends/spec_plan.py) finds both, and which
// elements of each statement the output needs: the kernel loads only the
// read set, runs each statement only where its value is used, and stores
// only the write set; halo values that feed nothing are not loaded, and no
// value the statement list leaves alone is stored.  A block owns a tile of
// PT patches (32 bytes of patches a row, whole sectors, where the tile's
// shared memory fits; else fewer) and holds every item
// of those patches in shared memory over the bounding box of the cells it
// touches, as [cell][var][patch], patch fastest; no temp touches device
// memory.  The read set is loaded with cp.async, so a thread keeps all its
// copies in flight instead of one load at a time.  Statements run as loops
// of the block's threads over their demanded elements x patches; a barrier ends each phase of statements
// between which no value crosses threads, and statements over the same
// elements whose values stay in their thread share a loop.  A typed call
// runs once per cell on the cell's variable vector.  The shared memory of
// a tile leaves room for more than one block an SM where the spec allows,
// so one block's loads overlap another's statements.
{note}

#include <cuda_runtime.h>

#include "device_math.cuh"

{functions}
namespace {{

constexpr int kThreads = {threads};
constexpr int kScalars = {n_scalars};
constexpr int kValuesPerPatch = {values_per_patch};

// One element from device memory to shared memory without a register
// (cp.async, 4 or 8 bytes), and the wait for this thread's copies.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {{
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\\n" :: "r"(s), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}}

__device__ __forceinline__ void copies_done() {{
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
}}

template <typename T>
struct Scalars {{
  const T* ptr[kScalars];  // a device scalar, or null: use val
  T val[kScalars];
}};

// PT patches a tile; MB resident blocks an SM for the register cap.
template <typename T, int PT, int MB>
__global__ void __launch_bounds__(kThreads, MB)
spec_kernel(T* __restrict__ state, long long n_patches, const Scalars<T> sc) {{
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
{pointers}  const long long p0 = static_cast<long long>(blockIdx.x) * PT;
  const int np = static_cast<int>(n_patches - p0 < PT ? n_patches - p0 : PT);
{read_scalars}
{load}
{zero}  copies_done();
  __syncthreads();

{phases}

{store}
}}

template <typename T, int PT>
constexpr size_t smem_bytes() {{
  return static_cast<size_t>(kValuesPerPatch) * PT * sizeof(T);
}}

template <typename T, int PT, int MB>
cudaError_t launch(T* state, long long n_patches, const unsigned long long* ptrs,
                   const double* vals, void* stream) {{
  if (n_patches <= 0) return cudaErrorInvalidValue;
  Scalars<T> sc;
  for (int i = 0; i < kScalars; ++i) {{
    sc.ptr[i] = reinterpret_cast<const T*>(ptrs[i]);
    sc.val[i] = static_cast<T>(vals[i]);
  }}
  const size_t smem = smem_bytes<T, PT>();
  // The opt-in above 48 KB of shared memory, once per instantiation (the
  // port launches on one card).
  static const cudaError_t attr = cudaFuncSetAttribute(
      spec_kernel<T, PT, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = (n_patches + PT - 1) / PT;
  spec_kernel<T, PT, MB><<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(state, n_patches, sc);
  return cudaGetLastError();
}}

// Registers, resident blocks per SM, threads, dynamic shared memory and
// local (spill) bytes of the kernel as launch() launches it.
template <typename T, int PT, int MB>
int info(int* out) {{
  const size_t smem = smem_bytes<T, PT>();
  cudaError_t e = cudaFuncSetAttribute(spec_kernel<T, PT, MB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, spec_kernel<T, PT, MB>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, spec_kernel<T, PT, MB>, kThreads, smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = static_cast<int>(smem);
  out[4] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}}

}}  // namespace

extern "C" {{

// Each entry enqueues one kernel on `stream` and returns the launch's
// cudaError_t (0 = cudaSuccess).  ptrs/vals: one device pointer (or 0) and
// one value per scalar input, in the spec's order.
int {symbol}_f32(float* state, long long n_patches,
                 const unsigned long long* ptrs, const double* vals, void* stream) {{
  return launch<float, {tile_f32}, {min_blocks_f32}>(state, n_patches, ptrs, vals, stream);
}}

int {symbol}_f64(double* state, long long n_patches,
                 const unsigned long long* ptrs, const double* vals, void* stream) {{
  return launch<double, {tile_f64}, {min_blocks_f64}>(state, n_patches, ptrs, vals, stream);
}}

// out[0..4] of the float32 (f64 = 0) or float64 (f64 = 1) kernel.
int {symbol}_info(int f64, int* out) {{
  return f64 ? info<double, {tile_f64}, {min_blocks_f64}>(out)
             : info<float, {tile_f32}, {min_blocks_f32}>(out);
}}

const char* exahype_cuda_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}

}}  // extern "C"
"""
