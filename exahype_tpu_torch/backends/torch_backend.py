"""The plain PyTorch version of the fused spec kernel (K4).

Evaluates a :class:`KernelBuilder` statement list with torch slices over
the whole SoA-P state ``[*extent, n_vars, *patch_tail]``, with the
semantics of ``exahype_tpu/backends/pallas_backend.py::PallasPrinter``
(``build``, ``_apply_statement``, ``_eval``, ``_eval_call``,
``_access_slices``) and no tiling:

- every temp item is zero-filled;
- each statement runs over its ``statement_ranges`` region,
  ``CONST_ASSIGN`` statements bind the directional ``normal``, and the var
  loop is cut to the statement's ``vb``;
- expressions are evaluated as the Pallas printer evaluates them: terms
  and factors in ``as_ordered_terms`` / ``as_ordered_factors`` order,
  folded from the left; a ``Pow`` of −1 is a reciprocal, of 2 a product,
  of ½ a ``sqrt``;
- typed functions run their ``torch_impl``.

The state is updated in place, as the Pallas kernel aliases it (halos are
padding and patches are independent within a step).  This is what a CPU
tensor takes in the CUDA wrapper (:mod:`.cuda_backend`), and what
``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

from typing import Any, Callable

import sympy
import torch
from sympy.core.function import AppliedUndef

from exahype_tpu_torch.backends.base import CodePrinter
from exahype_tpu_torch.frontend.dataflow import validate_dataflow
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.frontend.statements import Statement, StatementKind
from exahype_tpu_torch.utils.errors import LoweringError

_SCALAR, _FIELD, _VFIELD = "scalar", "field", "vfield"


class TorchPrinter(CodePrinter):
    """Lower a kernel spec to a PyTorch function over the SoA-P layout.

    ``build()`` returns ``fn(Q, *scalars) -> Q``: ``Q`` is
    ``[*extent, n_vars, *patch_tail]`` (any number of patch axes), updated
    in place and returned; the scalars follow the kernel's declared inputs
    (e.g. ``dt``) as Python floats or 0-d tensors.
    """

    def __init__(self, kernel: KernelBuilder, function_name: str = "time_step"):
        super().__init__(kernel, function_name=function_name)
        self._fn: Callable | None = None

    def build(self) -> Callable:
        if self._fn is not None:
            return self._fn
        kb = self._kernel
        cfg = kb.config
        check_spec(kb)
        primary = kb.inputs[0]
        scalar_inputs = kb.inputs[1:]
        temp_names = kb.temp_items()

        def fn(Q, *scalars):
            if len(scalars) != len(scalar_inputs):
                raise TypeError(
                    f"{self._function_name} expects {len(scalar_inputs)} "
                    f"scalar argument(s) {scalar_inputs}"
                )
            lead = (cfg.extent,) * cfg.dim + (cfg.n_vars,)
            if tuple(Q.shape[: cfg.dim + 1]) != lead or Q.dim() <= cfg.dim + 1:
                raise LoweringError(
                    f"state shape {tuple(Q.shape)} is not [*{lead}, *patch_tail]"
                )
            tail = tuple(Q.shape[cfg.dim + 1:])
            env: dict[str, Any] = {primary: Q}
            for name in temp_names:
                env[name] = torch.zeros(
                    item_shape(kb, name) + tail, dtype=Q.dtype, device=Q.device
                )
            for name, s in zip(scalar_inputs, scalars):
                env[name] = torch.as_tensor(s, dtype=Q.dtype, device=Q.device)
            env.update(kb.literal_values)
            for stmt in kb.statements:
                if stmt.kind is StatementKind.CONST_ASSIGN:
                    env[str(stmt.lhs)] = float(stmt.rhs)
                else:
                    self._apply_statement(env, stmt, len(tail))
            return Q

        fn.__name__ = self._function_name
        self._fn = fn
        return fn

    # ------------------------------------------------------------ statements

    def _apply_statement(self, env, stmt: Statement, n_tail: int) -> None:
        kb = self._kernel
        cfg = kb.config
        spatial, vb = statement_region(kb, stmt)
        var_axis = cfg.dim

        if isinstance(stmt.lhs, AppliedUndef):
            typed, out_arg, in_args = bare_call_parts(kb, stmt)
            _, value = self._eval_call(env, typed, in_args, spatial, n_tail)
            name, slices, has_var = access_slices(kb, out_arg, spatial, None, n_tail)
            if has_var:
                nvar = value.shape[var_axis]
                slices = slices[:var_axis] + (slice(0, nvar),) + slices[var_axis + 1:]
            _store(env[name], slices, value)
            return

        check_assignment(kb, stmt, vb)
        kind, value = self._eval(env, stmt.rhs, spatial, vb, n_tail)
        name, slices, has_var = access_slices(kb, stmt.lhs, spatial, vb, n_tail)
        if has_var and kind == _FIELD:
            value = value.unsqueeze(var_axis)
        if not has_var and kind == _VFIELD:
            value = value.select(var_axis, 0)
        _store(env[name], slices, value)

    # ------------------------------------------------------------ expression

    def _eval(self, env, expr, spatial, vb, n_tail):
        var_axis = self._kernel.config.dim
        if expr is None:
            raise LoweringError("missing RHS")
        if expr.is_Number:
            return _SCALAR, float(expr)
        if isinstance(expr, sympy.Symbol):
            name = str(expr)
            if name not in env:
                raise LoweringError(f"unbound symbol {name!r}")
            return _SCALAR, env[name]
        if isinstance(expr, sympy.Indexed):
            return self._read(env, expr, spatial, vb, n_tail)
        if isinstance(expr, AppliedUndef):
            typed = self._kernel.functions.get(type(expr).__name__)
            if typed is None:
                raise LoweringError(f"unknown function {type(expr).__name__}")
            return self._eval_call(env, typed, list(expr.args), spatial, n_tail)
        if isinstance(expr, sympy.Add):
            vals = [self._eval(env, a, spatial, vb, n_tail)
                    for a in expr.as_ordered_terms()]
            return _combine(vals, lambda x, y: x + y, var_axis)
        if isinstance(expr, sympy.Mul):
            vals = [self._eval(env, a, spatial, vb, n_tail)
                    for a in expr.as_ordered_factors()]
            return _combine(vals, lambda x, y: x * y, var_axis)
        if isinstance(expr, sympy.Pow):
            bk, bv = self._eval(env, expr.base, spatial, vb, n_tail)
            if expr.exp == sympy.Integer(-1):
                return bk, 1.0 / bv
            if expr.exp == sympy.Integer(2):
                return bk, bv * bv
            if expr.exp == sympy.Rational(1, 2):
                return bk, _sqrt(bv)
            ek, ev = self._eval(env, expr.exp, spatial, vb, n_tail)
            if ek != _SCALAR:
                raise LoweringError("array-valued exponents unsupported")
            return bk, bv**ev
        if isinstance(expr, (sympy.Max, sympy.Min)):
            op = _maximum if isinstance(expr, sympy.Max) else _minimum
            vals = [self._eval(env, a, spatial, vb, n_tail) for a in expr.args]
            return _combine(vals, op, var_axis)
        if isinstance(expr, sympy.Abs):
            k, v = self._eval(env, expr.args[0], spatial, vb, n_tail)
            return k, abs(v)
        raise LoweringError(f"cannot lower {type(expr).__name__}: {expr}")

    def _eval_call(self, env, typed, args, spatial, n_tail):
        impl = typed.torch_impl
        if impl is None:
            raise LoweringError(
                f"function {typed.name!r} has no torch_impl; supply one via "
                "kernel.function(..., torch_impl=...)"
            )
        evaluated = []
        for a in args:
            if isinstance(a, sympy.Indexed):
                evaluated.append(self._read(env, a, spatial, None, n_tail))
            else:
                k, v = self._eval(env, a, spatial, 1, n_tail)
                if k != _SCALAR:
                    raise LoweringError(f"argument {a} must be scalar")
                evaluated.append((_SCALAR, v))
        result = impl(*[v for _, v in evaluated])
        cfg = self._kernel.config
        if result.dim() == cfg.dim + n_tail:
            return _FIELD, result
        if result.dim() == cfg.dim + 1 + n_tail:
            return _VFIELD, result
        raise LoweringError(
            f"{typed.name} returned rank-{result.dim()}; expected a per-region "
            "field or vfield in SoA-P layout"
        )

    def _read(self, env, access, spatial, vb, n_tail):
        name, slices, has_var = access_slices(self._kernel, access, spatial, vb, n_tail)
        return (_VFIELD if has_var else _FIELD), env[name][slices]


# ------------------------------------------------------------------ shared
# Spec analysis the two printers share: both lower the same statement list
# over the same regions and refuse the same specs.


def item_shape(kb: KernelBuilder, name: str) -> tuple[int, ...]:
    """SoA-P shape of an item without its patch axes."""
    cfg = kb.config
    return (cfg.extent,) * cfg.dim + {0: (), 1: (cfg.n_real,), 2: (cfg.n_vars,)}[
        kb.item_struct[name]
    ]


def item_vars(kb: KernelBuilder, name: str) -> int:
    """Variables of an item (1 for a scalar field)."""
    cfg = kb.config
    return {0: 1, 1: cfg.n_real, 2: cfg.n_vars}[kb.item_struct[name]]


def check_spec(kb: KernelBuilder) -> None:
    """What both printers require before they lower a spec."""
    if not kb.inputs:
        raise LoweringError("kernel has no primary input item")
    if kb.item_struct.get(kb.inputs[0]) != 2:
        raise LoweringError(
            f"the primary item {kb.inputs[0]!r} must carry all n_vars variables"
        )
    validate_dataflow(kb)


def statement_region(kb: KernelBuilder, stmt: Statement):
    """``(spatial ranges, vb)`` of a loop statement."""
    ranges = kb.loop_ranges(stmt)
    return ranges[1: 1 + kb.config.dim], ranges[-1][1]


def bare_call_parts(kb: KernelBuilder, stmt: Statement):
    """``(typed, out_arg, in_args)`` of a bare call statement."""
    typed = kb.functions.get(type(stmt.lhs).__name__)
    if typed is None or typed.out_param is None:
        raise LoweringError(f"bare call {stmt.lhs} needs out_param")
    out_arg = stmt.lhs.args[typed.out_param]
    in_args = [a for i, a in enumerate(stmt.lhs.args) if i != typed.out_param]
    return typed, out_arg, in_args


def check_assignment(kb: KernelBuilder, stmt: Statement, vb: int) -> None:
    """Refuse what the Pallas printer refuses in a plain assignment."""
    cfg = kb.config
    if not isinstance(stmt.lhs, sympy.Indexed):
        raise LoweringError(f"cannot assign to {stmt.lhs}")
    if stmt.self_referencing_stencil(cfg.spatial_index_names):
        raise LoweringError(
            f"statement '{stmt.lhs} = {stmt.rhs}' reads its own target "
            "array at a shifted index (see jax_backend note)"
        )
    reject_pointer_call_in_var_loop(kb, stmt, vb)


def reject_pointer_call_in_var_loop(kb, stmt, vb: int) -> None:
    """Calls with struct-pointer arguments inside a var loop (vb > 1) are
    ambiguous: the C ABI passes a pointer offset by the loop's var index
    while the traced backends pass the full variable slice.  No reference
    spec exercises this; reject it instead of silently diverging."""
    if vb <= 1 or stmt.rhs is None:
        return
    for call in stmt.rhs.atoms(AppliedUndef):
        for a in call.args:
            if (
                isinstance(a, sympy.Indexed)
                and kb.item_struct.get(str(a.base.label), 0) != 0
            ):
                raise LoweringError(
                    f"call {call} passes struct pointer {a.base} inside a "
                    f"var loop of extent {vb}: the C ABI and the traced "
                    "backends would disagree; restructure the statement "
                    "(e.g. struct_override=0 or a scalar-field argument)"
                )


def access_offsets(kb: KernelBuilder, access: sympy.Indexed, spatial):
    """``(name, [(lo, hi, offset)] per spatial axis, var count or None)`` of
    an array access over ``spatial``; raises if it leaves the patch."""
    cfg = kb.config
    name = str(access.base.label)
    if name not in kb.item_struct:
        raise LoweringError(f"unknown item {name!r}")
    indices = access.indices  # [patch, i, j(, k)(, var)]
    axes = []
    for level in range(1, cfg.dim + 1):
        offset = _offset_of(indices[level])
        lo, hi = spatial[level - 1]
        if lo + offset < 0 or hi + offset > cfg.extent:
            raise LoweringError(
                f"access {access} leaves the halo-padded patch; "
                "increase halo_size"
            )
        axes.append((lo, hi, offset))
    nvars = item_vars(kb, name) if kb.item_struct[name] != 0 else None
    return name, axes, nvars


def access_slices(kb: KernelBuilder, access, spatial, vb, n_tail: int):
    """Index layout: [*spatial, (var,) *patch_tail]; tail always full."""
    name, axes, nvars = access_offsets(kb, access, spatial)
    slices = [slice(lo + off, hi + off) for lo, hi, off in axes]
    if nvars is not None:
        slices.append(slice(0, nvars if vb is None else min(vb, nvars)))
    slices.extend([slice(None)] * n_tail)
    return name, tuple(slices), nvars is not None


def _store(target, slices, value):
    if isinstance(value, torch.Tensor):
        target[slices] = value.to(target.dtype)
    else:
        target[slices] = value


def _offset_of(idx_expr) -> int:
    if isinstance(idx_expr, (sympy.Symbol, sympy.Idx)):
        return 0
    syms = list(idx_expr.free_symbols)
    if len(syms) != 1:
        raise LoweringError(f"unsupported index expression {idx_expr}")
    off = sympy.simplify(idx_expr - syms[0])
    if not off.is_Integer:
        raise LoweringError(f"non-integer offset in {idx_expr}")
    return int(off)


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else v**0.5


def _binary(tensor_op, scalar_op):
    """``tensor_op`` on tensors, a Python number taking the tensor's dtype
    (as ``jnp.maximum`` treats a weakly typed scalar)."""

    def op(a, b):
        ref = a if isinstance(a, torch.Tensor) else b
        if not isinstance(ref, torch.Tensor):
            return scalar_op(a, b)
        return tensor_op(
            torch.as_tensor(a, dtype=ref.dtype, device=ref.device),
            torch.as_tensor(b, dtype=ref.dtype, device=ref.device),
        )

    return op


_maximum = _binary(torch.maximum, max)
_minimum = _binary(torch.minimum, min)


def _combine(vals, op, var_axis: int):
    has_vfield = any(k == _VFIELD for k, _ in vals)
    has_field = any(k == _FIELD for k, _ in vals)
    norm = []
    for k, v in vals:
        if has_vfield and k == _FIELD:
            v = v.unsqueeze(var_axis)
        norm.append(v)
    out = norm[0]
    for v in norm[1:]:
        out = op(out, v)
    kind = _VFIELD if has_vfield else (_FIELD if has_field else _SCALAR)
    return kind, out
