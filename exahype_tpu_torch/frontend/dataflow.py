"""Spatial dataflow analysis over a kernel's statement list.

Copy of ``exahype_tpu/frontend/dataflow.py`` (the port imports nothing of
the JAX package); both of the port's printers call
:func:`validate_dataflow` when they build.

The reference computes loop bounds per statement in isolation
(``exahype/printers/CPPPrinter.py:109-137``); nothing relates a consumer's
reads to what its producers actually wrote, so a spec whose *chained*
stencil reach exceeds the stored halo silently computes interior cells from
never-written scratch positions.  This module supplies the two transitive
analyses the per-statement view cannot express:

- :func:`transitive_input_reach` — the hull of the kernel's chained stencil
  reach on its INPUT arrays, composed through every intermediate buffer.
  A first-order flux-form spec (the Rusanov patch update) has reach 1; a
  reconstruction-based spec (MUSCL: slope → face value → flux → update)
  has reach ≥ 2.  The AMR refluxing eligibility probe
  (:func:`exahype_tpu.parallel.refine.reflux_physics`) uses this to refuse
  specs whose face fluxes are NOT the first-order Rusanov flux of adjacent
  cell values — applying a first-order reflux correction to a
  reconstruction-based scheme breaks the conservation invariant the
  correction exists to guarantee.

- :func:`validate_dataflow` — demand-driven range checking: a backward pass
  computes which positions of each buffer actually flow into the kernel's
  write-back interior, a forward pass computes which positions each producer
  wrote (under the sound bounds of :mod:`.bounds`), and a demanded read
  outside the producer's written range raises :class:`LoweringError`
  instead of silently consuming zero-initialized scratch.

Interval arithmetic is hull-based (per buffer, per spatial axis): exact for
the contiguous write/read regions every DSL statement produces, and
conservative (over-approximate demand, never under-approximate validity)
otherwise.
"""

from __future__ import annotations

import sympy

from exahype_tpu_torch.frontend.statements import Statement, StatementKind
from exahype_tpu_torch.frontend.typed_function import typed_of
from exahype_tpu_torch.utils.errors import LoweringError

#: Half-open interval, or None for "empty".
Interval = tuple[int, int] | None


def _hull(a: Interval, b: Interval) -> Interval:
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def _intersect(a: Interval, b: Interval) -> Interval:
    if a is None or b is None:
        return None
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _shift(a: Interval, o: int) -> Interval:
    return None if a is None else (a[0] + o, a[1] + o)


def _covers(outer: Interval, inner: Interval) -> bool:
    if inner is None:
        return True
    return outer is not None and outer[0] <= inner[0] and inner[1] <= outer[1]


def _access_offsets(access: sympy.Indexed, spatial_names) -> dict[str, int]:
    """Constant spatial shifts of one array access: axis name -> offset."""
    offsets = {name: 0 for name in spatial_names}
    for idx in access.indices:
        if isinstance(idx, (sympy.Symbol, sympy.Idx)):
            continue
        for sym in idx.free_symbols:
            name = str(sym)
            if name not in offsets:
                continue
            off = sympy.simplify(idx - sym)
            if off.is_number:
                offsets[name] = int(off)
    return offsets


def _classify_accesses(stmt: Statement, spatial_names):
    """Split a statement's array accesses into (writes, reads).

    Each entry is ``(buffer_name, {axis: offset})``.  Plain assignments
    write their LHS access; bare calls and applied typed functions write
    through their ``out_param`` argument (the reference's
    ``Flux(Q, normal, F)`` convention, ``Unit test/Functions.cpp:9-37``).
    """
    writes: list[tuple[str, dict]] = []
    reads: list[tuple[str, dict]] = []
    write_ids: set[int] = set()

    def visit_out_params(expr):
        for node in sympy.preorder_traversal(expr):
            typed = typed_of(node) if isinstance(node, sympy.Basic) else None
            if typed is None or typed.out_param is None:
                continue
            if typed.out_param < len(node.args):
                for acc in node.args[typed.out_param].atoms(sympy.Indexed):
                    writes.append(
                        (str(acc.base.label), _access_offsets(acc, spatial_names))
                    )
                    write_ids.add(id(acc))

    if stmt.rhs is None:
        visit_out_params(stmt.lhs)
    else:
        if isinstance(stmt.lhs, sympy.Indexed):
            writes.append(
                (str(stmt.lhs.base.label), _access_offsets(stmt.lhs, spatial_names))
            )
            write_ids.add(id(stmt.lhs))
        visit_out_params(stmt.rhs)
    for expr in stmt.exprs():
        for acc in expr.atoms(sympy.Indexed):
            if id(acc) in write_ids:
                continue
            reads.append((str(acc.base.label), _access_offsets(acc, spatial_names)))
    return writes, reads


def transitive_input_reach(kernel) -> dict[str, tuple[int, int]]:
    """Chained stencil reach of the kernel on its input arrays.

    Returns ``{spatial_axis_name: (neg, pos)}`` — the hull, over every value
    the kernel's write-back statements consume, of the composed constant
    shifts back to the kernel INPUT arrays.  The first-order Rusanov spec
    reaches (1, 1) on each axis; MUSCL's slope→face→flux chain reaches
    (2, 2).  Scalar/constant reads contribute nothing.
    """
    cfg = kernel.config
    names = cfg.spatial_index_names
    inputs = set(kernel.inputs)
    # reach[buffer][axis] = (neg, pos) hull back to the inputs.
    reach: dict[str, dict[str, tuple[int, int]]] = {
        name: {ax: (0, 0) for ax in names} for name in inputs
    }
    total = {ax: (0, 0) for ax in names}

    def compose(base: tuple[int, int], off: int) -> tuple[int, int]:
        neg, pos = base
        return (neg + max(0, -off), pos + max(0, off))

    for stmt in kernel.statements:
        if stmt.kind is not StatementKind.LOOP:
            continue
        writes, reads = _classify_accesses(stmt, names)
        stmt_reach = {ax: None for ax in names}
        for buf, offs in reads:
            if buf not in reach:
                continue  # scalar / untracked
            for ax in names:
                r = compose(reach[buf][ax], offs[ax])
                cur = stmt_reach[ax]
                stmt_reach[ax] = (
                    r
                    if cur is None
                    else (max(cur[0], r[0]), max(cur[1], r[1]))
                )
        for buf, offs in writes:
            if stmt_reach[names[0]] is None and buf not in reach:
                continue
            prior = reach.get(buf)
            new = {}
            for ax in names:
                r = stmt_reach[ax] or (0, 0)
                if prior is not None:
                    # In-place updates (Q_copy += ...) keep earlier reach.
                    r = (max(r[0], prior[ax][0]), max(r[1], prior[ax][1]))
                new[ax] = r
            reach[buf] = new
            if stmt.direction == -2 or buf in inputs:
                for ax in names:
                    total[ax] = (
                        max(total[ax][0], new[ax][0]),
                        max(total[ax][1], new[ax][1]),
                    )
    return total


def max_input_reach(kernel) -> int:
    """Largest single-axis chained reach on the kernel inputs."""
    reach = transitive_input_reach(kernel)
    return max((max(neg, pos) for neg, pos in reach.values()), default=0)


def validate_dataflow(kernel) -> None:
    """Raise :class:`LoweringError` if any DEMANDED read falls outside its
    producer's written range (see module docstring).
    """
    cfg = kernel.config
    names = cfg.spatial_index_names
    stmts = [s for s in kernel.statements if s.kind is StatementKind.LOOP]
    per_stmt = []
    for stmt in stmts:
        ranges = kernel.loop_ranges(stmt)
        loops = {ax: ranges[1 + level] for level, ax in enumerate(names)}
        writes, reads = _classify_accesses(stmt, names)
        per_stmt.append((stmt, loops, writes, reads))

    # Backward pass: effective (demanded) range per statement.
    demand: dict[str, dict[str, Interval]] = {}
    effective: list[dict[str, Interval]] = [dict() for _ in stmts]
    for i in range(len(stmts) - 1, -1, -1):
        stmt, loops, writes, reads = per_stmt[i]
        eff = {ax: None for ax in names}
        for buf, offs in writes:
            if stmt.direction == -2:
                d = {ax: loops[ax] for ax in names}  # output: all demanded
            else:
                d = demand.get(buf)
                if d is None:
                    continue
            for ax in names:
                eff[ax] = _hull(
                    eff[ax], _intersect(loops[ax], _shift(d[ax], -offs[ax]))
                )
        if any(eff[ax] is None for ax in names):
            effective[i] = {ax: None for ax in names}
            continue  # nothing this statement produces is consumed
        effective[i] = eff
        for buf, offs in reads:
            cur = demand.setdefault(buf, {ax: None for ax in names})
            for ax in names:
                cur[ax] = _hull(cur[ax], _shift(eff[ax], offs[ax]))

    # Forward pass: written (valid) hull per buffer; check demanded reads.
    valid: dict[str, dict[str, Interval]] = {
        name: {ax: (0, cfg.extent) for ax in names} for name in kernel.inputs
    }
    for i, (stmt, loops, writes, reads) in enumerate(per_stmt):
        eff = effective[i]
        if all(eff.get(ax) is not None for ax in names):
            for buf, offs in reads:
                got = valid.get(buf)
                if got is None:
                    # Never written so far: the whole buffer is the backends'
                    # zero-initialized scratch — a DEFINED value in this
                    # framework (deviation from the reference's uninitialized
                    # ``new double[...]``, SURVEY.md §7), and a pattern the
                    # fuzzed specs exercise on purpose.  Only reads outside a
                    # PRODUCED range are the silent-corruption class.
                    continue
                for ax in names:
                    needed = _shift(eff[ax], offs[ax])
                    have = got[ax]
                    if have is not None and not _covers(have, needed):
                        raise LoweringError(
                            f"statement {i} reads {buf!r} over "
                            f"{ax}∈[{needed[0]},{needed[1]}) but its producers "
                            f"only wrote {ax}∈[{have[0]},{have[1]})"
                            f" — the spec's chained stencil reach exceeds what "
                            f"halo_size={cfg.halo_size} can hold (demand traced "
                            f"from the write-back interior)"
                        )
        for buf, offs in writes:
            cur = valid.setdefault(buf, {ax: None for ax in names})
            for ax in names:
                cur[ax] = _hull(cur[ax], _shift(loops[ax], offs[ax]))
