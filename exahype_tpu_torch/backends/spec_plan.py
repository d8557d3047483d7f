"""What the generated spec kernel (K4) computes, loads and stores.

A print-time analysis of a :class:`KernelBuilder` statement list, for
:mod:`.cuda_backend`.  Regions and stencil offsets are static, so every
statement's elements — ``(cell, lane)`` pairs of its region and var loop —
and the ``(item, cell, var)`` values each one reads and writes are known
before the kernel runs.  Three passes:

1. **Copy propagation.**  After a plain copy ``X[0] = Y[0]``, a read of X
   whose every value still equals Y's (neither written since) reads Y.
   The value is the same, so the result is bitwise the same; the copy then
   often feeds nothing (the ``fv`` spec's ``Q_copy = Q`` outside the
   interior).
2. **Demand.**  Walking backwards from the state values some statement
   writes (the *write set*), each statement keeps only the elements whose
   target a later statement, or the final state, reads.  A demanded element
   gets the same expression in the same order as in the full evaluation,
   so its value is bitwise the full evaluation's.  What is demanded of the
   state at the start is the *read set*.
3. **Layout and phases.**  Each item is stored over the bounding box of the
   cells it touches.  Statements become loops over their demanded elements
   (unions of boxes); consecutive statements share one barrier phase when
   no value crosses threads between them, and share one loop when they
   run over the same elements and every value they pass stays in its
   thread.

The plain evaluator (:mod:`.torch_backend`) computes every statement over
its whole region; on the elements the kernel computes, both agree.
"""

from __future__ import annotations

import dataclasses
import itertools

import sympy
from sympy.core.function import AppliedUndef

from exahype_tpu_torch.backends.torch_backend import (
    access_offsets,
    bare_call_parts,
    check_assignment,
    item_vars,
    statement_region,
)
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.frontend.statements import Statement, StatementKind
from exahype_tpu_torch.utils.errors import LoweringError

#: How a read picks its variable: the element's lane, variable 0, every
#: variable of the item (a struct argument of a call), or none (a field).
LANE, VAR0, ALL, FIELD = "lane", "var0", "all", "field"


@dataclasses.dataclass(frozen=True)
class Read:
    access: sympy.Indexed
    name: str
    offsets: tuple[int, ...]
    mode: str


@dataclasses.dataclass
class Loop:
    """One loop statement as the kernel runs it."""

    index: int  # position in the statement list
    stmt: Statement  # reads rewritten by copy propagation
    spatial: tuple  # the statement's region, ((lo, hi), ...) per axis
    vb: int
    lanes: int
    target: str
    call: bool  # a bare call: each element writes every var of the target
    reads: list[Read]
    pieces: tuple = ()  # demanded elements: ((box, (lane_lo, lane_hi)), ...)

    def elements(self):
        for cell in _box_cells(self.spatial):
            for lane in range(self.lanes):
                yield cell, lane


@dataclasses.dataclass
class Plan:
    loops: list[Loop]  # every loop statement, in order (pieces empty: not run)
    phases: list[list[list[Loop]]]  # phase -> fused loops -> statements
    read_cells: frozenset  # (cell, var) of the state loaded
    write_cells: frozenset  # (cell, var) of the state stored
    boxes: dict  # item -> its storage box, ((lo, hi), ...) per axis
    zeroed: tuple  # temps read before they are written (zero-filled)

    def values_per_patch(self, kb: KernelBuilder) -> int:
        return sum(box_size(box) * item_vars(kb, name) for name, box in self.boxes.items())


def plan(kb: KernelBuilder) -> Plan:
    state = kb.inputs[0]
    loops = [_describe(kb, k, s) for k, s in enumerate(kb.statements)
             if s.kind is not StatementKind.CONST_ASSIGN]
    loops = _propagate_copies(kb, loops)
    write = {(cell, var) for lp in loops if lp.target == state
             for cell, lane in lp.elements() for _, _, var in _targets(kb, lp, cell, lane)}
    demand = {(state, cell, var) for cell, var in write}
    touched: dict[str, set] = {}
    for lp in reversed(loops):
        kept = []
        for cell, lane in lp.elements():
            targets = _targets(kb, lp, cell, lane)
            if any(t in demand for t in targets):
                kept.append((cell, lane))
        for cell, lane in lp.elements():
            demand.difference_update(_targets(kb, lp, cell, lane))
        for cell, lane in kept:
            touched.setdefault(lp.target, set()).add(cell)
            for name, c, var in _values_read(kb, lp, cell, lane):
                demand.add((name, c, var))
                touched.setdefault(name, set()).add(c)
        lp.pieces = pieces(kept)
    read = frozenset((c, v) for name, c, v in demand if name == state)
    zeroed = tuple(sorted({name for name, _, _ in demand if name != state}))
    for name, c, _ in demand:
        touched.setdefault(name, set()).add(c)
    touched.setdefault(state, set()).update(c for c, _ in write)
    boxes = {name: _bbox(cells) for name, cells in sorted(touched.items())}
    live = [lp for lp in loops if lp.pieces]
    return Plan(loops, _phases(live), read, frozenset(write), boxes, zeroed)


# ------------------------------------------------------------ statements


def _describe(kb: KernelBuilder, k: int, stmt: Statement) -> Loop:
    """A statement's loop: region, lanes, target and reads (the checks are
    those of the printers)."""
    spatial, vb = statement_region(kb, stmt)
    if isinstance(stmt.lhs, AppliedUndef):
        _, out_arg, in_args = bare_call_parts(kb, stmt)
        target, _, _ = access_offsets(kb, out_arg, spatial)
        reads = []
        for a in in_args:
            if isinstance(a, sympy.Indexed):
                read = _call_read(kb, a, spatial)
                if read.name == target and any(read.offsets):
                    raise LoweringError(
                        f"call {stmt.lhs} writes {target!r} and reads it at a "
                        "shifted index: one kernel pass cannot keep its order"
                    )
                reads.append(read)
        return Loop(k, stmt, spatial, vb, 1, target, True, reads)
    check_assignment(kb, stmt, vb)
    target, _, lhs_vars = access_offsets(kb, stmt.lhs, spatial)
    lanes = 1 if lhs_vars is None else min(vb, lhs_vars)
    reads: list[Read] = []
    _expr_reads(kb, stmt.rhs, spatial, vb, lanes, reads)
    return Loop(k, stmt, spatial, vb, lanes, target, False, reads)


def _call_read(kb, a, spatial) -> Read:
    name, axes, nvars = access_offsets(kb, a, spatial)
    return Read(a, name, tuple(off for *_, off in axes), FIELD if nvars is None else ALL)


def _expr_reads(kb, expr, spatial, vb, lanes, out):
    """The reads of an expression, as the printers evaluate it."""
    if expr is None or expr.is_Number or isinstance(expr, sympy.Symbol):
        return
    if isinstance(expr, sympy.Indexed):
        name, axes, nvars = access_offsets(kb, expr, spatial)
        offsets = tuple(off for *_, off in axes)
        if nvars is None:
            out.append(Read(expr, name, offsets, FIELD))
            return
        take = nvars if vb is None else min(vb, nvars)
        if take == lanes:
            mode = LANE
        elif take == 1 or lanes == 1:
            mode = VAR0
        else:
            raise LoweringError(
                f"{expr} reads {take} variables where the statement writes {lanes}"
            )
        out.append(Read(expr, name, offsets, mode))
        return
    if isinstance(expr, AppliedUndef):
        for a in expr.args:
            if isinstance(a, sympy.Indexed):
                out.append(_call_read(kb, a, spatial))
        return
    for a in expr.args:
        _expr_reads(kb, a, spatial, vb, lanes, out)


def _targets(kb, lp: Loop, cell, lane):
    if lp.call:
        return [(lp.target, cell, w) for w in range(item_vars(kb, lp.target))]
    return [(lp.target, cell, lane)]


def _read_values(kb, read: Read, cell, lane):
    c = tuple(x + o for x, o in zip(cell, read.offsets))
    if read.mode == LANE:
        return [(read.name, c, lane)]
    if read.mode == ALL:
        return [(read.name, c, w) for w in range(item_vars(kb, read.name))]
    return [(read.name, c, 0)]


def _values_read(kb, lp: Loop, cell, lane):
    for read in lp.reads:
        yield from _read_values(kb, read, cell, lane)


# ------------------------------------------------------ copy propagation


def _propagate_copies(kb, loops: list[Loop]) -> list[Loop]:
    alias: dict = {}  # (X, cell, var) -> Y: X's value there is Y's
    users: dict = {}  # (Y, cell, var) -> the keys of alias that name it
    out = []
    for lp in loops:
        rename = {}
        for access in {r.access for r in lp.reads}:
            uses = [r for r in lp.reads if r.access == access]
            roots = {alias.get(v) for r in uses for cell, lane in lp.elements()
                     for v in _read_values(kb, r, cell, lane)}
            root = roots.pop() if len(roots) == 1 else None
            name = uses[0].name
            # Never onto the statement's own target: its writes would race
            # with its reads.
            if (root is not None and root != lp.target
                    and kb.item_struct[root] == kb.item_struct[name]):
                rename[access] = kb.all_items[root][access.indices]
        if rename:
            lp = _renamed(kb, lp, rename)
        for cell, lane in lp.elements():
            for t in _targets(kb, lp, cell, lane):
                alias.pop(t, None)
                for key in users.pop(t, ()):
                    alias.pop(key, None)
        src = _copy_source(kb, lp)
        if src is not None:
            for cell, lane in lp.elements():
                root = alias.get((src, cell, lane), src)
                alias[(lp.target, cell, lane)] = root
                users.setdefault((root, cell, lane), set()).add((lp.target, cell, lane))
        out.append(lp)
    return out


def _copy_source(kb, lp: Loop):
    """The item a plain copy ``X[0] = Y[0]`` reads, else None."""
    if lp.call or not isinstance(lp.stmt.rhs, sympy.Indexed) or len(lp.reads) != 1:
        return None
    read = lp.reads[0]
    if kb.item_struct[read.name] != kb.item_struct[lp.target]:
        return None
    lhs_offsets_zero = all(i == j for i, j in zip(lp.stmt.lhs.indices, read.access.indices))
    if read.name == lp.target or any(read.offsets) or not lhs_offsets_zero:
        return None
    return read.name if read.mode in (LANE, FIELD) else None


def _renamed(kb, lp: Loop, rename: dict) -> Loop:
    stmt = lp.stmt
    if lp.call:
        out = kb.functions[type(stmt.lhs).__name__].out_param
        args = [a if i == out else rename.get(a, a) for i, a in enumerate(stmt.lhs.args)]
        stmt = dataclasses.replace(stmt, lhs=stmt.lhs.func(*args))
    else:
        stmt = dataclasses.replace(stmt, rhs=stmt.rhs.xreplace(rename))
    reads = [dataclasses.replace(r, access=rename[r.access], name=str(rename[r.access].base.label))
             if r.access in rename else r for r in lp.reads]
    return dataclasses.replace(lp, stmt=stmt, reads=reads)


# ---------------------------------------------------------------- boxes


def _box_cells(box):
    return itertools.product(*(range(lo, hi) for lo, hi in box))


def _bbox(cells) -> tuple:
    axes = list(zip(*cells))
    return tuple((min(a), max(a) + 1) for a in axes)


def box_size(box) -> int:
    n = 1
    for lo, hi in box:
        n *= hi - lo
    return n


def boxes_of(cells) -> list:
    """A deterministic cover of a cell set by disjoint boxes: from the
    smallest cell left, grow along the last axis, then the earlier ones."""
    left = set(cells)
    out = []
    while left:
        start = min(left)
        box = [(x, x + 1) for x in start]
        for d in reversed(range(len(start))):
            while True:
                grown = list(box)
                grown[d] = (box[d][0], box[d][1] + 1)
                layer = list(box)
                layer[d] = (box[d][1], box[d][1] + 1)
                if all(c in left for c in _box_cells(layer)):
                    box = grown
                else:
                    break
        box = tuple(box)
        left.difference_update(_box_cells(box))
        out.append(box)
    return out


def pieces(elements) -> tuple:
    """``((box, (lo, hi)), ...)``: a set of ``(cell, lane)`` elements (or of
    ``(cell, var)`` pairs) as boxes of cells, each with a contiguous range."""
    lanes: dict = {}
    for cell, lane in elements:
        lanes.setdefault(cell, set()).add(lane)
    by_range: dict = {}
    for cell, ls in lanes.items():
        ls = sorted(ls)
        start = ls[0]
        for a, b in zip(ls, ls[1:] + [None]):
            if b != a + 1:
                by_range.setdefault((start, a + 1), set()).add(cell)
                start = b
    return tuple((box, rng) for rng in sorted(by_range) for box in boxes_of(by_range[rng]))


# --------------------------------------------------------------- phases


def _local(reader: Loop, writer: Loop, item: str) -> bool:
    """Whether every value of ``item`` that passes between the two loops,
    run fused over the same elements, stays in its thread."""
    if reader.pieces != writer.pieces:
        return False
    single = reader.lanes == 1 and writer.lanes == 1
    for r in reader.reads:
        if r.name != item:
            continue
        if any(r.offsets) or not (single or (r.mode == LANE and not writer.call)):
            return False
    return True


def _conflict(a: Loop, b: Loop):
    """``None`` if ``b`` may run beside ``a`` in one phase with no barrier;
    ``"local"`` if only fused over the same elements; ``"barrier"`` else."""
    a_reads = {r.name for r in a.reads}
    b_reads = {r.name for r in b.reads}
    kinds = []
    if a.target in b_reads:
        kinds.append(_local(b, a, a.target))
    if b.target in a_reads:
        kinds.append(_local(a, b, b.target))
    if a.target == b.target:
        kinds.append(a.pieces == b.pieces and (not (a.call or b.call) or
                                                a.lanes == b.lanes == 1))
    if not kinds:
        return None
    return "local" if all(kinds) else "barrier"


def _phases(loops: list[Loop]) -> list:
    """Barrier phases of fused groups.  A statement joins the open phase if
    no value crosses threads between it and the phase's statements; with a
    conflict that stays in its thread it joins the last group (same
    elements), and with none the first group over its elements (it may run
    in any order with the phase's statements), else a group of its own."""
    phases: list = []
    for lp in loops:
        phase = phases[-1] if phases else None
        kinds = set()
        if phase is not None:
            for group in phase:
                for other in group:
                    c = _conflict(other, lp)
                    if c == "local" and group is not phase[-1]:
                        c = "barrier"
                    kinds.add(c)
        if phase is None or "barrier" in kinds:
            phases.append([[lp]])
        elif "local" in kinds:
            phase[-1].append(lp)
        else:
            same = [group for group in phase if group[0].pieces == lp.pieces]
            if same:
                same[0].append(lp)
            else:
                phase.append([lp])
    return phases
