"""Statement records produced by the KernelBuilder front end.

Copy of ``exahype_tpu/frontend/statements.py`` (the port imports nothing of
the JAX package).

The reference keeps four parallel lists — ``LHS``, ``RHS``, ``directions``,
``struct_inclusion`` (``exahype/KernelBuilder.py:81-84``) — as its entire
intermediate representation of a kernel.  Here each entry is a proper record;
the KernelBuilder still exposes the parallel lists as views for API parity.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import sympy


class StatementKind(enum.Enum):
    #: A nested-loop assignment or bare call (the common case).
    LOOP = "loop"
    #: A scalar assignment of a directional constant before a directional
    #: sweep (emitted flat, outside any loop: ``normal = 0;`` in the golden
    #: kernel, ``Unit test/test.cpp:20``).
    CONST_ASSIGN = "const_assign"


@dataclasses.dataclass(frozen=True)
class Statement:
    """One kernel statement with its loop metadata.

    ``lhs``/``rhs`` are fully index-injected SymPy expressions (every array
    access carries explicit ``patch, i, j[, k][, var]`` indices with any
    directional offset applied).  ``rhs`` is ``None`` for bare call statements
    such as ``Flux(Q, normal, F)`` whose result is written through an output
    pointer parameter.

    ``direction`` encoding follows the reference (``exahype/KernelBuilder.py:
    157-160``): ``-2`` = write-back to the kernel input (interior only),
    ``-1`` = non-directional, ``1..dim`` = directional sweep along x/y/z.

    ``struct_inclusion`` encoding (``exahype/KernelBuilder.py:144-155``):
    ``-1`` = not applicable (const assign), ``0`` = no var loop, ``1`` = loop
    ``n_real`` variables, ``2`` = loop ``n_real + n_aux``.
    """

    lhs: sympy.Basic
    rhs: Optional[sympy.Basic]
    direction: int
    struct_inclusion: int
    kind: StatementKind = StatementKind.LOOP
    #: Framework extension: when set, the var-loop level is taken from this
    #: value directly, bypassing the reference's min-over-mentioned-items
    #: rule (which cannot express e.g. "full-struct update that reads a
    #: scalar wave-speed field" — the reason the reference's own Rusanov
    #: dissipation only updates variable 0, ``Unit test/test.cpp:80-103``).
    force_struct: Optional[int] = None

    def exprs(self) -> tuple[sympy.Basic, ...]:
        return (self.lhs,) if self.rhs is None else (self.lhs, self.rhs)

    @property
    def indexed_base_names(self) -> frozenset[str]:
        """Names of every array (IndexedBase) read or written by the statement."""
        names: set[str] = set()
        for expr in self.exprs():
            for atom in expr.atoms(sympy.tensor.indexed.IndexedBase):
                names.add(str(atom.label))
        return frozenset(names)

    def self_referencing_stencil(self, spatial_names: tuple[str, ...]) -> bool:
        """True if the RHS reads the LHS array at a shifted spatial index.

        Such statements are order-dependent: the reference's sequential C
        loops give them Gauss-Seidel semantics (reads see already-updated
        elements), which a vectorized evaluation cannot reproduce.  The
        vectorized backends reject them (write to a copy item instead).
        """
        if self.rhs is None or not isinstance(self.lhs, sympy.Indexed):
            return False
        name = str(self.lhs.base.label)
        spatial = set(spatial_names)
        for access in self.rhs.atoms(sympy.Indexed):
            if str(access.base.label) != name:
                continue
            for idx in access.indices:
                if isinstance(idx, (sympy.Symbol, sympy.Idx)):
                    continue
                if any(str(s) in spatial for s in idx.free_symbols):
                    return True
        return False

    def has_spatial_offset(self, spatial_names: tuple[str, ...]) -> bool:
        """True if any array access shifts a spatial index (e.g. ``i+1``).

        This is the tree-level equivalent of the reference CPPPrinter's
        string scan for ``'i +'``/``'i -'`` etc. (``CPPPrinter.py:114``).
        """
        spatial = set(spatial_names)
        for expr in self.exprs():
            for access in expr.atoms(sympy.Indexed):
                for idx in access.indices:
                    if isinstance(idx, (sympy.Symbol, sympy.Idx)):
                        continue
                    if any(str(s) in spatial for s in idx.free_symbols):
                        return True
        return False

    def spatial_offset_reach(
        self, spatial_names: tuple[str, ...]
    ) -> dict[str, tuple[int, int]]:
        """Per spatial index: the statement's (max negative, max positive)
        constant shift over all array accesses — the data the statement
        actually reaches, from which the sound bounds policy derives the
        widest valid loop region (``halo_size`` > max |offset| leaves halo
        rings usable by multi-stage stencils such as MUSCL)."""
        reach = {name: (0, 0) for name in spatial_names}
        for expr in self.exprs():
            for access in expr.atoms(sympy.Indexed):
                for idx in access.indices:
                    if isinstance(idx, (sympy.Symbol, sympy.Idx)):
                        continue
                    for sym in idx.free_symbols:
                        name = str(sym)
                        if name not in reach:
                            continue
                        off = sympy.simplify(idx - sym)
                        if off.is_number:
                            o = int(off)
                            neg, pos = reach[name]
                            reach[name] = (
                                max(neg, -o) if o < 0 else neg,
                                max(pos, o) if o > 0 else pos,
                            )
        return reach
