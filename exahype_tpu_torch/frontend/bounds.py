"""The single authoritative loop-bounds function.

Copy of ``exahype_tpu/frontend/bounds.py`` (the port imports nothing of the
JAX package); both of the port's printers take their ranges from here.

The reference computes loop bounds in two subtly different places:

- ``exahype/printers/MLIRPrinter.py:115-132`` — the logic that actually
  produced the golden kernel ``Unit test/test.cpp`` (directional sweeps trim
  the *swept* axis to the interior and keep transverse axes full; the
  non-directional copy keeps every axis full; write-backs to the kernel input
  trim every axis);
- ``exahype/printers/CPPPrinter.py:109-137`` — a later drift of the same
  logic (directional sweeps keep the swept axis full unless the statement
  contains a stencil offset, non-directional statements trim, and the final
  statement's LHS forces trimming).

The two disagree, which is exactly the kind of latent inconsistency this
rebuild must not replicate (SURVEY.md §7 "hard parts").  Worse, BOTH are
unsound at patch edges:

- under "golden", a directional flux evaluation trims the swept axis to the
  interior, but the stencil update then reads the flux at ``i±1`` over the
  full extent — the edge reads hit array elements no statement ever wrote
  (uninitialized ``new[]`` memory in the reference's generated C++,
  ``Unit test/test.cpp:24-27`` vs ``:66-69``);
- under "cpp", the non-directional copy trims, so flux evaluations read
  uninitialized ``Q_copy`` halo cells instead.

This module keeps one rule, the JAX package's ``"sound"`` policy (its
``"golden"`` and ``"cpp"`` policies reproduce the reference printers for
parity studies; no path of the port runs them): pointwise directional
evaluations (no stencil offset) cover the full halo-padded extent, stencil
updates trim only the swept axis, non-directional statements stay full,
write-backs to the kernel input trim everywhere.  Every read is then a
written (or input) element.
"""

from __future__ import annotations

from typing import Mapping, Optional

from exahype_tpu_torch.frontend.statements import Statement
from exahype_tpu_torch.utils.config import KernelConfig

#: Half-open range.
Range = tuple[int, int]


def var_range(
    cfg: KernelConfig, stmt: Statement, item_struct: Mapping[str, int]
) -> Range:
    """Range of the innermost ``var`` loop.

    Both reference printers take the minimum struct level over every item
    mentioned in the statement plus the statement's own ``struct_inclusion``
    (``MLIRPrinter.py:118-126``, ``CPPPrinter.py:119-126``); a minimum of 0
    collapses the var loop to a single iteration (the pointer-call case).
    """
    if stmt.force_struct is not None:
        m = stmt.force_struct
    else:
        levels = [
            item_struct[name]
            for name in stmt.indexed_base_names
            if name in item_struct
        ]
        levels.append(stmt.struct_inclusion)
        m = min(levels)
    if m <= 0:
        return (0, 1)
    if m == 1:
        return (0, cfg.n_real)
    return (0, cfg.n_vars)


def spatial_range(
    cfg: KernelConfig,
    level: int,
    direction: int,
    *,
    has_offset: bool = False,
    offset_reach: Optional[tuple[int, int]] = None,
) -> Range:
    """Range of spatial loop level ``level`` (1-based: 1=i/x, 2=j/y, 3=k/z).

    ``direction`` uses the statement encoding (-2 write-back, -1 none,
    1..dim sweep axis).  ``offset_reach`` is the statement's actual
    (negative, positive) shift extent on this level, when known.
    """
    full: Range = (0, cfg.extent)
    trimmed: Range = cfg.interior
    if direction == -2:
        return trimmed  # write-back: interior only
    if direction >= 1 and level == direction and has_offset:
        # Widest valid region: trim each side by the statement's own
        # reach, never wider than the stored halo allows.  With
        # halo_size == max|offset| (every reference spec) this equals
        # the interior; a larger halo leaves rings for multi-stage
        # stencils (e.g. MUSCL's slope → face-flux → update chain).
        if offset_reach is not None:
            neg, pos = offset_reach
            if neg == 0 and pos == 0:
                # Offsets exist but not as constants on this axis
                # (e.g. a symbolic shift): stay conservative.
                return trimmed
            return (neg, cfg.extent - pos)
        return trimmed  # stencil update: swept axis needs neighbours
    return full


def statement_ranges(
    cfg: KernelConfig,
    stmt: Statement,
    item_struct: Mapping[str, int],
) -> tuple[Range, ...]:
    """Half-open loop ranges for a statement, outermost first.

    Returns ``dim + 2`` ranges aligned with ``cfg.index_names``:
    ``(patch, i, j[, k], var)``.
    """
    has_offset = stmt.has_spatial_offset(cfg.spatial_index_names)
    reach = (
        stmt.spatial_offset_reach(cfg.spatial_index_names)
        if has_offset
        else None
    )
    ranges: list[Range] = [(0, cfg.n_patches)]
    for level in range(1, cfg.dim + 1):
        level_reach = (
            reach.get(cfg.spatial_index_names[level - 1])
            if reach is not None
            else None
        )
        ranges.append(
            spatial_range(
                cfg,
                level,
                stmt.direction,
                has_offset=has_offset,
                offset_reach=level_reach,
            )
        )
    ranges.append(var_range(cfg, stmt, item_struct))
    return tuple(ranges)
