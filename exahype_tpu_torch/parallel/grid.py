"""Patch grid in the SoA-P layout, and its halo exchange.

Port of ``exahype_tpu/parallel/grid.py::TpuPatchGrid``: the state is
``[*extent, n_vars, *grid_shape]``, patch lanes last and split into their
grid axes, which the spec kernel consumes as they are, as one flat patch
count (the grid axes are trailing and contiguous).  ``halo_fill`` copies
each neighbour's interior edge slab into the local halo padding, axis by
axis in the JAX package's order, so edge and corner halos come out the
same.  It is plain PyTorch, as it is plain XLA in the JAX package.

It writes the halo slabs of the state in place with ``copy_``, from the
state's own interior slabs, which moves each slab once instead of building
the rolled copies ``jnp.roll`` makes.  The slabs read on an axis are
disjoint from those written on it when ``patch_size >= halo_size``; a
narrower patch copies the slabs it reads first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

from exahype_tpu_torch.utils.config import KernelConfig
from exahype_tpu_torch.utils.errors import SemanticError

Boundary = Literal["periodic", "reflective"]


def _axis_slice(ndim: int, axes: dict) -> tuple:
    sl = [slice(None)] * ndim
    for axis, rng in axes.items():
        sl[axis] = slice(*rng)
    return tuple(sl)


@dataclasses.dataclass(frozen=True)
class TpuPatchGrid:
    """A Cartesian arrangement of patches in the SoA-P layout.

    ``boundary="reflective"`` mirrors the interior into the domain-face
    halos after each axis's exchange: a symmetry (slip, zero-gradient)
    boundary.  The JAX grid's ``reflect_fn`` ghost transform is not ported.
    """

    config: KernelConfig
    grid_shape: tuple[int, ...]
    boundary: Boundary = "periodic"

    def __post_init__(self):
        if len(self.grid_shape) != self.config.dim:
            raise SemanticError(
                f"grid_shape {self.grid_shape} must have {self.config.dim} axes"
            )
        if self.config.n_patches != math.prod(self.grid_shape):
            raise SemanticError(
                f"config.n_patches ({self.config.n_patches}) must equal "
                f"prod(grid_shape) ({math.prod(self.grid_shape)})"
            )
        if self.boundary not in ("periodic", "reflective"):
            raise SemanticError(
                f"boundary must be 'periodic' or 'reflective', got {self.boundary!r}"
            )

    @property
    def state_shape(self) -> tuple[int, ...]:
        cfg = self.config
        return (cfg.extent,) * cfg.dim + (cfg.n_vars,) + tuple(self.grid_shape)

    def halo_fill(self, Q):
        """Fill every patch's halo padding from its grid neighbours, in
        place; returns ``Q``."""
        cfg = self.config
        h, P = cfg.halo_size, cfg.patch_size
        if h == 0:
            return Q
        nd = Q.dim()
        for d in range(cfg.dim):
            s, g = d, cfg.dim + 1 + d  # spatial axis, grid axis
            hi_src = Q[_axis_slice(nd, {s: (P, P + h)})]   # → the next patch's low halo
            lo_src = Q[_axis_slice(nd, {s: (h, 2 * h)})]   # → the previous one's high halo
            if P < h:
                hi_src, lo_src = hi_src.clone(), lo_src.clone()
            n = Q.shape[g]
            lo_halo = Q[_axis_slice(nd, {s: (0, h)})]
            hi_halo = Q[_axis_slice(nd, {s: (P + h, P + 2 * h)})]
            # Periodic roll by +1 (low halos) and -1 (high halos) along g.
            lo_halo[_axis_slice(nd, {g: (1, n)})].copy_(hi_src[_axis_slice(nd, {g: (0, n - 1)})])
            lo_halo[_axis_slice(nd, {g: (0, 1)})].copy_(hi_src[_axis_slice(nd, {g: (n - 1, n)})])
            hi_halo[_axis_slice(nd, {g: (0, n - 1)})].copy_(lo_src[_axis_slice(nd, {g: (1, n)})])
            hi_halo[_axis_slice(nd, {g: (n - 1, n)})].copy_(lo_src[_axis_slice(nd, {g: (0, 1)})])
            if self.boundary == "reflective":
                self._reflect(Q, d)
        return Q

    def _reflect(self, Q, d: int) -> None:
        """Mirror the interior into the outer faces of the domain boundary
        along ``d``, in place."""
        cfg = self.config
        h, P = cfg.halo_size, cfg.patch_size
        nd = Q.dim()
        s, g = d, cfg.dim + 1 + d
        n_g = self.grid_shape[d]
        interior_lo = Q[_axis_slice(nd, {g: (0, 1), s: (h, 2 * h)})].flip(s)
        interior_hi = Q[_axis_slice(nd, {g: (n_g - 1, n_g), s: (P, P + h)})].flip(s)
        Q[_axis_slice(nd, {g: (0, 1), s: (0, h)})].copy_(interior_lo)
        Q[_axis_slice(nd, {g: (n_g - 1, n_g), s: (P + h, P + 2 * h)})].copy_(interior_hi)
