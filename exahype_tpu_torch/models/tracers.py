"""Tracer particles: probes that sample a DG solution and advect through it
(PyTorch).

Port of ``exahype_tpu/models/tracers.py`` (``_lagrange_basis``,
``euler_velocity``, ``TracerAdvector``, ``uniform_tracers``): particle
positions are a dense ``[n_particles, dim]`` tensor; locating the owning
cell is a floor division, reading its ``(order+1)^dim`` nodal values is one
gather along the flat grid axis of the SoA-P state, and evaluating the
cell's polynomial at the particle is a Lagrange-basis contraction per
axis.  Nothing leaves the device, so a sample inside a time loop costs no
host synchronisation.  Advection is explicit RK2 (midpoint) through the
frozen start-of-step field.  The domain's constants (extents, cell
widths, grid shape) are made once per dtype and device: a tensor made from
host data would cost a synchronising copy each call.

Interpolation uses the owning cell's polynomial only (the DG solution is
discontinuous across faces), exact for polynomials up to the scheme's
order.  The operation order is the JAX module's, except in the Lagrange
basis (one masked product over all nodes, where JAX multiplies factor by
factor): the two agree to rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


def _lagrange_basis(nodes, xi):
    """``B[..., i] = ℓ_i(xi[...])`` for local coordinates ``xi`` ∈ [0, 1]
    (a tensor of any shape) and the 1-D ``nodes`` (a tensor in ``xi``'s
    dtype on its device): one broadcast difference, then the product over
    the other nodes with the i-th factor masked to 1, over the same
    product of node differences.  A handful of launches for every axis at
    once, where a loop over node pairs costs ~n² per axis."""
    n = nodes.shape[0]
    others = ~torch.eye(n, dtype=torch.bool, device=xi.device)
    num = torch.where(others, xi[..., None, None] - nodes, 1.0).prod(-1)
    den = torch.where(others, nodes[:, None] - nodes, 1.0).prod(-1)
    return num / den


def euler_velocity(dim: int):
    """``velocity_fn`` for compressible Euler: v = momentum / density."""

    def velocity(vals):
        return vals[:, 1:1 + dim] / vals[:, 0:1]

    return velocity


@dataclasses.dataclass(frozen=True)
class TracerAdvector:
    """Samples and advects tracer particles through a DG solution.

    ``solver``: any SoA-P-layout DG solver (``dim``, ``n_nodes``,
    ``n_vars``, ``grid_shape``, ``_dxs``, ``ops``; a ``CudaADERDG`` is
    unwrapped through its ``.solver``).  ``velocity_fn``: ``vals[P,
    n_vars] -> v[P, dim]``.  ``boundary``: ``"periodic"`` wraps positions
    across the domain, ``"clamp"`` clips them to its interior.
    """

    solver: object
    velocity_fn: Callable
    boundary: str = "periodic"

    def __post_init__(self):
        solver = getattr(self.solver, "solver", self.solver)
        object.__setattr__(self, "solver", solver)
        if self.boundary not in ("periodic", "clamp"):
            raise SemanticError(
                f"boundary must be 'periodic' or 'clamp', got {self.boundary!r}"
            )
        if solver.var_axis != solver.dim:
            raise SemanticError(
                "TracerAdvector requires the SoA-P layout "
                "(node axes, var axis, grid axes)"
            )
        object.__setattr__(self, "_nodes", np.asarray(solver.ops.nodes))
        object.__setattr__(self, "_consts", {})

    def _const(self, name: str, like):
        """The constant ``name`` (``"extents"``, ``"eps"``, ``"dxs"``,
        ``"nodes"`` in ``like``'s dtype, ``"grid"`` int64) on ``like``'s
        device, made once."""
        key = (name, like.dtype, like.device)
        if key not in self._consts:
            values = {
                "extents": self.extents,
                "eps": [np.finfo(np.float32).eps * e for e in self.extents],
                "dxs": self.solver._dxs,
                "grid": self.solver.grid_shape,
                "nodes": self._nodes,
            }[name]
            dtype = torch.int64 if name == "grid" else like.dtype
            self._consts[key] = torch.as_tensor(values, dtype=dtype, device=like.device)
        return self._consts[key]

    # ------------------------------------------------------------- geometry

    @property
    def dim(self) -> int:
        return self.solver.dim

    @property
    def extents(self) -> tuple[float, ...]:
        """Physical domain size per axis (grid cells × cell width)."""
        return tuple(g * d for g, d in zip(self.solver.grid_shape, self.solver._dxs))

    def _wrap(self, x):
        ext = self._const("extents", x)
        if self.boundary == "periodic":
            return torch.remainder(x, ext)
        # Clamp strictly inside so floor() lands on a real cell.
        return torch.minimum(torch.clamp(x, min=0.0), ext - self._const("eps", x))

    def _locate(self, x):
        """Owning cell indices ``[P, dim]`` (int64) and local coordinates
        ξ ∈ [0, 1] ``[P, dim]``."""
        s = x / self._const("dxs", x)
        c = torch.floor(s)
        xi = s - c
        g = self._const("grid", x)
        c = c.to(torch.int64)
        if self.boundary == "periodic":
            c = torch.remainder(c, g)
        else:
            c = torch.minimum(torch.clamp(c, min=0), g - 1)
        return c, xi

    # ------------------------------------------------------------- sampling

    def sample(self, u, x):
        """The DG solution at positions ``x[P, dim]`` → ``[P, n_vars]``: one
        gather along the flat grid axis, then per-axis Lagrange
        contractions."""
        solver = self.solver
        # Normalise into the domain first so clamp mode lands on the edge
        # cell with ξ at the edge.
        c, xi = self._locate(self._wrap(torch.as_tensor(x, device=u.device)))
        flat = c[:, 0]
        for d in range(1, self.dim):
            flat = flat * solver.grid_shape[d] + c[:, d]
        outer = tuple(u.shape[:self.dim + 1])  # node axes + var axis
        qc = u.reshape(outer + (-1,)).index_select(-1, flat)  # [n.., V, P]
        basis = _lagrange_basis(self._const("nodes", xi), xi).to(u.dtype)  # [P, dim, n]
        if self.dim == 1:
            return torch.einsum("pa,avp->pv", basis[:, 0], qc)
        if self.dim == 2:
            return torch.einsum("pa,pb,abvp->pv", basis[:, 0], basis[:, 1], qc)
        return torch.einsum("pa,pb,pc,abcvp->pv", basis[:, 0], basis[:, 1], basis[:, 2], qc)

    # ------------------------------------------------------------ advection

    def velocity(self, u, x):
        """Advecting velocity at positions ``x`` → ``[P, dim]``."""
        return self.velocity_fn(self.sample(u, x))

    def advect(self, u, x, dt):
        """One RK2 (midpoint) step of the positions through the frozen
        field ``u``."""
        x = torch.as_tensor(x, device=u.device)
        v1 = self.velocity(u, x)
        xm = self._wrap((x + (0.5 * dt) * v1).to(x.dtype))
        v2 = self.velocity(u, xm)
        return self._wrap((x + dt * v2).to(x.dtype))

    # ------------------------------------------------------------ recording

    def trajectories(self, step_fn, u, x, dt, n_steps: int):
        """Advance solver and tracers together (tracers through the
        start-of-step field, then the field), recording after each step.
        Returns ``(u_final, x_final, xs[n_steps, P, dim], vals[n_steps, P,
        n_vars])``, the records stacked on the device."""
        x = torch.as_tensor(x, device=u.device)
        xs, vals = [], []
        for _ in range(n_steps):
            x_new = self.advect(u, x, dt)
            vals.append(self.sample(u, x_new))
            xs.append(x_new)
            u, x = step_fn(u, dt), x_new
        return u, x, torch.stack(xs), torch.stack(vals)


def uniform_tracers(extents: Sequence[float], counts: Sequence[int],
                    dtype=torch.float32, device=None):
    """Regular lattice of tracer seeds, cell-centre style (no particle on
    the domain boundary), on ``device`` (None: the card)."""
    axes = [(np.arange(n) + 0.5) * (e / n) for e, n in zip(extents, counts)]
    grids = np.meshgrid(*axes, indexing="ij")
    return torch.as_tensor(np.stack([g.ravel() for g in grids], axis=-1), dtype=dtype,
                           device=resolve_device(device))
