"""Point sources: Dirac-delta forcing with a source-time function (PyTorch).

Port of ``exahype_tpu/models/point_source.py`` (``ricker``,
``PointSources``): the delta is represented by its nodal coefficients under
the solver's diagonal mass matrix, per axis ℓ_i(ξ₀)/(w_i·dx), the exact
weak-form projection (testing the deposit against any polynomial up to the
scheme's degree gives point evaluation); time integration is split-step
(Strang): half the time-integrated wavelet is injected before the solver
step and half after, the wavelet's integral over each half step taken by
Gauss–Legendre quadrature of the scheme's order.

The deposit adds each source's nodal block into its owning cell only
(``index_add_`` along the flat grid axis), where the JAX module adds a
whole state-sized field that is zero outside the sources' cells.  The two
give the same values; they differ only in signed zeros: JAX's ``u + 0``
turns a ``-0.0`` of ``u`` outside the sources' cells into ``+0.0``, and
here it stays ``-0.0``.  Two sources in one cell add in the order the
index's backend takes (on the card atomics, in no fixed order).  The
blocks' geometry is computed once per dtype and device; positions,
amplitudes and the wavelet stay data, and nothing is read back to the
host, so an injection inside a time loop costs no host synchronisation.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from exahype_tpu_torch.models.tracers import _lagrange_basis
from exahype_tpu_torch.utils.errors import SemanticError


def ricker(f0: float, t_delay: float | None = None):
    """Ricker (Mexican-hat) wavelet of peak frequency ``f0``, centred at
    ``t_delay`` (default 1/f0, so it starts near zero).  ``psi(t)`` takes a
    tensor of times; ``psi.f0`` and ``psi.t_delay`` name it."""
    if t_delay is None:
        t_delay = 1.0 / f0

    def psi(t):
        a = (math.pi * f0 * (t - t_delay)) ** 2
        return (1.0 - 2.0 * a) * torch.exp(-a)

    psi.f0, psi.t_delay = float(f0), float(t_delay)
    return psi


class PointSources:
    """A set of delta sources for an SoA-P-layout DG solver.

    ``solver``: an ``ADERDGSolver`` (a ``CudaADERDG`` is unwrapped through
    its ``.solver``).  ``positions``: ``[n_sources, dim]`` physical
    locations.  ``amplitudes``: ``[n_sources, n_vars]`` per-variable
    strengths.  ``wavelet``: ``psi(t)`` on a tensor of times, returning a
    tensor of their shape (a wavelet shared by the sources) or with a
    trailing ``n_sources`` axis.
    """

    def __init__(self, solver, positions, amplitudes, wavelet: Callable):
        solver = getattr(solver, "solver", solver)
        pos = np.array(positions, dtype=np.float64)
        amp = np.array(amplitudes, dtype=np.float64)
        if pos.ndim != 2 or pos.shape[1] != solver.dim:
            raise SemanticError(
                f"positions must be [n_sources, {solver.dim}], got {pos.shape}"
            )
        if amp.shape != (pos.shape[0], solver.n_vars):
            raise SemanticError(
                f"amplitudes must be [{pos.shape[0]}, {solver.n_vars}], got {amp.shape}"
            )
        self.solver = solver
        self.positions = pos
        self.amplitudes = amp
        self.wavelet = wavelet
        # The solver's own nodal basis and diagonal mass weights.
        self._nodes = np.asarray(solver.ops.nodes)
        self._weights = np.asarray(solver.ops.weights)
        self._geometry = {}

    # ------------------------------------------------------------ deposit

    def _blocks(self, dtype, device):
        """``(blocks [S, n..], amplitudes [S, V], flat [S], (nodes,
        weights))``: each source's nodal block Π_d ℓ_i(ξ_d)/(w_i·dx_d), its
        amplitudes and its owning cell's index on the flat grid axis,
        computed in ``dtype`` as the JAX ``delta_field`` computes them, and
        the time quadrature, made once per dtype and device."""
        key = (dtype, device)
        if key not in self._geometry:
            solver = self.solver
            dim, n = solver.dim, solver.n_nodes
            n_src = self.positions.shape[0]
            pos = torch.as_tensor(self.positions, device=device).to(dtype)
            dxs = torch.as_tensor(solver._dxs, dtype=dtype, device=device)
            s = pos / dxs
            c = torch.floor(s)
            xi = s - c
            g = torch.as_tensor(solver.grid_shape, device=device)
            c = torch.remainder(c.to(torch.int64), g)
            weights = torch.as_tensor(self._weights, dtype=dtype, device=device)
            nodes = torch.as_tensor(self._nodes, dtype=dtype, device=device)
            basis = _lagrange_basis(nodes, xi)  # [S, dim, n]
            blocks = None
            for d in range(dim):
                b = basis[:, d]
                b = b / (weights * dxs[d])
                b = b.reshape((n_src,) + (1,) * d + (n,) + (1,) * (dim - 1 - d))
                blocks = b if blocks is None else blocks * b
            flat = c[:, 0]
            for d in range(1, dim):
                flat = flat * solver.grid_shape[d] + c[:, d]
            amp = torch.as_tensor(self.amplitudes, device=device).to(dtype)
            # The time quadrature's nodes and weights.
            quad = (nodes, torch.as_tensor(self._weights, dtype=dtype, device=device))
            self._geometry[key] = (blocks, amp, flat, quad)
        return self._geometry[key]

    def _scaled_blocks(self, dtype, device, scale=None):
        """``[S, n.., V]``: the blocks times the amplitudes, each source's
        times its ``scale`` (scalar or ``[n_sources]``)."""
        blocks, amp = self._blocks(dtype, device)[:2]
        n_src, dim = amp.shape[0], self.solver.dim
        if scale is not None:
            ones = torch.ones((n_src,), dtype=dtype, device=device)
            amp = amp * (torch.as_tensor(scale, device=device).to(dtype) * ones).reshape(n_src, 1)
        return blocks.unsqueeze(-1) * amp.reshape((n_src,) + (1,) * dim + (self.solver.n_vars,))

    def delta_field(self, dtype, scale=None):
        """The nodal representation of Σ_s scale_s·amp_s·δ(x − x_s), a
        tensor of the solver's state shape on the solver's device whose
        weak inner product with any test polynomial up to the scheme's
        degree equals point evaluation."""
        solver = self.solver
        n_cells = int(np.prod(solver.grid_shape))
        out = torch.zeros(solver.state_shape[:solver.dim + 1] + (n_cells,), dtype=dtype,
                          device=solver.weights.device)
        return self._deposit(out, scale).reshape(solver.state_shape)

    def _deposit(self, flat_state, scale):
        """Add the scaled blocks into ``flat_state`` (``[n.., V, cells]``),
        each into its owning cell, in place."""
        blocks = self._scaled_blocks(flat_state.dtype, flat_state.device, scale)
        flat = self._blocks(flat_state.dtype, flat_state.device)[2]
        return flat_state.index_add_(-1, flat, torch.movedim(blocks, 0, -1))

    # ------------------------------------------------------------- wavelet

    def _integrate_wavelet(self, t0, dt):
        """∫_{t0}^{t0+dt} ψ by Gauss–Legendre of the scheme's order, in
        ``t0``'s dtype (a tensor, or a Python float taken as float64)."""
        t0 = torch.as_tensor(t0, dtype=t0.dtype if torch.is_tensor(t0) else torch.float64)
        nodes, wq = self._blocks(t0.dtype, t0.device)[3]
        tq = t0 + nodes * dt
        vals = self.wavelet(tq)
        return dt * torch.tensordot(wq, vals, dims=([0], [0]))

    # --------------------------------------------------------------- steps

    def inject(self, u, t0, dt):
        """``u`` plus the sources integrated over [t0, t0 + dt] (a new
        tensor)."""
        return self._inject_(u.clone(memory_format=torch.contiguous_format), t0, dt)

    def _inject_(self, u, t0, dt):
        """:meth:`inject` into the contiguous ``u`` itself."""
        w = self._integrate_wavelet(t0, dt)
        self._deposit(u.view(tuple(u.shape[:self.solver.dim + 1]) + (-1,)), w)
        return u

    def step(self, u, t0, dt, step_fn=None):
        """One Strang-split forced step: inject [t0, t0 + dt/2], advance the
        homogeneous solver (``step_fn(u, dt)``, default the solver's own
        step), inject [t0 + dt/2, t0 + dt].  ``u`` is not modified; the
        second injection adds into the solver's result in place (one state
        copy a step, not two)."""
        if step_fn is None:
            step_fn = self.solver.step
        u = step_fn(self.inject(u, t0, 0.5 * dt), dt)
        return self._inject_(u.contiguous(), t0 + 0.5 * dt, 0.5 * dt)

    def run(self, u, t0, dt, n_steps: int, step_fn=None):
        """``n_steps`` forced steps; returns ``(u, t)``, ``t`` a 0-d tensor
        of ``u``'s dtype on its device (the JAX scan's carry)."""
        t = torch.as_tensor(t0, dtype=u.dtype, device=u.device)
        for _ in range(n_steps):
            u, t = self.step(u, t, dt, step_fn), t + dt
        return u, t
