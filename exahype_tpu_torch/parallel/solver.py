"""Grid solver: the time-integration driver over a patch grid.

Port of ``exahype_tpu/parallel/solver.py::GridSolver`` on its SoA-P
(``backend="pallas"``) path:

    halo_fill (neighbour exchange)
      → the spec kernel on the grid-native state (K4, generated CUDA)
      → optional CFL dt from the global max wave speed

The kernel is :class:`~exahype_tpu_torch.backends.cuda_backend.CudaPrinter`'s
wrapper: it launches the generated kernel for a CUDA state and runs the
plain PyTorch version for a CPU state.  ``step`` updates the state in place;
``run`` is a Python loop over a copy of its input, with ``dt`` kept on the
device (no ``.item()`` per step).
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import torch

from exahype_tpu_torch.backends.cuda_backend import CudaPrinter
from exahype_tpu_torch.frontend.kernel_builder import KernelBuilder
from exahype_tpu_torch.parallel.grid import TpuPatchGrid
from exahype_tpu_torch.utils.device import resolve_device
from exahype_tpu_torch.utils.errors import SemanticError


class GridSolver:
    """Drives a patch-update kernel over a :class:`TpuPatchGrid`.

    ``eigenvalue_fn(interior) -> wave speeds`` (the grid's layout) enables
    CFL-controlled dt; omit it for fixed-dt stepping.  ``kernel_dt`` says
    what the kernel's scalar means: the physical dt (the canonical spec,
    ``models/rusanov.py``) or λ = dt/dx (``models/fv.py``).  The state lives
    on ``device`` (the CUDA card when None; ``device="cpu"`` for the CPU) in
    ``dtype``.
    """

    def __init__(
        self,
        grid: TpuPatchGrid,
        kernel: KernelBuilder,
        dx: float = 1.0,
        cfl: float = 0.45,
        eigenvalue_fn: Optional[Callable] = None,
        kernel_dt: Literal["physical", "lambda"] = "physical",
        *,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        if not isinstance(grid, TpuPatchGrid):
            raise SemanticError("GridSolver requires a TpuPatchGrid")
        if grid.config != kernel.config:
            raise SemanticError(
                f"grid config {grid.config} differs from the kernel's {kernel.config}"
            )
        if kernel_dt not in ("physical", "lambda"):
            raise SemanticError(
                f"kernel_dt must be 'physical' or 'lambda', got {kernel_dt!r}"
            )
        self.grid = grid
        self.kernel = kernel
        self.dx = dx
        self.cfl = cfl
        self.eigenvalue_fn = eigenvalue_fn
        self.kernel_dt = kernel_dt
        self.device = resolve_device(device)
        self.dtype = dtype
        #: The patch-update callable (a ``CudaSpecKernel``); its
        #: ``launches`` counts kernel launches, its ``plain`` is the plain
        #: version.
        self.kernel_fn = CudaPrinter(kernel).build()

    # ------------------------------------------------------------------ step

    def _check(self, Q) -> None:
        if Q.device != self.device or Q.dtype != self.dtype:
            raise SemanticError(
                f"state on {Q.device} in {Q.dtype}; this solver runs on "
                f"{self.device} in {self.dtype}"
            )
        if tuple(Q.shape) != self.grid.state_shape:
            raise SemanticError(
                f"state shape {tuple(Q.shape)} != {self.grid.state_shape}"
            )

    def step(self, Q, dt):
        """One halo-exchange + patch-update step of the grid-shaped state,
        in place; returns ``Q``."""
        self._check(Q)
        kdt = dt / self.dx if self.kernel_dt == "lambda" else dt
        self.grid.halo_fill(Q)
        return self.kernel_fn(Q, kdt)

    def _interior(self, Q):
        cfg = self.grid.config
        h = cfg.halo_size
        out = Q
        for d in range(cfg.dim):
            sl = [slice(None)] * Q.dim()
            sl[d] = slice(h, h + cfg.patch_size)
            out = out[tuple(sl)]
        return out

    def compute_dt(self, Q):
        """CFL time step from the global maximum wave speed, as a 0-d
        tensor on the state's device."""
        if self.eigenvalue_fn is None:
            raise ValueError("GridSolver needs eigenvalue_fn for adaptive dt")
        lam = torch.max(self.eigenvalue_fn(self._interior(Q)))
        return self.cfl * self.dx / lam

    def run(self, Q, n_steps: int, dt=None):
        """Integrate ``n_steps`` from a copy of ``Q``; returns ``(state, t)``.

        Fixed ``dt`` if given, else the CFL dt of each step's state."""
        self._check(Q)
        Q = Q.clone()
        t = torch.zeros((), dtype=Q.dtype, device=Q.device)
        for _ in range(n_steps):
            step_dt = self.compute_dt(Q) if dt is None else dt
            Q = self.step(Q, step_dt)
            t = t + step_dt
        return Q, t

    def dofs(self) -> int:
        """Interior degrees of freedom updated per step (real vars only)."""
        return self.grid.config.dofs()
