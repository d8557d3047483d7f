"""ADER-DG step through hand-written CUDA kernels (Hopper, ``sm_90a``).

Port of ``exahype_tpu/models/aderdg_pallas.py::PallasADERDG`` on the
flux-form path at order 3 in 3-D, periodic or with domain walls, for three
physics, and at orders 4, 5 and 7 in 3-D, periodic or with domain walls,
for compressible Euler (``examples/high_order_p5.py``'s step at order 5:
``aderdg_predictor_volume_p5``, the space-time predictor of
``csrc/aderdg_st.cuh`` built by ``csrc/aderdg_p5.cu``, with a thread a space
node and each time slice's fluxes through shared memory, then
``aderdg_face_flux_p5`` and ``aderdg_surface_update_p5``, the face stage's
n = 6 instances, or with walls ``aderdg_face_flux_walls_p5`` and
``aderdg_surface_update_walls_p5``; the same names with ``_p4`` and ``_p7``
at orders 4 and 7, ``csrc/aderdg_p4.cu`` and ``csrc/aderdg_p7.cu`` with the
face stage at n = 5 and 8; the other physics raise at those orders, and
Euler at order 6), and at order 3 in 2-D, periodic or
with walls, for compressible Euler (``examples/limited_blast_walls.py``'s
solver: ``aderdg_predictor_volume_2d``, a thread a space node, and the
face pair ``aderdg_face_flux_2d`` + ``aderdg_surface_update_2d`` or its wall
variant ``aderdg_face_flux_walls_2d`` + ``aderdg_surface_update_walls_2d``,
all of ``csrc/aderdg_2d.cu``; the grid goes to them as (g0, g1, 1)), and
for compressible Navier–Stokes, periodic or with walls in every mode
(``examples/viscous_shock.py``'s and ``examples/navier_stokes_vortex.py``'s
solver, and the no-slip channels and boxes of the JAX package's viscous-wall
tests: ``aderdg_predictor_volume_visc_2d``, on a walled grid its instance
that also writes the viscous-only wall planes, and the face pairs'
Navier–Stokes instances, the same names, the wall pair with the
advective/viscous wall split), also at order 2 (the JAX package's
``PallasADERDG`` Navier–Stokes tests: the same kernels at three nodes an
axis, ``aderdg_predictor_volume_visc_p2_2d``, ``aderdg_face_flux_p2_2d`` +
``aderdg_surface_update_p2_2d``, walled ``aderdg_face_flux_walls_p2_2d`` +
``aderdg_surface_update_walls_p2_2d``; 2-D Euler at order 2 and
Navier–Stokes at order 4 raise).  K2 b,
the homogeneous elasticity on the CK predictor (``models/elastic.py``'s
``elastic`` and ``elastic3d``, ρ, λ, μ compiled in as parameters): in 2-D at
order 3, periodic or walled (``examples/seismic_point_source.py --ck``:
``aderdg_ck_predictor_volume_2d``, the CK predictor of
``csrc/aderdg_ck_nodes.cuh``, a thread a space node, and the 2-D face pairs'
``Elastic2D`` instances), and in 3-D at order 2, periodic
(``aderdg_ck_predictor_volume_p2`` and the face stage's n = 3 instances
``aderdg_face_flux_p2`` + ``aderdg_surface_update_p2``); their other orders,
the 3-D walls and a sponge raise, naming ROADMAP.md Queue 2 K2 b (K2 a).
K2 b.1, the node kernel with frozen slots and the dissipation mask (the
rows from the first frozen slot on carry no flux, keep u's values through
the step and get no jump term): the 12-variable heterogeneous elasticity
at order 2 in 3-D, periodic (``elastic3d_het`` through the ``_p2`` entries,
``tests/test_ck.py:317``'s system), the 8-variable 2-D heterogeneous system
at order 3, periodic or walled (``elastic_het``), and the 10-variable
curvilinear lift of the 2-D elasticity at order 3, periodic
(``curvilinear_elastic``, ``examples/seismic_topography.py``: J and the four
J·a^k_i ride as frozen slots) through the 2-D entries.  At
order 3 in 3-D the physics are: compressible Euler on the Picard predictor (``bench.py::main``),
compressible Navier–Stokes on the Picard predictor with its viscous terms
(``models/navier_stokes.py``) and heterogeneous elasticity on the
Cauchy–Kovalewski predictor with its materials frozen
(``bench.py::bench_ck``), with the absorbing sponge of
``models/elastic.py::sponge_source`` as its source
(``examples/seismic3d_layered.py``'s step: K2 a,
``aderdg_ck_predictor_volume_sponge``, which takes σ per cell as a
``[ncell]`` tensor); and on the pure-NCP path with the fused
right-hand side at order 2 in 3-D, periodic, for the 38-variable vacuum Z4
system (``models/z4.py::make_z4_solver(..., impl="soa", fused_rhs="soa")``,
``scripts/z4_probe.py``) and the 53-variable shifted one
(``make_z4_shift_solver(..., fused_rhs="soa")``, frozen shift or
Gamma-driver, ``scripts/z4_probe.py --shift``); and on the same path with a
conservative flux beside the NCP for the 43-variable coupled Z4+GRHD system
(``models/z4_matter.py::make_z4_matter_solver(..., fused_rhs="soa")``,
``scripts/z4_probe.py --matter``) and the 47-variable coupled Z4+GRMHD one
(``models/z4_grmhd.py::make_z4_grmhd_solver(..., fused_rhs="soa")``); for the
vacuum system also on its per-axis NCP path (``make_z4_solver(...,
fused_rhs=False)``, the JAX package's default: ``ncp_fn`` and ``source_fn``
without ``rhs_all_fn``) in 3-D at order 2, and in 2-D at orders 2 and 3,
fused or per-axis (``examples/z4_gauge_wave.py``); for the Z4+GRHD system
on its per-axis NCP path with its flux (``make_z4_matter_solver(...,
fused_rhs=False)``, the JAX package's default) in 3-D at order 2, and in 2-D
at order 2, fused or per-axis (``examples/flrw_cosmology.py``); and for the
Z4+GRMHD system the same (``make_z4_grmhd_solver(..., fused_rhs=False)``,
the solver every Z4+GRMHD test of the JAX package builds), and for the
shifted system the same (``make_z4_shift_solver(..., fused_rhs=False)``,
frozen shift or Gamma-driver, the solver every shifted test of the JAX
package builds and ``scripts/z4_probe.py --shift`` runs).  The
step is three launches of kernels from ``csrc/aderdg.cu``,
``csrc/aderdg_visc.cu``, ``csrc/aderdg_z4.cu``, ``csrc/aderdg_z4_shift.cu``,
``csrc/aderdg_z4_matter.cu`` and ``csrc/aderdg_z4_grmhd.cu`` (see the notes
there for the design):

- ``aderdg_predictor_volume`` (Picard), ``aderdg_predictor_volume_visc``
  (Picard with the viscous flux from the polynomial's gradients) or
  ``aderdg_ck_predictor_volume`` (CK): predictor, time averages, volume
  integral and the face projections of every axis (the viscous one, on a
  grid with walls, also the viscous-only flux on the wall planes);
- the face stage, two launches: ``aderdg_face_flux`` solves every interface
  once (the Rusanov flux, with the physics' dissipation mask) into a
  face-flux tensor, each cell's high-face fluxes of every axis, which is
  also the limiter's input (the Pallas kernel's ``emit_fused_fhat``
  outputs); ``aderdg_surface_update`` then updates ``new`` in place (on the
  CPU too) from each cell's own and its lower neighbours' entries.  For
  Navier–Stokes the flux kernel adds the Gassner penalty
  2(2N+1)/dx_d·max(κ⁻, κ⁺) to the dissipation speed.

Z4 (``aderdg_predictor_volume_z4``, ``aderdg_face_flux_z4``,
``aderdg_surface_update_z4``; the per-axis predictor
``aderdg_predictor_volume_per_axis_z4``, with the same face pair; in 2-D
``aderdg_predictor_volume_2d_z4``, ``aderdg_predictor_volume_per_axis_2d_z4``,
``aderdg_face_flux_2d_z4`` and ``aderdg_surface_update_2d_z4`` at order 2,
the same with ``_p3_2d_z4`` at order 3, ``csrc/aderdg_z4_per_axis.cu``,
``aderdg_z4_2d.cu`` and ``aderdg_z4_2d_p3.cu``; shifted, the same names with ``_shift``;
Z4+GRHD with ``_matter``, whose predictor also carries the hydro flux's D·F
term, its volume integral and its face projections, and whose face flux
the Rusanov flux's ½(f_hi + f⁺) on the hydro rows (its per-axis predictor
``aderdg_predictor_volume_per_axis_z4_matter``,
``csrc/aderdg_z4_matter_per_axis.cu``, and its 2-D step at order 2,
``csrc/aderdg_z4_matter_2d.cu``, the vacuum 2-D names with ``_matter``); Z4+GRMHD with
``_grmhd``, the same on its fluid, field and cleaning rows (its per-axis
predictor and 2-D step in ``csrc/aderdg_z4_grmhd_per_axis.cu`` and
``csrc/aderdg_z4_grmhd_2d.cu``; the shifted system's in
``csrc/aderdg_z4_shift_per_axis.cu`` and ``csrc/aderdg_z4_shift_2d.cu``)): the
predictor evaluates the algebra of ``csrc/z4.cuh`` (shifted:
``csrc/z4_shift.cuh``; coupled: ``csrc/z4_matter.cuh``,
``csrc/z4_grmhd.cuh``) in every Picard iteration, for the source average
and twice for the strong-form NCP volume term; the face flux kernel also
writes each interface's NCP half-fluctuation into a second tensor,
``fhalf``, which :meth:`CudaADERDG.face_flux` returns in place of ``fwall``
and :meth:`CudaADERDG.surface_update` takes.  A solver qualifies when its
flux, wave speed, ``source_fn``, ``ncp_fn`` and ``rhs_all_fn`` all carry one
``PhysicsTag("z4", ...)`` (or ``"z4_shift"``, ``"z4_matter"``,
``"z4_grmhd"``), or all but ``rhs_all_fn`` (the per-axis NCP branch); any
other ``source_fn``/``ncp_fn``/``rhs_all_fn`` raises
:class:`LoweringError`, and so do a Z4 solver with ``source_fn`` alone, a Z4
solver with walls, and a solver whose ``rhs_all_fn`` is already on K5
(``models.rhs_cuda.with_cuda_rhs``: these kernels compile the algebra in and
would bypass it; build ``CudaADERDG`` on the plain solver).  On the CK
predictor the one callback compiled in is the sponge (a ``source_fn`` that
carries a :class:`~exahype_tpu_torch.models.elastic.SpongeTag`, with
``n_wave`` the 9 evolved rows); CK with ``ncp_fn`` or ``rhs_all_fn``, CK
with any other ``source_fn``, and a sponge on a solver other than the CK
``elastic3d_het`` one raise :class:`LoweringError` naming ROADMAP.md,
Queue 2 K2 a (the plain solver runs them all).

With walls (``solver.boundary`` not periodic) the face stage is its wall
variant, ``aderdg_face_flux_walls`` + ``aderdg_surface_update_walls``:
:attr:`CudaADERDG.walls` describes the walls to it (the
axes, the mode, the sign tables read off the reflect hooks, the farfield
state, the Dirichlet rows in the kernel's face layout), and the low-wall
fluxes go through a side tensor (:meth:`CudaADERDG.face_flux`).  A reflect
hook without a sign table (an arbitrary callback) raises
:class:`LoweringError`; the plain solver still runs it.  A viscous solver
with walls hands the viscous-only wall-plane fluxes of the predictor to the
flux kernel (``fvwall``, in the Dirichlet rows' layout), which applies the
ghost flux hook to the advective part only.  A viscous callback other than
the tagged Navier–Stokes four raises :class:`LoweringError`.

Each wrapper takes its plain PyTorch version
(``ADERDGSolver.predictor_volume`` / ``face_surface``) for a tensor on the
CPU, and launches its kernels — or raises — for a CUDA tensor.  It counts
each kernel's launches in :attr:`CudaADERDG.launches`.  The Pallas kernel's TPU knobs
(``tile0``, ``vmem_limit_bytes``, ``boundary_faces_only``, ``picard_loop``,
``slice_loop``, ``interpret``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from exahype_tpu_torch import _build
from exahype_tpu_torch.models import elastic
from exahype_tpu_torch.models.aderdg import CALLBACK_OPTIONS, VISCOUS_OPTIONS, ADERDGSolver
from exahype_tpu_torch.models.curvilinear import (
    curvilinear_dissipation_mask,
    curvilinear_material_slots,
    n_vars_curvilinear,
)
from exahype_tpu_torch.models.rhs_cuda import CudaRHS
from exahype_tpu_torch.models.z4 import N_VARS as Z4_VARS
from exahype_tpu_torch.models.z4 import N_VARS_SHIFT, SHIFTS, SLICINGS
from exahype_tpu_torch.models.z4_grmhd import N_VARS as N_VARS_GRMHD
from exahype_tpu_torch.models.z4_matter import N_VARS as N_VARS_MATTER
from exahype_tpu_torch.utils.errors import LoweringError

#: (physics, dim, order) -> the predictor mode the kernels are instantiated
#: for with that physics.
INSTANTIATED = {
    ("euler", 2, 3): "picard",
    ("euler", 3, 3): "picard",
    ("euler", 3, 4): "picard",
    ("euler", 3, 5): "picard",
    ("euler", 3, 7): "picard",
    ("navier_stokes", 2, 2): "picard",
    ("navier_stokes", 2, 3): "picard",
    ("navier_stokes", 3, 3): "picard",
    ("elastic3d_het", 3, 3): "ck",
    ("elastic3d_het", 3, 2): "ck",
    ("elastic3d", 3, 2): "ck",
    ("elastic", 2, 3): "ck",
    ("elastic_het", 2, 3): "ck",
    ("curvilinear_elastic", 2, 3): "ck",
    ("z4", 3, 2): "picard",
    ("z4", 2, 2): "picard",
    ("z4", 2, 3): "picard",
    ("z4_shift", 3, 2): "picard",
    ("z4_shift", 2, 2): "picard",
    ("z4_matter", 3, 2): "picard",
    ("z4_matter", 2, 2): "picard",
    ("z4_grmhd", 3, 2): "picard",
    ("z4_grmhd", 2, 2): "picard",
}
#: The Z4 systems, whose step is the fused-NCP kernels' (K1 d), each also
#: with the per-axis NCP branch and a 2-D step.
_Z4 = ("z4", "z4_shift", "z4_matter", "z4_grmhd")
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _n_vars(name: str, dim: int) -> int:
    if name in _Z4:
        return {"z4": Z4_VARS, "z4_shift": N_VARS_SHIFT, "z4_matter": N_VARS_MATTER,
                "z4_grmhd": N_VARS_GRMHD}[name]
    if name in ("euler", "navier_stokes"):
        return dim + 2
    return {"elastic": 5, "elastic3d": elastic.N_VARS_3D, "elastic_het": elastic.N_VARS_HET,
            "curvilinear_elastic": n_vars_curvilinear(5, 2)}.get(name, elastic.N_VARS_3D_HET)


#: The wall modes of the C interface (``csrc/aderdg.cu``): a sign table
#: times my own face (reflective hooks with ``.signs``; outflow, whose hooks
#: are the all-ones table), the farfield state, the Dirichlet rows.
_WALL_MODES = {"reflective": 0, "outflow": 0, "farfield": 1, "dirichlet": 2}
#: K1 e's side modes (``csrc/aderdg.cu``'s ``SideMode``).
_SIDE_MODES = {"periodic": 0, "wall": 1, "exchanged": 2}

#: What each physics compiles into the kernels: its id in the C interface,
#: and the CK material slots and dissipation mask a solver must carry.
_PHYSICS = {
    "euler": {"id": 0, "ck_material_slots": None, "dissipation_mask": None},
    "elastic3d_het": {
        "id": 1,
        "ck_material_slots": elastic.MATERIAL_SLOTS,
        "dissipation_mask": elastic.DISSIPATION_MASK,
    },
    "navier_stokes": {"id": 2, "ck_material_slots": None, "dissipation_mask": None},
    "z4": {"id": 3, "ck_material_slots": None, "dissipation_mask": None},
    "z4_shift": {"id": 4, "ck_material_slots": None, "dissipation_mask": None},
    "z4_matter": {"id": 5, "ck_material_slots": None, "dissipation_mask": None},
    "z4_grmhd": {"id": 6, "ck_material_slots": None, "dissipation_mask": None},
    "elastic3d": {"id": 7, "ck_material_slots": None, "dissipation_mask": None},
    "elastic": {"id": 8, "ck_material_slots": None, "dissipation_mask": None},
    "elastic_het": {
        "id": 9,
        "ck_material_slots": elastic.MATERIAL_SLOTS_HET,
        "dissipation_mask": elastic.DISSIPATION_MASK_HET,
    },
    "curvilinear_elastic": {
        "id": 10,
        "ck_material_slots": curvilinear_material_slots(5, 2),
        "dissipation_mask": curvilinear_dissipation_mask(5, 2),
    },
}
#: The elastic systems: a configuration of theirs without kernels raises
#: naming ROADMAP.md, Queue 2 K2 b, which lists what is still to port.
_ELASTIC = ("elastic", "elastic3d", "elastic3d_het", "elastic_het", "curvilinear_elastic")


def _kernel_params(tag, solver) -> tuple:
    """The physics' parameters as the kernels take them: Euler's (γ,); for
    Navier–Stokes (γ, μ, max(4/3, γ/Pr), κ_T = μγ/((γ−1)Pr), then the face
    penalty factor 2(2N+1)/dx_d of each axis), each computed in float64 as
    the plain solver computes it; Z4's (slicing id, f, m, κ₁, κ₂) as K5
    takes them, the shifted system's followed by (shift id, f_b, η), the
    Z4+GRHD system's by (Γ, con2prim's Newton iterations), the Z4+GRMHD
    system's by (Γ, Newton iterations, c_h, GLM κ); the homogeneous
    elasticity's (ρ, λ, μ); none for the heterogeneous one."""
    if tag.name in ("z4", "z4_matter", "z4_grmhd"):
        slicing, *rest = tag.params
        return (SLICINGS[slicing], *rest)
    if tag.name == "z4_shift":
        slicing, f, m, kappa1, kappa2, shift, f_b, eta = tag.params
        return (SLICINGS[slicing], f, m, kappa1, kappa2, SHIFTS[shift], f_b, eta)
    if tag.name != "navier_stokes":
        return tag.params or (0.0,)
    gamma, mu, prandtl = tag.params
    return (gamma, mu, max(4.0 / 3.0, gamma / prandtl),
            mu * gamma / ((gamma - 1.0) * prandtl),
            *(2.0 * (2 * solver.order + 1) / dx for dx in solver._dxs))


def _ck_sponge(solver):
    """The :class:`~exahype_tpu_torch.models.elastic.SpongeTag` of a CK
    ``elastic3d_het`` solver whose one callback is the sponge, or None for
    a solver without CK callbacks or sponge; raise for the CK callbacks
    the kernels do not compile in (Queue 2 K2 a)."""
    where = "see ROADMAP.md, Queue 2 K2 a (the plain solver runs it)"
    ck = solver.predictor_mode == "ck"
    sponge = getattr(solver.source_fn, "sponge", None)
    if ck:
        for name in ("ncp_fn", "rhs_all_fn"):
            if getattr(solver, name) is not None:
                raise LoweringError(
                    f"the CUDA CK predictor carries no {name}: CK with a non-conservative "
                    f"product or a fused right-hand side on the card is still to port; {where}"
                )
        if solver.source_fn is not None and sponge is None:
            raise LoweringError(
                "the CUDA CK predictor compiles in one source, the absorbing sponge of "
                "models.elastic.sponge_source; this solver's source_fn is another; " + where
            )
    if sponge is None:
        return None
    tag = getattr(solver.flux_fn, "physics", None)
    if not ck or tag is None or tag.name != "elastic3d_het" or sponge.n_wave != (
            elastic.MATERIAL_SLOTS[0]) or sponge.sigma.shape != tuple(solver.grid_shape):
        raise LoweringError(
            "the sponge is compiled into the CK predictor of the 12-variable "
            "elastic3d_het solver only, damping its 9 evolved rows (n_wave=9) on the "
            "solver's own grid; " + where
        )
    return sponge


def _z4_refusal(solver) -> None:
    """Raise unless the solver's ``source_fn``/``ncp_fn``/``rhs_all_fn`` are
    a Z4 system the kernels compile in: fused (all three set), zero-shift,
    shifted or coupled to matter, magnetized or not, or the per-axis NCP
    branch (``source_fn`` and ``ncp_fn`` without ``rhs_all_fn``) of any of
    them (called when any is set)."""
    if isinstance(solver.rhs_all_fn, CudaRHS):
        raise LoweringError(
            "the rhs_all_fn is on K5 (models.rhs_cuda.with_cuda_rhs): the CUDA step "
            "kernels compile the Z4 algebra in and would bypass it; build CudaADERDG on "
            "the plain make_z4_solver, make_z4_shift_solver, make_z4_matter_solver or "
            "make_z4_grmhd_solver(..., fused_rhs='soa') solver"
        )
    names = ("flux_fn", "max_eigenvalue_fn", *CALLBACK_OPTIONS)
    tags = {getattr(getattr(solver, name), "physics", None)
            for name in names if getattr(solver, name) is not None}
    tag = tags.pop() if len(tags) == 1 else None
    if tag is not None and tag.name in _Z4:
        missing = [name for name in CALLBACK_OPTIONS if getattr(solver, name) is None]
        if missing == ["rhs_all_fn"]:
            return  # the per-axis NCP branch (make_z4_solver(..., fused_rhs=False))
        if "ncp_fn" in missing and solver.source_fn is not None:
            raise LoweringError(
                f"a {tag.name} solver with source_fn and without ncp_fn: the source_fn-only "
                "branch of the CUDA kernels is still to port, see ROADMAP.md, Queue 2 K1 d "
                "(the plain solver runs it)"
            )
        if missing:
            raise LoweringError(
                f"a {tag.name} solver without {', '.join(missing)}: the CUDA kernels carry "
                "the fused right-hand side (make_z4_solver, make_z4_shift_solver, "
                "make_z4_matter_solver or make_z4_grmhd_solver(..., fused_rhs='soa')) and "
                "the per-axis NCP branch (the same with fused_rhs=False), each with "
                "source_fn and ncp_fn; other combinations are still to port, see ROADMAP.md, "
                "Queue 2 K1 d (the plain solver runs them)"
            )
        return
    options = ", ".join(name for name in CALLBACK_OPTIONS if getattr(solver, name) is not None)
    raise LoweringError(
        f"the CUDA step kernels carry source_fn, ncp_fn and rhs_all_fn for the fused "
        f"vacuum Z4 system only, zero-shift or shifted, or coupled to a perfect fluid "
        f"(Z4+GRHD) or a magnetized one (Z4+GRMHD) (make_z4_solver, make_z4_shift_solver, "
        f"make_z4_matter_solver or make_z4_grmhd_solver(..., impl='soa', "
        f"fused_rhs='soa'): its flux, wave speed and those three callbacks tagged alike); "
        f"this solver's {options} is set otherwise; see ROADMAP.md, Queue 2 K1 d (the "
        "plain solver runs any)"
    )


class CudaADERDG:
    """Solver protocol (``step``, ``run``, ``cfl_dt``, ``total_mass``,
    ``dofs``) over an :class:`ADERDGSolver`, with the step on CUDA kernels.
    """

    #: The kernels, by their index in the occupancy query of
    #: ``csrc/aderdg.cu`` (index 7 of physics 2: the instance of
    #: ``aderdg_predictor_volume_visc``, ``csrc/aderdg_visc.cu``, with the
    #: wall planes; 7-9 of physics 3: the Z4 kernels of
    #: ``csrc/aderdg_z4.cu``; 10-12 of physics 4: the shifted Z4 kernels of
    #: ``csrc/aderdg_z4_shift.cu``; 13-15 of physics 5: the Z4+GRHD kernels
    #: of ``csrc/aderdg_z4_matter.cu``; 16-18 of physics 6: the Z4+GRMHD
    #: kernels of ``csrc/aderdg_z4_grmhd.cu``; 19-21 of physics 0: the
    #: order-5 Euler step's, ``csrc/aderdg_p5.cu`` and the face stage's n = 6
    #: instances; 22-26 of physics 0: the 2-D Euler step's,
    #: ``csrc/aderdg_2d.cu``, the wall pair last; 27 of physics 2: the 2-D
    #: viscous predictor of the same file, whose face pair is 23-24 of
    #: physics 2; 29-31 of physics 7: K2 b's 3-D homogeneous elasticity at
    #: order 2, the CK predictor of ``csrc/aderdg_ck_nodes.cuh`` and the face
    #: stage's n = 3 instances, and of physics 1 the same over the
    #: heterogeneous elasticity (K2 b.1); 32 of physics 8: K2 b's 2-D CK
    #: predictor, whose face pairs are 23-26 of physics 8, and the same
    #: indices of physics 9 and 10, the 2-D heterogeneous and curvilinear
    #: elasticity (K2 b.1); 33 of physics 0: K1 e, the sharded face flux,
    #: whose update is 5; 34-35 of physics 0: the order-5 walled pair; 36-40
    #: and 41-45 of physics 0: the order-4 and order-7 Euler steps,
    #: ``csrc/aderdg_p4.cu`` and ``csrc/aderdg_p7.cu`` with the face stage's
    #: n = 5 and n = 8 instances, predictor, pair, walled pair; 46 of
    #: physics 3: the vacuum Z4 system's per-axis predictor,
    #: ``csrc/aderdg_z4_per_axis.cu``, and 47-50 and 51-54 its 2-D steps at
    #: orders 2 and 3, ``csrc/aderdg_z4_2d.cu`` and ``aderdg_z4_2d_p3.cu``,
    #: the fused predictor, the pair, the per-axis predictor; 55 of physics 5:
    #: the Z4+GRHD system's per-axis predictor,
    #: ``csrc/aderdg_z4_matter_per_axis.cu``, and 56-59 its 2-D step at order
    #: 2, ``csrc/aderdg_z4_matter_2d.cu``, in the same order; 60-64 of
    #: physics 6: the Z4+GRMHD system's, ``csrc/aderdg_z4_grmhd_per_axis.cu``
    #: and ``csrc/aderdg_z4_grmhd_2d.cu``, the same; 65-69 of physics 4: the
    #: shifted system's, ``csrc/aderdg_z4_shift_per_axis.cu`` and
    #: ``csrc/aderdg_z4_shift_2d.cu``, the same; 70-74 of physics 2: the 2-D
    #: Navier–Stokes step at order 2, ``csrc/aderdg_2d.cu``'s order-2
    #: instances, predictor, pair, walled pair; the 2-D viscous predictors
    #: with the wall planes are 75 and 76 of physics 2, orders 3 and 2,
    #: ``_WALLED_PREDICTOR_INFO``).
    KERNELS = (
        "aderdg_predictor_volume", "aderdg_ck_predictor_volume", "aderdg_face_flux",
        "aderdg_surface_update", "aderdg_face_flux_walls", "aderdg_surface_update_walls",
        "aderdg_predictor_volume_visc", "aderdg_predictor_volume_z4", "aderdg_face_flux_z4",
        "aderdg_surface_update_z4", "aderdg_predictor_volume_z4_shift",
        "aderdg_face_flux_z4_shift", "aderdg_surface_update_z4_shift",
        "aderdg_predictor_volume_z4_matter", "aderdg_face_flux_z4_matter",
        "aderdg_surface_update_z4_matter", "aderdg_predictor_volume_z4_grmhd",
        "aderdg_face_flux_z4_grmhd", "aderdg_surface_update_z4_grmhd",
        "aderdg_predictor_volume_p5", "aderdg_face_flux_p5", "aderdg_surface_update_p5",
        "aderdg_predictor_volume_2d", "aderdg_face_flux_2d", "aderdg_surface_update_2d",
        "aderdg_face_flux_walls_2d", "aderdg_surface_update_walls_2d",
        "aderdg_predictor_volume_visc_2d", "aderdg_ck_predictor_volume_sponge",
        "aderdg_ck_predictor_volume_p2", "aderdg_face_flux_p2", "aderdg_surface_update_p2",
        "aderdg_ck_predictor_volume_2d", "aderdg_face_flux_exchanged",
        "aderdg_face_flux_walls_p5", "aderdg_surface_update_walls_p5",
        *(f"aderdg_{kernel}_p{order}" for order in (4, 7) for kernel in (
            "predictor_volume", "face_flux", "surface_update", "face_flux_walls",
            "surface_update_walls")),
        "aderdg_predictor_volume_per_axis_z4",
        *(f"aderdg_{kernel}{order}_2d_z4" for order in ("", "_p3") for kernel in (
            "predictor_volume", "face_flux", "surface_update", "predictor_volume_per_axis")),
        *(name for system in ("matter", "grmhd", "shift") for name in (
            f"aderdg_predictor_volume_per_axis_z4_{system}",
            *(f"aderdg_{kernel}_2d_z4_{system}" for kernel in (
                "predictor_volume", "face_flux", "surface_update",
                "predictor_volume_per_axis")))),
        *(f"aderdg_{kernel}_p2_2d" for kernel in (
            "predictor_volume_visc", "face_flux", "surface_update", "face_flux_walls",
            "surface_update_walls")),
    )
    #: The occupancy index of a viscous predictor's walled instance (the one
    #: that also writes the viscous-only wall planes).
    _WALLED_PREDICTOR_INFO = {"aderdg_predictor_volume_visc": 7,
                              "aderdg_predictor_volume_visc_2d": 75,
                              "aderdg_predictor_volume_visc_p2_2d": 76}

    def __init__(self, solver: ADERDGSolver):
        sponge = _ck_sponge(solver)
        ncp = sponge is None and any(
            getattr(solver, option) is not None for option in CALLBACK_OPTIONS)
        if ncp:
            _z4_refusal(solver)
        viscous = any(getattr(solver, option) is not None for option in VISCOUS_OPTIONS)
        names = (("flux_fn", "max_eigenvalue_fn") + (VISCOUS_OPTIONS if viscous else ())
                 + tuple(o for o in CALLBACK_OPTIONS if ncp and getattr(solver, o) is not None))
        tags = {getattr(getattr(solver, name), "physics", None) for name in names}
        tag = tags.pop() if len(tags) == 1 else None
        if viscous and (tag is None or tag.name != "navier_stokes"):
            raise LoweringError(
                "the CUDA kernels carry viscous terms for the compressible "
                "Navier–Stokes callbacks only: build all four with "
                "exahype_tpu_torch.models.navier_stokes.navier_stokes (the plain "
                "solver runs any viscous callback)"
            )
        if tag is not None and tag.name == "navier_stokes" and not viscous:
            raise LoweringError(
                "the navier_stokes kernels need the solver's visc_flux_fn and "
                "visc_eigenvalue_fn (models.navier_stokes.navier_stokes gives all "
                "four callbacks)"
            )
        if tag is not None and tag.name.startswith("curvilinear_") and tag.name not in _PHYSICS:
            raise LoweringError(
                f"the CUDA kernels compile in the curvilinear lift of the 2-D elasticity "
                f"only (curvilinear_elastic), got {tag.name}: the curvilinear Euler is still "
                "to port, see ROADMAP.md, Queue 1 item 12 (the plain solver runs it)"
            )
        # (The Z4 systems are 3-D; on a 2-D grid their tags keep dim 3, and
        # the instantiation check below names the missing (dim, order).)
        per_axis = ncp and solver.rhs_all_fn is None
        if tag is None or tag.name not in _PHYSICS or (
                tag.dim != solver.dim and tag.name not in _Z4):
            raise LoweringError(
                "the CUDA kernels compile in Euler, Navier–Stokes, elastic (homogeneous "
                "2-D and 3-D, heterogeneous 2-D and 3-D, the 2-D system lifted onto a "
                "curvilinear mesh), vacuum Z4, Z4+GRHD or Z4+GRMHD physics: "
                "build the solver with exahype_tpu_torch.models.aderdg.euler_physics, "
                "models.navier_stokes.navier_stokes, models.elastic.elastic, "
                "models.elastic.elastic3d, models.elastic.elastic_heterogeneous, "
                "models.elastic.elastic3d_heterogeneous, "
                "models.curvilinear.curvilinear_physics(*models.elastic.elastic(...), 2, 5), "
                "models.z4.make_z4_solver / "
                "make_z4_shift_solver, models.z4_matter.make_z4_matter_solver or "
                "models.z4_grmhd.make_z4_grmhd_solver"
            )
        n_vars = _n_vars(tag.name, solver.dim)
        if tag.n_real != solver.n_vars or solver.n_vars != n_vars:
            raise LoweringError(
                f"the CUDA kernels take the {n_vars} {tag.name} variables "
                f"only, got n_vars={solver.n_vars}"
            )
        key = (tag.name, solver.dim, solver.order)
        if key not in INSTANTIATED:
            item = "Queue 2 K2 b" if tag.name in _ELASTIC else "Queue 1 item 4"
            raise LoweringError(
                f"no CUDA kernel instantiated for {tag.name}, dim={solver.dim}, "
                f"order={solver.order} (have {sorted(INSTANTIATED)}); see ROADMAP.md, "
                f"{item}"
            )
        mode = INSTANTIATED[key]
        if solver.predictor_mode != mode:
            raise LoweringError(
                f"the {tag.name} kernels are instantiated for predictor_mode="
                f"{mode!r}, got {solver.predictor_mode!r}"
            )
        physics = _PHYSICS[tag.name]
        for option in ("ck_material_slots", "dissipation_mask"):
            if getattr(solver, option) != physics[option]:
                raise LoweringError(
                    f"the {tag.name} kernels compile in {option}="
                    f"{physics[option]!r}, got {getattr(solver, option)!r}"
                )
        walled = any(solver.is_wall(d) for d in range(solver.dim))
        if ncp and walled:
            raise LoweringError(
                f"the CUDA Z4 face stage is periodic only, and boundary="
                f"{solver.boundary!r}: NCP walls on the card are still to port, see "
                "ROADMAP.md, Queue 2 K1 d (the plain solver runs them)"
            )
        # Orders 4, 5 and 7 (Euler), 2 (the 3-D elasticity, 2-D Navier–Stokes)
        # have kernels of their own, named with the order; Euler's face stage
        # has its wall pair at each of them, and so has 2-D Navier–Stokes at
        # order 2, the elasticity's is periodic only.  The Z4 kernels' own
        # order is 2; the 2-D vacuum step's order 3 has its own.
        default_order = 2 if ncp else 3
        order_suffix = "" if solver.order == default_order else f"_p{solver.order}"
        if order_suffix and walled and tag.name in _ELASTIC:
            raise LoweringError(
                f"the CUDA face stage of the 3-D elasticity ({tag.name}) at order "
                f"{solver.order} is periodic only, and boundary={solver.boundary!r}: its walls "
                "on the card are still to port, see ROADMAP.md, Queue 2 K2 b (the plain "
                "solver runs them)"
            )
        if walled and tag.name == "curvilinear_elastic":
            raise LoweringError(
                f"the CUDA face stage of the curvilinear elasticity is periodic only, and "
                f"boundary={solver.boundary!r}: its walls on the card are still to port, see "
                "ROADMAP.md, Queue 2 K2 b (the plain solver runs them)"
            )
        # The 2-D steps have kernels of their own (csrc/aderdg_2d.cu), named
        # with the dimension; they take the grid as (g0, g1, 1).
        dim_suffix = "_2d" if solver.dim == 2 else ""
        self._grid = tuple(solver.grid_shape) + (1,) * (3 - solver.dim)
        self.solver = solver
        #: Whether the step carries the fused NCP right-hand side (Z4): the
        #: face flux kernel then also returns the NCP half-fluctuations.
        self.ncp = ncp
        #: Whether the NCP is the per-axis branch (a Z4 system without
        #: ``rhs_all_fn``: its own predictor, the same face stage).
        self.per_axis = per_axis
        #: The sponge the CK predictor compiles in (K2 a), or None; its σ
        #: goes to the kernel per cell, by dtype and device in ``_sigma``.
        self.sponge = sponge
        self._sigma = {}
        self._physics_id = physics["id"]
        # The rows whose face flux can be nonzero: all but the frozen
        # materials, the last rows (the kernels' Phys::kFluxRows).
        self._flux_rows = min(physics["ck_material_slots"] or (n_vars,))
        self._params = np.ascontiguousarray(_kernel_params(tag, solver), dtype=np.float64)
        #: The walls as the face kernels take them (None: periodic).
        self.walls = self._wall_description(solver) if walled else None
        self._rows = {}  # the Dirichlet rows by dtype
        self._side_layouts = {}  # K1 e's side tensor layouts by modes
        #: The kernels of this solver's step: its predictor and the face
        #: stage (its wall variant on a grid with walls).
        suffix = "" if self.walls is None else "_walls"
        predictor = "aderdg_ck_predictor_volume" if mode == "ck" else "aderdg_predictor_volume"
        if sponge is not None:
            predictor += "_sponge"
        if per_axis:
            predictor += "_per_axis"
        self.kernels = (
            predictor + ("_visc" if viscous else "") + order_suffix + dim_suffix,
            f"aderdg_face_flux{suffix}{order_suffix}{dim_suffix}",
            f"aderdg_surface_update{suffix}{order_suffix}{dim_suffix}",
        )
        if ncp:
            self.kernels = tuple(f"{name}_{tag.name}" for name in self.kernels)
        #: Launches per kernel since construction (or the last reset).
        self.launches = {name: 0 for name in self.kernels}
        ops = solver.ops
        self._ops = np.ascontiguousarray(np.concatenate([
            ops.D.ravel(), ops.K1inv.ravel(), ops.Kvol.ravel(), ops.weights,
            ops.phi0, ops.phi1, ops.phi0 / ops.weights, ops.phi1 / ops.weights,
        ]), dtype=np.float64)
        # Three entries: the kernels' parameter bank has dx of three axes.
        self._dx = np.ascontiguousarray(
            tuple(solver._dxs) + (1.0,) * (3 - solver.dim), dtype=np.float64)

    def _wall_description(self, sol) -> dict:
        """``mask`` (bit d: axis d walled), ``mode``, ``table`` (float64
        [S_q (3, V), S_f (3, V), farfield (V)]), ``off`` (int64, each wall
        axis's block in the side tensor), ``size`` (its elements), ``planes``
        (each axis's face-row shape: the other node axes, V, the grid with
        the axis cut to 1) and ``rows`` (Dirichlet: both sides' rows, float64, in the side
        tensor's layout, on the solver's device; else None)."""
        n_vars, dim = sol.n_vars, sol.dim
        axes = [d for d in range(dim) if sol.is_wall(d)]
        sq = sf = np.zeros((dim, n_vars))
        far = np.zeros(n_vars)
        if sol.boundary in ("reflective", "outflow"):
            tables = []
            for hook in (sol.reflect_fn, sol.reflect_flux_fn):
                signs = getattr(hook, "signs", None)
                if signs is None or np.shape(signs) != (dim, n_vars):
                    raise LoweringError(
                        "the CUDA face stage compiles in a reflect hook as a sign table "
                        f"[dim, n_vars] (its .signs, as models.aderdg.sign_reflect makes), "
                        f"and {getattr(hook, '__name__', hook)!r} has none; the plain "
                        "solver runs any hook"
                    )
                tables.append(np.asarray(signs, dtype=np.float64))
            sq, sf = tables
        if sol.boundary == "farfield":
            far = np.asarray(sol.farfield_state, dtype=np.float64)
        planes = sol.wall_planes()
        off, size = np.zeros(3, dtype=np.int64), 0
        for d in axes:
            off[d] = size
            size += int(np.prod(planes[d]))
        rows = None
        if sol.boundary == "dirichlet":
            device = sol.weights.device
            rows = torch.cat([
                sol.dirichlet_row(d, side, torch.empty(
                    planes[d], dtype=torch.float64, device=device)).reshape(-1)
                for side in (0, 1) for d in axes
            ])
        return {
            "mask": sum(1 << d for d in axes),
            "mode": _WALL_MODES[sol.boundary],
            "table": np.ascontiguousarray(np.concatenate([sq.ravel(), sf.ravel(), far])),
            "off": off,
            "size": size,
            "planes": planes,
            "rows": rows,
        }

    def _wall_args(self, like):
        """The walled face flux kernel's wall arguments for a launch in
        ``like``'s dtype: ``(mask, mode, table, rows pointer, off, side
        stride)``."""
        w = self.walls
        rows = None
        if w["rows"] is not None:
            if like.dtype not in self._rows:
                self._rows[like.dtype] = w["rows"].to(device=like.device, dtype=like.dtype)
            rows = self._rows[like.dtype].data_ptr()
        return (w["mask"], w["mode"], w["table"].ctypes.data, rows, w["off"].ctypes.data,
                w["size"])

    def wall_fluxes(self, fwall) -> dict:
        """Each wall axis's low-wall fluxes in the side tensor ``fwall`` of
        :meth:`face_flux`, as views shaped like one face row (the plain
        version is ``ADERDGSolver.low_wall_flux``)."""
        w = self.walls
        return {
            d: fwall[w["off"][d]:w["off"][d] + int(np.prod(shape))].view(shape)
            for d, shape in w["planes"].items()
        }

    # ---------------------------------------------------------------- checks

    def _check(self, x, shape, name):
        if x.dtype not in _SUFFIX:
            raise LoweringError(f"{name}: dtype {x.dtype} not float32/float64")
        if tuple(x.shape) != tuple(shape):
            raise LoweringError(f"{name}: shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise LoweringError(f"{name}: must be contiguous")

    def _dt_args(self, dt, like):
        """``(tensor, pointer, value)`` for the kernels' dt: a Python float
        goes by value, a tensor stays on the device and goes by pointer (the
        caller holds the tensor until the launch is enqueued)."""
        if isinstance(dt, torch.Tensor):
            if dt.numel() != 1:
                raise LoweringError("dt must be a scalar")
            dt = dt.to(device=like.device, dtype=like.dtype).reshape(())
            return dt, dt.data_ptr(), 0.0
        return None, None, float(dt)

    # --------------------------------------------------------------- kernels

    def predictor_volume(self, u, dt):
        """``(new, faces, fvwall)`` of the cell-local half of the step
        (``fvwall`` None but for a viscous solver with walls: the contract
        of ``ADERDGSolver.predictor_volume``).  ``u`` is not modified."""
        if not u.is_cuda:
            return self.solver.predictor_volume(u, dt)
        sol = self.solver
        self._check(u, sol.state_shape, "u")
        new = torch.empty_like(u)
        faces = torch.empty(sol.face_shape, dtype=u.dtype, device=u.device)
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, u)
        name = self.kernels[0]
        # The Picard launchers take the iteration count; the CK ones have none.
        ck = name.startswith("aderdg_ck_predictor_volume")
        iters = () if ck else (sol.picard_iters,)
        # The viscous launchers take the wall planes of the viscous split
        # (mask 0: none).
        fvwall, planes = None, ()
        if name in self._WALLED_PREDICTOR_INFO:
            if sol.splits_wall_viscosity:
                w = self.walls
                fvwall = torch.empty(2 * w["size"], dtype=u.dtype, device=u.device)
                planes = (w["mask"], fvwall.data_ptr(), w["off"].ctypes.data, w["size"])
            else:
                planes = (0, None, None, 0)
        if self.sponge is not None:  # K2 a takes σ, one value a cell
            key = (u.dtype, u.device)
            if key not in self._sigma:
                self._sigma[key] = torch.as_tensor(
                    self.sponge.sigma.reshape(-1), dtype=u.dtype, device=u.device).contiguous()
            planes = (self._sigma[key].data_ptr(),)
        lib = _build.library()
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[u.dtype]}")(
                u.data_ptr(), new.data_ptr(), faces.data_ptr(), dt_ptr, dt_val,
                self._ops.ctypes.data, self._dx.ctypes.data, sol.order, *iters,
                self._physics_id, self._params.ctypes.data, *self._grid, *planes, stream,
            )
        _build.check(lib, err, name)
        self.launches[name] += 1
        return new, faces, fvwall

    def face_surface(self, new, faces, dt, return_face_fluxes: bool = False, fvwall=None):
        """Surface update of ``new`` from ``faces`` (and a viscous walled
        solver's ``fvwall``), in place on either device; returns ``new``,
        and with ``return_face_fluxes`` also the per-axis high-face fluxes
        (``solver.face_flux_shape`` each; on a wall axis the last row holds
        the high-wall flux)."""
        sol = self.solver
        if not new.is_cuda:
            out = sol.face_surface(new, faces, dt, return_face_fluxes, fvwall)
            if return_face_fluxes:
                return new.copy_(out[0]), out[1]
            return new.copy_(out)
        fhat, side = self.face_flux(faces, fvwall)
        if self.ncp:
            self.surface_update(new, fhat, dt, fhalf=side)
        else:
            self.surface_update(new, fhat, dt, side)
        if return_face_fluxes:
            fhat[:, :, self._flux_rows:].zero_()  # the unwritten rows; none for Euler
            return new, [fhat[d].view(sol.face_flux_shape) for d in range(sol.dim)]
        return new

    def face_flux(self, faces, fvwall=None):
        """The face stage's first launch (CUDA tensors only): ``(fhat,
        fwall)`` (``fvwall``: the viscous-only wall-plane fluxes of
        :meth:`predictor_volume`, which a viscous solver with walls needs
        and no other takes).  ``fhat``, ``[dim, n^(dim-1), n_vars, *grid]``,
        is every interface's Rusanov flux, each cell's high-face fluxes (on a wall
        axis the last row's is the high-wall flux).  ``fwall`` is None
        without walls, else the side tensor of the low-wall fluxes
        (:meth:`wall_fluxes` views it by axis).  The rows that are zero by
        construction (the elasticity's frozen materials, from its first
        material slot on) are not written: :meth:`surface_update` never
        reads them, and :meth:`face_surface` zeroes them when it returns
        the fluxes (``fwall`` is allocated zeroed for such a physics).
        For Z4, shifted or not (:attr:`ncp`), the second output is ``fhalf``, fhat's shape:
        each interface's NCP half-fluctuation (the plain version is
        ``ADERDGSolver.ncp_half``)."""
        sol = self.solver
        if not faces.is_cuda:
            raise LoweringError("face_flux launches a CUDA kernel: faces must be on the card")
        self._check(faces, sol.face_shape, "faces")
        if (fvwall is not None) != sol.splits_wall_viscosity:
            raise LoweringError(
                "fvwall (the viscous-only wall fluxes of predictor_volume) goes with a "
                "viscous solver with walls, and only with one")
        if fvwall is not None:
            self._check(fvwall, (2 * self.walls["size"],), "fvwall")
            if fvwall.dtype != faces.dtype or fvwall.device != faces.device:
                raise LoweringError("fvwall must match faces' dtype and device")
        fhat = torch.empty(
            (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape,
            dtype=faces.dtype, device=faces.device,
        )
        args = (faces.data_ptr(), fhat.data_ptr(), self._ops.ctypes.data,
                self._dx.ctypes.data, sol.order, self._physics_id,
                self._params.ctypes.data, *self._grid)
        fwall = None
        if self.ncp:
            fwall = torch.empty_like(fhat)  # fhalf
            args = args[:2] + (fwall.data_ptr(),) + args[2:]
        if self.walls is not None:
            alloc = torch.zeros if self._flux_rows < sol.n_vars else torch.empty
            fwall = alloc(self.walls["size"], dtype=faces.dtype, device=faces.device)
            mask, mode, table, rows, off, side = self._wall_args(faces)
            args += (mask, mode, table, rows, fwall.data_ptr(), off, side,
                     None if fvwall is None else fvwall.data_ptr())
        name = self.kernels[1]
        lib = _build.library()
        with torch.cuda.device(faces.device):
            stream = torch.cuda.current_stream(faces.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[faces.dtype]}")(*args, stream)
        _build.check(lib, err, name)
        self.launches[name] += 1
        return fhat, fwall

    def surface_update(self, new, fhat, dt, fwall=None, fhalf=None):
        """The face stage's second launch (CUDA tensors only): the surface
        update of ``new`` from :meth:`face_flux`'s ``fhat`` (and, with walls,
        its ``fwall``; for Z4 its ``fhalf``, which Z4 needs and no other
        takes), in place; returns ``new``."""
        sol = self.solver
        if not new.is_cuda:
            raise LoweringError("surface_update launches a CUDA kernel: new must be on the card")
        self._check(new, sol.state_shape, "new")
        fshape = (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape
        self._check(fhat, fshape, "fhat")
        if fhat.dtype != new.dtype or fhat.device != new.device:
            raise LoweringError("faces must match new's dtype and device")
        if (fhalf is not None) != self.ncp:
            raise LoweringError(
                "fhalf (the NCP half-fluctuations of face_flux) goes with a Z4 solver, and "
                "only with one")
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, new)
        args = (new.data_ptr(), fhat.data_ptr(), dt_ptr, dt_val, self._ops.ctypes.data,
                self._dx.ctypes.data, sol.order, self._physics_id,
                self._params.ctypes.data, *self._grid)
        if fhalf is not None:
            self._check(fhalf, fshape, "fhalf")
            if fhalf.dtype != new.dtype or fhalf.device != new.device:
                raise LoweringError("fhalf must match new's dtype and device")
            args = args[:2] + (fhalf.data_ptr(),) + args[2:]
        if self.walls is not None:
            if fwall is None:
                raise LoweringError("a walled solver's update needs face_flux's fwall")
            self._check(fwall, (self.walls["size"],), "fwall")
            if fwall.dtype != new.dtype or fwall.device != new.device:
                raise LoweringError("fwall must match new's dtype and device")
            args += (self.walls["mask"], fwall.data_ptr(), self.walls["off"].ctypes.data)
        elif fwall is not None:
            raise LoweringError("fwall given, but the solver has no walls")
        name = self.kernels[2]
        lib = _build.library()
        with torch.cuda.device(new.device):
            stream = torch.cuda.current_stream(new.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[new.dtype]}")(*args, stream)
        _build.check(lib, err, name)
        self.launches[name] += 1
        return new

    # ------------------------------------------------- K1 e: sharded faces

    def _side_layout(self, modes) -> tuple:
        """``(mask, off, size)`` of K1 e's side tensor for ``modes``: the
        axes whose low side is not periodic, each axis's block offset
        (int64) and the elements in all."""
        key = tuple(tuple(m) for m in modes)
        if key not in self._side_layouts:
            sol = self.solver
            off, size, mask = np.zeros(3, dtype=np.int64), 0, 0
            for d, (lo, _) in enumerate(key):
                if lo != "periodic":
                    mask |= 1 << d
                    off[d] = size
                    size += sol.n_nodes ** (sol.dim - 1) * sol.n_vars * math.prod(
                        g for e, g in enumerate(sol.grid_shape) if e != d)
            self._side_layouts[key] = (mask, off, size)
        return self._side_layouts[key]

    def face_flux_exchanged(self, faces, modes, planes):
        """K1 e, the face flux of a rank's window of a sharded grid (CUDA
        tensors only; ``parallel/shard.py``): ``modes[d] = (low, high)``,
        each ``"periodic"``, ``"wall"`` (a domain wall this rank owns; the
        solver's ghosts) or ``"exchanged"``, and ``planes[(d, side)]`` the
        received face row of each exchanged side, ``[2 (q, f), n^(dim-1),
        n_vars, *plane]`` (side 0: the −d neighbour's last row's high faces;
        side 1: the +d neighbour's first row's low faces).  Returns ``(fhat,
        fside)``: every face's Rusanov flux as :meth:`face_flux` gives it,
        and the first row's low-face fluxes of each axis whose low side is
        not periodic (wall or exchanged), which
        :meth:`surface_update_exchanged` reads.  Its plain version is
        ``ADERDGSolver.face_update`` with ``shift`` and the wall gates."""
        sol = self.solver
        if not faces.is_cuda:
            raise LoweringError("face_flux_exchanged launches a CUDA kernel: faces must be on "
                                "the card")
        if self._physics_id != _PHYSICS["euler"]["id"] or sol.dim != 3 or sol.order != 3:
            raise LoweringError(
                "K1 e (aderdg_face_flux_exchanged) is compiled for 3-D Euler at order 3; see "
                "ROADMAP.md, Queue 2 K1 e")
        self._check(faces, sol.face_shape, "faces")
        codes = np.zeros(6, dtype=np.int32)
        ptrs = (ctypes.c_void_p * 6)()
        for d in range(sol.dim):
            for side in (0, 1):
                mode = modes[d][side]
                codes[2 * d + side] = _SIDE_MODES[mode]
                if mode != "exchanged":
                    continue
                x = planes[(d, side)]
                shape = (2, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + tuple(
                    1 if e == d else g for e, g in enumerate(sol.grid_shape))
                if x.is_contiguous() and x.numel() == math.prod(shape):
                    x = x.view(shape)  # e.g. face_flux_shape's separate node axes
                self._check(x, shape, f"planes[{d}, {side}]")
                if x.dtype != faces.dtype or x.device != faces.device:
                    raise LoweringError("the planes must match faces' dtype and device")
                ptrs[2 * d + side] = x.data_ptr()
        mask, off, size = self._side_layout(modes)
        fhat = torch.empty(
            (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape,
            dtype=faces.dtype, device=faces.device,
        )
        fside = torch.empty(max(size, 1), dtype=faces.dtype, device=faces.device)
        walls = (0, 0, None, None, None, 0) if self.walls is None else self._wall_args(faces)
        name = "aderdg_face_flux_exchanged"
        lib = _build.library()
        with torch.cuda.device(faces.device):
            stream = torch.cuda.current_stream(faces.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[faces.dtype]}")(
                faces.data_ptr(), fhat.data_ptr(), self._ops.ctypes.data, self._dx.ctypes.data,
                sol.order, self._physics_id, self._params.ctypes.data, *self._grid, *walls,
                codes.ctypes.data, ctypes.addressof(ptrs), fside.data_ptr(), off.ctypes.data,
                stream,
            )
        _build.check(lib, err, name)
        self.launches[name] = self.launches.get(name, 0) + 1
        return fhat, fside[:size]

    def surface_update_exchanged(self, new, fhat, dt, fside, modes):
        """The update after :meth:`face_flux_exchanged` (CUDA tensors
        only): ``aderdg_surface_update_walls`` with F̂_lo of the first row
        read from ``fside`` on every axis whose low side is not periodic,
        in place; returns ``new``."""
        sol = self.solver
        mask, off, size = self._side_layout(modes)
        if not new.is_cuda:
            raise LoweringError("surface_update_exchanged launches a CUDA kernel: new must be "
                                "on the card")
        self._check(new, sol.state_shape, "new")
        self._check(fhat, (sol.dim, sol.n_nodes ** (sol.dim - 1), sol.n_vars) + sol.grid_shape,
                    "fhat")
        self._check(fside, (size,), "fside")
        for name, x in (("fhat", fhat), ("fside", fside)):
            if x.dtype != new.dtype or x.device != new.device:
                raise LoweringError(f"{name} must match new's dtype and device")
        dt_dev, dt_ptr, dt_val = self._dt_args(dt, new)
        args = (new.data_ptr(), fhat.data_ptr(), dt_ptr, dt_val, self._ops.ctypes.data,
                self._dx.ctypes.data, sol.order, self._physics_id, self._params.ctypes.data,
                *self._grid)
        name = "aderdg_surface_update" if mask == 0 else "aderdg_surface_update_walls"
        if mask:
            args += (mask, fside.data_ptr(), off.ctypes.data)
        lib = _build.library()
        with torch.cuda.device(new.device):
            stream = torch.cuda.current_stream(new.device).cuda_stream
            err = getattr(lib, f"exahype_{name}_{_SUFFIX[new.dtype]}")(*args, stream)
        _build.check(lib, err, name)
        self.launches[name] = self.launches.get(name, 0) + 1
        return new

    def kernel_info(self, name: str, dtype) -> dict:
        """How ``name`` (one of :attr:`kernels`) launches for this solver's
        physics in ``dtype`` on the current card: ``registers`` per thread,
        resident ``blocks_per_sm``, ``threads`` per block, dynamic ``smem``
        bytes and ``local`` (spill) bytes per thread."""
        out = (ctypes.c_int * 5)()
        index = self.KERNELS.index(name)
        if name in self._WALLED_PREDICTOR_INFO and self.walls is not None:
            index = self._WALLED_PREDICTOR_INFO[name]
        lib = _build.library()
        err = lib.exahype_aderdg_kernel_info(
            index, int(dtype == torch.float64), self._physics_id, out)
        _build.check(lib, err, f"kernel_info({name})")
        return dict(zip(("registers", "blocks_per_sm", "threads", "smem", "local"), out))

    # ------------------------------------------------------- solver protocol

    def step(self, u, dt, return_face_fluxes: bool = False):
        """One step; a fresh tensor (``u`` is not modified).  With
        ``return_face_fluxes``, ``(new, [fhat_hi per axis])`` as
        :meth:`ADERDGSolver.step` returns them."""
        if not u.is_cuda:
            return self.solver.step(u, dt, return_face_fluxes)
        new, faces, fvwall = self.predictor_volume(u, dt)
        return self.face_surface(new, faces, dt, return_face_fluxes, fvwall)

    def run(self, u, n_steps: int, dt):
        for _ in range(n_steps):
            u = self.step(u, dt)
        return u

    def reset_launches(self):
        for name in self.launches:
            self.launches[name] = 0

    def dofs(self) -> int:
        return self.solver.dofs()

    def cfl_dt(self, u, cfl: float | None = None):
        return self.solver.cfl_dt(u, cfl=cfl)

    def total_mass(self, u):
        return self.solver.total_mass(u)
