"""The Z4 converters and ``grid_solver_from_jax`` check the parameters they
are told against the JAX solver's callbacks (ROADMAP Queue 3): the port's
callbacks and the JAX ones evaluate one seeded float64 probe state, and a
difference beyond the bar raises ``SemanticError``.

Z4 (``z4_solver_from_jax``, ``z4_shift_solver_from_jax``,
``z4_matter_solver_from_jax``, ``z4_grmhd_solver_from_jax`` and
``limited_from_jax(..., physics="z4_matter")``): ``source_fn``, each axis's
``ncp_fn`` at a seeded gradient, flux, wave speed and ``rhs_all_fn`` where
set, at 1e-12·max(1, max|JAX|), on a state whose lapse is off 1, whose Θ,
Z_i and other slots carry noise, with an admissible fluid and a field
nowhere zero with ψ ≠ 0.  Each case is a JAX solver built with a parameter
off its default, crossed with the default named (κ₁, f, slicing, the shift
condition, Γ, c_h) and then with the right one, einsum and SoA alike.  FV:
the JAX kernel's ``Flux`` and ``maxEigenvalue`` and its ``eigenvalue_fn``
against the port's Euler ones at the γ named, for both specs, and a JAX
kernel whose flux is not Euler's.  The JAX solvers are 2-D and built once
per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import euler as jax_euler
from exahype_tpu.models import z4 as jz
from exahype_tpu.models import z4_grmhd as jg
from exahype_tpu.models import z4_matter as jm
from exahype_tpu.models.fv import build_fv_rusanov_kernel as jax_fv
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu.models.rusanov import build_rusanov_kernel as jax_rusanov
from exahype_tpu.parallel.grid import TpuPatchGrid as JaxTpuPatchGrid
from exahype_tpu.parallel.solver import GridSolver as JaxGridSolver
from exahype_tpu_torch.convert import (
    _z4_probe,
    grid_solver_from_jax,
    limited_from_jax,
    z4_grmhd_solver_from_jax,
    z4_matter_solver_from_jax,
    z4_shift_solver_from_jax,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import z4_grmhd as tg
from exahype_tpu_torch.utils.errors import SemanticError

GRID = (2, 2)
#: (JAX maker, converter, the parameter the JAX solver is built with, the
#: same parameter at its default): one case a parameter.
CASES = {
    "kappa1": (jz.make_z4_solver, z4_solver_from_jax, dict(kappa1=0.5, kappa2=0.1),
               dict(kappa1=0.0, kappa2=0.1)),
    "f": (jz.make_z4_solver, z4_solver_from_jax, dict(f=0.0), dict(f=1.0)),
    "slicing": (jz.make_z4_solver, z4_solver_from_jax, dict(slicing="1+log"),
                dict(slicing="harmonic")),
    "shift": (jz.make_z4_shift_solver, z4_shift_solver_from_jax, dict(shift="gamma_driver"),
              dict(shift="frozen")),
    "gamma": (jm.make_z4_matter_solver, z4_matter_solver_from_jax, dict(gamma=4.0 / 3.0),
              dict(gamma=5.0 / 3.0)),
    "c_h": (jg.make_z4_grmhd_solver, z4_grmhd_solver_from_jax, dict(c_h=2.0), dict(c_h=1.0)),
}


@pytest.fixture(scope="module")
def jax_solvers():
    """``{(case, impl): JAX solver}``: each case's solver, per-axis, in the
    einsum and the SoA formulations."""
    return {(case, impl): make(dim=2, order=2, grid_shape=GRID, dx=0.25, impl=impl, **built)
            for case, (make, _, built, _) in CASES.items() for impl in ("einsum", "soa")}


@pytest.mark.parametrize("case", list(CASES))
def test_a_misnamed_parameter_raises(jax_solvers, case):
    _, convert, built, default = CASES[case]
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's"):
        convert(jax_solvers[(case, "einsum")], device="cpu", **default)


@pytest.mark.parametrize("impl", ["einsum", "soa"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_right_parameters_cross(jax_solvers, case, impl):
    """The same solvers with their own parameters named cross, the einsum
    formulation (1e-13 from the port's SoA algebra) as the SoA one."""
    _, convert, built, _ = CASES[case]
    js = jax_solvers[(case, impl)]
    port = convert(js, device="cpu", **built)
    assert port.n_vars == js.n_vars and port.rhs_all_fn is None


def test_the_message_names_the_parameters(jax_solvers):
    _, convert, _, default = CASES["c_h"]
    with pytest.raises(SemanticError, match="flux_fn along axis 0.*c_h=1.0.*name the ones"):
        convert(jax_solvers[("c_h", "einsum")], device="cpu", **default)


def test_the_fused_hook_is_probed():
    """A fused JAX solver (``fused_rhs="soa"``, ``rhs_all_fn`` set) crosses
    to the port's fused solver; κ₂ alone mis-named (it enters with κ₁ on
    the Θ and Z rows) raises."""
    js = jz.make_z4_solver(2, 2, GRID, dx=0.25, kappa1=0.5, kappa2=0.3, fused_rhs="soa")
    assert z4_solver_from_jax(js, kappa1=0.5, kappa2=0.3, device="cpu").rhs_all_fn is not None
    with pytest.raises(SemanticError, match="does not reproduce"):
        z4_solver_from_jax(js, kappa1=0.5, device="cpu")


def test_the_probe_sees_each_parameter():
    """The probe state: the lapse off 1, Θ and Z_i nonzero, the metric
    positive definite, the fluid admissible, the field nowhere zero and ψ ≠
    0."""
    q, g0, g1 = _z4_probe(47, 2, 2)
    q = np.moveaxis(q, 2, -1)
    assert np.all(np.abs(q[..., 0] - 1.0) > 0) and np.abs(q[..., 0] - 1.0).max() > 0.1
    assert np.all(q[..., 13] != 0) and np.all(q[..., 14:17] != 0)
    g = q[..., [1, 2, 3, 2, 4, 5, 3, 5, 6]].reshape(q.shape[:-1] + (3, 3))
    assert np.all(np.linalg.eigvalsh(g) > 0)
    assert np.all(q[..., 43:46] != 0) and np.all(q[..., 46] != 0)
    assert bool(tg.z4_grmhd_admissible()(torch.from_numpy(q), q.ndim - 1).all())
    assert g0.shape == g1.shape == np.moveaxis(q, -1, 2).shape


def test_limited_from_jax_goes_through_the_z4_check(jax_solvers):
    jl = JaxLimited(jax_solvers[("gamma", "soa")])
    lim = limited_from_jax(jl, physics="z4_matter", gamma=4.0 / 3.0, device="cpu")
    assert lim.solver.n_vars == 43
    with pytest.raises(SemanticError, match="does not reproduce"):
        limited_from_jax(jl, physics="z4_matter", gamma=5.0 / 3.0, device="cpu")


# ------------------------------------------------------------------ FV

FV_GRID = (2, 2, 2)
FV_WIDTH = dict(dim=3, patch_size=4, halo_size=1, n_real=5, n_aux=0, n_patches=8)


def _wave_speed(cells):
    out = jax_euler.max_eigenvalue_tpu(cells, 0, dim=3)
    for d in (1, 2):
        out = jnp.maximum(out, jax_euler.max_eigenvalue_tpu(cells, d, dim=3))
    return out


def _fv(kb, eigenvalue_fn=_wave_speed):
    return JaxGridSolver(JaxTpuPatchGrid(kb.config, FV_GRID), kb, dx=1.0 / 8, cfl=0.45,
                         eigenvalue_fn=eigenvalue_fn, backend="pallas", kernel_dt="lambda",
                         interpret=True)


@pytest.mark.parametrize("spec", ["fv", "rusanov"])
def test_grid_solver_gamma_is_probed(spec):
    """The JAX default Euler (γ = 1.4) crosses with γ = 1.4 and raises with
    γ = 5/3, for both specs."""
    js = _fv({"fv": jax_fv, "rusanov": jax_rusanov}[spec](**FV_WIDTH))
    assert grid_solver_from_jax(js, spec=spec, gamma=1.4, device="cpu").cfl == 0.45
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's Flux"):
        grid_solver_from_jax(js, spec=spec, gamma=5.0 / 3.0, device="cpu")


def test_grid_solver_refuses_another_flux():
    """A JAX FV kernel built with a custom ``flux_impl`` (Euler's doubled)
    does not cross as Euler; nor does an ``eigenvalue_fn`` that is not the
    Euler wave speed."""
    flux = jax_euler.flux_v_fn(dim=3, n_real=5)
    js = _fv(jax_fv(**FV_WIDTH, flux_impl=lambda q, n: 2.0 * flux(q, n)))
    with pytest.raises(SemanticError, match="Flux along axis 0.*custom flux_impl"):
        grid_solver_from_jax(js, spec="fv", gamma=1.4, device="cpu")
    js = _fv(jax_fv(**FV_WIDTH), eigenvalue_fn=lambda cells: 2.0 * _wave_speed(cells))
    with pytest.raises(SemanticError, match="eigenvalue_fn"):
        grid_solver_from_jax(js, spec="fv", gamma=1.4, device="cpu")
