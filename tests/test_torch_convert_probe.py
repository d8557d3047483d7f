"""``aderdg_from_jax`` checks the physics it is told against the JAX
solver's callbacks (ROADMAP Queue 3): the port's pair and the JAX pair
evaluate one seeded float64 probe state that the physics admits, along
every axis's normal, and a difference beyond a few roundings raises
``SemanticError``.  For every physics name the converter knows: a JAX
solver crosses with its own constants and raises with another (γ = 1.4
against 5/3 for Euler; another μ or Prandtl number for Navier–Stokes,
whose viscous pair is probed too; another ρ, λ or μ for the elastic
systems; another system of the same shape for the heterogeneous ones,
which take no constants).  The named reflect pair is probed against the
JAX solver's ``reflect_fn``/``reflect_flux_fn``, and ``limited_from_jax``
goes through the same check.
"""

import numpy as np
import pytest

from exahype_tpu.models import curvilinear as jc
from exahype_tpu.models import elastic as jel
from exahype_tpu.models import navier_stokes as jns
from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu.models.aderdg import euler_reflect, euler_reflect_flux, wrap_var_last
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu_torch.convert import _probe, aderdg_from_jax, limited_from_jax
from exahype_tpu_torch.utils.errors import SemanticError


def _var_last(pair):
    return dict(flux_fn=wrap_var_last(pair[0]), max_eigenvalue_fn=wrap_var_last(pair[1]))


def _doubled(pair):
    """Another system of the same shape: the flux times two."""
    flux, eig = pair
    return (lambda q, n: 2.0 * flux(q, n)), eig


def _jax(name, bad=False):
    """A JAX solver of ``name`` (``bad``: built with other constants, or for
    the heterogeneous systems another system of the same shape) and the
    keywords that name the good constants."""
    if name == "euler":
        flux, eig = jax_euler_physics(dim=2, n_real=4, gamma=5 / 3 if bad else 1.4)
        return JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(3, 3), flux_fn=flux,
                         max_eigenvalue_fn=eig), dict(gamma=1.4)
    if name == "navier_stokes":
        f, e, vf, ve = jns.navier_stokes(dim=2, mu=0.02 if bad else 0.01, prandtl=0.7, gamma=1.4)
        return JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(3, 3), **_var_last((f, e)),
                         visc_flux_fn=jns.wrap_visc_var_last(vf),
                         visc_eigenvalue_fn=wrap_var_last(ve)), dict(
            physics="navier_stokes", gamma=1.4, mu=0.01, prandtl=0.7)
    mat = dict(rho=1.3, lam=2.5, mu=0.7)
    bad_mat = dict(rho=1.3, lam=2.5, mu=0.9)
    if name == "elastic":
        pair = jel.elastic(**(bad_mat if bad else mat))
        return JaxSolver(dim=2, order=3, n_vars=5, grid_shape=(3, 3), **_var_last(pair)), dict(
            physics=name, **mat)
    if name == "elastic3d":
        pair = jel.elastic3d(**(bad_mat if bad else mat))
        return JaxSolver(dim=3, order=2, n_vars=9, grid_shape=(2, 2, 2),
                         **_var_last(pair)), dict(physics=name, **mat)
    if name == "curvilinear_elastic":
        pair = jc.curvilinear_physics(*jel.elastic(**(bad_mat if bad else mat)), dim=2,
                                      n_wave=5)
        return JaxSolver(dim=2, order=3, n_vars=10, grid_shape=(3, 3),
                         **_var_last(pair)), dict(physics=name, **mat)
    pair = jel.elastic3d_heterogeneous() if name == "elastic3d_het" else (
        jel.elastic_heterogeneous())
    pair = _doubled(pair) if bad else pair
    dim, nv = (3, 12) if name == "elastic3d_het" else (2, 8)
    return JaxSolver(dim=dim, order=2, n_vars=nv, grid_shape=(2,) * dim,
                     **_var_last(pair)), dict(physics=name)


NAMES = ["euler", "navier_stokes", "elastic", "elastic3d", "elastic_het", "elastic3d_het",
         "curvilinear_elastic"]


@pytest.mark.parametrize("name", NAMES)
def test_a_wrong_constant_raises(name):
    good, kw = _jax(name)
    assert aderdg_from_jax(good, device="cpu", **kw).n_vars == good.n_vars
    bad, _ = _jax(name, bad=True)
    what = "visc_flux_fn" if name == "navier_stokes" else "flux_fn"
    with pytest.raises(SemanticError, match=f"does not reproduce the JAX solver's {what}"):
        aderdg_from_jax(bad, device="cpu", **kw)


def test_the_probe_admits_the_physics():
    """The Euler probe has positive density and pressure (its wave speed,
    √(γp/ρ), is finite), the heterogeneous one positive materials."""
    js, kw = _jax("euler")
    ts = aderdg_from_jax(js, device="cpu", **kw)
    q = _probe("euler", 2, 4, 2)
    assert np.all(q[:, :, 0] > 0)
    p = 0.4 * (q[:, :, 3] - 0.5 * (q[:, :, 1] ** 2 + q[:, :, 2] ** 2) / q[:, :, 0])
    assert np.all(p > 0)
    assert ts.flux_fn.physics.gamma == 1.4
    assert np.all(_probe("elastic_het", 2, 8, 2)[:, :, 5:] > 0)


def test_the_named_reflect_pair_is_probed():
    """A reflective Euler solver (``euler_reflect``: the normal momentum
    negated) crosses with ``walls="euler"`` and raises with
    ``walls="noslip"`` (every momentum negated)."""
    flux, eig = jax_euler_physics(dim=2, n_real=4)
    js = JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(3, 3), flux_fn=flux,
                   max_eigenvalue_fn=eig, boundary="reflective", reflect_fn=euler_reflect(2),
                   reflect_flux_fn=euler_reflect_flux(2))
    assert aderdg_from_jax(js, gamma=1.4, walls="euler", device="cpu").is_wall(0)
    with pytest.raises(SemanticError, match="does not reproduce the JAX solver's reflect_fn"):
        aderdg_from_jax(js, gamma=1.4, walls="noslip", device="cpu")


def test_limited_from_jax_goes_through_the_check():
    js, _ = _jax("euler", bad=True)  # γ = 5/3
    jl = JaxLimited(js)
    assert limited_from_jax(jl, gamma=5 / 3, device="cpu").solver.n_vars == 4
    with pytest.raises(SemanticError, match="does not reproduce"):
        limited_from_jax(jl, gamma=1.4, device="cpu")
