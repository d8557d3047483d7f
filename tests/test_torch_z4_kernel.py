"""The Z4 step on ``CudaADERDG`` (K1's fused-algebra variant, K1 d) on the
CPU: its plain stages against the plain solver and against the JAX package,
the crossing of a JAX ``PallasADERDG`` over the fused Z4 solver, and the
wrapper's refusals.

On CPU tensors ``CudaADERDG`` runs its kernels' plain versions
(``ADERDGSolver.predictor_volume`` / ``face_surface``), so its step, run and
halves are bitwise the plain solver's.  Against JAX's
``make_z4_solver(impl="soa", fused_rhs="soa")`` step and its
``with_pallas_rhs(interpret=True)`` step (K5's reference) the bar is
rtol 1e-12 / atol 1e-14 in f64, for each parameter family of
``tests/test_torch_z4.py``, on the noisy gauge wave of
``tests/test_z4.py::_noisy_gauge_wave`` made from a seed with NumPy.

The chain to the TPU kernel: ``tests/test_z4.py::
test_z4_soa_fused_pallas_parity`` (slow tier, ~530 s in interpret mode)
holds JAX's ``PallasADERDG`` on the SoA Z4 solver at 1e-12 to the same base
``ADERDGSolver.step`` these tests hold the port to; it is not repeated
here.  The CUDA kernels themselves are held to these plain stages on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu.models.rhs_pallas import with_pallas_rhs
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    state_from_numpy,
    state_to_numpy,
    z4_solver_from_jax,
)
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import ADERDGSolver, euler_physics
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.limiter import LimitedADERDG
from exahype_tpu_torch.models.rhs_cuda import with_cuda_rhs
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRIDS = [(4, 2, 4), (2, 2, 2)]
DX = 0.25
DT = 1e-3
RTOL, ATOL = 1e-12, 1e-14

#: The parameter families of ``tests/test_torch_z4.py::FAMILIES``.
FAMILIES = [
    dict(),
    dict(slicing="1+log", kappa1=0.3, kappa2=0.2),
    dict(f=0.7, m=1.5, kappa1=0.1),
]
FAMILY_IDS = ["harmonic", "1+log_damped", "f_m_kappa"]


def _noisy_gauge_wave(shape, seed=3, eps=1e-4):
    """``tests/test_z4.py::_noisy_gauge_wave``'s noise, made with NumPy."""
    return eps * np.random.default_rng(seed).standard_normal(shape)


def _port(grid, **kw):
    return tz.make_z4_solver(3, 2, grid, dx=DX, impl="soa", fused_rhs="soa", device="cpu",
                             **kw)


def _state(grid):
    """The noisy gauge wave on the port's solver (float64 NumPy)."""
    sol = _port(grid)
    return state_to_numpy(tz.gauge_wave_state(sol, amplitude=0.01)) + _noisy_gauge_wave(
        sol.state_shape)


@pytest.fixture(scope="module", params=range(len(FAMILIES)), ids=FAMILY_IDS)
def jax_run(request):
    """For one family, at ``(4, 2, 4)``: the JAX fused solver, the initial
    state, its step and two chained steps, and one step through
    ``with_pallas_rhs(interpret=True)``."""
    kw = FAMILIES[request.param]
    grid = GRIDS[0]
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=grid, dx=DX, impl="soa",
                           fused_rhs="soa", **kw)
    Q = _state(grid)
    one = np.asarray(js.step(jnp.asarray(Q), DT))
    two = np.asarray(js.step(jnp.asarray(one), DT))
    pallas = np.asarray(with_pallas_rhs(js, interpret=True).step(jnp.asarray(Q), DT))
    return kw, js, Q, one, two, pallas


# ------------------------------------------------------- against plain, bitwise


@pytest.mark.parametrize("kw", FAMILIES, ids=FAMILY_IDS)
@pytest.mark.parametrize("grid", GRIDS)
def test_cpu_stages_are_the_plain_solver_bitwise(grid, kw):
    """``step``, ``run``, ``predictor_volume`` and ``face_surface`` of the
    kernel wrapper on CPU tensors give the plain solver's bits."""
    sol = _port(grid, **kw)
    cu = CudaADERDG(sol)
    assert cu.kernels == ("aderdg_predictor_volume_z4", "aderdg_face_flux_z4",
                          "aderdg_surface_update_z4")
    assert cu.ncp and cu.walls is None
    u = state_from_numpy(_state(grid), device="cpu")
    u0 = u.clone()
    new_k, faces_k, fv_k = cu.predictor_volume(u, DT)
    new_p, faces_p, fv_p = sol.predictor_volume(u, DT)
    assert fv_k is None and fv_p is None
    assert torch.equal(new_k, new_p) and torch.equal(faces_k, faces_p)
    assert faces_k.shape == sol.face_shape and not faces_k[:, 2:].any()  # F̄ rows zero
    stage_p = sol.face_surface(new_p, faces_p, DT)
    stage_k = cu.face_surface(new_k, faces_k, DT)
    assert stage_k is new_k and torch.equal(stage_k, stage_p)  # in place, as on the card
    step_k, step_p = cu.step(u, DT), sol.step(u, DT)
    assert torch.equal(step_k, step_p) and torch.equal(step_k, stage_p)
    assert torch.equal(cu.run(u, 2, DT), sol.run(u, 2, DT))
    assert torch.equal(u, u0)
    out, fluxes = cu.step(u, DT, return_face_fluxes=True)
    ref, ref_fluxes = sol.step(u, DT, return_face_fluxes=True)
    assert torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(fluxes, ref_fluxes))
    assert cu.launches == {name: 0 for name in cu.kernels}  # CPU tensors launch nothing
    assert (step_k - u).abs().max().item() > 1e-5  # the step moved the state


def test_face_stage_halves_compose_the_plain_face_surface():
    """``ncp_half`` and ``ncp_term`` (the plain versions of the face flux
    kernel's second output and of the update's NCP term), with
    ``interface_flux`` and ``surface_term``, rebuild ``face_surface``
    bitwise, and the half-fluctuation is the midpoint NCP."""
    sol = _port((3, 2, 4))
    u = state_from_numpy(_state((3, 2, 4)), device="cpu")
    new, faces, _ = sol.predictor_volume(u, DT)
    fs = sol.face_flux_shape
    out = new
    for d in range(3):
        parts = [faces[d, k].reshape(fs) for k in range(4)]
        half = sol.ncp_half(*parts, d)
        q_plus = torch.roll(parts[0], -1, sol.grid_axis(d) - 1)
        mid = 0.5 * (parts[1] + q_plus)
        assert torch.equal(half, 0.5 * sol.ncp_fn(mid, q_plus - parts[1], d, sol.var_axis - 1))
        out = sol.surface_term(out, sol.interface_flux(*parts, d), d, DT)
        out = sol.ncp_term(out, half, d, DT)
    assert torch.equal(out, sol.face_surface(new, faces, DT))


# ------------------------------------------------------------ against JAX


def test_step_matches_jax_and_pallas_interpret(jax_run):
    kw, js, Q, one, _, pallas = jax_run
    cu = CudaADERDG(_port(GRIDS[0], **kw))
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    assert got.shape == js.state_shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    assert np.abs(got - Q).max() > 1e-5


def test_run_matches_chained_jax_steps(jax_run):
    kw, _, Q, _, two, _ = jax_run
    cu = CudaADERDG(_port(GRIDS[0], **kw))
    got = state_to_numpy(cu.run(state_from_numpy(Q, device="cpu"), 2, DT))
    np.testing.assert_allclose(got, two, rtol=RTOL, atol=ATOL)


def test_small_grid_step_matches_jax():
    """The second grid, ``(2, 2, 2)``: two cells a row, so each cell is its
    own neighbour's neighbour."""
    grid = GRIDS[1]
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=grid, dx=DX, impl="soa", fused_rhs="soa")
    Q = _state(grid)
    ref = np.asarray(js.step(jnp.asarray(Q), DT))
    got = state_to_numpy(CudaADERDG(_port(grid)).step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_pallas_aderdg_crosses_to_cuda_aderdg(jax_run):
    """A JAX ``PallasADERDG`` over the fused Z4 solver crosses to
    ``CudaADERDG`` over the port's solver, parameters and state carried."""
    kw, js, Q, one, _, _ = jax_run
    cu = z4_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **kw)
    assert isinstance(cu, CudaADERDG) and cu.ncp
    sol = cu.solver
    assert (sol.dim, sol.order, sol.grid_shape, sol._dxs, sol.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert sol.rhs_all_fn.physics.params == tz._tag(**{
        **dict(slicing="harmonic", f=1.0, m=2.0, kappa1=0.0, kappa2=0.0), **kw}).params
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)
    # The base solver alone still crosses to the plain solver.
    assert isinstance(z4_solver_from_jax(js, device="cpu", **kw), ADERDGSolver)


# --------------------------------------------------------------- refusals


def test_refuses_the_per_axis_ncp_branch():
    """The per-axis NCP branch was refused for the shifted system until its
    kernel existed; it is now accepted with that kernel
    (``tests/test_torch_z4_shift_per_axis.py``)."""
    cu = CudaADERDG(tz.make_z4_shift_solver(3, 2, (2, 2, 2), dx=DX, impl="soa", device="cpu"))
    assert cu.per_axis and cu.kernels == (
        "aderdg_predictor_volume_per_axis_z4_shift", "aderdg_face_flux_z4_shift",
        "aderdg_surface_update_z4_shift")


def test_refuses_a_solver_already_on_k5():
    """``with_cuda_rhs`` puts ``rhs_all_fn`` on K5; the step kernels compile
    the algebra in and would bypass it, so the wrapper refuses (it does not
    read the tag through ``CudaRHS``)."""
    with pytest.raises(LoweringError, match="with_cuda_rhs"):
        CudaADERDG(with_cuda_rhs(_port((2, 2, 2))))


def test_refuses_walls():
    sol = _port((2, 2, 2), boundary="outflow", wall_axes=(0,))
    assert sol.is_wall(0)
    with pytest.raises(LoweringError, match="periodic only.*Queue 2 K1 d"):
        CudaADERDG(sol)


@pytest.mark.parametrize("dim,order", [(3, 3), (2, 4)])
def test_refuses_other_dims_and_orders(dim, order):
    sol = tz.make_z4_solver(dim, order, (2,) * dim, dx=DX, impl="soa", fused_rhs="soa",
                            device="cpu")
    with pytest.raises(LoweringError, match=f"z4, dim={dim}, order={order}.*Queue 1 item 4"):
        CudaADERDG(sol)


@pytest.mark.parametrize("order", [2, 3])
def test_accepts_the_2d_orders(order):
    """The fused 2-D solver at orders 2 and 3 has kernels of its own
    (``csrc/aderdg_z4_2d.cu``, ``aderdg_z4_2d_p3.cu``)."""
    cu = CudaADERDG(tz.make_z4_solver(2, order, (2, 2), dx=DX, impl="soa", fused_rhs="soa",
                                      device="cpu"))
    suffix = "" if order == 2 else "_p3"
    assert cu.kernels == tuple(f"aderdg_{k}{suffix}_2d_z4" for k in (
        "predictor_volume", "face_flux", "surface_update")) and not cu.per_axis


def _swap(sol, **callbacks):
    """The solver with some callbacks replaced (the constructor's checks
    have passed on the Z4 ones)."""
    for name, fn in callbacks.items():
        setattr(sol, name, fn)
    return sol


@pytest.mark.parametrize("option", ["rhs_all_fn", "source_fn", "ncp_fn", "max_eigenvalue_fn"])
def test_refuses_untagged_callbacks(option):
    sol = _port((2, 2, 2))
    plain = getattr(sol, option)
    with pytest.raises(LoweringError, match="fused vacuum Z4 system only.*Queue 2 K1 d"):
        CudaADERDG(_swap(sol, **{option: lambda *a, _f=plain: _f(*a)}))


def test_refuses_callbacks_of_two_parameter_sets():
    sol = _port((2, 2, 2))
    other = _port((2, 2, 2), slicing="1+log")
    with pytest.raises(LoweringError, match="Queue 2 K1 d"):
        CudaADERDG(_swap(sol, ncp_fn=other.ncp_fn))


def test_refuses_ncp_on_other_physics():
    flux, eig = euler_physics(3)
    z4 = _port((2, 2, 2))
    sol = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu", source_fn=z4.source_fn)
    with pytest.raises(LoweringError, match="source_fn is set"):
        CudaADERDG(sol)


def test_face_stage_halves_launch_only_on_the_card():
    """The two face launches have no plain path of their own: on CPU
    tensors they raise (``face_surface`` takes the plain stage)."""
    flux, eig = euler_physics(3)
    assert not CudaADERDG(ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu")).ncp
    cu = CudaADERDG(_port((2, 2, 2)))
    u = torch.zeros(cu.solver.state_shape, dtype=torch.float64)
    faces = torch.zeros(cu.solver.face_shape, dtype=torch.float64)
    with pytest.raises(LoweringError, match="on the card"):
        cu.face_flux(faces)
    with pytest.raises(LoweringError, match="on the card"):
        cu.surface_update(u, u, DT, fhalf=u)


def test_kernel_params_are_k5s():
    """The Z4 kernels take K5's parameters: the slicing's id, f, m, κ₁, κ₂."""
    cu = CudaADERDG(_port((2, 2, 2), slicing="1+log", f=0.7, m=1.5, kappa1=0.1, kappa2=0.3))
    assert cu._params.tolist() == [1.0, 0.7, 1.5, 0.1, 0.3]
    assert cu._physics_id == 3
    assert CudaADERDG.KERNELS.index("aderdg_predictor_volume_z4") == 7  # the occupancy index


# ---------------------------------------------- the refusals' ROADMAP items


def test_limiter_refusals_name_queue1_item9():
    flux, eig = euler_physics(3)
    sol = ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu")
    row = dict(troubled_granularity="row", device="cpu")
    # JAX's own error for the means fallback with a capacity.
    with pytest.raises(ValueError, match="troubled_capacity requires fallback='subcell'"):
        LimitedADERDG(sol, troubled_capacity=8, fallback="means", **row)
    with pytest.raises(SemanticError, match="candidate.*ROADMAP.md, Queue 1 item 9 \\(9.5\\)"):
        LimitedADERDG(sol, troubled_capacity=8, overflow_fallback="candidate", **row)
    # The NCP solver builds a limiter since item 9.4; the sweep kernel has no
    # vacuum Z4 instance (the Z4+GRHD p2 one is K3 a's first): Queue 2 K3 a.
    z4 = LimitedADERDG(_port((2, 2, 2)), troubled_capacity=8, **row)
    assert z4.troubled_capacity == 4 and z4.solver.ncp_fn is not None
    from exahype_tpu_torch.models import subcell_cuda

    with pytest.raises(LoweringError, match=r"ROADMAP.md, Queue 2 K3 a"):
        subcell_cuda.check_physics(LimitedADERDG(_port((2, 2, 2)), troubled_capacity=8,
                                                 subcell_cuda=True, **row))


def test_driver_observables_names_queue1_item6():
    flux, eig = euler_physics(3)
    lim = LimitedADERDG(ADERDGSolver(3, 3, 5, (2, 2, 2), flux, eig, device="cpu"),
                        troubled_capacity=8, troubled_granularity="row", device="cpu")
    with pytest.raises(SemanticError, match=r"ROADMAP.md, Queue 1 item 6$"):
        lim.driver_observables()


def test_viscous_crossing_cites_the_done_item():
    from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
    from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics

    flux, eig = jax_euler_physics(dim=2, n_real=4)
    viscous = JaxSolver(dim=2, order=3, n_vars=4, grid_shape=(4, 4), flux_fn=flux,
                        max_eigenvalue_fn=eig,
                        visc_flux_fn=lambda q, g, d, va: 0.0 * q,
                        visc_eigenvalue_fn=lambda q, d, va: 0.0 * q[0])
    with pytest.raises(SemanticError, match=r"Queue 1, done: item 3, the viscous fluxes"):
        aderdg_from_jax(viscous, gamma=1.4, device="cpu")
