"""The vacuum Z4 system on ``CudaADERDG``'s per-axis and 2-D kernels (K1 d's
per-axis NCP branch, ``csrc/aderdg_z4_per_axis.cu``, and the 2-D steps at
orders 2 and 3, ``csrc/aderdg_z4_2d.cu`` and ``aderdg_z4_2d_p3.cu``) on the
CPU: the wrapper's stages against the plain solver, the steps against the
JAX package's, the crossing of JAX solvers, and what still raises.

On CPU tensors ``CudaADERDG`` runs its kernels' plain versions
(``ADERDGSolver.predictor_volume`` / ``face_surface``), so its stages are
bitwise the plain solver's and launch nothing.  Against JAX's
``make_z4_solver(dim=2, order, impl="soa", fused_rhs)`` step (XLA, eager)
the bar is 1e-12·max(1, max|ref|) in float64, for orders 2 and 3, per-axis
and fused, on the noisy gauge wave of ``tests/test_z4.py::_noisy_gauge_wave``
(its κ₁ = 0.5, κ₂ = 0.1, (4, 2) cells at dx = 0.25, dt = 1e-3) made from a
seed with NumPy.  The JAX steps run once per form and module, eagerly (a
jit costs more here than the two steps).  The Pallas kernel itself and the
example's run are ``tests/test_torch_z4_2d_pallas.py`` and
``tests/test_torch_z4_2d_example.py``; the CUDA kernels are held to these
plain stages on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models import z4 as jz
from exahype_tpu.models.aderdg_pallas import PallasADERDG
from exahype_tpu_torch.convert import state_from_numpy, state_to_numpy, z4_solver_from_jax
from exahype_tpu_torch.models import z4 as tz
from exahype_tpu_torch.models.aderdg import ADERDGSolver
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG
from exahype_tpu_torch.models.z4_grmhd import make_z4_grmhd_solver
from exahype_tpu_torch.models.z4_matter import make_z4_matter_solver
from exahype_tpu_torch.utils.errors import LoweringError, SemanticError

torch.set_num_threads(1)

GRID = (4, 2)
DX = 0.25
DT = 1e-3
PARAMS = dict(kappa1=0.5, kappa2=0.1)  # tests/test_z4.py's Pallas parity solver

#: (dim, order, fused_rhs) of the forms on the new kernels, and their kernels.
FORMS = [(2, 2, False), (2, 2, "soa"), (2, 3, False), (2, 3, "soa"), (3, 2, False)]
FORM_IDS = ["2d_p2_per_axis", "2d_p2_fused", "2d_p3_per_axis", "2d_p3_fused", "3d_p2_per_axis"]
KERNELS = {
    (2, 2, False): ("aderdg_predictor_volume_per_axis_2d_z4", "aderdg_face_flux_2d_z4",
                    "aderdg_surface_update_2d_z4"),
    (2, 2, "soa"): ("aderdg_predictor_volume_2d_z4", "aderdg_face_flux_2d_z4",
                    "aderdg_surface_update_2d_z4"),
    (2, 3, False): ("aderdg_predictor_volume_per_axis_p3_2d_z4", "aderdg_face_flux_p3_2d_z4",
                    "aderdg_surface_update_p3_2d_z4"),
    (2, 3, "soa"): ("aderdg_predictor_volume_p3_2d_z4", "aderdg_face_flux_p3_2d_z4",
                    "aderdg_surface_update_p3_2d_z4"),
    (3, 2, False): ("aderdg_predictor_volume_per_axis_z4", "aderdg_face_flux_z4",
                    "aderdg_surface_update_z4"),
}


def _grid(dim):
    return GRID if dim == 2 else (2, 2, 2)


def _port(dim, order, fused, **kw):
    return tz.make_z4_solver(dim, order, _grid(dim), dx=DX, impl="soa", fused_rhs=fused,
                             device="cpu", **{**PARAMS, **kw})


def _state(sol):
    """The noisy gauge wave (``tests/test_z4.py::_noisy_gauge_wave``'s
    amplitude and noise, seed 3) on the port's solver, float64 NumPy."""
    q = state_to_numpy(tz.gauge_wave_state(sol, amplitude=0.01))
    return q + 1e-4 * np.random.default_rng(3).standard_normal(sol.state_shape)


def _bar(ref):
    return 1e-12 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def jax_steps():
    """``form -> (js, Q, one step, two steps)``: the JAX solver of a 2-D
    form and its eager XLA steps from the noisy state, each made once."""
    made = {}

    def get(form):
        if form not in made:
            dim, order, fused = form
            js = jz.make_z4_solver(dim=dim, order=order, grid_shape=GRID, dx=DX, impl="soa",
                                   fused_rhs=fused, **PARAMS)
            Q = _state(_port(*form))
            one = np.asarray(js.step(jnp.asarray(Q), DT))
            two = np.asarray(js.step(jnp.asarray(one), DT))
            made[form] = js, Q, one, two
        return made[form]

    return get


# ------------------------------------------------------- against plain, bitwise


@pytest.mark.parametrize("form", FORMS, ids=FORM_IDS)
def test_cpu_stages_are_the_plain_step_bitwise(form):
    """The wrapper's predictor and face stage on CPU tensors compose the
    plain step bit for bit (the face stage in place, as on the card), its
    kernels are the form's, and nothing launches."""
    sol = _port(*form)
    cu = CudaADERDG(sol)
    assert cu.kernels == KERNELS[form] and cu.ncp and cu.walls is None
    assert cu.per_axis == (form[2] is False)
    u = state_from_numpy(_state(sol), device="cpu")
    u0 = u.clone()
    new, faces, fvwall = cu.predictor_volume(u, DT)
    assert fvwall is None and faces.shape == sol.face_shape and not faces[:, 2:].any()
    out = cu.face_surface(new, faces, DT)
    ref = sol.step(u, DT)
    assert out is new and torch.equal(out, ref)
    assert torch.equal(u, u0)
    assert cu.launches == {name: 0 for name in cu.kernels}
    assert (ref - u).abs().max().item() > 1e-5  # the step moved the state


def test_face_halves_launch_only_on_the_card():
    """The two face launches of the 2-D pair have no plain path of their
    own: on CPU tensors they raise (``face_surface`` takes the plain
    stage)."""
    sol = _port(2, 3, False)
    cu = CudaADERDG(sol)
    u = state_from_numpy(_state(sol), device="cpu")
    new, faces, _ = cu.predictor_volume(u, DT)
    with pytest.raises(LoweringError, match="on the card"):
        cu.face_flux(faces)
    with pytest.raises(LoweringError, match="on the card"):
        cu.surface_update(new, torch.zeros(1), DT, fhalf=torch.zeros(1))


# ------------------------------------------------------------ against JAX


@pytest.mark.parametrize("form", FORMS[:4], ids=FORM_IDS[:4])
def test_one_and_two_steps_match_jax(jax_steps, form):
    js, Q, one, two = jax_steps(form)
    cu = CudaADERDG(_port(*form))
    u1 = cu.step(state_from_numpy(Q, device="cpu"), DT)
    got1, got2 = state_to_numpy(u1), state_to_numpy(cu.step(u1, DT))
    assert got1.shape == js.state_shape and np.isfinite(got2).all()
    np.testing.assert_allclose(got1, one, rtol=0, atol=_bar(one))
    np.testing.assert_allclose(got2, two, rtol=0, atol=_bar(two))
    assert np.abs(two - Q).max() > 1e-5


@pytest.mark.parametrize("form", FORMS[:4], ids=FORM_IDS[:4])
def test_z4_solver_from_jax_crosses_each_form(jax_steps, form):
    """``z4_solver_from_jax`` maps the JAX solver of each form to the port's
    (the per-axis NCP without ``rhs_all_fn``, the fused hook with it), and
    ``PallasADERDG`` over it to ``CudaADERDG`` with the form's kernels; the
    crossed solver steps as the JAX one does."""
    js, Q, one, _ = jax_steps(form)
    port = z4_solver_from_jax(js, device="cpu", **PARAMS)
    assert isinstance(port, ADERDGSolver)
    assert (port.dim, port.order, port.grid_shape, port._dxs, port.picard_iters) == (
        js.dim, js.order, js.grid_shape, js._dxs, js.picard_iters)
    assert (port.rhs_all_fn is None) == (form[2] is False) and port.ncp_fn is not None
    cu = z4_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu", **PARAMS)
    assert isinstance(cu, CudaADERDG) and cu.kernels == KERNELS[form]
    got = state_to_numpy(cu.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, one, rtol=0, atol=_bar(one))


def test_z4_solver_from_jax_crosses_the_3d_per_axis_solver():
    js = jz.make_z4_solver(dim=3, order=2, grid_shape=(2, 2, 2), dx=DX, impl="soa")
    assert js.rhs_all_fn is None
    cu = z4_solver_from_jax(PallasADERDG(js, interpret=True), device="cpu")
    assert isinstance(cu, CudaADERDG) and cu.per_axis
    assert cu.kernels == KERNELS[(3, 2, False)]


# --------------------------------------------------------------- refusals


@pytest.mark.parametrize("make", [tz.make_z4_shift_solver, make_z4_matter_solver,
                                  make_z4_grmhd_solver], ids=["shift", "matter", "grmhd"])
def test_other_systems_per_axis_and_2d_forms_still_raise(make):
    """The shifted, Z4+GRHD and Z4+GRMHD systems have the per-axis and 2-D
    order-2 kernels (``tests/test_torch_z4_shift_2d.py``,
    ``tests/test_torch_z4_matter_2d.py``, ``tests/test_torch_z4_grmhd_2d.py``):
    their forms, once refused, are accepted with their kernels' names."""
    name = make.__name__[len("make_"):-len("_solver")]
    for grid, fused in (((2, 2, 2), False), ((4, 2), False), ((4, 2), "soa")):
        cu = CudaADERDG(make(len(grid), 2, grid, dx=DX, fused_rhs=fused, device="cpu"))
        predictor = "aderdg_predictor_volume" + ("_per_axis" if fused is False else "")
        dim = "_2d" if len(grid) == 2 else ""
        assert cu.per_axis == (fused is False)
        assert cu.kernels == (f"{predictor}{dim}_{name}", f"aderdg_face_flux{dim}_{name}",
                              f"aderdg_surface_update{dim}_{name}")


def test_what_else_still_raises():
    """The source_fn-only branch and NCP walls (Queue 2 K1 d), 2-D Z4 at
    other orders and 3-D Z4 at orders other than 2 (Queue 1 item 4), the
    einsum algebra (Queue 1 item 7.4)."""
    sol = _port(2, 2, False)
    sol.ncp_fn = None
    with pytest.raises(LoweringError, match="source_fn-only branch.*Queue 2 K1 d"):
        CudaADERDG(sol)
    walled = _port(2, 3, False, boundary="outflow", wall_axes=(0,))
    with pytest.raises(LoweringError, match="periodic only.*Queue 2 K1 d"):
        CudaADERDG(walled)
    for dim, order, fused in ((2, 1, False), (2, 4, "soa"), (3, 3, False)):
        sol = tz.make_z4_solver(dim, order, (2,) * dim, dx=DX, fused_rhs=fused, device="cpu")
        with pytest.raises(LoweringError, match=f"z4, dim={dim}, order={order}.*Queue 1 item 4"):
            CudaADERDG(sol)
    with pytest.raises(SemanticError, match="Queue 1 item 7.4"):
        tz.make_z4_solver(2, 3, GRID, dx=DX, impl="einsum", device="cpu")
