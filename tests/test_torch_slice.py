"""The port's main path as a whole: the benchmark's ADER-DG p3 3-D Euler
step, built on both sides from one JAX configuration.

Depth is cut (a few cells instead of ``(256, 8, 128)``); the order, the
physics, ``dx`` and the initial state's recipe are ``bench.py``'s, ``dt``
is under the CFL limit.
f64 at rtol=0, atol=1e-12 per step (1e-11 after 3 steps, the bar
``tests/test_aderdg.py`` holds multi-step Pallas runs to).
"""

import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exahype_tpu.models.aderdg import ADERDGSolver as JaxSolver
from exahype_tpu.models.aderdg import euler_physics as jax_euler_physics
from exahype_tpu_torch.convert import (
    aderdg_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from exahype_tpu_torch.models.aderdg_cuda import CudaADERDG

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
#: Under the CFL limit (6.26e-5 at dx = 1/256 on this state); bench.py's
#: fixed 1e-4 exceeds it, and the state then grows step by step.
DT = 5e-5


def bench_config(grid):
    """``bench.py::main``'s solver at a cut grid, and its initial state."""
    flux, eig = jax_euler_physics(dim=3, n_real=5)
    js = JaxSolver(
        dim=3, order=3, n_vars=5, grid_shape=grid, flux_fn=flux,
        max_eigenvalue_fn=eig, dx=1.0 / 256,
    )
    rng = np.random.default_rng(0)
    va = js.var_axis
    no_var = js.state_shape[:va] + js.state_shape[va + 1:]
    rho = 1.0 + 0.2 * rng.random(no_var)
    comps = [rho, rho, 0.5 * rho, 0.25 * rho, 5.0 + 0.5 * rho * 1.3125]
    return js, np.stack(comps, axis=va)


def test_slice_three_steps_match_jax():
    js, Q = bench_config((4, 2, 8))
    port = CudaADERDG(aderdg_from_jax(js, gamma=1.4, device="cpu"))
    u = state_from_numpy(Q, device="cpu")
    ref = jnp.asarray(Q)
    for k in range(3):
        ref = js.step(ref, DT)
        u = port.step(u, DT)
        np.testing.assert_allclose(
            state_to_numpy(u), np.asarray(ref), rtol=0, atol=1e-11,
            err_msg=f"step {k + 1}",
        )
    assert port.launches == {"aderdg_predictor_volume": 0, "aderdg_face_flux": 0,
                             "aderdg_surface_update": 0}
    out = state_to_numpy(u)
    assert out.shape == js.state_shape and np.isfinite(out).all()
    np.testing.assert_allclose(
        state_to_numpy(port.total_mass(u)),
        np.asarray(js.total_mass(jnp.asarray(Q))), rtol=0, atol=1e-12,
    )


def test_slice_step_matches_pallas_interpret():
    """One step against the TPU kernel itself, in interpret mode, with the
    benchmark's boundary_faces_only layout."""
    from exahype_tpu.models.aderdg_pallas import PallasADERDG

    js, Q = bench_config((2, 2, 2))
    fused = PallasADERDG(js, interpret=True, tile0=2, boundary_faces_only=True)
    ref = np.asarray(fused.step(jnp.asarray(Q), DT))
    assert fused.boundary_faces_only
    port = CudaADERDG(aderdg_from_jax(js, gamma=1.4, device="cpu"))
    got = state_to_numpy(port.step(state_from_numpy(Q, device="cpu"), DT))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_bench_dt_blows_up_in_both_packages():
    """``bench.py``'s fixed dt = 1e-4 is 1.6x the CFL step of its state at
    dx = 1/256: the JAX solver itself grows until it overflows, and the
    port follows it step by step.

    Once the state grows, rounding differences grow with it, so a fixed
    atol holds only for the first steps.  After that the port is held to
    the JAX solver's own sensitivity: it may differ from the JAX state by
    no more than 4x what the JAX solver differs from itself when its input
    is perturbed by one unit in the last place — checked while that
    self-difference is below 1e-3 of the state (rounding regime)."""
    js, Q = bench_config((4, 2, 8))
    port = aderdg_from_jax(js, gamma=1.4, device="cpu")
    noise = np.random.default_rng(1).choice([-1.0, 1.0], Q.shape)
    u = state_from_numpy(Q, device="cpu")
    ref = jnp.asarray(Q)
    pert = jnp.asarray(Q * (1 + 2.0**-52 * noise))
    first_nonfinite = {}
    for k in range(1, 31):
        ref, pert = js.step(ref, 1e-4), js.step(pert, 1e-4)
        u = port.step(u, 1e-4)
        a, b, c = np.asarray(ref), state_to_numpy(u), np.asarray(pert)
        for name, x in (("jax", a), ("port", b), ("jax_perturbed", c)):
            if name not in first_nonfinite and not np.isfinite(x).all():
                first_nonfinite[name] = k
        if len(first_nonfinite) == 3:
            break
        if first_nonfinite:
            continue
        err, own = np.abs(b - a).max(), np.abs(c - a).max()
        if k <= 3:
            assert err <= 1e-11, (k, err)
        if own < 1e-3 * np.abs(a).max():
            assert err <= 4 * own, (k, err, own)
    assert set(first_nonfinite) == {"jax", "port", "jax_perturbed"}, first_nonfinite
    lo = min(first_nonfinite["jax"], first_nonfinite["jax_perturbed"])
    hi = max(first_nonfinite["jax"], first_nonfinite["jax_perturbed"])
    assert lo - 3 <= first_nonfinite["port"] <= hi + 3, first_nonfinite


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


PKG = REPO / "exahype_tpu_torch"
#: Every module of the port, and the package itself (its lazy exports).
PORT_MODULES = ["exahype_tpu_torch"] + sorted(
    "exahype_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)
#: The ADER-DG, limited, CK and Z4 slices load no SymPy; the spec-DSL front
#: end is built on it.
SYMPY_FREE = (
    "exahype_tpu_torch.models.aderdg",
    "exahype_tpu_torch.models.elastic",
    "exahype_tpu_torch.models.z4",
    "exahype_tpu_torch.models.rhs_cuda",
    "exahype_tpu_torch.models.limiter",
    "exahype_tpu_torch.models.subcell_cuda",
    "exahype_tpu_torch.models.dg",
    "exahype_tpu_torch.models.euler",
    "exahype_tpu_torch.convert",
    "exahype_tpu_torch._build",
    "exahype_tpu_torch.utils.device",
    "exahype_tpu_torch.utils.errors",
)


def _import_alone(module: str):
    """Import ``module`` in a fresh interpreter; the roots it loaded."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "for name in getattr(m, '__all__', ()) if m.__name__ == 'exahype_tpu_torch' else ():\n"
        "    if name != '__version__': getattr(m, name)\n"
        "roots = ('jax', 'jaxlib', 'exahype_tpu', 'sympy')\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules} & set(roots))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    return proc.returncode, proc.stdout.split(), proc.stderr


@pytest.fixture(scope="module")
def imported_roots():
    """Every port module imported alone, three interpreters at a time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=3) as pool:
        return dict(zip(PORT_MODULES, pool.map(_import_alone, PORT_MODULES)))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_imports_no_jax(module, imported_roots):
    rc, roots, err = imported_roots[module]
    assert rc == 0, err
    assert not {"jax", "jaxlib", "exahype_tpu"} & set(roots), roots
    if module.startswith(SYMPY_FREE):
        assert "sympy" not in roots, roots


def test_port_module_list_covers_both_slices():
    assert "exahype_tpu_torch.models.aderdg_cuda" in PORT_MODULES
    assert "exahype_tpu_torch.backends.cuda_backend" in PORT_MODULES
    sympy_free = [m for m in PORT_MODULES if m.startswith(SYMPY_FREE)]
    for module in ("aderdg_cuda", "limiter", "subcell_cuda", "elastic", "z4", "rhs_cuda"):
        assert f"exahype_tpu_torch.models.{module}" in sympy_free
    assert "exahype_tpu_torch.convert" in sympy_free


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "card" in proc.stderr
    assert '"ok"' not in proc.stdout
    # Alone in a directory it fails too.
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
