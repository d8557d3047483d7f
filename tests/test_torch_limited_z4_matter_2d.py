"""The twin of ``tests/test_z4_matter.py:503-543`` on the port: the 2-D
whole-grid limiter over the coupled Z4+GRHD system (the per-axis NCP solver,
ROADMAP Queue 1 item 9.4) on an FLRW state with a sharp density bump,
against JAX's own limited step on the CPU in f64.

The bar is the Z4 family's, 1e-12·max(1, max|JAX|).  JAX runs the whole
step, its candidate included, eagerly: its primitives compile at first use
(~60 s here); a jit of the step costs as much.  The candidate JAX computes
inside its step is kept (:class:`KeptCandidate`) and the port's is held to
it, so the 2-D per-axis NCP step on the clumped state is compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from exahype_tpu.models import z4_matter as jm
from exahype_tpu.models.limiter import LimitedADERDG as JaxLimited
from exahype_tpu_torch.convert import limited_from_jax, state_from_numpy, state_to_numpy
from exahype_tpu_torch.models import z4_matter as tm
from test_torch_limited_z4_matter import GAMMA, GAUGE, close, with_clump

torch.set_num_threads(1)


class KeptCandidate:
    """A duck-typed accelerator for the JAX limiter: JAX's own solver step,
    whose candidate it keeps."""

    def __init__(self, js):
        self.solver, self.candidate = js, None

    def step(self, u, dt, return_face_fluxes=False):
        out = self.solver.step(u, dt, return_face_fluxes=return_face_fluxes)
        self.candidate = out[0] if return_face_fluxes else out
        return out


def test_limiter_composes_with_coupled_system():
    """The 2-D whole-grid limiter over the coupled system: an FLRW state with
    a strong density bump stays finite and admissible through three limited
    steps, the limiter engages, and the first step and its candidate match
    JAX's."""
    rho0, eps0 = 0.02, 0.3
    js = jm.make_z4_matter_solver(dim=2, order=2, grid_shape=(6, 6), dx=1.0 / 6, gamma=GAMMA,
                                  **GAUGE)
    adm_j = jm.z4_matter_admissible(gamma=GAMMA)
    pl = limited_from_jax(JaxLimited(js, admissible=adm_j), gamma=GAMMA, physics="z4_matter",
                          device="cpu", **GAUGE)
    kept = KeptCandidate(js)
    jl = JaxLimited(js, admissible=adm_j, accelerator=kept)
    adot = np.sqrt(8 * np.pi * rho0 * (1 + eps0) / 3)
    Q = with_clump(js, jm.flrw_state(js, 1.0, adot, rho0=rho0, eps0=eps0, gamma=GAMMA),
                   4.0, 0.01)
    u = state_from_numpy(Q, device="cpu")
    adm = tm.z4_matter_admissible(gamma=GAMMA)
    assert bool(adm(u, pl.solver.var_axis).all())
    candidate = pl.solver.step(u, 2e-3)
    troubled = pl.troubled_mask(u, candidate)
    assert int(troubled.sum()) > 0
    with jax.disable_jit():
        ref = jl.step(jnp.asarray(Q), 2e-3)
    close(state_to_numpy(candidate), kept.candidate, "the candidate")
    u = pl.step(u, 2e-3)
    close(state_to_numpy(u), ref, "step 1")
    u = pl.run(u, 2, 2e-3)
    assert torch.isfinite(u).all() and bool(adm(u, pl.solver.var_axis).all())
