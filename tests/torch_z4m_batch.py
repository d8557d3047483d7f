"""A seeded gathered Z4+GRHD batch for the subcell sweep's checks: shared by
``tests/test_torch_limited_z4_matter.py``, ``tests/test_torch_cuda.py`` and
``scripts/torch_same_bits.py``.  It imports the port only (no JAX), so the
card tests and the script can use it."""

import numpy as np
import torch

from exahype_tpu_torch.models.z4_matter import pack_matter


def z4m_gathered_batch(shape, seed, dtype=torch.float64, device="cpu"):
    """A gathered batch ``[5, 5, 5, 43, K, L]``, or a ghost layer with one
    sub-axis cut to 1: ``pack_matter`` of the FLRW metric (γ ≈ δ, K ≈ −0.4 δ)
    with seeded noise of 5e-2 on every Z4 slot, ρ ≈ 0.02, p ≈ 0.005 and
    velocities up to 0.15 a component, so every term of the sweep is live."""
    rng = np.random.default_rng(seed)
    lead = tuple(shape[:3]) + tuple(shape[4:])
    z4 = 0.05 * rng.standard_normal(lead + (38,))
    z4[..., [0, 1, 4, 6]] += 1.0
    z4[..., [7, 10, 12]] -= 0.4
    rho = 0.02 * (1.0 + 0.1 * rng.random(lead))
    p = 0.005 * (1.0 + 0.1 * rng.random(lead))
    v = 0.3 * (rng.random(lead + (3,)) - 0.5)
    q = pack_matter(*(torch.from_numpy(x) for x in (z4, rho, v, p)))
    return q.movedim(-1, 3).to(device, dtype).contiguous()
