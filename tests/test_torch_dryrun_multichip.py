"""The port's twin of ``__graft_entry__.py::dryrun_multichip``
(``exahype_tpu_torch/parallel/dryrun.py``) on the CPU over gloo, at 4 and 2
ranks: one case per check of the JAX function, under its name.

Each check's sharded step, gathered, must be within the JAX check's
tolerance of the port's unsharded step (1e-6; the bf16 wire 0.05) and, but
for the bf16 wire, bit for bit.  The limited and pool checks are reported
as waiting on ROADMAP.md Queue 1 items 5.b and 11, not as passed; at 2
ranks the 2-axis checks are skipped, as in the JAX function.
"""

import functools

import pytest

from exahype_tpu_torch.parallel.dryrun import CHECKS, TWO_AXIS, WAITING, dryrun_multichip


@functools.lru_cache(maxsize=None)
def _report(n_devices):
    return dryrun_multichip(n_devices, device="cpu", join_timeout=300.0)


@pytest.mark.parametrize("n_devices", [4, 2])
@pytest.mark.parametrize("check", CHECKS)
def test_dryrun_check(check, n_devices):
    line = _report(n_devices)[check]
    if check in WAITING:
        assert line == {"status": "waiting", "on": WAITING[check]}
        assert ("5.b" if "limited" in check else "item 11") in line["on"]
        return
    if check in TWO_AXIS and n_devices < 4:
        assert line["status"] == "skipped"
        return
    assert line["status"] == "passed", line
    assert line["err"] <= (0.05 if "bf16" in check else 1e-6)
    assert line["bitwise"] == ("bf16" not in check), line
