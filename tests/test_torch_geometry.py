"""The CAD and meshing modules fea2 reaches (`fea/{brep,step_import,
surface,sizing,cavity}.py`) in the port, held to the JAX package.

Every test of `tests/test_brep_step.py`, `test_cavity_step.py`,
`test_sizing.py` and `test_surface_meshing.py` runs with each function and
class of `runmat_tpu.fea` it calls paired with the port's (`torch_twin`):
the same inputs through both, results equal exactly (both run the same
numpy), and its MATLAB sources through `PairedSession`, a run's fresh id
and wall time left out (`test_torch_fea2.CLOCK`). HOME points at a
directory of each test's own (`fea.run` writes its registry there).
"""

import pytest

import test_brep_step
import test_cavity_step
import test_sizing
import test_surface_meshing
from test_torch_fea2 import CLOCK, own_home  # noqa: F401  (its fixture)
from torch_both import no_engine  # noqa: F401  (own_home takes it)
from torch_twin import cases, run_twin

MODULE_CASES = [(m, n, p, label)
                for m in (test_brep_step, test_cavity_step, test_sizing,
                          test_surface_meshing)
                for n, p, label in cases(m)]


@pytest.mark.parametrize("module,name,params", [c[:3] for c in MODULE_CASES],
                         ids=[f"{c[0].__name__}::{c[3]}"
                              for c in MODULE_CASES])
def test_the_module_tests_agree_through_both(request, monkeypatch, module,
                                             name, params):
    run_twin(request, monkeypatch, module, name, params, clock=CLOCK)
