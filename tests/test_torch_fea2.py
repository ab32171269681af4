"""fea2 in the port, held to the JAX package (its CAD and meshing modules:
`tests/test_torch_geometry.py`).

* Every test of `tests/test_fea2.py` and `tests/test_fea_evidence.py` runs
  with each of its sessions a `torch_paired.PairedSession` (the same
  sources through both packages' host sessions; output, errors,
  workspaces, the files they write and the FEA run registry under HOME held
  equal exactly). A run's fresh id and its wall time, and the hashes over
  them, are left out (`LOOSE`, `CLOCK`); the test itself still checks them
  in the JAX package.
* `runmat_tpu_torch/workloads/fea_thermal.m` at R = 16 and its STEP part at
  the JAX tests' edge length: JaxEngine("cpu") against TorchEngine("cpu"),
  whose solve is the plain CG, within `spbench.X_TOL` of the largest
  temperature.

HOME points at a directory of each test's own: `fea.run` appends to
`~/.runmat_tpu/fea_runs.json` and `fea.evidence` chains through
`fea_evidence_chain.json` beside it, in both packages.
"""

import os
import re

import pytest

import test_fea2
import test_fea_evidence
from torch_both import close, no_engine, run_both, same  # noqa: F401
from torch_paired import fresh_state, run_paired, session_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THERMAL = os.path.join(REPO, "runmat_tpu_torch", "workloads",
                       "fea_thermal.m")
STEP = os.path.join(REPO, "runmat_tpu_torch", "workloads",
                    "plate_bore.step")


@pytest.fixture(autouse=True)
def own_home(tmp_path, monkeypatch, no_engine):
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    fresh_state()
    yield
    fresh_state()


# a run's id (uuid4) and wall time, and what holds or hashes them: the
# workspace names, and the struct fields of a run result, a comparison, a
# trends table and an evidence record
LOOSE = {"test_fea_run_linear_static_and_field": ("rid",),
         "test_fea_sweep_compare_trends": ("a", "b", "tr"),
         "test_evidence_write_and_verify_roundtrip": ("h",)}
CLOCK = ("runId", "wallTime", "runA", "runB", "hash")

SESSION_CASES = [(m, n) for m in (test_fea2, test_fea_evidence)
                 for n in session_tests(m)]


@pytest.mark.parametrize("module,name", SESSION_CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in SESSION_CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    run_paired(request, monkeypatch, module, name, home=True,
               loose=LOOSE.get(name, ()), clock=CLOCK)


def _thermal_setup(R: int, hs: float) -> str:
    return f"R = {R}; hs = {hs}; stepfile = '{STEP}';"


def test_thermal_script_on_both_engines():
    """fea_thermal.m at R = 16 (4,913 nodes; the cube's 4,335 free unknowns
    and the replay's 4,624 go to the CG) with the STEP plate at the JAX
    tests' edge length 0.35, on JaxEngine("cpu") and TorchEngine("cpu"):
    the temperatures within spbench.X_TOL of the largest, the histogram
    and the printed lines alike."""
    from runmat_tpu_torch import spbench
    b = run_both(_thermal_setup(16, 0.35), open(THERMAL).read())
    close(b, ("T", "Tp", "edges"), spbench.X_TOL)
    same(b, ("n", "png_ok", "bore"))
    solves = [e for e in b.teng.launch_log if e["cat"] == "sparse_cg"]
    assert [e["n"] for e in solves] == [4335, 4624], solves
    assert int(b.ts.get("bore").host()[0, 0]) == 7
    for label in ("THERMAL", "PLATE"):
        j, t = (float(re.search(rf"RESULT_ok {label}=(\S+)", r.output)
                      .group(1)) for r in (b.jr, b.tr))
        assert abs(t - j) <= spbench.X_TOL * abs(j), (label, t, j)
