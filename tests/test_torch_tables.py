"""Tables, timetables, categoricals, dictionaries and text analytics in the
port, held to the JAX package.

Every test of `tests/test_table2.py` and `tests/test_textanalytics.py` runs
with each of its sessions a `torch_paired.PairedSession`: the same sources through both
packages' host sessions, output, errors, workspaces and the files they
write held equal exactly.
"""

import pytest

import test_table2
import test_textanalytics
from torch_paired import run_paired, session_tests

CASES = [(m, n) for m in (test_table2, test_textanalytics)
         for n in session_tests(m)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    run_paired(request, monkeypatch, module, name)
