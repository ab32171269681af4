"""Datetime types, calendar arithmetic and the datetime columns of tables in the port, held to the JAX package.

Every test of `tests/test_datetime3.py` and `tests/test_table_datetime.py`
runs with each of its sessions a `torch_paired.PairedSession`: the same
sources through both packages' host sessions, output, errors, workspaces,
the files they write and the figures they touch held equal exactly.
"""

import pytest

import test_datetime3
import test_table_datetime
from torch_paired import run_paired, session_tests

CASES = [(m, n) for m in (test_datetime3, test_table_datetime)
         for n in session_tests(m)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    run_paired(request, monkeypatch, module, name)
