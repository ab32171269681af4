"""Thirteen JAX test files of the host language and library, run through
both packages.

Every test of `tests/test_vm_language.py`, `test_numerics.py`,
`test_indexing.py`, `test_optim_ml.py`, `test_dict_scattered.py`,
`test_linalg_signal2.py`, `test_stats2.py`, `test_breadth4.py`,
`test_strings2.py`, `test_symbolic_io2.py`, `test_stats3.py`,
`test_conformance_options5.py` and `test_arguments.py` runs with each of
its sessions a `torch_paired.PairedSession`: the same sources through both
packages' host sessions, output, errors, workspaces and the files they
write held equal exactly. They pass as they are. So do the three cases of
`test_value_surfaces.py` whose datetime arrays hold NaT, which the harness
compares in place since it holds NaT like NaN.
"""

import pytest

import test_arguments
import test_breadth4
import test_conformance_options5
import test_dict_scattered
import test_indexing
import test_linalg_signal2
import test_numerics
import test_optim_ml
import test_stats2
import test_stats3
import test_strings2
import test_symbolic_io2
import test_value_surfaces
import test_vm_language
from torch_both import no_engine  # noqa: F401
from torch_paired import run_paired, session_tests

MODULES = (test_vm_language, test_numerics, test_indexing, test_optim_ml,
           test_dict_scattered, test_linalg_signal2, test_stats2,
           test_breadth4, test_strings2, test_symbolic_io2, test_stats3,
           test_conformance_options5, test_arguments)
# the datetime cases that hold NaT
NAT = ("test_datetime_write_and_grow_with_nat", "test_nat_builtin",
       "test_datetime_sort_min_max_unique")

CASES = [(m, n) for m in MODULES for n in session_tests(m)] + \
    [(test_value_surfaces, n) for n in NAT]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, no_engine,
                                          module, name):
    run_paired(request, monkeypatch, module, name)
