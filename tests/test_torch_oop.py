"""classdef and +package namespaces in the port, held to the JAX package.

Every test of `tests/test_oop.py` and `tests/test_packages.py` runs with
each of its sessions a `torch_paired.PairedSession`: the same sources
through both packages' host sessions, output, errors and workspaces held
equal exactly (objects field by field, their classes by name, properties,
methods and events), the tests of `import` (misc2's builtin, which the
copied `LOADC` and `resolve_import` branches reach) among them.
"""

import pytest

import test_oop
import test_packages
from test_packages import pkgdir  # noqa: F401  (the fixture its tests take)
from torch_both import no_engine  # noqa: F401
from torch_paired import (PairedSession, fresh_state, run_paired,
                          session_tests)

CASES = [(m, n) for m in (test_oop, test_packages) for n in session_tests(m)]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    run_paired(request, monkeypatch, module, name)


def test_a_classdef_defined_by_execute_runs_in_both(no_engine):
    """`classdef` through `Session.execute`: a value class with a static
    method and a handle class, their objects, display and isa."""
    fresh_state()
    s = PairedSession(accelerate=False)
    s.execute("classdef Foo\nproperties\nv = 1\nend\nmethods\n"
              "function obj = Foo(x)\nif nargin > 0, obj.v = x; end\nend\n"
              "function r = twice(obj)\nr = 2 * obj.v;\nend\nend\n"
              "methods (Static)\nfunction f = make()\nf = Foo(21);\nend\n"
              "end\nend\n")
    s.execute("classdef Bar < handle\nproperties\nitems = []\nend\n"
              "methods\nfunction push(obj, x)\nobj.items = [obj.items, x];\n"
              "end\nend\nend\n")
    r = s.execute("f = Foo.make(); t = f.twice(); g = Foo();"
                  " b = Bar(); c = b; c.push(5); c.push(2);"
                  " n = numel(b.items); k = {class(f), class(b)};"
                  " i = [isa(b, 'handle'), isa(f, 'handle'), isobject(f)];"
                  " f\nb")
    assert r.error is None, r.error
    assert "Foo with properties" in r.output
    assert sorted(s.classes) == ["Bar", "Foo"]


def test_state_left_in_one_package_does_not_reach_a_paired_case(
        request, monkeypatch):
    """What a JAX test file run before on the same worker can leave in the
    JAX package only (a figure, its current number, `hold on`, `format
    long`), which failed every later paired comparison of the current
    figure: `run_paired` starts from a fresh process's state in both."""
    from runmat_tpu.plot import figure as jax_figures
    from runmat_tpu.utils import display as jax_display
    fig = jax_figures.figure(2)
    fig.ax.hold = True
    jax_display.set_format("long")
    run_paired(request, monkeypatch, test_packages,
               "test_import_statement_unqualified")
    assert jax_figures._FIGURES == {} and jax_display._FORMAT["mode"] == \
        "short"
