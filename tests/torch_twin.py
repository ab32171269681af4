"""The JAX package's module-level tests, run through both packages.

`run_twin(request, monkeypatch, module, name, params)` calls the test
function `name` of the JAX package's test module `module` with every
function and class it reaches of a JAX-package module replaced by a
`Paired` call: the JAX package's function and the port's of the same
module and name run on the same inputs (the port's on its own copy of
every array, made before the JAX call), and the port is held to the JAX
package before the JAX result is returned, so the test's own assertions
read the JAX package's values:

* results equal exactly (`torch_paired.same_value`: arrays by shape, dtype
  and value with NaNs in the same places, objects attribute by attribute,
  of classes of the same name); both packages run the same numpy;
* an exception in both or in neither, of the same class name and message.

An object that a paired call returns is a `Twin`: the JAX package's object
and the port's. Passed to another paired call, each package gets its own;
its methods are paired calls, and its other attributes are held equal and
read from the JAX package's.

What is replaced: the test module's globals that are JAX-package modules
or functions (`B`, `load_step`, ...), the names listed in `LOCAL` on the
module they are imported from while a test function that imports them in
its body runs (`from runmat_tpu.fea.cavity import mesh_plc`), and, for
tests that run MATLAB source through `helpers`, `helpers.Session` by
`torch_paired.PairedSession` (`clock` as `run_paired` takes it).
"""

from __future__ import annotations

import importlib
import inspect
import types

import numpy as np

import helpers
import torch_paired
from torch_paired import PairedSession, same_value

# names a JAX test imports from a JAX-package module inside its body
# (replaced on that module only while a test whose source imports them
# runs: the JAX package's own calls to them would otherwise be paired too)
LOCAL = {"runmat_tpu.fea.cavity": ("mesh_plc", "_volumes"),
         "runmat_tpu.lsp": ("diagnostics",)}


class Count:
    calls = 0


def _is_jax(obj) -> bool:
    mod = getattr(obj, "__module__", None) or ""
    if isinstance(obj, types.ModuleType):
        mod = obj.__name__
    return mod == "runmat_tpu" or mod.startswith("runmat_tpu.")


def _port_of(obj):
    """The port's module, function or class of the same module and name."""
    if isinstance(obj, types.ModuleType):
        return importlib.import_module("runmat_tpu_torch" +
                                       obj.__name__[len("runmat_tpu"):])
    mod = importlib.import_module("runmat_tpu_torch" +
                                  obj.__module__[len("runmat_tpu"):])
    return getattr(mod, obj.__qualname__)


class Twin:
    """A JAX-package object and the port's, made by the same paired call."""

    __slots__ = ("_j", "_t")

    def __init__(self, j, t):
        self._j, self._t = j, t

    def __getattr__(self, name):
        a, b = getattr(self._j, name), getattr(self._t, name)
        if callable(a) and not isinstance(a, np.ndarray):
            return Paired(a, b, name)
        return _wrap(a, b, name)

    def __call__(self, *args, **kw):
        return Paired(self._j, self._t, type(self._j).__name__)(*args, **kw)


def _side(v, i: int):
    """`v` as package i (0 the JAX package, 1 the port) gets it: a Twin's
    own object, a copy of an array for the port."""
    if isinstance(v, Twin):
        return (v._j, v._t)[i]
    if isinstance(v, np.ndarray):
        return v if i == 0 else v.copy()
    if isinstance(v, (list, tuple)):
        return type(v)(_side(x, i) for x in v)
    if isinstance(v, dict):
        return {k: _side(x, i) for k, x in v.items()}
    return v


def _wrap(a, b, what: str):
    """The JAX package's result, after holding the port's to it; objects
    of the packages come back as Twins."""
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return tuple(_wrap(x, y, f"{what}[{i}]")
                     for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [_wrap(x, y, f"{what}[{i}]")
                for i, (x, y) in enumerate(zip(a, b))]
    same_value(a, b, what)
    if _is_jax(type(a)) and not isinstance(a, BaseException):
        return Twin(a, b)
    return a


class Paired:
    """A function (or class) of the JAX package and the port's."""

    def __init__(self, jax_fn, port_fn, name: str):
        self._j, self._t, self._name = jax_fn, port_fn, name

    def __call__(self, *args, **kw):
        targs = [_side(a, 1) for a in args]
        tkw = {k: _side(v, 1) for k, v in kw.items()}
        jargs = [_side(a, 0) for a in args]
        jkw = {k: _side(v, 0) for k, v in kw.items()}
        Count.calls += 1
        try:
            a, ja = self._j(*jargs, **jkw), None
        except Exception as e:          # noqa: BLE001 (compared below)
            a, ja = None, e
        try:
            b, tb = self._t(*targs, **tkw), None
        except Exception as e:          # noqa: BLE001
            b, tb = None, e
        assert (ja is None) == (tb is None), (self._name, ja, tb)
        if ja is not None:
            assert type(tb).__name__ == type(ja).__name__ and \
                str(tb) == str(ja), (self._name, tb, ja)
            raise ja
        return _wrap(a, b, self._name)

    def __getattr__(self, name):
        # an attribute of the function or class itself (a method read off
        # the class, a class attribute)
        a, b = getattr(self._j, name), getattr(self._t, name)
        if callable(a):
            return Paired(a, b, f"{self._name}.{name}")
        return _wrap(a, b, f"{self._name}.{name}")


class PairedModule:
    """A JAX-package module whose functions and classes are Paired."""

    def __init__(self, jax_mod):
        self._j, self._t = jax_mod, _port_of(jax_mod)

    def __getattr__(self, name):
        a, b = getattr(self._j, name), getattr(self._t, name)
        if callable(a):
            return Paired(a, b, f"{self._j.__name__}.{name}")
        same_value(a, b, name)
        return a


def cases(module) -> list:
    """(name, params) for each test of `module`, a case per parameter set
    of a parametrized one."""
    out = []
    for name, fn in vars(module).items():
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, {}, name))
            continue
        assert len(marks) == 1, name
        argnames, values = marks[0].args[:2]
        argnames = [a.strip() for a in argnames.split(",")] \
            if isinstance(argnames, str) else list(argnames)
        ids = marks[0].kwargs.get("ids")
        for i, v in enumerate(values):
            v = v if len(argnames) > 1 else (v,)
            label = ids[i] if ids else str(i)
            out.append((name, dict(zip(argnames, v)), f"{name}[{label}]"))
    return out


def run_twin(request, monkeypatch, module, name, params, clock=()) -> None:
    fn = getattr(module, name)
    monkeypatch.setitem(vars(torch_paired), "_CLOCK", frozenset(clock))
    for g, obj in list(vars(module).items()):
        if isinstance(obj, types.ModuleType) and _is_jax(obj):
            monkeypatch.setattr(module, g, PairedModule(obj))
        elif (inspect.isfunction(obj) or inspect.isclass(obj)) and \
                _is_jax(obj):
            monkeypatch.setattr(module, g, Paired(obj, _port_of(obj), g))
    src = inspect.getsource(fn)
    for modname, names in LOCAL.items():
        if f"from {modname} import" not in src:
            continue
        jmod = importlib.import_module(modname)
        for n in names:
            obj = getattr(jmod, n)
            monkeypatch.setattr(jmod, n, Paired(obj, _port_of(obj), n))
    monkeypatch.setattr(helpers, "Session", PairedSession)
    monkeypatch.setattr(PairedSession, "runs", 0)
    monkeypatch.setattr(Count, "calls", 0)
    kw = dict(params)
    kw.update({p.name: request.getfixturevalue(p.name)
               for p in inspect.signature(fn).parameters.values()
               if p.name not in kw and p.default is inspect.Parameter.empty})
    fn(**kw)
    assert Count.calls + PairedSession.runs > 0, f"{name} ran nothing paired"
