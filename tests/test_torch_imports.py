"""The port is a package of its own.

* No module of `runmat_tpu_torch/` and not `chip_smoke.py` imports
  `runmat_tpu` in any form: an AST walk over every file finds no `import`
  or `from ... import` of `runmat_tpu` or `runmat_tpu.*` at any depth, and
  no `importlib.import_module`/`__import__` of such a string.
* Every relative import of the port names a module the port has, so a copied
  host module never reaches for one that is not copied yet.
* Every copied host module says in its first docstring line which file of
  the JAX package it copies, and that file exists.
* The trimmed builtin registry resolves each name the port registers to the
  function that wins in the JAX package's full registry (same module suffix
  and `__qualname__`), so no name silently changes its implementation.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "runmat_tpu_torch")


def _port_files():
    out = []
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), REPO))
    return sorted(out)


FILES = _port_files() + ["chip_smoke.py"]


def _module_name(rel: str) -> str:
    name = rel[:-3].replace(os.sep, ".")
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


PORT_MODULES = {_module_name(f) for f in _port_files()}


def _is_jax_package(name) -> bool:
    return isinstance(name, str) and (name == "runmat_tpu"
                                      or name.startswith("runmat_tpu."))


def _tree(rel: str) -> ast.AST:
    with open(os.path.join(REPO, rel)) as f:
        return ast.parse(f.read(), rel)


@pytest.mark.parametrize("rel", FILES)
def test_no_import_of_the_jax_package(rel):
    found = []
    for node in ast.walk(_tree(rel)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _is_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_jax_package(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    _is_jax_package(node.args[0].value):
                found.append(node.args[0].value)
    assert not found, f"{rel} imports {found}"


@pytest.mark.parametrize("rel", _port_files())
def test_relative_imports_resolve_in_the_port(rel):
    mod = _module_name(rel)
    is_pkg = rel.endswith("__init__.py")
    missing = []
    for node in ast.walk(_tree(rel)):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = mod.split(".")
            if not is_pkg:
                base = base[:-1]
            base = base[:len(base) - (node.level - 1)]
            target = ".".join(base + ([node.module] if node.module else []))
            if target not in PORT_MODULES:
                missing.append(f"{target} (line {node.lineno})")
            elif node.module is None:
                # `from . import x`: x is a module of the port or a name
                # its package defines
                missing += [f"{target}.{a.name}" for a in node.names
                            if f"{target}.{a.name}" not in PORT_MODULES
                            and not _defines(target, a.name)]
    assert not missing, f"{rel}: {missing}"


def _defines(module: str, name: str) -> bool:
    rel = module.replace(".", os.sep)
    path = os.path.join(REPO, rel, "__init__.py")
    if not os.path.exists(path):
        path = os.path.join(REPO, rel + ".py")
    tree = _tree(os.path.relpath(path, REPO))
    return any(isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == name
               for n in ast.walk(tree)) or \
        any(isinstance(n, ast.Assign) and
            any(getattr(t, "id", None) == name for t in n.targets)
            for n in tree.body)


COPIED = [f for f in _port_files()
          if (ast.get_docstring(_tree(f)) or "").startswith("Copy of ")]


def test_the_host_layers_are_copied():
    # the front end, VM, runtime, values and session are the port's own
    for rel in ("frontend/parser.py", "vm/interp.py", "runtime/dispatch.py",
                "runtime/builtins/stats.py", "values.py", "session.py",
                "execution.py"):
        assert os.path.join("runmat_tpu_torch", rel) in COPIED, rel


@pytest.mark.parametrize("rel", COPIED)
def test_a_copy_names_its_source(rel):
    first = ast.get_docstring(_tree(rel)).splitlines()[0]
    m = re.match(r"Copy of (runmat_tpu/\S+?\.py)", first)
    assert m, first
    assert os.path.exists(os.path.join(REPO, m.group(1))), m.group(1)
    # the copy sits at the same relative path as its source
    assert m.group(1).split("/", 1)[1] == rel.split(os.sep, 1)[1].replace(
        os.sep, "/")


def _registries():
    from runmat_tpu.runtime import registry as jreg
    from runmat_tpu_torch.runtime import registry as treg
    jreg.ensure_loaded()
    treg.ensure_loaded()
    return jreg.all_builtins(), treg.all_builtins()


def _port_names():
    from runmat_tpu_torch.runtime import registry as treg
    treg.ensure_loaded()
    return sorted(treg.all_builtins())


@pytest.mark.parametrize("name", _port_names())
def test_registry_resolves_as_the_jax_package(name):
    jax_all, port_all = _registries()
    assert name in jax_all, name
    got, want = port_all[name].fn, jax_all[name].fn
    assert got.__module__.split(".", 1)[1] == want.__module__.split(".", 1)[1]
    assert got.__qualname__ == want.__qualname__
    assert port_all[name].max_out == jax_all[name].max_out


def test_names_a_later_module_takes_stay_undefined():
    from runmat_tpu_torch.runtime import registry as treg
    jax_all, port_all = _registries()
    for name, module in treg._REGISTERED_LATER.items():
        assert name not in port_all
        assert jax_all[name].fn.__module__.endswith("builtins." + module)


def test_the_registry_is_the_jax_packages_name_for_name():
    """Every builtin module is carried: the port's registry holds exactly
    the JAX package's names, each from the module of the same name."""
    jax_all, port_all = _registries()
    assert sorted(port_all) == sorted(jax_all)
    jmods = {b.fn.__module__.split(".", 1)[1] for b in jax_all.values()}
    tmods = {b.fn.__module__.split(".", 1)[1] for b in port_all.values()}
    assert tmods == jmods and "runtime.builtins.fea2" in tmods
