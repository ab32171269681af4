"""Copy of runmat_tpu/packages.py in the PyTorch port.

MATLAB +package namespaces: directory packages and import lists.

Reference parity: the reference resolves `+pkg` directory namespaces and
`import pkg.fn` / `import pkg.*` through HIR callable resolution
(runmat-hir import handling; SURVEY §2.2 "imports/packages"). Here
resolution is dynamic against the session search path, matching the VM's
runtime call-or-index design: `pkg.fn(x)` loads a PackageRef, member
lookup compiles `<path>/+pkg/fn.m` on first use (cached by mtime), and
imports extend unqualified-name resolution.
"""

from __future__ import annotations

import os


class PackageRef:
    """A resolved +package namespace (value of `pkg` in `pkg.fn(...)`)."""

    __slots__ = ("name", "path")
    mclass = "package"
    shared = False

    def __init__(self, name: str, path: str):
        self.name = name       # dotted name, e.g. "mypkg.sub"
        self.path = path       # directory ending in +<last segment>

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def __repr__(self):  # pragma: no cover
        return f"<package {self.name}>"

    # -- VM object protocol: pkg.fn(args) / pkg.sub / pkg.Class(...) ------- #

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        from .errors import MatError
        hit = member(interp.session, self, fname)
        if hit is None:
            raise MatError("MATLAB:UndefinedFunction",
                           f"Undefined function or package member "
                           f"'{fname}' in package '{self.name}'.")
        kind, val = hit
        if kind == "pkg":
            if args:
                raise MatError("MATLAB:UndefinedFunction",
                               f"'{self.name}.{fname}' is a package, not a "
                               f"function.")
            return [val]
        if kind == "class":
            from . import oop
            return [oop.construct(interp, frame, val, args)]
        return interp.call_user(val, args, max(nargout, 1))

    def _mat_get_field_(self, fname):
        return NotImplemented   # falls through to the zero-arg method call


def find_package(session, name: str):
    """`name` -> PackageRef if any search-path dir contains +<name>.
    Cached per (name, search path): LOADC probes this for every
    non-variable identifier, and an uncached lookup would put stat()
    syscalls on the interpreter hot path."""
    cache = getattr(session, "_pkg_find_cache", None)
    if cache is None:
        cache = session._pkg_find_cache = {}
    sp = tuple(session.search_path)
    ent = cache.get(name)
    if ent is not None and ent[0] == sp:
        return ent[1]
    result = None
    for d in sp:
        p = os.path.join(d, "+" + name)
        if os.path.isdir(p):
            result = PackageRef(name, p)
            break
    if len(cache) > 512:
        cache.clear()
    cache[name] = (sp, result)
    return result


def member(session, pkg: PackageRef, fname: str):
    """Resolve a package member: ('pkg', PackageRef) for nested +dirs,
    ('code', Code) for fn.m / classdef files (compiled, mtime-cached)."""
    sub = os.path.join(pkg.path, "+" + fname)
    if os.path.isdir(sub):
        return ("pkg", PackageRef(pkg.name + "." + fname, sub))
    mfile = os.path.join(pkg.path, fname + ".m")
    if not os.path.isfile(mfile):
        return None
    cache = getattr(session, "_pkg_cache", None)
    if cache is None:
        cache = session._pkg_cache = {}
    key = pkg.name + "." + fname
    mtime = os.path.getmtime(mfile)
    ent = cache.get(key)
    if ent is not None and ent[0] == mtime:
        return ent[1]
    from .frontend.parser import parse
    from .vm.compiler import Compiler
    with open(mfile) as f:
        src = f.read()
    prog = parse(src, mfile)
    if fname in prog.classes:
        from .oop import build_class
        cls = session.classes.setdefault(key, build_class(
            prog.classes[fname]))
        out = ("class", cls)
    else:
        compiled = Compiler.compile_program(prog, mfile)
        code = compiled.functions.get(fname)
        if code is None and compiled.functions:
            code = next(iter(compiled.functions.values()))
        if code is None:
            return None
        # local functions stay file-private: each unit sees its siblings
        # through the per-code table the resolver consults (not the global
        # function registry — MATLAB file scoping)
        for fn_code in compiled.functions.values():
            fn_code.siblings = compiled.functions
        out = ("code", code)
    cache[key] = (mtime, out)
    return out


def resolve_import(session, name: str):
    """Unqualified `name` through the session import list (`import
    pkg.fn` exact imports win over `import pkg.*` wildcards). Returns
    ('code', Code) | ('class', cls) | None."""
    imports = getattr(session, "imports", None)
    if not imports:
        return None
    for path in imports:
        parts = path.split(".")
        if parts[-1] != name or len(parts) < 2:
            continue
        hit = _walk(session, parts[:-1], name)
        if hit is not None:
            return hit
    for path in imports:
        parts = path.split(".")
        if parts[-1] != "*" or len(parts) < 2:
            continue
        hit = _walk(session, parts[:-1], name)
        if hit is not None:
            return hit
    return None


def _walk(session, pkg_parts, fname):
    pkg = find_package(session, pkg_parts[0])
    if pkg is None:
        return None
    for seg in pkg_parts[1:]:
        nxt = member(session, pkg, seg)
        if nxt is None or nxt[0] != "pkg":
            return None
        pkg = nxt[1]
    hit = member(session, pkg, fname)
    if hit is None or hit[0] == "pkg":
        return None
    return hit
