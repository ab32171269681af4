"""Copy of runmat_tpu/runtime/builtins/oop_builtins.py in the PyTorch port.

OOP introspection + handle/event builtins.

Reference parity: class dispatch and introspection builtins over the class
registry (runmat-vm/src/object/resolve.rs; events/listeners per
Value::Listener, runmat-builtins/src/lib.rs:73-123).
"""

from __future__ import annotations

import numpy as np

from ... import oop
from ...errors import MatError
from ...values import CellArray, FunctionHandle, MatArray, text_of
from ..registry import builtin


def _is_obj(x) -> bool:
    return isinstance(x, (oop.MatObject, oop.HandleObject))


@builtin("isobject", category="introspection", min_in=1, max_in=1)
def m_isobject(x):
    return MatArray.logical_scalar(_is_obj(x))


@builtin("properties", category="introspection", min_in=1, max_in=1,
         pass_ctx=True)
def m_properties(x, ctx=None):
    cls = _class_of(ctx, x)
    names = [p for (p, _d, _a) in cls.all_props(ctx.session)]
    return _cellcol(names)


@builtin("methods", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_methods(x, ctx=None):
    cls = _class_of(ctx, x)
    names = set()
    for c in cls.mro(ctx.session):
        names.update(c.methods)
        names.update(c.statics)
    names.add(cls.name)
    return _cellcol(sorted(names))


@builtin("events", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_events(x, ctx=None):
    cls = _class_of(ctx, x)
    return _cellcol(cls.all_events(ctx.session))


@builtin("ishandle_object", category="introspection", min_in=1, max_in=1)
def m_ishandle_object(x):
    return MatArray.logical_scalar(isinstance(x, oop.HandleObject))


@builtin("isvalid", category="handles", min_in=1, max_in=1)
def m_isvalid(h):
    if isinstance(h, oop.HandleObject):
        return MatArray.logical_scalar(h.valid)
    if isinstance(h, oop.Listener):
        return MatArray.logical_scalar(h.enabled)
    return MatArray.logical_scalar(False)


@builtin("delete", category="handles", min_in=1, max_in=1, pass_ctx=True)
def m_delete(h, ctx=None):
    """delete(h): invalidate a handle object (runs the class delete method
    first, if any); delete('file') removes a file (MATLAB's dual use)."""
    from ...values import is_text
    if is_text(h):
        import glob as _glob
        import os as _os
        pattern = text_of(h)
        matches = _glob.glob(pattern) or [pattern]
        for p in matches:
            try:
                _os.remove(p)
            except OSError as e:
                raise MatError("MATLAB:DELETE:FileNotFound", str(e))
        return None
    if not isinstance(h, oop.HandleObject):
        raise MatError("MATLAB:class:mustBeHandle",
                       "delete requires a handle object.")
    m = h.cls.find_method(ctx.session, "delete")
    if m is not None and h.valid:
        ctx.interp.call_user(m, [h], 0)
    h.valid = False
    return None


@builtin("addlistener", category="handles", min_in=3, max_in=3, pass_ctx=True)
def m_addlistener(h, event, cb, ctx=None):
    if not isinstance(h, oop.HandleObject):
        raise MatError("MATLAB:class:mustBeHandle",
                       "addlistener requires a handle object.")
    ev = text_of(event)
    if ev not in h.cls.all_events(ctx.session):
        raise MatError("MATLAB:class:invalidEvent",
                       f"Class '{h.cls.name}' does not define event '{ev}'.")
    if not isinstance(cb, FunctionHandle):
        raise MatError("MATLAB:class:invalidCallback",
                       "Listener callback must be a function handle.")
    lst = oop.Listener(h, ev, cb)
    h.listeners.setdefault(ev, []).append(lst)
    return lst


@builtin("notify", category="handles", min_in=2, max_in=None, pass_ctx=True)
def m_notify(h, event, *extra, ctx=None):
    if not isinstance(h, oop.HandleObject):
        raise MatError("MATLAB:class:mustBeHandle",
                       "notify requires a handle object.")
    oop.notify(ctx.interp, ctx.frame, h, text_of(event), list(extra))
    return None


def _class_of(ctx, x):
    if _is_obj(x):
        return x.cls
    if isinstance(x, oop.ClassRef):
        return x.cls
    name = text_of(x) if isinstance(x, MatArray) and x.mclass == "char" else None
    if name and ctx is not None:
        cls = ctx.session.classes.get(name)
        if cls is not None:
            return cls
    raise MatError("MATLAB:class:unknownClass",
                   "Argument must be an object or a known class name.")


def _cellcol(names: list) -> CellArray:
    data = np.empty((len(names), 1), dtype=object)
    for i, nm in enumerate(names):
        data[i, 0] = MatArray.char_from_str(nm)
    return CellArray(data)
