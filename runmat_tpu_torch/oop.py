"""Copy of runmat_tpu/oop.py in the PyTorch port.

classdef OOP runtime: classes, value/handle objects, method dispatch,
events/listeners.

Reference parity: the reference registers classes via Instr::RegisterClass and
resolves properties/methods/statics through a class registry at dispatch time
(runmat-vm/src/bytecode/instr.rs:233-248, vm/src/object/resolve.rs). Here the
session owns the registry; value classes get MATLAB copy-on-write semantics
(the `shared` flag, like MatArray), handle classes share one property store
through any number of bindings. Listeners follow the reference's
Value::Listener model (runmat-builtins/src/lib.rs:73-123).
"""

from __future__ import annotations

from typing import Any, Optional

from .errors import MatError


class MatClass:
    __slots__ = ("name", "supers", "props", "methods", "statics", "events",
                 "is_handle", "prop_order")

    def __init__(self, name: str, supers: list, props: dict, prop_order: list,
                 methods: dict, statics: dict, events: list):
        self.name = name
        self.supers = supers          # superclass names (resolved via session)
        self.props = props            # name -> (default_code|None, attrs)
        self.prop_order = prop_order
        self.methods = methods        # name -> Code
        self.statics = statics        # name -> Code
        self.events = events
        self.is_handle = "handle" in supers

    # -- resolution up the inheritance chain ---------------------------------- #

    def mro(self, session) -> list:
        """Depth-first superclass chain (self first)."""
        out = [self]
        for s in self.supers:
            if s == "handle":
                continue
            sc = session.classes.get(s)
            if sc is None:
                raise MatError("MATLAB:class:undefinedSuper",
                               f"Superclass '{s}' of '{self.name}' is not defined.")
            out.extend(sc.mro(session))
        return out

    def handle_semantics(self, session) -> bool:
        return any(c.is_handle for c in self.mro(session))

    def find_method(self, session, name: str):
        for c in self.mro(session):
            if name in c.methods:
                return c.methods[name]
        return None

    def find_static(self, session, name: str):
        for c in self.mro(session):
            if name in c.statics:
                return c.statics[name]
        return None

    def all_props(self, session) -> list:
        """(name, default_code, attrs) in definition order, supers first."""
        out = []
        seen = set()
        for c in reversed(self.mro(session)):
            for p in c.prop_order:
                if p not in seen:
                    seen.add(p)
                    out.append((p, *c.props[p]))
        return out

    def all_events(self, session) -> list:
        ev = []
        for c in self.mro(session):
            ev.extend(c.events)
        return ev


class ClassRef:
    """A class name used as a value (static access: C.method(...))."""

    __slots__ = ("cls",)

    def __init__(self, cls: MatClass):
        self.cls = cls

    def __repr__(self):  # pragma: no cover
        return f"<class {self.cls.name}>"


# builtin class names that support the hidden `.empty` static constructor
# (≙ the reference's `string.empty` registration, runmat-runtime name list)
BUILTIN_EMPTY_CLASSES = frozenset((
    "double", "single", "int8", "int16", "int32", "int64", "uint8",
    "uint16", "uint32", "uint64", "logical", "char", "string", "cell",
    "struct", "datetime", "duration",
))


class BuiltinClassRef:
    """A BUILTIN class name used as a value (string.empty, double.empty(0, 3)):
    carries just the class name; the static surface is `.empty`."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):  # pragma: no cover
        return f"<builtin class {self.name}>"

    def empty(self, dims=()):
        import numpy as np
        from .values import CellArray, MatArray, StringArray, StructArray
        from .errors import MatError
        shape = tuple(int(d) for d in dims) if dims else (0, 0)
        if len(shape) == 1:
            shape = (shape[0], shape[0])
        if all(d > 0 for d in shape):
            raise MatError("MATLAB:class:emptyMustBeEmpty",
                           "At least one dimension must be zero.")
        nm = self.name
        if nm == "string":
            return StringArray(np.empty(shape, dtype=object))
        if nm == "cell":
            return CellArray(np.empty(shape, dtype=object))
        if nm == "struct":
            return StructArray({}, shape)
        if nm == "char":
            return MatArray(np.zeros(shape, dtype=np.uint32), "char")
        if nm in ("datetime", "duration"):
            from .runtime.builtins.datetime_builtins import (MatDatetime,
                                                             MatDuration)
            dt = "datetime64[us]" if nm == "datetime" else "timedelta64[us]"
            ctor = MatDatetime if nm == "datetime" else MatDuration
            return ctor(np.empty(shape, dtype=dt))
        from . import dtypes
        return MatArray(dtypes.cast_to_class(np.zeros(shape), nm), nm)


class MatObject:
    """Value-class instance: copy-on-write like MatArray."""

    __slots__ = ("cls", "props", "shared")

    def __init__(self, cls: MatClass, props: dict):
        self.cls = cls
        self.props = props
        self.shared = False

    def copy(self) -> "MatObject":
        return MatObject(self.cls, dict(self.props))

    @property
    def is_handle(self) -> bool:
        return False


class HandleObject:
    """Handle-class instance: one shared property store, identity semantics."""

    __slots__ = ("cls", "props", "listeners", "valid", "shared")

    def __init__(self, cls: MatClass, props: dict):
        self.cls = cls
        self.props = props
        self.listeners: dict[str, list] = {}
        self.valid = True
        self.shared = False   # irrelevant for handles; kept for uniform checks

    def copy(self) -> "HandleObject":
        return self            # handle copy = same identity

    @property
    def is_handle(self) -> bool:
        return True


class Listener:
    """≙ Value::Listener: binding of (source handle, event, callback)."""

    __slots__ = ("source", "event", "callback", "enabled")

    def __init__(self, source: HandleObject, event: str, callback):
        self.source = source
        self.event = event
        self.callback = callback
        self.enabled = True


# --------------------------------------------------------------------------- #
# registration + construction
# --------------------------------------------------------------------------- #


def build_class(cd) -> MatClass:
    """AST ClassDef -> MatClass (compiles method bodies and prop defaults)."""
    from .vm.compiler import Compiler
    props = {}
    order = []
    for (pname, default, attrs) in cd.properties:
        dcode = Compiler.compile_expr(default) if default is not None else None
        props[pname] = (dcode, tuple(attrs))
        order.append(pname)
    methods = {fd.name: Compiler.compile_function(fd) for fd in cd.methods}
    statics = {fd.name: Compiler.compile_function(fd) for fd in cd.static_methods}
    return MatClass(cd.name, list(cd.supers), props, order, methods, statics,
                    list(getattr(cd, "events", []) or []))


def default_props(interp, session, cls: MatClass) -> dict:
    from .values import MatArray
    out = {}
    for (pname, dcode, _attrs) in cls.all_props(session):
        if dcode is None:
            out[pname] = MatArray.empty()
        else:
            from .vm.interp import Frame
            f = Frame(dcode)
            stack = interp.run(dcode, f, keep_stack=True)
            out[pname] = stack[-1] if stack else MatArray.empty()
    return out


def construct(interp, frame, cls: MatClass, args: list):
    session = interp.session
    is_handle = cls.handle_semantics(session)
    obj = (HandleObject if is_handle else MatObject)(
        cls, default_props(interp, session, cls))
    ctor = cls.methods.get(cls.name)
    if ctor is None:
        if args:
            raise MatError("MATLAB:TooManyInputs",
                           f"Too many input arguments for class '{cls.name}'.")
        return obj
    if not ctor.outs:
        raise MatError("MATLAB:class:ctorOutput",
                       f"Constructor of '{cls.name}' must return the object.")
    from .vm.interp import Frame
    f2 = Frame(ctor, nargin=len(args), nargout=1)
    f2.vars[ctor.outs[0]] = obj       # the output starts as the default object
    _bind_params(f2, ctor, args)
    interp.run(ctor, f2)
    res = f2.vars.get(ctor.outs[0])
    if res is None:
        raise MatError("MATLAB:class:ctorOutput",
                       f"Constructor of '{cls.name}' did not assign the object.")
    return res


def call_method(interp, frame, code, obj, args: list, nargout: int) -> list:
    """Invoke a method: obj is prepended as the first parameter."""
    return interp.call_user(code, [obj] + list(args), nargout)


def _bind_params(f2, code, args: list) -> None:
    import numpy as np
    from .values import CellArray, MatArray
    nparams = len(code.params) - (1 if code.has_varargin else 0)
    if len(args) > nparams and not code.has_varargin:
        raise MatError("MATLAB:TooManyInputs",
                       f"Too many input arguments for '{code.name}'.")
    for i, p in enumerate(code.params[:nparams]):
        if i < len(args) and p != "~":
            v = args[i]
            if isinstance(v, (MatArray, MatObject)):
                v.shared = True
            f2.vars[p] = v
    if code.has_varargin:
        extra = args[nparams:]
        data = np.empty((1, len(extra)), dtype=object)
        for i, v in enumerate(extra):
            data[0, i] = v
        f2.vars["varargin"] = CellArray(data)


# --------------------------------------------------------------------------- #
# property access
# --------------------------------------------------------------------------- #


def prop_read(obj, fname: str):
    if not obj_valid(obj):
        raise MatError("MATLAB:class:InvalidHandle",
                       "Invalid or deleted object.")
    if fname in obj.props:
        return obj.props[fname]
    raise MatError("MATLAB:noSuchMethodOrField",
                   f"Unrecognized method, property, or field '{fname}' for "
                   f"class '{obj.cls.name}'.")


def prop_write(obj, fname: str, value):
    """Returns the (possibly copied) object holding the write."""
    if fname not in obj.props:
        raise MatError("MATLAB:noPublicFieldForClass",
                       f"Unrecognized property '{fname}' for class "
                       f"'{obj.cls.name}'.")
    if isinstance(obj, MatObject) and obj.shared:
        obj = obj.copy()
    obj.props[fname] = value
    return obj


def obj_valid(obj) -> bool:
    return not isinstance(obj, HandleObject) or obj.valid


def notify(interp, frame, obj: HandleObject, event: str, extra_args=()) -> None:
    if event not in obj.cls.all_events(interp.session):
        raise MatError("MATLAB:class:invalidEvent",
                       f"Class '{obj.cls.name}' does not define event "
                       f"'{event}'.")
    for lst in obj.listeners.get(event, []):
        if lst.enabled:
            interp.call_value(lst.callback, [obj] + list(extra_args), 0, frame)
