"""Copy of runmat_tpu/runtime/builtins/introspection2.py in the PyTorch port.

Introspection batch 2: argument parsing, cleanup guards, memoization,
metaclass queries, debug-stack stubs, lock state, workspace clearing.

Reference parity: runmat-runtime/src/builtins/introspection/ — inputParser
(addRequired/addOptional/addParameter/parse/Results), onCleanup, memoize
(+ clearCache/clearAllMemoizedCaches/stats), metaclass, superclasses,
ismethod, iskeyword, namelengthmax, verLessThan, clearvars, dbstack/dbclear/
dbstatus/dbtype, mlock/munlock/mislocked, underlyingType/isUnderlyingType,
keyboard, isdeployed, addprop/findprop for dynamicprops.
Objects use the interpreter's built-in-object method protocol
(`_mat_call_method_` / `_mat_get_field_`, runmat_tpu/vm/interp.py).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, class_name, is_text, text_of)
from ..registry import builtin

_MATLAB_KEYWORDS = [
    "break", "case", "catch", "classdef", "continue", "else", "elseif", "end",
    "for", "function", "global", "if", "otherwise", "parfor", "persistent",
    "return", "spmd", "switch", "try", "while",
]


# ------------------------------------------------------------- inputParser --- #

class InputParserValue:
    """MATLAB inputParser: declarative argument validation (handle object)."""

    mclass = "inputParser"
    shared = False

    def __init__(self):
        self.required: list = []     # (name, validator)
        self.optional: list = []     # (name, default, validator)
        self.params: list = []       # (name, default, validator)
        self.results: dict = {}
        self.using_defaults: list = []
        self.keep_unmatched = False
        self.unmatched: dict = {}
        self.function_name = ""

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _validate(self, interp, frame, validator, name, value):
        if validator is None:
            return
        r = interp.call_value(validator, [value], 1, frame)
        ok = r and r[0] is not None and hasattr(r[0], "is_true") and r[0].is_true()
        if not ok:
            raise MatError("MATLAB:InputParser:ArgumentFailedValidation",
                           f"The value of '{name}' is invalid.")

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "addRequired":
            self.required.append((text_of(args[0]), args[1] if len(args) > 1 else None))
            return []
        if fname == "addOptional":
            self.optional.append((text_of(args[0]), args[1] if len(args) > 1 else None,
                                  args[2] if len(args) > 2 else None))
            return []
        if fname in ("addParameter", "addParamValue"):
            self.params.append((text_of(args[0]), args[1] if len(args) > 1 else None,
                                args[2] if len(args) > 2 else None))
            return []
        if fname == "parse":
            self.results = {}
            self.using_defaults = []
            pos = list(args)
            for name, validator in self.required:
                if not pos:
                    raise MatError("MATLAB:InputParser:notEnoughInputs",
                                   f"Required input '{name}' is missing.")
                v = pos.pop(0)
                self._validate(interp, frame, validator, name, v)
                self.results[name] = v
            # optionals: consume while the next positional isn't a known param name
            param_names = {n for n, _d, _v in self.params}
            for name, default, validator in self.optional:
                use_default = True
                if pos and not (is_text(pos[0]) and text_of(pos[0]) in param_names):
                    v = pos.pop(0)
                    self._validate(interp, frame, validator, name, v)
                    self.results[name] = v
                    use_default = False
                if use_default:
                    self.results[name] = default
                    self.using_defaults.append(name)
            # name/value pairs
            given = {}
            i = 0
            while i + 1 < len(pos) + 1 and i < len(pos):
                if not is_text(pos[i]):
                    raise MatError("MATLAB:InputParser:ParamMustBeChar",
                                   "Expected a parameter name.")
                key = text_of(pos[i])
                if i + 1 >= len(pos):
                    raise MatError("MATLAB:InputParser:MissingValue",
                                   f"Parameter '{key}' has no value.")
                given[key] = pos[i + 1]
                i += 2
            for name, default, validator in self.params:
                if name in given:
                    v = given.pop(name)
                    self._validate(interp, frame, validator, name, v)
                    self.results[name] = v
                else:
                    self.results[name] = default
                    self.using_defaults.append(name)
            if given and not self.keep_unmatched:
                bad = next(iter(given))
                raise MatError("MATLAB:InputParser:UnmatchedParameter",
                               f"The parameter '{bad}' is not recognized.")
            self.unmatched = given
            return []
        return NotImplemented

    def _mat_get_field_(self, fname):
        if fname == "Results":
            return StructArray.scalar({k: (v if v is not None else MatArray.empty())
                                       for k, v in self.results.items()})
        if fname == "UsingDefaults":
            data = np.empty((1, len(self.using_defaults)), dtype=object)
            for i, n in enumerate(self.using_defaults):
                data[0, i] = MatArray.char_from_str(n)
            return CellArray(data)
        if fname == "Unmatched":
            return StructArray.scalar(dict(self.unmatched))
        if fname == "KeepUnmatched":
            return MatArray.logical_scalar(self.keep_unmatched)
        if fname == "FunctionName":
            return MatArray.char_from_str(self.function_name)
        return NotImplemented

    def _mat_set_field_(self, fname, value):
        if fname == "KeepUnmatched":
            self.keep_unmatched = bool(value.is_true())
            return True
        if fname == "FunctionName":
            self.function_name = text_of(value)
            return True
        return NotImplemented


@builtin("inputParser", category="introspection", min_in=0, max_in=0)
def m_input_parser():
    return InputParserValue()


# function-style forms the reference registers (addParameter(p,...), parse(p,...))

@builtin("addParameter", category="introspection", min_in=3, pass_ctx=True)
def m_add_parameter(p, name, default, *rest, ctx=None):
    if not isinstance(p, InputParserValue):
        raise bad_arg("addParameter", "First argument must be an inputParser.")
    p.params.append((text_of(name), default, rest[0] if rest else None))
    return None


@builtin("parse", category="introspection", min_in=1, pass_ctx=True)
def m_parse(p, *args, ctx=None):
    if not isinstance(p, InputParserValue):
        raise bad_arg("parse", "First argument must be an inputParser.")
    p._mat_call_method_(ctx.interp, ctx.frame, "parse", list(args), 0)
    return None


# --------------------------------------------------------------- onCleanup --- #

class OnCleanupValue:
    """Runs its handle when the value is destroyed (RAII guard)."""

    mclass = "onCleanup"
    shared = False

    def __init__(self, interp, frame, handle):
        self._interp = interp
        self._frame = frame
        self._handle = handle
        self._done = False

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def run_now(self):
        if not self._done and self._handle is not None:
            self._done = True
            try:
                self._interp.call_value(self._handle, [], 0, self._frame)
            except Exception:
                pass

    def __del__(self):  # host GC fires the cleanup (value went out of scope)
        self.run_now()


@builtin("onCleanup", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_oncleanup(f, ctx=None):
    return OnCleanupValue(ctx.interp, ctx.frame, f)


# ----------------------------------------------------------------- memoize --- #

_MEMO_REGISTRY: list = []


class MemoizedFunction:
    mclass = "matlab.lang.MemoizedFunction"
    shared = False

    def __init__(self, handle):
        self.handle = handle
        self.cache: dict = {}
        self.hits = 0
        self.misses = 0
        _MEMO_REGISTRY.append(self)

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _key(self, args):
        parts = []
        for a in args:
            if isinstance(a, MatArray):
                parts.append((a.mclass, a.host().tobytes(), a.shape))
            else:
                parts.append(repr(a))
        return tuple(parts)

    def call(self, interp, frame, args, nargout):
        k = (self._key(args), nargout)
        if k in self.cache:
            self.hits += 1
            return self.cache[k]
        self.misses += 1
        r = interp.call_value(self.handle, list(args), max(nargout, 1), frame)
        self.cache[k] = r
        return r

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "clearCache":
            self.cache.clear()
            return []
        if fname == "stats":
            return [StructArray.scalar({
                "Cache": StructArray.scalar({
                    "HitCount": MatArray.scalar(float(self.hits)),
                    "MissCount": MatArray.scalar(float(self.misses)),
                    "CurrentSize": MatArray.scalar(float(len(self.cache))),
                })})]
        return NotImplemented

    # calling m(args) goes through paren indexing on the object
    def _mat_paren_call_(self, interp, frame, args, nargout):
        return self.call(interp, frame, args, nargout)


@builtin("memoize", category="introspection", min_in=1, max_in=1)
def m_memoize(f):
    return MemoizedFunction(f)


@builtin("clearAllMemoizedCaches", category="introspection", min_in=0, max_in=0)
def m_clear_all_memoized():
    for m in _MEMO_REGISTRY:
        m.cache.clear()
    return None


@builtin("clearCache", category="introspection", min_in=1, max_in=1)
def m_clear_cache(m):
    if isinstance(m, MemoizedFunction):
        m.cache.clear()
    return None


@builtin("stats", category="introspection", min_in=1, max_in=1)
def m_memoize_stats(m):
    """stats(f): cache statistics for a MemoizedFunction (function form of
    the method; ≙ runmat-runtime introspection/memoize.rs:328 stats)."""
    if not isinstance(m, MemoizedFunction):
        from ...errors import MatError
        raise MatError("MATLAB:invalidType",
                       "stats: expected a MemoizedFunction object.")
    return StructArray.scalar({
        "Cache": StructArray.scalar({
            "HitCount": MatArray.scalar(float(m.hits)),
            "MissCount": MatArray.scalar(float(m.misses)),
            "CurrentSize": MatArray.scalar(float(len(m.cache))),
        })})


# ------------------------------------------------------- metaclass queries --- #

@builtin("metaclass", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_metaclass(obj, ctx=None):
    from ... import oop
    cname = class_name(obj)
    fields = {"Name": MatArray.char_from_str(cname)}
    if isinstance(obj, (oop.MatObject, oop.HandleObject)):
        cls = obj.cls
        pd = np.empty((len(cls.prop_order), 1), dtype=object)
        for i, p in enumerate(cls.prop_order):
            pd[i, 0] = StructArray.scalar({"Name": MatArray.char_from_str(p)})
        md_names = sorted(cls.methods)
        md = np.empty((len(md_names), 1), dtype=object)
        for i, mname in enumerate(md_names):
            md[i, 0] = StructArray.scalar({"Name": MatArray.char_from_str(mname)})
        sup = np.empty((len(cls.supers), 1), dtype=object)
        for i, s in enumerate(cls.supers):
            sup[i, 0] = StructArray.scalar({"Name": MatArray.char_from_str(s)})
        fields["PropertyList"] = CellArray(pd)
        fields["MethodList"] = CellArray(md)
        fields["SuperclassList"] = CellArray(sup)
        fields["HandleCompatible"] = MatArray.logical_scalar(
            cls.handle_semantics(ctx.session))
    return StructArray.scalar(fields)


@builtin("superclasses", category="introspection", min_in=1, max_in=1, pass_ctx=True)
def m_superclasses(obj, ctx=None):
    from ... import oop
    names: list[str] = []
    cls = None
    if is_text(obj):
        cls = ctx.session.classes.get(text_of(obj))
    elif isinstance(obj, (oop.MatObject, oop.HandleObject)):
        cls = obj.cls
    if cls is not None:
        for c in cls.mro(ctx.session)[1:]:
            names.append(c.name)
        if cls.handle_semantics(ctx.session):
            names.append("handle")
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = MatArray.char_from_str(n)
    return CellArray(data)


@builtin("ismethod", category="introspection", min_in=2, max_in=2, pass_ctx=True)
def m_ismethod(obj, name, ctx=None):
    from ... import oop
    if isinstance(obj, (oop.MatObject, oop.HandleObject)):
        return MatArray.logical_scalar(
            obj.cls.find_method(ctx.session, text_of(name)) is not None)
    if hasattr(obj, "_mat_call_method_"):
        return MatArray.logical_scalar(True)
    return MatArray.logical_scalar(False)


@builtin("iskeyword", category="introspection", min_in=0, max_in=1)
def m_iskeyword(word=None):
    if word is None:
        data = np.empty((len(_MATLAB_KEYWORDS), 1), dtype=object)
        for i, k in enumerate(_MATLAB_KEYWORDS):
            data[i, 0] = MatArray.char_from_str(k)
        return CellArray(data)
    return MatArray.logical_scalar(text_of(word) in _MATLAB_KEYWORDS)


@builtin("namelengthmax", category="introspection", min_in=0, max_in=0)
def m_namelengthmax():
    return MatArray.scalar(63.0)


@builtin("verLessThan", category="introspection", min_in=2, max_in=2)
def m_verlessthan(toolbox, version):
    # this runtime reports itself as a current MATLAB-compatible release
    ours = (9, 14)
    want = tuple(int(p) for p in text_of(version).split(".")[:2])
    want = want + (0,) * (2 - len(want))
    return MatArray.logical_scalar(ours < want)


@builtin("isdeployed", category="introspection", min_in=0, max_in=0)
def m_isdeployed():
    return MatArray.logical_scalar(False)


@builtin("underlyingType", category="introspection", min_in=1, max_in=1)
def m_underlying_type(v):
    if isinstance(v, MatArray):
        return MatArray.char_from_str(v.mclass)
    return MatArray.char_from_str(class_name(v))


@builtin("isUnderlyingType", category="introspection", min_in=2, max_in=2)
def m_is_underlying_type(v, name):
    return MatArray.logical_scalar(m_underlying_type(v).to_str() == text_of(name))


# ------------------------------------------------------------- clearvars --- #

@builtin("clearvars", category="introspection", min_in=0, pass_ctx=True)
def m_clearvars(*args, ctx=None):
    names = [text_of(a) for a in args]
    if names and names[0] == "-except":
        keep = set(names[1:])
        for n in list(ctx.frame.vars):
            if n not in keep:
                ctx.frame.vars.pop(n, None)
        return None
    if not names:
        ctx.frame.vars.clear()
        return None
    import fnmatch
    for pat in names:
        for n in list(ctx.frame.vars):
            if fnmatch.fnmatch(n, pat):
                ctx.frame.vars.pop(n, None)
    return None


# ------------------------------------------------------------ debug stubs --- #

@builtin("dbstack", category="introspection", min_in=0, max_in=1, pass_ctx=True,
         pass_nargout=True)
def m_dbstack(opt=None, ctx=None, nargout=0):
    frames = []
    fr = ctx.frame
    while fr is not None:
        nm = getattr(fr, "func_name", None) or "<base>"
        frames.append(nm)
        fr = getattr(fr, "parent", None)
    n = len(frames)
    fields = {"file": np.empty((n, 1), dtype=object),
              "name": np.empty((n, 1), dtype=object),
              "line": np.empty((n, 1), dtype=object)}
    for i, nm in enumerate(frames):
        fields["file"][i, 0] = MatArray.char_from_str("")
        fields["name"][i, 0] = MatArray.char_from_str(nm)
        fields["line"][i, 0] = MatArray.scalar(0.0)
    st = StructArray(fields, (n, 1))
    if nargout >= 1:
        return st
    for nm in frames:
        ctx.session.write(f"> In {nm}\n")
    return None


@builtin("dbclear", category="introspection", min_in=0)
def m_dbclear(*a):
    return None


@builtin("dbstatus", category="introspection", min_in=0)
def m_dbstatus(*a):
    return StructArray(
        {"name": np.empty((0, 1), dtype=object),
         "line": np.empty((0, 1), dtype=object)}, (0, 1))


@builtin("dbtype", category="introspection", min_in=1, max_in=2, pass_ctx=True)
def m_dbtype(fname, lines=None, ctx=None):
    from ...fs import fs as _fs
    name = text_of(fname)
    path = name if name.endswith(".m") else name + ".m"
    try:
        src = _fs().read_bytes(path).decode("utf-8")
    except Exception:
        raise MatError("MATLAB:dbtype:fileNotFound", f"File '{name}' not found.")
    for i, line in enumerate(src.split("\n"), 1):
        ctx.session.write(f"{i:5d}  {line}\n")
    return None


@builtin("keyboard", category="introspection", min_in=0, max_in=0)
def m_keyboard():
    raise MatError("MATLAB:keyboard:NonInteractive",
                   "keyboard requires an interactive debugger session.")


# --------------------------------------------------------------- mlock etc --- #

_LOCKS: set[str] = set()


@builtin("mlock", category="introspection", min_in=0, max_in=0, pass_ctx=True)
def m_mlock(ctx=None):
    _LOCKS.add(getattr(ctx.frame, "func_name", "") or "<base>")
    return None


@builtin("munlock", category="introspection", min_in=0, max_in=1, pass_ctx=True)
def m_munlock(name=None, ctx=None):
    key = text_of(name) if name is not None else \
        (getattr(ctx.frame, "func_name", "") or "<base>")
    _LOCKS.discard(key)
    return None


@builtin("mislocked", category="introspection", min_in=0, max_in=1, pass_ctx=True)
def m_mislocked(name=None, ctx=None):
    key = text_of(name) if name is not None else \
        (getattr(ctx.frame, "func_name", "") or "<base>")
    return MatArray.logical_scalar(key in _LOCKS)


# --------------------------------------------------- dynamicprops support --- #

@builtin("addprop", category="introspection", min_in=2, max_in=2)
def m_addprop(obj, name):
    from ... import oop
    if not isinstance(obj, oop.HandleObject):
        raise bad_arg("addprop", "addprop requires a handle (dynamicprops) object.")
    pname = text_of(name)
    obj.props[pname] = MatArray.empty()
    return StructArray.scalar({"Name": MatArray.char_from_str(pname)})


@builtin("findprop", category="introspection", min_in=2, max_in=2)
def m_findprop(obj, name):
    from ... import oop
    pname = text_of(name)
    if isinstance(obj, (oop.MatObject, oop.HandleObject)) and pname in obj.props:
        return StructArray.scalar({"Name": MatArray.char_from_str(pname)})
    return MatArray.empty()


# ------------------------------------------- source-unit introspection --- #
# mfilename / localfunctions / nargoutchk (≙ runmat-runtime/src/builtins/
# introspection/{mfilename,localfunctions}.rs reading the source_context +
# SourceFunctionInfo catalog; here the compiler stamps each Code with its
# execution-unit path and sibling function names, vm/compiler.py).

@builtin("mfilename", category="introspection", max_in=1, pass_ctx=True)
def m_mfilename(opt=None, ctx=None):
    import os as _os
    path = getattr(ctx.frame.code, "source_path", "") or ""
    if path.startswith("<"):            # <input>/<script>: not file-backed
        path = ""
    mode = text_of(opt).lower() if opt is not None else ""
    if mode == "fullpath":
        if not path:
            return MatArray.char_from_str("")
        full = _os.path.abspath(path)
        root, ext = _os.path.splitext(full)
        return MatArray.char_from_str(root if ext.lower() == ".m" else full)
    if mode == "class":
        return MatArray.char_from_str("")
    base = _os.path.basename(path)
    if base.lower().endswith(".m"):
        base = base[:-2]
    return MatArray.char_from_str(base)


@builtin("localfunctions", category="introspection", max_in=0, pass_ctx=True)
def m_localfunctions(ctx=None):
    code = ctx.frame.code
    names = list(getattr(code, "unit_functions", ()) or ())
    if not getattr(code, "is_script", True) and names \
            and names[0] == code.name:
        # in a function file the primary function is not "local"
        names = names[1:]
    handles = np.empty((len(names), 1), dtype=object)
    for i, nm in enumerate(names):
        handles[i, 0] = FunctionHandle("named", name=nm, src=f"@{nm}")
    return CellArray(handles)


@builtin("nargoutchk", category="control", min_in=2, max_in=2, pass_ctx=True)
def m_nargoutchk(lo, hi, ctx=None):
    n = ctx.frame.nargout
    lo_v = float(lo.host().reshape(-1)[0])
    hi_v = float(hi.host().reshape(-1)[0])
    if n < lo_v:
        raise MatError("MATLAB:nargoutchk:notEnoughOutputs",
                       "Not enough output arguments.")
    if n > hi_v:
        raise MatError("MATLAB:nargoutchk:tooManyOutputs",
                       "Too many output arguments.")
    return None


# ---------------------------------------------- call-context + method refs --- #

class BoundMethod:
    """Method-bound callable: getmethod(obj, 'm') -> handle-like value
    (≙ introspection/getmethod.rs creating a bound function handle routed
    through __runmat_call_bound_method__)."""

    __slots__ = ("obj", "name", "shared")
    mclass = "function_handle"

    def __init__(self, obj, name: str):
        self.obj = obj
        self.name = name
        self.shared = False

    @property
    def shape(self):
        return (1, 1)

    size = 1

    def copy(self):
        return BoundMethod(self.obj, self.name)

    def __repr__(self):  # pragma: no cover
        return f"@bound:{self.name}"

    def _mat_paren_call_(self, interp, frame, args, nargout):
        return interp._call_method(frame, self.obj, self.name, list(args),
                                   max(nargout, 1))


@builtin("getmethod", category="introspection", min_in=2, max_in=2,
         pass_ctx=True)
def m_getmethod(obj, name, ctx=None):
    mname = text_of(name).strip()
    if not mname:
        raise bad_arg("getmethod", "Method name must be non-empty.")
    from ... import oop
    if isinstance(obj, (oop.MatObject, oop.HandleObject)):
        if obj.cls.find_method(ctx.session, mname) is None and \
                obj.cls.find_static(ctx.session, mname) is None:
            raise MatError("MATLAB:class:undefinedMethod",
                           f"Unrecognized method '{mname}' for class "
                           f"'{obj.cls.name}'.")
        return BoundMethod(obj, mname)
    if is_text(obj):
        cls = ctx.session.classes.get(text_of(obj))
        if cls is None:
            raise bad_arg("getmethod", f"Unknown class '{text_of(obj)}'.")
        m = cls.find_static(ctx.session, mname)
        if m is None:
            raise MatError("MATLAB:class:noStatic",
                           f"Unrecognized static method '{mname}' for "
                           f"class '{cls.name}'.")
        return BoundMethod(oop.ClassRef(cls), mname)
    # built-in object types route through their method protocol
    if hasattr(obj, "_mat_call_method_"):
        return BoundMethod(obj, mname)
    raise bad_arg("getmethod", "First input must be an object or class name.")


@builtin("classref", category="introspection", min_in=1, max_in=1,
         pass_ctx=True)
def m_classref(name, ctx=None):
    """Class reference token for static dispatch (≙ classref.rs)."""
    from ... import oop
    nm = text_of(name)
    cls = ctx.session.classes.get(nm)
    if cls is not None:
        return oop.ClassRef(cls)
    if nm in oop.BUILTIN_EMPTY_CLASSES:
        return oop.BuiltinClassRef(nm)
    raise bad_arg("classref", f"Unknown class '{nm}'.")


@builtin("getcallinfo", category="introspection", max_in=0, pass_ctx=True)
def m_getcallinfo(ctx=None):
    """Current call context: name/file/line + the dbstack-style stack
    (≙ introspection/debugging.rs dispatch_getcallinfo)."""
    import os as _os
    code = ctx.frame.code
    path = getattr(code, "source_path", "") or ""
    if path.startswith("<"):
        path = ""
    name = "" if code.name in ("<script>", "<input>") else code.name
    frames = []
    fr = ctx.frame
    while fr is not None:
        c = fr.code
        if c is not None and c.name not in ("<input>",):
            frames.append(StructArray.scalar({
                "name": MatArray.char_from_str(
                    "" if c.name == "<script>" else c.name),
                "file": MatArray.char_from_str(
                    getattr(c, "source_path", "") or ""),
                "line": MatArray.scalar(0.0),
            }))
        fr = getattr(fr, "parent", None)
    data = np.empty((len(frames), 1), dtype=object)
    for i, f in enumerate(frames):
        data[i, 0] = f
    return StructArray.scalar({
        "name": MatArray.char_from_str(name),
        "file": MatArray.char_from_str(_os.path.abspath(path) if path else ""),
        "line": MatArray.scalar(0.0),
        "stack": CellArray(data),
    })
