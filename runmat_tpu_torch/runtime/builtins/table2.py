"""Copy of runmat_tpu/runtime/builtins/table2.py in the PyTorch port.

Table batch 2: categorical/ordinal arrays, timetable, dictionary,
conversions, grouped summaries, pivot, cell readers, datastores.

Reference parity: runmat-runtime/src/builtins/table/ — categorical/ordinal/
iscategorical/isordinal, timetable family (array2timetable/table2timetable/
timetable2table/istimetable/readtimetable/writetimetable/timerange),
dictionary (+ subsref/subsasgn through the built-in-object protocols),
cell2table/table2cell, groupsummary/grpstats/pivot, readcell, rowfilter/
vartype, arrayDatastore/fileDatastore (parquet* raise a clear unsupported
error), uitable (headless error).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...tables import MatTable
from ...values import (CellArray, FunctionHandle, MatArray, StringArray,
                       StructArray, fortran_ravel, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


# -------------------------------------------------------------- categorical --- #

class CategoricalArray:
    """Array of values from a finite category set (codes + category names)."""

    __slots__ = ("codes", "cats", "ordinal", "shared")
    mclass = "categorical"

    def __init__(self, codes: np.ndarray, cats: list[str], ordinal=False):
        self.codes = codes          # int codes, 0 = <undefined>, 1-based into cats
        self.cats = list(cats)
        self.ordinal = ordinal
        self.shared = False

    @property
    def shape(self):
        return self.codes.shape

    @property
    def size(self):
        return int(self.codes.size)

    @property
    def is_scalar(self):
        return self.codes.size == 1

    def copy(self):
        c = CategoricalArray(self.codes.copy(), self.cats, self.ordinal)
        return c

    def texts(self) -> list[str]:
        return [self.cats[c - 1] if c > 0 else "<undefined>"
                for c in self.codes.reshape(-1, order="F")]

    def _other_code(self, other):
        """Category code of the comparand: categorical / text / numeric."""
        if isinstance(other, CategoricalArray):
            return other.codes
        if is_text(other):
            t = text_of(other)
            return self.cats.index(t) + 1 if t in self.cats else -1
        if isinstance(other, MatArray) and other.size == 1:
            t = f"{float(other.host().reshape(-1)[0].real):g}"
            return self.cats.index(t) + 1 if t in self.cats else -1
        return None

    def _mat_binop_(self, op, other, swapped):
        if op in ("eq", "ne"):
            oc = self._other_code(other)
            if oc is None:
                return NotImplemented
            m = self.codes == oc
            return MatArray(m if op == "eq" else ~m, "logical")
        if self.ordinal and op in ("lt", "le", "gt", "ge"):
            oc = self._other_code(other)
            if oc is None:
                return NotImplemented
            a, b = (oc, self.codes) if swapped else (self.codes, oc)
            fn = {"lt": np.less, "le": np.less_equal,
                  "gt": np.greater, "ge": np.greater_equal}[op]
            return MatArray(fn(a, b), "logical")
        return NotImplemented


def _make_categorical(v, ordinal=False, cats_arg=None) -> CategoricalArray:
    if isinstance(v, CategoricalArray):
        return CategoricalArray(v.codes.copy(), v.cats, ordinal)
    if isinstance(v, (StringArray, CellArray)):
        if isinstance(v, StringArray):
            texts = [s or "" for s in v.data.reshape(-1, order="F")]
        else:
            texts = [e.to_str() for e in v.data.reshape(-1, order="F")]
        shape = v.shape
        cats = ([text_of(c) for c in cats_arg.data.reshape(-1, order="F")]
                if isinstance(cats_arg, (CellArray,)) else sorted(set(texts)))
        lut = {c: i + 1 for i, c in enumerate(cats)}
        codes = np.array([lut.get(t, 0) for t in texts]).reshape(shape, order="F")
        return CategoricalArray(codes, cats, ordinal)
    h = _f(v)
    if cats_arg is not None and not isinstance(cats_arg, (CellArray,)):
        vals = fortran_ravel(_f(cats_arg))
    else:
        vals = np.unique(h[~np.isnan(h)])
    lut = {float(x): i + 1 for i, x in enumerate(vals)}
    codes = np.zeros(h.shape, dtype=int)
    flat_c = codes.reshape(-1)
    for i, x in enumerate(h.reshape(-1)):
        flat_c[i] = lut.get(float(x), 0)
    cats = [f"{x:g}" for x in vals]
    return CategoricalArray(codes, cats, ordinal)


@builtin("categorical", category="table", min_in=1, max_in=3)
def m_categorical(v, valueset=None, names=None):
    c = _make_categorical(v, False, valueset)
    if names is not None and isinstance(names, (CellArray, StringArray)):
        if isinstance(names, StringArray):
            c.cats = [s or "" for s in names.data.reshape(-1, order="F")]
        else:
            c.cats = [e.to_str() for e in names.data.reshape(-1, order="F")]
    return c


@builtin("ordinal", category="table", min_in=1, max_in=2)
def m_ordinal(v, valueset=None):
    return _make_categorical(v, True, valueset)


@builtin("iscategorical", category="table", min_in=1, max_in=1)
def m_iscategorical(v):
    return MatArray.logical_scalar(isinstance(v, CategoricalArray))


@builtin("isordinal", category="table", min_in=1, max_in=1)
def m_isordinal(v):
    return MatArray.logical_scalar(isinstance(v, CategoricalArray) and v.ordinal)


@builtin("categories", category="table", min_in=1, max_in=1)
def m_categories(c):
    if not isinstance(c, CategoricalArray):
        raise bad_arg("categories", "Expected a categorical array.")
    data = np.empty((len(c.cats), 1), dtype=object)
    for i, nm in enumerate(c.cats):
        data[i, 0] = MatArray.char_from_str(nm)
    return CellArray(data)


# -------------------------------------------------------------- dictionary --- #

class DictionaryValue:
    """MATLAB dictionary: typed key -> value map with paren lookup/insert."""

    mclass = "dictionary"
    shared = False

    def __init__(self, ktype=None, vtype=None):
        self.store: dict = {}
        self.ktype = ktype      # 'string' | 'double' | ... or None (unset)
        self.vtype = vtype

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        d = DictionaryValue(self.ktype, self.vtype)
        d.store = dict(self.store)
        return d

    @staticmethod
    def _key(k):
        if is_text(k):
            return text_of(k)
        if isinstance(k, MatArray) and k.size == 1:
            return float(k.host().reshape(-1)[0].real)
        raise MatError("MATLAB:dictionary:key", "Unsupported dictionary key type.")

    # --- typed-dictionary support (configureDictionary/insert/lookup) ----- #

    NUMERIC_VTYPES = {"double", "single", "int8", "int16", "int32", "int64",
                      "uint8", "uint16", "uint32", "uint64", "logical"}

    def _check_key(self, k):
        kind = "string" if isinstance(k, str) else "double"
        if self.ktype is None:
            self.ktype = kind
        elif self.ktype != kind and not (kind == "double"
                                         and self.ktype in self.NUMERIC_VTYPES):
            raise MatError("MATLAB:dictionary:KeysTypeMismatch",
                           f"Key must be of type {self.ktype}; got {kind}.")
        return k

    def _coerce_value(self, v):
        if self.vtype is None:
            if isinstance(v, MatArray) and v.size == 1:
                self.vtype = v.mclass
            elif is_text(v):
                self.vtype = "string"
            else:
                self.vtype = "any"
            return v
        if self.vtype in self.NUMERIC_VTYPES and isinstance(v, MatArray) \
                and v.size == 1 and v.mclass != self.vtype:
            from ...dtypes import cast_to_class
            return MatArray(cast_to_class(v.host(), self.vtype), self.vtype)
        if self.vtype == "string" and is_text(v) \
                and not isinstance(v, StringArray):
            return StringArray.scalar(text_of(v))
        return v

    def put(self, k, v):
        self.store[self._check_key(k)] = self._coerce_value(v)

    def _mat_paren_call_(self, interp, frame, args, nargout):
        k = self._key(args[0])
        if k not in self.store:
            raise MatError("MATLAB:dictionary:KeyNotFound",
                           f"Key not found: {k}.")
        return [self.store[k]]

    def _mat_paren_assign_(self, args, rhs):
        self.put(self._key(args[0]), rhs)
        return self

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "insert":
            return [m_dict_insert(self, *args)]
        if fname == "lookup":
            return [m_dict_lookup(self, *args)]
        if fname == "entries":
            return [m_dict_entries(self, *args)]
        if fname == "isConfigured":
            return [MatArray.logical_scalar(self.ktype is not None)]
        if fname == "types":
            return m_dict_types(self, nargout=max(1, nargout))
        if fname == "keys":
            ks = list(self.store)
            if ks and isinstance(ks[0], str):
                data = np.array([[k] for k in ks], dtype=object)
                return [StringArray(data)]
            return [MatArray(np.array([[float(k)] for k in ks])
                             if ks else np.zeros((0, 1)), "double")]
        if fname == "values":
            data = np.empty((len(self.store), 1), dtype=object)
            for i, v in enumerate(self.store.values()):
                data[i, 0] = v
            return [CellArray(data)]
        if fname == "isKey":
            return [MatArray.logical_scalar(self._key(args[0]) in self.store)]
        if fname == "numEntries":
            return [MatArray.scalar(float(len(self.store)))]
        if fname == "remove":
            self.store.pop(self._key(args[0]), None)
            return [self]
        return NotImplemented

    def _mat_get_field_(self, fname):
        if fname == "numEntries":
            return MatArray.scalar(float(len(self.store)))
        return NotImplemented


@builtin("dictionary", category="table", min_in=0)
def m_dictionary(*args):
    d = DictionaryValue()
    i = 0
    args = list(args)
    if len(args) == 2:
        ks, vs = args
        kk = []
        if isinstance(ks, (StringArray, CellArray)):
            kk = ([s or "" for s in ks.data.reshape(-1, order="F")]
                  if isinstance(ks, StringArray)
                  else [e.to_str() for e in ks.data.reshape(-1, order="F")])
        elif is_text(ks):
            # char-vector key becomes a string scalar key (MATLAB R2022b)
            kk = [text_of(ks)]
        elif isinstance(ks, MatArray):
            kk = [float(x) for x in ks.host().reshape(-1, order="F")]
        vv = []
        if isinstance(vs, CellArray):
            vv = list(vs.data.reshape(-1, order="F"))
        elif is_text(vs) and not isinstance(vs, StringArray):
            vv = [StringArray.scalar(text_of(vs))]
        elif isinstance(vs, MatArray):
            vv = [MatArray.scalar(float(x)) for x in vs.host().reshape(-1, order="F")]
        elif isinstance(vs, StringArray):
            vv = [StringArray.scalar(s) for s in vs.data.reshape(-1, order="F")]
        if len(vv) == 1:
            vv = vv * len(kk)
        for k, v in zip(kk, vv):
            d.put(k, v)
    return d


def _dict_keys_of(arg) -> list:
    """Canonical key list from a scalar/array key argument."""
    if isinstance(arg, StringArray):
        return [s or "" for s in arg.data.reshape(-1, order="F")]
    if isinstance(arg, CellArray):
        return [text_of(e) for e in arg.data.reshape(-1, order="F")]
    if is_text(arg):
        return [text_of(arg)]
    if isinstance(arg, MatArray):
        return [float(x.real) for x in arg.host().reshape(-1, order="F")]
    raise MatError("MATLAB:dictionary:key", "Unsupported dictionary key type.")


def _dict_values_of(arg, n: int) -> list:
    if isinstance(arg, CellArray):
        vv = list(arg.data.reshape(-1, order="F"))
    elif isinstance(arg, StringArray):
        vv = [StringArray.scalar(s) for s in arg.data.reshape(-1, order="F")]
    elif isinstance(arg, MatArray) and arg.size != 1:
        vv = [MatArray(arg.host().reshape(-1, order="F")[i:i + 1].reshape(1, 1),
                       arg.mclass) for i in range(arg.size)]
    else:
        vv = [arg]
    if len(vv) == 1 and n > 1:
        vv = vv * n
    if len(vv) != n:
        raise MatError("MATLAB:dictionary:KeysValuesMismatch",
                       "Keys and values must have compatible sizes.")
    return vv


def _pack_dict_values(vals: list):
    """Stack homogeneous scalar values into a typed column, else a cell."""
    if vals and all(isinstance(v, MatArray) and v.size == 1 for v in vals) \
            and len({v.mclass for v in vals}) == 1:
        h = np.array([[complex(v.host().reshape(-1)[0])] for v in vals])
        if not np.iscomplexobj(np.array([v.host() for v in vals])):
            h = h.real
        return MatArray(h, vals[0].mclass)
    if vals and all(isinstance(v, StringArray) and v.size == 1 for v in vals):
        return StringArray(np.array([[v.data.reshape(-1)[0]] for v in vals],
                                    dtype=object))
    data = np.empty((len(vals), 1), dtype=object)
    for i, v in enumerate(vals):
        data[i, 0] = v
    return CellArray(data)


def _pack_dict_keys(ks: list, ktype=None):
    if ks and isinstance(ks[0], str):
        return StringArray(np.array([[k] for k in ks], dtype=object))
    # numeric keys keep the dictionary's configured key type (ADVICE r4 #4)
    mclass = ktype if ktype in ("double", "single", "int8", "int16", "int32",
                                "int64", "uint8", "uint16", "uint32",
                                "uint64", "logical") else "double"
    from ... import dtypes
    dt = dtypes.np_dtype(mclass)
    arr = np.array([[k] for k in ks], dtype=np.float64) if ks \
        else np.zeros((0, 1))
    return MatArray(arr.astype(dt), mclass)


@builtin("configureDictionary", category="table", min_in=2, max_in=2)
def m_configure_dictionary(kt, vt):
    """Empty dictionary with pinned key/value types (R2023b API)."""
    return DictionaryValue(text_of(kt), text_of(vt))


@builtin("insert", category="table", min_in=3, max_in=5)
def m_dict_insert(d, k, v, *opts):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("insert", "Expected a dictionary.")
    overwrite = True
    if len(opts) == 2 and is_text(opts[0]) \
            and text_of(opts[0]).lower() == "overwrite":
        overwrite = bool(opts[1].host().reshape(-1)[0])
    out = d.copy()
    ks = _dict_keys_of(k)
    for kk, vv in zip(ks, _dict_values_of(v, len(ks))):
        if overwrite or kk not in out.store:
            out.put(kk, vv)
    return out


@builtin("lookup", category="table", min_in=2, max_in=4)
def m_dict_lookup(d, k, *opts):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("lookup", "Expected a dictionary.")
    fallback = None
    if len(opts) == 2 and is_text(opts[0]) \
            and text_of(opts[0]).lower() == "fallbackvalue":
        fallback = opts[1]
    ks = _dict_keys_of(k)
    vals = []
    for kk in ks:
        if kk in d.store:
            vals.append(d.store[kk])
        elif fallback is not None:
            vals.append(fallback)
        else:
            raise MatError("MATLAB:dictionary:KeyNotFound",
                           f"Key not found: {kk}.")
    if len(vals) == 1 and not (isinstance(k, (StringArray, MatArray))
                               and k.size > 1):
        return vals[0]
    return _pack_dict_values(vals)


@builtin("entries", category="table", min_in=1, max_in=2)
def m_dict_entries(d, fmt=None):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("entries", "Expected a dictionary.")
    form = text_of(fmt).lower() if fmt is not None else "table"
    ks = list(d.store)
    vs = list(d.store.values())
    if form == "cell":
        data = np.empty((len(ks), 2), dtype=object)
        for i, (kk, vv) in enumerate(zip(ks, vs)):
            # string keys stay strings in the cell form (ADVICE r4 #4)
            data[i, 0] = (StringArray.scalar(kk) if isinstance(kk, str)
                          else _pack_dict_keys([kk], d.ktype))
            data[i, 1] = vv
        return CellArray(data)
    if form == "struct":
        kcol = np.empty((len(ks), 1), dtype=object)
        vcol = np.empty((len(ks), 1), dtype=object)
        for i, (kk, vv) in enumerate(zip(ks, vs)):
            kcol[i, 0] = (StringArray.scalar(kk) if isinstance(kk, str)
                          else MatArray.scalar(kk))
            vcol[i, 0] = vv
        return StructArray({"Key": kcol, "Value": vcol}, (len(ks), 1))
    return MatTable(["Key", "Value"],
                    [_pack_dict_keys(ks, d.ktype), _pack_dict_values(vs)])


@builtin("numEntries", category="table", min_in=1, max_in=1)
def m_num_entries(d):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("numEntries", "Expected a dictionary.")
    return MatArray.scalar(float(len(d.store)))


@builtin("isConfigured", category="table", min_in=1, max_in=1)
def m_is_configured(d):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("isConfigured", "Expected a dictionary.")
    return MatArray.logical_scalar(d.ktype is not None)


@builtin("types", category="table", min_in=1, max_in=1, pass_nargout=True)
def m_dict_types(d, nargout=1):
    if not isinstance(d, DictionaryValue):
        raise bad_arg("types", "Expected a dictionary.")
    kt = StringArray.scalar(d.ktype or "unset")
    vt = StringArray.scalar(d.vtype or "unset")
    return [kt, vt][:max(1, nargout)]


# --------------------------------------------------------------- timetable --- #

def _is_timetable(t) -> bool:
    return isinstance(t, MatTable) and getattr(t, "rownames", None) is not None \
        and isinstance(t.rownames, dict) and t.rownames.get("_timetable")


def _make_timetable(times, varnames, cols) -> MatTable:
    t = MatTable(varnames, cols)
    t.rownames = {"_timetable": True, "times": times}
    return t


@builtin("timetable", category="table", min_in=1, pass_ctx=True)
def m_timetable(times, *cols, ctx=None):
    names = [f"Var{i + 1}" for i in range(len(cols))]
    # honor 'VariableNames'
    cs = list(cols)
    for i in range(len(cs) - 1):
        if is_text(cs[i]) and text_of(cs[i]) == "VariableNames":
            vn = cs[i + 1]
            names = [e.to_str() for e in vn.data.reshape(-1, order="F")] \
                if isinstance(vn, CellArray) else \
                [s or "" for s in vn.data.reshape(-1, order="F")]
            cs = cs[:i]
            break
    return _make_timetable(times, names[:len(cs)], list(cs))


@builtin("istimetable", category="table", min_in=1, max_in=1)
def m_istimetable(t):
    return MatArray.logical_scalar(_is_timetable(t))


@builtin("array2timetable", category="table", min_in=3, max_in=3)
def m_array2timetable(arr, rowtimes_kw, times):
    h = arr.host()
    cols = [MatArray(h[:, j:j + 1].copy(), arr.mclass) for j in range(h.shape[1])]
    names = [f"Var{j + 1}" for j in range(h.shape[1])]
    return _make_timetable(times, names, cols)


@builtin("table2timetable", category="table", min_in=1, max_in=3)
def m_table2timetable(t, rowtimes_kw=None, times=None):
    if not isinstance(t, MatTable):
        raise bad_arg("table2timetable", "Expected a table.")
    if times is None:
        # first variable becomes the time vector
        return _make_timetable(t.cols[0], t.varnames[1:], t.cols[1:])
    return _make_timetable(times, list(t.varnames), list(t.cols))


@builtin("timetable2table", category="table", min_in=1, max_in=1)
def m_timetable2table(t):
    if not _is_timetable(t):
        raise bad_arg("timetable2table", "Expected a timetable.")
    times = t.rownames["times"]
    return MatTable(["Time"] + list(t.varnames), [times] + list(t.cols))


@builtin("timerange", category="table", min_in=2, max_in=2)
def m_timerange(lo, hi):
    return StructArray.scalar({"_timerange": MatArray.logical_scalar(True),
                               "lo": lo, "hi": hi})


@builtin("readtimetable", category="table", min_in=1, max_in=1, pass_ctx=True)
def m_readtimetable(path, ctx=None):
    t = ctx.interp.call_named("readtable", [path], 1, ctx.frame)[0]
    return m_table2timetable(t)


@builtin("writetimetable", category="table", min_in=2, max_in=2, pass_ctx=True)
def m_writetimetable(t, path, ctx=None):
    tt = m_timetable2table(t)
    ctx.interp.call_named("writetable", [tt, path], 0, ctx.frame)
    return None


# -------------------------------------------------------------- conversions --- #

@builtin("cell2table", category="table", min_in=1, pass_ctx=True)
def m_cell2table(c, *rest, ctx=None):
    if not isinstance(c, CellArray):
        raise bad_arg("cell2table", "Expected a cell array.")
    nrows, ncols = c.shape
    names = [f"Var{j + 1}" for j in range(ncols)]
    rest = list(rest)
    for i in range(len(rest) - 1):
        if is_text(rest[i]) and text_of(rest[i]) == "VariableNames":
            vn = rest[i + 1]
            names = [e.to_str() for e in vn.data.reshape(-1, order="F")] \
                if isinstance(vn, CellArray) else \
                [s or "" for s in vn.data.reshape(-1, order="F")]
    cols = []
    for j in range(ncols):
        items = [c.data[i, j] for i in range(nrows)]
        if all(isinstance(e, MatArray) and e.size == 1 and e.mclass != "char"
               for e in items):
            cols.append(MatArray(np.array(
                [[float(e.host().reshape(-1)[0].real)] for e in items]), "double"))
        else:
            data = np.empty((nrows, 1), dtype=object)
            for i, e in enumerate(items):
                data[i, 0] = e
            cols.append(CellArray(data))
    return MatTable(names[:ncols], cols)


@builtin("table2cell", category="table", min_in=1, max_in=1)
def m_table2cell(t):
    if not isinstance(t, MatTable):
        raise bad_arg("table2cell", "Expected a table.")
    nrows, ncols = t.height, t.width
    data = np.empty((nrows, ncols), dtype=object)
    for j, col in enumerate(t.cols):
        if isinstance(col, CellArray):
            for i in range(nrows):
                data[i, j] = col.data[i, 0]
        elif isinstance(col, StringArray):
            for i in range(nrows):
                data[i, j] = StringArray.scalar(col.data.reshape(-1, order="F")[i])
        else:
            h = col.host()
            for i in range(nrows):
                data[i, j] = MatArray(h[i:i + 1, :].copy(), col.mclass)
    return CellArray(data)


@builtin("readcell", category="table", min_in=1, max_in=1)
def m_readcell(path):
    from ...fs import fs
    p = text_of(path)
    raw = fs().read_bytes(p).decode("utf-8")
    rows = [r for r in raw.strip().split("\n") if r != ""]
    parsed = [r.split(",") for r in rows]
    ncols = max(len(r) for r in parsed) if parsed else 0
    data = np.empty((len(parsed), ncols), dtype=object)
    for i, r in enumerate(parsed):
        for j in range(ncols):
            cell = r[j] if j < len(r) else ""
            try:
                data[i, j] = MatArray.scalar(float(cell))
            except ValueError:
                data[i, j] = MatArray.char_from_str(cell)
    return CellArray(data)


# --------------------------------------------------------- grouped summary --- #

def _group_codes(g):
    if isinstance(g, CategoricalArray):
        return g.codes.reshape(-1, order="F"), g.cats
    if isinstance(g, (StringArray, CellArray)):
        texts = ([s or "" for s in g.data.reshape(-1, order="F")]
                 if isinstance(g, StringArray)
                 else [e.to_str() for e in g.data.reshape(-1, order="F")])
        cats = sorted(set(texts))
        lut = {c: i + 1 for i, c in enumerate(cats)}
        return np.array([lut[t] for t in texts]), cats
    h = fortran_ravel(_f(g))
    vals = np.unique(h)
    lut = {float(v): i + 1 for i, v in enumerate(vals)}
    return np.array([lut[float(x)] for x in h]), [f"{v:g}" for v in vals]


_GROUP_STATS = {
    "mean": np.mean, "sum": np.sum, "min": np.min, "max": np.max,
    "median": np.median, "std": lambda a: np.std(a, ddof=1),
    "var": lambda a: np.var(a, ddof=1), "nnz": np.count_nonzero,
    "numel": np.size, "range": np.ptp,
}


@builtin("groupsummary", category="table", min_in=2, pass_nargout=True)
def m_groupsummary(t, groupvar, *rest, nargout=1):
    """groupsummary(T, groupvars, method[, datavars]) for tables, or
    groupsummary(A, groups, method) for arrays."""
    method = "mean"
    if rest and is_text(rest[0]):
        method = text_of(rest[0]).lower()
    fn = _GROUP_STATS.get(method)
    if fn is None:
        raise bad_arg("groupsummary", f"Unknown method '{method}'.")
    if isinstance(t, MatTable):
        gname = text_of(groupvar)
        gi = t.varnames.index(gname)
        codes, cats = _group_codes(t.cols[gi])
        k = int(codes.max()) if codes.size else 0
        out_names = [gname, "GroupCount"]
        gvals = []
        counts = []
        for c in range(1, k + 1):
            counts.append(float((codes == c).sum()))
        gcol_src = t.cols[gi]
        if isinstance(gcol_src, MatArray):
            vals = np.unique(fortran_ravel(_f(gcol_src)))
            gvals = MatArray(vals.reshape(-1, 1), "double")
        else:
            data = np.empty((k, 1), dtype=object)
            for i, nm in enumerate(cats):
                data[i, 0] = MatArray.char_from_str(nm)
            gvals = CellArray(data)
        out_cols = [gvals, MatArray(np.array(counts).reshape(-1, 1), "double")]
        for j, nm in enumerate(t.varnames):
            if j == gi or not isinstance(t.cols[j], MatArray):
                continue
            h = fortran_ravel(_f(t.cols[j]))
            agg = [float(fn(h[codes == c])) if (codes == c).any() else np.nan
                   for c in range(1, k + 1)]
            out_names.append(f"{method}_{nm}")
            out_cols.append(MatArray(np.array(agg).reshape(-1, 1), "double"))
        return MatTable(out_names, out_cols)
    codes, _cats = _group_codes(groupvar)
    h = fortran_ravel(_f(t))
    k = int(codes.max()) if codes.size else 0
    agg = [float(fn(h[codes == c])) if (codes == c).any() else np.nan
           for c in range(1, k + 1)]
    return MatArray(np.array(agg).reshape(-1, 1), "double")


@builtin("grpstats", category="table", min_in=2, max_in=3)
def m_grpstats(x, g, which=None):
    codes, _cats = _group_codes(g)
    h = _f(x)
    if h.ndim == 2 and 1 in h.shape:
        h = h.reshape(-1, 1)
    method = text_of(which).lower() if which is not None and is_text(which) else "mean"
    fn = _GROUP_STATS.get(method, np.mean)
    k = int(codes.max()) if codes.size else 0
    rows = []
    for c in range(1, k + 1):
        rows.append([float(fn(h[codes == c, j])) for j in range(h.shape[1])])
    return MatArray(np.array(rows), "double")


@builtin("pivot", category="table", min_in=3, max_in=5)
def m_pivot(t, rows_kw, rowvar, cols_kw=None, colvar=None):
    """pivot(T, 'Rows', rv[, 'Columns', cv]): count aggregation."""
    if not isinstance(t, MatTable):
        raise bad_arg("pivot", "Expected a table.")
    rname = text_of(rowvar)
    rcodes, rcats = _group_codes(t.cols[t.varnames.index(rname)])
    if colvar is None:
        k = len(rcats)
        counts = [float((rcodes == c).sum()) for c in range(1, k + 1)]
        gdata = np.empty((k, 1), dtype=object)
        for i, nm in enumerate(rcats):
            gdata[i, 0] = MatArray.char_from_str(nm)
        return MatTable([rname, "count"],
                        [CellArray(gdata),
                         MatArray(np.array(counts).reshape(-1, 1), "double")])
    cname = text_of(colvar)
    ccodes, ccats = _group_codes(t.cols[t.varnames.index(cname)])
    M = np.zeros((len(rcats), len(ccats)))
    for rc, cc in zip(rcodes, ccodes):
        M[rc - 1, cc - 1] += 1
    gdata = np.empty((len(rcats), 1), dtype=object)
    for i, nm in enumerate(rcats):
        gdata[i, 0] = MatArray.char_from_str(nm)
    cols = [CellArray(gdata)] + \
        [MatArray(M[:, j:j + 1].copy(), "double") for j in range(len(ccats))]
    return MatTable([rname] + list(ccats), cols)


# --------------------------------------------------------- filters & types --- #

@builtin("vartype", category="table", min_in=1, max_in=1)
def m_vartype(kind):
    return StructArray.scalar({"_vartype": MatArray.char_from_str(text_of(kind))})


@builtin("rowfilter", category="table", min_in=1, max_in=1)
def m_rowfilter(t_or_names):
    names = []
    if isinstance(t_or_names, MatTable):
        names = list(t_or_names.varnames)
    elif isinstance(t_or_names, (CellArray, StringArray)):
        names = ([e.to_str() for e in t_or_names.data.reshape(-1, order="F")]
                 if isinstance(t_or_names, CellArray)
                 else [s or "" for s in t_or_names.data.reshape(-1, order="F")])
    data = np.empty((1, len(names)), dtype=object)
    for i, nm in enumerate(names):
        data[0, i] = MatArray.char_from_str(nm)
    return StructArray.scalar({"_rowfilter": MatArray.logical_scalar(True),
                               "Variables": CellArray(data)})


# --------------------------------------------------------------- datastores --- #

class DatastoreValue:
    """Minimal datastore: sequential read over in-memory partitions."""

    mclass = "arrayDatastore"
    shared = False

    def __init__(self, items: list):
        self.items = items
        self.pos = 0

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "read":
            if self.pos >= len(self.items):
                raise MatError("MATLAB:datastoreread:pastEnd",
                               "No more data to read.")
            v = self.items[self.pos]
            self.pos += 1
            return [v]
        if fname == "hasdata":
            return [MatArray.logical_scalar(self.pos < len(self.items))]
        if fname == "reset":
            self.pos = 0
            return []
        if fname == "readall":
            data = np.empty((len(self.items), 1), dtype=object)
            for i, v in enumerate(self.items):
                data[i, 0] = v
            return [CellArray(data)]
        return NotImplemented


@builtin("arrayDatastore", category="table", min_in=1)
def m_array_datastore(arr, *opts):
    h = arr.host()
    items = [MatArray(h[i:i + 1, :].copy(), arr.mclass) for i in range(h.shape[0])]
    return DatastoreValue(items)


@builtin("fileDatastore", category="table", min_in=2, pass_ctx=True)
def m_file_datastore(pattern, readfcn_kw=None, readfcn=None, ctx=None):
    import fnmatch
    import os
    from ...fs import fs
    pat = text_of(pattern)
    base = os.path.dirname(pat) or "."
    names = [os.path.join(base, n) for n in fs().listdir(base)
             if fnmatch.fnmatch(n, os.path.basename(pat))] \
        if fs().is_dir(base) else []
    items = []
    for p in sorted(names):
        if readfcn is not None:
            r = ctx.interp.call_value(readfcn, [MatArray.char_from_str(p)],
                                      1, ctx.frame)
            items.append(r[0] if r else MatArray.empty())
        else:
            items.append(MatArray.char_from_str(p))
    return DatastoreValue(items)


def _no_parquet(name):
    raise MatError("MATLAB:parquet:Unsupported",
                   f"{name}: Parquet support is not available in this runtime "
                   "(use writetable/readtable with CSV, or save/load).")


@builtin("parquetread", category="table", min_in=1)
def m_parquetread(*a):
    _no_parquet("parquetread")


@builtin("parquetinfo", category="table", min_in=1)
def m_parquetinfo(*a):
    _no_parquet("parquetinfo")


@builtin("parquetDatastore", category="table", min_in=1)
def m_parquet_datastore(*a):
    _no_parquet("parquetDatastore")


@builtin("spreadsheetImportOptions", category="table", min_in=0)
def m_spreadsheet_import_options(*args):
    return StructArray.scalar({
        "Sheet": MatArray.scalar(1.0),
        "DataRange": MatArray.char_from_str("A1"),
    })


@builtin("detectImportOptions", category="table", min_in=1, max_in=1)
def m_detect_import_options(path):
    p = text_of(path)
    kind = "spreadsheet" if p.endswith(".xlsx") else "delimitedtext"
    return StructArray.scalar({
        "Type": MatArray.char_from_str(kind),
        "Delimiter": MatArray.char_from_str(","),
        "VariableNamesLine": MatArray.scalar(1.0),
    })


@builtin("uitable", category="table", min_in=0)
def m_uitable(*a):
    raise MatError("MATLAB:ui:HeadlessEnvironment",
                   "uitable requires an interactive desktop session.")


@builtin("countcats", category="data", min_in=1, max_in=2)
def m_countcats(c, dim=None):
    """Counts per category (undefined excluded), along dim for matrices."""
    if not isinstance(c, CategoricalArray):
        raise bad_arg("countcats", "Input must be categorical.")
    ncat = len(c.cats)
    codes = c.codes
    if codes.ndim < 2:
        codes = codes.reshape(1, -1)
    d = scalar_int(dim, "dim") - 1 if dim is not None else \
        (0 if codes.shape[0] != 1 else 1)
    if d == 0:
        out = np.stack([(codes == k + 1).sum(axis=0) for k in range(ncat)])
    else:
        out = np.stack([(codes == k + 1).sum(axis=1) for k in range(ncat)],
                       axis=1)
    if c.codes.ndim < 2 or 1 in c.codes.shape:
        out = out.reshape(-1, 1) if c.codes.shape[0] != 1 else \
            out.reshape(1, -1)
    return MatArray(out.astype(np.float64), "double")


@builtin("retime", category="table", min_in=2, max_in=4)
def m_retime(tt, newtimes, method=None, extra=None):
    """retime(TT, 'regular', 'TimeStep', dt) / retime(TT, 'hourly'|'daily'|
    'monthly'|'yearly'[, method]) / retime(TT, newTimes[, method]).
    Methods: 'fillwithmissing' (default), 'previous', 'next', 'nearest',
    'linear', 'mean' (bin aggregation)."""
    from .datetime_builtins import MatDatetime
    if not _is_timetable(tt):
        raise bad_arg("retime", "First input must be a timetable.")
    told = tt.rownames["times"]
    if not isinstance(told, MatDatetime):
        raise bad_arg("retime", "Row times must be datetime.")
    tus = told.data.reshape(-1).astype("datetime64[us]").astype(np.int64)
    meth = "fillwithmissing"
    if method is not None and is_text(method) and \
            text_of(method).lower() != "timestep":
        meth = text_of(method).lower()

    if is_text(newtimes):
        spec = text_of(newtimes).lower()
        unit_us = {"secondly": 1_000_000, "minutely": 60_000_000,
                   "hourly": 3_600_000_000, "daily": 86_400_000_000,
                   "weekly": 7 * 86_400_000_000}
        if spec == "regular":
            # retime(TT, 'regular', 'TimeStep', dur) or (…, method, 'TimeStep', dur)
            from .datetime_builtins import MatDuration
            step = None
            for cand in (method, extra):
                if isinstance(cand, MatDuration):
                    step = int(cand.data.reshape(-1)[0]
                               .astype("timedelta64[us]").astype(np.int64))
            if step is None:
                raise bad_arg("retime", "'regular' needs a 'TimeStep' duration.")
            lo = tus.min() // step * step
            new_us = np.arange(lo, tus.max() + 1, step)
        elif spec in unit_us:
            u = unit_us[spec]
            new_us = np.arange(tus.min() // u * u, tus.max() + 1, u)
        elif spec in ("monthly", "yearly", "quarterly"):
            d64 = told.data.reshape(-1)
            unit = {"monthly": "M", "yearly": "Y"}.get(spec)
            if unit:
                lo = d64.min().astype(f"datetime64[{unit}]")
                hi = d64.max().astype(f"datetime64[{unit}]")
                marks = np.arange(lo, hi + 1)
            else:                      # quarterly: every 3rd month
                lo = d64.min().astype("datetime64[M]")
                hi = d64.max().astype("datetime64[M]")
                lo = lo - (lo.astype(np.int64) % 3)
                marks = np.arange(lo, hi + 1, 3)
            new_us = marks.astype("datetime64[us]").astype(np.int64)
        else:
            raise bad_arg("retime", f"Unknown time basis '{spec}'.")
    elif isinstance(newtimes, MatDatetime):
        new_us = newtimes.data.reshape(-1).astype("datetime64[us]") \
            .astype(np.int64)
    else:
        raise bad_arg("retime", "New row times must be datetime or a basis.")

    def resample(col):
        h = col.host().astype(np.float64)
        v = h.reshape(h.shape[0], -1)
        out = np.full((new_us.size, v.shape[1]), np.nan)
        if meth == "fillwithmissing":
            pos = {t: i for i, t in enumerate(tus)}
            for i, t in enumerate(new_us):
                j = pos.get(t)
                if j is not None:
                    out[i] = v[j]
        elif meth in ("previous", "next", "nearest"):
            order = np.argsort(tus)
            ts, vs = tus[order], v[order]
            ix = np.searchsorted(ts, new_us, side="right") - 1
            if meth == "previous":
                sel = ix
            elif meth == "next":
                sel = np.searchsorted(ts, new_us, side="left")
            else:
                lo = np.clip(ix, 0, ts.size - 1)
                hi = np.clip(ix + 1, 0, ts.size - 1)
                sel = np.where(np.abs(new_us - ts[lo])
                               <= np.abs(ts[hi] - new_us), lo, hi)
            ok = (sel >= 0) & (sel < ts.size)
            out[ok] = vs[np.clip(sel[ok], 0, ts.size - 1)]
        elif meth == "linear":
            order = np.argsort(tus)
            ts, vs = tus[order].astype(np.float64), v[order]
            for c in range(v.shape[1]):
                out[:, c] = np.interp(new_us.astype(np.float64), ts, vs[:, c])
        elif meth in ("mean", "sum", "min", "max", "firstvalue", "count"):
            # aggregate source rows into [new_k, new_k+1) bins
            bins = np.searchsorted(new_us, tus, side="right") - 1
            fn = {"mean": np.mean, "sum": np.sum, "min": np.min,
                  "max": np.max, "firstvalue": lambda x, axis=0: x[0],
                  "count": lambda x, axis=0: float(x.shape[0])}[meth]
            for i in range(new_us.size):
                rows = v[bins == i]
                if rows.size:
                    out[i] = fn(rows, axis=0)
        else:
            raise bad_arg("retime", f"Unknown method '{meth}'.")
        return MatArray(out.reshape((new_us.size,) + h.shape[1:]), "double")

    new_times = MatDatetime(new_us.astype("datetime64[us]").reshape(-1, 1))
    return _make_timetable(new_times, list(tt.varnames),
                           [resample(c) for c in tt.cols])
