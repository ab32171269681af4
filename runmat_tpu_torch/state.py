"""Carry a session's state across engines and packages.

`carry_session(src, dst)` gives `dst` (a session of the port) the workspace,
the classdef classes and the RNG position of `src`, so a script continued
in `dst` computes what it would have computed in `src`. `src` may be a
session of the port or of the JAX package: arrays cross as host numpy
copies of whatever holds them (`to_matarray`), the RNG as `(seed, key,
counter)`; a sparse matrix and a tetrahedral mesh of either package become
the port's `SparseMatrix` and `TetMesh` over copies of their arrays, and a
dlnetwork the port's `DlNetwork` with the same learnables. Every other
value of either package (cells, structs, strings, function handles,
datetimes and durations, tables and timetables, categoricals,
dictionaries, classdef objects with their classes) becomes an instance of
the port's class of the same module and name, its fields converted in
turn; shared references stay shared. A value of a class the port does not
carry raises. Nothing here imports the JAX package; its values are read
through their attributes.
"""

from __future__ import annotations

import copy
import enum
import importlib

import numpy as np

from .values import MatArray


def to_matarray(v) -> MatArray:
    """A numpy array, or any array value with `host()` and `mclass` (a
    MatArray of either package, on any device), as the port's host
    MatArray. A numpy array takes the class of its dtype."""
    if isinstance(v, np.ndarray):
        return MatArray.from_np(v.copy())
    return MatArray(np.array(v.host(), copy=True), v.mclass)


def to_numpy(v: MatArray) -> np.ndarray:
    """A port MatArray as a writable numpy array in its MATLAB shape."""
    return np.array(v.host(), copy=True)


_JAX = "runmat_tpu"
_PORT = __name__.rsplit(".", 1)[0]
# the modules whose objects hold a running interpreter, session or engine
_NOT_VALUES = ("session", "vm.interp", "accel")


def to_port_value(v, memo: dict | None = None):
    """A workspace value of either package as the port's own, over copies
    of its arrays. `memo` maps the id of each value already converted to its
    conversion (as `copy.deepcopy`'s does), so references shared in the
    source stay shared and cycles end. Raises TypeError for a value whose
    class the port does not carry."""
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes,
                                   np.generic)):
        return v
    memo = {} if memo is None else memo
    key = id(v)
    if key in memo:
        return memo[key]
    out = _convert(v, memo)
    memo[key] = out
    return out


def _package_of(cls) -> str | None:
    mod = cls.__module__
    for pkg in (_PORT, _JAX):
        if mod == pkg or mod.startswith(pkg + "."):
            return pkg
    return None


def _convert(v, memo: dict):
    if isinstance(v, np.ndarray):
        if v.dtype != object:
            return v.copy()
        out = np.empty(v.shape, dtype=object)
        for i, x in np.ndenumerate(v):
            out[i] = to_port_value(x, memo)
        return out
    if isinstance(v, (list, tuple, set, frozenset)):
        return type(v)(to_port_value(x, memo) for x in v)
    if isinstance(v, dict):
        return {to_port_value(k, memo): to_port_value(x, memo)
                for k, x in v.items()}
    cls = type(v)
    pkg = _package_of(cls)
    if pkg is None:
        return copy.deepcopy(v, {})
    kind = cls.__name__
    if kind == "MatArray":
        out = to_matarray(v)
        out.dl = getattr(v, "dl", False)
        return out
    if kind == "SparseMatrix":
        from .sparse import SparseMatrix
        return SparseMatrix(v.m, v.n, v.indptr.copy(), v.rowind.copy(),
                            v.data.copy(), v.mclass)
    if kind == "TetMesh":
        from .fea.mesh import TetMesh
        return TetMesh(v.nodes.copy(), v.tets.copy(), copy.deepcopy(v.dims),
                       copy.deepcopy(v.shape))
    if kind == "DlNetwork":
        return _dlnetwork(v)
    return _mirror(v, cls, pkg, memo)


def _mirror(v, cls, pkg: str, memo: dict):
    """An instance of the port's class of `cls`'s module and name with
    `v`'s fields, each converted."""
    rel = cls.__module__[len(pkg):]
    if rel.lstrip(".").startswith(_NOT_VALUES):
        raise TypeError(f"{cls.__module__}.{cls.__qualname__} is not a "
                        "workspace value and cannot be carried")
    try:
        target = importlib.import_module(_PORT + rel)
        for part in cls.__qualname__.split("."):
            target = getattr(target, part)
    except (ImportError, AttributeError):
        raise TypeError(f"{cls.__module__}.{cls.__qualname__} has no "
                        "counterpart in the port yet") from None
    if isinstance(v, enum.Enum):
        return target[v.name]
    out = object.__new__(target)
    memo[id(v)] = out       # before the fields: a field may lead back to v
    for n in _slot_names(cls):
        if hasattr(v, n):
            object.__setattr__(out, n, to_port_value(getattr(v, n), memo))
    for n, x in getattr(v, "__dict__", {}).items():
        object.__setattr__(out, n, to_port_value(x, memo))
    return out


def _slot_names(cls) -> list:
    """The slots `cls` and its bases declare."""
    names = []
    for k in cls.__mro__:
        sl = k.__dict__.get("__slots__", ())
        names += [sl] if isinstance(sl, str) else list(sl)
    return [n for n in names if n not in ("__dict__", "__weakref__")]


def _leaves(p) -> list:
    """A parameter pytree's arrays, depth first (`Learnables` order)."""
    if isinstance(p, (tuple, list)):
        return [a for e in p for a in _leaves(e)]
    return [np.asarray(p, dtype=np.float32).reshape(-1)]


def _dlnetwork(v):
    """A dlnetwork of either package as the port's, on the active
    engine's device: the same layers, loss and seed, its learnables
    through numpy into the port's flat leaf in the same nesting."""
    from .runtime.builtins.dl_layers import DlNetwork
    layers = [{k: (to_matarray(x) if hasattr(x, "host") and
                   hasattr(x, "mclass") else copy.deepcopy(x))
               for k, x in ly.items()} for ly in v.layers]
    arrays = v.learnables_np() if hasattr(v, "learnables_np") \
        else _leaves(v.params)
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in arrays] or [np.zeros(0, np.float32)])
    net = DlNetwork(layers, seed=getattr(v, "seed", 0), flat=flat)
    net.loss_kind = v.loss_kind
    return net


def carry_session(src, dst) -> None:
    memo: dict = {}
    for name, cls in getattr(src, "classes", {}).items():
        dst.classes[name] = to_port_value(cls, memo)
    for name, v in src.base_frame.vars.items():
        dst.base_frame.vars[name] = to_port_value(v, memo)
    dst.rng.seed, dst.rng.key, dst.rng.counter = src.rng.state_tuple()
