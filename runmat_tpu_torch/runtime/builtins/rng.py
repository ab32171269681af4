"""Copy of runmat_tpu/runtime/builtins/rng.py in the PyTorch port.

RNG builtins: rng/rand/randn/randi/randperm.

Reference parity: runmat-runtime/src/builtins/math (random) + the Philox GPU
RNG with host-mirrored state (runmat-accelerate/src/backend/wgpu/provider/ops/
random.rs:6-119). The session owns one Philox state; draws consume a
deterministic number of blocks whether they execute on host numpy or on device
jax, so host/device sequences are identical (gather parity).
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...ops import ctrng as philox
from ...values import MatArray, StructArray, is_text, normalize_shape, text_of
from ..registry import builtin
from .common import parse_size_args, scalar_int


def _engine():
    from ...accel import active_engine
    return active_engine()


def _gen(ctx, kind: str, args: list):
    dims, mclass, like = parse_size_args(list(args))
    mclass = mclass or "double"
    if mclass not in ("double", "single"):
        raise bad_arg(kind, f"Class must be 'double' or 'single', got '{mclass}'.")
    n = 1
    for d in dims:
        n *= d
    state = ctx.session.rng
    on_device = like is not None and isinstance(like, MatArray) and like.on_device
    eng = _engine()
    if eng is not None and (on_device or eng.offload_rng(n)):
        return eng.random(kind, state, dims, mclass)
    if kind == "rand":
        vals = philox.host_rand(state, n, mclass)
    else:
        vals = philox.host_randn(state, n, mclass)
    return MatArray(np.reshape(vals, normalize_shape(dims), order="F"), mclass)


@builtin("rand", category="math/random", pass_ctx=True)
def m_rand(*args, ctx=None):
    return _gen(ctx, "rand", list(args))


@builtin("randn", category="math/random", pass_ctx=True)
def m_randn(*args, ctx=None):
    return _gen(ctx, "randn", list(args))


@builtin("randi", category="math/random", min_in=1, pass_ctx=True)
def m_randi(imax, *args, ctx=None):
    if isinstance(imax, MatArray) and imax.size == 2:
        lo, hi = (int(v) for v in imax.host().reshape(-1))
    else:
        lo, hi = 1, scalar_int(imax, "imax")
    dims, mclass, _ = parse_size_args(list(args))
    n = 1
    for d in dims:
        n *= d
    u = philox.host_rand(ctx.session.rng, n, "double")
    vals = np.floor(u * (hi - lo + 1)).astype(np.float64) + lo
    out_class = mclass or "double"
    from ... import dtypes
    data = np.reshape(vals, normalize_shape(dims), order="F")
    if out_class != "double":
        data = dtypes.cast_to_class(data, out_class)
    return MatArray(data, out_class)


@builtin("randperm", category="math/random", min_in=1, max_in=2, pass_ctx=True)
def m_randperm(n, k=None, ctx=None):
    nn = scalar_int(n, "n")
    kk = scalar_int(k, "k") if k is not None else nn
    u = philox.host_rand(ctx.session.rng, nn, "double")
    perm = np.argsort(u, kind="stable")[:kk].astype(np.float64) + 1
    return MatArray(perm.reshape(1, -1), "double")


@builtin("rng", category="math/random", min_in=0, max_in=2, pass_ctx=True, pass_nargout=True)
def m_rng(*args, ctx=None, nargout=0):
    state = ctx.session.rng
    prev = None
    if nargout >= 1:
        prev = StructArray.scalar({
            "Type": MatArray.char_from_str(state.generator),
            "Seed": MatArray.scalar(float(state.seed)),
            "State": MatArray.scalar(float(state.counter)),
        })
    if args:
        a = args[0]
        if is_text(a):
            t = text_of(a)
            if t == "default":
                state.reseed(0)
            elif t == "shuffle":
                import time
                state.reseed(int(time.time_ns()) & 0xFFFFFFFF)
            else:
                raise bad_arg("rng", f"Unknown rng option '{t}'.")
        elif isinstance(a, StructArray):
            seed = int(a.get_scalar_field("Seed").scalar_double())
            ctr = int(a.get_scalar_field("State").scalar_double()) if "State" in a.fields else 0
            state.reseed(seed)
            state.counter = ctr
        else:
            state.reseed(scalar_int(a, "seed"))
    if prev is not None:
        return prev
    return None
