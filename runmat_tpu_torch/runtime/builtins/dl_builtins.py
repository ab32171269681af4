"""Copy of runmat_tpu/runtime/builtins/dl_builtins.py in the PyTorch port.

Deep-learning toolbox builtins (dlarray-style surface).

Reference parity: runmat-runtime/src/builtins/deep_learning/ (autodiff tape,
layers, adam, crossentropy, training). The TPU-native implementation lives in
runmat_tpu/dl (jax-grad based instead of a hand-rolled tape — jax IS the tape);
these builtins expose the MATLAB-level API. Round 1 registers the core
numeric ops; the training loop builtins land with the dl module.

In the port the tape is the same lazy DAG, differentiated by
torch.autograd (`runmat_tpu_torch/dl/autodiff.py`).
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray
from ..dispatch import binary, unary
from ..registry import builtin


@builtin("relu", category="deep_learning", min_in=1, max_in=1, accel_op="relu")
def m_relu(x):
    return binary("max2", x, MatArray.scalar(0.0))


@builtin("sigmoid", category="deep_learning", min_in=1, max_in=1)
def m_sigmoid(x):
    if x.on_device:
        # compositional: stays in the lazy DAG (differentiable)
        e = unary("exp", unary("neg", x))
        return binary("div", MatArray.scalar(1.0),
                      binary("add", MatArray.scalar(1.0), e))
    h = x.host().astype(np.float64)
    r = 1.0 / (1.0 + np.exp(-h))
    from ... import dtypes
    oc = "single" if x.mclass == "single" else "double"
    return MatArray(dtypes.cast_to_class(r, oc), oc)


@builtin("softmax", category="deep_learning", min_in=1, max_in=1)
def m_softmax(x):
    if x.on_device:
        from ...accel import active_engine
        eng = active_engine()
        oc = "single" if x.mclass == "single" else "double"
        mx = eng.reduce("max", x, (0,), oc, None)
        e = unary("exp", binary("sub", x, mx))
        sm = eng.reduce("sum", e, (0,), oc, None)
        return binary("div", e, sm)
    h = x.host().astype(np.float64)
    e = np.exp(h - np.max(h, axis=0, keepdims=True))
    r = e / np.sum(e, axis=0, keepdims=True)
    from ... import dtypes
    oc = "single" if x.mclass == "single" else "double"
    return MatArray(dtypes.cast_to_class(r, oc), oc)


@builtin("crossentropy", category="deep_learning", min_in=2, max_in=2)
def m_crossentropy(pred, target):
    if pred.on_device:
        from ...accel import active_engine
        eng = active_engine()
        oc = "single" if pred.mclass == "single" else "double"
        eps = MatArray.scalar(1e-12)
        lg = unary("log", binary("max2", pred, eps))
        prod = binary("mul", target, lg)
        total = eng.reduce("sum", prod, tuple(range(len(prod.shape))), oc, None)
        nobs = pred.shape[1] if len(pred.shape) > 1 else 1
        return binary("div", unary("neg", total), MatArray.scalar(float(nobs)))
    p = pred.host().astype(np.float64)
    t = target.host().astype(np.float64)
    eps = 1e-12
    ce = -np.sum(t * np.log(np.clip(p, eps, 1.0))) / max(1, p.shape[1] if p.ndim > 1 else 1)
    return MatArray.scalar(float(ce))


@builtin("adamupdate", category="deep_learning", min_in=6, pass_nargout=True)
def m_adamupdate(p, g, m_avg, v_avg, it, lr, *rest, nargout=1):
    """[p, m, v] = adamupdate(p, g, m, v, iter, lr[, beta1, beta2, eps]).

    Reference parity: provider adam_update hook
    (runmat-accelerate-api/src/lib.rs:1582)."""
    beta1 = rest[0].scalar_double() if len(rest) > 0 else 0.9
    beta2 = rest[1].scalar_double() if len(rest) > 1 else 0.999
    eps = rest[2].scalar_double() if len(rest) > 2 else 1e-8
    hp = p.host().astype(np.float64)
    hg = g.host().astype(np.float64)
    hm = m_avg.host().astype(np.float64) if m_avg.size else np.zeros_like(hp)
    hv = v_avg.host().astype(np.float64) if v_avg.size else np.zeros_like(hp)
    t = it.scalar_double()
    lrv = lr.scalar_double()
    hm = beta1 * hm + (1 - beta1) * hg
    hv = beta2 * hv + (1 - beta2) * hg * hg
    mhat = hm / (1 - beta1 ** t)
    vhat = hv / (1 - beta2 ** t)
    hp = hp - lrv * mhat / (np.sqrt(vhat) + eps)
    from ... import dtypes
    oc = "single" if p.mclass == "single" else "double"
    res = [MatArray(dtypes.cast_to_class(hp, oc), oc),
           MatArray(dtypes.cast_to_class(hm, oc), oc),
           MatArray(dtypes.cast_to_class(hv, oc), oc)]
    return res[:max(1, nargout)]


# --------------------------------------------------------------------------- #
# dlarray surface: tracing, gradients, layers, updates
# (≙ deep_learning/{autodiff,layers,training}.rs; TPU-native via jax.grad —
# see runmat_tpu/dl/autodiff.py)
# --------------------------------------------------------------------------- #


def _engine_required(what):
    from ...accel import active_engine
    eng = active_engine()
    if eng is None:
        from ...errors import MatError
        raise MatError("MATLAB:dlarray:noEngine",
                       f"{what} requires the accel engine (torch).")
    return eng


@builtin("dlarray", category="deep_learning", min_in=1, max_in=2)
def m_dlarray(x, labels=None):
    eng = _engine_required("dlarray")
    out = eng.upload(x) if not x.on_device else x
    out.dl = True
    return out


@builtin("extractdata", category="deep_learning", min_in=1, max_in=1)
def m_extractdata(x):
    out = MatArray(x.host().copy(), x.mclass)
    return out


@builtin("isdlarray", category="deep_learning", min_in=1, max_in=1)
def m_isdlarray(x):
    return MatArray.logical_scalar(isinstance(x, MatArray) and
                                   getattr(x, "dl", False))


@builtin("dlfeval", category="deep_learning", min_in=1, max_in=None,
         pass_ctx=True, pass_nargout=True)
def m_dlfeval(f, *args, ctx=None, nargout=1):
    """Run f with tracing enabled: the fusion window is uncapped so the whole
    computation stays in one lazy DAG (the autodiff tape)."""
    eng = _engine_required("dlfeval")
    old = eng.fuse_cap
    eng.fuse_cap = 1 << 60
    try:
        return ctx.interp.call_value(f, list(args), max(1, nargout), ctx.frame)
    finally:
        eng.fuse_cap = old


@builtin("dlgradient", category="deep_learning", min_in=2, max_in=None,
         pass_nargout=True)
def m_dlgradient(loss, *wrt, nargout=1):
    from ...dl.autodiff import grad
    grads = grad(loss, list(wrt))
    return grads[:max(1, nargout)]


@builtin("fullyconnect", category="deep_learning", min_in=3, max_in=3)
def m_fullyconnect(x, w, b):
    from ..dispatch import mtimes
    return binary("add", mtimes(w, x), b)


@builtin("mse", category="deep_learning", min_in=2, max_in=2, pass_ctx=True)
def m_mse(pred, target, ctx=None):
    d = binary("sub", pred, target)
    sq = binary("mul", d, d)
    return _mean_all_traced(sq, ctx)


def _mean_all_traced(x, ctx):
    """mean over all elements, staying in the device DAG when traced."""
    if x.on_device:
        from ...accel import active_engine
        eng = active_engine()
        r = eng.reduce("mean", x, tuple(range(len(x.shape))), 
                       "single" if x.mclass == "single" else "double", None)
        if r is not None:
            return r
    import numpy as _np
    return MatArray.scalar(float(_np.mean(x.host().astype(_np.float64))))


@builtin("l1loss", category="deep_learning", min_in=2, max_in=2, pass_ctx=True)
def m_l1loss(pred, target, ctx=None):
    d = unary("abs", binary("sub", pred, target))
    return _mean_all_traced(d, ctx)


@builtin("huber", category="deep_learning", min_in=2, max_in=3, pass_ctx=True)
def m_huber(pred, target, delta=None, ctx=None):
    dl = delta.scalar_double() if delta is not None else 1.0
    d = binary("sub", pred, target)
    a = unary("abs", d)
    quad = binary("mul", MatArray.scalar(0.5), binary("mul", d, d))
    lin = binary("mul", MatArray.scalar(dl),
                 binary("sub", a, MatArray.scalar(0.5 * dl)))
    small = binary("le", a, MatArray.scalar(dl))
    sel = binary("add",
                 binary("mul", small, quad),
                 binary("mul", binary("sub", MatArray.scalar(1.0), small), lin))
    return _mean_all_traced(sel, ctx)


@builtin("sgdmupdate", category="deep_learning", min_in=3, max_in=5,
         pass_nargout=True)
def m_sgdmupdate(p, g, vel, lr=None, momentum=None, nargout=1):
    lrv = lr.scalar_double() if lr is not None else 0.01
    mom = momentum.scalar_double() if momentum is not None else 0.9
    hv = vel.host().astype(np.float64) if vel.size else \
        np.zeros_like(p.host(), dtype=np.float64)
    hv = mom * hv - lrv * g.host().astype(np.float64)
    hp = p.host().astype(np.float64) + hv
    from ... import dtypes
    oc = "single" if p.mclass == "single" else "double"
    res = [MatArray(dtypes.cast_to_class(hp, oc), oc),
           MatArray(dtypes.cast_to_class(hv, oc), oc)]
    return res[:max(1, nargout)]


@builtin("dlupdate", category="deep_learning", min_in=2, max_in=None,
         pass_ctx=True)
def m_dlupdate(f, p, *rest, ctx=None):
    args = [p] + list(rest)
    r = ctx.interp.call_value(f, args, 1, ctx.frame)
    return r[0]


# --------------------------------------------------------------------------- #
# model container + ONNX import/export (≙ deep_learning/{model,onnx}.rs)
# --------------------------------------------------------------------------- #


def _layers_from_struct(model):
    from ...values import CellArray, StructArray, text_of
    if not isinstance(model, StructArray) or "Layers" not in model.fields:
        from ...errors import bad_arg
        raise bad_arg("onnx", "Model must be a struct with a Layers cell.")
    cell = model.fields["Layers"].reshape(-1)[0]
    layers = []
    for item in cell.data.reshape(-1, order="F"):
        t = text_of(item.fields["type"].reshape(-1)[0])
        ly = {"type": t}
        if t == "fc":
            ly["W"] = item.fields["W"].reshape(-1)[0].host().astype(np.float64)
            ly["b"] = item.fields["b"].reshape(-1)[0].host().astype(np.float64)
        layers.append(ly)
    return layers


def _layers_to_struct(layers):
    from ...values import CellArray, StructArray
    data = np.empty((1, len(layers)), dtype=object)
    for i, ly in enumerate(layers):
        fields = {"type": MatArray.char_from_str(ly["type"])}
        if ly["type"] == "fc":
            fields["W"] = MatArray(np.asarray(ly["W"], np.float64), "double")
            fields["b"] = MatArray(np.asarray(ly["b"], np.float64)
                                   .reshape(-1, 1), "double")
        data[0, i] = StructArray.scalar(fields)
    return StructArray.scalar({"Layers": CellArray(data)})


@builtin("exportONNXNetwork", category="deep_learning", min_in=2, max_in=2)
def m_export_onnx(model, path):
    from ...dl.onnx import export_onnx
    from ...values import text_of
    layers = _layers_from_struct(model)
    fc = next((l for l in layers if l["type"] == "fc"), None)
    in_dim = fc["W"].shape[1] if fc is not None else 1
    export_onnx(layers, text_of(path), in_dim)
    return None


@builtin("importONNXNetwork", category="deep_learning", min_in=1, max_in=1)
def m_import_onnx(path):
    from ...dl.onnx import import_onnx
    from ...values import text_of
    return _layers_to_struct(import_onnx(text_of(path)))


@builtin("predict", category="deep_learning", min_in=2, max_in=2)
def m_predict(model, x):
    """Forward pass of a Layers-struct model: X is (features x batch)."""
    from ..dispatch import mtimes
    cur = x
    for ly in _layers_from_struct(model):
        if ly["type"] == "fc":
            W = MatArray(np.asarray(ly["W"], np.float64), "double")
            b = MatArray(np.asarray(ly["b"], np.float64).reshape(-1, 1), "double")
            cur = binary("add", mtimes(W, cur), b)
        elif ly["type"] == "relu":
            cur = binary("max2", cur, MatArray.scalar(0.0))
        elif ly["type"] == "sigmoid":
            cur = m_sigmoid(cur)
        elif ly["type"] == "softmax":
            cur = m_softmax(cur)
        elif ly["type"] == "tanh":
            cur = unary("tanh", cur)
    return cur
