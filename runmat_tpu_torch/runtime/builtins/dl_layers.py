"""Copy of runmat_tpu/runtime/builtins/dl_layers.py in the PyTorch port.

Deep-learning layer API: layer constructors, layerGraph, dlnetwork,
trainingOptions, trainNetwork/trainnet, forward, analyzeNetwork, padsequences.

Reference parity: runmat-runtime/src/builtins/deep_learning/{layers,training,
model}.rs — the reference registers layer constructors + a host training
loop with provider adam_update hooks. The JAX package compiles a network's
forward and its whole Adam/SGDM step into jitted XLA programs. Here a
dlnetwork's learnables are one flat float32 tensor on the card; the
forward is torch (cuDNN convolutions, cuBLAS products) around the
hand-written LSTM recurrence (`ops/lstm_seq.py`: a direction one launch
of a thread-block cluster; a layer too wide for one runs a product and the
cell of `ops/lstm.py` a step); the training step (forward, loss,
`torch.autograd.grad`, the hand-written optimizer update of `ops/optim.py`)
is captured once as a CUDA graph and replayed for every minibatch, and the
loop reads nothing back. The layer constructors, layerGraph,
trainingOptions, analyzeNetwork and padsequences are copied as they are.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...accel import active_engine
from ...errors import MatError, bad_arg
from ...ops import jaxrandom, lstm, lstm_seq, optim
from ...values import (CellArray, MatArray, StructArray, is_text, text_of)
from ..registry import builtin
from .common import scalar_int, scalar_num


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


def _layer(kind: str, **params) -> StructArray:
    fields = {"Type": MatArray.char_from_str(kind)}
    for k, v in params.items():
        if isinstance(v, (int, float)):
            fields[k] = MatArray.scalar(float(v))
        elif isinstance(v, str):
            fields[k] = MatArray.char_from_str(v)
        else:
            fields[k] = v
    return StructArray.scalar(fields)


# ------------------------------------------------------ layer constructors --- #

@builtin("featureInputLayer", category="deep_learning", min_in=1)
def m_feature_input(n, *opts):
    return _layer("featureInput", InputSize=scalar_int(n, "numFeatures"))


@builtin("sequenceInputLayer", category="deep_learning", min_in=1)
def m_sequence_input(n, *opts):
    return _layer("sequenceInput", InputSize=scalar_int(n, "numFeatures"))


@builtin("fullyConnectedLayer", category="deep_learning", min_in=1)
def m_fully_connected(n, *opts):
    return _layer("fc", OutputSize=scalar_int(n, "outputSize"))


@builtin("reluLayer", category="deep_learning", min_in=0)
def m_relu_layer(*opts):
    return _layer("relu")


@builtin("eluLayer", category="deep_learning", min_in=0)
def m_elu_layer(*opts):
    return _layer("elu")


@builtin("tanhLayer", category="deep_learning", min_in=0)
def m_tanh_layer(*opts):
    return _layer("tanh")


@builtin("sigmoidLayer", category="deep_learning", min_in=0)
def m_sigmoid_layer(*opts):
    return _layer("sigmoid")


@builtin("softmaxLayer", category="deep_learning", min_in=0)
def m_softmax_layer(*opts):
    return _layer("softmax")


@builtin("dropoutLayer", category="deep_learning", min_in=0, max_in=1)
def m_dropout_layer(p=None):
    return _layer("dropout", Probability=scalar_num(p, "p") if p is not None else 0.5)


@builtin("layerNormalizationLayer", category="deep_learning", min_in=0)
def m_layernorm_layer(*opts):
    return _layer("layernorm")


@builtin("lstmLayer", category="deep_learning", min_in=1)
def m_lstm_layer(n, *opts):
    mode = "sequence"
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        if is_text(opts[i]) and text_of(opts[i]) == "OutputMode":
            mode = text_of(opts[i + 1])
    return _layer("lstm", NumHiddenUnits=scalar_int(n, "numHiddenUnits"),
                  OutputMode=mode)


@builtin("bilstmLayer", category="deep_learning", min_in=1)
def m_bilstm_layer(n, *opts):
    mode = "sequence"
    opts = list(opts)
    for i in range(0, len(opts) - 1, 2):
        if is_text(opts[i]) and text_of(opts[i]) == "OutputMode":
            mode = text_of(opts[i + 1])
    return _layer("bilstm", NumHiddenUnits=scalar_int(n, "numHiddenUnits"),
                  OutputMode=mode)


@builtin("convolution1dLayer", category="deep_learning", min_in=2)
def m_conv1d_layer(k, nf, *opts):
    return _layer("conv1d", FilterSize=scalar_int(k, "filterSize"),
                  NumFilters=scalar_int(nf, "numFilters"))


@builtin("globalAveragePooling1dLayer", category="deep_learning", min_in=0)
def m_gap1d_layer(*opts):
    return _layer("gap1d")


def _nv_opt(opts, name, default):
    """Name/value option scan for layer constructors."""
    from ...values import is_text
    vals = list(opts)
    for i in range(0, len(vals) - 1):
        if is_text(vals[i]) and text_of(vals[i]).lower() == name.lower():
            v = vals[i + 1]
            if is_text(v):
                return text_of(v)
            return float(v.host().reshape(-1)[0])
    return default


@builtin("imageInputLayer", category="deep_learning", min_in=1)
def m_image_input(sz, *opts):
    """imageInputLayer([h w c]): data flows (H, W, C, N) (MATLAB SSCB)."""
    dims = [int(v) for v in sz.host().reshape(-1)]
    while len(dims) < 3:
        dims.append(1)
    return _layer("imageInput", InputSize=MatArray(
        np.array([dims[:3]], dtype=np.float64), "double"))


@builtin("convolution2dLayer", category="deep_learning", min_in=2)
def m_conv2d_layer(k, nf, *opts):
    ks = [int(v) for v in k.host().reshape(-1)]
    if len(ks) == 1:
        ks = [ks[0], ks[0]]
    pad = _nv_opt(opts, "Padding", 0)
    stride = _nv_opt(opts, "Stride", 1)
    return _layer("conv2d",
                  FilterSize=MatArray(np.array([ks[:2]], np.float64),
                                      "double"),
                  NumFilters=scalar_int(nf, "numFilters"),
                  Padding=(pad if isinstance(pad, str) else float(pad)),
                  Stride=float(stride) if not isinstance(stride, str)
                  else 1.0)


@builtin("maxPooling2dLayer", category="deep_learning", min_in=1)
def m_maxpool2d_layer(k, *opts):
    stride = _nv_opt(opts, "Stride", None)
    ks = scalar_int(k, "poolSize")
    return _layer("maxpool2d", PoolSize=float(ks),
                  Stride=float(stride) if stride is not None else float(ks))


@builtin("averagePooling2dLayer", category="deep_learning", min_in=1)
def m_avgpool2d_layer(k, *opts):
    stride = _nv_opt(opts, "Stride", None)
    ks = scalar_int(k, "poolSize")
    return _layer("avgpool2d", PoolSize=float(ks),
                  Stride=float(stride) if stride is not None else float(ks))


@builtin("globalAveragePooling2dLayer", category="deep_learning", min_in=0)
def m_gap2d_layer(*opts):
    return _layer("gap2d")


@builtin("batchNormalizationLayer", category="deep_learning", min_in=0)
def m_batchnorm_layer(*opts):
    return _layer("batchnorm")


@builtin("flattenLayer", category="deep_learning", min_in=0)
def m_flatten_layer(*opts):
    return _layer("flatten")


@builtin("classificationLayer", category="deep_learning", min_in=0)
def m_classification_layer(*opts):
    return _layer("classification")


@builtin("regressionLayer", category="deep_learning", min_in=0)
def m_regression_layer(*opts):
    return _layer("regression")


@builtin("layerGraph", category="deep_learning", min_in=0)
def m_layer_graph(*layers):
    items: list = []
    for l in layers:
        if isinstance(l, CellArray):
            items.extend(l.data.reshape(-1, order="F"))
        else:
            items.append(l)
    data = np.empty((len(items), 1), dtype=object)
    for i, l in enumerate(items):
        data[i, 0] = l
    return StructArray.scalar({"Layers": CellArray(data)})


# ------------------------------------------------------------- dlnetwork --- #

def _layers_list(v) -> list[dict]:
    """Normalize layers input (cell array / layerGraph struct / single layer)
    into a list of {Type, params} dicts."""
    items: list = []
    if isinstance(v, StructArray) and v.is_scalar and "Layers" in v.fields:
        inner = v.get_scalar_field("Layers")
        items = list(inner.data.reshape(-1, order="F"))
    elif isinstance(v, CellArray):
        items = list(v.data.reshape(-1, order="F"))
    elif isinstance(v, StructArray) and not v.is_scalar:
        for i in range(v.size):
            items.append(StructArray.scalar(
                {k: v.fields[k].reshape(-1)[i] for k in v.fields}))
    else:
        items = [v]
    out = []
    for it in items:
        if not isinstance(it, StructArray):
            raise bad_arg("dlnetwork", "Each layer must be a layer struct.")
        d = {"Type": it.get_scalar_field("Type").to_str()}
        for k in it.fields:
            if k == "Type":
                continue
            fv = it.get_scalar_field(k)
            if isinstance(fv, MatArray) and fv.mclass == "char":
                d[k] = fv.to_str()
            elif isinstance(fv, MatArray) and fv.size == 1:
                d[k] = float(fv.host().reshape(-1)[0])
            else:
                d[k] = fv
        out.append(d)
    return out


class DlNetwork:
    """Feed-forward/sequence network. Its learnables are one flat float32
    leaf tensor (`flat`) on the active engine's device (the CPU where no
    engine is active); `params` holds views of it in the JAX package's
    nesting (a tuple a layer, an LSTM direction a tuple of (Wx, Wh, b)),
    depth first in the order `Learnables` reads them. The forward is a
    plain function of tensors (`forward_fn`)."""

    mclass = "dlnetwork"
    shared = False

    def __init__(self, layers: list[dict], seed: int = 0, flat=None,
                 device=None):
        self.layers = layers
        self.loss_kind = "none"
        if layers and layers[-1]["Type"] in ("classification", "regression"):
            self.loss_kind = layers[-1]["Type"]
        self.seed = seed
        if device is None:
            eng = active_engine()
            device = eng.device if eng is not None else "cpu"
        self.device = torch.device(device)
        self._spec, draws = self._layout(seed, draw=flat is None)
        if flat is None:
            flat = np.concatenate([d.reshape(-1) for d in draws]) \
                if draws else np.zeros(0, np.float32)
        self.flat = _upload(np.asarray(flat, np.float32).reshape(-1),
                            self.device)
        self.params = self.views(self.flat)
        # the captured training steps, by (solver, rate, batch shapes)
        self._train_steps: dict = {}

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self

    # -- parameter init -- #

    def _layout(self, seed: int, draw: bool = True) -> tuple:
        """(the shapes of the learnables in the JAX nesting, their initial
        values in flat order as float32 numpy arrays, or none without
        `draw`). The draws are jax.random's (`ops/jaxrandom.py`), key for
        key as the JAX package's `_init_params` splits them."""
        key = jaxrandom.prng_key(seed)
        spec: list = []
        draws: list = []

        def uniform(k, shape, lim):
            if draw:
                draws.append(jaxrandom.uniform(k, shape, -lim, lim).numpy())
            return tuple(shape)

        def const(shape, value):
            if draw:
                draws.append(np.full(shape, value, np.float32))
            return tuple(shape)

        width = None
        for ly in self.layers:
            t = ly["Type"]
            if t in ("featureInput", "sequenceInput"):
                width = int(ly["InputSize"])
                spec.append(())
            elif t == "fc":
                out = int(ly["OutputSize"])
                key, k1 = jaxrandom.split(key)
                lim = np.sqrt(6.0 / (width + out))
                spec.append((uniform(k1, (out, width), lim),
                             const((out, 1), 0.0)))
                width = out
            elif t in ("lstm", "bilstm"):
                h = int(ly["NumHiddenUnits"])
                ndir = 2 if t == "bilstm" else 1
                ps = []
                for _ in range(ndir):
                    key, k1, k2 = jaxrandom.split(key, 3)
                    lim = np.sqrt(6.0 / (width + h))
                    ps.append((uniform(k1, (4 * h, width), lim),
                               uniform(k2, (4 * h, h), lim),
                               const((4 * h,), 0.0)))
                spec.append(tuple(ps))
                width = h * ndir
            elif t == "conv1d":
                k_sz = int(ly["FilterSize"])
                nf = int(ly["NumFilters"])
                key, k1 = jaxrandom.split(key)
                lim = np.sqrt(6.0 / (width * k_sz + nf))
                spec.append((uniform(k1, (nf, width, k_sz), lim),
                             const((nf,), 0.0)))
                width = nf
            elif t == "imageInput":
                h, w, c = [int(v) for v in
                           np.asarray(ly["InputSize"].host()).reshape(-1)]
                width = (h, w, c)
                spec.append(())
            elif t == "conv2d":
                kh, kw = [int(v) for v in
                          np.asarray(ly["FilterSize"].host()).reshape(-1)]
                nf = int(ly["NumFilters"])
                h, w, c = width
                key, k1 = jaxrandom.split(key)
                lim = np.sqrt(6.0 / (kh * kw * c + nf))
                spec.append((uniform(k1, (kh, kw, c, nf), lim),
                             const((nf,), 0.0)))
                s = int(ly.get("Stride", 1))
                pad = ly.get("Padding", 0)
                if pad == "same":
                    h2, w2 = -(-h // s), -(-w // s)
                else:
                    p = int(pad) if not isinstance(pad, str) else 0
                    h2 = (h + 2 * p - kh) // s + 1
                    w2 = (w + 2 * p - kw) // s + 1
                width = (h2, w2, nf)
            elif t in ("maxpool2d", "avgpool2d"):
                h, w, c = width
                k_sz = int(ly["PoolSize"])
                s = int(ly.get("Stride", k_sz))
                width = ((h - k_sz) // s + 1, (w - k_sz) // s + 1, c)
                spec.append(())
            elif t == "batchnorm":
                c = width[2] if isinstance(width, tuple) else width
                spec.append((const((c,), 1.0), const((c,), 0.0)))
            elif t in ("flatten", "gap2d"):
                if isinstance(width, tuple):
                    h, w, c = width
                    width = h * w * c if t == "flatten" else c
                spec.append(())
            elif t == "layernorm":
                spec.append((const((width, 1), 1.0), const((width, 1), 0.0)))
            else:
                spec.append(())
        return spec, draws

    def views(self, flat: torch.Tensor) -> list:
        """The nested learnables as views of a flat tensor (the network's
        own `flat`, or a leaf that shares it, for autograd)."""
        return _views(self._spec, flat)

    def numel(self) -> int:
        return int(self.flat.numel())

    # -- forward as a plain function of tensors (features x batch layout) -- #

    def forward_fn(self):
        """fwd(params, x): the JAX package's forward (dl_layers.py:399-486)
        in torch, on the JAX layouts at its boundary (features x batch;
        (H, W, C, N) images; (F, T, N) sequences). Inside, image layers
        run NCHW (cuDNN's layout) and go back to (H, W, C, N) wherever a
        layer needs the JAX layout. Kept from JAX where torch differs:
        relu is maximum(x, 0) (half the gradient to each side at a tie,
        as jnp.maximum); batchnorm and layernorm use the batch's population
        statistics and keep no running statistics; flatten reshapes (H, W,
        C, N) in C order; SAME padding is jax's (the odd pixel after)."""
        layers = self.layers

        def lstm_dir(p, x, reverse: bool, last: bool):
            Wx, Wh, b = p
            h_units = Wh.shape[1]
            seq = torch.flip(x, (1,)) if reverse else x   # (F, T, N)
            n_f, n_t, n = seq.shape
            if lstm_seq.layout(h_units, n)[0]:
                # Wx x_t + b for every step in one product, (4H, T, N);
                # the recurrence is one launch (ops/lstm_seq.py)
                zx = torch.matmul(Wx, seq.reshape(n_f, n_t * n)) + b[:, None]
                hs = lstm_seq.sequence(zx.view(-1, n_t, n), Wh,
                                       last and not reverse)
                return torch.flip(hs, (1,)) if reverse else hs
            # too wide for a cluster: a product and a cell a step,
            # Wx x_t + b for every step in one product: (T, 4H, N)
            zx = torch.matmul(Wx, seq.permute(1, 0, 2)) + b[:, None]
            h = torch.zeros((h_units, n), dtype=x.dtype, device=x.device)
            c = h
            hs = []
            for t in range(n_t):
                h, c = lstm.cell(torch.addmm(zx[t], Wh, h), c)
                hs.append(h)
            if last and not reverse:
                return h[:, None, :]
            hs = torch.stack(hs, 1)   # (H, T, N)
            return torch.flip(hs, (1,)) if reverse else hs

        def to_jax(cur, img):
            return (cur.permute(2, 3, 1, 0) if img else cur), False

        def fwd(params, x, train: bool = False):
            cur = x
            img = False                # cur is NCHW, not (H, W, C, N)
            for ly, p in zip(layers, params):
                t = ly["Type"]
                if cur.ndim == 4 and (t in _IMAGE_LAYERS) != img:
                    cur = cur.permute(2, 3, 1, 0) if img else \
                        cur.permute(3, 2, 0, 1)
                    img = not img
                if t == "fc":
                    W, b = p
                    if cur.ndim == 3:   # (F, T, N): apply per timestep
                        cur = torch.einsum("of,ftn->otn", W, cur) + \
                            b[:, :, None]
                    else:
                        cur = W @ cur + b
                elif t == "relu":
                    cur = torch.maximum(cur, cur.new_zeros(()))
                elif t == "elu":
                    cur = torch.where(cur > 0, cur, torch.expm1(cur))
                elif t == "tanh":
                    cur = torch.tanh(cur)
                elif t == "sigmoid":
                    cur = torch.sigmoid(cur)
                elif t == "softmax":
                    cur = torch.softmax(cur, dim=0)
                elif t == "dropout":
                    pass   # identity at inference; training uses inverted noise upstream
                elif t == "layernorm":
                    g, b = p
                    mu = cur.mean(dim=0, keepdim=True)
                    sd = cur.std(dim=0, keepdim=True, correction=0) + 1e-5
                    cur = (cur - mu) / sd * g + b
                elif t in ("lstm", "bilstm"):
                    if cur.ndim == 2:
                        cur = cur[:, :, None] if cur.shape[1] > 1 \
                            else cur[:, None, :]
                    last = ly.get("OutputMode", "sequence") != "sequence"
                    hs = lstm_dir(p[0], cur, False, last and t == "lstm")
                    if t == "bilstm":
                        hs2 = lstm_dir(p[1], cur, True, False)
                        hs = torch.cat([hs, hs2], dim=0)
                    cur = hs if not last else hs[:, -1, :]
                elif t == "conv1d":
                    W, b = p   # (O, F, K)
                    y = F.conv1d(cur.permute(2, 0, 1), W)   # (N, O, T')
                    y = y + b[None, :, None]
                    cur = y.permute(1, 2, 0)                # (O, T', N)
                elif t == "gap1d":
                    cur = cur.mean(dim=1)
                elif t == "conv2d":
                    W, b = p           # (kh, kw, C, O)
                    s = int(ly.get("Stride", 1))
                    pad = ly.get("Padding", 0)
                    kh, kw = W.shape[0], W.shape[1]
                    if pad == "same":
                        ph = _same_pads(cur.shape[2], kh, s)
                        pw = _same_pads(cur.shape[3], kw, s)
                    else:
                        pp = int(pad) if not isinstance(pad, str) else 0
                        ph = pw = (pp, pp)
                    if any(ph + pw):
                        cur = F.pad(cur, pw + ph)
                    y = F.conv2d(cur, W.permute(3, 2, 0, 1), stride=s)
                    cur = y + b[None, :, None, None]
                elif t in ("maxpool2d", "avgpool2d"):
                    k_sz = int(ly["PoolSize"])
                    s = int(ly.get("Stride", k_sz))
                    pool = F.max_pool2d if t == "maxpool2d" else F.avg_pool2d
                    cur = pool(cur, k_sz, s)
                elif t == "batchnorm":
                    g, b = p
                    if cur.ndim == 4:   # NCHW: stats per channel
                        var, mu = torch.var_mean(cur, dim=(0, 2, 3),
                                                 keepdim=True, correction=0)
                        cur = (cur - mu) / torch.sqrt(var + 1e-5)
                        cur = cur * g[None, :, None, None] + \
                            b[None, :, None, None]
                    else:
                        var, mu = torch.var_mean(cur, dim=-1, keepdim=True,
                                                 correction=0)
                        cur = (cur - mu) / torch.sqrt(var + 1e-5)
                        cur = cur * g[:, None] + b[:, None]
                elif t == "gap2d":
                    cur = cur.mean(dim=(2, 3)).t()     # (C, N)
                    img = False
                elif t == "flatten":
                    cur, img = to_jax(cur, img)
                    n = cur.shape[3]
                    cur = cur.reshape(-1, n)           # (H*W*C, N)
            cur, img = to_jax(cur, img)
            return cur

        return fwd

    def predict_np(self, x: np.ndarray) -> np.ndarray:
        _check_features(self.layers, np.shape(x))
        fwd = self.forward_fn()
        xt = _upload(np.asarray(x, np.float32), self.device)
        with torch.no_grad(), _precise(self.device):
            out = fwd(self.params, xt)
        return _gather(out)

    def learnables_np(self) -> list:
        """The learnables as float32 numpy arrays, in `Learnables` order
        (one copy of the flat buffer to the host)."""
        flat = _gather(self.flat)
        out, off = [], 0

        def walk(node):
            nonlocal off
            if node and isinstance(node[0], int):
                n = math.prod(node)
                out.append(flat[off:off + n].reshape(node))
                off += n
            else:
                for e in node:
                    walk(e)

        for p in self._spec:
            walk(p)
        return out

    # -- object protocol -- #

    def _mat_get_field_(self, fname):
        if fname == "Layers":
            data = np.empty((len(self.layers), 1), dtype=object)
            for i, ly in enumerate(self.layers):
                fields = {"Type": MatArray.char_from_str(ly["Type"])}
                data[i, 0] = StructArray.scalar(fields)
            return CellArray(data)
        if fname == "Learnables":
            flat = self.learnables_np()
            data = np.empty((len(flat), 1), dtype=object)
            for i, w in enumerate(flat):
                data[i, 0] = MatArray(np.asarray(w, dtype=np.float64), "double")
            return CellArray(data)
        return NotImplemented

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname in ("predict", "forward"):
            x = args[0].host().astype(np.float64)
            if self.layers and self.layers[0]["Type"] == "imageInput" \
                    and x.ndim == 3:
                x = x[:, :, None, :]   # squeezed single-channel batch
            return [MatArray(self.predict_np(x).astype(np.float64), "double")]
        return NotImplemented


def _views(spec: list, flat: torch.Tensor) -> list:
    """Views of `flat` in the nesting of `spec` (DlNetwork._layout's)."""
    off = 0

    def walk(node):
        nonlocal off
        if node and isinstance(node[0], int):
            n = math.prod(node)
            v = flat[off:off + n].view(node)
            off += n
            return v
        return tuple(walk(e) for e in node)

    return [walk(p) for p in spec]


# the layers that take an NCHW image as it is (or any layout)
_IMAGE_LAYERS = ("conv2d", "maxpool2d", "avgpool2d", "batchnorm", "relu",
                 "elu", "tanh", "sigmoid", "dropout", "gap2d", "flatten")


# the layers that keep their input's shape, and those that multiply it by
# learnables sized by the input layer's width
_WIDTH_KEEPING = ("relu", "elu", "tanh", "sigmoid", "softmax", "dropout")
_PRODUCTS = ("fc", "lstm", "bilstm")
_NORMS = ("layernorm", "batchnorm")


def _check_features(layers: list, shape: tuple) -> None:
    """Raise where the first layers that read X's feature width would fail
    on X's shape, as the JAX package's jax ops do (torch raises a
    RuntimeError, which the VM maps to RunMat:builtin:internalError): a
    product whose width is not X's, a TypeError there (jax's dot_general,
    MATLAB:invalidType); a normalization's (width, 1) scale that does not
    broadcast against X, a TypeError where X has two dimensions (lax's
    mul) and a ValueError where it has another number (jnp's own rule,
    MATLAB:sizeDimensionsMustMatch). Where the scale broadcasts, X takes
    the broadcast shape, as in both packages' forwards."""
    if not layers or not shape or \
            layers[0]["Type"] not in ("featureInput", "sequenceInput"):
        return
    want = int(layers[0]["InputSize"])
    shape = tuple(shape)
    for ly in layers[1:]:
        if ly["Type"] in _NORMS:
            try:
                shape = np.broadcast_shapes(shape, (want, 1))
            except ValueError:
                err = TypeError if len(shape) == 2 else ValueError
                raise err(f"{ly['Type']}: Incompatible shapes for "
                          f"broadcasting: shapes={[shape, (want, 1)]}"
                          ) from None
        elif ly["Type"] in _PRODUCTS:
            if shape[0] != want:
                raise TypeError(f"{ly['Type']}: the input has {shape[0]} "
                                f"features, the network takes {want}")
            return
        elif ly["Type"] not in _WIDTH_KEEPING:
            return


def _same_pads(size: int, k: int, s: int) -> tuple:
    """jax's SAME padding of one dim: (before, after), the odd one after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return (total // 2, total - total // 2)


@contextlib.contextmanager
def _precise(device, deterministic: bool = True):
    """On a card: float32 products and convolutions in full float32 (TF32
    off for cuBLAS and cuDNN, as the JAX package computes them on the CPU)
    and cuDNN's deterministic algorithms (two trainings give the same
    learnables bit for bit), inside the block only."""
    if device.type != "cuda":
        yield
        return
    from ...accel.dense import tf32
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        with tf32(False, "matmul"), tf32(False, "conv"):
            yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _upload(h: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`, one counted upload to a card
    (through pinned memory, asynchronous, as the engine's `to_device`)."""
    h = np.ascontiguousarray(h)
    if device.type != "cuda":
        return torch.from_numpy(h.copy())
    eng = active_engine()
    if eng is not None:
        eng.stats["uploads"] += 1
        eng.stats["upload_bytes"] += h.nbytes
    buf = torch.empty(h.shape, dtype=torch.from_numpy(h[:0]).dtype,
                      pin_memory=True)
    buf.numpy()[...] = h
    return buf.to(device, non_blocking=True)


def _gather(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; a copy from a card is one counted
    gather."""
    t = t.detach()
    if t.device.type == "cuda":
        eng = active_engine()
        if eng is not None:
            eng.stats["gathers"] += 1
            eng.stats["gather_bytes"] += int(t.nbytes)
    return t.cpu().numpy().copy()


@builtin("dlnetwork", category="deep_learning", min_in=1, max_in=2)
def m_dlnetwork(layers, *rest):
    return DlNetwork(_layers_list(layers))


@builtin("forward", category="deep_learning", min_in=2, max_in=2)
def m_forward(net, x):
    if not isinstance(net, DlNetwork):
        raise bad_arg("forward", "Expected a dlnetwork.")
    return MatArray(net.predict_np(_f(x)).astype(np.float64), "double")


@builtin("analyzeNetwork", category="deep_learning", min_in=1, max_in=1,
         pass_ctx=True)
def m_analyze_network(net, ctx=None):
    layers = net.layers if isinstance(net, DlNetwork) else _layers_list(net)
    n_params = 0
    if isinstance(net, DlNetwork):
        for p in net.params:
            stack = list(p) if isinstance(p, tuple) else []
            while stack:
                e = stack.pop(0)
                if isinstance(e, tuple):
                    stack = list(e) + stack
                else:
                    n_params += int(np.prod(e.shape))
    ctx.session.write(f"  {len(layers)} layers, {n_params} learnables\n")
    for i, ly in enumerate(layers, 1):
        ctx.session.write(f"  {i:3d}  {ly['Type']}\n")
    return StructArray.scalar({
        "NumLayers": MatArray.scalar(float(len(layers))),
        "TotalLearnables": MatArray.scalar(float(n_params)),
    })


# ---------------------------------------------------------------- training --- #

@builtin("trainingOptions", category="deep_learning", min_in=1)
def m_training_options(solver, *args):
    fields = {
        "Solver": MatArray.char_from_str(text_of(solver)),
        "MaxEpochs": MatArray.scalar(30.0),
        "MiniBatchSize": MatArray.scalar(128.0),
        "InitialLearnRate": MatArray.scalar(
            0.001 if text_of(solver) == "adam" else 0.01),
        "Shuffle": MatArray.char_from_str("once"),
        "Verbose": MatArray.logical_scalar(False),
        "ExecutionEnvironment": MatArray.char_from_str("auto"),
    }
    i = 0
    args = list(args)
    while i + 1 < len(args):
        fields[text_of(args[i])] = args[i + 1]
        i += 2
    return StructArray.scalar(fields)


def _opt(opts, name, default):
    if isinstance(opts, StructArray) and name in opts.fields:
        v = opts.get_scalar_field(name)
        if isinstance(v, MatArray) and v.mclass == "char":
            return v.to_str()
        if isinstance(v, MatArray):
            return float(v.host().reshape(-1)[0])
    return default


class _TrainStep:
    """One training step over static buffers: the minibatch (`xb`, `yb`),
    the network's flat learnables and the optimizer's state
    (`ops/optim.State`). `body` runs the forward, the loss,
    `torch.autograd.grad` into one flat gradient and the update (`ops/
    optim.update`, which advances t on the device inside its launch);
    nothing in it waits for the card. On the CPU `run` calls it eagerly (the plain versions). On a card
    the first WARMUP steps run eagerly on a side stream (they compile the
    kernels and set up cuBLAS and cuDNN), then one step is captured as a
    `torch.cuda.CUDAGraph` and every later step is one replay of it. A
    capture or a replay that fails raises (`MatError`): no step falls back
    to eager. The graph lives in the engine's `dl_graphs`, which
    `uninstall()` and `reset(gpuDevice)` clear with the other graphs, so
    it is freed at once there: a graph left to the garbage collector could
    be destroyed inside another capture, which invalidates that
    capture."""

    WARMUP = 2
    _ids = itertools.count()
    # the kernel modules whose launches a replay of the step repeats
    _COUNTED = (lstm, optim, lstm_seq)

    def __init__(self, net: DlNetwork, loss_fn, solver: str, lr: float,
                 xshape: tuple, yshape: tuple, eng=None):
        self.flat, self.spec, self.loss_fn = net.flat, net._spec, loss_fn
        self.device = dev = net.device
        self.state = optim.State(solver, net.flat, lr)
        self.xb = torch.zeros(xshape, dtype=torch.float32, device=dev)
        self.yb = torch.zeros(yshape, dtype=torch.float32, device=dev)
        self.graphs = eng.dl_graphs if eng is not None else {}
        self.key = ("dl_train_step", next(self._ids))
        self.eager = 0          # steps run eagerly (the warm-up on a card)
        self.replays = 0
        self.side = torch.cuda.Stream(device=dev) if dev.type == "cuda" \
            else None

    @property
    def graph(self):
        """The captured step, or None."""
        return self.graphs.get(self.key)

    def body(self) -> torch.Tensor:
        leaf = self.flat.detach().requires_grad_()
        loss = self.loss_fn(_views(self.spec, leaf), self.xb, self.yb)
        (g,) = torch.autograd.grad(loss, leaf)
        optim.update(self.state, self.flat, g)
        return g

    def run(self, eng) -> None:
        if self.side is None:
            self.body()
            self.eager += 1
            return
        current = torch.cuda.current_stream(self.device)
        graph = self.graph
        if graph is None and self.eager < self.WARMUP:
            self.side.wait_stream(current)
            with torch.cuda.stream(self.side):
                self.body()
            current.wait_stream(self.side)
            self.eager += 1
            return
        if graph is None:
            graph = self._capture(eng, current)
        try:
            graph.replay()
        except RuntimeError as e:
            raise MatError("RunMat:dlGraph",
                           f"replay of the training step failed: {e}") from e
        for mod, kernels in zip(self._COUNTED, self.kernels):
            mod.replayed(kernels, 1)
        self.replays += 1
        if eng is not None:
            eng.stats["graph_replays"] += 1

    def _capture(self, eng, current):
        """One step captured on the side stream, with the garbage
        collector off: an unreachable graph it freed there would invalidate
        this capture. (`torch.cuda.graph` runs a whole collection first
        instead, at every capture.)"""
        before = [collections.Counter(m.captured) for m in self._COUNTED]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        self.side.wait_stream(current)
        try:
            with torch.cuda.stream(self.side):
                graph.capture_begin()
                try:
                    self.body()
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass        # the capture's first error is raised
                    raise MatError("RunMat:dlGraph",
                                   f"capture of the training step failed: "
                                   f"{type(e).__name__}: {e}") from e
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(self.side)
        self.graphs[self.key] = graph
        self.kernels = tuple(collections.Counter(m.captured) - b
                             for m, b in zip(self._COUNTED, before))
        if eng is not None:
            eng.stats["graph_captures"] += 1
        return graph


def _loss_fn(net: DlNetwork):
    """loss(params, xb, yb) of the JAX package's `_train`: the clip as
    minimum(maximum(out, 1e-12), 1), whose gradient splits at a tie as
    jnp.clip's does (torch.clamp's does not)."""
    fwd = net.forward_fn()
    loss_kind = net.loss_kind

    def loss_fn(params, xb, yb):
        out = fwd(params, xb)
        if loss_kind == "classification":
            lo = out.new_full((), 1e-12)
            logp = torch.log(torch.minimum(torch.maximum(out, lo),
                                           out.new_ones(())))
            return -(yb * logp).sum() / xb.shape[-1]
        return ((out - yb) ** 2).mean()

    return loss_fn


def _train(net: DlNetwork, X: np.ndarray, Y: np.ndarray, opts,
           max_steps: int | None = None) -> DlNetwork:
    """Adam/SGDM training, the JAX package's loop (no shuffle, a partial
    last minibatch skipped, Adam's bias correction by the step count t).
    The data is uploaded once; each minibatch is copied into the step's
    static buffers on the device and the step runs (`_TrainStep`: on a
    card a captured graph, replayed). Nothing is read back. `max_steps`
    stops after that many steps (for the checks that compare steps)."""
    loss_fn = _loss_fn(net)
    solver = _opt(opts, "Solver", "adam")
    lr = _opt(opts, "InitialLearnRate", 0.001)
    epochs = int(_opt(opts, "MaxEpochs", 30))
    bs = int(_opt(opts, "MiniBatchSize", 128))

    n = X.shape[-1]
    starts = [s for s in range(0, n, bs)
              if min(bs, n - s) == bs or n < bs]
    if not starts or epochs <= 0 or max_steps == 0:
        return net
    _check_features(net.layers, X.shape)
    dev = net.device
    Xd = _upload(X.astype(np.float32), dev)
    Yd = _upload(Y.astype(np.float32), dev)
    w = min(bs, n)
    key = (solver, float(lr), net.loss_kind, X.shape[:-1] + (w,),
           Y.shape[:-1] + (w,))
    eng = active_engine()
    with _precise(dev):
        step = net._train_steps.get(key)
        if step is None:
            step = net._train_steps[key] = _TrainStep(
                net, loss_fn, solver, lr, key[3], key[4], eng)
        else:
            step.state.reset()
            if eng is not None:     # the graph of an engine since released
                step.graphs = eng.dl_graphs
        done = 0
        for _ep in range(epochs):
            for s in starts:
                if max_steps is not None and done == max_steps:
                    return net
                step.xb.copy_(Xd[..., s:s + w])
                step.yb.copy_(Yd[..., s:s + w])
                step.run(eng)
                done += 1
    return net


def _labels_to_onehot(Y: np.ndarray, k: int | None = None) -> np.ndarray:
    flat = Y.reshape(-1).astype(int)
    kk = k or int(flat.max())
    out = np.zeros((kk, flat.size), dtype=np.float32)
    out[flat - 1, np.arange(flat.size)] = 1.0
    return out


@builtin("trainNetwork", category="deep_learning", min_in=3, max_in=4)
def m_train_network(X, Y, layers, opts=None):
    """trainNetwork(X, Y, layers, options): X is obs x features (feature
    input), Y is class labels (column) or response matrix."""
    net = DlNetwork(_layers_list(layers))
    return _train(net, *_train_data(net, X, Y), opts)


def _train_data(net: DlNetwork, X, Y) -> tuple:
    """trainNetwork's (hx, hy): the data in the layout of the network's
    input, the labels one-hot for classification."""
    hx = _f(X)
    if net.layers and net.layers[0]["Type"] == "imageInput":
        # image data stays (H, W, C, N); a squeezed (H, W, N) gets its
        # singleton channel back
        if hx.ndim == 3:
            hx = hx[:, :, None, :]
    else:
        hx = hx.T  # obs x features -> features x batch
    hy = _f(Y)
    if net.loss_kind == "classification":
        k = None
        for ly in reversed(net.layers):
            if ly["Type"] == "fc":
                k = int(ly["OutputSize"])
                break
        hy = _labels_to_onehot(hy, k)
    else:
        hy = hy.T
    return hx, hy


@builtin("trainnet", category="deep_learning", min_in=4, max_in=4)
def m_trainnet(X, Y, layers_or_net, lossname_opts=None, opts=None):
    """trainnet(X, T, net, lossFcn[, options]) — modern entry point."""
    net = layers_or_net if isinstance(layers_or_net, DlNetwork) \
        else DlNetwork(_layers_list(layers_or_net))
    lname = text_of(lossname_opts) if lossname_opts is not None and \
        is_text(lossname_opts) else "mse"
    net.loss_kind = "classification" if lname in ("crossentropy",) else "regression"
    hx = _f(X).T
    hy = _f(Y)
    if net.loss_kind == "classification" and (hy.ndim == 1 or 1 in hy.shape):
        hy = _labels_to_onehot(hy)
    else:
        hy = hy.T
    return _train(net, hx, hy, opts)


@builtin("padsequences", category="deep_learning", min_in=2, pass_nargout=True)
def m_padsequences(seqs, dim, *rest, nargout=1):
    if not isinstance(seqs, CellArray):
        raise bad_arg("padsequences", "First argument must be a cell of sequences.")
    d = scalar_int(dim, "dim") - 1
    items = [e.host().astype(np.float64) for e in seqs.data.reshape(-1, order="F")]
    maxlen = max(it.shape[d] for it in items)
    padded = []
    lens = []
    for it in items:
        lens.append(it.shape[d])
        pad = [(0, 0)] * it.ndim
        pad[d] = (0, maxlen - it.shape[d])
        padded.append(np.pad(it, pad))
    out = np.stack(padded, axis=-1)
    mask_arr = np.zeros((maxlen, len(items)), dtype=bool)
    for j, L in enumerate(lens):
        mask_arr[:L, j] = True
    outs = [MatArray(out, "double"), MatArray(mask_arr, "logical")]
    return outs[:max(1, nargout)]
