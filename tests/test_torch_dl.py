"""The port's deep-learning slice against the JAX package, on the CPU.

* `ops/jaxrandom.py`: keys, splits and float32 uniforms bit-equal to
  jax.random over several seeds and odd shapes; a dlnetwork's initial
  learnables of every layer kind bit-equal to the JAX package's
  `DlNetwork._init_params` (XLA on the CPU rounds the uniform's product
  and sum once, as an FMA: the port computes them exactly in float64 and
  rounds once).
* Every layer's forward against the JAX `forward_fn` with the JAX
  network's weights carried into the port (`state.to_port_value`), within
  1e-5 of the largest output (float32, sums in another order).
* The plain LSTM cell (`ops/lstm.py`) and its `autograd.Function`
  backward against a jax step and `jax.vjp` of it, within 1e-6.
* The plain optimizer update (`ops/optim.py`) against the JAX package's
  Adam and SGDM `tree_map` steps, three steps, within 1e-6 of the largest
  learnable: XLA on the CPU contracts the step's products and sums into
  FMAs, the plain version rounds each apart.
* trainNetwork for three steps (classification and regression, Adam and
  SGDM, CNN, LSTM, BiLSTM and MLP) from the same script in both packages:
  the learnables within 1e-4 of the largest.
* dlgradient against jax.grad (the JAX package's dlgradient), including
  relu, max, min and abs at exact ties and the loss clip at its ends; the
  training loss's gradient at a relu tie and a softmax output of exactly 1.
* A trained network carried from the JAX package predicts the same, and
  exportONNXNetwork writes the same bytes in both packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import runmat_tpu_torch
from runmat_tpu.runtime.builtins import dl_layers as jdl
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch import state
from runmat_tpu_torch.ops import jaxrandom, lstm, lstm_seq, optim
from runmat_tpu_torch.runtime.builtins import dl_layers as tdl
from runmat_tpu_torch.session import Session as PortSession

from torch_both import no_engine, run_both  # noqa: F401

FORWARD_TOL = 1e-5      # float32 forward, sums in another order
CELL_TOL = 1e-6         # one LSTM step and its gradient, float32
# a direction of up to 26 steps and its gradient, of the largest magnitude:
# the products' sums in another order than XLA's, compounded over the steps
SEQ_TOL = 1e-5
OPTIM_TOL = 1e-6        # three optimizer steps, of the largest learnable
TRAIN_TOL = 1e-4        # three training steps, of the largest learnable

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]
SHAPES = [(1,), (5,), (7, 3), (3, 3, 1, 8), (13, 1), (400, 12), (9, 100)]

# (id, layer cell source, input shape): every layer kind, at small widths
NETWORKS = [
    ("mlp", "{featureInputLayer(3), fullyConnectedLayer(5), reluLayer,"
            " fullyConnectedLayer(4), batchNormalizationLayer, eluLayer,"
            " dropoutLayer, fullyConnectedLayer(2), softmaxLayer}", (3, 7)),
    ("cnn", "{imageInputLayer([8 8 1]), convolution2dLayer(3, 4, 'Padding',"
            " 'same'), batchNormalizationLayer, reluLayer,"
            " maxPooling2dLayer(2, 'Stride', 2), convolution2dLayer(3, 5,"
            " 'Padding', 'same'), reluLayer, flattenLayer,"
            " fullyConnectedLayer(3), softmaxLayer}", (8, 8, 1, 6)),
    ("cnn-valid", "{imageInputLayer([9 9 2]), convolution2dLayer([4 2], 3,"
                  " 'Padding', 1, 'Stride', 2), tanhLayer,"
                  " averagePooling2dLayer(2), batchNormalizationLayer,"
                  " globalAveragePooling2dLayer, sigmoidLayer,"
                  " fullyConnectedLayer(2)}", (9, 9, 2, 4)),
    ("cnn-same-stride", "{imageInputLayer([9 7 1]), convolution2dLayer(4, 3,"
                        " 'Padding', 'same', 'Stride', 2), reluLayer}",
     (9, 7, 1, 3)),
    ("lstm", "{sequenceInputLayer(3), lstmLayer(8, 'OutputMode', 'last'),"
             " layerNormalizationLayer, fullyConnectedLayer(4),"
             " softmaxLayer}", (3, 6, 5)),
    ("lstm-seq", "{sequenceInputLayer(2), lstmLayer(4), fullyConnectedLayer(3)}",
     (2, 6, 3)),
    ("bilstm", "{sequenceInputLayer(2), bilstmLayer(3, 'OutputMode', 'last'),"
               " fullyConnectedLayer(2)}", (2, 5, 4)),
    ("conv1d", "{sequenceInputLayer(2), convolution1dLayer(3, 4), reluLayer,"
               " globalAveragePooling1dLayer, fullyConnectedLayer(1)}",
     (2, 8, 5)),
]


def _layers(session_cls, src: str) -> list:
    s = session_cls(accelerate=False)
    r = s.execute(f"layers = {src};")
    assert r.error is None, r.error
    return s.get("layers")


def _learnables(net) -> list:
    return [np.asarray(v.host()) for v in
            net._mat_get_field_("Learnables").data.reshape(-1)]


# ------------------------------------------------------------- jax.random


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_equal_jax(seed):
    k = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in np.asarray(k)) == jaxrandom.prng_key(seed)
    for n in (2, 3, 5):
        want = [tuple(int(v) for v in row)
                for row in np.asarray(jax.random.split(k, n))]
        assert jaxrandom.split(jaxrandom.prng_key(seed), n) == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_to_jax(seed, shape):
    lim = np.sqrt(6.0 / (sum(shape) + 3))
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, -lim, lim))
    got = jaxrandom.uniform(jaxrandom.prng_key(seed), shape, -lim,
                            lim).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("nid,src,xshape", NETWORKS,
                         ids=[n[0] for n in NETWORKS])
def test_initial_learnables_bit_equal(no_engine, nid, src, xshape, seed):
    jnet = jdl.DlNetwork(jdl._layers_list(_layers(JaxSession, src)), seed)
    tnet = tdl.DlNetwork(tdl._layers_list(_layers(PortSession, src)), seed)
    want, got = _learnables(jnet), _learnables(tnet)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)
    assert tnet.numel() == sum(w.size for w in want)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("nid,src,xshape", NETWORKS,
                         ids=[n[0] for n in NETWORKS])
def test_forward_matches_jax(no_engine, nid, src, xshape):
    jnet = jdl.DlNetwork(jdl._layers_list(_layers(JaxSession, src)), 5)
    # perturb the JAX network's weights, so zero biases and unit scales do
    # not hide a misplaced one, then carry them into the port
    rng = np.random.default_rng(len(nid))
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype),
        jnet.params)
    tnet = state.to_port_value(jnet)
    x = np.random.default_rng(1).normal(size=xshape)
    want = jnet.predict_np(x)
    got = tnet.predict_np(x)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= FORWARD_TOL * scale


# ---------------------------------------------------------------- LSTM cell


def _jax_cell(z, c):
    # dl_layers.py:383-390 without its product
    h = c.shape[0]
    i = jax.nn.sigmoid(z[:h])
    f2 = jax.nn.sigmoid(z[h:2 * h])
    g = jnp.tanh(z[2 * h:3 * h])
    o = jax.nn.sigmoid(z[3 * h:])
    c2 = f2 * c + i * g
    return o * jnp.tanh(c2), c2


@pytest.mark.parametrize("h,n", [(8, 5), (1, 1), (100, 27)])
def test_lstm_cell_and_backward_match_jax(h, n):
    rng = np.random.default_rng(h * n)
    z, c = (rng.normal(0, 2, (4 * h, n)).astype(np.float32),
            rng.normal(size=(h, n)).astype(np.float32))
    dh, dc = (rng.normal(size=(h, n)).astype(np.float32) for _ in range(2))
    (jh, jc), vjp = jax.vjp(_jax_cell, jnp.asarray(z), jnp.asarray(c))
    jdz, jdc = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    tz = torch.from_numpy(z).requires_grad_()
    tc = torch.from_numpy(c).requires_grad_()
    th, tc2 = lstm.cell(tz, tc)
    tdz, tdc = torch.autograd.grad((th, tc2), (tz, tc),
                                   (torch.from_numpy(dh), torch.from_numpy(dc)))
    for got, want in ((th, jh), (tc2, jc), (tdz, jdz), (tdc, jdc)):
        want = np.asarray(want)
        got = got.detach().numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= CELL_TOL * max(
            1.0, float(np.abs(want).max()))
    # only h' read (the last step of an 'last' LSTM): dc' is absent
    tz.grad = None
    th, _ = lstm.cell(tz, tc)
    (gz,) = torch.autograd.grad(th, tz, torch.from_numpy(dh))
    jgz = jax.grad(lambda zz: jnp.sum(_jax_cell(zz, jnp.asarray(c))[0] *
                                      dh))(jnp.asarray(z))
    assert float(np.abs(gz.numpy() - np.asarray(jgz)).max()) <= CELL_TOL


def test_lstm_cell_without_grad_saves_nothing():
    z = torch.randn(4 * 3, 2)
    c = torch.randn(3, 2)
    h2, c2, act = lstm.forward(z, c, save=False)
    assert act is None
    want = lstm.plain_forward(z, c)
    assert torch.equal(h2, want[0]) and torch.equal(c2, want[1])
    with torch.no_grad():
        hh, cc = lstm.cell(z.requires_grad_(), c)
    assert not hh.requires_grad and torch.equal(hh, h2)


# ------------------------------------------------------- LSTM recurrence


def _jax_dir(zx, wh, reverse):
    # dl_layers.py:376-397 with zx (T, 4H, N) in place of Wx x_t + b: the
    # scan's outputs h_t, c_t and the gate activations, in step order
    def step(carry, zt):
        h, c = carry
        z = zt + wh @ h
        hu = c.shape[0]
        i = jax.nn.sigmoid(z[:hu])
        f2 = jax.nn.sigmoid(z[hu:2 * hu])
        g = jnp.tanh(z[2 * hu:3 * hu])
        o = jax.nn.sigmoid(z[3 * hu:])
        c2 = f2 * c + i * g
        h2 = o * jnp.tanh(c2)
        return (h2, c2), (h2, c2, jnp.concatenate([i, f2, g, o]))

    h0 = jnp.zeros((wh.shape[1], zx.shape[2]), zx.dtype)
    _, out = jax.lax.scan(step, (h0, h0), zx, reverse=reverse)
    return out


def _near(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("last", [True, False], ids=["last", "sequence"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("t,h,n", [(7, 8, 5), (1, 1, 1), (26, 100, 27)])
def test_lstm_sequence_plain_matches_jax_scan(t, h, n, reverse, last,
                                              ordered):
    rng = np.random.default_rng(t * h * n + 7 * reverse + 3 * last)
    zx = rng.normal(0, 1, (t, 4 * h, n)).astype(np.float32)
    wh = rng.normal(0, 0.3, (4 * h, h)).astype(np.float32)
    dout = rng.normal(size=(h, 1 if last else t, n)).astype(np.float32)
    jzx, jwh = jnp.asarray(zx), jnp.asarray(wh)
    jh, jc, jact = _jax_dir(jzx, jwh, reverse)

    # the port walks a reverse direction over the flipped sequence, as
    # lstm_dir does; a 'last' direction returns the scan's final h
    def port_order(a):             # (T, ...) in the port's step order
        return a[::-1] if reverse else a

    tzx = torch.from_numpy(port_order(zx).transpose(1, 0, 2).copy())
    twh = torch.from_numpy(wh)
    out, saved = lstm_seq.plain_seq_forward(tzx, twh, ordered, True, last)
    hbuf, cs, act = saved
    _near(hbuf[:, 1:].permute(1, 0, 2), port_order(np.asarray(jh)), SEQ_TOL)
    _near(cs, port_order(np.asarray(jc)), SEQ_TOL)
    _near(act, port_order(np.asarray(jact)), SEQ_TOL)
    assert torch.equal(hbuf[:, 0], torch.zeros(h, n))
    want_out = np.asarray(jh)[0 if reverse else -1][:, None, :] if last \
        else port_order(np.asarray(jh)).transpose(1, 0, 2)
    _near(out, want_out, SEQ_TOL)
    nolast = lstm_seq.plain_seq_forward(tzx, twh, ordered, False, last)
    assert nolast[1] is None and torch.equal(nolast[0], out)

    def jout(a, w):
        hs = _jax_dir(a, w, reverse)[0]
        return hs[0 if reverse else -1][:, None, :] if last \
            else jnp.moveaxis(hs, 0, 1)

    jdout = dout if last or not reverse else dout[:, ::-1]
    _, vjp = jax.vjp(jout, jzx, jwh)
    jdzx, jdwh = vjp(jnp.asarray(jdout.copy()))
    dz, dwh = lstm_seq.plain_seq_backward(twh, saved, torch.from_numpy(dout),
                                          last, ordered)
    _near(dz.permute(1, 0, 2), port_order(np.asarray(jdzx)), SEQ_TOL)
    _near(dwh, jdwh, SEQ_TOL)


def test_lstm_sequence_function_gradients_equal_plain():
    # LSTMSeq's backward is plain_seq_backward on the CPU
    rng = np.random.default_rng(3)
    zx = torch.from_numpy(rng.normal(size=(4 * 5, 6, 3)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(0, 0.3, (4 * 5, 5)).astype(np.float32))
    for last in (True, False):
        a, w = zx.clone().requires_grad_(), wh.clone().requires_grad_()
        out = lstm_seq.sequence(a, w, last)
        dout = torch.ones_like(out)
        ga, gw = torch.autograd.grad(out, (a, w), dout)
        want_out, saved = lstm_seq.plain_seq_forward(zx, wh, last=last)
        dz, dwh = lstm_seq.plain_seq_backward(wh, saved, dout, last)
        assert torch.equal(out, want_out)
        assert torch.equal(ga, dz) and torch.equal(gw, dwh)
    with torch.no_grad():
        assert not lstm_seq.sequence(zx.requires_grad_(), wh, False).requires_grad


# (H, N) -> whether the sequence kernels take it: dl_vowels' layer, its
# predict (all 270 sequences: the columns shared by clusters), the odd
# shapes of the tests, H not a multiple of a cluster, a wide batch; an H
# whose slices for one column no cluster's shared memory holds keeps the
# per-step path
@pytest.mark.parametrize("h,n,fits", [
    (100, 27, True), (100, 270, True), (8, 5, True), (1, 1, True),
    (37, 9, True), (200, 27, True), (100, 1081, True), (300, 64, True),
    (512, 27, False), (450, 1, False), (1024, 3, False)])
def test_lstm_route_by_shape(h, n, fits):
    c, g = lstm_seq.layout(h, n)
    assert bool(c) == fits and bool(g) == fits
    if fits:
        assert c == lstm_seq.CLUSTER
        share = -(-n // g)
        assert max(lstm_seq.smem_bytes(h, share, c)) <= lstm_seq.SMEM_LIMIT
        # the fewest clusters: one fewer would not fit
        assert g == 1 or max(lstm_seq.smem_bytes(
            h, -(-n // (g - 1)), c)) > lstm_seq.SMEM_LIMIT
    else:
        assert all(max(lstm_seq.smem_bytes(h, 1, s)) > lstm_seq.SMEM_LIMIT
                   for s in lstm_seq.CLUSTER_SIZES)
    assert (lstm_seq.layout(100, 27), lstm_seq.layout(100, 270)) == \
        ((16, 1), (16, 3))


@pytest.mark.parametrize("wide", [False, True], ids=["cluster", "per-step"])
def test_lstm_layer_follows_the_route(no_engine, monkeypatch, wide):
    # a shape the route refuses runs a product and the cell a step; both
    # paths give the JAX package's forward
    src = "{sequenceInputLayer(3), bilstmLayer(6), fullyConnectedLayer(2)}"
    if wide:
        monkeypatch.setattr(lstm_seq, "SMEM_LIMIT", 0)
    calls = {"cell": 0, "sequence": 0}
    for mod, name in ((lstm, "cell"), (lstm_seq, "sequence")):
        def counted(*a, _f=getattr(mod, name), _k=name):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(mod, name, counted)
    jnet = jdl.DlNetwork(jdl._layers_list(_layers(JaxSession, src)), 2)
    tnet = state.to_port_value(jnet)
    x = np.random.default_rng(4).normal(size=(3, 5, 4))
    want = jnet.predict_np(x)
    got = tnet.predict_np(x)
    assert float(np.abs(got - want).max()) <= \
        FORWARD_TOL * float(np.abs(want).max())
    assert calls == ({"cell": 2 * 5, "sequence": 0} if wide
                     else {"cell": 0, "sequence": 2})


# ROADMAP Queue C 1: a deep-learning input of the wrong feature size
WRONG_FEATURES = [
    ("fc-dlarray",
     "net = dlnetwork({featureInputLayer(3), fullyConnectedLayer(2)});",
     "y = predict(net, dlarray(randn(4, 2)));"),
    ("trained-obs-by-features",
     "rng(1); X = randn(5, 3); Y = randi(2, 5, 1); net = trainNetwork(X, Y,"
     " {featureInputLayer(3), fullyConnectedLayer(2), softmaxLayer,"
     " classificationLayer}, trainingOptions('adam', 'MaxEpochs', 1,"
     " 'MiniBatchSize', 5));",
     "y = predict(net, X);"),
    ("train-wrong-x",
     "rng(1); X = randn(6, 4); Y = randi(2, 6, 1);",
     "net = trainNetwork(X, Y, {featureInputLayer(3), fullyConnectedLayer(2),"
     " softmaxLayer, classificationLayer}, trainingOptions('adam',"
     " 'MaxEpochs', 1, 'MiniBatchSize', 3));"),
    ("lstm-sequence",
     "net = dlnetwork({sequenceInputLayer(3), lstmLayer(4),"
     " fullyConnectedLayer(2)});",
     "y = predict(net, randn(2, 5, 3));"),
]


@pytest.mark.parametrize("cid,setup,call", WRONG_FEATURES,
                         ids=[c[0] for c in WRONG_FEATURES])
def test_wrong_feature_size_same_identifier(cid, setup, call):
    b = run_both(setup, f"try; {call} id = 'none'; catch e; id ="
                        f" e.identifier; end")
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    assert b.js.get("id").to_str() == b.ts.get("id").to_str() == \
        "MATLAB:invalidType"


# a normalization's (width, 1) scale meets X by broadcasting in both
# packages: a width of 1 on either side runs (X takes the broadcast shape,
# and a later product may then refuse it); two widths that do not broadcast
# fail as jax does: in lax's mul where X has two dimensions, in jnp's
# broadcasting rule where it has three
NORM_WIDTHS = [
    ("layernorm-x1", "featureInputLayer(3), layerNormalizationLayer,"
     " fullyConnectedLayer(2)", "randn(1, 4)", "none"),
    ("batchnorm-x1", "featureInputLayer(3), batchNormalizationLayer,"
     " fullyConnectedLayer(2)", "randn(1, 4)", "none"),
    ("layernorm-net1", "featureInputLayer(1), layerNormalizationLayer,"
     " reluLayer, fullyConnectedLayer(2)", "randn(3, 4)",
     "MATLAB:invalidType"),
    ("batchnorm-x4", "featureInputLayer(3), batchNormalizationLayer,"
     " fullyConnectedLayer(2)", "randn(4, 4)", "MATLAB:invalidType"),
    ("layernorm-seq", "sequenceInputLayer(3), layerNormalizationLayer,"
     " lstmLayer(4), fullyConnectedLayer(2)", "randn(3, 5, 2)",
     "MATLAB:sizeDimensionsMustMatch"),
]


@pytest.mark.parametrize("cid,layers,x,want", NORM_WIDTHS,
                         ids=[c[0] for c in NORM_WIDTHS])
def test_norm_layer_widths_same_identifier(cid, layers, x, want):
    b = run_both(f"rng(2); net = dlnetwork({{{layers}}}); X = {x};",
                 "try; y = predict(net, X); id = 'none'; sz = size(y);"
                 " catch e; id = e.identifier; sz = [0 0]; end")
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    assert b.js.get("id").to_str() == b.ts.get("id").to_str() == want
    assert np.array_equal(np.asarray(b.js.get("sz").host()),
                          np.asarray(b.ts.get("sz").host()))


# -------------------------------------------------------------- optimizer


def _jax_steps(solver, p, grads, lr, t0=0):
    # the tree_map lambdas of dl_layers.py:629-643, one leaf, from step
    # count t0
    def adam(p, m, v, t, g):
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        return p - lr * mh / (jnp.sqrt(vh) + eps), m, v

    def sgdm(p, vel, _v, t, g):
        vel = 0.9 * vel + g
        return p - lr * vel, vel, _v

    step = jax.jit(adam if solver == "adam" else sgdm)
    p = jnp.asarray(p)
    m = v = jnp.zeros_like(p)
    for t, g in enumerate(grads, t0 + 1):
        p, m, v = step(p, m, v, t, jnp.asarray(g))
    return [np.asarray(a) for a in ((p, m, v) if solver == "adam"
                                    else (p, m))]


# 1 and 3 fill a few of a block's 512 threads; 21690 (dl_digits'
# learnables) and 46109 (dl_vowels') end in a part block
@pytest.mark.parametrize("n", [1, 3, 1000, 21690, 46109])
@pytest.mark.parametrize("solver", ["adam", "sgdm"])
def test_optim_update_matches_jax(solver, n):
    rng = np.random.default_rng(n)
    p0 = rng.normal(0, 0.1, n).astype(np.float32)
    grads = [rng.normal(0, 10.0 ** -k, n).astype(np.float32)
             for k in range(3)]
    lr = 0.01 if solver == "sgdm" else 0.001
    want = _jax_steps(solver, p0, grads, lr)
    p = torch.from_numpy(p0.copy())
    st = optim.State(solver, p, lr)
    for g in grads:
        optim.update(st, p, torch.from_numpy(g))
    got = [p, st.m] + ([st.v] if solver == "adam" else [])
    for gv, wv in zip(got, want):
        scale = max(float(np.abs(wv).max()), 1e-30)
        assert float(np.abs(gv.numpy() - wv).max()) <= OPTIM_TOL * scale
    assert float(st.t) == 3.0


@pytest.mark.parametrize("solver", ["adam", "sgdm"])
def test_optim_update_matches_jax_at_late_t(solver):
    # from t = 497: the bias corrections at dl_vowels' last steps
    from runmat_tpu_torch import dlbench
    n, t0 = 1000, dlbench.LATE_T
    rng = np.random.default_rng(t0)
    p0 = rng.normal(0, 0.1, n).astype(np.float32)
    grads = [rng.normal(0, 10.0 ** -k, n).astype(np.float32)
             for k in range(3)]
    want = _jax_steps(solver, p0, grads, 0.001, t0)
    p = torch.from_numpy(p0.copy())
    st = optim.State(solver, p, 0.001)
    st.t.fill_(t0)
    for g in grads:
        optim.update(st, p, torch.from_numpy(g))
    got = [p, st.m] + ([st.v] if solver == "adam" else [])
    for gv, wv in zip(got, want):
        scale = max(float(np.abs(wv).max()), 1e-30)
        assert float(np.abs(gv.numpy() - wv).max()) <= OPTIM_TOL * scale
    assert float(st.t) == t0 + 3


@pytest.mark.parametrize("solver", ["adam", "sgdm"])
def test_optim_update_advances_t_once_a_call(solver):
    p = torch.ones(5)
    st = optim.State(solver, p, 0.1)
    for k in range(1, 4):
        optim.update(st, p, torch.full((5,), 0.5))
        assert float(st.t) == k
    st.reset()
    assert float(st.t) == 0 and not st.m.any()
    # after a reset the first step's bias correction is t = 1's again
    q = torch.ones(5)
    fresh = optim.State(solver, q, 0.1)
    optim.update(fresh, q, torch.full((5,), 0.5))
    p.fill_(1.0)
    optim.update(st, p, torch.full((5,), 0.5))
    assert torch.equal(p, q) and float(st.t) == 1


def test_optim_state_reset_and_refusals():
    p = torch.ones(4)
    st = optim.State("adam", p, 0.1)
    optim.update(st, p, torch.ones(4))
    st.reset()
    assert float(st.t) == 0 and not st.m.any() and not st.v.any()
    from runmat_tpu_torch.errors import MatError
    with pytest.raises(MatError):
        optim.State("rmsprop", p, 0.1)
    with pytest.raises(MatError):
        optim.update(st, p, torch.ones(5))


# ------------------------------------------------------- three train steps


# (id, data and layers, options): N = 3 minibatches, one epoch
TRAININGS = [
    ("cnn-sgdm-class",
     "rng(3); X = rand(8, 8, 1, 12); Y = randi(3, 12, 1);"
     " layers = {imageInputLayer([8 8 1]), convolution2dLayer(3, 4, 'Padding',"
     " 'same'), batchNormalizationLayer, reluLayer, maxPooling2dLayer(2,"
     " 'Stride', 2), flattenLayer, fullyConnectedLayer(3), softmaxLayer,"
     " classificationLayer};",
     "trainingOptions('sgdm', 'MaxEpochs', 1, 'MiniBatchSize', 4)"),
    ("cnn-adam-regr",
     "rng(4); X = rand(6, 6, 2, 15); Y = randn(15, 2);"
     " layers = {imageInputLayer([6 6 2]), convolution2dLayer(3, 3), eluLayer,"
     " globalAveragePooling2dLayer, fullyConnectedLayer(2), regressionLayer};",
     "trainingOptions('adam', 'MaxEpochs', 1, 'MiniBatchSize', 5,"
     " 'InitialLearnRate', 0.01)"),
    ("lstm-adam-class",
     "rng(5); X = randn(15, 6, 3); Y = randi(4, 15, 1);"
     " layers = {sequenceInputLayer(3), lstmLayer(8, 'OutputMode', 'last'),"
     " fullyConnectedLayer(4), softmaxLayer, classificationLayer};",
     "trainingOptions('adam', 'MaxEpochs', 1, 'MiniBatchSize', 5)"),
    ("lstm-sgdm-regr",
     "rng(6); X = randn(12, 6, 2); Y = randn(12, 3);"
     " layers = {sequenceInputLayer(2), lstmLayer(8, 'OutputMode', 'last'),"
     " fullyConnectedLayer(3), regressionLayer};",
     "trainingOptions('sgdm', 'MaxEpochs', 1, 'MiniBatchSize', 4)"),
    ("bilstm-adam-class",
     "rng(7); X = randn(9, 5, 2); Y = randi(2, 9, 1);"
     " layers = {sequenceInputLayer(2), bilstmLayer(4, 'OutputMode', 'last'),"
     " fullyConnectedLayer(2), softmaxLayer, classificationLayer};",
     "trainingOptions('adam', 'MaxEpochs', 1, 'MiniBatchSize', 3)"),
    ("mlp-sgdm-class-partial",
     "rng(8); X = randn(14, 3); Y = randi(2, 14, 1);"
     " layers = {featureInputLayer(3), fullyConnectedLayer(6), reluLayer,"
     " fullyConnectedLayer(2), softmaxLayer, classificationLayer};",
     "trainingOptions('sgdm', 'MaxEpochs', 1, 'MiniBatchSize', 4)"),
]


@pytest.mark.parametrize("tid,setup,opts", TRAININGS,
                         ids=[t[0] for t in TRAININGS])
def test_three_training_steps_match_jax(tid, setup, opts):
    b = run_both(setup, f"opts = {opts}; net = trainNetwork(X, Y, layers,"
                        f" opts); L = net.Learnables;")
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    want = [np.asarray(v.host()) for v in b.js.get("L").data.reshape(-1)]
    got = [np.asarray(v.host()) for v in b.ts.get("L").data.reshape(-1)]
    init = _learnables(jdl.DlNetwork(b.js.get("net").layers))
    scale = max(float(np.abs(w).max()) for w in want)
    moved = 0.0
    for g, w, w0 in zip(got, want, init):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        assert float(np.abs(g - w).max()) <= TRAIN_TOL * scale
        moved = max(moved, float(np.abs(w - w0).max()))
    assert moved > 10 * TRAIN_TOL * scale      # the steps did move them


# ------------------------------------------------------------- dlgradient


GRADIENTS = [
    ("square", "loss = sum(x .^ 2, 'all');", "[1 2 3]"),
    ("relu-ties", "loss = sum(relu(x), 'all') + sum(max(x, 1), 'all');",
     "[0 -1 2 0 1]"),
    ("min-abs-ties", "loss = sum(min(x, 0) .* 3, 'all') + sum(abs(x), 'all');",
     "[0 -1 2 0 1]"),
    ("losses", "loss = mse(sigmoid(x), 0.5 * ones(size(x))) + "
               "huber(x, zeros(size(x)), 1) + l1loss(x, ones(size(x)));",
     "[0 -1 2 0 1 3]"),
    ("clip-tie", "loss = crossentropy(softmax(x), [1; 0; 0]) + "
                 "crossentropy(x .* 1e-12, [1; 1; 1]);", "[1; 0; 2]"),
    ("chain", "loss = sum(sin(x) .* exp(x), 'all');", "[0.5 1.0]"),
    # indexed writes run `index_copy_` on a clone, reads `index_select`
    ("indexed", "y = x .* 2; y(2) = x(3); y(:, 1) = x(:, 2) .* 3;"
                " z = x(2:3) + 1; loss = sum(y .^ 2, 'all') + sum(z .* z,"
                " 'all');", "[1 2 3; 4 5 6]"),
    ("single-softmax-ce", "y = softmax(single([0.1 0.2; 0.3 0.4]) * x);"
                          " loss = crossentropy(y, single([1; 0]));",
     "single([1; 2])"),
]


@pytest.mark.parametrize("gid,body,x0", GRADIENTS,
                         ids=[g[0] for g in GRADIENTS])
def test_dlgradient_matches_jax_grad(gid, body, x0):
    src = f"""
function [loss, g] = f(x)
{body}
g = dlgradient(loss, x);
end
[l, g] = dlfeval(@f, dlarray({x0}));
gv = extractdata(g); lv = extractdata(l);
"""
    b = run_both("", src)
    assert b.jr.error is None and b.tr.error is None, (b.jr.error,
                                                       b.tr.error)
    for name in ("gv", "lv"):
        w, g = np.asarray(b.js.get(name).host()), \
            np.asarray(b.ts.get(name).host())
        assert g.shape == w.shape and g.dtype == w.dtype
        tol = 1e-6 if w.dtype == np.float32 else 1e-12
        assert np.allclose(g, w, rtol=tol, atol=tol), (name, g, w)
    assert b.td["compiles"] >= 1


def test_dlgradient_of_two_targets_and_its_cache():
    src = """
function [loss, gw, gb] = f(w, b, x)
y = fullyconnect(x, w, b);
loss = sum(y .^ 2, 'all');
[gw, gb] = dlgradient(loss, w, b);
end
for k = 1:2
[l, gw, gb] = dlfeval(@f, dlarray([1 2; 3 4]), dlarray([0.5; -0.5]), dlarray([1; 2]));
end
gwv = extractdata(gw); gbv = extractdata(gb);
"""
    b = run_both("", src)
    for name in ("gwv", "gbv"):
        assert np.array_equal(b.ts.get(name).host(), b.js.get(name).host())
    assert np.array_equal(b.ts.get("gwv").host(), [[11.0, 22.0], [21.0, 42.0]])
    # the second dlgradient of the same program is a cache hit, as in jax
    assert b.td["cache_hits"] >= 1 and b.jd["cache_hits"] >= 1


def _jax_loss_grad(jnet, x, y):
    fwd = jnet.forward_fn()

    def loss_fn(params):
        out = fwd(params, x)
        logp = jnp.log(jnp.clip(out, 1e-12, 1.0))
        return -(y * logp).sum() / x.shape[-1]

    g = jax.grad(loss_fn)(jnet.params)
    return np.concatenate([np.asarray(a).reshape(-1) for a in
                           jax.tree_util.tree_leaves(g)])


def _port_loss_grad(tnet, x, y):
    leaf = tnet.flat.detach().requires_grad_()
    loss = tdl._loss_fn(tnet)(tnet.views(leaf), torch.from_numpy(x),
                              torch.from_numpy(y))
    return torch.autograd.grad(loss, leaf)[0].numpy()


@pytest.mark.parametrize("case", ["relu-tie", "softmax-one"])
def test_training_loss_gradient_at_ties(no_engine, case):
    if case == "relu-tie":
        # zero inputs and zero biases: every relu input is exactly 0
        src = ("{featureInputLayer(2), fullyConnectedLayer(3), reluLayer,"
               " fullyConnectedLayer(2), softmaxLayer, classificationLayer}")
        x = np.array([[0.0, 1.0, 0.0], [0.0, -2.0, 0.0]], np.float32)
    else:
        # logits far apart: a softmax output of exactly 1 meets the clip
        src = ("{featureInputLayer(2), fullyConnectedLayer(2), softmaxLayer,"
               " classificationLayer}")
        x = np.array([[400.0, -300.0], [0.0, 500.0]], np.float32)
    jnet = jdl.DlNetwork(jdl._layers_list(_layers(JaxSession, src)), 2)
    tnet = state.to_port_value(jnet)
    y = np.zeros((2, x.shape[1]), np.float32)
    y[0] = 1.0
    out = jnet.predict_np(x)
    if case == "softmax-one":
        assert (out == 1.0).any()
    want = _jax_loss_grad(jnet, jnp.asarray(x), jnp.asarray(y))
    got = _port_loss_grad(tnet, x, y)
    assert np.allclose(got, want, rtol=1e-6, atol=1e-7), (got, want)


# ---------------------------------------------------- carried, ONNX bytes


def test_carried_network_predicts_the_same(no_engine):
    src = ("rng(2); X = randn(20, 3); Y = randi(2, 20, 1);"
           " layers = {featureInputLayer(3), fullyConnectedLayer(4), tanhLayer,"
           " fullyConnectedLayer(2), softmaxLayer, classificationLayer};"
           " net = trainNetwork(X, Y, layers, trainingOptions('adam',"
           " 'MaxEpochs', 5, 'MiniBatchSize', 5));")
    js = JaxSession(accelerate=False)
    assert js.execute(src).error is None
    ts = PortSession(accelerate=False)
    state.carry_session(js, ts)
    r = ts.execute("p = predict(net, X'); L = net.Learnables;")
    assert r.error is None, r.error
    js.execute("p = predict(net, X'); L = net.Learnables;")
    assert type(ts.get("net")).__module__.startswith("runmat_tpu_torch")
    assert np.allclose(ts.get("p").host(), js.get("p").host(), atol=1e-6)
    for g, w in zip(ts.get("L").data.reshape(-1), js.get("L").data.reshape(-1)):
        assert np.array_equal(g.host(), w.host())
    assert ts.get("net").loss_kind == "classification"


def test_onnx_export_same_bytes_and_reads_back(no_engine, tmp_path):
    src = ("rng(0); l1 = struct('type', 'fc', 'W', randn(4, 3), 'b', randn(4, 1));"
           " l3 = struct('type', 'fc', 'W', randn(2, 4), 'b', randn(2, 1));"
           " model = struct('Layers', {{l1, struct('type', 'relu'), l3,"
           " struct('type', 'softmax')}}); X = randn(3, 5);"
           " y1 = predict(model, X); exportONNXNetwork(model, '%s');"
           " m2 = importONNXNetwork('%s'); y2 = predict(m2, X);")
    runs = {}
    for name, cls in (("jax", JaxSession), ("port", PortSession)):
        path = str(tmp_path / f"{name}.onnx")
        s = cls(accelerate=False)
        r = s.execute(src % (path, path))
        assert r.error is None, r.error
        runs[name] = (open(path, "rb").read(), s)
    assert runs["port"][0] == runs["jax"][0]
    s = runs["port"][1]
    assert np.allclose(s.get("y2").host(), s.get("y1").host(), atol=1e-6)
    assert np.array_equal(s.get("y2").host(), runs["jax"][1].get("y2").host())


def test_a_card_session_network_lives_on_its_engine_device():
    s = runmat_tpu_torch.session("cpu")
    try:
        r = s.execute("net = dlnetwork({featureInputLayer(2),"
                      " fullyConnectedLayer(3)}); y = predict(net, [1; 2]);"
                      " info = analyzeNetwork(net);")
        assert r.error is None, r.error
        net = s.get("net")
        assert net.flat.device.type == "cpu" and net.flat.dtype == torch.float32
        # every learnable is a view of the one flat leaf
        for p in net.params[1]:
            assert p.untyped_storage().data_ptr() == \
                net.flat.untyped_storage().data_ptr()
        assert float(s.get("info").get_scalar_field(
            "TotalLearnables").host()[0, 0]) == 9.0
    finally:
        runmat_tpu_torch.uninstall()
