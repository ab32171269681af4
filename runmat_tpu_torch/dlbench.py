"""Deep learning on the card: the LSTM recurrence, the LSTM cell and the
optimizer update against their plain versions and timed, and the training
of dl_digits.m and dl_vowels.m checked and timed.

    python3 runmat_tpu_torch/dlbench.py

`held_seq` holds the cluster kernels of `ops/lstm_seq.py` (a direction's
forward with and without what the backward needs, 'last' and 'sequence',
both directions of a BiLSTM, and its backward) to `plain_seq_forward`/
`plain_seq_backward(ordered=True)` bit for bit at SEQ_SHAPES, at each
cluster size given; `seq_sweep` times both kernels at dl_vowels' layer for
every cluster size; `seq_rows` times them at the route's cluster beside
their bound (bytes or operations, whichever is larger), their plain
versions, the earlier design (a `torch.addmm` and a cell kernel a step,
forward, and autograd's backward through it), cuDNN's LSTM
(`torch.nn.LSTM`, which also does the input product) and the same kernel
at T = 1, whose difference over T - 1 steps is the cost of a step. The
earlier design runs as the replay of a captured graph, as it ran inside
the training step's graph. `held_cell` and `held_optim` hold the Triton
kernels of `ops/lstm.py` (forward and backward, each variant) and the CUDA
C++ update of `ops/optim.py` (`csrc/optim.cu`; Adam and SGDM, three steps
from t = 0 and from t = LATE_T, t counted) to their plain versions on the
card, bit for bit where they are
equal and with the largest difference either way; `kernel_rows` times each
at the paths' shapes (CUDA events, the card spinning first:
`histbench.time_ms`) beside its plain version, its bound (the bytes it must
move over 3.35 TB/s: no kernel here does enough arithmetic a byte to be
bound by operations) and the PyTorch call that computes the same function
(`torch.ops.aten._thnn_fused_lstm_cell` and its backward, whose inputs are
(N, 4H) gate sums; `torch._fused_adam_`, `torch._fused_sgd_`), a yardstick
the port never calls. `first_steps` trains a workload's network three
steps on the card and on the CPU from the same initial weights (the CPU
through the plain versions); `repeat` trains it twice on the card;
`step_times` times one training step eagerly and as a replay of its
captured graph, with cuDNN's deterministic algorithms and without, and
counts the device kernels of a replayed step with `torch.profiler`;
`dlfeval_snippet` runs a dlfeval/dlgradient snippet in a card session and
a CPU one; `optim_code` reads the update's loads and FMAs from its
machine code. `chip_smoke.py`'s tenth phase calls all of these.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

WORKLOADS = {"dl_digits": "runmat_tpu_torch/workloads/dl_digits.m",
             "dl_vowels": "runmat_tpu_torch/workloads/dl_vowels.m"}
# each script's learnables and training steps at its default size: 58
# full minibatches of 128 an epoch over 4 epochs; 10 of 27 over 50
LEARNABLES = {"dl_digits": 21690, "dl_vowels": 46109}
STEPS = {"dl_digits": 4 * 58, "dl_vowels": 50 * 10}
H, N, T = 100, 27, 26          # dl_vowels' LSTM: hidden units, batch, steps
F = 12                         # dl_vowels' features
BYTES_PER_S = 3.35e12
FLOPS_F32 = 67e12              # the H100's float32 rate outside tensor cores
# (T, H, N) the sequence kernels are held at: dl_vowels' layer, the CPU
# tests' odd shapes, an H no cluster size divides, a batch of one, and
# dl_vowels' predict (all 270 sequences: the columns shared by clusters)
SEQ_SHAPES = ((T, H, N), (7, 8, 5), (1, 1, 1), (5, 37, 9), (3, H, 1),
              (T, H, 270))
# operations of the cell a (unit, column) a step, besides the products:
# forward 3 sigmoids of 4, 2 tanh, 3 multiplies and an add; backward a
# tanh, 19 multiplies and subtractions, 2 adds and the dc product
CELL_OPS = {"lstm_seq_fwd": 18, "lstm_seq_bwd": 24}
# the first three steps on the card against the CPU's, of the largest
# learnable, by solver: cuDNN and cuBLAS sum in other orders than the CPU.
# An Adam step moves an element by up to its rate whatever the size of its
# gradient (m/(sqrt(v) + eps) is near +-1), so an element whose gradient's
# terms cancel to near eps moves by an amount rounding sets: after three
# steps of dl_vowels the JAX package and the port differ by 9.1e-5 of the
# largest learnable on the same CPU, and the card and the CPU by 9.8e-5
STEP_TOL = {"sgdm": 1e-4, "adam": 1e-3}
# the lines of the JAX package each kernel replaces (no Pallas twin: XLA
# compiled them from jax code)
REPLACES = {
    "lstm_seq_fwd": "runmat_tpu/runtime/builtins/dl_layers.py:376-397",
    "lstm_seq_bwd": "runmat_tpu/runtime/builtins/dl_layers.py:376-397",
    "lstm_fwd": "runmat_tpu/runtime/builtins/dl_layers.py:380-391",
    "lstm_bwd": "runmat_tpu/runtime/builtins/dl_layers.py:380-391",
    "optim_adam": "runmat_tpu/runtime/builtins/dl_layers.py:629-638",
    "optim_sgdm": "runmat_tpu/runtime/builtins/dl_layers.py:640-644"}
# the update's bytes besides its elements': t read and written, 8 each
FOLD_BYTES = 16
# a step count near dl_vowels' last (500 Adam steps), from which the held
# update also runs: the bias corrections' pows at large t
LATE_T = 497
# the kernel rows' main-path shapes: the cell at dl_vowels' (4H, N); the
# update at the learnables of the script that runs it
ROW_SIZES = {"optim_adam": LEARNABLES["dl_vowels"],
             "optim_sgdm": LEARNABLES["dl_digits"]}
SNIPPET = """
function [loss, gw, gb] = f(w, b, x, y)
h = relu(fullyconnect(x, w, b));
loss = mse(h, y);
[gw, gb] = dlgradient(loss, w, b);
end
rng(7); W = randn(16, 8); B = [zeros(8, 1); randn(8, 1)]; X = randn(8, 32);
X(:, 1) = 0; Y = randn(16, 32);
[l, gw, gb] = dlfeval(@f, dlarray(W), dlarray(B), dlarray(X), dlarray(Y));
lv = extractdata(l); gwv = extractdata(gw); gbv = extractdata(gb);
"""


def _gen(dev, seed: int):
    import torch
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(shape, dev, gen):
    import torch
    return torch.randn(shape, dtype=torch.float32, device=dev, generator=gen)


def cell_inputs(dev, h: int = H, n: int = N, seed: int = 0) -> dict:
    """z (4h, n), c, dh' and dc' (h, n), float32 on `dev`."""
    gen = _gen(dev, seed)
    return {"z": 2 * _randn((4 * h, n), dev, gen),
            "c": _randn((h, n), dev, gen),
            "dh": _randn((h, n), dev, gen),
            "dc2": _randn((h, n), dev, gen)}


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def held_cell(lstm, dev) -> dict:
    """Each kernel variant against the plain version, at the path's (4H,
    N) and two odd shapes: {kernel: {"equal", "max_abs_err"}}."""
    import torch
    out = {"lstm_fwd": {"equal": True, "max_abs_err": 0.0},
           "lstm_bwd": {"equal": True, "max_abs_err": 0.0}}

    def note(name, got, want):
        out[name]["equal"] &= bool(torch.equal(got, want))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       _err(got, want))

    for h, n in ((H, N), (7, 3), (H, 1081)):
        x = cell_inputs(dev, h, n, seed=h + n)
        for save in (True, False):
            got = lstm.forward(x["z"], x["c"], save)
            want = lstm.plain_forward(x["z"], x["c"], save)
            for g, w in zip(got, want):
                if w is not None:
                    note("lstm_fwd", g, w)
        h2, c2, act = lstm.plain_forward(x["z"], x["c"])
        for dh, dc2 in ((x["dh"], x["dc2"]), (x["dh"], None),
                        (None, x["dc2"])):
            got = lstm.backward(act, x["c"], c2, dh, dc2)
            want = lstm.plain_backward(act, x["c"], c2, dh, dc2)
            for g, w in zip(got, want):
                note("lstm_bwd", g, w)
    torch.cuda.synchronize()
    return out


def seq_inputs(dev, t: int = T, h: int = H, n: int = N,
               seed: int = 0) -> dict:
    """zx (4h, t, n), Wh (4h, h) and the gradients of the outputs, dhs
    (h, t, n) and dhlast (h, 1, n), float32 on `dev`."""
    gen = _gen(dev, seed)
    return {"zx": _randn((4 * h, t, n), dev, gen),
            "wh": 0.1 * _randn((4 * h, h), dev, gen),
            "dhs": _randn((h, t, n), dev, gen),
            "dhlast": _randn((h, 1, n), dev, gen)}


def held_seq(lstm_seq, dev, clusters) -> dict:
    """The sequence kernels at each cluster size of `clusters` against the
    ordered plain versions at SEQ_SHAPES, forward and reverse (the flipped
    sequence, as lstm_dir runs a BiLSTM's second direction), 'last' and
    'sequence', the forward with and without `save`, the backward from the
    plain forward's saved tensors: {kernel: {"equal", "max_abs_err"}}."""
    import torch
    out = {"lstm_seq_fwd": {"equal": True, "max_abs_err": 0.0},
           "lstm_seq_bwd": {"equal": True, "max_abs_err": 0.0}}

    def note(name, got, want):
        out[name]["equal"] &= bool(torch.equal(got, want))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       _err(got, want))

    for t, h, n in SEQ_SHAPES:
        x = seq_inputs(dev, t, h, n, seed=t + h + n)
        wh = x["wh"]
        for reverse in (False, True):
            zx = torch.flip(x["zx"], (1,)) if reverse else x["zx"]
            for last in (True, False):
                dout = x["dhlast"] if last else x["dhs"]
                want, saved = lstm_seq.plain_seq_forward(zx, wh, True, True,
                                                         last)
                dz, dwh = lstm_seq.plain_seq_backward(wh, saved, dout, last,
                                                      True)
                for c in clusters:
                    got, got_saved = lstm_seq.forward(zx, wh, True, last, c)
                    note("lstm_seq_fwd", got, want)
                    for g, w in zip(got_saved, saved):
                        note("lstm_seq_fwd", g, w)
                    note("lstm_seq_fwd",
                         lstm_seq.forward(zx, wh, False, last, c)[0], want)
                    for g, w in zip(lstm_seq.backward(wh, saved, dout, last,
                                                      c), (dz, dwh)):
                        note("lstm_seq_bwd", g, w)
    torch.cuda.synchronize()
    return out


def _seq_calls(lstm_seq, x: dict, cluster=None) -> dict:
    """The two kernels on dl_vowels' layer ('last', saving for the
    backward), as the training step launches them."""
    fwd = (lambda: lstm_seq.forward(x["zx"], x["wh"], True, True, cluster))
    _, (hbuf, cs, act) = fwd()
    bwd = (lambda: lstm_seq.backward_dz(x["wh"], cs, act, x["dhlast"], True,
                                        cluster))
    return {"lstm_seq_fwd": fwd, "lstm_seq_bwd": bwd}


def seq_sweep(lstm_seq, time_ms, reps: int, dev) -> dict:
    """{cluster size: {kernel: ms} or {"error": why}} at dl_vowels'
    layer, for every size of lstm_seq.CLUSTER_SIZES."""
    from runmat_tpu_torch.errors import MatError
    out = {}
    x = seq_inputs(dev)
    for c in lstm_seq.CLUSTER_SIZES:
        try:
            calls = _seq_calls(lstm_seq, x, c)
            out[c] = {k: time_ms(fn, reps) for k, fn in calls.items()}
        except MatError as e:      # a size the card cannot run: recorded
            out[c] = {"error": str(e)[:200]}
    return out


def _seq_work(name: str, t: int, h: int, n: int) -> tuple:
    """(bytes, operations) a kernel must move and do on dl_vowels' layer
    ('last', saving): each input read once, each output written once."""
    if name == "lstm_seq_fwd":
        floats = (4 * h * t * n + 4 * h * h + h * (t + 1) * n + h * n +
                  t * h * n + 4 * h * t * n)
        ops = 2 * 4 * h * h * n * t + CELL_OPS[name] * h * n * t
    else:
        floats = 4 * h * h + t * h * n + 4 * h * t * n + h * n + \
            4 * h * t * n
        ops = 2 * 4 * h * h * n * (t - 1) + CELL_OPS[name] * h * n * t
    return 4 * floats, ops


def _cudnn(dev, x: dict):
    """cuDNN's LSTM of dl_vowels' layer (F 12 -> H 100, 'last'), its TF32
    off: (forward, backward) as calls, or (None, why)."""
    import torch
    try:
        mod = torch.nn.LSTM(F, H).to(dev)
        with torch.no_grad():
            mod.weight_hh_l0.copy_(x["wh"])
            mod.bias_hh_l0.zero_()
        mod.flatten_parameters()
        xs = torch.randn((T, N, F), device=dev, requires_grad=True)
        params = [xs] + list(mod.parameters())
        out = mod(xs)[0][-1]
        g = x["dhlast"][:, 0, :].t().contiguous()
        torch.autograd.grad(out, params, g, retain_graph=True)
        return (lambda: mod(xs),
                lambda: torch.autograd.grad(out, params, g,
                                            retain_graph=True)), ""
    except (RuntimeError, TypeError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e)[:120]}"


def _graphed(fn, side):
    """fn captured as a CUDA graph on the stream `side` (after a warm-up
    there, as the training step is): its replay, a call whose time is the
    card's and not the host's launches."""
    import torch
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        graph.capture_begin()
        fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph.replay


def _per_step(lstm, x: dict):
    """The earlier design on dl_vowels' layer as replays of captured
    graphs, as the training step ran it: (forward, backward). Forward:
    `torch.addmm` and the cell kernel a step, saving for the backward;
    backward: autograd through that chain (the cell's backward, the
    products' gradients and their sums, a step), built on the stream that
    captures it (autograd runs a backward op on its forward op's
    stream)."""
    import torch
    zxt = x["zx"].permute(1, 0, 2).contiguous()      # (T, 4H, N)
    wh = x["wh"]

    def fwd():
        h = torch.zeros((H, N), dtype=torch.float32, device=wh.device)
        c = h
        for t in range(T):
            h, c, _ = lstm.forward(torch.addmm(zxt[t], wh, h), c, True)
        return h

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a, w = zxt.clone().requires_grad_(), wh.clone().requires_grad_()
        h = torch.zeros((H, N), dtype=torch.float32, device=wh.device)
        c = h
        for t in range(T):
            h, c = lstm.cell(torch.addmm(a[t], w, h), c)
    g = x["dhlast"][:, 0, :]
    return _graphed(fwd, side), _graphed(
        lambda: torch.autograd.grad(h, (a, w), g, retain_graph=True), side)


@contextlib.contextmanager
def _rnn_ieee():
    """cuDNN's RNNs in full float32 inside the block (torch runs them in
    TF32 by default where it has the switch)."""
    import torch
    rnn = getattr(torch.backends.cudnn, "rnn", None)
    holder, attr, value = (rnn, "fp32_precision", "ieee") \
        if hasattr(rnn, "fp32_precision") else \
        (torch.backends.cudnn, "allow_tf32", False)
    prev = getattr(holder, attr)
    setattr(holder, attr, value)
    try:
        yield
    finally:
        setattr(holder, attr, prev)


def seq_rows(lstm, lstm_seq, time_ms, reps: int, dev) -> dict:
    """{kernel: {"ms", "t1_ms", "step_ms", "plain_ms", "earlier_ms",
    "library_ms", "library_note", "bound_ms", "bound_by", "bytes", "ops",
    "cluster"}} at dl_vowels' layer and the route's cluster size."""
    x = seq_inputs(dev)
    one = {k: (v[:, :1] if k in ("zx", "dhs") else v).contiguous()
           for k, v in x.items()}
    calls, short = _seq_calls(lstm_seq, x), _seq_calls(lstm_seq, one)
    zx, wh = x["zx"], x["wh"]
    _, saved = lstm_seq.plain_seq_forward(zx, wh, True, True, True)
    plain = {"lstm_seq_fwd": lambda: lstm_seq.plain_seq_forward(
                 zx, wh, True, True, True),
             "lstm_seq_bwd": lambda: lstm_seq.plain_seq_backward(
                 wh, saved, x["dhlast"], True, True)}
    earlier = dict(zip(("lstm_seq_fwd", "lstm_seq_bwd"), _per_step(lstm, x)))
    with _rnn_ieee():
        lib, note = _cudnn(dev, x)
        lib_ms = {} if lib is None else {
            "lstm_seq_fwd": time_ms(lib[0], reps),
            "lstm_seq_bwd": time_ms(lib[1], reps)}
    rows = {}
    for name, fn in calls.items():
        nbytes, ops = _seq_work(name, T, H, N)
        by_bytes, by_ops = nbytes / BYTES_PER_S * 1e3, ops / FLOPS_F32 * 1e3
        ms, t1 = time_ms(fn, reps), time_ms(short[name], reps)
        rows[name] = {
            "ms": ms, "t1_ms": t1, "step_ms": (ms - t1) / (T - 1),
            "plain_ms": time_ms(plain[name], 2),
            "earlier_ms": time_ms(earlier[name], reps),
            "library_ms": lib_ms.get(name), "library_note":
                "cuDNN through torch.nn.LSTM, the input product included "
                "(TF32 off)" if lib is not None else note,
            "bytes": nbytes, "ops": ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "cluster": lstm_seq.layout(H, N)[0]}
    return rows


def held_optim(optim, dev, steps: int = 3, sizes=None) -> dict:
    """Adam and SGDM at `sizes` learnables (default: both scripts'),
    `steps` steps from zero moments, kernel against plain, once from t = 0
    and once from t = LATE_T (the bias corrections at a script's last
    steps): {kernel: {"equal", "max_abs_err", "t_ok"}}; t_ok: each run's t
    counts the steps."""
    import torch
    out = {}
    for solver in ("adam", "sgdm"):
        name = f"optim_{solver}"
        out[name] = {"equal": True, "max_abs_err": 0.0, "t_ok": True}
        for n in sizes or sorted(LEARNABLES.values()):
            gen = _gen(dev, n)
            p0 = 0.1 * _randn((n,), dev, gen)
            grads = [_randn((n,), dev, gen) * 10.0 ** -k for k in range(steps)]
            for t0 in (0, LATE_T):
                runs = []
                for fn in (optim.update, optim.plain_update):
                    p = p0.clone()
                    st = optim.State(solver, p, 0.01)
                    st.t.fill_(t0)
                    for g in grads:
                        fn(st, p, g)
                    out[name]["t_ok"] &= float(st.t) == t0 + steps
                    runs.append([p, st.m] + ([st.v] if st.v is not None
                                             else []))
                for g, w in zip(*runs):
                    out[name]["equal"] &= bool(torch.equal(g, w))
                    out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                                   _err(g, w))
    torch.cuda.synchronize()
    return out


def _library(fn):
    """A yardstick call, or None (with the reason) where this torch lacks
    it or refuses these inputs."""
    try:
        fn()
        return fn, ""
    except (RuntimeError, TypeError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e)[:120]}"


def kernel_rows(lstm, optim, time_ms, reps: int, dev) -> dict:
    """{kernel: {"ms", "plain_ms", "library_ms", "library_note",
    "bound_ms", "bound_by", "bytes"}} at the paths' shapes."""
    import torch
    rows = {}
    x = cell_inputs(dev)
    z, c, dh, dc2 = x["z"], x["c"], x["dh"], x["dc2"]
    hn = H * N
    h2, c2, act = lstm.forward(z, c)
    ig = z.t().contiguous()
    hg = torch.zeros_like(ig)
    cx = c.t().contiguous()
    aten = torch.ops.aten
    fwd_lib, fwd_note = _library(
        lambda: aten._thnn_fused_lstm_cell(ig, hg, cx))
    ws = None
    if fwd_lib is not None:
        hy, cy, ws = aten._thnn_fused_lstm_cell(ig, hg, cx)
        ghy, gcy = dh.t().contiguous(), dc2.t().contiguous()
    bwd_lib, bwd_note = (None, fwd_note) if ws is None else _library(
        lambda: aten._thnn_fused_lstm_cell_backward_impl(ghy, gcy, cx, cy,
                                                          ws, False))
    cases = {
        "lstm_fwd": (lambda: lstm.forward(z, c),
                     lambda: lstm.plain_forward(z, c), fwd_lib, fwd_note,
                     11 * hn * 4),
        "lstm_bwd": (lambda: lstm.backward(act, c, c2, dh, dc2),
                     lambda: lstm.plain_backward(act, c, c2, dh, dc2),
                     bwd_lib, bwd_note, 13 * hn * 4)}
    for name, n in ROW_SIZES.items():
        solver = name.split("_")[1]
        gen = _gen(dev, 5)
        p = 0.1 * _randn((n,), dev, gen)
        g = _randn((n,), dev, gen)
        st = optim.State(solver, p, 0.01)
        st.t.fill_(1.0)
        pl, gl, ml, vl = [p.clone()], [g], [st.m.clone()], \
            [torch.zeros_like(p)]
        if solver == "adam":
            steps = [torch.ones((), dtype=torch.float32, device=dev)]
            lib, note = _library(lambda: torch._fused_adam_(
                pl, gl, ml, vl, [], steps, lr=0.01, beta1=0.9, beta2=0.999,
                weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False))
            nbytes = 7 * n * 4 + FOLD_BYTES
        else:
            lib, note = _library(lambda: torch._fused_sgd_(
                pl, gl, ml, weight_decay=0.0, momentum=0.9, lr=0.01,
                dampening=0.0, nesterov=False, maximize=False,
                is_first_step=False))
            nbytes = 5 * n * 4 + FOLD_BYTES
        cases[name] = ((lambda st=st, p=p, g=g: optim.update(st, p, g)),
                       (lambda st=st, p=p, g=g: optim.plain_update(st, p, g)),
                       lib, note, nbytes)
    for name, (kern, plain, lib, note, nbytes) in cases.items():
        rows[name] = {
            "ms": time_ms(kern, reps), "plain_ms": time_ms(plain, reps),
            "library_ms": None if lib is None else time_ms(lib, reps),
            "library_note": note, "bytes": nbytes,
            "bound_ms": nbytes / BYTES_PER_S * 1e3, "bound_by": "bytes"}
    return rows


def optim_code() -> dict:
    """Each solver's kernel, from the library's machine code
    (`runmat_tpu_torch/sass.py`): its loads, how many come before the
    first DFMA, its DFMAs, FFMAs and registers, and the fma.rn.f32
    (contractions), div.rn.f32 and sqrt.rn.f32 of its PTX:
    {"optim_adam": {...}, "optim_sgdm": {...}}."""
    from runmat_tpu_torch import sass
    code = sass.kernels(sass.disassemble())
    res = sass.resources()
    ptx = sass.ptx_ops("optim.cu")
    out = {}
    for solver, key in (("adam", "ILb1EE"), ("sgdm", "ILb0EE")):
        (mangled,) = [k for k in code if "optim_kernel" in k and key in k]
        (entry,) = [k for k in ptx if "optim_kernel" in k and key in k]
        out[f"optim_{solver}"] = {
            **sass.load_order(code[mangled]), **ptx[entry],
            "registers": res.get(mangled, {}).get("REG")}
    return out


def _prefix(name: str) -> str:
    """A workload's source up to its training (the data and the options)."""
    src = open(WORKLOADS[name]).read()
    return src[:src.index("net = trainNetwork")]


def _setup(name: str):
    """The workload's data, layers and options, made in a card session:
    (session, layers list, opts, X, Y)."""
    import runmat_tpu_torch
    from runmat_tpu_torch.runtime.builtins import dl_layers
    s = runmat_tpu_torch.session("cuda")
    s.stdout = io.StringIO()
    s.run_source(_prefix(name))
    return (s, dl_layers._layers_list(s.get("layers")), s.get("opts"),
            s.get("X"), s.get("Y"))


def first_steps(name: str, steps: int = 3) -> dict:
    """The workload's network trained `steps` steps on the card (the
    warm-up steps and a replay of the captured step) and on the CPU (the
    plain versions) from the same initial weights: the largest difference
    of the learnables over the largest learnable."""
    import numpy as np

    import runmat_tpu_torch
    from runmat_tpu_torch.runtime.builtins import dl_layers
    s, layers, opts, X, Y = _setup(name)
    try:
        nets = {}
        for dev in ("cuda", "cpu"):
            net = dl_layers.DlNetwork(layers, device=dev)
            hx, hy = dl_layers._train_data(net, X, Y)
            dl_layers._train(net, hx, hy, opts, max_steps=steps)
            nets[dev] = np.concatenate([a.reshape(-1)
                                        for a in net.learnables_np()])
    finally:
        runmat_tpu_torch.uninstall()
    scale = float(np.abs(nets["cpu"]).max())
    return {"rel_err": float(np.abs(nets["cuda"] - nets["cpu"]).max())
            / scale, "largest": scale, "steps": steps,
            "tol": STEP_TOL[dl_layers._opt(opts, "Solver", "adam")]}


def repeat(name: str) -> dict:
    """The workload's network trained twice on the card over all its
    steps, from the same initial weights: the largest difference of the
    learnables, and each training's captures and replays."""
    import numpy as np

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.runtime.builtins import dl_layers
    s, layers, opts, X, Y = _setup(name)
    eng = accel.active_engine()
    try:
        flats, counts = [], []
        for _ in range(2):
            before = dict(eng.stats)
            net = dl_layers.DlNetwork(layers)
            dl_layers._train(net, *dl_layers._train_data(net, X, Y), opts)
            flats.append(np.concatenate([a.reshape(-1)
                                         for a in net.learnables_np()]))
            counts.append({k: eng.stats[k] - before[k]
                           for k in ("graph_captures", "graph_replays")})
    finally:
        runmat_tpu_torch.uninstall()
    return {"max_diff": float(np.abs(flats[0] - flats[1]).max()),
            "counts": counts}


def step_times(name: str, time_ms, reps: int) -> dict:
    """One training step of the workload at its first minibatch: eagerly
    (`_TrainStep.body`) and as a replay of its captured graph, with cuDNN's
    deterministic algorithms ("det") and without ("free"); and the device
    kernels of one replay (`torch.profiler`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import runmat_tpu_torch
    from runmat_tpu_torch import accel
    from runmat_tpu_torch.runtime.builtins import dl_layers
    s, layers, opts, X, Y = _setup(name)
    eng = accel.active_engine()
    out = {}
    try:
        for mode in ("det", "free"):
            net = dl_layers.DlNetwork(layers)
            hx, hy = dl_layers._train_data(net, X, Y)
            bs = int(dl_layers._opt(opts, "MiniBatchSize", 128))
            step = dl_layers._TrainStep(
                net, dl_layers._loss_fn(net),
                dl_layers._opt(opts, "Solver", "adam"),
                dl_layers._opt(opts, "InitialLearnRate", 0.001),
                hx.shape[:-1] + (bs,), hy.shape[:-1] + (bs,), eng)
            step.xb.copy_(torch.from_numpy(hx[..., :bs].astype("float32")))
            step.yb.copy_(torch.from_numpy(hy[..., :bs].astype("float32")))
            with dl_layers._precise(net.device, deterministic=mode == "det"):
                for _ in range(step.WARMUP + 1):
                    step.run(eng)
                out[f"eager_{mode}_ms"] = time_ms(step.body, reps)
            out[f"replay_{mode}_ms"] = time_ms(step.graph.replay, reps)
            if mode == "det":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    step.graph.replay()
                    torch.cuda.synchronize()
                out["kernels_a_step"] = sum(
                    1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    finally:
        runmat_tpu_torch.uninstall()
    return out


def dlfeval_snippet() -> dict:
    """SNIPPET (a fully connected layer, relu with a tie at 0 and mse,
    float64) in a card session and in a CPU one: the largest difference of
    the loss and the gradients over their largest magnitude."""
    import numpy as np

    import runmat_tpu_torch
    got = {}
    for dev in ("cuda", "cpu"):
        s = runmat_tpu_torch.session(dev)
        try:
            s.stdout = io.StringIO()
            s.run_source(SNIPPET)
            got[dev] = {k: np.asarray(s.get(k).host(), np.float64)
                        for k in ("lv", "gwv", "gbv")}
        finally:
            runmat_tpu_torch.uninstall()
    err = 0.0
    for k, w in got["cpu"].items():
        scale = max(float(np.abs(w).max()), 1e-300)
        err = max(err, float(np.abs(got["cuda"][k] - w).max()) / scale)
    return {"rel_err": err, "shapes": {k: v.shape
                                       for k, v in got["cpu"].items()}}


def main() -> int:
    # run as a script: the package's parent, not the package, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch

    from runmat_tpu_torch import histbench
    from runmat_tpu_torch.ops import lstm, lstm_seq, optim
    if not torch.cuda.is_available():
        print("dlbench: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    sweep = seq_sweep(lstm_seq, histbench.time_ms, 50, dev)
    print(f"cluster sweep: {sweep}")
    runs = [c for c, r in sweep.items() if "error" not in r]
    for name, r in held_seq(lstm_seq, dev, runs).items():
        print(f"{name} at clusters {runs}: equal to ordered plain "
              f"{r['equal']}, max abs err {r['max_abs_err']:.3g}")
    for name, r in seq_rows(lstm, lstm_seq, histbench.time_ms, 50,
                            dev).items():
        print(f"time {name}: {r}")
    for name, r in {**held_cell(lstm, dev), **held_optim(optim, dev)}.items():
        print(f"{name}: equal to plain {r['equal']}, max abs err "
              f"{r['max_abs_err']:.3g}")
    for name, r in kernel_rows(lstm, optim, histbench.time_ms, 50,
                               dev).items():
        print(f"time {name}: {r}")
    for name in WORKLOADS:
        print(name, step_times(name, histbench.time_ms, 20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
