"""The port's own host layers: what they repair, what they refuse, and the
engine registry they run on.

* `histcounts` routes a device x with explicit edges before it gathers; the
  engine counts every copy to the host (`gathers`, `gather_bytes`).
* The workspace preview of `Session.execute` gives a host array above
  `PREVIEW_MAX_ELEMENTS` a one-line `[RxC class]` and never formats it.
* `install`/`uninstall`/`session` touch only the port's engine registry;
  `init_engine` needs a card and a session that does not require one runs
  on the host without it; a `while` loop of device math folds, and a
  failed `for` fold is counted with its reason.
* The config loader reads RUNMAT_CONFIG or a file in the working directory,
  never one in a directory above it.
Counts are exact; values are compared with the port's host session exactly.
"""

import numpy as np
import pytest
import torch

import runmat_tpu_torch
from runmat_tpu import accel as jax_accel
from runmat_tpu_torch import accel, execution
from runmat_tpu_torch.errors import MatError
from runmat_tpu_torch.session import Session
from runmat_tpu_torch.values import MatArray

OFFLOAD = dict(auto_offload=True, offload_threshold=1)


@pytest.fixture
def restore_engine():
    prev, jprev = accel.active_engine(), jax_accel.active_engine()
    yield
    runmat_tpu_torch.uninstall()
    accel.set_engine(prev)
    jax_accel.set_engine(jprev)


def _host(src):
    prev = accel.active_engine()
    accel.set_engine(None)
    try:
        s = Session(accelerate=False)
        r = s.execute(src)
    finally:
        accel.set_engine(prev)
    assert r.error is None, r.error
    return s


def test_gathers_are_counted(restore_engine):
    eng = runmat_tpu_torch.install("cpu", **OFFLOAD)
    x = MatArray(np.arange(12.0).reshape(3, 4), "double")
    d = eng.upload(x)
    assert eng.stats["gathers"] == 0
    assert np.array_equal(d.host(), x.host())
    assert eng.stats["gathers"] == 1
    assert eng.stats["gather_bytes"] == 12 * 8
    assert eng.stats["uploads"] == 1 and eng.stats["upload_bytes"] == 96


def test_histcounts_of_a_device_array_gathers_no_input(restore_engine):
    src = ("x = gpuArray(single(linspace(-3, 3, 20000)));"
           " c = histcounts(x, single(-2:0.5:2)); d = histcounts(x, [-1 0 2]);")
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    eng = accel.active_engine()
    assert s.execute(src).error is None
    assert s.get("x").on_device and s.get("c").on_device
    # only the edges come back (for the second output); x's 80 KB do not
    assert eng.stats["gather_bytes"] <= 3 * 8
    host = _host(src.replace("gpuArray", ""))
    for k in ("c", "d"):
        assert np.array_equal(s.get(k).host(), host.get(k).host()), k


@pytest.mark.parametrize("args", ["10", "'BinWidth', 0.5", ""])
def test_histcounts_host_branches_still_gather(restore_engine, args):
    # bins chosen from the data, or BinWidth: the host path, as before
    tail = f", {args}" if args else ""
    src = f"x = gpuArray(linspace(-3, 3, 999)); [c, e] = histcounts(x{tail});"
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    assert s.execute(src).error is None
    host = _host(src.replace("gpuArray", ""))
    for k in ("c", "e"):
        assert np.array_equal(s.get(k).host(), host.get(k).host()), k


def test_preview_of_a_large_host_array_is_one_line(monkeypatch):
    big = MatArray(np.zeros((3000, 3000)), "double")
    small = MatArray(np.arange(4.0).reshape(2, 2), "double")
    assert "1" in execution.value_meta(small)["preview"]

    def refuse(*a, **k):
        raise AssertionError("formatted a large array")
    monkeypatch.setattr("runmat_tpu_torch.utils.display.format_value", refuse)
    meta = execution.value_meta(big)
    assert meta["preview"] == "[3000x3000 double]"
    assert meta["bytes"] == 3000 * 3000 * 8


def test_execute_previews_a_large_host_array_by_shape(restore_engine):
    from runmat_tpu.execution import value_meta as jax_value_meta
    from runmat_tpu.values import MatArray as JaxMatArray
    s = Session(accelerate=False)
    r = s.execute_request("x = zeros(1, 100000); y = [1 2 3];")
    meta = {u["name"]: u for u in r.workspace_delta.upserts}
    assert meta["x"]["preview"] == "[1x100000 double]"
    # a small array keeps the JAX package's formatted preview
    want = jax_value_meta(JaxMatArray(np.array([[1.0, 2.0, 3.0]]), "double"),
                          preview_lines=1)
    assert meta["y"]["preview"] == want["preview"]


def test_install_touches_only_the_ports_registry(restore_engine):
    before, jax_before = accel.active_engine(), jax_accel.active_engine()
    eng = runmat_tpu_torch.install("cpu")
    assert accel.active_engine() is eng
    assert jax_accel.active_engine() is jax_before
    runmat_tpu_torch.uninstall()
    assert accel.active_engine() is before


def test_init_engine_needs_a_card(restore_engine):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    accel.set_engine(None)
    with pytest.raises(MatError) as ei:
        accel.init_engine()
    assert ei.value.identifier == "parallel:gpu:device:NoDevice"
    # accelerate=None means the card: it raises, naming how to ask for the
    # host, and never falls back to the host on its own
    with pytest.raises(MatError) as ei:
        Session()
    assert ei.value.identifier == "parallel:gpu:device:NoDevice"
    assert "accelerate=False" in ei.value.message
    assert accel.active_engine() is None
    with pytest.raises(MatError):
        Session(accelerate=True)
    s = Session(accelerate=False)       # the host, asked for
    assert s.execute("y = sum([1 2 3]);").error is None
    assert accel.active_engine() is None


# `x ./ 2`: `x / 2` compiles to a matrix divide, which no fold traces
WHILE = "x = ones(64, 1); k = 0; while sum(x) > 1, x = x ./ 2; k = k + 1; end"


def test_while_loop_is_left_to_the_interpreter(restore_engine):
    # the name stays; since the while fold is ported the loop runs on the
    # device as one fold, with the interpreter's x and k
    host = _host(WHILE)
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    eng = accel.active_engine()
    r = s.execute(WHILE)
    assert r.error is None
    assert eng.stats["while_folds"] == 1
    assert "while_not_ported" not in eng.stats
    assert eng.stats["loop_bails"] == 0
    (entry,) = [e for e in eng.launch_log if e["cat"] == "device_while"]
    assert entry["iterations"] == 6
    assert s.get("x").on_device and s.get("k").on_device
    assert np.array_equal(s.get("x").host(), host.get("x").host())
    assert s.get("k").host().item() == host.get("k").host().item() == 6


def test_a_failed_fold_is_counted_with_its_reason(restore_engine):
    # writing a complex value into a real array declines on record (as
    # JaxEngine does; the body of complex ops this test used before
    # complex values were ported now folds), the fold bails on record
    # with its reason, and the interpreter runs the loop to the host
    # engine's result
    src = "x = zeros(1, 16); for t = 1:16, x(t) = t + 2i; end"
    host = _host(src)
    s = runmat_tpu_torch.session("cpu", **OFFLOAD)
    eng = accel.active_engine()
    r = s.execute(src)
    assert r.error is None
    assert eng.stats["loop_bails"] == 1
    assert eng.stats["loop_folds"] == 0
    reasons = [e["reason"] for e in eng.launch_log if e["cat"] == "loop_bail"]
    assert reasons and reasons[0]
    declined = [e["reason"] for e in eng.launch_log
                if e["cat"] == "host_fallback"]
    assert "a write that changes complexity" in declined
    assert np.array_equal(s.get("x").host(), host.get("x").host())


@pytest.mark.parametrize("name", ["runmat.toml", "runmat.json"])
def test_a_config_file_above_the_working_directory_is_ignored(
        tmp_path, monkeypatch, name):
    from runmat_tpu_torch import config
    monkeypatch.delenv("RUNMAT_CONFIG", raising=False)
    text = ('[accelerate]\nprovider = "none"\n' if name.endswith(".toml")
            else '{"accelerate": {"provider": "none"}}')
    (tmp_path / name).write_text(text)
    work = tmp_path / "checkout"
    work.mkdir()
    monkeypatch.chdir(work)
    assert config.load().source is None
    assert config.load().get("accelerate", "provider") == "auto"
    # the same file in the working directory itself is read
    monkeypatch.chdir(tmp_path)
    assert config.load().source == str(tmp_path / name)
    assert config.load().get("accelerate", "provider") == "none"


@pytest.mark.parametrize("src", [
    "x = (1:8)'; A = reshape(x, 4, 2); A(1) = 99;",
    "x = reshape(1:8, 1, 2, 4); A = squeeze(x); A(1) = 99;"])
def test_a_reshaped_copy_is_its_own_value(restore_engine, src):
    # ROADMAP Queue C: the JAX package's host reshape and squeeze return a
    # numpy view, so an indexed write into the result changes x too; the
    # port's copies return their own buffer, as MATLAB's values are
    from runmat_tpu.session import Session as JaxSession
    jax_accel.set_engine(None)
    jax = JaxSession(accelerate=False)
    assert jax.execute(src).error is None
    assert jax.get("x").host().reshape(-1, order="F")[0] == 99
    port = _host(src)
    assert port.get("x").host().reshape(-1, order="F")[0] == 1
    assert port.get("A").host().reshape(-1, order="F")[0] == 99
