"""The port's command line, its static analysis, HIR and MIR, held to the
JAX package.

* Every test of `tests/test_analysis.py`, `tests/test_hir.py` and
  `tests/test_mir.py` runs with each function of `runmat_tpu` it calls
  paired with the port's (`torch_twin`): the same inputs through both,
  results equal exactly (findings, bindings, control-flow graphs,
  liveness), `test_lsp_diagnostics_include_lints` (`runmat_tpu.lsp`'s
  diagnostics) among them.
* The scenarios of `tests/test_config_cli.py` through both command lines
  in subprocesses, the JAX package's on its CPU engine and the port's on
  the host (`--no-accel`; without it and without a card the port's CLI
  exits 1 and names the flag): the same output for `version`, `info`,
  `check` (with and without `--mir`), `-e` and a script; `serve`, `lsp`,
  `remote` and `login`; the session tests of that file through
  `torch_paired.PairedSession`; `accel-info --json` in process on
  `TorchEngine("cpu")`.
* `accel-warmup`, which exists only for the TPU, exits 1 saying so;
  `accel-calibrate` writes the port's own file under HOME, which a new
  `TorchEngine` reads back, and the TPU's file is never read.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import runmat_tpu.session
import test_analysis
import test_config_cli
import test_hir
import test_mir
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch import cli
from runmat_tpu_torch.accel.engine import TorchEngine, calibration_path
from torch_both import no_engine  # noqa: F401
from torch_paired import PairedSession, fresh_state, run_paired
from torch_twin import cases, run_twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a card is present; this checks the "
                                    "refusal without one")

STATIC = [(m, n, p, label) for m in (test_analysis, test_hir, test_mir)
          for n, p, label in cases(m)]


@pytest.mark.parametrize("module,name,params", [c[:3] for c in STATIC],
                         ids=[f"{c[0].__name__}::{c[3]}" for c in STATIC])
def test_the_static_tests_agree_through_both(request, monkeypatch, module,
                                             name, params):
    run_twin(request, monkeypatch, module, name, params)


def run_cli(pkg: str, *args, home=None, cwd=None):
    """`python -m <pkg>.cli args` in a subprocess: the JAX package's on its
    CPU engine, the port's as given (add --no-accel for the host)."""
    env = dict(os.environ)
    env["RUNMAT_TPU_PLATFORM"] = "cpu"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if home is not None:
        env["HOME"] = str(home)
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args],
                          capture_output=True, text=True, cwd=cwd or REPO,
                          env=env, timeout=120)


def _both(*args, tmp_path, port_args=("--no-accel",)):
    j = run_cli("runmat_tpu", *args, home=tmp_path)
    t = run_cli("runmat_tpu_torch", *port_args, *args, home=tmp_path)
    return j, t


def test_version_and_info_agree(tmp_path):
    for cmd in ("version", "info"):
        j, t = _both(cmd, tmp_path=tmp_path)
        assert (t.returncode, t.stdout) == (j.returncode, j.stdout), cmd
    assert int(t.stdout.split("builtins:")[1].split()[0]) > 400


@pytest.mark.parametrize("mir", [False, True], ids=["check", "check-mir"])
def test_check_agrees(tmp_path, mir):
    good, bad = tmp_path / "g.m", tmp_path / "b.m"
    good.write_text("x = 1 + 2;\nfor k = 1:3\n  x = x + k;\nend\n"
                    "function y = f(a)\ny = a;\nend\n")
    bad.write_text("x = 1 +;\n")
    flag = ("--mir",) if mir else ()
    for path in (good, bad):
        j, t = _both("check", *flag, str(path), tmp_path=tmp_path)
        assert (t.returncode, t.stdout) == (j.returncode, j.stdout), path
    assert "parseError" in t.stdout and t.returncode == 1


def test_eval_and_script_agree(tmp_path):
    j, t = _both("-e", "disp(6 * 7)", tmp_path=tmp_path)
    assert t.returncode == j.returncode == 0
    assert t.stdout == j.stdout and "42" in t.stdout
    p = tmp_path / "s.m"
    p.write_text("fprintf('%d\\n', sum(1:10));\nA = magic(4);\n"
                 "fprintf('%g\\n', A(2, :) * A(:, 3));\n")
    j, t = _both(str(p), tmp_path=tmp_path)
    assert (t.returncode, t.stdout) == (0, j.stdout) and "55" in t.stdout
    # the flag may come before a subcommand's arguments, as after them
    t = run_cli("runmat_tpu_torch", "run", str(p), "--no-accel",
                home=tmp_path)
    assert (t.returncode, t.stdout) == (0, j.stdout)


@NO_CARD
@pytest.mark.parametrize("args", [("-e", "disp(1)"), ("accel-info",),
                                  ("run", "x.m"), ("gc-stats",)],
                         ids=["eval", "accel-info", "run", "gc-stats"])
def test_without_a_card_the_cli_names_no_accel(tmp_path, args):
    t = run_cli("runmat_tpu_torch", *args, home=tmp_path)
    assert t.returncode == 1, (t.stdout, t.stderr)
    assert "--no-accel" in t.stderr and "No CUDA device" in t.stderr
    assert t.stdout == ""


@pytest.mark.parametrize("cmd", ["accel-warmup"])
def test_commands_not_carried_name_their_item(tmp_path, cmd):
    """accel-warmup replays XLA programs into XLA's cache: the port refuses
    it, saying it exists only for the TPU."""
    t = run_cli("runmat_tpu_torch", cmd, "--no-accel", home=tmp_path)
    assert t.returncode == 1
    assert "RunMat" not in t.stdout
    assert "exists only there" in t.stderr and "TPU" in t.stderr


def _framed(messages) -> str:
    out = ""
    for m in messages:
        body = json.dumps(m)
        out += f"Content-Length: {len(body.encode())}\r\n\r\n{body}"
    return out


def _unframed(data: str) -> list:
    out = []
    while data:
        head, _, rest = data.partition("\r\n\r\n")
        n = int(head.split(":")[1])
        out.append(json.loads(rest.encode()[:n]))
        data = rest.encode()[n:].decode()
    return out


def _stdin_cli(pkg, args, text, home, env=None):
    e = dict(os.environ, RUNMAT_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
             HOME=str(home), **(env or {}))
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    extra = ("--no-accel",) if pkg == "runmat_tpu_torch" else ()
    # bytes both ways: the LSP's framing holds "\r\n", which text mode
    # would translate
    r = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args, *extra],
                       input=text.encode(), capture_output=True, cwd=REPO,
                       env=e, timeout=120)
    r.stdout = r.stdout.decode()
    return r


@pytest.mark.parametrize("cmd", ["serve", "lsp", "remote", "login"])
def test_tooling_commands_agree(tmp_path, cmd):
    """serve (JSON lines on stdio), lsp (framed JSON-RPC on stdio), remote
    (against a project server on localhost) and login (the credentials
    file under HOME) through both command lines in subprocesses: the same
    output, responses equal but for their wall times."""
    outs = []
    for pkg in ("runmat_tpu", "runmat_tpu_torch"):
        home = tmp_path / pkg
        home.mkdir()
        if cmd == "serve":
            reqs = [{"id": 1, "op": "execute",
                     "source": "x = sum(1:10); disp(x)"},
                    {"id": 2, "op": "get", "name": "x"},
                    {"id": 3, "op": "check", "source": "y = zz + 1;"},
                    {"id": 4, "op": "shutdown"}]
            r = _stdin_cli(pkg, ["serve"], "\n".join(map(json.dumps, reqs)),
                           home)
            lines = [json.loads(ln) for ln in r.stdout.splitlines()]
            for ln in lines:
                ln.pop("wall_ms", None)
            outs.append((r.returncode, lines))
        elif cmd == "lsp":
            msgs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize",
                     "params": {}},
                    {"jsonrpc": "2.0", "method": "textDocument/didOpen",
                     "params": {"textDocument": {
                         "uri": "file:///t.m",
                         "text": "function y = f(x)\nq = 7;\ny = x +;\n"}}},
                    {"jsonrpc": "2.0", "id": 2, "method": "shutdown"},
                    {"jsonrpc": "2.0", "method": "exit"}]
            r = _stdin_cli(pkg, ["lsp"], _framed(msgs), home)
            outs.append((r.returncode, _unframed(r.stdout)))
        elif cmd == "remote":
            from runmat_tpu_torch.remote import ProjectServer
            srv = ProjectServer(str(tmp_path / f"store-{pkg}")).start()
            try:
                env = {"RUNMAT_TPU_API_URL": srv.base_url}
                r = _stdin_cli(pkg, ["remote", "org", "create", "acme"], "",
                               home, env)
                org = json.loads(r.stdout)
                r2 = _stdin_cli(pkg, ["remote", "org", "list"], "", home,
                                env)
            finally:
                srv.stop()
            outs.append((r.returncode, r2.returncode, org["name"],
                         r2.stdout.replace(org["id"], "<id>")))
        else:
            r = _stdin_cli(pkg, ["login", "http://127.0.0.1:1", "--token",
                                 "tok123"], "", home)
            cred = json.loads((home / ".runmat_tpu" /
                               "credentials.json").read_text())
            outs.append((r.returncode, r.stdout, cred))
    assert outs[1] == outs[0]
    assert outs[0][0] == 0


def test_accel_info_json_on_the_cpu_engine(no_engine):
    taccel.set_engine(TorchEngine("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["accel-info", "--json"]) == 0
    data = json.loads(out.getvalue())
    assert data["provider"]["platform"] == "cpu"
    assert "dispatches" in data["provider"]
    assert data["card"] == {"name": "cpu", "platform": "cpu", "count": 1,
                            "capability": None, "memory": 0}


def test_accel_calibrate_writes_the_ports_own_file(no_engine, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RUNMAT_TPU_OFFLOAD_THRESHOLD", raising=False)
    tpu = tmp_path / ".runmat_tpu" / "calibration.json"
    tpu.parent.mkdir()
    tpu.write_text(json.dumps({"platform": "cpu", "offload_threshold": 7,
                               "ozaki_auto_mindim": 256}))
    assert TorchEngine("cpu").offload_threshold == 32768   # never read
    taccel.set_engine(TorchEngine("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["accel-calibrate"]) == 0
    assert calibration_path() == str(tmp_path / ".runmat_tpu" /
                                     "torch_calibration.json")
    cal = json.loads(open(calibration_path()).read())
    assert cal["platform"] == "cpu" and cal["device"] == "cpu"
    assert cal["offload_threshold"] in [1 << k for k in range(10, 27)]
    assert "calibrated offload threshold" in out.getvalue()
    assert TorchEngine("cpu").offload_threshold == cal["offload_threshold"]
    # an explicit threshold or the environment's still wins
    assert TorchEngine("cpu", offload_threshold=5).offload_threshold == 5
    monkeypatch.setenv("RUNMAT_TPU_OFFLOAD_THRESHOLD", "9")
    assert TorchEngine("cpu").offload_threshold == 9


def test_config_precedence_and_generate_agree(tmp_path, monkeypatch):
    from runmat_tpu import config as jcfg
    from runmat_tpu_torch import config as tcfg
    (tmp_path / "runmat.toml").write_text(
        "[accelerate]\noffload_threshold = 999\n")
    monkeypatch.delenv("RUNMAT_TPU_OFFLOAD_THRESHOLD", raising=False)
    for mod in (jcfg, tcfg):
        c = mod.load(start=str(tmp_path))
        assert c.get("accelerate", "offload_threshold") == 999
    monkeypatch.setenv("RUNMAT_TPU_OFFLOAD_THRESHOLD", "123")
    j, t = (m.load(start=str(tmp_path)) for m in (jcfg, tcfg))
    assert t.describe() == j.describe()
    assert "RUNMAT_TPU_OFFLOAD_THRESHOLD" in t.overrides
    pj = jcfg.generate_default(str(tmp_path / "j.toml"))
    pt = tcfg.generate_default(str(tmp_path / "t.toml"))
    assert open(pt).read() == open(pj).read()


def test_telemetry_spans_in_the_port():
    from runmat_tpu_torch import telemetry
    from runmat_tpu_torch.session import Session
    telemetry.enable(True)
    try:
        s = Session(accelerate=False)
        s.run_source("x = 1 + 1;", "t")
        names = [sp["span"] for sp in telemetry.spans()]
        assert "runtime.lower" in names and "runtime.execute" in names
        assert telemetry.snapshot(s)["session"]["workspace_vars"] >= 1
    finally:
        telemetry.enable(False)


@pytest.mark.parametrize("name", ["test_search_path_function_and_class",
                                  "test_workspace_replay"])
def test_the_session_tests_agree_through_both(request, monkeypatch, no_engine,
                                              name):
    # they import the JAX package's Session inside their bodies
    monkeypatch.setattr(runmat_tpu.session, "Session", PairedSession)
    fresh_state()
    run_paired(request, monkeypatch, test_config_cli, name)
