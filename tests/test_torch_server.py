"""The port's session server, held to the JAX package's.

* `tests/test_server.py`'s request sequences through both packages'
  `handle_request` (`torch_paired.paired_handle_request`): each request to
  the JAX package's server over a JAX session and to the port's over a
  port session, the responses equal but for `wall_ms` and what names the
  engine or reads its counters, the workspaces, files and figures as
  `PairedSession` holds them.
* Its transport tests against the port alone (`torch_ported.ported`): the
  `serve` command over stdio in a subprocess, the HTTP bridge with its
  token, Host and Origin refusals, and `host_header_ok`'s IPv6 forms.
* `serve` over stdio and over TCP as subprocesses of both command lines,
  the same requests, the same responses.
* `accel_info` on the port's engine names its platform, its counters, the
  card (here the CPU) and the kernels' launch counts.

The TS bindings' two tests check files of the JAX package's bindings and
are not paired.
"""

import collections
import inspect
import json
import os
import subprocess
import sys

import pytest

import test_server
from runmat_tpu_torch import accel as taccel
from runmat_tpu_torch.accel.engine import TorchEngine
from runmat_tpu_torch.server import handle_request
from runmat_tpu_torch.session import Session
from torch_both import no_engine  # noqa: F401
from torch_paired import run_paired, session_tests
from torch_ported import ported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# they start a server of their own or call it without a session
TRANSPORT = ("test_serve_subprocess_roundtrip",
             "test_http_bridge_serves_repl_and_api",
             "test_host_header_ok_ipv6_forms")
# they read the JAX package's TS bindings
BINDINGS = ("test_ts_dist_mirror_covers_index_ts_surface",
            "test_ts_bindings_node_suite")
# a session with accelerate=True on the JAX package's CPU engine; its
# sum(sin(x) + 1, 'all') over 4096 values adds in another order than XLA's
# (138 ulp apart on the CPU), held within the port's double-sum tolerance
ENGINE = ("test_fusion_plans_op",)
NEAR = {"test_fusion_plans_op": {"y": 1e-12}}
PAIRED = [n for n in session_tests(test_server)
          if n not in TRANSPORT + BINDINGS]


@pytest.mark.parametrize("name", PAIRED)
def test_the_requests_agree_through_both(request, monkeypatch, no_engine,
                                         name):
    run_paired(request, monkeypatch, test_server, name,
               engine=name in ENGINE, near=NEAR.get(name))


@pytest.mark.parametrize("name", TRANSPORT)
def test_the_transport_tests_hold_the_port(request, name):
    fn = getattr(ported(test_server), name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


REQUESTS = [{"id": 1, "op": "execute", "source": "x = magic(3); disp(x(2, :))"},
            {"id": 2, "op": "workspace"},
            {"id": 3, "op": "get", "name": "x"},
            {"id": 4, "op": "execute", "source": "error('my:id', 'boom')"},
            {"id": 5, "op": "hover", "name": "x"},
            {"id": 6, "op": "nope"},
            {"id": 7, "op": "shutdown"}]


def _env():
    env = dict(os.environ, RUNMAT_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cmd(pkg, *args):
    extra = ("--no-accel",) if pkg == "runmat_tpu_torch" else ()
    return [sys.executable, "-m", f"{pkg}.cli", "serve", *args, *extra]


def _steady(lines):
    for ln in lines:
        ln.pop("wall_ms", None)
    return lines


def _stdio(pkg):
    p = subprocess.run(_cmd(pkg), input="\n".join(map(json.dumps, REQUESTS))
                       + "\n", capture_output=True, text=True, cwd=REPO,
                       env=_env(), timeout=120)
    assert p.returncode == 0, p.stderr
    return _steady([json.loads(ln) for ln in p.stdout.splitlines()])


def _tcp(pkg):
    import socket
    p = subprocess.Popen(_cmd(pkg, "--tcp", "0"), stderr=subprocess.PIPE,
                         stdout=subprocess.DEVNULL, text=True, cwd=REPO,
                         env=_env())
    try:
        line = p.stderr.readline()
        assert "listening on" in line, line
        port = int(line.rsplit(":", 1)[1])
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            f = c.makefile("rw", encoding="utf-8")
            out = []
            for req in REQUESTS:
                f.write(json.dumps(req) + "\n")
                f.flush()
                out.append(json.loads(f.readline()))
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        p.stderr.close()
    return _steady(out)


@pytest.mark.parametrize("transport", [_stdio, _tcp], ids=["stdio", "tcp"])
def test_serve_subprocesses_agree(transport):
    want, got = transport("runmat_tpu"), transport("runmat_tpu_torch")
    assert got == want
    assert want[0]["output"].split() == ["3", "5", "7"]
    assert want[3]["error"]["identifier"] == "my:id"
    assert want[-1]["shutdown"] is True


def test_accel_info_reports_the_ports_engine(no_engine, monkeypatch):
    from runmat_tpu_torch.ops import fused
    taccel.set_engine(TorchEngine("cpu"))
    s = Session(accelerate=True)
    r = handle_request(s, {"id": 1, "op": "execute",
                           "source": "x = gpuArray(rand(1000, 1, "
                                     "'single')); "
                                     "m = gather(mean(x .* 2));"})
    assert r["ok"], r
    info = handle_request(s, {"id": 2, "op": "accel_info"})["accel"]
    assert info["available"] and info["platform"] == "cpu"
    assert info["stats"]["dispatches"] > 0
    assert info["card"]["name"] == "cpu"
    assert set(info["launches"]) >= {"threefry", "fused", "histogram"}
    # on the CPU the wrappers run their plain versions: no kernel launched
    assert not any(info["launches"].values())
    # a generated kernel's count is keyed by (label, module): the response
    # is one JSON line all the same
    monkeypatch.setattr(fused, "launches_by", collections.Counter(
        {("fused_map_f32", "fused_0123"): 3}))
    r = handle_request(s, {"id": 3, "op": "accel_info"})
    assert r["accel"]["launches"]["fused"] == {"fused_map_f32 fused_0123": 3}
    assert json.loads(json.dumps(r)) == r


def test_every_kernel_module_is_counted_and_zeroed(monkeypatch):
    """`ops.KERNEL_MODULES` is the one list of the modules that count
    launches: every module of `ops` with a `launches_by` is on it, and
    `zero_launches` clears what `launch_counts` reads."""
    import pathlib

    from runmat_tpu_torch import ops
    counting = sorted(p.stem for p in
                      pathlib.Path(ops.__file__).parent.glob("*.py")
                      if "\nlaunches_by" in p.read_text())
    assert counting == sorted(ops.KERNEL_MODULES)
    mods = ops.kernel_modules()
    for m, mod in mods.items():
        monkeypatch.setattr(mod, "launches", 2)
        monkeypatch.setattr(mod, "launches_by", collections.Counter({m: 2}))
    assert ops.launch_counts() == {m: {m: 2} for m in ops.KERNEL_MODULES}
    ops.zero_launches()
    assert ops.launch_counts() == {m: {} for m in ops.KERNEL_MODULES}
    assert not any(mod.launches for mod in mods.values())
