"""The port's embedded client profile, held to the JAX package's.

* `client.run`, `handle_json` and `engine_info` give what the JAX
  package's client gives (but for wall times), and its `python -m ...client`
  entry prints the same.
* The profile never touches the card: in a subprocess with jax and
  runmat_tpu blocked and torch's CUDA initialisation and the port's
  `init_engine` made to record any call, a run, the wire protocol and the
  capability card leave `torch.cuda.is_initialized()` false, call neither,
  and leave `accel.active_engine()` None. (The JAX profile's invariant, no
  jax import, cannot hold for the port, whose package imports torch: the
  standing difference in ROADMAP.)
"""

import json
import os
import subprocess
import sys

import pytest

from runmat_tpu import client as jclient
from runmat_tpu_torch import client as tclient
from torch_both import no_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCES = ["A = magic(4); x = A \\ ones(4,1); disp(round(sum(x)*1e6)/1e6)",
           "s = 'abc'; disp(upper(s)); n = numel(s)",
           "error('my:id', 'boom %d', 3)",
           "c = {1, 'two'}; disp(class(c))"]


def _steady(d: dict) -> dict:
    d.pop("wall_ms", None)
    return d


@pytest.fixture
def fresh_clients(monkeypatch, no_engine):
    # no engine active in either package: accel_info reports the active
    # engine, and another test file on the worker may have left one
    monkeypatch.setattr(jclient, "_SESSION", None)
    monkeypatch.setattr(tclient, "_SESSION", None)


@pytest.mark.parametrize("src", SOURCES)
def test_run_agrees(fresh_clients, src):
    assert _steady(tclient.run(src)) == _steady(jclient.run(src))


def test_handle_json_agrees(fresh_clients):
    lines = [{"id": 1, "op": "execute", "source": "q = (1:4)'; w = q .^ 2;"},
             {"id": 2, "op": "workspace"},
             {"id": 3, "op": "get", "name": "w"},
             {"id": 4, "op": "hover", "name": "q"},
             {"id": 5, "op": "check", "source": "y = undefined_xyz + 1;"},
             {"id": 6, "op": "accel_info"},
             {"id": 7, "op": "reset"},
             {"id": 8, "op": "workspace"}]
    for req in lines:
        want = _steady(json.loads(jclient.handle_json(json.dumps(req))))
        got = _steady(json.loads(tclient.handle_json(json.dumps(req))))
        assert got == want, req
    bad = "{not json"
    assert tclient.handle_json(bad) == jclient.handle_json(bad)


def test_engine_info_agrees():
    want, got = jclient.engine_info(), tclient.engine_info()
    assert got == want and got["accelerate"] is False


def test_client_entry_agrees(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", RUNMAT_TPU_PLATFORM="cpu")
    out = []
    for pkg in ("runmat_tpu", "runmat_tpu_torch"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.client", "-e",
                            "disp(sum(1:10))"], capture_output=True,
                           text=True, cwd=REPO, env=env, timeout=120)
        out.append((r.returncode, r.stdout))
    assert out[1] == out[0] and "55" in out[0][1]


NO_CARD = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["runmat_tpu"] = None
import torch
calls = []
real = torch.cuda._lazy_init
def lazy_init():
    calls.append("torch.cuda._lazy_init")
    return real()
torch.cuda._lazy_init = lazy_init
from runmat_tpu_torch import accel
def init_engine(*a, **kw):
    calls.append("accel.init_engine")
    raise AssertionError("the client made an engine")
accel.init_engine = init_engine
from runmat_tpu_torch import client
res = client.run("A = magic(4); x = A \\ ones(4,1); disp(round(sum(x)*1e6)/1e6)")
assert res["ok"], res
wire = json.loads(client.handle_json(json.dumps(
    {"id": 1, "op": "accel_info"})))
card = client.engine_info()
print(json.dumps({"output": res["output"], "wire": wire, "card": card,
                  "calls": calls,
                  "initialized": torch.cuda.is_initialized(),
                  "engine": accel.active_engine() is None}))
"""


def test_the_profile_never_touches_the_card():
    r = subprocess.run([sys.executable, "-c", NO_CARD], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert "0.1176" in got["output"]
    assert got["wire"]["accel"] == {"available": False}
    assert got["card"]["profile"] == "client"
    assert got["calls"] == [] and got["initialized"] is False
    assert got["engine"] is True
