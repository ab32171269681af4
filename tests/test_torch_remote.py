"""The port's remote project API, held to the JAX package's wire protocol.

`tests/test_remote.py`'s cases run three ways, each with HOME at a
directory of its own:

* "port": against the port alone (`torch_ported.ported`): its
  `ProjectServer`, `PublicApiClient`, `RemoteFsProvider`, bearer-token
  store and command line's `remote` and `login`, a port session running a
  script read from the remote filesystem among them;
* "jax-client": the JAX package's test module with the port's
  `ProjectServer` in place of its own, so the JAX client, provider and
  command line talk to the port's server;
* "port-client": the ported module with the JAX package's `ProjectServer`,
  so the port's client talks to the JAX package's server.

Both packages speak openapi/runmat-tpu-public.yaml, so each pairing must
pass the JAX package's own assertions.
"""

import inspect

import pytest

import test_remote
from runmat_tpu.remote import ProjectServer as JaxServer
from runmat_tpu_torch.remote import ProjectServer as PortServer
from torch_paired import session_tests
from torch_ported import ported

NAMES = session_tests(test_remote)
# tests that start no server: run against the port only
NO_SERVER = ("test_cli_login_stores_token",)
PAIRINGS = ("port", "jax-client", "port-client")
CASES = [(p, n) for p in PAIRINGS for n in NAMES
         if p == "port" or n not in NO_SERVER]


def _module(pairing):
    if pairing == "jax-client":
        return test_remote, PortServer
    mod = ported(test_remote)
    return mod, (JaxServer if pairing == "port-client" else PortServer)


@pytest.mark.parametrize("pairing,name", CASES,
                         ids=[f"{p}::{n}" for p, n in CASES])
def test_the_remote_tests_hold(request, monkeypatch, tmp_path, pairing,
                               name):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("RUNMAT_TPU_API_TOKEN", raising=False)
    mod, server_class = _module(pairing)
    monkeypatch.setattr(mod, "ProjectServer", server_class)
    fn = getattr(mod, name)
    params = inspect.signature(fn).parameters
    kw, srv = {}, None
    if "server" in params or "client" in params:
        srv = server_class(str(tmp_path / "store")).start()
        request.addfinalizer(srv.stop)
        kw["server"] = srv
        kw["client"] = mod.PublicApiClient(srv.base_url, token="")
    for p in params:
        if p not in kw:
            kw[p] = request.getfixturevalue(p)
    fn(**{p: kw[p] for p in params})
