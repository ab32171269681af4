"""The port's language server, held to the JAX package's.

Every test of `tests/test_lsp.py` runs with its message sequences sent to
both packages' `Server`s: `lsp_session` feeds the same framed messages to
the JAX package's server and to the port's, holds the port's replies equal
to the JAX package's, message for message, and returns the JAX package's,
so the test's own assertions read them. `diagnostics` and `format_source`
are paired the same way (the port's result equal to the JAX package's).
"""

import inspect
import io
import json

import pytest

import test_lsp
from runmat_tpu import lsp as jlsp
from runmat_tpu_torch import lsp as tlsp
from torch_paired import session_tests

NAMES = session_tests(test_lsp)


def _replies(server_class, messages) -> list:
    buf = io.BytesIO()
    for m in messages:
        body = json.dumps(m).encode()
        buf.write(f"Content-Length: {len(body)}\r\n\r\n".encode())
        buf.write(body)
    buf.seek(0)
    out = io.BytesIO()
    server_class(stdin=buf, stdout=out).serve()
    data = out.getvalue()
    results = []
    while data:
        head, _, rest = data.partition(b"\r\n\r\n")
        n = int(head.split(b":")[1])
        results.append(json.loads(rest[:n]))
        data = rest[n:]
    return results


class Count:
    sessions = 0


def paired_session(messages):
    want = _replies(jlsp.Server, messages)
    got = _replies(tlsp.Server, messages)
    assert got == want
    Count.sessions += 1
    return want


def _paired(name):
    jax_fn, port_fn = getattr(jlsp, name), getattr(tlsp, name)

    def call(*a, **kw):
        want = jax_fn(*a, **kw)
        assert port_fn(*a, **kw) == want
        Count.sessions += 1
        return want
    return call


@pytest.mark.parametrize("name", NAMES)
def test_the_lsp_tests_agree_through_both(request, monkeypatch, name):
    monkeypatch.setattr(test_lsp, "lsp_session", paired_session)
    monkeypatch.setattr(test_lsp, "diagnostics", _paired("diagnostics"))
    monkeypatch.setattr(jlsp, "format_source", _paired("format_source"))
    monkeypatch.setattr(Count, "sessions", 0)
    fn = getattr(test_lsp, name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})
    assert Count.sessions > 0, f"{name} drove no server"
