"""Copy of runmat_tpu/client.py in the PyTorch port.

Client-side (embedded) engine profile: the full MATLAB language front
end — lexer → parser → HIR → bytecode → interpreter — with the numpy host
provider only, no device.

≙ reference runmat-wasm (crates/runmat-wasm/src/api/{init,session}.rs).
The JAX package's profile never imports jax, so it loads under Pyodide.
The port's package imports torch (its `__init__` imports the engine
module), and Pyodide has no torch, so the port cannot keep that invariant;
`scripts/build_client_wheel.py` stays the JAX package's. What the port's
profile keeps instead: it never initialises CUDA and never makes an engine
(`torch.cuda.is_initialized()` stays false and `accel.active_engine()`
stays None; tests/test_torch_client.py).

Two embedding surfaces:

* Python API: ``create_session()`` → a ``Session`` pinned to the host
  provider; drive it with ``.execute(source)``.
* Wire API: ``handle_json(line)`` — the SAME JSON-lines op protocol the
  session server speaks (server.py: execute/workspace/get/figures/...), so
  a TS host reuses one protocol across its transports.

Device gates in the VM see no engine and take the host path.
"""

from __future__ import annotations

import json
from typing import Optional

_SESSION = None


def create_session(fresh: bool = False):
    """A host-only Session (numpy provider, no engine, no CUDA).

    The singleton mirrors the wasm module-instance model (one engine per
    page); pass fresh=True for an independent workspace.
    """
    global _SESSION
    from .session import Session
    if fresh:
        return Session(accelerate=False)
    if _SESSION is None:
        _SESSION = Session(accelerate=False)
    return _SESSION


def run(source: str) -> dict:
    """One-shot execute for pyodide.runPython-style hosts: returns a plain
    dict (JSON-safe) with ok/output/error."""
    r = create_session().execute(source)
    out = {"ok": r.ok, "output": r.output,
           "wall_ms": round(r.wall_time * 1000, 3)}
    if r.error is not None:
        out["error"] = {"identifier": r.error.identifier,
                        "message": r.error.message}
    return out


def handle_json(line: str) -> str:
    """The server's JSON-lines protocol, client-side: one request object
    in, one response object out. The TS package calls this through
    Pyodide so `createLocalSession()` and `connect()` share the exact op
    surface (execute/workspace/get/hover/builtins/check/figures/...)."""
    from .server import handle_request
    try:
        req = json.loads(line)
    except json.JSONDecodeError as e:
        return json.dumps({"id": None, "ok": False,
                           "error": {"identifier": "RunMat:client:BadJson",
                                     "message": str(e)}})
    return json.dumps(handle_request(create_session(), req), default=str)


def engine_info() -> dict:
    """Capability card for hosts (≙ runmat-wasm init.rs handshake)."""
    import numpy
    import sys
    from .runtime import registry
    registry.ensure_loaded()
    return {
        "profile": "client",
        "accelerate": False,
        "python": sys.version.split()[0],
        "numpy": numpy.__version__,
        "builtins": len(registry.all_builtins()),
        "wasm": sys.platform == "emscripten",
    }


def main(argv: Optional[list] = None) -> int:
    """``python -m runmat_tpu_torch.client [script.m]`` — run a script or
    serve the JSON-lines protocol on stdio, never touching the card. This
    is also the node fallback transport for createLocalSession() when the
    host has Python but no browser."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    sess = create_session()
    if argv and not argv[0].startswith("-"):
        sess.run_file(argv[0])
        return 0
    if argv[:1] == ["-e"] and len(argv) > 1:
        r = sess.execute(argv[1])
        if r.output:
            sys.stdout.write(r.output)
        if r.error is not None:
            sys.stderr.write(f"{r.error.identifier}: {r.error.message}\n")
            return 1
        return 0
    from .server import handle_request
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        resp = json.loads(handle_json(line))
        sys.stdout.write(json.dumps(resp, default=str) + "\n")
        sys.stdout.flush()
        if resp.get("shutdown"):
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
