"""Copy of runmat_tpu/remote/auth.py in the PyTorch port.

Bearer-token credential store (≙ runmat-server-client/src/auth.rs).

Tokens live in ~/.runmat_tpu/credentials.json keyed by server base URL;
RUNMAT_TPU_API_TOKEN overrides everything (CI usage)."""

from __future__ import annotations

import json
import os


def _cred_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".runmat_tpu",
                        "credentials.json")


def _load() -> dict:
    try:
        with open(_cred_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save(data: dict) -> None:
    path = _cred_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    os.chmod(path, 0o600)


def login(base_url: str, token: str) -> None:
    data = _load()
    data[base_url.rstrip("/")] = {"token": token}
    _save(data)


def logout(base_url: str) -> None:
    data = _load()
    data.pop(base_url.rstrip("/"), None)
    _save(data)


def resolve_token(base_url: str) -> str | None:
    env = os.environ.get("RUNMAT_TPU_API_TOKEN")
    if env:
        return env
    ent = _load().get(base_url.rstrip("/"))
    return ent.get("token") if ent else None
