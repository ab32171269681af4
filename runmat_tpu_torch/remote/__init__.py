"""Copy of runmat_tpu/remote/__init__.py in the PyTorch port.

Remote project API: typed client + self-hostable server + auth store.

Reference parity: runmat-server-client (crates/runmat-server-client/src/
{auth,public_api}.rs) + the public spec (the reference's
openapi/runmat-public.yaml) — orgs, projects, remote project filesystem, snapshots,
history. The TPU build ships the same three pieces re-designed for a
zero-egress deployment:

  * `client.PublicApiClient`  — typed client over urllib (works against any
    server implementing openapi/runmat-tpu-public.yaml; localhost by default)
  * `server.ProjectServer`    — a complete reference implementation of the
    spec over a local directory, so teams can self-host project storage
    (`runmat-tpu remote serve <root>`)
  * `auth`                    — bearer-token credential store
    (~/.runmat_tpu/credentials.json; RUNMAT_TPU_API_TOKEN overrides)
"""

from .auth import login, logout, resolve_token     # noqa: F401
from .client import PublicApiClient                # noqa: F401
from .server import ProjectServer                  # noqa: F401
