"""Copy of runmat_tpu/remote/client.py in the PyTorch port.

Typed client for the project API (≙ runmat-server-client/src/
public_api.rs over openapi/runmat-tpu-public.yaml).

urllib-based — no third-party HTTP stack; works against any server
implementing the spec (the bundled ProjectServer, or a hosted deployment)."""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request

from ..errors import MatError
from . import auth


class RemoteApiError(MatError):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(f"RunMat:remote:{code}", message)
        self.status = status


class PublicApiClient:
    def __init__(self, base_url: str, token: str | None = None,
                 timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.token = token if token is not None else \
            auth.resolve_token(self.base_url)
        self.timeout = timeout

    # ------------------------------------------------------------- transport

    def _request(self, method: str, path: str, query: dict | None = None,
                 body: dict | None = None, raw: bool = False):
        url = f"{self.base_url}{path}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read()).get("error", {})
            except Exception:
                err = {}
            raise RemoteApiError(e.code, err.get("code", "http_error"),
                                 err.get("message", str(e))) from None
        except urllib.error.URLError as e:
            raise RemoteApiError(0, "unreachable",
                                 f"cannot reach {self.base_url}: "
                                 f"{e.reason}") from None
        if raw:
            return payload
        return json.loads(payload) if payload else {}

    # ------------------------------------------------------------------ auth

    def me(self) -> dict:
        return self._request("GET", "/v1/auth/me")

    # ---------------------------------------------------------- orgs/projects

    def orgs(self) -> list:
        return self._request("GET", "/v1/orgs")["orgs"]

    def create_org(self, name: str) -> dict:
        return self._request("POST", "/v1/orgs", body={"name": name})

    def projects(self, org_id: str) -> list:
        return self._request("GET", f"/v1/orgs/{org_id}/projects")["projects"]

    def create_project(self, org_id: str, name: str) -> dict:
        return self._request("POST", f"/v1/orgs/{org_id}/projects",
                             body={"name": name})

    def project(self, project_id: str) -> dict:
        return self._request("GET", f"/v1/projects/{project_id}")

    def delete_project(self, project_id: str) -> None:
        self._request("DELETE", f"/v1/projects/{project_id}")

    # ------------------------------------------------------------ project fs

    def fs_dir(self, project_id: str, path: str = "") -> list:
        return self._request("GET", f"/v1/projects/{project_id}/fs/dir",
                             query={"path": path})["entries"]

    def fs_read(self, project_id: str, path: str) -> bytes:
        return self._request("GET", f"/v1/projects/{project_id}/fs/read",
                             query={"path": path}, raw=True)

    def fs_write(self, project_id: str, path: str, data: bytes,
                 append: bool = False) -> dict:
        return self._request(
            "POST", f"/v1/projects/{project_id}/fs/write",
            body={"path": path, "append": append,
                  "contentBase64": base64.b64encode(data).decode()})

    def fs_mkdir(self, project_id: str, path: str) -> None:
        self._request("POST", f"/v1/projects/{project_id}/fs/mkdir",
                      body={"path": path})

    def fs_rename(self, project_id: str, src: str, dst: str) -> None:
        self._request("POST", f"/v1/projects/{project_id}/fs/rename",
                      body={"src": src, "dst": dst})

    def fs_delete(self, project_id: str, path: str) -> None:
        self._request("POST", f"/v1/projects/{project_id}/fs/delete",
                      body={"path": path})

    def fs_metadata(self, project_id: str, path: str) -> dict:
        return self._request("GET",
                             f"/v1/projects/{project_id}/fs/metadata",
                             query={"path": path})

    # ------------------------------------------------------------- snapshots

    def snapshots(self, project_id: str) -> list:
        return self._request(
            "GET", f"/v1/projects/{project_id}/fs/snapshots")["snapshots"]

    def create_snapshot(self, project_id: str, label: str = "") -> dict:
        return self._request("POST",
                             f"/v1/projects/{project_id}/fs/snapshots",
                             body={"label": label})

    def snapshot(self, project_id: str, snap_id: str) -> dict:
        return self._request(
            "GET", f"/v1/projects/{project_id}/fs/snapshots/{snap_id}")

    def delete_snapshot(self, project_id: str, snap_id: str) -> None:
        self._request(
            "DELETE", f"/v1/projects/{project_id}/fs/snapshots/{snap_id}")

    def restore_snapshot(self, project_id: str, snap_id: str) -> None:
        self._request(
            "POST",
            f"/v1/projects/{project_id}/fs/snapshots/{snap_id}/restore")

    def snapshot_entries(self, project_id: str, snap_id: str) -> list:
        return self._request(
            "GET",
            f"/v1/projects/{project_id}/fs/snapshots/{snap_id}/entries"
        )["entries"]

    def tag_snapshot(self, project_id: str, snap_id: str, tag: str) -> dict:
        return self._request(
            "POST",
            f"/v1/projects/{project_id}/fs/snapshots/{snap_id}/tags",
            body={"tag": tag})

    # --------------------------------------------------------------- history

    def history(self, project_id: str, limit: int = 100) -> list:
        return self._request("GET", f"/v1/projects/{project_id}/history",
                             query={"limit": limit})["entries"]
