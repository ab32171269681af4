"""Copy of runmat_tpu/remote/server.py in the PyTorch port.

Self-hostable project server: reference implementation of
openapi/runmat-tpu-public.yaml over a local directory.

Reference parity: the api.runmat.com service behind
the reference's openapi/runmat-public.yaml (orgs / projects / project fs /
snapshots / history). Zero-egress design: the server binds localhost and
stores everything under one root directory —

    <root>/orgs.json                     org registry
    <root>/<orgId>/<projectId>/files/    the project filesystem
    <root>/<orgId>/<projectId>/.snapshots/<id>/   full-copy snapshots
    <root>/<orgId>/<projectId>/history.jsonl      mutation audit log
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class ApiError(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code
        self.message = message


class _Store:
    """Filesystem-backed model; every mutation appends to history.jsonl."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.lock = threading.Lock()

    # ------------------------------------------------------------------ orgs

    def _orgs_path(self) -> str:
        return os.path.join(self.root, "orgs.json")

    def _load_orgs(self) -> dict:
        try:
            with open(self._orgs_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"orgs": []}

    def _save_orgs(self, data: dict) -> None:
        with open(self._orgs_path(), "w") as f:
            json.dump(data, f, indent=1)

    def list_orgs(self) -> list:
        return self._load_orgs()["orgs"]

    def create_org(self, name: str) -> dict:
        if not name or "/" in name:
            raise ApiError(400, "invalid_name", "invalid org name")
        data = self._load_orgs()
        if any(o["name"] == name for o in data["orgs"]):
            raise ApiError(409, "exists", f"org '{name}' exists")
        org = {"id": f"org_{uuid.uuid4().hex[:10]}", "name": name,
               "createdAt": time.time()}
        data["orgs"].append(org)
        self._save_orgs(data)
        os.makedirs(os.path.join(self.root, org["id"]), exist_ok=True)
        return org

    def _org(self, org_id: str) -> dict:
        for o in self.list_orgs():
            if o["id"] == org_id:
                return o
        raise ApiError(404, "not_found", f"org {org_id} not found")

    # -------------------------------------------------------------- projects

    def list_projects(self, org_id: str) -> list:
        self._org(org_id)
        base = os.path.join(self.root, org_id)
        out = []
        for pid in sorted(os.listdir(base)) if os.path.isdir(base) else []:
            meta = os.path.join(base, pid, "project.json")
            if os.path.isfile(meta):
                with open(meta) as f:
                    out.append(json.load(f))
        return out

    def create_project(self, org_id: str, name: str) -> dict:
        self._org(org_id)
        if not name or "/" in name:
            raise ApiError(400, "invalid_name", "invalid project name")
        if any(p["name"] == name for p in self.list_projects(org_id)):
            raise ApiError(409, "exists", f"project '{name}' exists")
        proj = {"id": f"prj_{uuid.uuid4().hex[:10]}", "orgId": org_id,
                "name": name, "createdAt": time.time()}
        pdir = os.path.join(self.root, org_id, proj["id"])
        os.makedirs(os.path.join(pdir, "files"), exist_ok=True)
        with open(os.path.join(pdir, "project.json"), "w") as f:
            json.dump(proj, f)
        return proj

    def _project_dir(self, project_id: str) -> str:
        for org in self.list_orgs():
            cand = os.path.join(self.root, org["id"], project_id)
            if os.path.isfile(os.path.join(cand, "project.json")):
                return cand
        raise ApiError(404, "not_found", f"project {project_id} not found")

    def project(self, project_id: str) -> dict:
        with open(os.path.join(self._project_dir(project_id),
                               "project.json")) as f:
            return json.load(f)

    def delete_project(self, project_id: str) -> None:
        shutil.rmtree(self._project_dir(project_id))

    # ------------------------------------------------------------ project fs

    def _files_path(self, project_id: str, rel: str) -> str:
        base = os.path.join(self._project_dir(project_id), "files")
        p = os.path.normpath(os.path.join(base, rel.lstrip("/")))
        if not (p == base or p.startswith(base + os.sep)):
            raise ApiError(400, "path_escape", "path escapes project root")
        return p

    def _log(self, project_id: str, op: str, **attrs) -> None:
        rec = {"op": op, "ts": time.time(), **attrs}
        with open(os.path.join(self._project_dir(project_id),
                               "history.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def fs_dir(self, project_id: str, rel: str) -> list:
        p = self._files_path(project_id, rel)
        if not os.path.isdir(p):
            raise ApiError(404, "not_found", f"no such directory: {rel}")
        out = []
        for name in sorted(os.listdir(p)):
            st = os.stat(os.path.join(p, name))
            out.append({"name": name,
                        "isDir": os.path.isdir(os.path.join(p, name)),
                        "size": st.st_size, "mtime": st.st_mtime})
        return out

    def fs_read(self, project_id: str, rel: str) -> bytes:
        p = self._files_path(project_id, rel)
        if not os.path.isfile(p):
            raise ApiError(404, "not_found", f"no such file: {rel}")
        with open(p, "rb") as f:
            return f.read()

    def fs_write(self, project_id: str, rel: str, data: bytes,
                 append: bool = False) -> dict:
        p = self._files_path(project_id, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "ab" if append else "wb") as f:
            f.write(data)
        self._log(project_id, "write", path=rel, size=len(data))
        return {"path": rel, "size": os.path.getsize(p)}

    def fs_mkdir(self, project_id: str, rel: str) -> None:
        os.makedirs(self._files_path(project_id, rel), exist_ok=True)
        self._log(project_id, "mkdir", path=rel)

    def fs_rename(self, project_id: str, src: str, dst: str) -> None:
        sp = self._files_path(project_id, src)
        dp = self._files_path(project_id, dst)
        if not os.path.exists(sp):
            raise ApiError(404, "not_found", f"no such path: {src}")
        os.makedirs(os.path.dirname(dp), exist_ok=True)
        os.replace(sp, dp)
        self._log(project_id, "rename", src=src, dst=dst)

    def fs_delete(self, project_id: str, rel: str) -> None:
        p = self._files_path(project_id, rel)
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.isfile(p):
            os.remove(p)
        else:
            raise ApiError(404, "not_found", f"no such path: {rel}")
        self._log(project_id, "delete", path=rel)

    def fs_metadata(self, project_id: str, rel: str) -> dict:
        p = self._files_path(project_id, rel)
        if not os.path.exists(p):
            raise ApiError(404, "not_found", f"no such path: {rel}")
        st = os.stat(p)
        return {"path": rel, "isDir": os.path.isdir(p), "size": st.st_size,
                "mtime": st.st_mtime}

    # ------------------------------------------------------------- snapshots

    def _snap_dir(self, project_id: str) -> str:
        d = os.path.join(self._project_dir(project_id), ".snapshots")
        os.makedirs(d, exist_ok=True)
        return d

    def list_snapshots(self, project_id: str) -> list:
        d = self._snap_dir(project_id)
        out = []
        for sid in sorted(os.listdir(d)):
            meta = os.path.join(d, sid, "meta.json")
            if os.path.isfile(meta):
                with open(meta) as f:
                    out.append(json.load(f))
        return out

    def create_snapshot(self, project_id: str, label: str = "") -> dict:
        files = os.path.join(self._project_dir(project_id), "files")
        sid = f"snap_{uuid.uuid4().hex[:10]}"
        sdir = os.path.join(self._snap_dir(project_id), sid)
        shutil.copytree(files, os.path.join(sdir, "files"))
        n_files = sum(len(fs) for _, _, fs in os.walk(files))
        meta = {"id": sid, "label": label, "createdAt": time.time(),
                "fileCount": n_files, "tags": []}
        with open(os.path.join(sdir, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._log(project_id, "snapshot", id=sid, label=label)
        return meta

    def _snapshot(self, project_id: str, snap_id: str) -> str:
        sdir = os.path.join(self._snap_dir(project_id), snap_id)
        if not os.path.isfile(os.path.join(sdir, "meta.json")):
            raise ApiError(404, "not_found", f"snapshot {snap_id} not found")
        return sdir

    def snapshot_meta(self, project_id: str, snap_id: str) -> dict:
        with open(os.path.join(self._snapshot(project_id, snap_id),
                               "meta.json")) as f:
            return json.load(f)

    def delete_snapshot(self, project_id: str, snap_id: str) -> None:
        shutil.rmtree(self._snapshot(project_id, snap_id))
        self._log(project_id, "snapshot_delete", id=snap_id)

    def restore_snapshot(self, project_id: str, snap_id: str) -> None:
        sdir = self._snapshot(project_id, snap_id)
        files = os.path.join(self._project_dir(project_id), "files")
        shutil.rmtree(files)
        shutil.copytree(os.path.join(sdir, "files"), files)
        self._log(project_id, "restore", id=snap_id)

    def tag_snapshot(self, project_id: str, snap_id: str, tag: str) -> dict:
        sdir = self._snapshot(project_id, snap_id)
        meta = self.snapshot_meta(project_id, snap_id)
        if tag not in meta["tags"]:
            meta["tags"].append(tag)
        with open(os.path.join(sdir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return meta

    def snapshot_entries(self, project_id: str, snap_id: str) -> list:
        sdir = os.path.join(self._snapshot(project_id, snap_id), "files")
        out = []
        for dirpath, _, files in os.walk(sdir):
            for name in files:
                full = os.path.join(dirpath, name)
                out.append({"path": os.path.relpath(full, sdir),
                            "size": os.path.getsize(full)})
        return sorted(out, key=lambda e: e["path"])

    # --------------------------------------------------------------- history

    def history(self, project_id: str, limit: int = 100) -> list:
        path = os.path.join(self._project_dir(project_id), "history.jsonl")
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return []
        return [json.loads(ln) for ln in lines[-limit:]]


class _Handler(BaseHTTPRequestHandler):
    server_version = "runmat-tpu-project-server/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):   # quiet
        pass

    # -------------------------------------------------------------- plumbing

    def _json(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, status: int, data: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _auth(self) -> None:
        token = self.server.api_token
        if not token:
            return
        got = self.headers.get("Authorization", "")
        if got != f"Bearer {token}":
            raise ApiError(401, "unauthorized", "missing or invalid token")

    def _route(self, method: str) -> None:
        store: _Store = self.server.store
        # drain the request body FIRST: an early 401/404 on a keep-alive
        # connection must not leave unread body bytes to be parsed as the
        # client's next request
        self._raw_body = self._body()
        try:
            self._auth()
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            parts = [p for p in url.path.split("/") if p]
            if not parts or parts[0] != "v1":
                raise ApiError(404, "not_found", "unknown route")
            parts = parts[1:]
            with store.lock:
                self._dispatch(method, parts, q, store)
        except ApiError as e:
            self._json(e.status, {"error": {"code": e.code,
                                            "message": e.message}})
        except Exception as e:   # never crash the connection
            self._json(500, {"error": {"code": "internal",
                                       "message": str(e)}})

    def _dispatch(self, method, parts, q, store: _Store) -> None:
        body = self._raw_body
        payload = {}
        if body:
            try:
                payload = json.loads(body)
            except ValueError:
                payload = {}

        if parts == ["auth", "me"] and method == "GET":
            return self._json(200, {"user": "local",
                                    "authenticated": True})
        if parts == ["orgs"]:
            if method == "GET":
                return self._json(200, {"orgs": store.list_orgs()})
            if method == "POST":
                return self._json(201, store.create_org(payload.get("name")))
        if len(parts) == 3 and parts[0] == "orgs" and parts[2] == "projects":
            if method == "GET":
                return self._json(200,
                                  {"projects": store.list_projects(parts[1])})
            if method == "POST":
                return self._json(201, store.create_project(
                    parts[1], payload.get("name")))
        if len(parts) >= 2 and parts[0] == "projects":
            pid = parts[1]
            rest = parts[2:]
            if not rest:
                if method == "GET":
                    return self._json(200, store.project(pid))
                if method == "DELETE":
                    store.delete_project(pid)
                    return self._json(200, {"ok": True})
            if rest == ["history"] and method == "GET":
                return self._json(200, {"entries": store.history(
                    pid, int(q.get("limit", 100)))})
            if rest and rest[0] == "fs":
                return self._fs(method, pid, rest[1:], q, payload, store)
        raise ApiError(404, "not_found", "unknown route")

    def _fs(self, method, pid, rest, q, payload, store: _Store) -> None:
        path = q.get("path", payload.get("path", ""))
        if rest == ["dir"] and method == "GET":
            return self._json(200, {"entries": store.fs_dir(pid, path)})
        if rest == ["read"] and method == "GET":
            return self._bytes(200, store.fs_read(pid, path))
        if rest == ["write"] and method == "POST":
            data = self._raw_payload(payload)
            return self._json(200, store.fs_write(
                pid, path, data, append=bool(payload.get("append"))))
        if rest == ["mkdir"] and method == "POST":
            store.fs_mkdir(pid, path)
            return self._json(200, {"ok": True})
        if rest == ["rename"] and method == "POST":
            store.fs_rename(pid, payload.get("src"), payload.get("dst"))
            return self._json(200, {"ok": True})
        if rest == ["delete"] and method == "POST":
            store.fs_delete(pid, path)
            return self._json(200, {"ok": True})
        if rest == ["metadata"] and method == "GET":
            return self._json(200, store.fs_metadata(pid, path))
        if rest == ["snapshots"]:
            if method == "GET":
                return self._json(200,
                                  {"snapshots": store.list_snapshots(pid)})
            if method == "POST":
                return self._json(201, store.create_snapshot(
                    pid, payload.get("label", "")))
        if len(rest) == 2 and rest[0] == "snapshots":
            sid = rest[1]
            if method == "GET":
                return self._json(200, store.snapshot_meta(pid, sid))
            if method == "DELETE":
                store.delete_snapshot(pid, sid)
                return self._json(200, {"ok": True})
        if len(rest) == 3 and rest[0] == "snapshots":
            sid, action = rest[1], rest[2]
            if action == "restore" and method == "POST":
                store.restore_snapshot(pid, sid)
                return self._json(200, {"ok": True})
            if action == "entries" and method == "GET":
                return self._json(200, {"entries":
                                        store.snapshot_entries(pid, sid)})
            if action == "tags" and method == "POST":
                return self._json(200, store.tag_snapshot(
                    pid, sid, payload.get("tag", "")))
        raise ApiError(404, "not_found", "unknown fs route")

    @staticmethod
    def _raw_payload(payload: dict) -> bytes:
        import base64
        if "contentBase64" in payload:
            return base64.b64decode(payload["contentBase64"])
        return str(payload.get("content", "")).encode()

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


class ProjectServer:
    """`runmat-tpu remote serve <root>`: serve one directory as a project
    store. Binds localhost only (zero-egress deployment)."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None):
        self.store = _Store(root)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.store = self.store
        self.httpd.api_token = token
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = None

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ProjectServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()
