"""Copy of runmat_tpu/fs.py in the PyTorch port.

Filesystem provider abstraction.

Reference parity: runmat-filesystem (crates/runmat-filesystem/src/lib.rs:11-31)
— an FS provider trait with Native / Memory / Sandbox implementations so hosts
can run the runtime against a virtual or restricted filesystem (the reference
additionally ships Remote and Wasm providers over the same trait; the remote
transport is out of scope in a zero-egress build and raises a clear error).

The active provider is process-global (set_fs_provider) and io builtins route
file access through `fs()`. The Native provider is the default and is a thin
passthrough; Memory keeps a dict of bytes; Sandbox wraps another provider and
refuses paths outside its root.
"""

from __future__ import annotations

import io
import os
import time
from typing import Optional

from .errors import MatError


class NativeFsProvider:
    """Direct OS filesystem access (≙ NativeFsProvider, runmat-filesystem)."""

    name = "native"

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes, append: bool = False) -> None:
        with open(path, "ab" if append else "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def is_file(self, path: str) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> list[str]:
        return sorted(os.listdir(path))

    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(path)

    def rmdir(self, path: str, recursive: bool = False) -> None:
        if recursive:
            import shutil
            shutil.rmtree(path)
        else:
            os.rmdir(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def copy(self, src: str, dst: str) -> None:
        import shutil
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)

    def stat(self, path: str) -> dict:
        st = os.stat(path)
        return {"size": st.st_size, "mtime": st.st_mtime,
                "isdir": os.path.isdir(path),
                "writable": os.access(path, os.W_OK)}

    def open(self, path: str, mode: str):
        return open(path, mode)


class MemoryFsProvider:
    """In-memory filesystem (≙ MemoryFsProvider): a dict of path -> bytes.
    Directories are implicit (any prefix of a stored path)."""

    name = "memory"

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.mtimes: dict[str, float] = {}

    def _norm(self, path: str) -> str:
        return os.path.normpath("/" + path.lstrip("/"))

    def read_bytes(self, path: str) -> bytes:
        p = self._norm(path)
        if p not in self.files:
            raise FileNotFoundError(path)
        return self.files[p]

    def write_bytes(self, path: str, data: bytes, append: bool = False) -> None:
        p = self._norm(path)
        if append and p in self.files:
            self.files[p] += data
        else:
            self.files[p] = data
        self.mtimes[p] = time.time()

    def exists(self, path: str) -> bool:
        p = self._norm(path)
        return p in self.files or self.is_dir(path)

    def is_file(self, path: str) -> bool:
        return self._norm(path) in self.files

    def is_dir(self, path: str) -> bool:
        p = self._norm(path).rstrip("/") + "/"
        if p == "//":
            return True
        return any(k.startswith(p) for k in self.files)

    def listdir(self, path: str) -> list[str]:
        p = self._norm(path).rstrip("/") + "/"
        if p == "//":
            p = "/"
        out = set()
        for k in self.files:
            if k.startswith(p):
                rest = k[len(p):]
                out.add(rest.split("/", 1)[0])
        return sorted(out)

    def mkdir(self, path: str) -> None:
        pass  # directories are implicit

    def remove(self, path: str) -> None:
        p = self._norm(path)
        if p not in self.files:
            raise FileNotFoundError(path)
        del self.files[p]
        self.mtimes.pop(p, None)

    def rmdir(self, path: str, recursive: bool = False) -> None:
        p = self._norm(path).rstrip("/") + "/"
        victims = [k for k in self.files if k.startswith(p)]
        if victims and not recursive:
            raise OSError(f"Directory not empty: {path}")
        for k in victims:
            del self.files[k]

    def rename(self, src: str, dst: str) -> None:
        s, d = self._norm(src), self._norm(dst)
        if s in self.files:
            self.files[d] = self.files.pop(s)
            self.mtimes[d] = self.mtimes.pop(s, time.time())
            return
        sp = s.rstrip("/") + "/"
        for k in list(self.files):
            if k.startswith(sp):
                self.files[d + "/" + k[len(sp):]] = self.files.pop(k)

    def copy(self, src: str, dst: str) -> None:
        s = self._norm(src)
        if s in self.files:
            self.write_bytes(dst, self.files[s])
            return
        sp = s.rstrip("/") + "/"
        for k in list(self.files):
            if k.startswith(sp):
                self.write_bytes(self._norm(dst) + "/" + k[len(sp):], self.files[k])

    def stat(self, path: str) -> dict:
        p = self._norm(path)
        if p in self.files:
            return {"size": len(self.files[p]), "mtime": self.mtimes.get(p, 0.0),
                    "isdir": False, "writable": True}
        if self.is_dir(path):
            return {"size": 0, "mtime": 0.0, "isdir": True, "writable": True}
        raise FileNotFoundError(path)

    def open(self, path: str, mode: str):
        p = self._norm(path)
        if "r" in mode and p not in self.files:
            raise FileNotFoundError(path)
        binary = "b" in mode
        if "r" in mode:
            raw = self.files[p]
            return io.BytesIO(raw) if binary else io.StringIO(raw.decode("utf-8"))
        # write modes: return a buffer that flushes back on close
        provider = self

        class _W(io.BytesIO if binary else io.StringIO):
            def close(inner):
                data = inner.getvalue()
                provider.write_bytes(p, data if binary else data.encode("utf-8"),
                                     append="a" in mode)
                super().close()

        w = _W()
        if "a" in mode and p in self.files:
            pass  # append handled at flush
        return w


class SandboxFsProvider:
    """Path-restricting wrapper (≙ SandboxFsProvider): refuses any access
    outside `root`."""

    name = "sandbox"

    def __init__(self, root: str, inner=None):
        self.root = os.path.realpath(root)
        self.inner = inner or NativeFsProvider()

    def _check(self, path: str) -> str:
        rp = os.path.realpath(os.path.join(self.root, path) if not os.path.isabs(path)
                              else path)
        if not (rp == self.root or rp.startswith(self.root + os.sep)):
            raise MatError("RunMat:fs:SandboxViolation",
                           f"Path '{path}' is outside the sandbox root.")
        return rp

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def wrapped(path, *args, **kw):
            if name in ("rename", "copy"):
                return fn(self._check(path), self._check(args[0]), *args[1:], **kw)
            return fn(self._check(path), *args, **kw)

        return wrapped


class RemoteFsProvider:
    """Remote project filesystem over the public API (≙ RemoteFsProvider,
    runmat-filesystem/src/remote/native.rs + runmat-server-client). Backed by
    runmat_tpu.remote.PublicApiClient against any server implementing
    openapi/runmat-tpu-public.yaml (e.g. the bundled self-hosted
    ProjectServer on localhost — zero-egress deployments)."""

    name = "remote"

    def __init__(self, base_url: str, project_id: str,
                 token: Optional[str] = None):
        from .remote import PublicApiClient
        self.client = PublicApiClient(base_url, token)
        self.project_id = project_id

    def read_bytes(self, path: str) -> bytes:
        return self.client.fs_read(self.project_id, path)

    def write_bytes(self, path: str, data: bytes,
                    append: bool = False) -> None:
        self.client.fs_write(self.project_id, path, data, append=append)

    def exists(self, path: str) -> bool:
        try:
            self.client.fs_metadata(self.project_id, path)
            return True
        except MatError:
            return False

    def is_file(self, path: str) -> bool:
        try:
            return not self.client.fs_metadata(self.project_id,
                                               path)["isDir"]
        except MatError:
            return False

    def is_dir(self, path: str) -> bool:
        try:
            return bool(self.client.fs_metadata(self.project_id,
                                                path)["isDir"])
        except MatError:
            return False

    def listdir(self, path: str) -> list:
        return [e["name"] for e in self.client.fs_dir(self.project_id, path)]

    def mkdir(self, path: str) -> None:
        self.client.fs_mkdir(self.project_id, path)

    def remove(self, path: str) -> None:
        self.client.fs_delete(self.project_id, path)

    def rmdir(self, path: str, recursive: bool = False) -> None:
        self.client.fs_delete(self.project_id, path)

    def rename(self, src: str, dst: str) -> None:
        self.client.fs_rename(self.project_id, src, dst)

    def copy(self, src: str, dst: str) -> None:
        self.write_bytes(dst, self.read_bytes(src))

    def stat(self, path: str) -> dict:
        md = self.client.fs_metadata(self.project_id, path)
        return {"size": md["size"], "mtime": md["mtime"],
                "isdir": md["isDir"], "writable": True}

    def open(self, path: str, mode: str):
        import io
        binary = "b" in mode
        if "r" in mode:
            data = self.read_bytes(path)
            return io.BytesIO(data) if binary else \
                io.StringIO(data.decode("utf-8", "replace"))
        provider = self

        class _W(io.BytesIO if binary else io.StringIO):
            def close(_self):
                buf = _self.getvalue()
                provider.write_bytes(path,
                                     buf if binary else buf.encode(),
                                     append="a" in mode)
                super(_W, _self).close()
        return _W()


_ACTIVE: list = [NativeFsProvider()]


def fs():
    """The active filesystem provider."""
    return _ACTIVE[0]


def set_fs_provider(provider) -> None:
    _ACTIVE[0] = provider


def reset_fs_provider() -> None:
    _ACTIVE[0] = NativeFsProvider()
