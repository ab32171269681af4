"""Copy of runmat_tpu/lsp.py in the PyTorch port.

Language server: stdio JSON-RPC (LSP 3.x subset).

Reference parity: runmat-lsp (crates/runmat-lsp/src/backend.rs — tower-lsp
server with diagnostics, completion, hover, document symbols). Implemented
against the LSP wire protocol directly; the analysis reuses the runtime's
parser/compiler (the `check` pipeline) and the builtin registry.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Any, Optional

from .errors import MatError


def _uri_to_path(uri: str) -> str:
    if uri.startswith("file://"):
        from urllib.parse import unquote, urlparse
        return unquote(urlparse(uri).path)
    return uri


def _path_to_uri(path: str) -> str:
    import pathlib
    return pathlib.Path(path).resolve().as_uri()


class WorkspaceIndex:
    """Workspace-wide symbol index (VERDICT r4 #8; ≙ runmat-lsp's
    workspace/analysis tier, runmat-lsp/src/core/{workspace,analysis}.rs).

    Walks the workspace root for .m files — including `+pkg` package
    directories, whose functions index under their QUALIFIED name through
    the same search-path convention the runtime resolver uses
    (runtime/packages.py) — and records every function/class definition
    with its location and parameter list. Open-document edits re-index
    just that file, so navigation stays live without a full rescan."""

    def __init__(self):
        self.defs: dict[str, dict] = {}      # name -> def record
        self.sources: dict[str, str] = {}    # uri -> text (disk snapshot)
        self.by_uri: dict[str, list[str]] = {}

    def build(self, root_uri: str) -> None:
        import os
        root = _uri_to_path(root_uri)
        if not os.path.isdir(root):
            return
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if not d.startswith(".")]
            for fn in filenames:
                if fn.endswith(".m"):
                    p = os.path.join(dirpath, fn)
                    try:
                        with open(p, encoding="utf-8",
                                  errors="replace") as f:
                            text = f.read()
                    except OSError:
                        continue
                    self.update(_path_to_uri(p), text, path=p, root=root)

    def _pkg_prefix(self, path: str, root: str) -> str:
        """'+pkg/+sub/f.m' -> 'pkg.sub.' (package-qualified names)."""
        import os
        parts = []
        d = os.path.dirname(os.path.relpath(path, root))
        for comp in d.split(os.sep):
            if comp.startswith("+"):
                parts.append(comp[1:])
        return ".".join(parts) + "." if parts else ""

    def update(self, uri: str, text: str, path: str = None,
               root: str = None) -> None:
        for name in self.by_uri.pop(uri, ()):
            if self.defs.get(name, {}).get("uri") == uri:
                del self.defs[name]
        self.sources[uri] = text
        prefix = self._pkg_prefix(path, root) if path and root else ""
        names = []
        try:
            from .frontend.parser import parse
            prog = parse(text, uri)
        except MatError:
            self.by_uri[uri] = names
            return
        for name, fd in prog.functions.items():
            q = prefix + name
            self.defs[q] = {"uri": uri, "line": fd.line, "kind": 12,
                            "name": q,
                            "params": list(getattr(fd, "params", []) or []),
                            "outs": list(getattr(fd, "outs", []) or [])}
            names.append(q)
        for name, cd in prog.classes.items():
            q = prefix + name
            self.defs[q] = {"uri": uri, "line": cd.line, "kind": 5,
                            "name": q, "params": [], "outs": []}
            names.append(q)
        self.by_uri[uri] = names

    def lookup(self, name: str):
        return self.defs.get(name)

    def query(self, q: str) -> list:
        ql = (q or "").lower()
        return [d for n, d in sorted(self.defs.items()) if ql in n.lower()]


class Server:
    def __init__(self, stdin=None, stdout=None):
        self.stdin = stdin or sys.stdin.buffer
        self.stdout = stdout or sys.stdout.buffer
        self.docs: dict[str, str] = {}
        self.workspace = WorkspaceIndex()
        self.running = True

    # -- wire ------------------------------------------------------------------

    def _read_message(self) -> Optional[dict]:
        headers = {}
        while True:
            line = self.stdin.readline()
            if not line:
                return None
            line = line.decode().strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0))
        body = self.stdin.read(n)
        return json.loads(body)

    def _send(self, msg: dict) -> None:
        body = json.dumps(msg).encode()
        self.stdout.write(f"Content-Length: {len(body)}\r\n\r\n".encode())
        self.stdout.write(body)
        self.stdout.flush()

    def _reply(self, req: dict, result: Any) -> None:
        self._send({"jsonrpc": "2.0", "id": req.get("id"), "result": result})

    def _notify(self, method: str, params: dict) -> None:
        self._send({"jsonrpc": "2.0", "method": method, "params": params})

    # -- main loop ---------------------------------------------------------------

    def serve(self) -> int:
        while self.running:
            msg = self._read_message()
            if msg is None:
                break
            self.handle(msg)
        return 0

    def handle(self, msg: dict) -> None:
        method = msg.get("method", "")
        params = msg.get("params", {}) or {}
        if method == "initialize":
            root = params.get("rootUri") or params.get("rootPath")
            folders = params.get("workspaceFolders") or []
            if not root and folders:
                root = folders[0].get("uri")
            if root:
                self.workspace.build(root)
            self._reply(msg, {
                "capabilities": {
                    "textDocumentSync": 1,     # full
                    "completionProvider": {"triggerCharacters": ["."]},
                    "hoverProvider": True,
                    "documentSymbolProvider": True,
                    "workspaceSymbolProvider": True,
                    "definitionProvider": True,
                    "referencesProvider": True,
                    "documentFormattingProvider": True,
                    "renameProvider": True,
                    "signatureHelpProvider": {
                        "triggerCharacters": ["(", ","]},
                    "semanticTokensProvider": {
                        "legend": {"tokenTypes": SEMANTIC_TOKEN_TYPES,
                                   "tokenModifiers": []},
                        "full": True,
                    },
                },
                "serverInfo": {"name": "runmat-tpu-lsp"},
            })
        elif method == "initialized":
            pass
        elif method == "shutdown":
            self._reply(msg, None)
        elif method == "exit":
            self.running = False
        elif method == "textDocument/didOpen":
            doc = params["textDocument"]
            self.docs[doc["uri"]] = doc["text"]
            self.workspace.update(doc["uri"], doc["text"])
            self._publish_diagnostics(doc["uri"])
        elif method == "textDocument/didChange":
            uri = params["textDocument"]["uri"]
            changes = params.get("contentChanges", [])
            if changes:
                self.docs[uri] = changes[-1]["text"]
                self.workspace.update(uri, changes[-1]["text"])
            self._publish_diagnostics(uri)
        elif method == "textDocument/didClose":
            self.docs.pop(params["textDocument"]["uri"], None)
        elif method == "textDocument/completion":
            self._reply(msg, self._completions(params))
        elif method == "textDocument/hover":
            self._reply(msg, self._hover(params))
        elif method == "textDocument/documentSymbol":
            self._reply(msg, self._symbols(params))
        elif method == "textDocument/definition":
            self._reply(msg, self._definition(params))
        elif method == "textDocument/references":
            self._reply(msg, self._references(params))
        elif method == "textDocument/semanticTokens/full":
            self._reply(msg, self._semantic_tokens(params))
        elif method == "textDocument/formatting":
            self._reply(msg, self._formatting(params))
        elif method == "textDocument/rename":
            self._reply(msg, self._rename(params))
        elif method == "textDocument/signatureHelp":
            self._reply(msg, self._signature_help(params))
        elif method == "workspace/symbol":
            self._reply(msg, self._workspace_symbols(params))
        elif "id" in msg:
            self._reply(msg, None)

    # -- features -----------------------------------------------------------------

    def _publish_diagnostics(self, uri: str) -> None:
        src = self.docs.get(uri, "")
        diags = diagnostics(src)
        self._notify("textDocument/publishDiagnostics",
                     {"uri": uri, "diagnostics": diags})

    def _completions(self, params: dict) -> list:
        from .runtime import registry
        registry.ensure_loaded()
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        src = self.docs.get(uri, "")
        prefix = _word_before(src, pos["line"], pos["character"])
        items = []
        for name, b in sorted(registry.all_builtins().items()):
            if name.startswith(prefix):
                items.append({"label": name, "kind": 3,     # Function
                              "detail": b.summary or b.category})
        # workspace-ish: identifiers in the document
        for w in sorted(set(re.findall(r"[A-Za-z_]\w*", src))):
            if w.startswith(prefix) and w != prefix and \
                    w not in registry.all_builtins():
                items.append({"label": w, "kind": 6})       # Variable
        return items[:200]

    def _hover(self, params: dict):
        from .runtime import registry
        registry.ensure_loaded()
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        src = self.docs.get(uri, "")
        word = _word_at(src, pos["line"], pos["character"])
        b = registry.lookup(word) if word else None
        if b is None:
            return None
        sig = f"{b.name} — {b.category}"
        doc = b.summary or (b.fn.__doc__ or "").strip().split("\n")[0]
        return {"contents": {"kind": "markdown",
                             "value": f"**{sig}**\n\n{doc}"}}

    def _symbols(self, params: dict) -> list:
        uri = params["textDocument"]["uri"]
        src = self.docs.get(uri, "")
        out = []
        try:
            from .frontend.parser import parse
            prog = parse(src, uri)
            for name, fd in prog.functions.items():
                out.append({"name": name, "kind": 12,   # Function
                            "location": {"uri": uri, "range": _line_range(fd.line)}})
            for name, cd in prog.classes.items():
                out.append({"name": name, "kind": 5,    # Class
                            "location": {"uri": uri, "range": _line_range(cd.line)}})
        except MatError:
            pass
        return out


    # -- definition / references / rename ------------------------------------
    # (≙ runmat-lsp goto-definition/references, runmat-lsp/src/backend.rs:6-8)

    def _ident_occurrences(self, src: str, word: str) -> list[dict]:
        """All IDENT-token occurrences of `word` (lexer-accurate: strings and
        comments never match)."""
        out = []
        try:
            from .frontend.lexer import tokenize
            toks = tokenize(src)
        except MatError:
            return out
        for t in toks:
            if t.kind == "IDENT" and t.text == word:
                out.append({"start": {"line": t.line - 1,
                                      "character": t.col - 1},
                            "end": {"line": t.line - 1,
                                    "character": t.col - 1 + len(word)}})
        return out

    def _definition(self, params: dict):
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        src = self.docs.get(uri, self.workspace.sources.get(uri, ""))
        word = _word_at(src, pos["line"], pos["character"])
        if not word:
            return None
        # function/class defined in this document
        try:
            from .frontend.parser import parse
            prog = parse(src, uri)
            fd = prog.functions.get(word)
            if fd is not None:
                return {"uri": uri, "range": _line_range(fd.line)}
            cd = prog.classes.get(word)
            if cd is not None:
                return {"uri": uri, "range": _line_range(cd.line)}
        except MatError:
            pass
        # cross-file: workspace index through the search-path convention,
        # both plain and package-qualified (pkg.fun at the cursor)
        qual = _qualified_word_at(src, pos["line"], pos["character"])
        for cand in (qual, word):
            d = self.workspace.lookup(cand) if cand else None
            if d is not None:
                return {"uri": d["uri"], "range": _line_range(d["line"])}
        # variable: first assignment occurrence (name = / name( / [.. name ..] =)
        occ = self._ident_occurrences(src, word)
        lines = src.splitlines()
        for r in occ:
            ln = r["start"]["line"]
            rest = lines[ln][r["end"]["character"]:] if ln < len(lines) else ""
            if re.match(r"\s*(\(.*\))?\s*=[^=]", rest):
                return {"uri": uri, "range": r}
        return ({"uri": uri, "range": occ[0]}) if occ else None

    def _all_sources(self, uri: str):
        """Every known document: open docs (live text wins) + the
        workspace's disk snapshots."""
        seen = dict(self.workspace.sources)
        seen.update(self.docs)
        if uri not in seen:
            seen[uri] = ""
        return seen

    def _references(self, params: dict) -> list:
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        src = self.docs.get(uri, self.workspace.sources.get(uri, ""))
        word = _word_at(src, pos["line"], pos["character"])
        if not word:
            return []
        out = []
        # workspace-wide when the name is a known cross-file symbol or a
        # function; plain local identifiers stay document-scoped
        cross = self.workspace.lookup(word) is not None
        for u, text in sorted(self._all_sources(uri).items()):
            if u != uri and not cross:
                continue
            for r in self._ident_occurrences(text, word):
                out.append({"uri": u, "range": r})
        return out

    def _rename(self, params: dict):
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        new = params.get("newName", "")
        src = self.docs.get(uri, self.workspace.sources.get(uri, ""))
        word = _word_at(src, pos["line"], pos["character"])
        if not word or not re.fullmatch(r"[A-Za-z_]\w*", new or ""):
            return None
        cross = self.workspace.lookup(word) is not None
        changes: dict = {}
        for u, text in self._all_sources(uri).items():
            if u != uri and not cross:
                continue
            edits = [{"range": r, "newText": new}
                     for r in self._ident_occurrences(text, word)]
            if edits:
                changes[u] = edits
        return {"changes": changes} if changes else None

    def _workspace_symbols(self, params: dict) -> list:
        q = params.get("query", "")
        return [{"name": d["name"], "kind": d["kind"],
                 "location": {"uri": d["uri"],
                              "range": _line_range(d["line"])}}
                for d in self.workspace.query(q)][:200]

    def _signature_help(self, params: dict):
        """Active call signature from builtin descriptors (name + arity
        from the registry) or the workspace index's parameter lists."""
        uri = params["textDocument"]["uri"]
        pos = params["position"]
        src = self.docs.get(uri, self.workspace.sources.get(uri, ""))
        lines = src.splitlines()
        if pos["line"] >= len(lines):
            return None
        line = lines[pos["line"]][:pos["character"]]
        # innermost unclosed call: scan left tracking paren depth
        depth = 0
        active = 0
        name = None
        for i in range(len(line) - 1, -1, -1):
            ch = line[i]
            if ch == ")":
                depth += 1
            elif ch == "(":
                if depth == 0:
                    m = re.search(r"([A-Za-z_]\w*(?:\.\w+)*)\s*$", line[:i])
                    if m:
                        name = m.group(1)
                    break
                depth -= 1
            elif ch == "," and depth == 0:
                active += 1
        if not name:
            return None
        d = self.workspace.lookup(name)
        if d is not None and d["params"]:
            label = f"{name}({', '.join(d['params'])})"
            pars = [{"label": p} for p in d["params"]]
            doc = ""
        else:
            from .runtime import registry
            registry.ensure_loaded()
            b = registry.lookup(name)
            if b is None:
                return None
            lo = getattr(b, "min_in", 0) or 0
            hi = getattr(b, "max_in", lo)
            if hi is None:
                args = [f"arg{i + 1}" for i in range(max(lo, 1))] + ["..."]
            else:
                args = [f"arg{i + 1}" for i in range(max(hi, lo))]
                for i in range(lo, len(args)):
                    args[i] = f"[{args[i]}]"
            label = f"{name}({', '.join(args)})"
            pars = [{"label": a} for a in args]
            doc = b.summary or ""
        return {"signatures": [{"label": label, "documentation": doc,
                                "parameters": pars}],
                "activeSignature": 0,
                "activeParameter": min(active, max(len(pars) - 1, 0))}

    # -- semantic tokens -------------------------------------------------------

    def _semantic_tokens(self, params: dict) -> dict:
        uri = params["textDocument"]["uri"]
        src = self.docs.get(uri, "")
        return {"data": semantic_tokens(src)}

    # -- formatting -----------------------------------------------------------

    def _formatting(self, params: dict) -> list:
        uri = params["textDocument"]["uri"]
        src = self.docs.get(uri, "")
        new = format_source(src)
        if new == src:
            return []
        lines = src.count("\n") + 1
        return [{"range": {"start": {"line": 0, "character": 0},
                           "end": {"line": lines, "character": 0}},
                 "newText": new}]


_SEV = {"error": 1, "warning": 2, "info": 3}

SEMANTIC_TOKEN_TYPES = ["keyword", "function", "variable", "number",
                        "string", "comment", "operator", "class"]
_ST = {n: i for i, n in enumerate(SEMANTIC_TOKEN_TYPES)}


def semantic_tokens(src: str) -> list[int]:
    """LSP semantic-tokens/full data: lexer-driven classification encoded as
    (deltaLine, deltaStart, length, type, 0) runs."""
    from .frontend.lexer import tokenize
    from .runtime import registry
    registry.ensure_loaded()
    try:
        toks = tokenize(src)
    except MatError:
        return []
    raw: list[tuple[int, int, int, int]] = []   # (line0, col0, len, type)
    defined: set[str] = set()
    try:
        from .frontend.parser import parse
        prog = parse(src, "<st>")
        defined = set(prog.functions) | set(prog.classes)
    except MatError:
        prog = None
    for t in toks:
        if t.kind == "KW":
            tt = _ST["keyword"]
        elif t.kind in ("NUM", "IMAG"):
            tt = _ST["number"]
        elif t.kind in ("STR", "DQSTR"):
            tt = _ST["string"]
        elif t.kind == "IDENT":
            if t.text in defined:
                tt = _ST["function"]
            elif registry.lookup(t.text) is not None:
                tt = _ST["function"]
            else:
                tt = _ST["variable"]
        elif t.kind == "OP":
            tt = _ST["operator"]
        else:
            continue
        ln = len(t.text) if t.kind not in ("STR", "DQSTR") else len(t.text) + 2
        raw.append((t.line - 1, t.col - 1, max(ln, 1), tt))
    # comments: not emitted by the lexer; detect '%' outside token spans
    tok_spans: dict[int, list[tuple[int, int]]] = {}
    for (l0, c0, ln, _) in raw:
        tok_spans.setdefault(l0, []).append((c0, c0 + ln))
    for i, line in enumerate(src.splitlines()):
        for m in re.finditer(r"%", line):
            c = m.start()
            if any(s <= c < e for s, e in tok_spans.get(i, [])):
                continue
            raw.append((i, c, len(line) - c, _ST["comment"]))
            break
    raw.sort()
    data: list[int] = []
    pl, pc = 0, 0
    for (l0, c0, ln, tt) in raw:
        dl = l0 - pl
        dc = c0 - pc if dl == 0 else c0
        data.extend([dl, dc, ln, tt, 0])
        pl, pc = l0, c0
    return data


_INDENT_OPEN = {"if", "for", "while", "switch", "function", "parfor", "try",
                "classdef", "methods", "properties", "events", "spmd",
                "arguments"}
_INDENT_MID = {"else", "elseif", "case", "otherwise", "catch"}


def format_source(src: str, indent: str = "    ") -> str:
    """Structure-aware re-indentation + trailing-whitespace cleanup (the
    formatting surface of runmat-lsp/src/core/formatting.rs). Token content
    is never altered — only leading/trailing whitespace. `end` inside
    subscripts (paren depth > 0) is not structural; switch/case follow the
    MATLAB editor convention (case bodies two levels under switch)."""
    from .frontend.lexer import tokenize
    out_lines = []
    depth = 0
    blocks: list[dict] = []         # {"kind": str, "seen_case": bool}
    cont = False                    # previous line ended with ...
    for line in src.splitlines():
        stripped = line.rstrip()
        body = stripped.strip()
        if not body:
            out_lines.append("")
            continue
        try:
            toks = [t for t in tokenize(body)
                    if t.kind not in ("NEWLINE", "EOF")]
        except MatError:
            toks = []
        first = toks[0] if toks else None
        # line indent: end/else/elseif/catch/case/otherwise dedent one level
        this_depth = depth
        if first is not None and first.kind == "KW" and not cont:
            if first.text == "end":
                d = 1
                if blocks and blocks[-1]["kind"] == "switch" and \
                        blocks[-1]["seen_case"]:
                    d = 2
                this_depth = max(0, depth - d)
            elif first.text in _INDENT_MID and first.text not in \
                    ("case", "otherwise"):
                this_depth = max(0, depth - 1)
            elif first.text in ("case", "otherwise"):
                sw = next((b for b in reversed(blocks)
                           if b["kind"] == "switch"), None)
                this_depth = max(0, depth - 1) if sw is not None and \
                    sw["seen_case"] else depth
        if cont:
            this_depth = depth + 1
        out_lines.append(indent * this_depth + body if this_depth else body)
        # update depth from this line's structural tokens
        pdepth = 0
        for t in toks:
            if t.kind == "OP":
                if t.text in ("(", "[", "{"):
                    pdepth += 1
                elif t.text in (")", "]", "}"):
                    pdepth = max(0, pdepth - 1)
                continue
            if t.kind != "KW" or pdepth:
                continue
            if t.text in _INDENT_OPEN:
                blocks.append({"kind": t.text, "seen_case": False})
                depth += 1
            elif t.text in ("case", "otherwise"):
                sw = next((b for b in reversed(blocks)
                           if b["kind"] == "switch"), None)
                if sw is not None:
                    if not sw["seen_case"]:
                        sw["seen_case"] = True
                        depth += 1
                    # subsequent cases: dedent+indent cancel out
            elif t.text == "end":
                if blocks:
                    b = blocks.pop()
                    depth = max(0, depth - (2 if b["kind"] == "switch"
                                            and b["seen_case"] else 1))
                else:
                    depth = max(0, depth - 1)
        cont = body.endswith("...")
    text = "\n".join(out_lines)
    if src.endswith("\n") and not text.endswith("\n"):
        text += "\n"
    return text


def diagnostics(src: str) -> list:
    """Parse+compile diagnostics + static lints (≙ runmat check /
    analyze_source, runmat-static-analysis/src/frontend.rs:137)."""
    from .frontend.parser import parse
    from .vm.compiler import Compiler
    try:
        prog = parse(src, "<lsp>")
        Compiler.compile_program(prog, "<lsp>")
    except MatError as e:
        line, col = _err_pos(e.message)
        return [{
            "range": {"start": {"line": line, "character": col},
                      "end": {"line": line, "character": col + 1}},
            "severity": 1,
            "source": "runmat-tpu",
            "message": f"{e.identifier}: {e.message}",
        }]
    from .analysis import analyze_source
    return [{
        "range": _line_range(f.line),
        "severity": _SEV.get(f.severity, 3),
        "source": "runmat-tpu",
        "message": f"{f.identifier}: {f.message}",
    } for f in analyze_source(src, "<lsp>")]


def _err_pos(msg: str) -> tuple:
    m = re.search(r":(\d+):(\d+)\)", msg)
    if m:
        return max(0, int(m.group(1)) - 1), max(0, int(m.group(2)) - 1)
    return 0, 0


def _line_range(line: int) -> dict:
    l0 = max(0, line - 1)
    return {"start": {"line": l0, "character": 0},
            "end": {"line": l0, "character": 1}}


def _word_before(src: str, line: int, ch: int) -> str:
    try:
        text = src.splitlines()[line][:ch]
    except IndexError:
        return ""
    m = re.search(r"[A-Za-z_]\w*$", text)
    return m.group(0) if m else ""


def _word_at(src: str, line: int, ch: int) -> str:
    try:
        text = src.splitlines()[line]
    except IndexError:
        return ""
    for m in re.finditer(r"[A-Za-z_]\w*", text):
        if m.start() <= ch <= m.end():
            return m.group(0)
    return ""


def _qualified_word_at(src: str, line: int, ch: int) -> str:
    """Dotted name covering the position (pkg.sub.fun for package calls)."""
    try:
        text = src.splitlines()[line]
    except IndexError:
        return ""
    for m in re.finditer(r"[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)*", text):
        if m.start() <= ch <= m.end():
            return m.group(0)
    return ""


def main() -> int:
    return Server().serve()


if __name__ == "__main__":
    sys.exit(main())
