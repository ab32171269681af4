"""Copy of runmat_tpu/server.py in the PyTorch port.

Session server: the execute_request ABI over JSON lines (stdio or TCP).

Reference parity: runmat-core's `execute_request(ExecutionRequest) ->
ExecutionResponse` host ABI (crates/runmat-core/src/session/run.rs:330) plus
the wasm/TS host transport (crates/runmat-wasm/src/api/session.rs,
bindings/ts) and the remote-execution surface (runmat-server-client +
openapi/runmat-public.yaml). One protocol serves all hosts: each request is
one JSON object per line; each response is one JSON object per line.

Request:
  {"id": 1, "op": "execute", "source": "x = 1 + 1"}
  {"id": 2, "op": "workspace"}               — variable names + previews
  {"id": 3, "op": "get", "name": "x"}        — full value of one variable
  {"id": 4, "op": "accel_info"}              — provider telemetry snapshot
  {"id": 5, "op": "reset"}                   — clear the workspace
  {"id": 6, "op": "shutdown"}

Response:
  {"id": 1, "ok": true, "output": "...", "wall_ms": 1.2}
  {"id": 1, "ok": false, "error": {"identifier": "...", "message": "..."}}

In the port, `accel_info` reports the active `TorchEngine` (its platform,
`stats`, the card it runs on) and the launch counts of the hand-written
and generated kernels since the process started (`ops.launch_counts`).
The session takes the card unless the command line's `--no-accel` asks
for the host.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def _preview(v) -> dict:
    from .values import MatArray, CellArray, StringArray, StructArray, class_name
    d: dict = {"class": class_name(v)}
    shape = getattr(v, "shape", None)
    if shape is not None:
        d["size"] = list(shape)
    if isinstance(v, MatArray) and not v.on_device and v.size <= 16 and \
            v.mclass != "char":
        h = v.host()
        d["value"] = np.real(h).astype(float).tolist()
    if isinstance(v, MatArray) and v.mclass == "char":
        d["value"] = v.to_str()
    if isinstance(v, MatArray):
        d["on_device"] = bool(v.on_device)
    return d


def _full_value(v) -> dict:
    from .values import MatArray, StringArray, class_name
    if isinstance(v, MatArray):
        h = v.host()
        out = {"class": class_name(v), "size": list(v.shape)}
        if v.mclass == "char":
            out["value"] = v.to_str()
        elif h.dtype.kind == "c":
            out["real"] = np.real(h).tolist()
            out["imag"] = np.imag(h).tolist()
        else:
            out["value"] = h.astype(float).tolist()
        return out
    if isinstance(v, StringArray):
        return {"class": "string", "size": list(v.shape),
                "value": [s for s in v.data.reshape(-1, order="F")]}
    return {"class": type(v).__name__}


def handle_request(sess, req: dict) -> dict:
    rid = req.get("id")
    op = req.get("op", "execute")
    try:
        if op == "execute":
            r = sess.execute(req.get("source", ""), req.get("name", "<remote>"))
            if r.error is not None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": r.error.identifier,
                                  "message": r.error.message},
                        "output": r.output}
            return {"id": rid, "ok": True, "output": r.output,
                    "wall_ms": round(r.wall_time * 1000, 3)}
        if op == "execute_abi":
            # typed execution protocol (≙ runmat-core execute_request ABI,
            # run.rs:330-385): ordered streams, display events, workspace
            # delta, warnings, figures touched, engine dispatch deltas
            outcome = sess.execute_request(req.get("source", ""),
                                           req.get("name", "<remote>"))
            return {"id": rid, "ok": outcome.ok, **outcome.to_dict()}
        if op == "workspace":
            names = sess.workspace_names()
            return {"id": rid, "ok": True,
                    "workspace": {n: _preview(sess.get(n)) for n in names}}
        if op == "get":
            v = sess.get(req.get("name", ""))
            if v is None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": "RunMat:server:NoVariable",
                                  "message": f"No variable '{req.get('name')}'."}}
            return {"id": rid, "ok": True, "value": _full_value(v)}
        if op == "accel_info":
            from .accel import active_engine
            eng = active_engine()
            info = {"available": eng is not None}
            if eng is not None:
                from .ops import launch_counts
                info.update({"platform": eng.platform, "stats": dict(eng.stats),
                             "card": eng.device_info(),
                             "launches": launch_counts()})
            return {"id": rid, "ok": True, "accel": info}
        if op == "fusion_plans":
            from .accel import active_engine
            eng = active_engine()
            return {"id": rid, "ok": True,
                    "plans": eng.fusion_snapshot() if eng is not None else []}
        if op == "hover":
            # workspace hover card (≙ bindings/ts/src/workspace-hover.ts):
            # class/shape/residency + a short value preview + HBM bytes
            name = req.get("name", "")
            v = sess.get(name)
            if v is None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": "RunMat:server:NoVariable",
                                  "message": f"No variable '{name}'."}}
            card = _preview(v)
            card["name"] = name
            from .values import MatArray
            if isinstance(v, MatArray):
                if v.on_device and v.dev.value is not None:
                    card["device_bytes"] = int(
                        getattr(v.dev.value, "nbytes", 0) or 0)
                from .utils.display import format_value
                text = format_value(name, v)
                lines = text.splitlines()
                card["preview"] = "\n".join(lines[:8])
            return {"id": rid, "ok": True, "hover": card}
        if op == "builtins":
            # registered builtin catalog with full spec metadata
            # (≙ bindings/ts/src/builtins.ts typed registry)
            from .runtime import registry
            registry.ensure_loaded()
            q = req.get("query", "")

            def entry(nm, b):
                summary = b.summary
                if not summary and b.fn.__doc__:
                    summary = b.fn.__doc__.strip().splitlines()[0]
                return {"name": nm, "category": b.category,
                        "summary": summary[:200],
                        "min_in": b.min_in, "max_in": b.max_in,
                        "max_out": b.max_out,
                        "accel": bool(b.accel_op), "sink": b.is_sink,
                        "extension": b.extension}

            items = [entry(nm, b)
                     for nm, b in registry.all_builtins().items()
                     if not q or q.lower() in nm.lower()]
            items.sort(key=lambda d: d["name"])
            return {"id": rid, "ok": True, "builtins": items[:500],
                    "total": len(items)}
        if op == "check":
            from .analysis import analyze_source
            findings = analyze_source(req.get("source", ""),
                                      req.get("name", "<remote>"))
            return {"id": rid, "ok": True, "findings": [
                {"line": f.line, "severity": f.severity,
                 "identifier": f.identifier, "message": f.message}
                for f in findings]}
        if op == "telemetry":
            from . import telemetry
            return {"id": rid, "ok": True,
                    "telemetry": json.loads(json.dumps(
                        telemetry.snapshot(sess), default=str))}
        if op == "figures":
            # open figures rendered to SVG (the interactive GUI transport:
            # the browser host pans/zooms client-side — ≙ runmat-plot's
            # winit/egui window, re-homed to the web host). 3-D figures
            # carry is3d + az/el so the client can orbit them.
            return {"id": rid, "ok": True, "figures": _render_figures(),
                    "rev": _scene_rev()}
        if op == "figures_wait":
            # long-poll for live figure updates (server-push analog,
            # ≙ the GUI redraw loop): returns when the scene revision
            # moves past the client's, or on timeout.
            import time as _time
            client_rev = int(req.get("rev", -1))
            deadline = _time.monotonic() + min(float(req.get("timeout", 25)),
                                               25.0)
            while _scene_rev() == client_rev and _time.monotonic() < deadline:
                _time.sleep(0.05)
            changed = _scene_rev() != client_rev
            out = {"id": rid, "ok": True, "rev": _scene_rev(),
                   "changed": changed}
            if changed:
                out["figures"] = _render_figures()
            return out
        if op == "figure_webgl":
            # typed-geometry scene for client-side WebGL rendering: the
            # browser gets vertex/index buffers once and orbits locally
            # with zero server round trips per frame (≙ runmat-plot's GPU
            # scene graph consumed by wgpu pipelines,
            # crates/runmat-plot/src/gpu/*.rs — re-homed to the client GPU)
            from .plot import figure as figmod
            from .plot.webgl import export_scene
            num = int(req.get("fig", 0))
            f = figmod._FIGURES.get(num)
            if f is None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": "RunMat:server:NoSuchFigure",
                                  "message": f"No figure {num}."}}
            return {"id": rid, "ok": True, "num": num,
                    "scene": export_scene(f)}
        if op == "view":
            # 3-D camera orbit: update az/el and return the re-rendered
            # scene for that figure (≙ runmat-plot GUI camera controller)
            from .plot import figure as figmod
            from .plot.svg import render_svg
            num = int(req.get("fig", 0))
            f = figmod._FIGURES.get(num)
            if f is None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": "RunMat:server:NoSuchFigure",
                                  "message": f"No figure {num}."}}
            az = float(req.get("az", f.ax.view[0]))
            el = float(req.get("el", f.ax.view[1]))
            el = max(-90.0, min(90.0, el))
            for ax in f.axes:
                ax.view = (az, el)
            figmod.bump_rev()
            # draft=true while the mouse is down: surfaces render a
            # decimated proxy (≙ runmat-plot's GPU orbit redraw staying
            # interactive by re-using device vertex buffers; here the
            # cheap path is fewer faces, with a full-fidelity render
            # following on mouseup)
            draft = bool(req.get("draft", False))
            if req.get("nosvg"):
                # camera-sync only (the WebGL client renders locally;
                # keeping the server camera in step makes PNG/SVG exports
                # and probes match what the user sees)
                return {"id": rid, "ok": True, "num": num, "az": az,
                        "el": el}
            return {"id": rid, "ok": True, "num": num, "az": az, "el": el,
                    "svg": render_svg(f, draft=draft)}
        if op == "probe":
            # data cursor: nearest data vertex to a figure-fraction point
            from .plot import figure as figmod
            from .plot.svg import probe_figure
            num = int(req.get("fig", 0))
            f = figmod._FIGURES.get(num)
            if f is None:
                return {"id": rid, "ok": False,
                        "error": {"identifier": "RunMat:server:NoSuchFigure",
                                  "message": f"No figure {num}."}}
            hit = probe_figure(f, float(req.get("fx", 0.5)),
                               float(req.get("fy", 0.5)))
            return {"id": rid, "ok": True, "hit": hit}
        if op == "reset":
            sess.clear()
            return {"id": rid, "ok": True}
        if op == "shutdown":
            return {"id": rid, "ok": True, "shutdown": True}
        return {"id": rid, "ok": False,
                "error": {"identifier": "RunMat:server:UnknownOp",
                          "message": f"Unknown op '{op}'."}}
    except Exception as e:  # never kill the server on a request
        ident = getattr(e, "identifier", "RunMat:server:InternalError")
        return {"id": rid, "ok": False,
                "error": {"identifier": ident, "message": str(e)}}


def _scene_rev() -> int:
    from .plot import figure as figmod
    return figmod.scene_rev()


def _render_figures() -> list:
    from .plot import figure as figmod
    from .plot.svg import render_svg
    figs = []
    for num in sorted(figmod._FIGURES):
        f = figmod._FIGURES[num]
        try:
            is3d = any(ax.is3d for ax in f.axes)
            figs.append({"num": num, "svg": render_svg(f),
                         "is3d": is3d, "webgl": is3d,
                         "view": list(f.ax.view), "size": list(f.size)})
        except Exception:
            pass
    return figs


def serve_stdio(sess) -> int:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            sys.stdout.write(json.dumps({
                "id": None, "ok": False,
                "error": {"identifier": "RunMat:server:BadJson",
                          "message": str(e)}}) + "\n")
            sys.stdout.flush()
            continue
        resp = handle_request(sess, req)
        sys.stdout.write(json.dumps(resp) + "\n")
        sys.stdout.flush()
        if resp.get("shutdown"):
            break
    return 0


def host_header_ok(hdr: str, host: str) -> bool:
    """Anti-DNS-rebinding Host-header check: accept only local names (or
    the bound host). urlsplit handles bracketed IPv6 with or without a
    port — a naive rsplit(":") mangles a portless "[::1]" into ":"."""
    try:
        from urllib.parse import urlsplit
        h = (urlsplit("//" + (hdr or "")).hostname or "").lower()
    except ValueError:
        return False
    return h in ("localhost", "127.0.0.1", "::1", host.lower())


def serve_http(sess, host: str, port: int, token: str = None) -> int:
    """HTTP bridge + in-browser REPL: the accelerator-side answer to the
    reference's wasm embedding (crates/runmat-wasm + bindings/ts). A browser
    cannot host a card, so instead of compiling the runtime to wasm the
    session stays server-side (next to the card) and the browser gets a
    single-page REPL speaking the same request ABI over POST /api.
    GET / serves the page; binds localhost.

    Security: 'execute' can run arbitrary code (incl. the system() builtin),
    so the bridge is locked down against drive-by requests from web pages:
    a per-session random token is required on every request (query param on
    GET /, X-Runmat-Token header on /api), the Host header must be local
    (defeats DNS rebinding), cross-site Origin headers are rejected, and
    /api requires Content-Type: application/json (forces a CORS preflight,
    which we never answer)."""
    import secrets
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()
    if token is None:
        token = secrets.token_urlsafe(24)
    page = _repl_page()

    def _host_ok(hdr):
        return host_header_ok(hdr, host)

    def _origin_ok(hdr):
        if not hdr:          # same-origin fetches and curl omit Origin
            return True
        try:
            from urllib.parse import urlsplit
            return _host_ok(urlsplit(hdr).netloc)
        except ValueError:
            return False

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, status, body, ctype):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _guard(self, supplied_token):
            if not _host_ok(self.headers.get("Host")):
                self._send(403, b"forbidden: bad host", "text/plain")
                return False
            if not _origin_ok(self.headers.get("Origin")):
                self._send(403, b"forbidden: bad origin", "text/plain")
                return False
            if not (supplied_token and secrets.compare_digest(supplied_token, token)):
                self._send(403, b"forbidden: bad token", "text/plain")
                return False
            return True

        def do_GET(self):
            from urllib.parse import parse_qs, urlsplit
            parts = urlsplit(self.path)
            if parts.path in ("/", "/index.html"):
                q = parse_qs(parts.query).get("token", [""])[0]
                if not self._guard(q):
                    return
                self._send(200, page, "text/html; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/api":
                return self._send(404, b"not found", "text/plain")
            if not self._guard(self.headers.get("X-Runmat-Token")):
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype != "application/json":
                return self._send(415, b'{"ok":false}', "application/json")
            n = int(self.headers.get("Content-Length") or 0)
            try:
                req = json.loads(self.rfile.read(n))
            except ValueError:
                return self._send(400, b'{"ok":false}', "application/json")
            if req.get("op") == "figures_wait":
                # read-only long poll: must not hold the session lock, or a
                # waiting tab would block every execute for up to 25 s
                resp = handle_request(sess, req)
            else:
                with lock:   # one session, serialized requests
                    resp = handle_request(sess, req)
            self._send(200, json.dumps(resp).encode(), "application/json")

    httpd = ThreadingHTTPServer((host, port), H)
    actual = httpd.server_address[1]
    print(f"runmat-tpu web REPL on http://{host}:{actual}/?token={token}",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _repl_page() -> bytes:
    """The single-file browser REPL (no build step, no dependencies)."""
    return ("""<!doctype html>
<html><head><meta charset="utf-8"><title>runmat-tpu</title><style>
:root{--bg:#14161a;--fg:#e8e8e3;--dim:#8a8f98;--acc:#5ec8f0;--err:#f07d7d}
body{background:var(--bg);color:var(--fg);font:14px/1.5 ui-monospace,Menlo,
monospace;margin:0;display:grid;grid-template-columns:1fr 280px;height:100vh}
#main{display:flex;flex-direction:column;overflow:hidden}
#log{flex:1;overflow-y:auto;padding:14px;white-space:pre-wrap}
#log .in{color:var(--acc)}#log .err{color:var(--err)}#log .out{color:var(--fg)}
#bar{display:flex;border-top:1px solid #2a2e35}
#prompt{color:var(--acc);padding:10px 4px 10px 14px}
#input{flex:1;background:none;border:none;color:var(--fg);font:inherit;
padding:10px 14px 10px 4px;outline:none}
#side{border-left:1px solid #2a2e35;padding:14px;overflow-y:auto}
#side h3{margin:0 0 8px;font-size:12px;color:var(--dim);font-weight:normal;
text-transform:uppercase;letter-spacing:.08em}
.var{margin:2px 0}.var b{color:var(--acc);font-weight:normal}
.var span{color:var(--dim)}.dev{color:#8fdf9f !important}
.fig{margin:10px 0;border:1px solid #2a2e35;border-radius:4px;
overflow:hidden;background:#fff;cursor:grab}
.fig .zoombox{transform-origin:0 0}
.fig svg{display:block;width:100%;height:auto}
#figs h4{margin:14px 0 4px;font-size:11px;color:var(--dim)}
</style></head><body>
<div id="main">
 <div id="log">runmat-tpu web REPL — session runs server-side next to the card.
Type MATLAB, Enter to run. Figures render below the workspace:
drag to pan, wheel to zoom, double-click to reset.
</div>
 <div id="bar"><span id="prompt">&gt;&gt;</span>
  <input id="input" autofocus autocomplete="off" spellcheck="false"></div>
</div>
<div id="side"><h3>Workspace</h3><div id="vars"></div>
<div id="figs"></div></div>
<script>
const log=document.getElementById('log'),inp=document.getElementById('input'),
vars=document.getElementById('vars'),figs=document.getElementById('figs');
let id=1;const hist=[];let hi=0;const view={};
const TOKEN=new URLSearchParams(location.search).get('token')||'';
async function api(body){const r=await fetch('/api',{method:'POST',
headers:{'Content-Type':'application/json','X-Runmat-Token':TOKEN},
body:JSON.stringify({id:id++,...body})});return r.json();}
function add(cls,text){const d=document.createElement('div');d.className=cls;
d.textContent=text;log.appendChild(d);log.scrollTop=log.scrollHeight;}
async function refreshVars(){const r=await api({op:'workspace'});
vars.innerHTML='';for(const[k,v]of Object.entries(r.workspace||{})){
const d=document.createElement('div');d.className='var';
const sz=(v.size||[]).join('x');
d.innerHTML=`<b${v.on_device?' class="dev"':''}>${k}</b> `+
`<span>${sz} ${v.class}${v.on_device?' (device)':''}</span>`;
vars.appendChild(d);}}
inp.addEventListener('keydown',async e=>{
if(e.key==='ArrowUp'){if(hi>0)inp.value=hist[--hi];e.preventDefault();return;}
if(e.key==='ArrowDown'){inp.value=hi<hist.length-1?hist[++hi]:'';return;}
if(e.key!=='Enter')return;const src=inp.value.trim();if(!src)return;
hist.push(src);hi=hist.length;inp.value='';add('in','>> '+src);
const r=await api({op:'execute',source:src});
if(r.output)add('out',r.output.replace(/\\n$/,''));
if(!r.ok&&r.error)add('err',r.error.identifier+': '+r.error.message);
refreshVars();refreshFigs();});
function applyView(num,box){const v=view[num]||(view[num]={x:0,y:0,s:1});
box.style.transform=`translate(${v.x}px,${v.y}px) scale(${v.s})`;}
let sceneRev=-1;const cams={};
// --- base64 -> typed arrays (WebGL scene buffers) ---
function b64bytes(s){const b=atob(s);const u=new Uint8Array(b.length);
for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);return u;}
const b64f32=s=>new Float32Array(b64bytes(s).buffer);
const b64u32=s=>new Uint32Array(b64bytes(s).buffer);
// Client-side WebGL renderer: geometry arrives once per scene revision;
// orbit/zoom/pan are pure-local (zero server round trips per frame).
async function buildGL(f,box,cam){
const r=await api({op:'figure_webgl',fig:f.num});
if(!r.ok||!r.scene||!r.scene.axes.length)return null;
const sc=r.scene,W=sc.size[0],H=sc.size[1],dpr=window.devicePixelRatio||1;
const cv=document.createElement('canvas');
cv.width=W*dpr;cv.height=H*dpr;
cv.style.cssText='display:block;width:100%;height:auto;background:#fff';
const ov=document.createElement('canvas');
ov.width=W*dpr;ov.height=H*dpr;
ov.style.cssText='position:absolute;left:0;top:0;width:100%;height:auto;pointer-events:none';
const gl=cv.getContext('webgl',{antialias:true});
if(!gl||!gl.getExtension('OES_element_index_uint'))return null;
box.innerHTML='';box.style.position='relative';
box.appendChild(cv);box.appendChild(ov);
const mk=(t,src)=>{const s=gl.createShader(t);gl.shaderSource(s,src);
gl.compileShader(s);return s;};
const pr=gl.createProgram();
gl.attachShader(pr,mk(gl.VERTEX_SHADER,'attribute vec3 p;attribute vec3 c;'+
'uniform mat4 M;uniform float ps;varying vec3 vc;void main(){'+
'gl_Position=M*vec4(p,1.0);gl_PointSize=ps;vc=c;}'));
gl.attachShader(pr,mk(gl.FRAGMENT_SHADER,'precision mediump float;'+
'varying vec3 vc;uniform float al;void main(){gl_FragColor=vec4(vc,al);}'));
gl.linkProgram(pr);gl.useProgram(pr);
const aP=gl.getAttribLocation(pr,'p'),aC=gl.getAttribLocation(pr,'c'),
uM=gl.getUniformLocation(pr,'M'),uPS=gl.getUniformLocation(pr,'ps'),
uA=gl.getUniformLocation(pr,'al');
gl.enable(gl.DEPTH_TEST);gl.enable(gl.POLYGON_OFFSET_FILL);
gl.polygonOffset(1.0,1.0);
gl.enableVertexAttribArray(aP);gl.enableVertexAttribArray(aC);
function vbo(data){const b=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,b);
gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const axes=sc.axes.map(a=>{
const draws=a.draws.map(dr=>{
const o={kind:dr.kind,nv:dr.nv,ni:dr.ni||0,alpha:dr.alpha||1,
width:dr.width||1,size:dr.size||4,
pb:vbo(b64f32(dr.pos)),cb:vbo(b64bytes(dr.col))};
if(dr.kind==='tris'){o.ib=gl.createBuffer();
gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,o.ib);
gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,b64u32(dr.idx),gl.STATIC_DRAW);}
return o;});
const E=[];
for(const u of[-0.5,0.5])for(const v of[-0.5,0.5]){
E.push(-0.5,u,v,0.5,u,v, u,-0.5,v,u,0.5,v, u,v,-0.5,u,v,0.5);}
return {a,draws,bb:vbo(new Float32Array(E)),
bc:vbo(new Uint8Array(E.length).fill(170)),nbox:E.length/3};});
function mat(){const az=cam.az*Math.PI/180,el=cam.el*Math.PI/180;
const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
const z=cam.zoom/0.75;
return {m:new Float32Array([ca*z,sa*se*z,0.9*sa*ce,0,
sa*z,-ca*se*z,-0.9*ca*ce,0, 0,ce*z,-0.9*se,0,
cam.px/0.75,cam.py/0.75,0,1]),ca,sa,ce,se};}
function proj(M,x,y,z){return [M[0]*x+M[4]*y+M[8]*z+M[12],
M[1]*x+M[5]*y+M[9]*z+M[13]];}
function draw(){
gl.viewport(0,0,cv.width,cv.height);
gl.clearColor(1,1,1,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
const ctx=ov.getContext('2d');ctx.clearRect(0,0,ov.width,ov.height);
for(const rec of axes){const a=rec.a;
const vx=a.rect[0]*W*dpr,vy=a.rect[1]*H*dpr,
vw=a.rect[2]*W*dpr,vh=a.rect[3]*H*dpr;
gl.viewport(vx,vy,vw,vh);
const mm=mat();gl.uniformMatrix4fv(uM,false,mm.m);
const bind=(o)=>{gl.bindBuffer(gl.ARRAY_BUFFER,o.pb);
gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
gl.bindBuffer(gl.ARRAY_BUFFER,o.cb);
gl.vertexAttribPointer(aC,3,gl.UNSIGNED_BYTE,true,0,0);};
if(!a.axis_off){bind({pb:rec.bb,cb:rec.bc});gl.uniform1f(uA,1);
gl.drawArrays(gl.LINES,0,rec.nbox);}
for(const o of rec.draws){bind(o);gl.uniform1f(uA,o.alpha);
gl.uniform1f(uPS,o.size*dpr);
if(o.kind==='tris'){gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,o.ib);
gl.drawElements(gl.TRIANGLES,o.ni,gl.UNSIGNED_INT,0);}
else if(o.kind==='lines'){gl.lineWidth(o.width);
gl.drawArrays(gl.LINES,0,o.nv);}
else gl.drawArrays(gl.POINTS,0,o.nv);}
if(!a.axis_off)drawLabels(ctx,a,mm,vx,vy,vw,vh);}}
function drawLabels(ctx,a,mm,vx,vy,vw,vh){
const px=(q)=>{const s=proj(mm.m,q[0],q[1],q[2]);
return [vx+(s[0]+1)/2*vw, ov.height-(vy+(s[1]+1)/2*vh)];};
ctx.fillStyle='#333';ctx.font=(10*dpr)+'px ui-monospace,monospace';
ctx.textAlign='center';
const ye=mm.ca>=0?-0.5:0.5, xe=mm.sa<=0?-0.5:0.5;
for(const t of a.ticks.x){const p=px([t[0],ye,-0.5]);
ctx.fillText(t[1],p[0],p[1]+14*dpr);}
for(const t of a.ticks.y){const p=px([xe,t[0],-0.5]);
ctx.fillText(t[1],p[0],p[1]+14*dpr);}
ctx.textAlign='right';
// z ticks on the leftmost vertical edge
let best=null,bu=1e9;
for(const cx of[-0.5,0.5])for(const cy of[-0.5,0.5]){
const u=proj(mm.m,cx,cy,0)[0];if(u<bu){bu=u;best=[cx,cy];}}
for(const t of a.ticks.z){const p=px([best[0],best[1],t[0]]);
ctx.fillText(t[1],p[0]-6*dpr,p[1]+3*dpr);}
ctx.textAlign='center';
if(a.title){ctx.font='bold '+(12*dpr)+'px ui-monospace,monospace';
ctx.fillText(a.title,vx+vw/2,ov.height-(vy+vh)-6*dpr);}
const lbl=(s,q,dy)=>{if(!s)return;
ctx.font=(11*dpr)+'px ui-monospace,monospace';
const p=px(q);ctx.fillText(s,p[0],p[1]+dy*dpr);};
lbl(a.xlabel,[0,ye,-0.5],30);lbl(a.ylabel,[xe,0,-0.5],30);
lbl(a.zlabel,[best[0],best[1],0.55],-8);}
draw();
return {draw,canvas:cv};}
function buildFig(f){
const h=document.createElement('h4');
h.textContent='Figure '+f.num+(f.is3d?'  (drag to orbit)':'');
const d=document.createElement('div');d.className='fig';d.dataset.num=f.num;
const box=document.createElement('div');box.className='zoombox';
box.innerHTML=f.svg;d.appendChild(box);applyView(f.num,box);
let glr=null;
if(f.webgl&&f.is3d){
const c=cams[f.num]=cams[f.num]||{az:f.view[0],el:f.view[1]};
c.zoom=c.zoom||1;c.px=c.px||0;c.py=c.py||0;
buildGL(f,box,c).then(g=>{glr=g;}).catch(()=>{});}
const tip=document.createElement('div');
tip.style.cssText='position:absolute;display:none;background:#14161a;'+
'color:#e8e8e3;font:11px ui-monospace,monospace;padding:3px 6px;'+
'border-radius:3px;pointer-events:none;z-index:5;white-space:pre';
d.style.position='relative';d.appendChild(tip);
if(f.is3d)cams[f.num]=cams[f.num]||{az:f.view[0],el:f.view[1]};
let drag=null,moved=false,orbitTimer=null,raf=0;
async function orbit(dx,dy){const c=cams[f.num];
c.az-=dx*0.5;c.el=Math.max(-90,Math.min(90,c.el+dy*0.5));
if(glr){if(!raf)raf=requestAnimationFrame(()=>{raf=0;glr.draw();});
return;}
if(orbitTimer)return;orbitTimer=setTimeout(async()=>{orbitTimer=null;
const r=await api({op:'view',fig:f.num,az:c.az,el:c.el,draft:true});
if(r.ok)box.innerHTML=r.svg;},50);}
d.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY};
moved=false;d.style.cursor='grabbing';e.preventDefault();});
window.addEventListener('mouseup',async()=>{const was=drag;drag=null;
d.style.cursor='grab';
if(was&&moved&&f.is3d&&cams[f.num]){const c=cams[f.num];
if(glr){api({op:'view',fig:f.num,az:c.az,el:c.el,nosvg:true});return;}
const r=await api({op:'view',fig:f.num,az:c.az,el:c.el});
if(r.ok)box.innerHTML=r.svg;}});
d.addEventListener('mousemove',e=>{if(!drag)return;moved=true;
const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
drag={x:e.clientX,y:e.clientY};
if(f.is3d&&!e.shiftKey){orbit(dx,dy);return;}
const v=view[f.num];v.x+=dx;v.y+=dy;applyView(f.num,box);});
d.addEventListener('wheel',e=>{e.preventDefault();
const k=e.deltaY<0?1.2:1/1.2;
if(glr){const c=cams[f.num];c.zoom*=k;
if(!raf)raf=requestAnimationFrame(()=>{raf=0;glr.draw();});return;}
const v=view[f.num];
const rect=d.getBoundingClientRect();
const px=e.clientX-rect.left,py=e.clientY-rect.top;
v.x=px-(px-v.x)*k;v.y=py-(py-v.y)*k;v.s*=k;applyView(f.num,box);});
d.addEventListener('dblclick',()=>{view[f.num]={x:0,y:0,s:1};
applyView(f.num,box);tip.style.display='none';
if(glr){const c=cams[f.num];c.az=f.view[0];c.el=f.view[1];
c.zoom=1;c.px=0;c.py=0;glr.draw();
api({op:'view',fig:f.num,az:c.az,el:c.el,nosvg:true});}});
d.addEventListener('click',async e=>{if(moved)return;
const svg=glr?glr.canvas:box.querySelector('svg');if(!svg)return;
const r0=svg.getBoundingClientRect();
const fx=(e.clientX-r0.left)/r0.width,fy=(e.clientY-r0.top)/r0.height;
const r=await api({op:'probe',fig:f.num,fx:fx,fy:fy});
if(!r.ok||!r.hit){tip.style.display='none';return;}
const hit=r.hit;const dr=d.getBoundingClientRect();
let txt=`${hit.series}[${hit.index}]\nx ${hit.x.toPrecision(6)}`+
`\ny ${hit.y.toPrecision(6)}`;
if('z' in hit)txt+=`\nz ${hit.z.toPrecision(6)}`;
tip.textContent=txt;tip.style.display='block';
tip.style.left=(e.clientX-dr.left+12)+'px';
tip.style.top=(e.clientY-dr.top+12)+'px';});
figs.appendChild(h);figs.appendChild(d);}
function renderFigs(list){figs.innerHTML='';
for(const f of (list||[]))buildFig(f);}
async function refreshFigs(){const r=await api({op:'figures'});
sceneRev=r.rev;renderFigs(r.figures);}
async function liveLoop(){for(;;){try{
const r=await api({op:'figures_wait',rev:sceneRev,timeout:25});
if(r.changed){sceneRev=r.rev;renderFigs(r.figures);refreshVars();}
}catch(e){await new Promise(res=>setTimeout(res,2000));}}}
refreshVars();refreshFigs().then(liveLoop);
</script></body></html>""").encode()


def serve_tcp(sess, host: str, port: int) -> int:
    import socket
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    actual = srv.getsockname()[1]
    print(f"runmat-tpu server listening on {host}:{actual}", file=sys.stderr)
    while True:
        conn, _addr = srv.accept()
        f = conn.makefile("rw", encoding="utf-8")
        shutdown = False
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = handle_request(sess, req)
            f.write(json.dumps(resp) + "\n")
            f.flush()
            if resp.get("shutdown"):
                shutdown = True
                break
        conn.close()
        if shutdown:
            return 0
