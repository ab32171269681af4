"""The port runs where neither jax nor the JAX package can be imported: a
subprocess with `jax` and `runmat_tpu` blocked in `sys.modules` imports
runmat_tpu_torch and runs the three workloads and the statistics,
indexing, linear algebra, spectral and sparse scripts
(`runmat_tpu_torch/workloads/{histogram_stats,index_sets,dense_linalg,
spectral,sparse_poisson,dl_digits,dl_vowels,sensor_log}.m`) at small
size on TorchEngine(device="cpu"), and a host session without an engine
(sensor_log through both, the same checksum, and a MAT file saved under
the engine loaded on the host), and field_plot (plotting, imfilter and
the colormap on the engine, the same checksum on the host), and
fea_thermal (fea2, the STEP reader and mesher, the CG on the engine) and
the command line (`--no-accel -e`); the host modules of datetime, classdef, files, tables, plotting, control, image
and graphs import there, and the
profiling, sync-counting, timing and benchmark tools import there too, and
so do the deep-learning modules (their initial weights drawn without
jax). No module of the JAX package is loaded
at the end. A second subprocess does the same for the tooling: the
session server, the client profile, the remote project API, the language
server, the native loop tier and the CUDA battery."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["runmat_tpu"] = None
import runmat_tpu_torch
import runmat_tpu_torch.fusebench
import runmat_tpu_torch.histbench
import runmat_tpu_torch.ops.boxmuller
import runmat_tpu_torch.ops.fused
import runmat_tpu_torch.ops.iir
import runmat_tpu_torch.ops.spcg
import runmat_tpu_torch.ops.eig_qr
import runmat_tpu_torch.accel.eig_qr
import runmat_tpu_torch.fea
import runmat_tpu_torch.spbench
import runmat_tpu_torch.linalgbench
import runmat_tpu_torch.profile
import runmat_tpu_torch.rngbench
import runmat_tpu_torch.sass
import runmat_tpu_torch.syncs
import runmat_tpu_torch.walls
import runmat_tpu_torch.dlbench
import runmat_tpu_torch.dl.autodiff
import runmat_tpu_torch.dl.onnx
import runmat_tpu_torch.ops.jaxrandom
import runmat_tpu_torch.ops.lstm
import runmat_tpu_torch.ops.optim
import runmat_tpu_torch.runtime.builtins.dl_layers
import runmat_tpu_torch.runtime.builtins.dl_builtins
import runmat_tpu_torch.runtime.builtins.ml
import runmat_tpu_torch.fs
import runmat_tpu_torch.matio
import runmat_tpu_torch.oop
import runmat_tpu_torch.packages
import runmat_tpu_torch.tables
from runmat_tpu_torch.runtime.registry import ensure_loaded
ensure_loaded()   # first, in the registry's order: table_builtins and
                  # sets_sort both register sortrows
for m in ("datetime_builtins", "datetime2", "datetime3", "oop_builtins",
          "file_io", "io2", "data_api", "introspection2", "table_builtins",
          "table2", "textanalytics", "plotting", "plotting2", "plotting3",
          "control2", "misc2", "domains", "graph2"):
    __import__("runmat_tpu_torch.runtime.builtins." + m)
import runmat_tpu_torch.plot.webgl
import runmat_tpu_torch.plot.volumetric
import runmat_tpu_torch.plotbench
from runmat_tpu_torch import accel
from runmat_tpu_torch.session import Session

small = {"elementwise_math": "points = 4096;",
         "monte_carlo": "M = 4096; T = 16;",
         "image_normalize": "B = 2; H = 32; W = 48;"}
for name, pre in small.items():
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    eng = accel.active_engine()
    r = s.execute(pre + "\n" + open(f"benchmarks/{name}.m").read())
    assert r.error is None, r.error
    print(r.output.strip())
    print(name, "folds", eng.stats["loop_folds"], "fallbacks",
          eng.stats["host_fallbacks"], "plans", len(eng.fusion_snapshot()))
    runmat_tpu_torch.uninstall()
s = runmat_tpu_torch.session("cpu", auto_offload=True, offload_threshold=1)
eng = accel.active_engine()
r = s.execute("N = 65536;\n" +
              open("runmat_tpu_torch/workloads/histogram_stats.m").read())
assert r.error is None, r.error
print(r.output.strip())
print("histogram_stats fallbacks", eng.stats["host_fallbacks"])
runmat_tpu_torch.uninstall()
s = runmat_tpu_torch.session("cpu", auto_offload=True, offload_threshold=1)
eng = accel.active_engine()
r = s.execute("N = 65536;\n" +
              open("runmat_tpu_torch/workloads/index_sets.m").read())
assert r.error is None, r.error
print(r.output.strip())
print("index_sets folds", eng.stats["loop_folds"], eng.stats["while_folds"],
      "fallbacks", eng.stats["host_fallbacks"])
runmat_tpu_torch.uninstall()
for name, pre in (("dense_linalg", "N = 64;"), ("spectral", "N = 2^12;"),
                  ("sparse_poisson", "N = 48;")):
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    eng = accel.active_engine()
    r = s.execute(pre + "\n" +
                  open(f"runmat_tpu_torch/workloads/{name}.m").read())
    assert r.error is None, r.error
    print(r.output.strip())
    print(name, "fallbacks", eng.stats["host_fallbacks"])
    runmat_tpu_torch.uninstall()
for name, pre in (("dl_digits", "N = 256; EPOCHS = 1; NP = 64;"),
                  ("dl_vowels", "EPOCHS = 1;")):
    s = runmat_tpu_torch.session("cpu", auto_offload=True,
                                 offload_threshold=1)
    eng = accel.active_engine()
    r = s.execute(pre + "\n" +
                  open(f"runmat_tpu_torch/workloads/{name}.m").read())
    assert r.error is None, r.error
    print(r.output.strip())
    print(name, "learnables", s.get("net").numel())
    runmat_tpu_torch.uninstall()
sensor = open("runmat_tpu_torch/workloads/sensor_log.m").read()
s = runmat_tpu_torch.session("cpu", auto_offload=True, offload_threshold=1)
eng = accel.active_engine()
r = s.execute("D = 3; F = 1024; C = 4;\n" + sensor)
assert r.error is None, r.error
print(r.output.strip())
print("sensor_log fallbacks", eng.stats["host_fallbacks"])
import os
mat = os.path.join(os.environ["PORT_TEST_DIR"], "sensor.mat")
assert s.execute(f"save('{mat}', 'mu', 'n64', 'n32');").error is None
runmat_tpu_torch.uninstall()
h = Session(accelerate=False)
assert h.execute(f"L = load('{mat}');").error is None
print("mat reloaded", h.get("L").get_scalar_field("mu").host().shape)
h = Session(accelerate=False)
r = h.execute("D = 3; F = 1024; C = 4;\n" + sensor)
assert r.error is None, r.error
print("host", r.output.strip())
field = "H = 270; W = 480;\n" + open(
    "runmat_tpu_torch/workloads/field_plot.m").read()
s = runmat_tpu_torch.session("cpu", auto_offload=True)
eng = accel.active_engine()
r = s.execute(field)
assert r.error is None, r.error
print(r.output.strip())
print("field_plot fallbacks", eng.stats["host_fallbacks"], "linalg",
      [e["ops"][0] for e in eng.launch_log if e["cat"] == "linalg"])
runmat_tpu_torch.uninstall()
h = Session(accelerate=False)
r = h.execute(field)
assert r.error is None, r.error
print("host", r.output.strip())
s = runmat_tpu_torch.session("cpu")
eng = accel.active_engine()
r = s.execute("R = 16; hs = 0.35;\n" +
              open("runmat_tpu_torch/workloads/fea_thermal.m").read())
assert r.error is None, r.error
print(r.output.strip())
print("fea_thermal solves", [e["n"] for e in eng.launch_log
                             if e["cat"] == "sparse_cg"],
      "fallbacks", eng.stats["host_fallbacks"])
runmat_tpu_torch.uninstall()
import contextlib, io
from runmat_tpu_torch import cli
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(["--no-accel", "-e", "fprintf('CLI_ok %d\\n', 6 * 7);"])
print("cli", rc, buf.getvalue().strip())
h = Session(accelerate=False)
r = h.execute("x = rand(1, 5); fprintf('HOST_ok %d\\n', numel(x));")
assert r.error is None, r.error
print(r.output.strip())
print("jax blocked:", sys.modules["jax"] is None)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] == "runmat_tpu" and sys.modules[m])
print("runmat_tpu modules:", loaded)
"""


def test_port_runs_without_jax(tmp_path):
    # the port runs without jax and without runmat_tpu
    env = dict(os.environ)
    env["PORT_TEST_DIR"] = str(tmp_path)
    env["HOME"] = str(tmp_path)        # fea.run's registry lives under ~
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = p.stdout
    for label in ("CHECK", "PRICE", "MSE", "HIST", "RANK", "LINALG",
                  "SPECTRAL", "POISSON", "DIGITS", "VOWELS", "SENSOR",
                  "FIELD", "THERMAL", "PLATE"):
        assert f"RESULT_ok {label}=" in out, out
    assert "monte_carlo folds 1 fallbacks 0 plans" in out, out
    assert "elementwise_math folds 0 fallbacks 0 plans 4" in out, out
    assert "histogram_stats fallbacks 0" in out, out
    assert "index_sets folds 1 1 fallbacks 0" in out, out
    assert "dense_linalg fallbacks 0" in out, out
    assert "spectral fallbacks 0" in out, out
    assert "sparse_poisson fallbacks 0" in out, out
    assert "dl_digits learnables 21690" in out, out
    assert "dl_vowels learnables 46109" in out, out
    assert "sensor_log fallbacks 0" in out, out
    assert "mat reloaded (3, 4)" in out, out
    assert "field_plot fallbacks 0 linalg ['imfilter', 'cmap']" in out, out
    field = [ln.split("=")[1] for ln in out.splitlines()
             if "RESULT_ok FIELD=" in ln]
    assert len(field) == 2 and field[0] == field[1], out
    # the host engine prints the same checksum as the CPU engine
    sensor = [ln.split("=")[1] for ln in out.splitlines()
              if "RESULT_ok SENSOR=" in ln]
    assert len(sensor) == 2 and sensor[0] == sensor[1], out
    assert "fea_thermal solves [4335, 4624] fallbacks 0" in out, out
    assert "cli 0 CLI_ok 42" in out, out
    assert "HOST_ok 5" in out, out
    assert "jax blocked: True" in out, out
    assert "runmat_tpu modules: []" in out, out


TOOLING = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["runmat_tpu"] = None
import runmat_tpu_torch
from runmat_tpu_torch import accel, client, cuda_smoke, lsp, server
from runmat_tpu_torch.fs import RemoteFsProvider
from runmat_tpu_torch.native import turbine_loop
from runmat_tpu_torch.remote import ProjectServer, PublicApiClient
from runmat_tpu_torch.session import Session
s = runmat_tpu_torch.session("cpu")
r = server.handle_request(s, {"id": 1, "op": "execute",
                              "source": "x = gpuArray(1:8); y = sum(x);"})
info = server.handle_request(s, {"id": 2, "op": "accel_info"})["accel"]
print("server", r["ok"], info["platform"], sorted(info["launches"])[:2])
res = cuda_smoke.run(s)
print("battery", res["failed"], res["passed"] >= 120)
runmat_tpu_torch.uninstall()
print("client", client.run("disp(6 * 7)")["output"].strip())
srv = ProjectServer(os.path.join(os.environ["PORT_TEST_DIR"], "store"))
srv.start()
c = PublicApiClient(srv.base_url, token="")
pid = c.create_project(c.create_org("o")["id"], "p")["id"]
c.fs_write(pid, "job.m", b"r = sum(1:100);")
h = Session(accelerate=False)
h.run_source(RemoteFsProvider(srv.base_url, pid, token="").read_bytes(
    "job.m").decode(), "job.m")
srv.stop()
print("remote", float(h.get("r").host().reshape(-1)[0]))
print("lsp", [d["message"].split(":")[0] for d in
              lsp.diagnostics("x = 1 +;")])
h.execute("t = 0; for k = 1:1000, t = t + k; end")
print("native", dict(turbine_loop.taken), float(h.get("t").host()[0, 0]))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] == "runmat_tpu" and sys.modules[m])
print("runmat_tpu modules:", loaded)
"""


def test_the_tooling_runs_without_jax(tmp_path):
    """The session server, client profile, remote project API, language
    server, native loop tier and CUDA battery import and run with jax and
    runmat_tpu blocked (on the CPU engine or the host)."""
    env = dict(os.environ, PORT_TEST_DIR=str(tmp_path), HOME=str(tmp_path))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", TOOLING], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    out = p.stdout
    for line in ("server True cpu ['cmap', 'eig_qr']", "battery 0 True",
                 "client 42", "remote 5050.0", "lsp ['MATLAB']",
                 "native {'for': 1} 500500.0", "runmat_tpu modules: []"):
        assert line in out, out
