"""The port runs where neither jax nor the JAX package can be imported: a
subprocess with `jax` and `runmat_tpu` blocked in `sys.modules` imports
runmat_tpu_torch and runs the three workloads and the statistics and
indexing scripts (`runmat_tpu_torch/workloads/{histogram_stats,
index_sets}.m`) at small size on TorchEngine(device="cpu"), and a host
session without an engine; the profiling, sync-counting, timing and
benchmark tools import there too. No module of the JAX package is loaded
at the end."""

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
import runmat_tpu_torch.profile
import runmat_tpu_torch.rngbench
import runmat_tpu_torch.sass
import runmat_tpu_torch.syncs
import runmat_tpu_torch.walls
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
h = Session(accelerate=False)
r = h.execute("x = rand(1, 5); fprintf('HOST_ok %d\\n', numel(x));")
assert r.error is None, r.error
print(r.output.strip())
print("jax blocked:", sys.modules["jax"] is None)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] == "runmat_tpu" and sys.modules[m])
print("runmat_tpu modules:", loaded)
"""


def test_port_runs_without_jax():
    # the port runs without jax and without runmat_tpu
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = p.stdout
    for label in ("CHECK", "PRICE", "MSE", "HIST", "RANK"):
        assert f"RESULT_ok {label}=" in out, out
    assert "monte_carlo folds 1 fallbacks 0 plans" in out, out
    assert "elementwise_math folds 0 fallbacks 0 plans 4" in out, out
    assert "histogram_stats fallbacks 0" in out, out
    assert "index_sets folds 1 1 fallbacks 0" in out, out
    assert "HOST_ok 5" in out, out
    assert "jax blocked: True" in out, out
    assert "runmat_tpu modules: []" in out, out
