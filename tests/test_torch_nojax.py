"""The port runs where jax is not installed: a subprocess with `jax` blocked
in `sys.modules` imports runmat_tpu_torch and runs the three workloads at
small size on TorchEngine(device="cpu")."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import runmat_tpu_torch
from runmat_tpu import accel

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
          eng.stats["host_fallbacks"])
    runmat_tpu_torch.uninstall()
print("jax blocked:", sys.modules["jax"] is None)
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = p.stdout
    for label in ("CHECK", "PRICE", "MSE"):
        assert f"RESULT_ok {label}=" in out, out
    assert "monte_carlo folds 1 fallbacks 0" in out, out
    assert "jax blocked: True" in out, out
