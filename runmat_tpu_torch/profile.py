"""One warm run of a `.m` script on the card under `torch.profiler`.

    python -m runmat_tpu_torch.profile runmat_tpu_torch/workloads/histogram_stats.m \
        [--pre "N = 2^20;"] [--trace chiprun_out/trace.json]

Runs the script once to warm up, then once more under the profiler (CPU and
CUDA activity) in the same session, through `Session.run_source` (no
workspace preview). Prints the profiled wall time, the number of device
items, the device busy time and idle share (1 - busy / wall), the largest
device items and the largest host items; writes a Chrome trace if asked.
Device "busy" sums every device item, memory copies included.
"""

from __future__ import annotations

import argparse
import io
import subprocess
import time


def profile_script(src: str, top: int = 12, trace: str | None = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import runmat_tpu_torch

    s = runmat_tpu_torch.session("cuda")
    try:
        s.stdout = io.StringIO()
        s.run_source(src)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.run_source(src)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        runmat_tpu_torch.uninstall()
    items = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in items) / 1e3
    per_name: dict = {}
    for e in items:
        ms, count = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    device = sorted(((k, ms, c) for k, (ms, c) in per_name.items()),
                    key=lambda t: -t[1])[:top]
    host = sorted(((e.key, e.cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda t: -t[1])[:top]
    if trace:
        prof.export_chrome_trace(trace)
    return {"wall_ms": wall_ms, "device_items": len(items),
            "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_top": device, "host_top": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("script", help="path of the .m script")
    ap.add_argument("--pre", default="", help="statements run before it")
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    src = args.pre + "\n" + open(args.script).read()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    r = profile_script(src, args.top, args.trace)
    print(f"{card}")
    print(f"profile {args.script}: wall {r['wall_ms']:.1f} ms, "
          f"{r['device_items']} device items, busy {r['busy_ms']:.3f} ms, "
          f"idle share {r['idle_share']:.3f}")
    print("device top:")
    for key, ms, count in r["device_top"]:
        print(f"  {ms:.3f} ms  x{count}  {key[:90]}")
    print("host top:")
    for key, ms, count in r["host_top"]:
        print(f"  {ms:.3f} ms  x{count}  {key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
