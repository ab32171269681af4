"""Copy of runmat_tpu/cli.py in the PyTorch port.

Command-line interface: script runner, REPL, and subcommands.

Reference parity: runmat-cli (crates/runmat-cli/src/cli/root.rs:207-333 —
default script run + Repl/Run/Check/Version/Info/AccelInfo/GcStats/Benchmark/
Config subcommands; bootstrap initializes config, logging, and the
acceleration provider, app/bootstrap.rs:53).

A session runs on the card unless `--no-accel` (anywhere on the command
line) asks for the host; without a card a command that needs a session
exits 1 and says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from .errors import MatError
    try:
        return _main(argv)
    except MatError as e:   # no card (the message names --no-accel), or
        # accel-warmup, which exists only for the TPU
        print(f"Error: {e.message}", file=sys.stderr)
        return 1


def _main(argv: list) -> int:
    no_accel = "--no-accel" in argv
    argv = [a for a in argv if a != "--no-accel"]

    # structured log subscriber with EnvFilter semantics (≙ runmat-logging
    # bootstrap, runmat-cli/src/app/bootstrap.rs): RUNMAT_TPU_LOG=
    # "info,runmat_tpu.accel=debug", RUNMAT_TPU_LOG_FORMAT=json
    from . import telemetry as _tel
    _tel.init_logging()

    # subcommand style: runmat-tpu <cmd> [...]
    if argv and argv[0] in ("repl", "run", "check", "version", "info",
                            "accel-info", "accel-calibrate", "accel-warmup",
                            "gc-stats", "gc-minor", "gc-major", "gc-config",
                            "gc-stress",
                            "benchmark", "config", "lsp", "serve",
                            "remote", "login"):
        cmd = argv[0]
        rest = argv[1:]
        return _dispatch(cmd, rest, no_accel)

    p = argparse.ArgumentParser(prog="runmat-tpu",
                                description="TPU-native MATLAB-compatible runtime")
    p.add_argument("script", nargs="?", help="MATLAB script to run")
    p.add_argument("-e", "--eval", help="evaluate a snippet and exit")
    p.add_argument("--no-accel", action="store_true", help="disable the accel engine")
    p.add_argument("--accel-info", action="store_true", help="print accelerator info")
    p.add_argument("--version", action="store_true")
    args = p.parse_args(argv)

    if args.version:
        return _dispatch("version", [], no_accel)
    if args.accel_info:
        return _dispatch("accel-info", [], no_accel)

    sess = _make_session(no_accel)
    from .errors import MatError

    if args.eval:
        try:
            sess.run_source(args.eval, "<cli>")
        except MatError as e:
            print(f"Error: {e.message}", file=sys.stderr)
            return 1
        return 0
    if args.script:
        try:
            sess.run_file(args.script)
        except MatError as e:
            print(f"Error: {e.message}", file=sys.stderr)
            for fn, line in e.stack:
                print(f"  in {fn} (line {line})", file=sys.stderr)
            return 1
        return 0
    return repl(sess)


def _make_session(no_accel=False):
    from .session import Session
    return Session(accelerate=False if no_accel else None)


def _dispatch(cmd: str, rest: list, no_accel=False) -> int:
    if cmd == "version":
        from . import __version__
        print(f"runmat-tpu {__version__}")
        return 0

    if cmd == "repl":
        return repl(_make_session(no_accel))

    if cmd == "run":
        show = "--show" in rest
        if show:
            rest = [a for a in rest if a != "--show"]
        port = 8765
        if "--port" in rest:
            i = rest.index("--port")
            port = int(rest[i + 1])
            del rest[i:i + 2]
        if not rest:
            print("usage: runmat-tpu run <script.m> [--show [--port N]]",
                  file=sys.stderr)
            return 2
        sess = _make_session(no_accel)
        from .errors import MatError
        try:
            sess.run_file(rest[0])
        except MatError as e:
            print(f"Error: {e.message}", file=sys.stderr)
            return 1
        if show:
            # interactive figure surface (VERDICT r4 #9; the
            # accelerator-side analog of the reference's winit+egui window,
            # runmat-plot/src/gui/native_window.rs): serve the session's
            # figures over HTTP — the embedded client renders typed-
            # geometry WebGL scenes with orbit/zoom and long-polls
            # figures_wait for live updates; device arrays are gathered
            # once per scene revision, never re-gathered unchanged.
            from .plot import figure as figmod
            if not figmod._FIGURES:
                print("no figures to show", file=sys.stderr)
                return 0
            import secrets
            token = secrets.token_urlsafe(24)
            url = f"http://127.0.0.1:{port}/?token={token}"
            print(f"serving figures at {url} (Ctrl-C to exit)")
            try:
                import threading
                import webbrowser
                threading.Timer(0.4, webbrowser.open, (url,)).start()
            except Exception:
                pass
            from .server import serve_http
            try:
                return serve_http(sess, "127.0.0.1", port, token=token)
            except KeyboardInterrupt:
                return 0
        return 0

    if cmd == "check":
        return _check(rest)

    if cmd == "info":
        from . import __version__
        from .config import load
        from .runtime import registry
        registry.ensure_loaded()
        cfg = load()
        print(f"runmat-tpu {__version__}")
        print(f"builtins: {len(registry.all_builtins())}")
        print(f"config: {cfg.source or '<defaults>'}")
        if cfg.overrides:
            print(f"env overrides: {', '.join(cfg.overrides)}")
        return 0

    if cmd == "accel-info":
        as_json = "--json" in rest
        sess = _make_session(no_accel)
        from . import telemetry
        from .accel import active_engine
        eng = active_engine()
        if as_json:
            snap = telemetry.snapshot(sess)
            if eng is not None:
                snap["card"] = eng.device_info()
            print(json.dumps(snap, indent=2, default=str))
        elif eng is None:
            print("accelerator: none (host numpy only)")
        else:
            info = eng.device_info()
            print(f"accelerator: {info['platform']} ({info['name']}), "
                  f"{info['count']} device(s), compute capability "
                  f"{info['capability']}, {info['memory']} bytes")
            print(f"  matmul_precision: {eng.matmul_precision}")
            for k, v in eng.stats.items():
                print(f"  {k}: {v}")
        if "--fusion" in rest and eng is not None:
            # cached fused-plan snapshot (≙ fusion-plan export for hosts)
            for i, plan in enumerate(eng.fusion_snapshot(), 1):
                print(f"  plan {i}: {plan['kind']} "
                      f"({plan['n_ops']} ops) {' '.join(plan['ops'][:12])}")
        return 0

    if cmd == "gc-stats":
        # python is the host GC (≙ runmat gc stats); report its counters +
        # engine residency
        import gc as pygc
        sess = _make_session(no_accel)
        counts = pygc.get_count()
        print(f"gc generations (collections pending): {counts}")
        from .accel import active_engine
        eng = active_engine()
        if eng is not None:
            print(f"device uploads: {eng.stats['uploads']} "
                  f"({eng.stats['upload_bytes']} bytes)")
            mi = eng.memory_info()
            if mi["available"]:
                print(f"device memory: {mi['bytes_in_use']} / "
                      f"{mi['bytes_limit']} bytes in use "
                      f"({mi['devices']} device(s))")
            else:
                print("device memory: backend does not report usage "
                      "(no memory_stats on this platform)")
            rs = eng.residency.snapshot()
            print(f"hbm ledger: {rs['live_bytes']} bytes live in "
                  f"{rs['n_live']} handle(s), peak {rs['peak_bytes']}, "
                  f"{rs['allocs']} allocs / {rs['frees']} frees")
            print(f"generations: young {rs['young_bytes']} B / old "
                  f"{rs['old_bytes']} B (promote after "
                  f"{rs['promote_after']} allocs; {rs['promoted']} "
                  f"died tenured)")
            if rs["budget_bytes"]:
                print(f"hbm budget: {rs['budget_bytes']} bytes, "
                      f"{rs['pressure_events']} pressure event(s)")
        return 0

    if cmd in ("gc-minor", "gc-major"):
        # ≙ runmat gc minor/major (runmat-gc/src/lib.rs:548,725): drop the
        # engine's transient device caches; major additionally runs the host
        # collector to break cycles pinning device handles
        sess = _make_session(no_accel)
        from .accel import active_engine
        eng = active_engine()
        if eng is None:
            print("no accelerator engine")
            return 0
        res = eng.residency.collect(eng, full=(cmd == "gc-major"))
        print(f"{res['kind']} collection: dropped "
              f"{res['cache_entries_dropped']} cached device args, "
              f"ledger {res['bytes_before']} -> {res['bytes_after']} bytes")
        return 0

    if cmd == "gc-config":
        from .accel import active_engine
        sess = _make_session(no_accel)
        eng = active_engine()
        if eng is None:
            print("no accelerator engine")
            return 0
        rs = eng.residency.snapshot()
        print(f"hbm budget: {rs['budget_bytes'] or 'unlimited'} "
              f"(set RUNMAT_TPU_HBM_BUDGET_MB)")
        print(f"pressure hooks: {len(eng.residency.pressure_hooks)}")
        print(f"fuse cap: {eng.fuse_cap} (RUNMAT_TPU_FUSE_CAP)")
        print(f"offload threshold: {eng.offload_threshold} "
              f"(RUNMAT_TPU_OFFLOAD_THRESHOLD)")
        print("shard threshold: none (sharded arrays are not yet ported, "
              "ROADMAP A 14)")
        print(f"generation promote-after: {eng.residency.promote_after} "
              f"(RUNMAT_TPU_GC_PROMOTE_AFTER)")
        return 0

    if cmd == "gc-stress":
        # allocation-churn soak validating the ledger's invariants
        # (≙ runmat gc stress / the miri soundness suite's role)
        from .accel import active_engine
        sess = _make_session(no_accel)
        eng = active_engine()
        if eng is None:
            print("no accelerator engine")
            return 1
        import gc as _pygc
        rounds = 50
        if "--rounds" in rest:
            rounds = int(rest[rest.index("--rounds") + 1])
        rs0 = eng.residency.snapshot()
        for k in range(rounds):
            sess.run_source(
                f"gs_a = gpuArray(rand(4096, 1)); "
                f"gs_b = sin(gs_a) + {k}; gs_c = gather(sum(gs_b)); "
                f"clear gs_a gs_b", "gc_stress")
        sess.run_source("clear gs_c", "gc_stress")
        _pygc.collect()
        rs1 = eng.residency.snapshot()
        leaked = rs1["live_bytes"] - rs0["live_bytes"]
        ok = (rs1["allocs"] > rs0["allocs"] and rs1["frees"] > rs0["frees"]
              and leaked <= 64 * 4096 * 8)
        print(f"gc-stress: {rounds} rounds, {rs1['allocs'] - rs0['allocs']} "
              f"allocs, {rs1['frees'] - rs0['frees']} frees, "
              f"residual {leaked} bytes, peak {rs1['peak_bytes']}, "
              f"promoted {rs1['promoted']}")
        print("OK" if ok else "FAILED: ledger leak detected")
        return 0 if ok else 1

    if cmd == "benchmark":
        return _benchmark(rest, no_accel)

    if cmd == "config":
        if "--generate" in rest or "--generate-config" in rest:
            from .config import generate_default
            path = generate_default()
            print(f"wrote {path}")
            return 0
        from .config import load
        print(json.dumps(load().describe(), indent=2, default=str))
        return 0

    if cmd == "lsp":
        from .lsp import main as lsp_main
        return lsp_main()

    if cmd == "serve":
        # JSON-lines session server (≙ the wasm/TS host + remote API surface)
        # --http serves the in-browser REPL (the wasm-embedding analog)
        from .server import serve_http, serve_stdio, serve_tcp
        sess = _make_session(no_accel)
        if rest and rest[0] == "--tcp":
            port = int(rest[1]) if len(rest) > 1 else 0
            return serve_tcp(sess, "127.0.0.1", port)
        if rest and rest[0] == "--http":
            port = int(rest[1]) if len(rest) > 1 else 8780
            return serve_http(sess, "127.0.0.1", port)
        return serve_stdio(sess)

    if cmd == "login":
        # runmat-tpu login <url> --token T (≙ runmat login, auth.rs)
        if not rest:
            print("usage: runmat-tpu login <url> --token <token>",
                  file=sys.stderr)
            return 2
        url = rest[0]
        token = rest[rest.index("--token") + 1] if "--token" in rest else ""
        from .remote import auth as rauth
        rauth.login(url, token)
        print(f"stored credentials for {url}")
        return 0

    if cmd == "remote":
        return _remote(rest)

    if cmd == "accel-calibrate":
        return _accel_calibrate()

    if cmd == "accel-warmup":
        # it replays the JAX package's manifest of XLA programs into XLA's
        # persistent cache, which exists only for the TPU
        from .errors import MatError
        raise MatError("RunMat:notPorted", "accel-warmup replays XLA "
                       "programs for the TPU and exists only there; the "
                       "port builds its kernels at first use")

    print(f"unknown command '{cmd}'", file=sys.stderr)
    return 2


def _accel_calibrate() -> int:
    """Measure the host-vs-card crossover size of an elementwise chain and
    persist it (≙ runmat accel-calibrate + the auto-offload calibration
    cache, crates/runmat-accelerate/src/native_auto.rs:478,706-724).
    `TorchEngine` reads the file back (`accel/engine.py:calibration_path`);
    the JAX package's TPU file is never read."""
    import time

    import numpy as np
    import torch

    from .accel import active_engine, init_engine
    from .accel.engine import calibration_path
    eng = active_engine() or init_engine()

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    def device_time(n: int) -> float:
        x = torch.linspace(0.0, 1.0, n, dtype=torch.float32,
                           device=eng.device)
        torch.sin(x) * x + 1.0
        sync()
        t0 = time.perf_counter()
        torch.sin(x) * x + 1.0
        sync()
        return time.perf_counter() - t0

    def host_time(n: int) -> float:
        x = np.linspace(0.0, 1.0, n, dtype=np.float32)
        t0 = time.perf_counter()
        np.sin(x) * x + 1.0
        return time.perf_counter() - t0

    crossover = None
    for n in (1 << k for k in range(10, 27)):
        dh, dt = host_time(n), device_time(n)
        print(f"  n={n:>10}: host {dh * 1e3:8.3f} ms   device {dt * 1e3:8.3f} ms")
        if dt < dh:
            crossover = n
            break
    if crossover is None:
        crossover = 1 << 26
    # the f64 GEMM's Ozaki crossover of the JAX package exists only for
    # the TPU's MXU and is not measured here
    info = eng.device_info()
    path = calibration_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"platform": eng.platform, "device": info["name"],
                   "offload_threshold": int(crossover)}, f)
    print(f"calibrated offload threshold: {crossover} for {info['name']} "
          f"(saved to {path})")
    return 0


def _check(rest: list) -> int:
    """Static checks: parse + compile without executing (≙ runmat check).
    `--mir` additionally dumps the basic-block CFG with liveness per unit."""
    dump_mir = "--mir" in rest
    rest = [r for r in rest if r != "--mir"]
    if not rest:
        print("usage: runmat-tpu check [--mir] <script.m>", file=sys.stderr)
        return 2
    from .errors import MatError
    from .frontend.parser import parse
    from .vm.compiler import Compiler
    from .analysis import analyze_source
    ok = True
    for path in rest:
        try:
            with open(path) as f:
                src = f.read()
            prog = parse(src, path)
            compiled = Compiler.compile_program(prog, path)
            if dump_mir:
                from .vm import mir
                print(mir.format_mir(compiled.main))
                for fn in compiled.functions.values():
                    print(mir.format_mir(fn))
        except MatError as e:
            ok = False
            print(f"{path}: error: {e.identifier}: {e.message}")
            continue
        except OSError as e:
            ok = False
            print(f"{path}: {e}")
            continue
        findings = analyze_source(src, path)
        if not findings:
            print(f"{path}: OK")
        for f2 in findings:
            if f2.severity == "error":
                ok = False
            print(f"{path}:{f2.line}: {f2.severity}: {f2.identifier}: "
                  f"{f2.message}")
    return 0 if ok else 1


def _remote(rest: list) -> int:
    """Remote project API commands (≙ runmat remote/org/project/fs/snapshot,
    runmat-cli's root.rs:207-333 and remote/* over runmat-server-client).

    remote serve <root> [--port N] [--token T]   self-host a project server
    remote me
    remote org list | org create <name>
    remote project list <orgId> | project create <orgId> <name>
    remote fs ls <proj> [path] | get <proj> <path> [out] |
              put <proj> <local> <path> | rm <proj> <path>
    remote snapshot list <proj> | create <proj> [label] |
              restore <proj> <snapId> | tag <proj> <snapId> <tag>
    remote history <proj>
    Server URL: --url flag or RUNMAT_TPU_API_URL (default
    http://127.0.0.1:8765)."""
    if not rest:
        print(_remote.__doc__, file=sys.stderr)
        return 2
    sub = rest[0]
    args = rest[1:]
    if sub == "serve":
        from .remote import ProjectServer
        root = args[0] if args else "."
        port = int(args[args.index("--port") + 1]) if "--port" in args \
            else 8765
        token = args[args.index("--token") + 1] if "--token" in args else None
        srv = ProjectServer(root, port=port, token=token)
        print(f"project server on {srv.base_url} (root {root})")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    url = None
    if "--url" in args:
        i = args.index("--url")
        url = args[i + 1]
        args = args[:i] + args[i + 2:]
    url = url or os.environ.get("RUNMAT_TPU_API_URL", "http://127.0.0.1:8765")
    from .errors import MatError
    from .remote import PublicApiClient
    c = PublicApiClient(url)
    try:
        if sub == "me":
            print(json.dumps(c.me()))
        elif sub == "org":
            if args and args[0] == "create":
                print(json.dumps(c.create_org(args[1])))
            else:
                for o in c.orgs():
                    print(f"{o['id']}  {o['name']}")
        elif sub == "project":
            if args and args[0] == "create":
                print(json.dumps(c.create_project(args[1], args[2])))
            else:
                org = args[1] if len(args) > 1 else args[0]
                for p in c.projects(org):
                    print(f"{p['id']}  {p['name']}")
        elif sub == "fs":
            op, proj = args[0], args[1]
            if op == "ls":
                for e in c.fs_dir(proj, args[2] if len(args) > 2 else ""):
                    kind = "d" if e["isDir"] else "f"
                    print(f"{kind} {e['size']:>10}  {e['name']}")
            elif op == "get":
                data = c.fs_read(proj, args[2])
                if len(args) > 3:
                    with open(args[3], "wb") as f:
                        f.write(data)
                    print(f"wrote {args[3]} ({len(data)} bytes)")
                else:
                    sys.stdout.write(data.decode("utf-8", "replace"))
            elif op == "put":
                with open(args[2], "rb") as f:
                    data = f.read()
                print(json.dumps(c.fs_write(proj, args[3], data)))
            elif op == "rm":
                c.fs_delete(proj, args[2])
                print("deleted")
            else:
                print(f"unknown fs op: {op}", file=sys.stderr)
                return 2
        elif sub == "snapshot":
            op, proj = args[0], args[1]
            if op == "list":
                for s in c.snapshots(proj):
                    tags = ",".join(s["tags"]) if s["tags"] else "-"
                    print(f"{s['id']}  files={s['fileCount']} tags={tags} "
                          f"{s['label']}")
            elif op == "create":
                print(json.dumps(c.create_snapshot(
                    proj, args[2] if len(args) > 2 else "")))
            elif op == "restore":
                c.restore_snapshot(proj, args[2])
                print("restored")
            elif op == "tag":
                print(json.dumps(c.tag_snapshot(proj, args[2], args[3])))
            else:
                print(f"unknown snapshot op: {op}", file=sys.stderr)
                return 2
        elif sub == "history":
            for e in c.history(args[0]):
                print(json.dumps(e))
        else:
            print(f"unknown remote subcommand: {sub}", file=sys.stderr)
            return 2
    except MatError as e:
        print(f"remote error: {e.identifier}: {e.message}", file=sys.stderr)
        return 1
    except IndexError:
        print(_remote.__doc__, file=sys.stderr)
        return 2
    return 0


def _benchmark(rest: list, no_accel=False) -> int:
    """Run the bundled benchmark suite (≙ runmat benchmark).
    `--small` presets reduced sizes (CPU smoke); the scripts honor pre-set
    workspace variables via their exist() guards."""
    import pathlib
    import time
    rest = list(rest)
    small = "--small" in rest
    if small:
        rest.remove("--small")
    sess = _make_session(no_accel)
    if small:
        sess.run_source("points = 100000; M = 10000; T = 16; B = 2;"
                        "H = 216; W = 384;", "<bench-small>")
    bdir = pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
    names = rest or [p.stem for p in sorted(bdir.glob("*.m"))]
    for name in names:
        src = (bdir / f"{name}.m").read_text()
        t0 = time.perf_counter()
        sess.run_source(src, name)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.run_source(src, name)
        print(f"{name}: warmup {warm*1e3:.1f} ms, "
              f"rep {(time.perf_counter()-t0)*1e3:.1f} ms")
    return 0


def repl(sess) -> int:
    from .errors import MatError
    print("runmat-tpu REPL (TPU-native MATLAB runtime). Ctrl-D to exit.")
    buf: list[str] = []
    while True:
        try:
            prompt = ">> " if not buf else ".. "
            line = input(prompt)
        except EOFError:
            print()
            return 0
        except KeyboardInterrupt:
            print("^C")
            buf = []
            continue
        buf.append(line)
        src = "\n".join(buf)
        if _needs_more(src):
            continue
        buf = []
        try:
            sess.run_source(src, "<repl>")
        except MatError as e:
            print(f"Error: {e.message}")


def _needs_more(src: str) -> bool:
    """Heuristic block-continuation check for the REPL."""
    from .frontend.lexer import tokenize
    from .errors import MatError
    try:
        toks = tokenize(src)
    except MatError:
        return False
    depth = 0
    for t in toks:
        if t.kind == "KW" and t.text in ("if", "for", "while", "switch", "try",
                                         "function", "parfor", "classdef"):
            depth += 1
        elif t.kind == "KW" and t.text == "end":
            depth = max(0, depth - 1)
    return depth > 0


if __name__ == "__main__":
    sys.exit(main())
