"""Copy of runmat_tpu/accel/residency.py in the PyTorch port.

HBM residency ledger: the TPU-native analog of the reference GC's
memory-accounting layer.

Reference parity: runmat-gc (crates/runmat-gc/src/{lib.rs,stats.rs,
config.rs:11-23}) + the wgpu buffer residency pool
(runmat-accelerate/src/backend/wgpu/residency.rs, provider/init.rs:26-60).
The reference needs a tracing GC because Rust values own GPU buffers through
handle tables; here the host language refcounts MatArrays, so the TPU-native
design splits the GC's two jobs:

  1. *Reclamation* — host refcounting + jax buffer lifetime (automatic).
  2. *Accounting & pressure* — this module: every LazyNode that acquires a
     concrete device buffer is tracked (bytes, count, peak) via a weakref
     finalizer, a configurable HBM budget fires pressure hooks (the session
     registers a workspace spiller that gathers cold arrays to host), and
     collect() drops the engine's transient device caches.

Accounting is per-handle (a buffer shared by two nodes counts twice), the
same contract as the reference's per-handle residency marks (api lib.rs:67).
"""

from __future__ import annotations

import os
import weakref


class ResidencyPool:
    def __init__(self, budget_bytes: int | None = None):
        if budget_bytes is None:
            mb = os.environ.get("RUNMAT_TPU_HBM_BUDGET_MB")
            budget_bytes = int(float(mb) * 1e6) if mb else 0
        self.budget_bytes = int(budget_bytes)     # 0 = unlimited
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_live = 0
        self.allocs = 0
        self.frees = 0
        self.freed_bytes = 0
        self.pressure_events = 0
        self.pressure_hooks: list = []            # callables(pool) -> None
        self._in_pressure = False
        # generational accounting (≙ runmat-gc GcConfig generation sizing)
        self.promote_after = int(os.environ.get(
            "RUNMAT_TPU_GC_PROMOTE_AFTER", "64"))
        self.promoted = 0
        self._gen: dict = {}                      # birth_seq -> nbytes live

    # ------------------------------------------------------------- tracking

    def track(self, node) -> None:
        """Account one node's freshly-set device buffer; called from the
        LazyNode.value setter. The finalizer keys on the NODE: when the host
        drops its last reference the buffer bytes leave the ledger.
        Generational accounting (≙ runmat-gc generations.rs): each handle is
        born YOUNG; handles surviving `promote_after` later allocations are
        counted OLD — the gc-stats young/old split and promotion counter
        mirror the reference's nursery/tenured story on top of refcounted
        reclamation."""
        v = node._value
        nb = int(getattr(v, "nbytes", 0) or 0)
        if nb <= 0:
            return
        self.allocs += 1
        self.n_live += 1
        self.live_bytes += nb
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        self._gen[self.allocs] = nb             # birth sequence
        weakref.finalize(node, self._freed, nb, self.allocs)
        if self.budget_bytes and self.live_bytes > self.budget_bytes:
            self._pressure()

    def _freed(self, nb: int, birth: int) -> None:
        self.live_bytes -= nb
        self.n_live -= 1
        self.frees += 1
        self.freed_bytes += nb
        if self.allocs - birth >= self.promote_after:
            self.promoted += 1                 # died tenured
        self._gen.pop(birth, None)

    def generation_stats(self) -> dict:
        """young/old live-byte split at the current allocation clock."""
        young = old = 0
        for birth, nb in self._gen.items():
            if self.allocs - birth < self.promote_after:
                young += nb
            else:
                old += nb
        return {"young_bytes": young, "old_bytes": old,
                "promote_after": self.promote_after,
                "promoted": self.promoted}

    def _pressure(self) -> None:
        """Over budget: run registered hooks (spillers) once, non-reentrant
        (a hook that gathers arrays to host triggers track() again)."""
        if self._in_pressure:
            return
        self._in_pressure = True
        try:
            self.pressure_events += 1
            for hook in list(self.pressure_hooks):
                try:
                    hook(self)
                except Exception:
                    pass   # pressure response is best-effort, never fatal
        finally:
            self._in_pressure = False

    @property
    def over_budget(self) -> bool:
        return bool(self.budget_bytes) and self.live_bytes > self.budget_bytes

    # ------------------------------------------------------------ collection

    def collect(self, engine, full: bool = False) -> dict:
        """Minor: drop the engine's transient device caches (loop-arg zeros /
        itvec placeholders). Major (full=True): additionally run the host GC
        to break cycles pinning nodes, and clear the sync-probe cache.
        (≙ runmat gc minor/major, runmat-gc/src/lib.rs:548,725)"""
        before = self.live_bytes
        cache = getattr(engine, "_loop_arg_cache", None)
        n_cache = len(cache) if cache else 0
        if cache:
            cache.clear()
        if full:
            probes = [k for k in engine._jit_cache
                      if isinstance(k, tuple) and k and k[0] == "sync_probe"]
            for k in probes:
                del engine._jit_cache[k]
            import gc as _pygc
            _pygc.collect()
        return {"kind": "major" if full else "minor",
                "cache_entries_dropped": n_cache,
                "bytes_before": before,
                "bytes_after": self.live_bytes,
                "bytes_freed": max(0, before - self.live_bytes)}

    # -------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        out = {
            "live_bytes": self.live_bytes,
            "peak_bytes": self.peak_bytes,
            "n_live": self.n_live,
            "allocs": self.allocs,
            "frees": self.frees,
            "freed_bytes": self.freed_bytes,
            "budget_bytes": self.budget_bytes,
            "pressure_events": self.pressure_events,
        }
        out.update(self.generation_stats())
        return out


def make_workspace_spiller(session, keep_fraction: float = 0.7):
    """Pressure hook: gather the coldest device-resident workspace arrays to
    host until the ledger is back under keep_fraction x budget. Coldness =
    lowest producing dispatch id (stream order makes that
    least-recently-computed). Spilled variables keep full MATLAB semantics —
    they simply re-upload on next device use (≙ the reference's residency
    clearing + gather-retry dispatcher, runmat-runtime/src/dispatcher.rs)."""
    from ..values import MatArray

    def spill(pool: ResidencyPool) -> None:
        target = int(pool.budget_bytes * keep_fraction)
        # Base workspace plus every live interpreter frame: device arrays
        # held by in-flight function calls are spill candidates too.
        frames = [session.base_frame]
        interp = getattr(session, "interp", None)
        for fr in getattr(interp, "active_frames", ()):
            if fr is not session.base_frame:
                frames.append(fr)
        candidates = []
        for frame in frames:
            for name, v in list(frame.vars.items()):
                if isinstance(v, MatArray) and v.on_device and \
                        v.dev.value is not None:
                    nb = int(getattr(v.dev.value, "nbytes", 0) or 0)
                    if nb > 0:
                        age = v.dev.dispatch_id or 0
                        candidates.append((age, nb, name, frame, v))
        candidates.sort(key=lambda t: t[0])
        for age, nb, name, frame, v in candidates:
            if pool.live_bytes <= target:
                break
            host = v.dev.gather()
            frame.vars[name] = MatArray(host, v.mclass)
        session._spill_count = getattr(session, "_spill_count", 0) + 1

    return spill
