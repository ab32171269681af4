"""Copy of runmat_tpu/runtime/builtins/async_builtins.py in the PyTorch port.

Async task extension: spawn/await + parfeval-style futures.

Reference parity: the Spawn/Await bytecode ops + async-function beta
(runmat-vm/src/bytecode/instr.rs:259-261, docs/execution/async.md) and the
SpawnHandleConcurrency device-handle policy
(runmat-accelerate-api/src/lib.rs:824-845). Tasks run on host threads; device
values crossing a task boundary are safe by construction — jax arrays are
immutable, so the policy is ImmutableShare (the reference's safest mode).
Each task gets its own interpreter over the shared session (MATLAB workers
share nothing; here the base workspace is snapshotted per task argument).
"""

from __future__ import annotations

import threading

import numpy as np

from ...errors import MatError
from ...values import CellArray, FunctionHandle, MatArray, OutputList
from ..registry import builtin


class Future:
    """≙ reference spawn handle (Value::HandleObject task handle)."""

    __slots__ = ("thread", "result", "error", "done", "nout", "shared")
    mclass = "parallel.Future"

    def __init__(self, nout: int):
        self.thread = None
        self.result = None
        self.error = None
        self.done = threading.Event()
        self.nout = nout
        self.shared = False

    def wait(self, timeout=None) -> bool:
        return self.done.wait(timeout)


def _mark_cow(v):
    """Copy-on-write across the task boundary (≙ SpawnHandleConcurrency::
    CopyOnWrite): any value reachable from both the parent workspace and the
    task gets its shared flag set, so the first indexed write in either side
    copies instead of mutating the other's buffer. Device (jax) arrays are
    immutable already (ImmutableShare)."""
    if isinstance(v, MatArray):
        v.shared = True
    elif isinstance(v, CellArray):
        for e in v.data.reshape(-1):
            _mark_cow(e)
    elif hasattr(v, "fields"):
        for col in v.fields.values():
            for e in np.asarray(col).reshape(-1):
                _mark_cow(e)
    return v


def _run_task(fut: Future, interp, f, args, nout):
    try:
        from ...vm.interp import Frame
        args = [_mark_cow(a) for a in args]
        res = interp.call_value(f, list(args), nout, Frame(None))
        fut.result = res
    except MatError as e:
        fut.error = e
    except Exception as e:  # noqa: BLE001
        fut.error = MatError("MATLAB:parfeval:taskError", str(e))
    finally:
        fut.done.set()


@builtin("parfeval", category="async", min_in=2, max_in=None, pass_ctx=True)
def m_parfeval(*args, ctx=None):
    """F = parfeval(fn, nargout, a1, a2, ...) — also accepts a leading pool
    argument which is ignored (there is one in-process 'pool')."""
    args = list(args)
    if args and not isinstance(args[0], (FunctionHandle, MatArray)):
        args = args[1:]
    if args and isinstance(args[0], MatArray) and args[0].mclass not in ("char",):
        args = args[1:]   # pool object placeholder
    f = args[0]
    nout = int(args[1].host().reshape(-1)[0]) if len(args) > 1 else 1
    call_args = args[2:]
    fut = Future(nout)
    t = threading.Thread(target=_run_task,
                         args=(fut, ctx.interp, f, call_args, max(nout, 0)),
                         daemon=True)
    fut.thread = t
    t.start()
    return fut


@builtin("spawn", category="async", min_in=1, max_in=None, pass_ctx=True)
def m_spawn(f, *call_args, ctx=None):
    """h = spawn(@() work()) — the reference's async-spawn extension."""
    fut = Future(1)
    t = threading.Thread(target=_run_task,
                         args=(fut, ctx.interp, f, list(call_args), 1),
                         daemon=True)
    fut.thread = t
    t.start()
    return fut


def _fetch(fut: Future, nargout: int):
    fut.wait()
    if fut.error is not None:
        raise fut.error
    res = fut.result or []
    if nargout <= 1:
        return res[0] if res else MatArray.empty()
    return list(res[:nargout])


@builtin("await", category="async", min_in=1, max_in=1, pass_nargout=True)
def m_await(fut, nargout=1):
    if not isinstance(fut, Future):
        return fut          # awaiting a plain value yields the value
    return _fetch(fut, nargout)


@builtin("fetchOutputs", category="async", min_in=1, max_in=1, pass_nargout=True)
def m_fetchoutputs(fut, nargout=1):
    if not isinstance(fut, Future):
        raise MatError("MATLAB:fetchOutputs:notFuture",
                       "fetchOutputs requires a Future.")
    return _fetch(fut, max(nargout, fut.nout if fut.nout else 1))


@builtin("cancel", category="async", min_in=1, max_in=1)
def m_cancel(fut):
    # cooperative: threads can't be killed; mark done with an error
    if isinstance(fut, Future) and not fut.done.is_set():
        fut.error = MatError("MATLAB:parfeval:cancelled", "Task was cancelled.")
        fut.done.set()
    return None


@builtin("wait", category="async", min_in=1, max_in=2)
def m_wait(fut, timeout=None):
    if isinstance(fut, Future):
        t = float(timeout.host().reshape(-1)[0]) if timeout is not None else None
        ok = fut.wait(t)
        return MatArray.logical_scalar(bool(ok))
    return MatArray.logical_scalar(True)


@builtin("isdone", category="async", min_in=1, max_in=1)
def m_isdone(fut):
    return MatArray.logical_scalar(isinstance(fut, Future) and
                                   fut.done.is_set())


@builtin("parpool", category="async", max_in=1)
def m_parpool(n=None):
    """In-process pool placeholder (single shared engine)."""
    import os
    from ...values import StructArray
    return StructArray.scalar({
        "NumWorkers": MatArray.scalar(float(os.cpu_count() or 1)),
        "Connected": MatArray.logical_scalar(True),
    })


@builtin("backgroundPool", category="async", max_in=0)
def m_backgroundpool():
    return m_parpool()
