"""Copy of runmat_tpu/runtime/builtins/timing2.py in the PyTorch port.

Timing batch 2: timeit and timer objects.

Reference parity: runmat-runtime/src/builtins/timing/{timeit,timer,timerfind}
(+ the __runmat_timer_* hooks). Timers execute on host threads; start/stop/
wait/delete are methods through the built-in-object protocol.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ...errors import MatError, bad_arg
from ...values import CellArray, MatArray, text_of
from ..registry import builtin
from .common import scalar_int, scalar_num


@builtin("timeit", category="timing", min_in=1, max_in=2, pass_ctx=True)
def m_timeit(f, nout=None, ctx=None):
    """Median wall-clock of calling f, with warmup and adaptive rep count."""
    n_out = scalar_int(nout, "numOutputs") if nout is not None else 1

    def once() -> float:
        t0 = time.perf_counter()
        ctx.interp.call_value(f, [], n_out, ctx.frame)
        return time.perf_counter() - t0

    once()  # warmup
    t1 = once()
    reps = max(1, min(100, int(0.01 / max(t1, 1e-7))))
    times = [once() for _ in range(reps)]
    times.sort()
    return MatArray.scalar(float(times[len(times) // 2]))


class TimerValue:
    """MATLAB timer: periodic/one-shot callback execution on a host thread."""

    mclass = "timer"
    shared = False
    _ALL: list = []

    def __init__(self, interp, frame):
        self.interp = interp
        self.frame = frame
        self.period = 1.0
        self.tasks = 1          # TasksToExecute
        self.mode = "singleShot"  # ExecutionMode
        self.start_delay = 0.0
        self.timer_fcn = None
        self.name = f"timer-{len(TimerValue._ALL) + 1}"
        self.tag = ""
        self.executed = 0
        self.running = False
        self._thread = None
        self._stop = threading.Event()
        TimerValue._ALL.append(self)

    @property
    def size(self):
        return 1

    @property
    def shape(self):
        return (1, 1)

    def copy(self):
        return self   # handle semantics

    def _run(self):
        if self.start_delay > 0:
            if self._stop.wait(self.start_delay):
                self.running = False
                return
        while not self._stop.is_set():
            if self.timer_fcn is not None:
                try:
                    self.interp.call_value(self.timer_fcn, [self, MatArray.empty()],
                                           0, self.frame)
                except Exception:
                    pass
            self.executed += 1
            if self.mode == "singleShot" or \
                    (self.tasks > 0 and self.executed >= self.tasks):
                break
            if self._stop.wait(self.period):
                break
        self.running = False

    def start(self):
        if self.running:
            raise MatError("MATLAB:timer:alreadystarted", "Timer is already running.")
        self._stop.clear()
        self.running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.running = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        self.running = False

    def delete(self):
        self.stop()
        if self in TimerValue._ALL:
            TimerValue._ALL.remove(self)

    # -- object protocol -- #

    def _mat_call_method_(self, interp, frame, fname, args, nargout):
        if fname == "start":
            self.start()
            return []
        if fname == "stop":
            self.stop()
            return []
        if fname == "wait":
            self.wait()
            return []
        if fname == "delete":
            self.delete()
            return []
        return NotImplemented

    _FIELD_MAP = {
        "Period": "period", "TasksToExecute": "tasks",
        "ExecutionMode": "mode", "StartDelay": "start_delay",
        "TimerFcn": "timer_fcn", "Name": "name", "Tag": "tag",
    }

    def _mat_get_field_(self, fname):
        if fname == "Running":
            return MatArray.char_from_str("on" if self.running else "off")
        if fname == "TasksExecuted":
            return MatArray.scalar(float(self.executed))
        attr = self._FIELD_MAP.get(fname)
        if attr is None:
            return NotImplemented
        v = getattr(self, attr)
        if isinstance(v, str):
            return MatArray.char_from_str(v)
        if isinstance(v, (int, float)):
            return MatArray.scalar(float(v))
        return v if v is not None else MatArray.empty()

    def _mat_set_field_(self, fname, value):
        attr = self._FIELD_MAP.get(fname)
        if attr is None:
            return NotImplemented
        if attr in ("period", "start_delay"):
            setattr(self, attr, float(value.host().reshape(-1)[0]))
        elif attr == "tasks":
            setattr(self, attr, int(value.host().reshape(-1)[0]))
        elif attr in ("mode", "name", "tag"):
            setattr(self, attr, text_of(value))
        else:
            setattr(self, attr, value)
        return True


@builtin("timer", category="timing", min_in=0, pass_ctx=True)
def m_timer(*args, ctx=None):
    t = TimerValue(ctx.interp, ctx.frame)
    i = 0
    args = list(args)
    while i + 1 < len(args):
        name = text_of(args[i])
        t._mat_set_field_(name, args[i + 1])
        i += 2
    return t


def _timer_cell(timers):
    data = np.empty((1, len(timers)), dtype=object)
    for i, t in enumerate(timers):
        data[0, i] = t
    return CellArray(data)


@builtin("timerfind", category="timing", min_in=0, pass_ctx=True)
def m_timerfind(*args, ctx=None):
    sel = list(TimerValue._ALL)
    i = 0
    args = list(args)
    while i + 1 < len(args):
        key, val = text_of(args[i]), args[i + 1]
        if key == "Name":
            sel = [t for t in sel if t.name == text_of(val)]
        elif key == "Tag":
            sel = [t for t in sel if t.tag == text_of(val)]
        i += 2
    if len(sel) == 1:
        return sel[0]
    return _timer_cell(sel)


@builtin("timerfindall", category="timing", min_in=0, max_in=0)
def m_timerfindall():
    sel = list(TimerValue._ALL)
    if len(sel) == 1:
        return sel[0]
    return _timer_cell(sel)


# function forms on timer handles

@builtin("startat", category="timing", min_in=2, max_in=2)
def m_startat(t, when):
    if not isinstance(t, TimerValue):
        raise bad_arg("startat", "Expected a timer.")
    # delay until the given serial date number
    target = float(when.host().reshape(-1)[0])
    now_dn = time.time() / 86400.0 + 719529.0
    t.start_delay = max(0.0, (target - now_dn) * 86400.0)
    t.start()
    return None
