"""Copy of runmat_tpu/runtime/builtins/datetime_timing.py in the PyTorch port.

Date/time builtins: now, clock, datestr, cputime, etime, date.

Reference parity: runmat-runtime/src/builtins/{datetime,timing}/.
"""

from __future__ import annotations

import datetime as _dt
import time

import numpy as np

from ...values import MatArray
from ..registry import builtin


_EPOCH = _dt.datetime(1, 1, 1)


def _datenum(dt: _dt.datetime) -> float:
    delta = dt - _EPOCH
    return 367.0 + delta.days + (delta.seconds + delta.microseconds / 1e6) / 86400.0


@builtin("now", category="datetime", min_in=0, max_in=0)
def m_now():
    return MatArray.scalar(_datenum(_dt.datetime.now()))


@builtin("clock", category="datetime", min_in=0, max_in=0)
def m_clock():
    n = _dt.datetime.now()
    v = np.array([[n.year, n.month, n.day, n.hour, n.minute,
                   n.second + n.microsecond / 1e6]], dtype=np.float64)
    return MatArray(v, "double")


@builtin("date", category="datetime", min_in=0, max_in=0)
def m_date():
    return MatArray.char_from_str(_dt.datetime.now().strftime("%d-%b-%Y"))


@builtin("datestr", category="datetime", min_in=1, max_in=2)
def m_datestr(dn, fmt=None):
    days = dn.scalar_double()
    dt = _EPOCH + _dt.timedelta(days=days - 367.0)
    return MatArray.char_from_str(dt.strftime("%d-%b-%Y %H:%M:%S"))


@builtin("cputime", category="timing", min_in=0, max_in=0)
def m_cputime():
    return MatArray.scalar(time.process_time())


@builtin("etime", category="timing", min_in=2, max_in=2)
def m_etime(t1, t0):
    a = t1.host().reshape(-1)
    b = t0.host().reshape(-1)
    da = _dt.datetime(int(a[0]), int(a[1]), int(a[2]), int(a[3]), int(a[4])) + \
        _dt.timedelta(seconds=float(a[5]))
    db = _dt.datetime(int(b[0]), int(b[1]), int(b[2]), int(b[3]), int(b[4])) + \
        _dt.timedelta(seconds=float(b[5]))
    return MatArray.scalar((da - db).total_seconds())
