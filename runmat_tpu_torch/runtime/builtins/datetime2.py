"""Copy of runmat_tpu/runtime/builtins/datetime2.py in the PyTorch port.

Datetime batch 2: calendar arithmetic, shifting, component extraction,
epoch conversions.

Reference parity: runmat-runtime/src/builtins/datetime/ — dateshift, between,
caldays/calmonths/calyears, juliandate, ymd/hms, week, isbetween, posixtime,
exceltime. Calendar durations (month-granular arithmetic) are represented as
a tagged struct since their algebra differs from fixed durations.
"""

from __future__ import annotations

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, StructArray, fortran_ravel, is_text, text_of
from ..registry import builtin
from .common import scalar_int
from .datetime_builtins import MatDatetime, MatDuration


def _dt(v) -> MatDatetime:
    if not isinstance(v, MatDatetime):
        raise bad_arg("datetime", "Expected a datetime array.")
    return v


def _ymd_parts(d: np.ndarray):
    Y = d.astype("datetime64[Y]")
    M = d.astype("datetime64[M]")
    D = d.astype("datetime64[D]")
    years = Y.astype(np.int64) + 1970
    months = (M - Y).astype(np.int64) + 1
    days = (D - M).astype(np.int64) + 1
    return years, months, days


def _make_caldur(months: np.ndarray, days: np.ndarray = None) -> StructArray:
    return StructArray.scalar({
        "_calendarDuration": MatArray.logical_scalar(True),
        "months": MatArray(np.asarray(months, dtype=np.float64), "double"),
        "days": MatArray(np.asarray(days if days is not None
                                    else np.zeros_like(months)), "double"),
    })


_AVG_DAYS_PER_MONTH = 30.436875     # unit-conversion constant (≙ reference)


def _caldur_counts(cd, months_per_unit: float, days_per_unit: float):
    """calendarDuration -> unit counts (the extraction direction of the
    dual-mode cal* builtins, ≙ calendar_duration_unit_value)."""
    months = cd.get_scalar_field("months").host().astype(np.float64)
    days = cd.get_scalar_field("days").host().astype(np.float64)
    if months_per_unit != 0.0:
        out = months / months_per_unit \
            + days / _AVG_DAYS_PER_MONTH / months_per_unit
    else:
        out = days / days_per_unit
    return MatArray(out, "double")


@builtin("caldays", category="datetime", min_in=1, max_in=1)
def m_caldays(n):
    if is_caldur(n):
        return _caldur_counts(n, 0.0, 1.0)
    h = n.host().astype(np.float64)
    return _make_caldur(np.zeros_like(h), h)


@builtin("calmonths", category="datetime", min_in=1, max_in=1)
def m_calmonths(n):
    if is_caldur(n):
        return _caldur_counts(n, 1.0, 0.0)
    return _make_caldur(n.host().astype(np.float64))


@builtin("calyears", category="datetime", min_in=1, max_in=1)
def m_calyears(n):
    if is_caldur(n):
        return _caldur_counts(n, 12.0, 0.0)
    return _make_caldur(n.host().astype(np.float64) * 12)


@builtin("dateshift", category="datetime", min_in=3, max_in=4)
def m_dateshift(t, where, unit, rule=None):
    if rule is not None:
        # dateshift(t, 'start'|'end', unit, 'next'|'previous'|'current'|k):
        # land on the boundary of the k-th following/preceding unit
        base = m_dateshift(t, where, unit)
        r = text_of(rule).lower() if is_text(rule) else None
        if r == "current":
            return base
        u = text_of(unit).lower().rstrip("s")
        steps = {"next": 1.0, "previous": -1.0}.get(r)
        if steps is None:
            if is_text(rule):
                raise bad_arg("dateshift", f"Unknown rule '{text_of(rule)}'.")
            steps = float(rule.host().reshape(-1)[0])
        if u in ("month", "year", "quarter", "week"):
            months = {"month": 1, "year": 12, "quarter": 3}.get(u)
            if months is not None:
                return caldur_add(base, _make_caldur(
                    np.full(base.shape, months * steps)), 1.0)
            delta = (steps * 7 * 86_400_000_000)
        else:
            per_us = {"day": 86_400_000_000, "hour": 3_600_000_000,
                      "minute": 60_000_000, "second": 1_000_000}[u]
            delta = steps * per_us
        return MatDatetime(base.data
                           + np.timedelta64(int(round(delta)), "us"))
    d = _dt(t).data
    w = text_of(where).lower()
    u = text_of(unit).lower().rstrip("s")
    unit_code = {"day": "D", "month": "M", "year": "Y", "hour": "h",
                 "minute": "m", "second": "s", "week": "D"}.get(u)
    if unit_code is None:
        raise bad_arg("dateshift", f"Unknown unit '{text_of(unit)}'.")
    if u == "week":
        # start of week = previous Monday... MATLAB weeks start Sunday
        days = d.astype("datetime64[D]")
        dow = ((days.astype(np.int64) + 4) % 7)   # 0=Sunday
        start = days - dow.astype("timedelta64[D]")
        floor = start.astype("datetime64[us]")
        step = np.timedelta64(7, "D")
    else:
        floor = d.astype(f"datetime64[{unit_code}]").astype("datetime64[us]")
        one = {"D": np.timedelta64(1, "D"), "h": np.timedelta64(1, "h"),
               "m": np.timedelta64(1, "m"), "s": np.timedelta64(1, "s")}
        if unit_code in ("M", "Y"):
            nxt = (d.astype(f"datetime64[{unit_code}]") + 1).astype("datetime64[us]")
            step = None
        else:
            step = one[unit_code]
    if w == "start":
        return MatDatetime(floor)
    if w == "end":
        if u in ("month", "year"):
            return MatDatetime(nxt - np.timedelta64(1, "D"))
        return MatDatetime(floor + step - np.timedelta64(1, "us"))
    if w == "dayofnextweek" or w == "next":
        if u in ("month", "year"):
            return MatDatetime(nxt)
        return MatDatetime(floor + step)
    raise bad_arg("dateshift", f"Unknown position '{text_of(where)}'.")


@builtin("between", category="datetime", min_in=2, max_in=3)
def m_between(t1, t2, components=None):
    d1, d2 = _dt(t1).data, _dt(t2).data
    y1, m1, dd1 = _ymd_parts(d1)
    y2, m2, dd2 = _ymd_parts(d2)
    months = (y2 - y1) * 12 + (m2 - m1)
    days = dd2 - dd1
    # borrow when day-of-month underflows
    borrow = days < 0
    months = months - borrow.astype(np.int64)
    # days in the previous month of d2
    prev_m = d2.astype("datetime64[M]")
    dim = ((prev_m + 1).astype("datetime64[D]")
           - prev_m.astype("datetime64[D]")).astype(np.int64)
    days = np.where(borrow, days + dim, days)
    return _make_caldur(months.astype(np.float64), days.astype(np.float64))


@builtin("isbetween", category="datetime", min_in=3, max_in=3)
def m_isbetween(t, lo, hi):
    d = _dt(t).data
    return MatArray((d >= _dt(lo).data) & (d <= _dt(hi).data), "logical")


@builtin("juliandate", category="datetime", min_in=1, max_in=1)
def m_juliandate(t):
    d = _dt(t).data
    epoch = np.datetime64("1970-01-01T00:00:00", "us")
    days = (d - epoch) / np.timedelta64(1, "D")
    return MatArray(days.astype(np.float64) + 2440587.5, "double")


@builtin("posixtime", category="datetime", min_in=1, max_in=1)
def m_posixtime(t):
    d = _dt(t).data
    epoch = np.datetime64("1970-01-01T00:00:00", "us")
    return MatArray(((d - epoch) / np.timedelta64(1, "s")).astype(np.float64),
                    "double")


@builtin("exceltime", category="datetime", min_in=1, max_in=1)
def m_exceltime(t):
    d = _dt(t).data
    epoch = np.datetime64("1899-12-30T00:00:00", "us")
    return MatArray(((d - epoch) / np.timedelta64(1, "D")).astype(np.float64),
                    "double")


@builtin("ymd", category="datetime", min_in=1, max_in=1, pass_nargout=True)
def m_ymd(t, nargout=3):
    y, m, d = _ymd_parts(_dt(t).data)
    outs = [MatArray(y.astype(np.float64), "double"),
            MatArray(m.astype(np.float64), "double"),
            MatArray(d.astype(np.float64), "double")]
    return outs[:max(1, nargout)]


@builtin("hms", category="datetime", min_in=1, max_in=1, pass_nargout=True)
def m_hms(t, nargout=3):
    if isinstance(t, MatDuration):
        total = t.data / np.timedelta64(1, "s")
        h = np.floor(total / 3600)
        m = np.floor((total - h * 3600) / 60)
        s = total - h * 3600 - m * 60
    else:
        d = _dt(t).data
        day = d.astype("datetime64[D]").astype("datetime64[us]")
        total = (d - day) / np.timedelta64(1, "s")
        h = np.floor(total / 3600)
        m = np.floor((total - h * 3600) / 60)
        s = total - h * 3600 - m * 60
    outs = [MatArray(h.astype(np.float64), "double"),
            MatArray(m.astype(np.float64), "double"),
            MatArray(s.astype(np.float64), "double")]
    return outs[:max(1, nargout)]


@builtin("week", category="datetime", min_in=1, max_in=2)
def m_week(t, kind=None):
    d = _dt(t).data
    ystart = d.astype("datetime64[Y]").astype("datetime64[D]")
    doy = (d.astype("datetime64[D]") - ystart).astype(np.int64) + 1
    return MatArray(np.ceil(doy / 7.0), "double")


@builtin("tzoffset", category="datetime", min_in=1, max_in=1)
def m_tzoffset(t):
    _dt(t)
    z = np.zeros(t.shape)
    return MatDuration(z.astype("timedelta64[us]"))


# calendar-duration arithmetic hook: datetime +/- calendarDuration
def caldur_add(dtv: MatDatetime, cd: StructArray, sign: float) -> MatDatetime:
    months = fortran_ravel(cd.get_scalar_field("months").host()) * sign
    days = fortran_ravel(cd.get_scalar_field("days").host()) * sign
    d = dtv.data
    y, m, dd = _ymd_parts(d)
    day_part = d - d.astype("datetime64[D]").astype("datetime64[us]")
    tot_m = (y * 12 + (m - 1)).astype(np.float64) + months
    new_y = np.floor(tot_m / 12).astype(np.int64)
    new_m = (tot_m - new_y * 12).astype(np.int64)
    month_start = (np.array(new_y - 1970, dtype="datetime64[Y]")
                   .astype("datetime64[M]") + new_m)
    # clamp day-of-month to the target month's length
    dim = ((month_start + 1).astype("datetime64[D]")
           - month_start.astype("datetime64[D]")).astype(np.int64)
    dd2 = np.minimum(dd, dim)
    out = (month_start.astype("datetime64[D]")
           + (dd2 - 1).astype("timedelta64[D]")).astype("datetime64[us]")
    out = out + days.astype("timedelta64[D]").astype("timedelta64[us]") * 86_400_000_000 \
        if False else out + (days * 86_400_000_000).astype("timedelta64[us]")
    return MatDatetime((out + day_part).reshape(d.shape))


def is_caldur(v) -> bool:
    return isinstance(v, StructArray) and v.is_scalar and \
        "_calendarDuration" in v.fields
