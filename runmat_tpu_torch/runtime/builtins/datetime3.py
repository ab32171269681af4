"""Copy of runmat_tpu/runtime/builtins/datetime3.py in the PyTorch port.

Datetime batch 3: calendarDuration constructors, date vectors, and the
exchange-calendar business-day family.

Reference parity: runmat-runtime/src/builtins/datetime/mod.rs —
calendarDuration/calweeks/calquarters (:2299-2431), datevec matrix +
multi-output (:1410-1431, :2084-2140), eomday (:2206), today (:2012),
datetick compat no-op (:2839), and the financial calendar: NYSE-style
market holidays (observed fixed dates, nth/last weekdays, Good Friday via
the Gregorian computus, :1560-1654), isbusday/busdays/days252bus/daysdif/
fbusdate/lbusdate (:2443-2830). Business-day math runs on integer date
keys (floor of the MATLAB serial datenum); `holidays` returns a datetime
column while busdays/fbusdate/lbusdate return serial datenums, matching
the reference's return types.
"""

from __future__ import annotations

import datetime as _pydt

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, OutputList, StructArray, is_text, text_of
from ..registry import builtin
from .datetime2 import _make_caldur, is_caldur
from .datetime_builtins import MatDatetime, MatDuration, _dt_to_datenum

_EPOCH_SERIAL = 719529.0            # datenum of 1970-01-01 (datetime64 epoch)
_AVG_DAYS_PER_MONTH = 30.436875     # reference unit-conversion constant
_MAX_BUSDAYS = 1_000_000
_MAX_HOLIDAY_YEAR_SPAN = 1_000


# --------------------------------------------------------------------------- #
# serial/key helpers
# --------------------------------------------------------------------------- #

def _serials(v, name: str) -> np.ndarray:
    """Numeric datenums / datetime arrays / date text -> float serial array."""
    if isinstance(v, MatDatetime):
        us = v.data.astype("datetime64[us]").astype(np.int64)
        return us / 86.4e9 + _EPOCH_SERIAL
    if is_text(v):
        from .datetime_builtins import _parse_dt_text
        return np.array([[_dt_to_datenum(_parse_dt_text(text_of(v)))]])
    if isinstance(v, MatArray) and not v.is_complex:
        out = v.host().astype(np.float64)
        if not np.isfinite(out).all():
            raise MatError("MATLAB:datetime:invalidDate",
                           f"{name}: date values must be finite.")
        return out
    raise bad_arg(name, "Expected serial date numbers, datetime values, "
                        "or date text.")


def _keys(serials: np.ndarray) -> np.ndarray:
    return np.floor(serials).astype(np.int64)


def _key_to_date(key: int) -> _pydt.date:
    return (_pydt.date(1970, 1, 1)
            + _pydt.timedelta(days=int(key) - int(_EPOCH_SERIAL)))


def _date_to_key(d: _pydt.date) -> int:
    return (d - _pydt.date(1970, 1, 1)).days + int(_EPOCH_SERIAL)


def _is_weekend_key(key: int) -> bool:
    return _key_to_date(key).weekday() >= 5        # Sat=5, Sun=6


# --------------------------------------------------------------------------- #
# NYSE-style market holiday calendar (≙ market_holiday_keys_for_year)
# --------------------------------------------------------------------------- #

def _observed_fixed(year: int, month: int, day: int) -> int:
    d = _pydt.date(year, month, day)
    if d.weekday() == 5:                           # Saturday -> Friday
        d -= _pydt.timedelta(days=1)
    elif d.weekday() == 6:                         # Sunday -> Monday
        d += _pydt.timedelta(days=1)
    return _date_to_key(d)


def _nth_weekday(year: int, month: int, weekday: int, n: int) -> int:
    d = _pydt.date(year, month, 1)
    while d.weekday() != weekday:
        d += _pydt.timedelta(days=1)
    return _date_to_key(d + _pydt.timedelta(days=(n - 1) * 7))


def _last_weekday(year: int, month: int, weekday: int) -> int:
    nxt = _pydt.date(year + (month == 12), month % 12 + 1, 1)
    d = nxt - _pydt.timedelta(days=1)
    while d.weekday() != weekday:
        d -= _pydt.timedelta(days=1)
    return _date_to_key(d)


def _easter_sunday(year: int) -> _pydt.date:
    # anonymous Gregorian computus (public algorithm)
    a = year % 19
    b, c = divmod(year, 100)
    d, e = divmod(b, 4)
    f = (b + 8) // 25
    g = (b - f + 1) // 3
    h = (19 * a + b - d - g + 15) % 30
    i, k = divmod(c, 4)
    m_l = (32 + 2 * e + 2 * i - h - k) % 7
    m = (a + 11 * h + 22 * m_l) // 451
    month, day = divmod(h + m_l - 7 * m + 114, 31)
    return _pydt.date(year, month, day + 1)


def _market_holidays_for_year(year: int) -> list:
    keys = [
        _observed_fixed(year, 1, 1),               # New Year's (observed)
        _nth_weekday(year, 1, 0, 3),               # MLK: 3rd Mon Jan
        _nth_weekday(year, 2, 0, 3),               # Washington: 3rd Mon Feb
        _date_to_key(_easter_sunday(year) - _pydt.timedelta(days=2)),
        _last_weekday(year, 5, 0),                 # Memorial: last Mon May
        _observed_fixed(year, 6, 19),              # Juneteenth (observed)
        _observed_fixed(year, 7, 4),               # Independence (observed)
        _nth_weekday(year, 9, 0, 1),               # Labor: 1st Mon Sep
        _nth_weekday(year, 11, 3, 4),              # Thanksgiving: 4th Thu Nov
        _observed_fixed(year, 12, 25),             # Christmas (observed)
    ]
    return sorted(set(keys))


def _holiday_keys_between(k0: int, k1: int) -> list:
    lo, hi = min(k0, k1), max(k0, k1)
    y0 = _key_to_date(lo).year - 1
    y1 = _key_to_date(hi).year + 1
    if y1 - y0 > _MAX_HOLIDAY_YEAR_SPAN:
        raise MatError("MATLAB:holidays:rangeTooLarge",
                       "holidays: date range spans more than "
                       f"{_MAX_HOLIDAY_YEAR_SPAN} years.")
    keys: list = []
    for y in range(y0, y1 + 1):
        keys.extend(_market_holidays_for_year(y))
    return sorted({k for k in keys if lo <= k <= hi})


def _holiday_set(opt, name: str, k0: int, k1: int) -> set:
    if opt is not None:
        return set(int(k) for k in _keys(_serials(opt, name)).reshape(-1))
    return set(_holiday_keys_between(k0, k1))


def _is_busday_key(key: int, hols: set) -> bool:
    return not _is_weekend_key(key) and key not in hols


def _count_busdays(k0: int, k1: int, hols: set) -> int:
    if k0 > k1:
        return -_count_busdays(k1, k0, hols)
    total = k1 - k0 + 1
    count = (total // 7) * 5
    for off in range(total % 7):
        if not _is_weekend_key(k0 + off):
            count += 1
    for h in hols:
        if k0 <= h <= k1 and not _is_weekend_key(h):
            count -= 1
    return count


def _dt_from_keys(keys, shape) -> MatDatetime:
    arr = ((np.asarray(keys, np.int64) - int(_EPOCH_SERIAL))
           .astype("timedelta64[D]")
           + np.datetime64("1970-01-01", "D")).astype("datetime64[us]")
    return MatDatetime(arr.reshape(shape))


# --------------------------------------------------------------------------- #
# calendarDuration family
# --------------------------------------------------------------------------- #

def _component(v, name: str) -> np.ndarray:
    if not isinstance(v, MatArray) or v.is_complex:
        raise bad_arg(name, "Calendar components must be real numeric.")
    return v.host().astype(np.float64)


@builtin("calendarDuration", category="datetime", max_in=6)
def m_calendarduration(*args):
    if not args:
        return _make_caldur(np.zeros((1, 1)), np.zeros((1, 1)))
    if len(args) == 1 and is_caldur(args[0]):
        return args[0]
    if len(args) == 1:
        d = _component(args[0], "calendarDuration")
        return _make_caldur(np.zeros_like(d), d)
    if len(args) == 2 or len(args) > 6:
        raise bad_arg("calendarDuration",
                      "Expected no input, days, or Y/M/D[/H/M/S] components.")
    comps = [_component(a, "calendarDuration") for a in args]
    comps += [np.zeros((1, 1))] * (6 - len(comps))
    y, mo, d, h, mi, s = np.broadcast_arrays(*comps)
    months = y * 12.0 + mo
    days = d + h / 24.0 + mi / 1440.0 + s / 86400.0
    if not (np.isfinite(months).all() and np.isfinite(days).all()):
        raise MatError("MATLAB:calendarDuration:outOfRange",
                       "calendarDuration: resulting calendar duration is "
                       "outside the supported range.")
    return _make_caldur(months.copy(), days.copy())


@builtin("iscalendarduration", category="datetime", min_in=1, max_in=1)
def m_iscalendarduration(v):
    return MatArray.logical_scalar(is_caldur(v))


def _cal_unit(name: str, months_per_unit: float, days_per_unit: float):
    """Dual-direction unit builtin: numeric -> calendarDuration; a
    calendarDuration input converts back to unit counts (average-month
    length for mixed components, ≙ calendar_duration_unit_value)."""
    @builtin(name, category="datetime", min_in=1, max_in=1)
    def _f(v, _name=name, _mpu=months_per_unit, _dpu=days_per_unit):
        if is_caldur(v):
            months = v.get_scalar_field("months").host().astype(np.float64)
            days = v.get_scalar_field("days").host().astype(np.float64)
            if _mpu != 0.0:
                out = months / _mpu + days / _AVG_DAYS_PER_MONTH / _mpu
            else:
                out = days / _dpu
            return MatArray(out, "double")
        n = _component(v, _name)
        if not np.isfinite(n).all():
            raise MatError(f"MATLAB:{_name}:nonFinite",
                           f"{_name}: values must be finite.")
        return _make_caldur(n * _mpu, n * _dpu)
    return _f


_cal_unit("calweeks", 0.0, 7.0)
_cal_unit("calquarters", 3.0, 0.0)


# --------------------------------------------------------------------------- #
# date vectors / month ends / today / datetick
# --------------------------------------------------------------------------- #

@builtin("datevec", category="datetime", min_in=1, max_in=1,
         pass_nargout=True, max_out=6)
def m_datevec(v, nargout=1):
    serials = _serials(v, "datevec").reshape(-1)
    us = np.round((serials - _EPOCH_SERIAL) * 86.4e9).astype(np.int64)
    d = us.astype("timedelta64[us]") + np.datetime64("1970-01-01", "us")
    Y = d.astype("datetime64[Y]")
    M = d.astype("datetime64[M]")
    D = d.astype("datetime64[D]")
    years = Y.astype(np.int64) + 1970.0
    months = (M - Y).astype(np.int64) + 1.0
    days = (D - M).astype(np.int64) + 1.0
    rem_us = (d - D).astype("timedelta64[us]").astype(np.int64)
    hours = rem_us // 3_600_000_000
    rem_us -= hours * 3_600_000_000
    minutes = rem_us // 60_000_000
    secs = (rem_us - minutes * 60_000_000) / 1e6
    cols = [years, months, days, hours.astype(np.float64),
            minutes.astype(np.float64), secs]
    if nargout > 1:
        n = serials.size
        return OutputList([MatArray(np.asarray(c, np.float64)
                                    .reshape(n, 1) if n != 1 else
                                    np.asarray(c, np.float64).reshape(1, 1),
                                    "double")
                           for c in cols[:nargout]])
    mat = np.stack([np.asarray(c, np.float64) for c in cols], axis=1)
    return MatArray(mat, "double")


@builtin("eomday", category="datetime", min_in=2, max_in=2)
def m_eomday(y, m):
    yy = _component(y, "eomday")
    mm = _component(m, "eomday")
    yy, mm = np.broadcast_arrays(yy, mm)
    out = np.empty(yy.shape)
    for idx in np.ndindex(yy.shape):
        yi = int(round(yy[idx]))
        mi = int(round(mm[idx]))
        if not 1 <= mi <= 12:
            raise MatError("MATLAB:eomday:invalidMonth",
                           "eomday: month must be in 1..12.")
        nxt = _pydt.date(yi + (mi == 12), mi % 12 + 1, 1)
        out[idx] = (nxt - _pydt.date(yi, mi, 1)).days
    return MatArray(out, "double")


@builtin("today", category="datetime", max_in=0)
def m_today():
    d = _pydt.date.today()
    return MatDatetime(np.full((1, 1), np.datetime64(d, "us")))


@builtin("datetick", category="plotting", max_in=4, is_sink=True)
def m_datetick(*args):
    """Compat no-op: accepts MATLAB date-axis formatting calls
    (≙ datetick_builtin, datetime/mod.rs:2839-2848)."""
    return None


# --------------------------------------------------------------------------- #
# business-day calendar
# --------------------------------------------------------------------------- #

@builtin("holidays", category="datetime", max_in=2)
def m_holidays(*args):
    if len(args) == 0:
        year = _pydt.date.today().year
        keys = _holiday_keys_between(_date_to_key(_pydt.date(year, 1, 1)),
                                     _date_to_key(_pydt.date(year, 12, 31)))
    elif len(args) == 1:
        a = args[0]
        if isinstance(a, MatArray) and not a.is_complex and a.size == 1 \
                and 1000.0 <= float(a.host().reshape(-1)[0]) <= 9999.0:
            keys = _market_holidays_for_year(
                int(round(float(a.host().reshape(-1)[0]))))
        else:
            year = _key_to_date(int(_keys(_serials(a, "holidays"))
                                    .reshape(-1)[0])).year
            keys = _holiday_keys_between(
                _date_to_key(_pydt.date(year, 1, 1)),
                _date_to_key(_pydt.date(year, 12, 31)))
    else:
        s0 = _keys(_serials(args[0], "holidays")).reshape(-1)
        s1 = _keys(_serials(args[1], "holidays")).reshape(-1)
        if s0.size != 1 or s1.size != 1:
            raise bad_arg("holidays", "Start and end dates must be scalar.")
        keys = _holiday_keys_between(int(s0[0]), int(s1[0]))
    return _dt_from_keys(keys, (len(keys), 1))


@builtin("isbusday", category="datetime", min_in=1, max_in=2)
def m_isbusday(v, hol=None):
    serials = _serials(v, "isbusday")
    kk = _keys(serials)
    if kk.size:
        hols = _holiday_set(hol, "isbusday", int(kk.min()), int(kk.max()))
    else:
        hols = set()
    out = np.empty(kk.shape, dtype=bool)
    for idx in np.ndindex(kk.shape):
        out[idx] = _is_busday_key(int(kk[idx]), hols)
    return MatArray(out, "logical")


@builtin("busdays", category="datetime", min_in=2, max_in=3)
def m_busdays(start, end, hol=None):
    s0 = _serials(start, "busdays").reshape(-1)
    s1 = _serials(end, "busdays").reshape(-1)
    if s0.size != 1 or s1.size != 1:
        raise bad_arg("busdays", "Start and end dates must be scalar.")
    k, k1 = int(_keys(s0)[0]), int(_keys(s1)[0])
    if abs(k1 - k) + 1 > _MAX_BUSDAYS:
        raise MatError("MATLAB:busdays:rangeTooLarge",
                       f"busdays: output would exceed {_MAX_BUSDAYS} dates.")
    hols = _holiday_set(hol, "busdays", min(k, k1), max(k, k1))
    step = 1 if k <= k1 else -1
    out = []
    while True:
        if _is_busday_key(k, hols):
            out.append(float(k))
        if k == k1:
            break
        k += step
    return MatArray(np.asarray(out, np.float64).reshape(len(out), 1),
                    "double")


@builtin("days252bus", category="datetime", min_in=2, max_in=3)
def m_days252bus(start, end, hol=None):
    s0 = _serials(start, "days252bus")
    s1 = _serials(end, "days252bus")
    k0, k1 = _keys(s0), _keys(s1)
    allk = np.concatenate([k0.reshape(-1), k1.reshape(-1)])
    hols = _holiday_set(hol, "days252bus", int(allk.min()), int(allk.max())) \
        if allk.size else set()
    a, b = np.broadcast_arrays(k0, k1)
    out = np.empty(a.shape)
    for idx in np.ndindex(a.shape):
        out[idx] = _count_busdays(int(a[idx]), int(b[idx]), hols)
    return MatArray(out, "double")


@builtin("daysdif", category="datetime", min_in=2, max_in=3)
def m_daysdif(start, end, basis=None):
    b = 0
    if basis is not None:
        b = int(round(float(_component(basis, "daysdif").reshape(-1)[0])))
    k0, k1 = _keys(_serials(start, "daysdif")), _keys(_serials(end, "daysdif"))
    a, c = np.broadcast_arrays(k0, k1)
    out = np.empty(a.shape)
    for idx in np.ndindex(a.shape):
        if b == 1:                                 # 30/360 day count
            s = _key_to_date(int(a[idx]))
            e = _key_to_date(int(c[idx]))
            sd = min(s.day, 30)
            ed = min(e.day, 30) if sd == 30 else e.day
            out[idx] = ((e.year - s.year) * 360
                        + (e.month - s.month) * 30 + (ed - sd))
        else:                                      # actual
            out[idx] = int(c[idx]) - int(a[idx])
    return MatArray(out, "double")


def _busdate_grid(name: str, y, m, hol, pick_first: bool):
    yy = _component(y, name)
    mm = _component(m, name)
    yy, mm = np.broadcast_arrays(yy, mm)
    lo, hi = None, None
    for idx in np.ndindex(yy.shape):
        yi, mi = int(round(yy[idx])), int(round(mm[idx]))
        if not 1 <= mi <= 12:
            raise MatError(f"MATLAB:{name}:invalidMonth",
                           f"{name}: month must be in 1..12.")
        k_first = _date_to_key(_pydt.date(yi, mi, 1))
        nxt = _pydt.date(yi + (mi == 12), mi % 12 + 1, 1)
        k_last = _date_to_key(nxt - _pydt.timedelta(days=1))
        lo = k_first if lo is None else min(lo, k_first)
        hi = k_last if hi is None else max(hi, k_last)
    hols = _holiday_set(hol, name, lo, hi)
    out = np.empty(yy.shape)
    for idx in np.ndindex(yy.shape):
        yi, mi = int(round(yy[idx])), int(round(mm[idx]))
        if pick_first:
            k = _date_to_key(_pydt.date(yi, mi, 1))
            while not _is_busday_key(k, hols):
                k += 1
        else:
            nxt = _pydt.date(yi + (mi == 12), mi % 12 + 1, 1)
            k = _date_to_key(nxt - _pydt.timedelta(days=1))
            while not _is_busday_key(k, hols):
                k -= 1
        out[idx] = float(k)
    return MatArray(out, "double")


@builtin("fbusdate", category="datetime", min_in=2, max_in=3)
def m_fbusdate(y, m, hol=None):
    return _busdate_grid("fbusdate", y, m, hol, True)


@builtin("lbusdate", category="datetime", min_in=2, max_in=3)
def m_lbusdate(y, m, hol=None):
    return _busdate_grid("lbusdate", y, m, hol, False)


@builtin("NaT", category="datetime", max_in=2)
def m_nat(m=None, n=None):
    """NaT / NaT(n) / NaT(m, n): not-a-time datetime arrays."""
    rows = int(m.host().reshape(-1)[0]) if m is not None else 1
    cols = int(n.host().reshape(-1)[0]) if n is not None else rows
    return MatDatetime(np.full((rows, cols), np.datetime64("NaT", "us")))


@builtin("isnat", category="datetime", min_in=1, max_in=1)
def m_isnat(t):
    if not isinstance(t, MatDatetime):
        raise bad_arg("isnat", "Input must be a datetime array.")
    return MatArray(np.isnat(t.data), "logical")
