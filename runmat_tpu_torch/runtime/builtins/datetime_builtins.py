"""Copy of runmat_tpu/runtime/builtins/datetime_builtins.py in the PyTorch port.

datetime / duration types and builtins.

Reference parity: crates/runmat-runtime/src/builtins/{datetime,duration}.
Storage: datetime = microseconds since the MATLAB epoch proleptic 0000-01-00
representation is avoided — we store numpy datetime64[us]; duration = numpy
timedelta64[us]. Arithmetic follows MATLAB: datetime±duration -> datetime,
datetime-datetime -> duration, duration arithmetic elementwise.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from ...errors import MatError, bad_arg
from ...values import MatArray, StringArray, is_text, normalize_shape, text_of
from ..registry import builtin


class MatDatetime:
    __slots__ = ("data", "shared")
    mclass = "datetime"

    def __init__(self, data: np.ndarray):
        d = np.asarray(data, dtype="datetime64[us]")
        if d.ndim < 2:
            d = d.reshape(normalize_shape(d.shape))
        self.data = d
        self.shared = False

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return self.data.size

    def copy(self):
        return MatDatetime(self.data.copy())


class MatDuration:
    __slots__ = ("data", "shared")
    mclass = "duration"

    def __init__(self, data: np.ndarray):
        d = np.asarray(data, dtype="timedelta64[us]")
        if d.ndim < 2:
            d = d.reshape(normalize_shape(d.shape))
        self.data = d
        self.shared = False

    @property
    def shape(self):
        return self.data.shape

    @property
    def size(self):
        return self.data.size

    def copy(self):
        return MatDuration(self.data.copy())

    def seconds_array(self) -> np.ndarray:
        return self.data.astype("timedelta64[us]").astype(np.int64) / 1e6

    def _mat_unop_(self, op: str):
        if op == "neg":
            return MatDuration(-self.data)
        if op == "uplus":
            return MatDuration(self.data.copy())
        if op == "abs":
            return MatDuration(np.abs(self.data))
        return NotImplemented


def _num(v) -> np.ndarray:
    return v.host().astype(np.float64)


_DT_INFMT_SUBS = [("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
                  ("MM", "%m"), ("dd", "%d"), ("HH", "%H"), ("mm", "%M"),
                  ("ss", "%S")]


def _parse_dt_text(t: str, infmt: str = None) -> "_dt.datetime":
    if infmt is not None:
        pat = infmt
        for tok, rep in _DT_INFMT_SUBS:
            pat = pat.replace(tok, rep)
        return _dt.datetime.strptime(t, pat)
    for pat in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d",
                "%d-%b-%Y %H:%M:%S", "%d-%b-%Y", "%m/%d/%Y %H:%M:%S",
                "%m/%d/%Y", "%Y/%m/%d"):
        try:
            return _dt.datetime.strptime(t, pat)
        except ValueError:
            continue
    raise bad_arg("datetime", f"Cannot parse datetime text '{t}'.")


@builtin("datetime", category="datetime", max_in=None)
def m_datetime(*args):
    if not args:
        now = np.datetime64(_dt.datetime.now(), "us")
        return MatDatetime(np.full((1, 1), now))
    if is_text(args[0]):
        t = text_of(args[0])
        if t == "now":
            return MatDatetime(np.full((1, 1), np.datetime64(_dt.datetime.now(), "us")))
        if t == "today":
            today = _dt.date.today()
            return MatDatetime(np.full((1, 1), np.datetime64(today, "us")))
        infmt = None
        rest = list(args[1:])
        for i in range(0, len(rest) - 1, 2):
            if is_text(rest[i]) and text_of(rest[i]) in ("InputFormat", "Format"):
                if text_of(rest[i]) == "InputFormat":
                    infmt = text_of(rest[i + 1])
        return MatDatetime(np.full((1, 1),
                                   np.datetime64(_parse_dt_text(t, infmt), "us")))
    # numeric (Y, M, D [, H, MI, S]) component form, arrays broadcast
    comps = [_num(a) for a in args[:6]]
    while len(comps) < 6:
        comps.append(np.zeros_like(comps[0]))
    comps = np.broadcast_arrays(*comps)
    shape = comps[0].shape
    flat = [c.reshape(-1) for c in comps]
    out = np.empty(flat[0].size, dtype="datetime64[us]")
    for i in range(flat[0].size):
        y, mo, d, h, mi, se = (flat[k][i] for k in range(6))
        micro = int(round((se - int(se)) * 1e6))
        out[i] = np.datetime64(_dt.datetime(int(y), int(mo), int(d), int(h),
                                            int(mi), int(se)) +
                               _dt.timedelta(microseconds=micro), "us")
    return MatDatetime(out.reshape(shape))


@builtin("isdatetime", category="datetime", min_in=1, max_in=1)
def m_isdatetime(x):
    return MatArray.logical_scalar(isinstance(x, MatDatetime))


@builtin("isduration", category="datetime", min_in=1, max_in=1)
def m_isduration(x):
    return MatArray.logical_scalar(isinstance(x, MatDuration))


@builtin("duration", category="datetime", min_in=1, max_in=3)
def m_duration(h, mi=None, s=None):
    hh = _num(h)
    mm = _num(mi) if mi is not None else np.zeros_like(hh)
    ss = _num(s) if s is not None else np.zeros_like(hh)
    hh, mm, ss = np.broadcast_arrays(hh, mm, ss)
    us = ((hh * 3600 + mm * 60 + ss) * 1e6).astype(np.int64)
    return MatDuration(us.astype("timedelta64[us]"))


def _dur_from(factor_us: float):
    def mk(x):
        if isinstance(x, MatDuration):
            # extraction form: days(d) -> numeric
            return MatArray(x.seconds_array() / (factor_us / 1e6), "double")
        us = (_num(x) * factor_us).astype(np.int64)
        return MatDuration(us.astype("timedelta64[us]"))
    return mk


for _name, _f in (("days", 86400e6), ("hours", 3600e6), ("minutes", 60e6),
                  ("seconds", 1e6), ("milliseconds", 1e3),
                  # fixed-length calendar units (≙ duration/mod.rs years
                  # builtin: 365.2425-day years; weeks are exact)
                  ("years", 365.2425 * 86400e6), ("weeks", 7 * 86400e6)):
    builtin(_name, category="datetime", min_in=1, max_in=1)(_dur_from(_f))


_COMP_KINDS = {
    # (builtin, kind) -> getter over datetime.datetime
    ("day", "dayofmonth"): lambda t: t.day,
    ("day", "dayofyear"): lambda t: t.timetuple().tm_yday,
    ("day", "dayofweek"): lambda t: (t.weekday() + 1) % 7 + 1,  # 1=Sunday
    ("day", "name"): lambda t: t.strftime("%A"),
    ("day", "shortname"): lambda t: t.strftime("%a"),
    ("month", "monthofyear"): lambda t: t.month,
    ("month", "name"): lambda t: t.strftime("%B"),
    ("month", "shortname"): lambda t: t.strftime("%b"),
}


def _comp(name, getter, default_kind=None):
    @builtin(name, category="datetime", min_in=1, max_in=2)
    def _g(x, kind=None, _get=getter, _name=name):
        if not isinstance(x, MatDatetime):
            raise bad_arg(_name, "Input must be a datetime array.")
        get = _get
        if kind is not None:
            k = text_of(kind).lower()
            get = _COMP_KINDS.get((_name, k))
            if get is None:
                raise bad_arg(_name, f"Unknown kind '{text_of(kind)}'.")
        flat = x.data.reshape(-1)
        vals = [get(t.astype(_dt.datetime)) for t in flat]
        if vals and isinstance(vals[0], str):
            from ...values import StringArray
            data = np.array(vals, dtype=object).reshape(x.shape)
            return StringArray(data)
        out = np.array(vals, dtype=np.float64)
        return MatArray(out.reshape(x.shape), "double")
    return _g


@builtin("weekday", category="datetime", min_in=1, max_in=2,
         pass_nargout=True)
def m_weekday(x, fmt=None, nargout=1):
    """weekday: 1=Sunday..7=Saturday; second output = day names
    ('short' default, 'long' option). Accepts datetime arrays or MATLAB
    serial date numbers (datenum: day 1 = 1-Jan-0000, python ordinal
    offset 366)."""
    long_names = fmt is not None and text_of(fmt).lower() == "long"
    if isinstance(x, MatDatetime):
        flat = [t.astype(_dt.datetime) for t in x.data.reshape(-1)]
        shape = x.shape
    else:
        nums = x.host().astype(np.float64)
        flat = [_dt.datetime.fromordinal(int(v) - 366)
                for v in nums.reshape(-1)]
        shape = nums.shape
    dow = np.array([(t.weekday() + 1) % 7 + 1 for t in flat],
                   dtype=np.float64).reshape(shape)
    out = [MatArray(dow, "double")]
    if nargout >= 2:
        from ...values import StringArray
        fmt_s = "%A" if long_names else "%a"
        names = np.array([t.strftime(fmt_s) for t in flat],
                         dtype=object).reshape(shape)
        out.append(StringArray(names))
    return out[:max(1, nargout)]


_comp("year", lambda t: t.year)
_comp("month", lambda t: t.month)
_comp("day", lambda t: t.day)
_comp("hour", lambda t: t.hour)
_comp("minute", lambda t: t.minute)
_comp("second", lambda t: t.second + t.microsecond / 1e6)


_DATESTR_IDS = {
    0: "dd-mmm-yyyy HH:MM:SS", 1: "dd-mmm-yyyy", 13: "HH:MM:SS",
    15: "HH:MM", 23: "mm/dd/yyyy", 26: "yyyy/mm/dd", 29: "yyyy-mm-dd",
    30: "yyyymmddTHHMMSS", 31: "yyyy-mm-dd HH:MM:SS",
}


def _matlab_datefmt(t: "_dt.datetime", fmt: str) -> str:
    """Translate a MATLAB date-format string and render t."""
    # longest tokens first; strftime-escape everything else literally
    subs = [("yyyy", "%Y"), ("yy", "%y"), ("mmmm", "%B"), ("mmm", "%b"),
            ("mm", "%m"), ("dddd", "%A"), ("ddd", "%a"), ("dd", "%d"),
            ("HH", "%H"), ("MM", "%M"), ("SS", "%S"),
            ("FFF", f"{t.microsecond // 1000:03d}"),
            ("AM", "%p"), ("PM", "%p")]
    out = []
    i = 0
    while i < len(fmt):
        for tok, rep in subs:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(fmt[i].replace("%", "%%"))
            i += 1
    pattern = "".join(out)
    if "%p" in pattern:
        pattern = pattern.replace("%H", "%I")
    return t.strftime(pattern)


@builtin("datestr", category="datetime", min_in=1, max_in=2)
def m_datestr(x, fmt=None):
    if isinstance(x, MatDatetime):
        t = x.data.reshape(-1)[0].astype(_dt.datetime)
    else:
        t = _datenum_to_dt(float(_num(x).reshape(-1)[0]))
    if fmt is None:
        return MatArray.char_from_str(t.strftime("%d-%b-%Y %H:%M:%S"))
    if is_text(fmt):
        return MatArray.char_from_str(_matlab_datefmt(t, text_of(fmt)))
    fid = int(fmt.host().reshape(-1)[0])
    pattern = _DATESTR_IDS.get(fid)
    if pattern is None:
        raise bad_arg("datestr", f"Unsupported date format number {fid}.")
    return MatArray.char_from_str(_matlab_datefmt(t, pattern))


_MATLAB_EPOCH = _dt.datetime(1, 1, 1)  # datenum 367


def _datenum_to_dt(dn: float) -> _dt.datetime:
    return _MATLAB_EPOCH + _dt.timedelta(days=dn - 367.0)


def _dt_to_datenum(t: _dt.datetime) -> float:
    delta = t - _MATLAB_EPOCH
    return delta.days + delta.seconds / 86400.0 + delta.microseconds / 86400e6 + 367.0


@builtin("datenum", category="datetime", min_in=1, max_in=6)
def m_datenum(*args):
    if len(args) == 1 and isinstance(args[0], MatDatetime):
        flat = args[0].data.reshape(-1)
        out = np.array([_dt_to_datenum(t.astype(_dt.datetime)) for t in flat])
        return MatArray(out.reshape(args[0].shape), "double")
    if len(args) >= 3:
        dtv = m_datetime(*args)
        return m_datenum(dtv)
    raise bad_arg("datenum", "Unsupported datenum form.")


@builtin("calendar_now", category="datetime", max_in=0)
def m_calendar_now():
    return MatDatetime(np.full((1, 1), np.datetime64(_dt.datetime.now(), "us")))


# -- arithmetic hooks (registered into the dispatch layer lazily) ------------- #


def dt_binary(op, a, b):
    """datetime/duration arithmetic; returns None when not applicable."""
    da = isinstance(a, MatDatetime)
    db = isinstance(b, MatDatetime)
    ua = isinstance(a, MatDuration)
    ub = isinstance(b, MatDuration)
    if not (da or db or ua or ub):
        return None
    # calendar durations: month-granular arithmetic (datetime2.caldur_add)
    from .datetime2 import caldur_add, is_caldur
    if op in ("add", "sub"):
        sign = 1.0 if op == "add" else -1.0
        if da and is_caldur(b):
            return caldur_add(a, b, sign)
        if db and is_caldur(a) and op == "add":
            return caldur_add(b, a, 1.0)
    if op == "add":
        if da and ub:
            return MatDatetime(a.data + b.data)
        if ua and db:
            return MatDatetime(b.data + a.data)
        if ua and ub:
            return MatDuration(a.data + b.data)
        if ua and isinstance(b, MatArray):
            return MatDuration(a.data + (_num(b) * 1e6).astype("timedelta64[us]"))
        if ub and isinstance(a, MatArray):
            return MatDuration(b.data + (_num(a) * 1e6).astype("timedelta64[us]"))
    if op == "sub":
        if da and db:
            return MatDuration(a.data - b.data)
        if da and ub:
            return MatDatetime(a.data - b.data)
        if ua and ub:
            return MatDuration(a.data - b.data)
    if op in ("mul",) and ua and isinstance(b, MatArray):
        return MatDuration((a.seconds_array() * _num(b) * 1e6)
                           .astype(np.int64).astype("timedelta64[us]"))
    if op in ("mul",) and ub and isinstance(a, MatArray):
        return dt_binary("mul", b, a)
    if op in ("div",) and ua and isinstance(b, MatArray):
        return MatDuration((a.seconds_array() / _num(b) * 1e6)
                           .astype(np.int64).astype("timedelta64[us]"))
    if op in ("lt", "le", "gt", "ge", "eq", "ne"):
        import operator
        fn = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
              "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}[op]
        xa = a.data if (da or ua) else _num(a)
        xb = b.data if (db or ub) else _num(b)
        return MatArray(np.asarray(fn(xa, xb)), "logical")
    raise MatError("MATLAB:datetime:badOp",
                   f"Operation '{op}' is not defined for datetime/duration.")
