"""Copy of runmat_tpu/runtime/builtins/profiler.py in the PyTorch port.

MATLAB profiler: profile on/off/clear/info/report.

Reference parity: the tracing/profiling tier (runmat-logging spans +
interpreter timing instrumentation, runmat-vm/src/interpreter/timing.rs).
Function-level wall-clock accumulation hooks live in vm/interp.py
(call_builtin / call_user); this module is the user surface.
"""

from __future__ import annotations

import numpy as np

from ...errors import bad_arg
from ...values import MatArray, StructArray, is_text, text_of
from ..registry import builtin


@builtin("profile", category="diagnostics", min_in=1, pass_ctx=True,
         pass_nargout=True)
def m_profile(action, *rest, ctx=None, nargout=0):
    sess = ctx.session
    act = text_of(action).lower()
    if act == "on":
        sess._profile = {}
        return None
    if act == "resume":
        if getattr(sess, "_profile", None) is None:
            sess._profile = {}
        return None
    if act == "off":
        data = getattr(sess, "_profile", None) or {}
        sess._last_profile = data
        sess._profile = None
        return None
    if act == "clear":
        if getattr(sess, "_profile", None) is not None:
            sess._profile = {}
        sess._last_profile = {}
        return None
    if act in ("info",):
        data = getattr(sess, "_profile", None)
        if data is None:
            data = getattr(sess, "_last_profile", {})
        names = sorted(data, key=lambda n: -data[n][1])
        n = len(names)
        fields = {"FunctionName": np.empty((n, 1), dtype=object),
                  "NumCalls": np.empty((n, 1), dtype=object),
                  "TotalTime": np.empty((n, 1), dtype=object)}
        for i, nm in enumerate(names):
            calls, total = data[nm]
            fields["FunctionName"][i, 0] = MatArray.char_from_str(nm)
            fields["NumCalls"][i, 0] = MatArray.scalar(float(calls))
            fields["TotalTime"][i, 0] = MatArray.scalar(total)
        table = StructArray(fields, (n, 1))
        return StructArray.scalar({"FunctionTable": table})
    if act in ("report", "viewer"):
        data = getattr(sess, "_profile", None)
        if data is None:
            data = getattr(sess, "_last_profile", {})
        sess.write(f"{'function':<28}{'calls':>8}{'total (s)':>12}\n")
        for nm in sorted(data, key=lambda n: -data[n][1])[:25]:
            calls, total = data[nm]
            sess.write(f"{nm:<28}{calls:>8}{total:>12.6f}\n")
        return None
    if act == "status":
        on = getattr(sess, "_profile", None) is not None
        return StructArray.scalar({
            "ProfilerStatus": MatArray.char_from_str("on" if on else "off")})
    raise bad_arg("profile", f"Unknown profile option '{act}'.")
