"""The JAX package's own tests of a module, run through both packages.

`run_paired(request, module, name)` calls the test function `name` of the
JAX package's test module `module` with `Session` replaced, in that module
and in `helpers`, by `PairedSession`: each `execute`/`run_source` runs the
same source through the JAX package's `Session` and then through the
port's, and holds the port to the JAX package before it returns the JAX
package's result (so the test's own assertions still read the JAX
package's values):

* printed output equal as text; an error in both or in neither, with the
  same identifier and message;
* the same workspace names; every value equal (`same_value`): arrays by
  class, shape, dtype and value exactly (NaNs in the same places); cells,
  strings, structs, tables, datetimes, categoricals, objects and the rest
  field by field, of classes of the same name; and each value's display
  text equal;
* the files the source names under the temporary directory (each quoted
  absolute path's deepest existing directory below it, and the working
  directory if it lies there) equal after each run: names, and bytes
  (a MAT-file's bytes after its 116-byte header text, which stamps the
  time; the sizes of zip, gzip, tar and HDF5 files, which stamp it
  inside). Between the two runs those directories and the working
  directory are put back as they were before the first, so each package
  sees what the other saw, and after the second as the JAX package left
  them;
* with `home=True` (a test that points HOME at a directory of its own),
  likewise the FEA run registry and evidence chain under `~/.runmat_tpu`
  (`HOME_FILES`, which `fea.run` and `fea.evidence` append to in both
  packages): put back between the runs, equal after them as JSON but for
  the run's fresh id, its clock and the hashes over them (`_FEA_KEYS`),
  and left as the JAX package wrote them.

`loose` names workspace values not compared (each test file says why:
the clock, a fresh id); `clock` names struct fields not compared (they
hold the clock); `near` maps a workspace name to a relative tolerance for
a floating value that a library computes differently from call to call
(class, shape and dtype still exactly, values within the tolerance of the
largest magnitude, at least 1).

Each package keeps its figures in its own `plot.figure` module. Around
each run the figures it touched are taken from that package's touch log:
both runs must touch the same figure numbers and end on the same current
figure, and each touched figure must hold the same object tree in both
(`same_value`: its axes, their children and their properties, class names
equal and arrays exactly).

Module-wide state that a test file run before on the same worker may leave
in one package and not the other (figures, `hold on`, `format long`) is
put back to a fresh process's by `fresh_state` before each paired test.
"""

import inspect
import json
import os
import re
import shutil
import tempfile

import numpy as np

import helpers
from runmat_tpu.plot import figure as jax_figures
from runmat_tpu.session import Session as JaxSession
from runmat_tpu.utils import display as jax_display
from runmat_tpu.utils.display import format_value as jax_format
from runmat_tpu_torch.errors import MatError as PortError
from runmat_tpu_torch.plot import figure as port_figures
from runmat_tpu_torch.session import Session as PortSession
from runmat_tpu_torch.utils import display as port_display
from runmat_tpu_torch.utils.display import format_value as port_format

_QUOTED = re.compile(r"""['"](/[^'"]*)['"]""")
_ADDRESS = re.compile(r" at 0x[0-9a-f]+")
# manifest fields that hold a fresh id or the clock (data_api)
_VOLATILE_KEYS = {"dataset_id", "created_at", "updated_at", "txn_id"}
# the files under ~/.runmat_tpu that fea.run and fea.evidence append to,
# and the keys in them (and in an evidence file) that hold a run's fresh
# id, its clock, or a hash over them (fea2.py:_save_runs, m_fea_evidence)
HOME_FILES = ("fea_runs.json", "fea_evidence_chain.json")
_FEA_KEYS = {"run_id", "wall_s", "when", "runId", "hash", "head", "parent"}
_BINARY = (".zip", ".xlsx", ".gz", ".tar", ".tgz", ".h5", ".hdf5")
_SNAPSHOT_LIMIT = 64 << 20
_CLOCK: frozenset = frozenset()   # struct fields holding the clock (run_paired)
_START = os.path.realpath(os.getcwd())


def shown(text: str) -> str:
    """Printed text with a Python object's repr made package-neutral: a
    value without a display of its own prints as its class's repr in both
    packages (`<runmat_tpu.runtime.builtins.table2.CategoricalArray object
    at 0x...>`)."""
    return _ADDRESS.sub("", text).replace("runmat_tpu_torch.", "runmat_tpu.")


def _unclocked(text: str) -> str:
    """A display with the lines of the `clock` fields left out."""
    if not _CLOCK:
        return text
    pat = re.compile(r"^\s*(%s):" % "|".join(map(re.escape, sorted(_CLOCK))))
    return "\n".join(ln for ln in text.split("\n") if not pat.match(ln))


def _temp_root() -> str:
    return os.path.realpath(tempfile.gettempdir())


def _dirs(src: str) -> list:
    """The directories below the temporary directory that `src` names."""
    root = _temp_root()
    found = set()
    cands = [m.group(1) for m in _QUOTED.finditer(src)] + [os.getcwd()]
    for p in cands:
        p = os.path.realpath(p)
        while p and not os.path.isdir(p):
            p = os.path.dirname(p)
        # never the directory the tests started in, nor one above it
        if p.startswith(root + os.sep) and \
                not (_START + os.sep).startswith(p + os.sep):
            found.add(p)
    # an enclosing directory covers the ones below it
    return sorted(d for d in found
                  if not any(d.startswith(o + os.sep) for o in found))


def _snapshot(dirs: list) -> dict:
    snap, total = {}, 0
    for d in dirs:
        files = {}
        for base, subdirs, names in os.walk(d):
            rel = os.path.relpath(base, d)
            files[rel + os.sep] = None
            for n in names:
                p = os.path.join(base, n)
                with open(p, "rb") as f:
                    files[os.path.join(rel, n)] = f.read()
                total += len(files[os.path.join(rel, n)])
                assert total < _SNAPSHOT_LIMIT, d
        snap[d] = files
    return snap


def _restore(snap: dict) -> None:
    for d, files in snap.items():
        if os.path.isdir(d):
            for n in os.listdir(d):
                p = os.path.join(d, n)
                if os.path.isdir(p) and not os.path.islink(p):
                    shutil.rmtree(p)
                else:
                    os.remove(p)
        os.makedirs(d, exist_ok=True)
        for rel, data in sorted(files.items()):
            p = os.path.join(d, rel)
            if data is None:
                os.makedirs(p, exist_ok=True)
            else:
                with open(p, "wb") as f:
                    f.write(data)


def _home_files() -> dict:
    """The FEA registry files under ~/.runmat_tpu: name -> bytes, or None
    where there is none."""
    d = os.path.join(os.path.expanduser("~"), ".runmat_tpu")
    out = {}
    for n in HOME_FILES:
        p = os.path.join(d, n)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[n] = f.read()
        else:
            out[n] = None
    return out


def _put_home_files(files: dict) -> None:
    d = os.path.join(os.path.expanduser("~"), ".runmat_tpu")
    for n, data in files.items():
        p = os.path.join(d, n)
        if data is None:
            if os.path.exists(p):
                os.remove(p)
        else:
            os.makedirs(d, exist_ok=True)
            with open(p, "wb") as f:
                f.write(data)


def _same_home_files(want: dict, got: dict) -> None:
    for n in HOME_FILES:
        assert (want[n] is None) == (got[n] is None), n
        if want[n] is not None:
            assert _same_file(n, want[n], got[n]), n


def _same_file(rel: str, want: bytes, got: bytes) -> bool:
    if rel.endswith(_BINARY):
        return len(got) == len(want)
    if want[:10] == b"MATLAB 5.0" and rel.endswith(".mat"):
        return got[116:] == want[116:] and got[:19] == want[:19]
    if rel.endswith(".mat") and want[:8] == b"\x89HDF\r\n\x1a\n":
        return len(got) == len(want)
    if rel.endswith(".json"):
        return _steady(json.loads(got)) == _steady(json.loads(want))
    return got == want


def _steady(v):
    if isinstance(v, dict):
        return {k: _steady(x) for k, x in v.items()
                if k not in _VOLATILE_KEYS | _FEA_KEYS}
    if isinstance(v, list):
        return [_steady(x) for x in v]
    return v


def _same_files(want: dict, got: dict) -> None:
    assert want.keys() == got.keys()
    for d in want:
        assert sorted(want[d]) == sorted(got[d]), (d, sorted(got[d]),
                                                   sorted(want[d]))
        for rel, data in want[d].items():
            if data is not None:
                assert _same_file(rel, data, got[d][rel]), (d, rel)


def _slots(v) -> dict:
    out = {}
    for k in type(v).__mro__:
        sl = k.__dict__.get("__slots__", ())
        for n in ((sl,) if isinstance(sl, str) else sl):
            if n not in ("__dict__", "__weakref__") and hasattr(v, n):
                out[n] = getattr(v, n)
    out.update(getattr(v, "__dict__", {}))
    return out


# module paths whose objects hold an interpreter, a session or an engine:
# compared by their display text only
_LIVE = ("session", "vm.interp", "accel")


def same_value(want, got, path="", seen=None) -> None:
    """`got` (the port's) holds what `want` (the JAX package's) holds."""
    seen = set() if seen is None else seen
    if (id(want), id(got)) in seen:
        return
    seen.add((id(want), id(got)))
    if want is None or isinstance(want, (bool, int, str, bytes)):
        assert got == want, (path, got, want)
        return
    if isinstance(want, (float, complex, np.generic)):
        assert np.array_equal(np.asarray(got), np.asarray(want),
                              equal_nan=True), (path, got, want)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (path, got.shape, want.shape, got.dtype, want.dtype)
        if want.dtype == object:
            for i, w in np.ndenumerate(want):
                same_value(w, got[i], f"{path}{list(i)}", seen)
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind
                                  in "fc"), (path, got, want)
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            same_value(w, g, f"{path}[{i}]", seen)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            if k not in _VOLATILE_KEYS and k not in _CLOCK:
                same_value(want[k], got[k], f"{path}[{k!r}]", seen)
        return
    kind = type(want).__name__
    assert type(got).__name__ == kind, (path, type(got), type(want))
    pkg, _, mod = type(want).__module__.partition(".")
    if pkg != "runmat_tpu" or mod.startswith(_LIVE):
        # a thread, a lock, a file: the package's own state, not a value
        return
    if kind == "MatArray":
        assert got.mclass == want.mclass, path
        same_value(np.asarray(want.host()), np.asarray(got.host()), path,
                   seen)
        return
    if kind == "MatClass":
        for n in ("name", "supers", "prop_order", "events", "is_handle"):
            assert getattr(got, n) == getattr(want, n), (path, n)
        for n in ("methods", "statics"):
            assert sorted(getattr(got, n)) == sorted(getattr(want, n)), path
        return
    if kind == "Code":
        return
    w, g = _slots(want), _slots(got)
    assert sorted(g) == sorted(w), (path, sorted(g), sorted(w))
    for n in w:
        if n not in _VOLATILE_KEYS:
            same_value(w[n], g[n], f"{path}.{n}", seen)


def fresh_state() -> None:
    """Both packages' module-wide state as a fresh process has it: no
    figure open (each figure's hold off first), the current figure 1, and
    MATLAB's default display format. The JAX tests assume it; a test file
    run before on the same worker can leave a figure, `hold on` or `format
    long` in one package only, and every later paired comparison of the
    current figure or of a display would then fail."""
    for figs in (jax_figures, port_figures):
        for fig in figs._FIGURES.values():
            for ax in fig.axes:
                ax.hold = False
        figs.close_all()
    jax_display.set_format("short")
    port_display.set_format("short")


def same_figures(jax_touched: list, port_touched: list) -> None:
    """The figures a run touched hold the same trees in both packages."""
    assert port_touched == jax_touched, (port_touched, jax_touched)
    assert port_figures._CURRENT == jax_figures._CURRENT, \
        (port_figures._CURRENT, jax_figures._CURRENT)
    for num in jax_touched:
        same_value(jax_figures._FIGURES.get(num),
                   port_figures._FIGURES.get(num), f"figure {num}")


def _near(want, got, tol: float, name: str) -> None:
    assert got.mclass == want.mclass, name
    w, g = np.asarray(want.host()), np.asarray(got.host())
    assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1.0)
    assert float(np.max(np.abs(g - w), initial=0.0)) <= tol * scale, \
        (name, g, w)


class _Mirror(list):
    """A list whose writes go to the JAX session's list too (search_path)."""

    def __init__(self, jax_list, port_list):
        super().__init__(jax_list)
        self._lists = (jax_list, port_list)

    def insert(self, i, x):
        super().insert(i, x)
        for lst in self._lists:
            lst.insert(i, x)

    def append(self, x):
        super().append(x)
        for lst in self._lists:
            lst.append(x)


class PairedSession:
    """A JAX `Session` and a port `Session` driven with the same sources."""

    runs = 0
    loose: tuple = ()
    near: dict = {}
    home = False

    def __init__(self, *args, **kw):
        self.__dict__["_jax"] = JaxSession(*args, **kw)
        tkw = dict(kw)
        if not args and tkw.get("accelerate") is None:
            # a bare Session(): the JAX package's auto mode falls back to
            # the host without a card, the port's raises; the port runs on
            # the host here, as the JAX tests on the CPU expect
            tkw["accelerate"] = False
        self.__dict__["_port"] = PortSession(*args, **tkw)

    def __getattr__(self, name):
        if name == "search_path":
            return _Mirror(self._jax.search_path, self._port.search_path)
        return getattr(self._jax, name)

    def __setattr__(self, name, value):
        setattr(self._jax, name, value)
        setattr(self._port, name, value)

    def _both(self, call):
        """`call(session)` on each; returns both outcomes, as (result,
        error) pairs, and checks the files and the working directory."""
        src = call.source
        dirs = _dirs(src)
        before, cwd0 = _snapshot(dirs), os.getcwd()
        home = type(self).home
        home0 = _home_files() if home else None
        out, touched = [], []
        for i, (s, figs) in enumerate(((self._jax, jax_figures),
                                       (self._port, port_figures))):
            mark = figs.touch_log_len()
            try:
                out.append((call(s), None))
            except Exception as e:   # a MatError of either package
                out.append((None, e))
            touched.append(figs.touched_since(mark))
            after, cwd = _snapshot(_dirs(src)), os.getcwd()
            if i == 0:
                jafter, jcwd = after, cwd
                jhome = _home_files() if home else None
                _restore(before)
                os.chdir(cwd0)
                if home:
                    _put_home_files(home0)
        assert cwd == jcwd, (cwd, jcwd)
        _same_files(jafter, after)
        if home:
            _same_home_files(jhome, _home_files())
        _restore(jafter)
        os.chdir(jcwd)
        if home:
            _put_home_files(jhome)
        same_figures(*touched)
        type(self).runs += 1
        return out

    def _same_workspaces(self):
        js, ts = self._jax, self._port
        assert sorted(ts.workspace_names()) == sorted(js.workspace_names())
        for name in js.workspace_names():
            if name in type(self).loose:
                continue
            want, got = js.get(name), ts.get(name)
            if name in type(self).near:
                _near(want, got, type(self).near[name], name)
                continue
            same_value(want, got, name)
            if type(want).__name__ != "MatArray":
                assert _unclocked(shown(port_format(name, got))) == \
                    _unclocked(shown(jax_format(name, want))), name

    def execute(self, source, name="<input>"):
        call = (lambda s: s.execute(source, name))
        call.source = source
        (jr, je), (tr, te) = self._both(call)
        assert je is None and te is None, (je, te)
        assert shown(tr.output) == shown(jr.output), (tr.output, jr.output)
        assert (tr.error is None) == (jr.error is None), (tr.error,
                                                          jr.error)
        if jr.error is not None:
            assert (tr.error.identifier, tr.error.message) == \
                (jr.error.identifier, jr.error.message)
        self._same_workspaces()
        return jr

    def run_source(self, source, name="<input>"):
        call = (lambda s: s.run_source(source, name))
        call.source = source
        self._raise_as_both(*self._both(call))

    def run_file(self, path):
        call = (lambda s: s.run_file(path))
        with open(path) as f:
            call.source = f.read() + f"\n'{path}'"
        self._raise_as_both(*self._both(call))

    def _raise_as_both(self, jax_out, port_out):
        """The same MatError from both, or none; then the workspaces."""
        (_, je), (_, te) = jax_out, port_out
        assert (je is None) == (te is None), (je, te)
        if je is not None:
            assert isinstance(te, PortError), te
            assert (te.identifier, te.message) == (je.identifier,
                                                   je.message)
        self._same_workspaces()
        if je is not None:
            raise je


def session_tests(module) -> list:
    """The names of `module`'s test functions, in their order (each must
    drive a session: `run_paired` checks)."""
    return [n for n, f in vars(module).items()
            if n.startswith("test_") and inspect.isfunction(f)]


def run_paired(request, monkeypatch, module, name, loose=(), clock=(),
               near=None, home=False) -> None:
    fn = getattr(module, name)
    fresh_state()
    monkeypatch.setattr(helpers, "Session", PairedSession)
    if hasattr(module, "Session"):
        monkeypatch.setattr(module, "Session", PairedSession)
    monkeypatch.setattr(PairedSession, "runs", 0)
    monkeypatch.setattr(PairedSession, "loose", tuple(loose))
    monkeypatch.setattr(PairedSession, "near", dict(near or {}))
    monkeypatch.setattr(PairedSession, "home", home)
    monkeypatch.setitem(globals(), "_CLOCK", frozenset(clock))
    kw = {p.name: request.getfixturevalue(p.name)
          for p in inspect.signature(fn).parameters.values()
          if p.default is inspect.Parameter.empty}
    fn(**kw)
    assert PairedSession.runs > 0, f"{name} ran no session"
