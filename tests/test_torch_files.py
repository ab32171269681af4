"""MAT files, file I/O, datasets and introspection in the port, held to
the JAX package.

Every test of `tests/test_io2.py`, `tests/test_data_api.py`,
`tests/test_introspection2.py` and the session tests of
`tests/test_matfile.py` run with each of their sessions a
`torch_paired.PairedSession`: the same sources through both packages' host
sessions, output, errors, workspaces and the files they write held equal
exactly. Not in that list:

* the MAT codec's own tests, which call `runmat_tpu.matio` directly: the
  tests below save in each package and load in the other, exactly;
* the filesystem-provider tests, which set the JAX package's provider
  (the port has its own `fs` module): the tests below set both.

Where a value holds the clock or a fresh id it is left out of the comparison (`LOOSE`);
the test itself still checks it in the JAX package.

Also here: `fprintf` to a file id, and `export_workspace`/
`import_workspace` round-tripping a workspace.
"""

import numpy as np
import pytest

import test_data_api
import test_introspection2
import test_io2
import test_matfile
from runmat_tpu import fs as jax_fs
from runmat_tpu import matio as jax_matio
from runmat_tpu.session import Session as JaxSession
from runmat_tpu_torch import fs as port_fs
from runmat_tpu_torch import matio as port_matio
from runmat_tpu_torch.session import Session as PortSession
from torch_both import EXACT, host_parity, no_engine  # noqa: F401
from torch_paired import run_paired, same_value, session_tests

CODEC = {"test_numeric_classes_roundtrip", "test_complex_roundtrip",
         "test_char_roundtrip", "test_cell_struct_roundtrip",
         "test_sparse_roundtrip", "test_string_array_saves_as_cellstr",
         "test_scipy_reads_our_files", "test_we_read_scipy_files"}
PROVIDERS = {"test_memory_fs_provider", "test_sandbox_fs_provider"}

# values that hold the clock or a fresh id: `dir`'s file times (the files
# are put back between the two runs), timeit's time, the profiler's times
# and the order it sorts them in, a dataset's id in data.inspect's struct
LOOSE = {"test_isfile_isfolder_dir": ("e",), "test_timeit": ("t",),
         "test_profiler": ("info", "t"),
         "test_list_copy_move_inspect": ("info",)}

CASES = [(m, n) for m in (test_matfile, test_io2, test_data_api,
                          test_introspection2)
         for n in session_tests(m)
         if n not in CODEC | PROVIDERS]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_the_jax_tests_agree_through_both(request, monkeypatch, module, name):
    run_paired(request, monkeypatch, module, name, loose=LOOSE.get(name, ()))


# ------------------------------------------------ MAT files across packages

# (id, source making the workspace): every kind of value the codec writes
WORKSPACES = [
    ("numeric", "d = [1.5 2.5; 3.5 4.5]; s = single([1 2]); i8 = int8(-5);"
                " u32 = uint32([7 8]); L = [true false]; u16 = uint16(65535);"
                " i64 = int64([-2^40 5]); e = zeros(0, 3);"
                " n3 = reshape(1:24, 2, 3, 4); L3 = rand(2, 2, 2) > 2;"),
    ("special", "x = [NaN Inf -Inf -0 realmin realmax eps];"
                " y = single([NaN Inf 1e-40]);"),
    ("complex", "z = [1+2i, 3-4i]; zs = single(1-1i); zc = complex(2, 0);"),
    ("char", "c = 'hello world'; cm = ['ab'; 'cd']; ce = '';"),
    ("cell-struct", "c = {1, 'two'; [1 2 3], {4, 'five'}}; s.a = 5;"
                    " s.b = 'x'; s.n.m = [1 2]; sa = struct('v', {1, 2, 3});"
                    " ec = {};"),
    ("sparse", "A = sparse([1 3], [2 1], [3 4], 3, 2); B = speye(4);"),
    ("string", "st = [\"ab\" \"cd\"]; s1 = \"one\";"),
    ("large", "rng(3); R = randn(300, 200); I = int16(round(R * 100));"),
]

MAT_FORMATS = [("v5", ""), ("v7.3", ", '-v7.3'")]


def _saved(session_cls, src: str, path: str, fmt: str):
    s = session_cls(accelerate=False)
    r = s.execute(f"{src} save('{path}'{fmt});")
    assert r.error is None, r.error
    return s


def _loaded(session_cls, path: str):
    s = session_cls(accelerate=False)
    r = s.execute(f"W = load('{path}');")
    assert r.error is None, r.error
    return s.get("W")


@pytest.mark.parametrize("fmt", [f for _, f in MAT_FORMATS],
                         ids=[i for i, _ in MAT_FORMATS])
@pytest.mark.parametrize("sid,src", WORKSPACES, ids=[i for i, _ in WORKSPACES])
def test_a_mat_file_of_each_package_loads_in_the_other(tmp_path, no_engine,
                                                       sid, src, fmt):
    """A file saved by either package loads in the other exactly as it
    loads in the package that saved it: classes, shapes and bits."""
    for writer in (JaxSession, PortSession):
        p = str(tmp_path / f"{writer.__module__.split('.')[0]}.mat")
        _saved(writer, src, p, fmt)
        same_value(_loaded(JaxSession, p), _loaded(PortSession, p), sid)


@pytest.mark.parametrize("sid,src", WORKSPACES, ids=[i for i, _ in WORKSPACES])
def test_both_packages_write_the_same_mat_bytes(tmp_path, no_engine, sid,
                                                src):
    """The v5 files of the same workspace are equal byte for byte after the
    header text, which stamps the time."""
    pj, pt = str(tmp_path / "jax.mat"), str(tmp_path / "port.mat")
    _saved(JaxSession, src, pj, "")
    _saved(PortSession, src, pt, "")
    with open(pj, "rb") as f, open(pt, "rb") as g:
        want, got = f.read(), g.read()
    assert got[116:] == want[116:] and got[:19] == want[:19]


def test_the_codecs_read_each_others_files_directly(tmp_path):
    """matio of each package, called as the codec tests call it, reads the
    other's file: the values of every class the codec writes."""
    from runmat_tpu.values import MatArray as JaxArray
    from runmat_tpu_torch.values import MatArray as PortArray
    h = {"d": (np.array([[1.5, 2.5], [3.5, 4.5]]), "double"),
         "s": (np.array([[1, 2]], np.float32), "single"),
         "i8": (np.array([[-5]], np.int8), "int8"),
         "u32": (np.array([[7, 8]], np.uint32), "uint32"),
         "L": (np.array([[True, False]]), "logical"),
         "z": (np.array([[1 + 2j, 3 - 4j]]), "double")}
    for mod, cls, other in ((jax_matio, JaxArray, port_matio),
                            (port_matio, PortArray, jax_matio)):
        p = str(tmp_path / f"{mod.__name__}.mat")
        mod.save_mat(p, {k: cls(a.copy(), c) for k, (a, c) in h.items()})
        out = other.load_mat(p)
        assert list(out) == list(h)
        for k, (a, c) in h.items():
            assert out[k].mclass == c
            got = out[k].host()
            assert got.dtype == a.dtype and np.array_equal(got, a), k


# ----------------------------------------------------- filesystem providers

def test_a_memory_provider_serves_each_package_its_own_files(no_engine):
    """Each package reads and writes through its own provider, as
    `test_io2.test_memory_fs_provider` sets the JAX package's."""
    src = ("writelines([\"x\" \"y\"], '/virt/f.txt');"
           "L = readlines('/virt/f.txt'); ok = isfile('/virt/f.txt');")
    mems = (jax_fs.MemoryFsProvider(), port_fs.MemoryFsProvider())
    jax_fs.set_fs_provider(mems[0])
    port_fs.set_fs_provider(mems[1])
    try:
        runs = [S(accelerate=False) for S in (JaxSession, PortSession)]
        for s in runs:
            assert s.execute(src).error is None
        same_value(runs[0].get("L"), runs[1].get("L"))
        assert runs[1].get("ok").host()[0, 0]
        assert mems[0].files == mems[1].files == {"/virt/f.txt": b"x\ny\n"}
    finally:
        jax_fs.reset_fs_provider()
        port_fs.reset_fs_provider()


def test_a_sandbox_provider_refuses_outside_paths_in_both(tmp_path):
    (tmp_path / "ok.txt").write_text("fine")
    for mod, S in ((jax_fs, JaxSession), (port_fs, PortSession)):
        mod.set_fs_provider(mod.SandboxFsProvider(str(tmp_path)))
        try:
            s = S(accelerate=False)
            assert s.execute(f"t = fileread('{tmp_path}/ok.txt');").error \
                is None
            assert s.get("t").to_str() == "fine"
            with pytest.raises(Exception) as e:
                mod.fs().read_bytes("/etc/passwd")
            assert type(e.value).__name__ == "MatError"
        finally:
            mod.reset_fs_provider()


# --------------------------------------------- what the removed stubs held

def test_fprintf_to_a_file_id(tmp_path, no_engine):
    """fprintf(fid, ...) writes, appends and the file reads back the same
    in both packages."""
    for name in ("a", "b"):
        p = tmp_path / f"{name}.txt"
        host_parity("fprintf-file",
                    f"fid = fopen('{p}', 'w'); fprintf(fid, '%d apples\\n', 3);"
                    f" fprintf(fid, '%.3f|', [pi; exp(1)]); st = fclose(fid);"
                    f" t = fileread('{p}'); fid = fopen('{p}', 'a');"
                    f" fprintf(fid, 'more'); fclose(fid); u = fileread('{p}');"
                    f" delete('{p}'); gone = ~isfile('{p}'); ok = fid > 2; clear fid",
                    EXACT)


def test_export_and_import_a_workspace(tmp_path, no_engine):
    """export_workspace/import_workspace (the session's MAT-file surface)
    round-trip a workspace exactly, and the JAX package reads the file."""
    src = WORKSPACES[2][1] + WORKSPACES[4][1] + WORKSPACES[5][1] + \
        " d = [1.5 2.5]; i8 = int8(-5); L = [true false];"
    p = str(tmp_path / "w.mat")
    src_s = PortSession(accelerate=False)
    assert src_s.execute(src).error is None
    src_s.export_workspace(p)
    dst = PortSession(accelerate=False)
    assert dst.execute("keep = 1;").error is None
    dst.import_workspace(p, replace=True)
    jax_dst = JaxSession(accelerate=False)
    jax_dst.import_workspace(p, replace=True)
    names = sorted(jax_dst.workspace_names())
    assert sorted(dst.workspace_names()) == names
    assert "keep" not in names
    for n in names:
        same_value(jax_dst.get(n), dst.get(n), n)
        same_value(src_s.get(n), dst.get(n), n)
