"""Copy of runmat_tpu/runtime/builtins/file_io.py in the PyTorch port.

File I/O builtins: fopen/fclose/fwrite family, save/load (.mat via numpy npz
compat container), csv read/write, fileread.

Reference parity: runmat-runtime/src/builtins/io/ (80k LoC: mat-files, csv,
text). Round-1 surface: text + csv + a .mat-compatible workspace save/load via
numpy (full MAT-file codec is a later milestone).
"""

from __future__ import annotations

import os

import numpy as np

from ...errors import MatError, bad_arg
from ...values import CellArray, MatArray, StringArray, StructArray, text_of
from ..registry import builtin

_FIDS: dict[int, object] = {}
_NEXT_FID = [3]


def write_fid(fid: int, s: str) -> None:
    f = _FIDS.get(fid)
    if f is None:
        raise MatError("MATLAB:badfid_mx", "Invalid file identifier.")
    f.write(s)


@builtin("fopen", category="io", min_in=1, max_in=2)
def m_fopen(path, mode=None):
    p = text_of(path)
    m = text_of(mode) if mode is not None else "r"
    pymode = {"r": "r", "w": "w", "a": "a", "r+": "r+", "w+": "w+",
              "rb": "rb", "wb": "wb", "rt": "r", "wt": "w"}.get(m, m)
    try:
        f = open(p, pymode)
    except OSError:
        return MatArray.scalar(-1.0)
    fid = _NEXT_FID[0]
    _NEXT_FID[0] += 1
    _FIDS[fid] = f
    return MatArray.scalar(float(fid))


@builtin("fclose", category="io", min_in=1, max_in=1)
def m_fclose(fid):
    from ...values import is_text
    if is_text(fid) and text_of(fid) == "all":
        for f in _FIDS.values():
            f.close()
        _FIDS.clear()
        return MatArray.scalar(0.0)
    i = int(fid.scalar_double())
    f = _FIDS.pop(i, None)
    if f is None:
        return MatArray.scalar(-1.0)
    f.close()
    return MatArray.scalar(0.0)


@builtin("fgetl", category="io", min_in=1, max_in=1)
def m_fgetl(fid):
    f = _FIDS.get(int(fid.scalar_double()))
    if f is None:
        raise MatError("MATLAB:badfid_mx", "Invalid file identifier.")
    line = f.readline()
    if line == "":
        return MatArray.scalar(-1.0)
    return MatArray.char_from_str(line.rstrip("\n"))


@builtin("fileread", category="io", min_in=1, max_in=1)
def m_fileread(path):
    with open(text_of(path), "r") as f:
        return MatArray.char_from_str(f.read())


@builtin("fwrite", category="io", min_in=2)
def m_fwrite(fid, data, *rest):
    f = _FIDS.get(int(fid.scalar_double()))
    if f is None:
        raise MatError("MATLAB:badfid_mx", "Invalid file identifier.")
    if isinstance(data, MatArray) and data.mclass == "char":
        f.write(data.to_str())
        return MatArray.scalar(float(data.size))
    raise bad_arg("fwrite", "Only char data supported for now.")


@builtin("csvwrite", category="io", min_in=2, max_in=2)
def m_csvwrite(path, m):
    np.savetxt(text_of(path), m.host().astype(np.float64), delimiter=",", fmt="%.10g")
    return None


@builtin("csvread", category="io", min_in=1, max_in=1)
def m_csvread(path):
    data = np.loadtxt(text_of(path), delimiter=",", ndmin=2)
    return MatArray(data, "double")


@builtin("writematrix", category="io", min_in=2, max_in=2)
def m_writematrix(m, path):
    np.savetxt(text_of(path), m.host().astype(np.float64), delimiter=",", fmt="%.10g")
    return None


@builtin("readmatrix", category="io", min_in=1, max_in=1)
def m_readmatrix(path):
    data = np.loadtxt(text_of(path), delimiter=",", ndmin=2)
    return MatArray(data, "double")


@builtin("save", category="io", min_in=1, pass_ctx=True)
def m_save(path, *names, ctx=None):
    """save('file.mat', 'x', ..., flags) — Level-5 MAT-file by default;
    '-v7.3' writes the HDF5-based container, '-ascii' plain text,
    '-append' merges into an existing file (runmat_tpu/matio.py)."""
    from ...matio import load_mat, save_mat, save_mat73
    p = text_of(path)
    flags = {text_of(n).lower() for n in names if text_of(n).startswith("-")}
    var_names = [text_of(n) for n in names if not text_of(n).startswith("-")]
    ascii_mode = "-ascii" in flags
    if not ascii_mode and not p.endswith(".mat"):
        p += ".mat"
    frame = ctx.frame
    to_save = {}
    sel = var_names or [k for k in frame.vars if not k.startswith("@")]
    for n in sel:
        v = frame.vars.get(n)
        if v is None:
            raise MatError("MATLAB:save:variableNotFound",
                           f"Variable '{n}' not found.")
        to_save[n] = v
    if ascii_mode:
        lines = []
        for v in to_save.values():
            h = v.host().astype(np.float64)
            for row in np.atleast_2d(h):
                lines.append("  ".join(f"{x: .7e}" for x in row))
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        return None
    if "-append" in flags and os.path.exists(p):
        merged = load_mat(p)
        merged.update(to_save)
        to_save = merged
    if "-v7.3" in flags:
        save_mat73(p, to_save)
    else:
        save_mat(p, to_save)
    return None


@builtin("load", category="io", min_in=1, pass_ctx=True, pass_nargout=True)
def m_load(path, *names, ctx=None, nargout=0):
    from ...matio import is_mat73, load_mat, load_mat73
    p = text_of(path)
    if not os.path.exists(p) and os.path.exists(p + ".mat"):
        p += ".mat"
    if not os.path.exists(p):
        raise MatError("MATLAB:load:couldNotReadFile",
                       f"Unable to read file '{text_of(path)}'. No such file.")
    data = load_mat73(p) if is_mat73(p) else load_mat(p)
    sel = [text_of(n) for n in names] if names else list(data)
    loaded = {}
    for n in sel:
        if n not in data:
            raise MatError("MATLAB:load:variableNotFound",
                           f"Variable '{n}' not found in '{p}'.")
        loaded[n] = data[n]
    if nargout >= 1:
        out = StructArray.scalar({k: v for k, v in loaded.items()})
        return out
    ctx.frame.vars.update(loaded)
    return None


@builtin("delete", category="io", min_in=1, max_in=1)
def m_delete(path):
    p = text_of(path)
    if os.path.exists(p):
        os.remove(p)
    return None


@builtin("tempdir", category="io", min_in=0, max_in=0)
def m_tempdir():
    import tempfile
    return MatArray.char_from_str(tempfile.gettempdir() + os.sep)


@builtin("tempname", category="io", min_in=0, max_in=0)
def m_tempname():
    import tempfile
    fd, name = tempfile.mkstemp()
    os.close(fd)
    os.remove(name)
    return MatArray.char_from_str(name)


@builtin("fullfile", category="io", min_in=1)
def m_fullfile(*parts):
    return MatArray.char_from_str(os.path.join(*[text_of(p) for p in parts]))


@builtin("filesep", category="io", min_in=0, max_in=0)
def m_filesep():
    return MatArray.char_from_str(os.sep)


@builtin("pwd", category="io", min_in=0, max_in=0)
def m_pwd():
    return MatArray.char_from_str(os.getcwd())


@builtin("cd", category="io", min_in=0, max_in=1)
def m_cd(path=None):
    if path is not None:
        os.chdir(text_of(path))
    return MatArray.char_from_str(os.getcwd())


@builtin("mkdir", category="io", min_in=1, max_in=1)
def m_mkdir(path):
    os.makedirs(text_of(path), exist_ok=True)
    return MatArray.logical_scalar(True)


@builtin("jsonencode", category="io", min_in=1, max_in=1)
def m_jsonencode(v):
    import json

    def enc(x):
        if isinstance(x, MatArray):
            if x.mclass == "char":
                return x.to_str()
            h = x.host()
            if x.mclass == "logical":
                h = h.astype(bool)
            if h.size == 1:
                val = h.reshape(-1)[0]
                return bool(val) if x.mclass == "logical" else \
                    (int(val) if float(val) == int(val) and x.mclass != "single" else float(val))
            def jnum(v):
                return bool(v) if x.mclass == "logical" else \
                    (int(v) if float(v) == int(v) else float(v))
            if h.ndim == 2 and 1 in h.shape:
                # MATLAB encodes vectors (row or column) FLAT
                return [jnum(v) for v in h.reshape(-1)]
            return h.tolist()
        if isinstance(x, StringArray):
            return x.item() if x.size == 1 else [s for s in x.data.reshape(-1)]
        if isinstance(x, CellArray):
            return [enc(e) for e in x.data.reshape(-1, order="F")]
        if isinstance(x, StructArray) and x.size == 1:
            return {k: enc(x.get_scalar_field(k)) for k in x.fields}
        raise bad_arg("jsonencode", "Unsupported value.")

    return MatArray.char_from_str(json.dumps(enc(v)))


@builtin("jsondecode", category="io", min_in=1, max_in=1)
def m_jsondecode(s):
    import json

    def dec(x):
        if isinstance(x, bool):
            return MatArray.logical_scalar(x)
        if isinstance(x, (int, float)):
            return MatArray.scalar(float(x))
        if isinstance(x, str):
            return MatArray.char_from_str(x)
        if x is None:
            return MatArray.empty()
        if isinstance(x, list):
            if all(isinstance(e, (int, float)) and not isinstance(e, bool) for e in x):
                return MatArray(np.array(x, dtype=np.float64).reshape(-1, 1), "double")
            data = np.empty((len(x), 1), dtype=object)
            for i, e in enumerate(x):
                data[i, 0] = dec(e)
            return CellArray(data)
        if isinstance(x, dict):
            return StructArray.scalar({k: dec(v) for k, v in x.items()})
        raise bad_arg("jsondecode", "Unsupported JSON value.")

    return dec(json.loads(text_of(s)))


# --------------------------------------------------------------------------- #
# HDF5 (≙ reference builtins/io/hdf5.rs)
# --------------------------------------------------------------------------- #


@builtin("h5create", category="io", min_in=3, max_in=3)
def m_h5create(path, dset, size):
    import h5py
    dims = tuple(int(v) for v in size.host().reshape(-1))
    with h5py.File(text_of(path), "a") as f:
        f.create_dataset(text_of(dset).lstrip("/"), shape=dims,
                         dtype=np.float64)
    return None


@builtin("h5write", category="io", min_in=3, max_in=3)
def m_h5write(path, dset, data):
    import h5py
    with h5py.File(text_of(path), "a") as f:
        key = text_of(dset).lstrip("/")
        h = data.host()
        if key in f:
            f[key][...] = h
        else:
            f.create_dataset(key, data=h)
    return None


@builtin("h5read", category="io", min_in=2, max_in=2)
def m_h5read(path, dset):
    import h5py
    with h5py.File(text_of(path), "r") as f:
        arr = np.asarray(f[text_of(dset).lstrip("/")])
    if arr.ndim < 2:
        arr = arr.reshape(normalize_shape(arr.shape))
    return MatArray.from_np(arr)


@builtin("h5info", category="io", min_in=1, max_in=1)
def m_h5info(path):
    import h5py
    names = []
    with h5py.File(text_of(path), "r") as f:
        f.visit(names.append)
    data = np.empty((len(names), 1), dtype=object)
    for i, n in enumerate(names):
        data[i, 0] = MatArray.char_from_str(n)
    from ...values import CellArray, StructArray
    return StructArray.scalar({
        "Filename": MatArray.char_from_str(text_of(path)),
        "Datasets": CellArray(data),
    })


@builtin("textscan", category="io", min_in=2, max_in=2, pass_ctx=True)
def m_textscan(fid_or_text, fmt, ctx=None):
    """textscan(text, '%f %s ...') over whitespace-delimited columns."""
    from ...values import CellArray
    if isinstance(fid_or_text, MatArray) and fid_or_text.mclass == "char":
        text = fid_or_text.to_str()
    else:
        raise bad_arg("textscan", "Pass text (read files with fileread).")
    specs = [s for s in text_of(fmt).split() if s.startswith("%")]
    rows = [ln.split() for ln in text.strip().splitlines() if ln.strip()]
    ncol = len(specs)
    cols = np.empty((1, ncol), dtype=object)
    for c, spec in enumerate(specs):
        vals = [r[c] if c < len(r) else "" for r in rows]
        if spec in ("%f", "%d", "%g", "%e"):
            arr = np.array([float(v) if v else np.nan for v in vals]).reshape(-1, 1)
            cols[0, c] = MatArray(arr, "double")
        else:
            data = np.empty((len(vals), 1), dtype=object)
            for i, v in enumerate(vals):
                data[i, 0] = MatArray.char_from_str(v)
            from ...values import CellArray as _CA
            cols[0, c] = _CA(data)
    return CellArray(cols)


@builtin("importdata", category="io", min_in=1, max_in=1)
def m_importdata(path):
    p = text_of(path)
    if p.endswith(".mat"):
        from ...matio import load_mat
        from ...values import StructArray
        data = load_mat(p)
        return StructArray.scalar(data)
    # numeric text / csv
    try:
        arr = np.loadtxt(p, delimiter="," if p.endswith(".csv") else None,
                         ndmin=2)
        return MatArray(arr, "double")
    except ValueError:
        with open(p) as f:
            return MatArray.char_from_str(f.read())


@builtin("zip", category="io", min_in=2, max_in=2)
def m_zip(zipname, files):
    import zipfile
    from ...values import CellArray
    names = []
    if isinstance(files, CellArray):
        for k in range(files.size):
            names.append(text_of(files.data.reshape(-1, order="F")[k]))
    else:
        names.append(text_of(files))
    with zipfile.ZipFile(text_of(zipname), "w") as z:
        for n in names:
            z.write(n, os.path.basename(n))
    return None


@builtin("unzip", category="io", min_in=1, max_in=2)
def m_unzip(zipname, outdir=None):
    import zipfile
    from ...values import CellArray
    out = text_of(outdir) if outdir is not None else "."
    with zipfile.ZipFile(text_of(zipname)) as z:
        z.extractall(out)
        names = z.namelist()
    data = np.empty((1, len(names)), dtype=object)
    for i, n in enumerate(names):
        data[0, i] = MatArray.char_from_str(os.path.join(out, n))
    return CellArray(data)


@builtin("tar", category="io", min_in=2, max_in=2)
def m_tar(tarname, files):
    import tarfile
    from ...values import CellArray
    names = []
    if isinstance(files, CellArray):
        for k in range(files.size):
            names.append(text_of(files.data.reshape(-1, order="F")[k]))
    else:
        names.append(text_of(files))
    mode = "w:gz" if text_of(tarname).endswith(".gz") else "w"
    with tarfile.open(text_of(tarname), mode) as t:
        for n in names:
            t.add(n, arcname=os.path.basename(n))
    return None


@builtin("untar", category="io", min_in=1, max_in=2)
def m_untar(tarname, outdir=None):
    import tarfile
    out = text_of(outdir) if outdir is not None else "."
    with tarfile.open(text_of(tarname)) as t:
        t.extractall(out)
    return None


@builtin("webread", category="io", min_in=1, max_in=1)
def m_webread(url):
    u = text_of(url)
    if u.startswith("file://"):
        with open(u[7:]) as f:
            txt = f.read()
        if u.endswith(".json"):
            return m_jsondecode(MatArray.char_from_str(txt))
        return MatArray.char_from_str(txt)
    raise MatError("MATLAB:webservices:noNetwork",
                   "Network access is not available in this environment "
                   "(zero-egress build); file:// URLs are supported.")


# --------------------------------------------------------------------------- #
# search path (≙ addpath semantics, CHANGELOG v0.6.1)
# --------------------------------------------------------------------------- #


@builtin("addpath", category="io", min_in=1, max_in=None, pass_ctx=True)
def m_addpath(*dirs, ctx=None):
    for d in dirs:
        p = os.path.abspath(text_of(d))
        sp = ctx.session.search_path
        if p in sp:
            sp.remove(p)
        sp.insert(0, p)
    return None


@builtin("rmpath", category="io", min_in=1, max_in=None, pass_ctx=True)
def m_rmpath(*dirs, ctx=None):
    for d in dirs:
        p = os.path.abspath(text_of(d))
        if p in ctx.session.search_path:
            ctx.session.search_path.remove(p)
    return None


@builtin("path", category="io", max_in=0, pass_ctx=True)
def m_path(ctx=None):
    return MatArray.char_from_str(os.pathsep.join(ctx.session.search_path))


@builtin("genpath", category="io", min_in=1, max_in=1)
def m_genpath(root):
    r = text_of(root)
    out = []
    for d, subdirs, _files in os.walk(r):
        subdirs[:] = [s for s in subdirs if not s.startswith(".")]
        out.append(d)
    return MatArray.char_from_str(os.pathsep.join(out))


@builtin("run", category="io", min_in=1, max_in=1, pass_ctx=True)
def m_run(script, ctx=None):
    p = text_of(script)
    if not os.path.exists(p) and os.path.exists(p + ".m"):
        p += ".m"
    with open(p) as f:
        src = f.read()
    ctx.interp.eval_source(src, ctx.frame)
    return None
