"""Copy of runmat_tpu/runtime/builtins/io2.py in the PyTorch port.

I/O batch 2: REPL filesystem ops, file-text ops, delimited/spreadsheet
tabular io, archives, audio, URL utilities, diary, legacy HDF5 wrappers.

Reference parity: runmat-runtime/src/builtins/io/{repl_fs,filetext,tabular,
archive,audio,http}.rs + src/console.rs (diary). File access routes through
the filesystem provider abstraction (runmat_tpu/fs.py ≙ runmat-filesystem).
Network builtins (websave/webwrite/sendmail) raise a clear no-egress error.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ...errors import MatError, bad_arg
from ...fs import fs
from ...values import (CellArray, MatArray, StringArray, StructArray,
                       is_text, text_of)
from ..registry import builtin, register_alias
from .common import scalar_int, scalar_num
from .file_io import _FIDS


def _f(v) -> np.ndarray:
    return v.host().astype(np.float64)


# ------------------------------------------------------------------ paths --- #

@builtin("fileparts", category="io/fs", min_in=1, max_in=1, pass_nargout=True)
def m_fileparts(p, nargout=1):
    t = text_of(p)
    d, base = os.path.split(t)
    name, ext = os.path.splitext(base)
    outs = [MatArray.char_from_str(d), MatArray.char_from_str(name),
            MatArray.char_from_str(ext)]
    return outs[:max(1, nargout)] if nargout > 1 else outs[0]


@builtin("pathsep", category="io/fs", min_in=0, max_in=0)
def m_pathsep():
    return MatArray.char_from_str(os.pathsep)


@builtin("matlabroot", category="io/fs", min_in=0, max_in=0)
def m_matlabroot():
    import runmat_tpu_torch
    return MatArray.char_from_str(os.path.dirname(os.path.abspath(
        runmat_tpu_torch.__file__)))


@builtin("userpath", category="io/fs", min_in=0, max_in=1)
def m_userpath(new=None):
    if new is not None:
        os.environ["RUNMAT_TPU_USERPATH"] = text_of(new)
        return None
    return MatArray.char_from_str(
        os.environ.get("RUNMAT_TPU_USERPATH",
                       os.path.join(os.path.expanduser("~"), "Documents", "MATLAB")))


@builtin("isfile", category="io/fs", min_in=1, max_in=1)
def m_isfile(p):
    return MatArray.logical_scalar(fs().is_file(text_of(p)))


@builtin("isfolder", category="io/fs", min_in=1, max_in=1)
def m_isfolder(p):
    return MatArray.logical_scalar(fs().is_dir(text_of(p)))


register_alias("isdir", "isfolder")


def _dir_entries(pattern: str):
    import fnmatch
    prov = fs()
    if prov.is_dir(pattern):
        base = pattern
        names = prov.listdir(pattern)
    else:
        base = os.path.dirname(pattern) or "."
        pat = os.path.basename(pattern)
        names = [n for n in (prov.listdir(base) if prov.is_dir(base) else [])
                 if fnmatch.fnmatch(n, pat)]
    return base, names


@builtin("dir", category="io/fs", min_in=0, max_in=1)
def m_dir(pattern=None):
    pat = text_of(pattern) if pattern is not None else "."
    base, names = _dir_entries(pat)
    prov = fs()
    n = len(names)
    fields = {
        "name": np.empty((n, 1), dtype=object),
        "folder": np.empty((n, 1), dtype=object),
        "isdir": np.empty((n, 1), dtype=object),
        "bytes": np.empty((n, 1), dtype=object),
        "datenum": np.empty((n, 1), dtype=object),
    }
    for i, nm in enumerate(names):
        full = os.path.join(base, nm)
        try:
            st = prov.stat(full)
        except Exception:
            st = {"size": 0, "isdir": False, "mtime": 0.0}
        fields["name"][i, 0] = MatArray.char_from_str(nm)
        fields["folder"][i, 0] = MatArray.char_from_str(os.path.abspath(base))
        fields["isdir"][i, 0] = MatArray.logical_scalar(bool(st["isdir"]))
        fields["bytes"][i, 0] = MatArray.scalar(float(st["size"]))
        fields["datenum"][i, 0] = MatArray.scalar(float(st["mtime"]) / 86400.0 + 719529.0)
    return StructArray(fields, (n, 1))


@builtin("ls", category="io/fs", min_in=0, max_in=1)
def m_ls(pattern=None):
    pat = text_of(pattern) if pattern is not None else "."
    _base, names = _dir_entries(pat)
    return MatArray.char_from_str("\n".join(names))


@builtin("what", category="io/fs", min_in=0, max_in=1)
def m_what(d=None):
    base = text_of(d) if d is not None else "."
    prov = fs()
    names = prov.listdir(base) if prov.is_dir(base) else []
    ms = [n for n in names if n.endswith(".m")]
    mats = [n for n in names if n.endswith(".mat")]

    def cellcol(items):
        data = np.empty((len(items), 1), dtype=object)
        for i, s in enumerate(items):
            data[i, 0] = MatArray.char_from_str(s)
        return CellArray(data)

    return StructArray.scalar({
        "path": MatArray.char_from_str(os.path.abspath(base)),
        "m": cellcol(ms), "mat": cellcol(mats),
    })


@builtin("copyfile", category="io/fs", min_in=2, max_in=2, pass_nargout=True)
def m_copyfile(src, dst, nargout=1):
    try:
        fs().copy(text_of(src), text_of(dst))
        return MatArray.logical_scalar(True)
    except Exception as e:
        if nargout >= 1:
            return MatArray.logical_scalar(False)
        raise MatError("MATLAB:COPYFILE:FileDoesNotExist", str(e))


@builtin("movefile", category="io/fs", min_in=2, max_in=2, pass_nargout=True)
def m_movefile(src, dst, nargout=1):
    try:
        fs().rename(text_of(src), text_of(dst))
        return MatArray.logical_scalar(True)
    except Exception as e:
        if nargout >= 1:
            return MatArray.logical_scalar(False)
        raise MatError("MATLAB:MOVEFILE:FileDoesNotExist", str(e))


@builtin("rmdir", category="io/fs", min_in=1, max_in=2, pass_nargout=True)
def m_rmdir(p, flag=None, nargout=1):
    rec = flag is not None and text_of(flag) == "s"
    try:
        fs().rmdir(text_of(p), recursive=rec)
        return MatArray.logical_scalar(True) if nargout >= 1 else None
    except Exception as e:
        if nargout >= 1:
            return MatArray.logical_scalar(False)
        raise MatError("MATLAB:RMDIR:NotADirectory", str(e))


@builtin("fileattrib", category="io/fs", min_in=1, max_in=1, pass_nargout=True)
def m_fileattrib(p, nargout=1):
    t = text_of(p)
    try:
        st = fs().stat(t)
        ok = True
    except Exception:
        st = {"isdir": False, "writable": False}
        ok = False
    attrs = StructArray.scalar({
        "Name": MatArray.char_from_str(os.path.abspath(t)),
        "directory": MatArray.logical_scalar(bool(st.get("isdir", False))),
        "UserRead": MatArray.logical_scalar(ok),
        "UserWrite": MatArray.logical_scalar(bool(st.get("writable", False))),
    })
    if nargout <= 1:
        return MatArray.logical_scalar(ok)
    return [MatArray.logical_scalar(ok), attrs]


@builtin("system", category="io/fs", min_in=1, max_in=1, pass_nargout=True)
def m_system(cmd, nargout=1):
    import subprocess
    r = subprocess.run(text_of(cmd), shell=True, capture_output=True, text=True)
    outs = [MatArray.scalar(float(r.returncode)),
            MatArray.char_from_str(r.stdout + r.stderr)]
    return outs[:max(1, nargout)]


@builtin("unsetenv", category="io/fs", min_in=1, max_in=1)
def m_unsetenv(name):
    os.environ.pop(text_of(name), None)
    return None


@builtin("isenv", category="io/fs", min_in=1, max_in=1)
def m_isenv(name):
    return MatArray.logical_scalar(text_of(name) in os.environ)


@builtin("restoredefaultpath", category="io/fs", min_in=0, max_in=0, pass_ctx=True)
def m_restoredefaultpath(ctx=None):
    ctx.session.search_path = []
    return None


@builtin("savepath", category="io/fs", min_in=0, max_in=1, pass_ctx=True)
def m_savepath(p=None, ctx=None):
    target = text_of(p) if p is not None else os.path.expanduser("~/.runmat_tpu_path")
    fs().write_bytes(target, "\n".join(ctx.session.search_path).encode())
    return MatArray.scalar(0.0)


# ------------------------------------------------------------- preferences --- #

_PREFS: dict[str, dict[str, object]] = {}


@builtin("setpref", category="io/prefs", min_in=3, max_in=3)
def m_setpref(group, name, value):
    _PREFS.setdefault(text_of(group), {})[text_of(name)] = value
    return None


@builtin("getpref", category="io/prefs", min_in=1, max_in=3)
def m_getpref(group, name=None, default=None):
    g = _PREFS.get(text_of(group), {})
    if name is None:
        return StructArray.scalar({k: v for k, v in g.items()})
    key = text_of(name)
    if key in g:
        return g[key]
    if default is not None:
        return default
    raise MatError("MATLAB:Pref:NotFound",
                   f"Preference '{key}' not found in group '{text_of(group)}'.")


@builtin("ispref", category="io/prefs", min_in=1, max_in=2)
def m_ispref(group, name=None):
    g = _PREFS.get(text_of(group))
    if name is None:
        return MatArray.logical_scalar(g is not None)
    return MatArray.logical_scalar(g is not None and text_of(name) in g)


@builtin("rmpref", category="io/prefs", min_in=1, max_in=2)
def m_rmpref(group, name=None):
    if name is None:
        _PREFS.pop(text_of(group), None)
    else:
        _PREFS.get(text_of(group), {}).pop(text_of(name), None)
    return None


# ----------------------------------------------------------- fid text ops --- #

def _fid_of(fid):
    f = _FIDS.get(int(fid.scalar_double()))
    if f is None:
        raise MatError("MATLAB:badfid_mx", "Invalid file identifier.")
    return f


@builtin("feof", category="io/filetext", min_in=1, max_in=1)
def m_feof(fid):
    f = _fid_of(fid)
    pos = f.tell()
    ch = f.read(1)
    f.seek(pos)
    return MatArray.logical_scalar(ch == "" or ch == b"")


@builtin("fgets", category="io/filetext", min_in=1, max_in=1)
def m_fgets(fid):
    f = _fid_of(fid)
    line = f.readline()
    if line == "" or line == b"":
        return MatArray.scalar(-1.0)
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    return MatArray.char_from_str(line)


@builtin("frewind", category="io/filetext", min_in=1, max_in=1)
def m_frewind(fid):
    _fid_of(fid).seek(0)
    return None


_FREAD_DTYPES = {
    "uint8": np.uint8, "int8": np.int8, "uint16": np.uint16, "int16": np.int16,
    "uint32": np.uint32, "int32": np.int32, "uint64": np.uint64,
    "int64": np.int64, "single": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64, "char": np.uint8,
    "uchar": np.uint8, "schar": np.int8,
}


@builtin("fread", category="io/filetext", min_in=1, max_in=3)
def m_fread(fid, count=None, precision=None):
    f = _fid_of(fid)
    prec = text_of(precision) if precision is not None else "uint8"
    prec = prec.split("=>")[0].strip()
    dt = _FREAD_DTYPES.get(prec, np.uint8)
    n = -1
    shape = None
    if count is not None and not is_text(count):
        hc = _f(count).reshape(-1)
        if hc.size == 1:
            n = int(hc[0]) if np.isfinite(hc[0]) else -1
        else:
            rows = int(hc[0])
            cols = int(hc[1]) if np.isfinite(hc[1]) else -1
            n = rows * cols if cols >= 0 else -1
            shape = (rows, cols)
    raw = f.read() if n < 0 else f.read(n * np.dtype(dt).itemsize)
    if isinstance(raw, str):
        raw = raw.encode("utf-8")
    vals = np.frombuffer(raw, dtype=dt).astype(np.float64)
    if shape is not None:
        rows = shape[0]
        cols = vals.size // rows
        vals = vals[:rows * cols].reshape((rows, cols), order="F")
        return MatArray(vals, "double")
    return MatArray(vals.reshape(-1, 1), "double")


@builtin("readlines", category="io/filetext", min_in=1, max_in=1)
def m_readlines(path):
    raw = fs().read_bytes(text_of(path)).decode("utf-8")
    lines = raw.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    data = np.array([[ln.rstrip("\r")] for ln in lines], dtype=object)
    return StringArray(data.reshape(-1, 1))


@builtin("writelines", category="io/filetext", min_in=2, max_in=2)
def m_writelines(lines, path):
    if isinstance(lines, StringArray):
        ts = [s or "" for s in lines.data.reshape(-1, order="F")]
    elif isinstance(lines, CellArray):
        ts = [e.to_str() for e in lines.data.reshape(-1, order="F")]
    else:
        ts = [text_of(lines)]
    fs().write_bytes(text_of(path), ("\n".join(ts) + "\n").encode("utf-8"))
    return None


@builtin("filewrite", category="io/filetext", min_in=2, max_in=2)
def m_filewrite(path, content):
    fs().write_bytes(text_of(path), text_of(content).encode("utf-8"))
    return None


# ------------------------------------------------------------ tabular io --- #

@builtin("dlmread", category="io/tabular", min_in=1, max_in=4)
def m_dlmread(path, delim=None, r0=None, c0=None):
    raw = fs().read_bytes(text_of(path)).decode("utf-8")
    d = text_of(delim) if delim is not None else None
    rows = []
    for line in raw.strip().split("\n"):
        if not line.strip():
            continue
        parts = line.split(d) if d else re.split(r"[,\s]+", line.strip())
        rows.append([float(p) if p else 0.0 for p in parts if p != ""])
    width = max(len(r) for r in rows) if rows else 0
    M = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        M[i, :len(r)] = r
    i0 = scalar_int(r0, "r0") if r0 is not None else 0
    j0 = scalar_int(c0, "c0") if c0 is not None else 0
    return MatArray(M[i0:, j0:], "double")


@builtin("dlmwrite", category="io/tabular", min_in=2, max_in=None)
def m_dlmwrite(path, m, *rest):
    # dlmwrite(file, M [, delim] [, 'delimiter', d] [, 'precision', p])
    d = ","
    rest = list(rest)
    i = 0
    while i < len(rest):
        a = rest[i]
        if is_text(a) and text_of(a).lower() == "delimiter" and \
                i + 1 < len(rest):
            d = text_of(rest[i + 1])
            i += 2
        elif is_text(a) and text_of(a).lower() == "precision" and \
                i + 1 < len(rest):
            i += 2      # accepted; %g formatting already round-trips
        elif is_text(a):
            d = text_of(a)
            i += 1
        else:
            i += 1
    h = _f(m)
    lines = [d.join(f"{v:g}" for v in row) for row in np.atleast_2d(h)]
    fs().write_bytes(text_of(path), ("\n".join(lines) + "\n").encode("utf-8"))
    return None


@builtin("writecell", category="io/tabular", min_in=2, max_in=2)
def m_writecell(c, path):
    if not isinstance(c, CellArray):
        raise bad_arg("writecell", "First argument must be a cell array.")
    rows = []
    for i in range(c.shape[0]):
        parts = []
        for j in range(c.shape[1]):
            e = c.data[i, j]
            if isinstance(e, MatArray) and e.mclass == "char":
                parts.append(e.to_str())
            elif isinstance(e, StringArray):
                parts.append(e.item() or "")
            elif isinstance(e, MatArray) and e.size == 1:
                parts.append(f"{e.host().reshape(-1)[0]:g}")
            else:
                parts.append("")
        rows.append(",".join(parts))
    fs().write_bytes(text_of(path), ("\n".join(rows) + "\n").encode("utf-8"))
    return None


# Minimal xlsx codec: a workbook is a zip of XML parts. Write numbers and
# inline strings on one sheet; read sheet1 with shared-string resolution.

def _xlsx_write(path: str, M, texts=None) -> None:
    import zipfile

    rows_xml = []
    nrows, ncols = M.shape
    for i in range(nrows):
        cells = []
        for j in range(ncols):
            ref = f"{_col_name(j)}{i + 1}"
            if texts is not None and texts[i][j] is not None:
                s = texts[i][j].replace("&", "&amp;").replace("<", "&lt;")
                cells.append(f'<c r="{ref}" t="inlineStr"><is><t>{s}</t></is></c>')
            else:
                v = M[i, j]
                if np.isfinite(v):
                    cells.append(f'<c r="{ref}"><v>{v:g}</v></c>')
        rows_xml.append(f'<row r="{i + 1}">' + "".join(cells) + "</row>")
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
             "<sheetData>" + "".join(rows_xml) + "</sheetData></worksheet>")
    content_types = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                     '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
                     '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
                     '<Default Extension="xml" ContentType="application/xml"/>'
                     '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
                     '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
                     "</Types>")
    rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
            "</Relationships>")
    wb = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
          '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
          'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
          '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>')
    wb_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
               '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
               '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
               "</Relationships>")
    import io as _io
    buf = _io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("xl/workbook.xml", wb)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    fs().write_bytes(path, buf.getvalue())


def _col_name(j: int) -> str:
    s = ""
    j += 1
    while j:
        j, r = divmod(j - 1, 26)
        s = chr(65 + r) + s
    return s


def _col_index(ref: str) -> int:
    j = 0
    for c in ref:
        if c.isalpha():
            j = j * 26 + (ord(c.upper()) - 64)
        else:
            break
    return j - 1


def _xlsx_read(path: str):
    import xml.etree.ElementTree as ET
    import zipfile
    import io as _io

    raw = fs().read_bytes(path)
    ns = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(_io.BytesIO(raw)) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{ns}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{ns}t")))
        sheet_name = next((n for n in z.namelist()
                           if n.startswith("xl/worksheets/sheet")), None)
        if sheet_name is None:
            raise MatError("MATLAB:xlsread:WorksheetNotFound", "No worksheet found.")
        root = ET.fromstring(z.read(sheet_name))
    cells = {}
    maxr = maxc = 0
    for row in root.iter(f"{ns}row"):
        for c in row.findall(f"{ns}c"):
            ref = c.get("r", "A1")
            j = _col_index(ref)
            i = int(re.sub(r"[A-Z]+", "", ref)) - 1
            t = c.get("t", "n")
            if t == "inlineStr":
                txt = "".join(e.text or "" for e in c.iter(f"{ns}t"))
                cells[(i, j)] = txt
            else:
                v_el = c.find(f"{ns}v")
                if v_el is None:
                    continue
                if t == "s":
                    cells[(i, j)] = shared[int(v_el.text)]
                else:
                    cells[(i, j)] = float(v_el.text)
            maxr, maxc = max(maxr, i + 1), max(maxc, j + 1)
    return cells, maxr, maxc


@builtin("xlswrite", category="io/tabular", min_in=2, max_in=2)
def m_xlswrite(path, m):
    if isinstance(m, CellArray):
        nrows, ncols = m.shape
        M = np.full((nrows, ncols), np.nan)
        texts = [[None] * ncols for _ in range(nrows)]
        for i in range(nrows):
            for j in range(ncols):
                e = m.data[i, j]
                if isinstance(e, MatArray) and e.mclass == "char":
                    texts[i][j] = e.to_str()
                elif isinstance(e, StringArray):
                    texts[i][j] = e.item() or ""
                elif isinstance(e, MatArray) and e.size == 1:
                    M[i, j] = float(e.host().reshape(-1)[0].real)
        _xlsx_write(text_of(path), M, texts)
    else:
        _xlsx_write(text_of(path), np.atleast_2d(_f(m)))
    return MatArray.logical_scalar(True)


@builtin("xlsread", category="io/tabular", min_in=1, max_in=1, pass_nargout=True)
def m_xlsread(path, nargout=1):
    cells, nr, nc = _xlsx_read(text_of(path))
    num = np.full((nr, nc), np.nan)
    txt = np.empty((nr, nc), dtype=object)
    for (i, j), v in cells.items():
        if isinstance(v, float):
            num[i, j] = v
            txt[i, j] = MatArray.char_from_str("")
        else:
            txt[i, j] = MatArray.char_from_str(v)
    for i in range(nr):
        for j in range(nc):
            if txt[i, j] is None:
                txt[i, j] = MatArray.char_from_str("")
    # trim all-NaN leading rows/cols like MATLAB's numeric block extraction
    out = MatArray(num, "double")
    if nargout <= 1:
        return out
    return [out, CellArray(txt)]


# ---------------------------------------------------------------- archives --- #

@builtin("gzip", category="io/archive", min_in=1, max_in=1)
def m_gzip(path):
    import gzip as _gz
    p = text_of(path)
    data = fs().read_bytes(p)
    fs().write_bytes(p + ".gz", _gz.compress(data))
    data2 = np.empty((1, 1), dtype=object)
    data2[0, 0] = MatArray.char_from_str(p + ".gz")
    return CellArray(data2)


@builtin("gunzip", category="io/archive", min_in=1, max_in=1)
def m_gunzip(path):
    import gzip as _gz
    p = text_of(path)
    out = p[:-3] if p.endswith(".gz") else p + ".out"
    fs().write_bytes(out, _gz.decompress(fs().read_bytes(p)))
    data2 = np.empty((1, 1), dtype=object)
    data2[0, 0] = MatArray.char_from_str(out)
    return CellArray(data2)


# ------------------------------------------------------------------ audio --- #

@builtin("audioread", category="io/audio", min_in=1, max_in=1, pass_nargout=True)
def m_audioread(path, nargout=1):
    import wave
    import io as _io
    raw = fs().read_bytes(text_of(path))
    with wave.open(_io.BytesIO(raw), "rb") as w:
        nch, sw, fr, nframes = w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()
        frames = w.readframes(nframes)
    if sw == 2:
        data = np.frombuffer(frames, dtype=np.int16).astype(np.float64) / 32768.0
    elif sw == 1:
        data = (np.frombuffer(frames, dtype=np.uint8).astype(np.float64) - 128) / 128.0
    elif sw == 4:
        data = np.frombuffer(frames, dtype=np.int32).astype(np.float64) / 2147483648.0
    else:
        raise MatError("MATLAB:audiovideo:audioread:Unsupported",
                       f"Unsupported sample width {sw}.")
    y = data.reshape(-1, nch)
    outs = [MatArray(y, "double"), MatArray.scalar(float(fr))]
    return outs[:max(1, nargout)]


@builtin("audiowrite", category="io/audio", min_in=3, max_in=3)
def m_audiowrite(path, y, fsr):
    import wave
    import io as _io
    h = _f(y)
    if h.ndim == 2 and h.shape[0] == 1:
        h = h.T
    pcm = np.clip(np.round(h * 32767), -32768, 32767).astype(np.int16)
    buf = _io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(h.shape[1] if h.ndim == 2 else 1)
        w.setsampwidth(2)
        w.setframerate(int(scalar_num(fsr, "fs")))
        w.writeframes(pcm.tobytes())
    fs().write_bytes(text_of(path), buf.getvalue())
    return None


@builtin("audioinfo", category="io/audio", min_in=1, max_in=1)
def m_audioinfo(path):
    import wave
    import io as _io
    raw = fs().read_bytes(text_of(path))
    with wave.open(_io.BytesIO(raw), "rb") as w:
        info = StructArray.scalar({
            "Filename": MatArray.char_from_str(text_of(path)),
            "NumChannels": MatArray.scalar(float(w.getnchannels())),
            "SampleRate": MatArray.scalar(float(w.getframerate())),
            "TotalSamples": MatArray.scalar(float(w.getnframes())),
            "Duration": MatArray.scalar(w.getnframes() / max(w.getframerate(), 1)),
            "BitsPerSample": MatArray.scalar(float(w.getsampwidth() * 8)),
            "CompressionMethod": MatArray.char_from_str("Uncompressed"),
        })
    return info


# -------------------------------------------------------------- URL / net --- #

@builtin("urlencode", category="io/http", min_in=1, max_in=1)
def m_urlencode(s):
    from urllib.parse import quote
    return MatArray.char_from_str(quote(text_of(s), safe=""))


@builtin("urldecode", category="io/http", min_in=1, max_in=1)
def m_urldecode(s):
    from urllib.parse import unquote
    return MatArray.char_from_str(unquote(text_of(s)))


@builtin("weboptions", category="io/http", min_in=0)
def m_weboptions(*args):
    fields = {"Timeout": MatArray.scalar(5.0),
              "ContentType": MatArray.char_from_str("auto"),
              "UserAgent": MatArray.char_from_str("runmat-tpu"),
              "HeaderFields": CellArray.empty()}
    i = 0
    args = list(args)
    while i + 1 < len(args):
        fields[text_of(args[i])] = args[i + 1]
        i += 2
    return StructArray.scalar(fields)


def _no_egress(name):
    raise MatError("MATLAB:webservices:ConnectionRefused",
                   f"{name}: network egress is disabled in this environment.")


@builtin("websave", category="io/http", min_in=2)
def m_websave(path, url, *rest):
    u = text_of(url)
    if u.startswith("file://"):
        src = u[len("file://"):]
        fs().write_bytes(text_of(path), fs().read_bytes(src))
        return MatArray.char_from_str(text_of(path))
    _no_egress("websave")


@builtin("webwrite", category="io/http", min_in=2)
def m_webwrite(url, data, *rest):
    _no_egress("webwrite")


@builtin("sendmail", category="io/http", min_in=2)
def m_sendmail(to, subject, *rest):
    _no_egress("sendmail")


# -------------------------------------------------------------------- diary --- #

@builtin("diary", category="io", min_in=0, max_in=1, pass_ctx=True)
def m_diary(arg=None, ctx=None):
    sess = ctx.session
    cur = getattr(sess, "_diary", None)
    if arg is None:
        # toggle with default filename
        if cur is not None:
            cur.close()
            sess._diary = None
        else:
            sess._diary = open("diary", "a")
        return None
    t = text_of(arg)
    if t == "off":
        if cur is not None:
            cur.close()
        sess._diary = None
    elif t == "on":
        if cur is None:
            sess._diary = open("diary", "a")
    else:
        if cur is not None:
            cur.close()
        sess._diary = open(t, "a")
    return None


# ------------------------------------------------------ XML / struct read --- #

def _xml_to_struct(el) -> StructArray:
    children = list(el)
    fields: dict = {}
    if el.attrib:
        fields["Attributes"] = StructArray.scalar(
            {k: MatArray.char_from_str(v) for k, v in el.attrib.items()})
    if not children:
        fields["Text"] = MatArray.char_from_str((el.text or "").strip())
    else:
        by_tag: dict[str, list] = {}
        for ch in children:
            by_tag.setdefault(ch.tag, []).append(ch)
        for tag, els in by_tag.items():
            if len(els) == 1:
                fields[tag] = _xml_to_struct(els[0])
            else:
                data = np.empty((len(els), 1), dtype=object)
                for i, e in enumerate(els):
                    data[i, 0] = _xml_to_struct(e)
                fields[tag] = CellArray(data)
    return StructArray.scalar(fields)


@builtin("xmlread", category="io/fs", min_in=1, max_in=1)
def m_xmlread(path):
    import xml.etree.ElementTree as ET
    raw = fs().read_bytes(text_of(path)).decode("utf-8")
    root = ET.fromstring(raw)
    return StructArray.scalar({root.tag: _xml_to_struct(root)})


def _struct_to_xml(name: str, v) -> str:
    if isinstance(v, StructArray) and v.is_scalar:
        keys = list(v.fields)
        # a struct whose only content field is Text is element text
        # (the shape xmlread produces for leaf elements)
        if "Text" in keys and all(k in ("Text", "Attributes") for k in keys):
            t = v.get_scalar_field("Text")
            return f"<{name}>{t.to_str() if hasattr(t, 'to_str') else ''}</{name}>"
        inner = "".join(_struct_to_xml(k, v.get_scalar_field(k))
                        for k in v.fields)
        return f"<{name}>{inner}</{name}>"
    if isinstance(v, MatArray):
        if v.mclass == "char":
            return f"<{name}>{v.to_str()}</{name}>"
        vals = " ".join(f"{x:g}" for x in v.host().astype(np.float64).reshape(-1, order="F"))
        return f"<{name}>{vals}</{name}>"
    if isinstance(v, StringArray):
        return f"<{name}>{v.item() or ''}</{name}>"
    return f"<{name}/>"


@builtin("xmlwrite", category="io/fs", min_in=1, max_in=2, pass_nargout=True)
def m_xmlwrite(path_or_struct, maybe_struct=None, nargout=1):
    if maybe_struct is None:
        s = path_or_struct
        path = None
    else:
        path = text_of(path_or_struct)
        s = maybe_struct
    if not isinstance(s, StructArray) or not s.is_scalar:
        raise bad_arg("xmlwrite", "Expected a scalar struct document.")
    keys = list(s.fields)
    if len(keys) != 1:
        body = "".join(_struct_to_xml(k, s.get_scalar_field(k)) for k in keys)
        doc = f'<?xml version="1.0"?><document>{body}</document>'
    else:
        doc = '<?xml version="1.0"?>' + _struct_to_xml(keys[0], s.get_scalar_field(keys[0]))
    if path is not None:
        fs().write_bytes(path, doc.encode("utf-8"))
        return None
    return MatArray.char_from_str(doc)


@builtin("readstruct", category="io/fs", min_in=1, max_in=1)
def m_readstruct(path):
    p = text_of(path)
    if p.endswith(".json"):
        from .file_io import m_jsondecode
        raw = fs().read_bytes(p).decode("utf-8")
        return m_jsondecode(MatArray.char_from_str(raw))
    doc = m_xmlread(path)
    # unwrap the root element
    keys = list(doc.fields)
    return doc.get_scalar_field(keys[0])


@builtin("writestruct", category="io/fs", min_in=2, max_in=2)
def m_writestruct(s, path):
    p = text_of(path)
    if p.endswith(".json"):
        from .file_io import m_jsonencode
        txt = m_jsonencode(s).to_str()
        fs().write_bytes(p, txt.encode("utf-8"))
        return None
    m_xmlwrite(MatArray.char_from_str(p), s)
    return None


# --------------------------------------------------------------- memmapfile --- #

@builtin("memmapfile", category="io/fs", min_in=1)
def m_memmapfile(path, *opts):
    fmt = "uint8"
    i = 0
    opts = list(opts)
    while i + 1 < len(opts):
        if is_text(opts[i]) and text_of(opts[i]).lower() == "format":
            fmt = text_of(opts[i + 1])
        i += 2
    dt = _FREAD_DTYPES.get(fmt, np.uint8)
    mm = np.memmap(text_of(path), dtype=dt, mode="r")
    data = MatArray(np.asarray(mm).astype(np.float64).reshape(-1, 1), "double")
    return StructArray.scalar({
        "Filename": MatArray.char_from_str(text_of(path)),
        "Format": MatArray.char_from_str(fmt),
        "Data": data,
    })


# -------------------------------------------------- headless-UI / platform --- #

def _headless(name):
    raise MatError("MATLAB:ui:HeadlessEnvironment",
                   f"{name} requires an interactive desktop session.")


@builtin("uigetfile", category="io/ui", min_in=0)
def m_uigetfile(*a):
    _headless("uigetfile")


@builtin("uiputfile", category="io/ui", min_in=0)
def m_uiputfile(*a):
    _headless("uiputfile")


@builtin("uigetdir", category="io/ui", min_in=0)
def m_uigetdir(*a):
    _headless("uigetdir")


@builtin("open", category="io/ui", min_in=1, max_in=1, pass_ctx=True)
def m_open(path, ctx=None):
    p = text_of(path)
    if p.endswith(".mat"):
        r = ctx.interp.call_named("load", [MatArray.char_from_str(p)], 1, ctx.frame)
        return r[0] if isinstance(r, list) and r else r
    _headless("open")


@builtin("opentoline", category="io/ui", min_in=2)
def m_opentoline(*a):
    _headless("opentoline")


@builtin("winqueryreg", category="io/fs", min_in=1)
def m_winqueryreg(*a):
    raise MatError("MATLAB:winqueryreg:NotWindows",
                   "winqueryreg is only available on Windows.")


@builtin("pcode", category="io/fs", min_in=1)
def m_pcode(*a):
    raise MatError("MATLAB:pcode:Unsupported",
                   "P-code generation is not supported by this runtime.")


# ----------------------------------------------------- legacy HDF5 wrappers --- #

@builtin("hdf5read", category="io", min_in=2, max_in=2)
def m_hdf5read(path, dset):
    from .file_io import m_h5read
    return m_h5read(path, dset)


@builtin("hdf5write", category="io", min_in=3, max_in=3)
def m_hdf5write(path, dset, data):
    from .file_io import m_h5create, m_h5write
    shape = MatArray(np.array([list(data.shape)], dtype=np.float64), "double")
    try:
        m_h5create(path, dset, shape)
    except Exception:
        pass
    return m_h5write(path, dset, data)


@builtin("hdf5info", category="io", min_in=1, max_in=1)
def m_hdf5info(path):
    from .file_io import m_h5info
    return m_h5info(path)


@builtin("h5disp", category="io", min_in=1, max_in=2, pass_ctx=True)
def m_h5disp(path, loc=None, ctx=None):
    from .file_io import m_h5info
    info = m_h5info(path)
    ctx.session.write(f"HDF5 {text_of(path)}\n")

    def walk(s, indent):
        if not isinstance(s, StructArray):
            return
        for k in s.fields:
            v = s.get_scalar_field(k)
            if isinstance(v, StructArray):
                ctx.session.write(" " * indent + k + "\n")
                walk(v, indent + 2)
            elif isinstance(v, CellArray):
                for e in v.data.reshape(-1):
                    walk(e, indent + 2)
            elif isinstance(v, MatArray) and v.mclass == "char":
                ctx.session.write(" " * indent + f"{k}: {v.to_str()}\n")
    walk(info, 2)
    return None


@builtin("h5writeatt", category="io", min_in=4, max_in=4)
def m_h5writeatt(path, loc, name, value):
    """Attribute writes store alongside the dataset in the container."""
    from . import file_io
    writer = getattr(file_io, "m_h5write_att_impl", None)
    if writer is not None:
        return writer(path, loc, name, value)
    # fall back: attributes as a sibling dataset under <loc>.attrs/<name>
    from .file_io import m_h5create, m_h5write
    att_path = text_of(loc).rstrip("/") + ".attrs/" + text_of(name)
    v = value if isinstance(value, MatArray) else MatArray.char_from_str(text_of(value))
    if v.mclass == "char":
        data = MatArray(np.array([[float(c) for c in v.host().reshape(-1)]]), "double")
    else:
        data = v
    shape = MatArray(np.array([list(data.shape)], dtype=np.float64), "double")
    try:
        m_h5create(path, MatArray.char_from_str(att_path), shape)
    except Exception:
        pass
    return m_h5write(path, MatArray.char_from_str(att_path), data)
