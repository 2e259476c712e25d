"""ctypes bindings for the native (C++) netCDF writer runtime (port of
qgcm_tpu/io/native.py).

`NativeNcWriter` mirrors `ncdf.NcWriter`'s interface but hands frames
to a background writer thread (native/ncwriter.cc) so the step loop
never blocks on disk. The library is built with g++ from the checkout's
native/ncwriter.cc into build/qgcm_torch/libqgncwriter-<hash>.so on
first use (the hash covers the source and the flags); nothing is loaded
from native/. `available()` says whether it can be built (the source and
g++ are present); a build that fails then raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_LIB = None
_NC_INT, _NC_FLOAT, _NC_DOUBLE = 4, 5, 6
_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "ncwriter.cc"
_BUILD_DIR = _ROOT / "build" / "qgcm_torch"
_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")


def _lib_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libqgncwriter-{key}.so"


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _lib_path()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: concurrent processes
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    lib.qgnc_create.argtypes = [ctypes.c_char_p]
    lib.qgnc_def_dim.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.qgnc_def_var.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)]
    lib.qgnc_put_att_text.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_char_p]
    lib.qgnc_enddef.argtypes = [ctypes.c_int]
    lib.qgnc_put.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.qgnc_put_async.argtypes = lib.qgnc_put.argtypes
    lib.qgnc_flush.argtypes = [ctypes.c_int]
    lib.qgnc_close.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    """True when the writer can be used: its source is in the checkout
    and g++ is on PATH (or the library is already built)."""
    return _SRC.exists() and (shutil.which("g++") is not None
                              or _lib_path().exists())


class NativeNcWriter:
    """Define-then-write netCDF3 writer backed by the C++ runtime.

    Unlike the scipy-backed NcWriter, variable definitions must all
    happen before the first data write (`_enddef` runs lazily on the
    first append/var-with-data)."""

    def __init__(self, path: str, async_io: bool = True):
        self.lib = _load()
        self.h = self.lib.qgnc_create(path.encode())
        if self.h < 0:
            raise OSError(f"cannot create {path}")
        self.dimids = {}
        self.varids = {}
        self.vdtype = {}
        self._defined = False
        self._pending = []          # (name, data) written after enddef
        self.async_io = async_io

    def dim(self, name: str, size):
        if name not in self.dimids:
            self.dimids[name] = self.lib.qgnc_def_dim(
                self.h, name.encode(), -1 if size is None else int(size))

    def var(self, name: str, dtype, dims, units=None, long_name=None,
            data=None):
        if dtype in ("d", np.float64):
            xt = _NC_DOUBLE
        elif dtype in ("i", np.int32):
            xt = _NC_INT
        else:
            xt = _NC_FLOAT
        ids = (ctypes.c_int * len(dims))(
            *[self.dimids[d] for d in dims])
        vid = self.lib.qgnc_def_var(self.h, name.encode(), xt,
                                    len(dims), ids)
        self.varids[name] = vid
        self.vdtype[name] = {_NC_DOUBLE: np.float64, _NC_INT: np.int32,
                             _NC_FLOAT: np.float32}[xt]
        if units is not None:
            self.lib.qgnc_put_att_text(self.h, vid, b"units",
                                       str(units).encode())
        if long_name is not None:
            self.lib.qgnc_put_att_text(self.h, vid, b"long_name",
                                       str(long_name).encode())
        if data is not None:
            self._pending.append((name, np.asarray(data)))

    def _enddef(self):
        if not self._defined:
            if self.lib.qgnc_enddef(self.h):
                raise OSError("enddef failed")
            self._defined = True
            for name, data in self._pending:
                self._put(name, 0, data)
            self._pending = []

    def _put(self, name, rec, value):
        a = np.ascontiguousarray(value, dtype=self.vdtype[name])
        fn = (self.lib.qgnc_put_async if self.async_io
              else self.lib.qgnc_put)
        fn(self.h, self.varids[name], int(rec),
           a.ctypes.data_as(ctypes.c_void_p))

    def append(self, name: str, rec: int, value):
        self._enddef()
        self._put(name, rec, value)

    def flush(self):
        self._enddef()
        self.lib.qgnc_flush(self.h)

    def close(self):
        self._enddef()
        self.lib.qgnc_close(self.h)
