"""Thin netCDF-3 writer/reader helpers over scipy.io.netcdf (port of
qgcm_tpu/io/ncdf.py: host code, copied).

The reference writes netCDF classic files (src/nc_subs.F); scipy's
pure-python netCDF3 module reads and writes them without external
libraries. Dimension order note: the reference's Fortran API declares
variables with dims (x, y, z[, t]); the classic file stores the LAST
Fortran dim varying slowest, which equals a C declaration (t, z, y, x).
All defs here use the C order, so files are bit-compatible with the
reference layout and our [layer, y, x] arrays map directly.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


class NcWriter:
    """A netCDF3 file being written incrementally; the first dimension
    passed as None is the unlimited (record/time) dimension."""

    def __init__(self, path: str):
        self.f = netcdf_file(path, "w", mmap=False)
        self.vars = {}

    def dim(self, name: str, size):
        if name not in self.f.dimensions:
            self.f.createDimension(name, size)

    def var(self, name: str, dtype, dims, units=None, long_name=None,
            data=None):
        v = self.f.createVariable(name, dtype, dims)
        if units is not None:
            v.units = units.encode() if isinstance(units, str) else units
        if long_name is not None:
            v.long_name = long_name.encode()
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            if dims:
                v[:] = data
            else:           # a scalar: scipy takes no slice of it
                v.data[...] = data
        self.vars[name] = v
        return v

    def append(self, name: str, rec: int, value):
        v = self.vars[name]
        v[rec] = np.asarray(value, dtype=v.data.dtype
                            if hasattr(v, "data") else v.typecode())

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


def make_writer(path: str, backend: str = None):
    """Writer factory. backend: "native" (C++ async runtime), "scipy",
    or None -> $QGCM_IO_BACKEND or auto (native when it can be built).
    A native writer that was chosen and fails to build raises."""
    import os
    from .native import NativeNcWriter, available
    backend = backend or os.environ.get("QGCM_IO_BACKEND", "auto")
    if backend not in ("auto", "native", "scipy"):
        raise ValueError(f"unknown netCDF writer backend {backend!r}")
    if backend == "native" or (backend == "auto" and available()):
        return NativeNcWriter(path)
    return NcWriter(path)


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array on the
    host: the one place the writers copy device data out."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_var(path: str, name: str) -> np.ndarray:
    with netcdf_file(path, "r", mmap=False) as f:
        return np.array(f.variables[name].data, dtype=np.float64)


def read_vars(path: str, names) -> dict:
    out = {}
    with netcdf_file(path, "r", mmap=False) as f:
        for n in names:
            out[n] = np.array(f.variables[n].data, dtype=np.float64)
    return out
