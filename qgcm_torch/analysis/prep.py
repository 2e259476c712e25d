"""Post-run preparation tools (a copy of qgcm_tpu/analysis/prep.py:
NumPy and scipy host code).

Replaces the k247 Ruby prep layer:
  unify_monit   -- concatenate the monit.nc of successive run segments
                   (qgcm_prep_k247.rb: unified monit_k247.nc)
  average_more  -- N-file re-averaging of the daily ocavg_* stream
                   (prep_avg_avgmore.rb)
  cut_eddy      -- eddy-centred cut-out around the SSH maximum
                   (prep_avg_cuteddy.rb)
  hmax_series   -- SSH-max time series over the ocavg stream
                   (prep_avg_hmax.rb)
"""

from __future__ import annotations

import glob
import os

import numpy as np
from scipy.io import netcdf_file

from .core import GRAV, M_TO_CM


def unify_monit(outdirs, path):
    """Concatenate monit.nc time series from successive run segments
    into one file (dropping duplicated boundary records)."""
    from ..io.ncdf import make_writer as NcWriter
    series = {}
    times = []
    for d in outdirs:
        with netcdf_file(os.path.join(d, "monit.nc"), "r",
                         mmap=False) as f:
            t = f.variables["time"][:].copy()
            start = 0
            if times and len(t) and t[0] <= times[-1][-1]:
                start = int(np.searchsorted(t, times[-1][-1], "right"))
            times.append(t[start:])
            for name, v in f.variables.items():
                if name == "time" or v.dimensions[0] != "time":
                    continue
                series.setdefault(name, []).append(
                    (v[:].copy()[start:], v.dimensions))
    tall = np.concatenate(times)
    w = NcWriter(path)
    w.dim("time", len(tall))
    w.var("time", "f", ("time",), units="years", data=tall)
    for name, chunks in series.items():
        data = np.concatenate([c[0] for c in chunks])
        dims = chunks[0][1]
        for dn, dsz in zip(dims[1:], data.shape[1:]):
            w.dim(dn, dsz)
        w.var(name, "f", dims, data=data)
    w.close()
    return path


def _load_ocavg(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return f.variables["po"][:].copy()


def average_more(avg_dir, n, out_dir=None):
    """Re-average the ocavg_*.nc stream in blocks of n files."""
    from ..io.ncdf import make_writer as NcWriter
    files = sorted(glob.glob(os.path.join(avg_dir, "ocavg_*.nc")))
    out_dir = out_dir or avg_dir
    written = []
    for b in range(len(files) // n):
        blk = files[b * n:(b + 1) * n]
        po = np.mean([_load_ocavg(f) for f in blk], axis=0)
        path = os.path.join(out_dir, f"ocavg{n}_{b:04d}.nc")
        w = NcWriter(path)
        w.dim("zo", po.shape[0])
        w.dim("ypo", po.shape[1]); w.dim("xpo", po.shape[2])
        w.var("po", "f", ("zo", "ypo", "xpo"), units="m^2/s^2",
              data=po)
        w.close()
        written.append(path)
    return written


def cut_eddy(po, half_width):
    """Cut a (2*half+1)^2 box centred on the layer-1 SSH maximum from a
    (nlo, ny, nx) pressure field; clipped at the domain edges."""
    j, i = np.unravel_index(np.argmax(po[0]), po[0].shape)
    jlo, jhi = max(0, j - half_width), min(po.shape[1], j + half_width + 1)
    ilo, ihi = max(0, i - half_width), min(po.shape[2], i + half_width + 1)
    return po[:, jlo:jhi, ilo:ihi], (j, i)


def hmax_series(avg_dir):
    """SSH-max (cm) + index series over the ocavg stream."""
    files = sorted(glob.glob(os.path.join(avg_dir, "ocavg_*.nc")))
    hmax = np.empty(len(files))
    hi = np.empty(len(files), int)
    hj = np.empty(len(files), int)
    for n, f in enumerate(files):
        po = _load_ocavg(f)
        j, i = np.unravel_index(np.argmax(po[0]), po[0].shape)
        hmax[n] = po[0, j, i] * M_TO_CM / GRAV
        hi[n], hj[n] = i, j
    return hmax, hi, hj
