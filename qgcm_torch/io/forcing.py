"""Mean-forcing file (avges.nc) read/write.

Ocean-only runs need (fnetoc, tauxo, tauyo); atmos-only runs need the
mean SST field (q-gcm.F:752-826). The k247 forcing generator
(src/k247_make_forcing_q-gcm.F90) writes the same variables; our
`generators.zero_forcing`/`double_gyre_windstress` produce the arrays
and `write_mean_forcing` lays them out in the reference schema.
Host code, copied from qgcm_tpu/io/forcing.py.
"""

from __future__ import annotations

import numpy as np

from .ncdf import make_writer as NcWriter, read_vars, read_var


def write_mean_forcing(path: str, model, tauxo, tauyo, fnetoc,
                       sst=None):
    cfg = model.cfg
    w = NcWriter(path)
    w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
    w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
    w.var("tauxo", "d", ("ypo", "xpo"), units="m^2/s^2", data=tauxo)
    w.var("tauyo", "d", ("ypo", "xpo"), units="m^2/s^2", data=tauyo)
    w.var("fnetoc", "d", ("yto", "xto"), units="W/m^2", data=fnetoc)
    if sst is not None:
        w.var("sst", "d", ("yto", "xto"), units="K", data=sst)
    w.close()


def read_mean_forcing(path: str):
    """-> (tauxo, tauyo, fnetoc) as float64 [y, x] arrays. Transposes
    Fortran-written files ((x,y) order) automatically based on shape."""
    d = read_vars(path, ["tauxo", "tauyo", "fnetoc"])
    tx, ty, fn = d["tauxo"], d["tauyo"], d["fnetoc"]
    # p-grid fields are (nypo, nxpo); if square this is ambiguous but
    # then transposition does not change the shape contract.
    if tx.shape[0] == fn.shape[1] + 1 and tx.shape != (fn.shape[0] + 1,
                                                       fn.shape[1] + 1):
        tx, ty, fn = tx.T, ty.T, fn.T
    return tx, ty, fn


def read_mean_sst(path: str) -> np.ndarray:
    return read_var(path, "sst")
