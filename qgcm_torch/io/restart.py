"""Checkpoint/restart in the reference's restart.nc schema (port of
qgcm_tpu/io/restart.py).

Writes every prognostic field at BOTH leapfrog time levels in double
precision so restarts are exact (resave_nc, src/nc_subs.F:1331-1718;
reader restart_nc:1721-2050). Vorticity is NOT stored -- it is
recomputed from pressure on load, exactly as the reference does
(q-gcm.F:715-750). Coordinate variables are written in km, ocean
coordinates relative to the ocean box origin (nc_subs.F:1596-1656).

The schema is qgcm_tpu's, variable for variable, so a restart written
by either package is read by the other. Fields go to float64 NumPy at
write time; a load builds tensors on the model's device in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .ncdf import host, make_writer as NcWriter, read_vars
from ..state import AtmosForcing, AtmosState, OceanForcing, OceanState


def _layer_depths(h):
    h = np.asarray(h)
    tops = np.concatenate([[0.0], np.cumsum(h)[:-1]])
    return 1.0e-3 * (tops + 0.5 * h), 1.0e-3 * np.cumsum(h)[:-1]


def _f64(x) -> np.ndarray:
    return host(x).astype(np.float64)


def save_restart(path: str, model, ocean: OceanState, atmos: AtmosState,
                 tyrs: float, ofor: OceanForcing = None,
                 afor: AtmosForcing = None):
    """Write restart.nc. Both states must be provided; in single-fluid
    modes pass the untouched init-time state for the inactive fluid
    (the reference likewise dumps the full state vector).

    ofor/afor: optional forcing to embed. The reference schema has no
    forcing variables -- its restart dumps are always coupling-cycle
    aligned (q-gcm.F:656-698), so xforc at resume reproduces the
    forcing exactly. The exact-cadence extension can dump MID cycle,
    where the leapfrog m-slots have advanced past the cycle head and a
    recompute would diverge; the driver then embeds the open cycle's
    forcing here and load_restart_forcing hands it back."""
    cfg = model.cfg
    g = model.grids
    w = NcWriter(path)
    w.dim("time", 1)
    w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo); w.dim("zo", cfg.nlo)
    w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
    w.dim("xpa", cfg.nxpa); w.dim("ypa", cfg.nypa); w.dim("za", cfg.nla)
    w.dim("xta", cfg.nxta); w.dim("yta", cfg.nyta)

    w.var("time", "d", ("time",), units="years", data=[tyrs])
    w.var("xpo", "d", ("xpo",), units="km",
          data=1.0e-3 * (g.xpo - g.xpo[0]))
    w.var("xto", "d", ("xto",), units="km",
          data=1.0e-3 * (g.xto - g.xpo[0]))
    w.var("ypo", "d", ("ypo",), units="km",
          data=1.0e-3 * (g.ypo - g.ypo[0]))
    w.var("yto", "d", ("yto",), units="km",
          data=1.0e-3 * (g.yto - g.ypo[0]))
    zo, _ = _layer_depths(cfg.ocean.hoc)
    w.var("zo", "d", ("zo",), units="km", data=zo)
    w.var("xpa", "d", ("xpa",), units="km", data=1.0e-3 * g.xpa)
    w.var("xta", "d", ("xta",), units="km", data=1.0e-3 * g.xta)
    w.var("ypa", "d", ("ypa",), units="km", data=1.0e-3 * g.ypa)
    w.var("yta", "d", ("yta",), units="km", data=1.0e-3 * g.yta)
    za, _ = _layer_depths(cfg.atmos.hat)
    w.var("za", "d", ("za",), units="km", data=za)

    w.var("sst", "d", ("yto", "xto"), units="K", data=_f64(ocean.sst))
    w.var("sstm", "d", ("yto", "xto"), units="K", data=_f64(ocean.sstm))
    w.var("po", "d", ("zo", "ypo", "xpo"), units="m^2/s^2",
          data=_f64(ocean.po))
    w.var("pom", "d", ("zo", "ypo", "xpo"), units="m^2/s^2",
          data=_f64(ocean.pom))
    w.var("ast", "d", ("yta", "xta"), units="K", data=_f64(atmos.ast))
    w.var("astm", "d", ("yta", "xta"), units="K", data=_f64(atmos.astm))
    w.var("hmixa", "d", ("yta", "xta"), units="m", data=_f64(atmos.hmixa))
    w.var("hmixam", "d", ("yta", "xta"), units="m",
          data=_f64(atmos.hmixam))
    w.var("pa", "d", ("za", "ypa", "xpa"), units="m^2/s^2",
          data=_f64(atmos.pa))
    w.var("pam", "d", ("za", "ypa", "xpa"), units="m^2/s^2",
          data=_f64(atmos.pam))
    if ofor is not None:
        w.var("tauxo", "d", ("ypo", "xpo"), units="m^2/s^2",
              data=_f64(ofor.tauxo))
        w.var("tauyo", "d", ("ypo", "xpo"), units="m^2/s^2",
              data=_f64(ofor.tauyo))
        w.var("fnetoc", "d", ("yto", "xto"), units="W/m^2",
              data=_f64(ofor.fnetoc))
        w.var("wekto", "d", ("yto", "xto"), units="m/s",
              data=_f64(ofor.wekto))
        w.var("wekpo", "d", ("ypo", "xpo"), units="m/s",
              data=_f64(ofor.wekpo))
        w.var("txisoc", "d", ("time",), data=[float(ofor.txisoc)])
        w.var("txinoc", "d", ("time",), data=[float(ofor.txinoc)])
    if afor is not None:
        w.var("tauxa", "d", ("ypa", "xpa"), units="m^2/s^2",
              data=_f64(afor.tauxa))
        w.var("tauya", "d", ("ypa", "xpa"), units="m^2/s^2",
              data=_f64(afor.tauya))
        w.var("fnetat", "d", ("yta", "xta"), units="W/m^2",
              data=_f64(afor.fnetat))
        w.var("wekta", "d", ("yta", "xta"), units="m/s",
              data=_f64(afor.wekta))
        w.var("wekpa", "d", ("ypa", "xpa"), units="m/s",
              data=_f64(afor.wekpa))
        w.var("uekat", "d", ("yta", "xpa"), units="m/s",
              data=_f64(afor.uekat))
        w.var("vekat", "d", ("ypa", "xta"), units="m/s",
              data=_f64(afor.vekat))
        w.var("txisat", "d", ("time",), data=[float(afor.txisat)])
        w.var("txinat", "d", ("time",), data=[float(afor.txinat)])
    w.close()


def load_restart(path: str, model):
    """Read restart.nc -> (OceanState, AtmosState, tini_years), tensors
    on model.device in model.dtype. PV and the constraint scalars are
    rederived from the pressures (q-gcm.F:711-750), which is what makes
    the checkpoint exact."""
    from ..models.atmos import init_atmos_state
    from ..models.ocean import init_ocean_state

    d = read_vars(path, ["time", "sst", "sstm", "po", "pom",
                         "ast", "astm", "hmixa", "hmixam", "pa", "pam"])
    ocean = init_ocean_state(model, po=d["po"], pom=d["pom"],
                             sst=d["sst"], sstm=d["sstm"])
    atmos = init_atmos_state(model, pa=d["pa"], pam=d["pam"],
                             ast=d["ast"], astm=d["astm"],
                             hmixa=d["hmixa"], hmixam=d["hmixam"])
    return ocean, atmos, float(np.ravel(d["time"])[0])


def load_restart_forcing(path: str, model):
    """Read the optional embedded forcing of a mid-cycle restart dump
    (see save_restart) -> (OceanForcing | None, AtmosForcing | None).
    Cycle-aligned dumps (the reference's only kind) carry none and the
    driver recomputes forcing with xforc, as the reference does at
    q-gcm.F:870."""
    from scipy.io import netcdf_file

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=model.device, dtype=model.dtype)

    with netcdf_file(path, "r", mmap=False) as f:
        names = set(f.variables)

        def arr(n):
            return tensor(f.variables[n][:])

        def scl(n):
            return tensor(float(np.ravel(f.variables[n][:])[0]))

        ofor = afor = None
        if "tauxo" in names:
            ofor = OceanForcing(
                tauxo=arr("tauxo"), tauyo=arr("tauyo"),
                fnetoc=arr("fnetoc"), wekto=arr("wekto"),
                wekpo=arr("wekpo"), txisoc=scl("txisoc"),
                txinoc=scl("txinoc"))
        if "tauxa" in names:
            afor = AtmosForcing(
                tauxa=arr("tauxa"), tauya=arr("tauya"),
                fnetat=arr("fnetat"), wekta=arr("wekta"),
                wekpa=arr("wekpa"), uekat=arr("uekat"),
                vekat=arr("vekat"), txisat=scl("txisat"),
                txinat=scl("txinat"))
    return ofor, afor
