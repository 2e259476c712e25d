"""Run-analysis: the K247_qgcm_data equivalents (a copy of
qgcm_tpu/analysis/core.py: NumPy and scipy host code).

Loads an outdata directory (monit.nc, input_parameters.m, ocpo.nc) and
provides the computations the Ruby layer does:
  * geostrophic velocities from snapshot pressure
    (uvgeooc2d_calc, qgcm_k247.rb:212-233)
  * 2-D KE/PE fields per layer (ke2d_calc/pe2d_calc, :176-195)
  * SSH-max eddy tracking (sshmax_set_with_ij, :336-389)
  * area-averaged energy series + checks
    (chk_monit_energy_*, :391-454), written to monit_energy.nc
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

GRAV = 9.8
M_TO_CM = 100.0


def _read_matlab_params(path: str) -> dict:
    vals = {}
    for line in open(path):
        line = line.strip().rstrip(";")
        if "=" not in line:
            continue
        name, rhs = line.split("=", 1)
        rhs = rhs.strip()
        if rhs.startswith("'"):          # string entries (file names etc.)
            vals[name.strip()] = rhs.strip("'")
        elif rhs.startswith("["):
            vals[name.strip()] = np.asarray(
                [float(t) for t in rhs[1:-1].split()])
        else:
            vals[name.strip()] = float(rhs)
    return vals


class QgcmData:
    def __init__(self, outdata: str):
        self.dir = outdata
        self.par = _read_matlab_params(
            os.path.join(outdata, "input_parameters.m"))
        self.rhooc = self.par.get("rhooc", 1.0e3)
        self.gpoc = np.atleast_1d(self.par["gpoc"])
        self.hoc = np.atleast_1d(self.par["hoc"])
        self.dxo = float(self.par["dxo"])
        self.fnot = float(self.par["fnot"])
        self.rdxof0 = 1.0 / (self.dxo * self.fnot)

    # -- snapshot-based fields ----------------------------------------
    def _ocpo(self, name):
        with netcdf_file(os.path.join(self.dir, "ocpo.nc"), "r",
                         mmap=False) as f:
            return (f.variables[name][:].copy(),
                    f.variables["time"][:].copy())

    def uvgeo(self, po2d: np.ndarray):
        """Centred geostrophic velocities from a (ny, nx) pressure
        field; boundary ring zero (uvgeooc2d_calc)."""
        u = np.zeros_like(po2d)
        v = np.zeros_like(po2d)
        u[1:-1, 1:-1] = -0.5 * self.rdxof0 * (po2d[2:, 1:-1]
                                              - po2d[:-2, 1:-1])
        v[1:-1, 1:-1] = 0.5 * self.rdxof0 * (po2d[1:-1, 2:]
                                             - po2d[1:-1, :-2])
        return u, v

    def ke2d(self, po2d: np.ndarray, k: int) -> np.ndarray:
        u, v = self.uvgeo(po2d)
        return 0.5 * self.rhooc * self.hoc[k] * (u**2 + v**2)

    def pe2d(self, p_up: np.ndarray, p_down: np.ndarray,
             k: int) -> np.ndarray:
        eta = (p_down - p_up) / self.gpoc[k]
        return 0.5 * self.rhooc * self.gpoc[k] * eta**2

    def sshmax(self):
        """SSH maximum (cm) + (i, j) index time series from ocpo.nc
        layer-1 pressure snapshots."""
        p, t = self._ocpo("p")
        p1 = p[:, 0]                     # (nt, ny, nx)
        nt = p1.shape[0]
        hmax = np.empty(nt)
        hi = np.empty(nt, int)
        hj = np.empty(nt, int)
        for n in range(nt):
            j, i = np.unravel_index(np.argmax(p1[n]), p1[n].shape)
            hmax[n] = p1[n, j, i] * M_TO_CM / GRAV
            hi[n], hj[n] = i, j
        return t, hmax, hi, hj

    def write_sshmax(self, path=None):
        from ..io.ncdf import make_writer as NcWriter
        t, hmax, hi, hj = self.sshmax()
        path = path or os.path.join(self.dir, "sshmax_etc.nc")
        w = NcWriter(path)
        w.dim("time", len(t))
        w.var("time", "f", ("time",), units="years", data=t)
        w.var("hmax", "f", ("time",), units="cm", data=hmax)
        w.var("hmax_i", "f", ("time",), data=hi.astype(np.float32))
        w.var("hmax_j", "f", ("time",), data=hj.astype(np.float32))
        w.close()
        return path

    # -- monit-based energy series ------------------------------------
    def energy_series(self):
        """-> dict of time (years), keocavg (nt, nlo), peocavg
        (nt, nlo-1), ke_sum, pe_sum, te (J m^-2)."""
        with netcdf_file(os.path.join(self.dir, "monit.nc"), "r",
                         mmap=False) as f:
            t = f.variables["time"][:].copy()
            ke = f.variables["kealoc"][:].copy()
            et2 = f.variables["et2moc"][:].copy()
        pe = 0.5 * self.rhooc * self.gpoc[None, :] * et2
        ke_sum = ke.sum(axis=1)
        pe_sum = pe.sum(axis=1)
        return dict(time=t, keocavg=ke, peocavg=pe, ke_sum=ke_sum,
                    pe_sum=pe_sum, te=ke_sum + pe_sum)

    def energy_check(self, verbose=True) -> dict:
        """chk_monit_energy_stdout: total/potential/kinetic energy
        conservation ratios over the run."""
        e = self.energy_series()
        te, ke, pe = e["te"], e["keocavg"], e["peocavg"]
        out = dict(
            te_fin_over_ini=float(te[-1] / te[0]) if te[0] else np.inf,
            te_min_over_max=float(te.min() / te.max()) if te.max()
            else np.inf,
            pe_fin_over_ini=float(pe.sum(1)[-1] / pe.sum(1)[0])
            if pe.sum(1)[0] else np.inf,
            ke_upper_fin_over_ini=float(ke[-1, 0] / ke[0, 0])
            if ke[0, 0] else np.inf,
        )
        if verbose:
            print("Check area-averaged energy (from monit.nc)")
            for k, v in out.items():
                print(f"  {k}: {v:.6f}")
        return out

    def write_energy(self, path=None):
        from ..io.ncdf import make_writer as NcWriter
        e = self.energy_series()
        path = path or os.path.join(self.dir, "monit_energy.nc")
        w = NcWriter(path)
        nt, nlo = e["keocavg"].shape
        w.dim("time", nt)
        w.var("time", "f", ("time",), units="years", data=e["time"])
        for k in range(nlo):
            w.var(f"keocavg{k}", "f", ("time",), units="J/m^2",
                  data=e["keocavg"][:, k])
        for k in range(e["peocavg"].shape[1]):
            w.var(f"peocavg{k}", "f", ("time",), units="J/m^2",
                  data=e["peocavg"][:, k])
        w.var("ke_sum", "f", ("time",), units="J/m^2", data=e["ke_sum"])
        w.var("pe_sum", "f", ("time",), units="J/m^2", data=e["pe_sum"])
        w.var("te", "f", ("time",), units="J/m^2", data=e["te"])
        w.close()
        return path
