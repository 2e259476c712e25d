"""Topography setup.

Replaces reference src/topsubs.F:41-479. Modes per fluid:
  'flat'    -- zero topography
  'define'  -- the reference's built-in test features (mid-Atlantic
               ridge for the ocean, topsubs.F:120-133; sloping Rockies
               for the atmosphere, topsubs.F:270-298)
  'extant'  -- pre-existing topography supplied by the caller
               (topsubs.F:146-163: the field is used as already set,
               e.g. by a dataset-preparation program like toptest)
  ndarray   -- user-supplied physical topography at p points (m)
  str path  -- NetCDF file with variable dtopoc/dtopat (topsubs.F:165+)

Validation as in topset: non-flat topographies are warned about if not
exactly cyclic in x (topsubs.F:227-236, 425-437), and any nonzero
atmospheric topography over the ocean footprint aborts unless
atmver=False (the dataset-preparation escape hatch, topsubs.F:392-416).

Physical topography D (m) is rescaled to dynamic topography
ddyn = (f0/H_bottom) * D (topsubs.F:454,467), where the "bottom" layer
is layer nlo (index -1) for the ocean and layer 1 (index 0) for the
atmosphere.

Copied from qgcm_tpu/topo.py, which is NumPy-only but cannot be
imported without JAX (the qgcm_tpu package __init__ imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from .config import ModelConfig
from .grids import Grids
from .ops.integrals import xintp_weights

TopoSpec = Union[str, np.ndarray]


@dataclass(frozen=True)
class Topography:
    dtopoc: np.ndarray   # (nypo, nxpo) physical ocean topography (m)
    ddynoc: np.ndarray   # (nypo, nxpo) dynamic ocean topography (s^-1)
    davgoc: float
    dtopat: np.ndarray   # (nypa, nxpa)
    ddynat: np.ndarray
    davgat: float

    def _or_scalar(self, field, dtype):
        """Scalar zero when flat: a grid of literal zeros would be
        serialized into every compiled program."""
        import numpy as np
        if not field.any():
            return np.zeros((), dtype)
        return np.asarray(field, dtype)

    def ddynoc_or_scalar(self, dtype):
        return self._or_scalar(self.ddynoc, dtype)

    def ddynat_or_scalar(self, dtype):
        return self._or_scalar(self.ddynat, dtype)

    def dtopat_or_scalar(self, dtype):
        return self._or_scalar(self.dtopat, dtype)


def _ocean_define(cfg: ModelConfig, grids: Grids) -> np.ndarray:
    """Mid-Atlantic ridge test feature (topsubs.F:120-133)."""
    dxlo, dxhi = 2000.0e3, 2600.0e3
    dcent = 0.5 * (dxlo + dxhi)
    dhwid = 0.5 * (dxhi - dxlo)
    xrel = grids.xpo - grids.xpo[0]
    ridge = 1000.0 * (1.0 - np.abs(xrel - dcent) / dhwid)
    ridge = np.maximum(0.0, ridge)
    return np.broadcast_to(ridge[None, :], (cfg.nypo, cfg.nxpo)).copy()


def _atmos_define(cfg: ModelConfig, grids: Grids) -> np.ndarray:
    """Sloping-ridge 'Rockies' test feature (topsubs.F:270-298)."""
    dcent, dhwid = 8800.0e3, 1440.0e3
    xacent = dcent - 2000.0e3 * grids.yparel / (0.5 * grids.yla)
    topo = 1000.0 * (1.0 - np.abs(grids.xpa[None, :] - xacent[:, None])
                     / dhwid)
    return np.maximum(0.0, topo)


def _load_netcdf(path: str, var: str, shape) -> np.ndarray:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        data = np.asarray(f.variables[var][:], dtype=np.float64)
    # reference stores (x, y); we use (y, x)
    if data.shape == shape:
        return data
    if data.shape == shape[::-1]:
        return data.T
    raise ValueError(f"{var} in {path} has shape {data.shape}, "
                     f"expected {shape} (or its transpose)")


def write_topog(path: str, model):
    """topog.nc: physical + dynamic topography record (topout_nc,
    src/topsubs.F:482-560), written when topography is active."""
    from .io.ncdf import make_writer as NcWriter
    cfg = model.cfg
    t = model.topo
    w = NcWriter(path)
    w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
    w.dim("xpa", cfg.nxpa); w.dim("ypa", cfg.nypa)
    w.var("dtopoc", "d", ("ypo", "xpo"), units="m", data=t.dtopoc)
    w.var("ddynoc", "d", ("ypo", "xpo"), units="s^-1", data=t.ddynoc)
    w.var("dtopat", "d", ("ypa", "xpa"), units="m", data=t.dtopat)
    w.var("ddynat", "d", ("ypa", "xpa"), units="s^-1", data=t.ddynat)
    w.close()


def build_topography(cfg: ModelConfig, grids: Grids,
                     topocname: TopoSpec = "flat",
                     topatname: TopoSpec = "flat",
                     extant_oc: np.ndarray = None,
                     extant_at: np.ndarray = None,
                     atmver: bool = True) -> Topography:
    # Ocean
    if isinstance(topocname, np.ndarray):
        dtopoc = np.asarray(topocname, dtype=np.float64)
    elif topocname == "flat":
        dtopoc = np.zeros((cfg.nypo, cfg.nxpo))
    elif topocname == "define":
        dtopoc = _ocean_define(cfg, grids)
    elif topocname == "extant":
        if extant_oc is None:
            raise ValueError("topocname='extant' needs a pre-existing "
                             "field (extant_oc=)")
        dtopoc = np.asarray(extant_oc, dtype=np.float64)
    else:
        dtopoc = _load_netcdf(topocname, "dtopoc", (cfg.nypo, cfg.nxpo))
    if dtopoc.shape != (cfg.nypo, cfg.nxpo):
        raise ValueError(f"ocean topography shape {dtopoc.shape} != "
                         f"({cfg.nypo}, {cfg.nxpo})")

    # Atmosphere
    if isinstance(topatname, np.ndarray):
        dtopat = np.asarray(topatname, dtype=np.float64)
    elif topatname == "flat":
        dtopat = np.zeros((cfg.nypa, cfg.nxpa))
    elif topatname == "define":
        dtopat = _atmos_define(cfg, grids)
    elif topatname == "extant":
        if extant_at is None:
            raise ValueError("topatname='extant' needs a pre-existing "
                             "field (extant_at=)")
        dtopat = np.asarray(extant_at, dtype=np.float64)
    else:
        dtopat = _load_netcdf(topatname, "dtopat", (cfg.nypa, cfg.nxpa))
    if dtopat.shape != (cfg.nypa, cfg.nxpa):
        raise ValueError(f"atmos topography shape {dtopat.shape} != "
                         f"({cfg.nypa}, {cfg.nxpa})")

    # Cyclicity checks (topsubs.F:227-236 ocean, :425-437 atmos)
    import warnings
    if cfg.cyclic_ocean and dtopoc.any() \
            and not np.array_equal(dtopoc[:, 0], dtopoc[:, -1]):
        warnings.warn("ocean topography not exactly cyclic in x")
    if dtopat.any() and not np.array_equal(dtopat[:, 0], dtopat[:, -1]):
        warnings.warn("atmos topography not exactly cyclic in x")

    # No atmospheric topography over the ocean footprint, boundary
    # points included (topsubs.F:392-416); atmver=False while
    # preparing topography datasets
    if atmver and not cfg.ocean_only and not cfg.atmos_only:
        j0, i0 = cfg.ny1 - 1, cfg.nx1 - 1
        over = dtopat[j0:j0 + cfg.nyaooc + 1, i0:i0 + cfg.nxaooc + 1]
        if over.any():
            j, i = np.unravel_index(np.argmax(over != 0.0), over.shape)
            raise ValueError(
                "nonzero atmosphere topography over ocean at "
                f"(j, i) = ({j0 + j}, {i0 + i})")

    wo = xintp_weights(cfg.nypo, cfg.nxpo)
    wa = xintp_weights(cfg.nypa, cfg.nxpa)
    davgoc = float((dtopoc * wo).sum() * cfg.ocnorm)
    davgat = float((dtopat * wa).sum() * cfg.atnorm)

    ddynoc = (cfg.fnot / cfg.ocean.hoc[-1]) * dtopoc
    ddynat = (cfg.fnot / cfg.atmos.hat[0]) * dtopat
    return Topography(dtopoc=dtopoc, ddynoc=ddynoc, davgoc=davgoc,
                      dtopat=dtopat, ddynat=ddynat, davgat=davgat)
