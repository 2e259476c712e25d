"""Ocean dq/dt term decomposition -> qocdiag.nc (reference
src/qocdiag.F: variables dqdt, qotjac, qt2dif, qt4dif, qotent); port of
qgcm_tpu/diags/qocdiag.py.

Recomputes the pieces of the PV tendency as the plain chain of the
vorticity step assembles them (ops/qgstep.py), but keeps them separate:
  qotjac = adfac * J(q, p)                     (advection)
  qt2dif = (ah2/f0) * del4 p_lagged            (Del-sqd diffusion)
  qt4dif = -(ah4/f0) * del6 p_lagged           (Del-4th diffusion)
  qotent = layer forcing (Ekman - entrainment, bottom drag)
  dqdt   = sum of the above
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.ncdf import host
from ..ops.stencils import (del2_bc, jacobian9, _col_mask, _eshift,
                            _pad_xy, _pad_y, _row_mask, _wshift)


def qocdiag_terms(model, state, forcing, entoc) -> dict:
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    po, pom, qo = state.po, state.pom, state.qo
    dxom2 = 1.0 / g.dxo**2
    adfaco = 1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot)
    bcfaco = cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0)
    bdrfac = 0.5 * float(np.sign(cfg.fnot)) * cfg.ocean.delek \
        / cfg.ocean.hoc[-1]

    del2p = del2_bc(pom, bcfaco, dxom2, cyclic)
    d4p = del2_bc(del2p, bcfaco, dxom2, cyclic)
    zonal = _row_mask(po[0], 0) | _row_mask(po[0], -1)
    if cyclic:
        d4pp = _pad_y(d4p)
        d6p = dxom2 * (d4pp[:, :-2, :] + d4pp[:, 2:, :] + _wshift(d4p)
                       + _eshift(d4p) - 4.0 * d4p)
        edge = zonal
    else:
        d4pp = _pad_xy(d4p)
        d6p = dxom2 * (d4pp[:, :-2, 1:-1] + d4pp[:, 2:, 1:-1]
                       + d4pp[:, 1:-1, :-2] + d4pp[:, 1:-1, 2:]
                       - 4.0 * d4p)
        edge = zonal | _col_mask(po[0], 0) | _col_mask(po[0], -1)
    d6full = torch.where(edge, 0.0, d6p)

    qotjac = adfaco * jacobian9(qo, po, cyclic)
    qt2dif = (model.ah2oc[:, None, None] / cfg.fnot) * d4p
    qt4dif = -(model.ah4oc[:, None, None] / cfg.fnot) * d6full
    qotent = torch.zeros_like(po)
    qotent[0] = (cfg.fnot / cfg.ocean.hoc[0]) * (forcing.wekpo - entoc)
    qotent[1] = (cfg.fnot / cfg.ocean.hoc[1]) * entoc
    qotent[-1] = qotent[-1] - bdrfac * del2p[-1]
    dqdt = qotjac + qt2dif + qt4dif + qotent
    return dict(dqdt=dqdt, qotjac=qotjac, qt2dif=qt2dif,
                qt4dif=qt4dif, qotent=qotent)


class QocdiagWriter:
    def __init__(self, path: str, model, stride: int = 1):
        from ..io.ncdf import make_writer as NcWriter
        cfg = model.cfg
        g = model.grids
        self.stride = stride
        self.rec = 0
        w = NcWriter(path)
        w.dim("time", None)
        nxs = len(range(0, cfg.nxpo, stride))
        nys = len(range(0, cfg.nypo, stride))
        w.dim("xp", nxs); w.dim("yp", nys); w.dim("z", cfg.nlo)
        w.var("xp", "f", ("xp",), units="km",
              data=1e-3 * (g.xpo[::stride] - g.xpo[0]))
        w.var("yp", "f", ("yp",), units="km",
              data=1e-3 * (g.ypo[::stride] - g.ypo[0]))
        w.var("time", "f", ("time",), units="years")
        for n in ("dqdt", "qotjac", "qt2dif", "qt4dif", "qotent"):
            w.var(n, "f", ("time", "z", "yp", "xp"), units="s^-2")
        self.w = w

    def append(self, terms: dict, tyrs: float):
        s = self.stride
        self.w.append("time", self.rec, tyrs)
        for n, v in terms.items():
            self.w.append(n, self.rec, host(v[..., ::s, ::s]))
        self.rec += 1

    def close(self):
        self.w.close()
