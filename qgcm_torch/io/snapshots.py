"""Snapshot output streams matching the reference schemas:

  ocpo.nc  : p, q, h, taux, tauy on the ocean p grid (4-D float)
  ocsst.nc : sst, wekt on the ocean T grid (3-D float)
  atpa.nc  : p, q, h, taux, tauy on the atmos p grid
  atast.nc : ast, wekt, hmixa on the atmos T grid

(ocnc_init/ocnc_out src/nc_subs.F:116-486,837-1077; atnc_* :488-1330.)
Field selection via the outfloc/outflat 7-flag vectors
(src/input.params:132-143: [ml-temp, p, q, wekt, h, tau, hmix]) and
spatial subsampling by stride nsko/nska. Interface displacement
h(k) = (p(k+1)-p(k))/gprime(k) for the ocean and
(p(k)-p(k+1))/gprime(k) for the atmosphere (eta sign conventions of
nc_subs.F:1012-1031 and :1240-1260).

Port of qgcm_tpu/io/snapshots.py: fields are subsampled on the device
and copied to the host once each, at write time.
"""

from __future__ import annotations

import numpy as np

from .ncdf import host, make_writer as NcWriter


def _sub(a, stride):
    """Every stride-th row and column of a tensor or array, on the host."""
    return host(a[..., ::stride, ::stride])


class _Snapshots:
    """Common machinery; subclasses bind names/grids/sign conventions."""

    def __init__(self, pathp, patht, model, flags, stride, atmos: bool):
        cfg = model.cfg
        g = model.grids
        self.flags = flags
        self.stride = stride
        self.atmos = atmos
        self.model = model
        self.rec = 0
        if atmos:
            nl = cfg.nla
            xp, yp = g.xpa, g.ypa
            xt, yt = g.xta, g.yta
            h = cfg.atmos.hat
            x0, y0 = 0.0, 0.0
            tname = "ast"
        else:
            nl = cfg.nlo
            xp, yp = g.xpo, g.ypo
            xt, yt = g.xto, g.yto
            h = cfg.ocean.hoc
            x0, y0 = g.xpo[0], g.ypo[0]
            tname = "sst"
        self.nl = nl
        xp_s, yp_s = xp[::stride], yp[::stride]
        xt_s, yt_s = xt[::stride], yt[::stride]

        wp = NcWriter(pathp)
        wp.dim("time", None)
        wp.dim("xp", len(xp_s)); wp.dim("yp", len(yp_s))
        wp.dim("z", nl); wp.dim("zi", nl - 1)
        wp.var("xp", "f", ("xp",), units="km", data=1e-3 * (xp_s - x0))
        wp.var("yp", "f", ("yp",), units="km", data=1e-3 * (yp_s - y0))
        tops = np.concatenate([[0.0], np.cumsum(h)[:-1]])
        wp.var("z", "f", ("z",), units="km",
               data=1e-3 * (tops + 0.5 * np.asarray(h)))
        wp.var("zi", "f", ("zi",), units="km",
               data=1e-3 * np.cumsum(h)[:-1])
        wp.var("time", "f", ("time",), units="years")
        if flags[1]:
            wp.var("p", "f", ("time", "z", "yp", "xp"), units="m^2/s^2")
        if flags[2]:
            wp.var("q", "f", ("time", "z", "yp", "xp"), units="s^-1")
        if flags[4]:
            wp.var("h", "f", ("time", "zi", "yp", "xp"), units="m")
        if flags[5]:
            wp.var("taux", "f", ("time", "yp", "xp"), units="m^2/s^2")
            wp.var("tauy", "f", ("time", "yp", "xp"), units="m^2/s^2")
        self.wp = wp

        wt = NcWriter(patht)
        wt.dim("time", None)
        wt.dim("xt", len(xt_s)); wt.dim("yt", len(yt_s))
        wt.var("xt", "f", ("xt",), units="km", data=1e-3 * (xt_s - x0))
        wt.var("yt", "f", ("yt",), units="km", data=1e-3 * (yt_s - y0))
        wt.var("time", "f", ("time",), units="years")
        if flags[0]:
            wt.var(tname, "f", ("time", "yt", "xt"), units="K")
        if flags[3]:
            wt.var("wekt", "f", ("time", "yt", "xt"), units="m/s")
        if atmos and flags[6]:
            wt.var("hmixa", "f", ("time", "yt", "xt"), units="m")
        self.wt = wt
        self.tname = tname

    def _eta(self, p):
        model = self.model
        if self.atmos:
            return (p[:-1] - p[1:]) / model.gpat[:, None, None]
        return (p[1:] - p[:-1]) / model.gpoc[:, None, None]

    def append(self, state, forcing, tyrs: float):
        s = self.stride
        fl = self.flags
        r = self.rec
        wp, wt = self.wp, self.wt
        p = state.pa if self.atmos else state.po
        q = state.qa if self.atmos else state.qo
        wp.append("time", r, tyrs)
        wt.append("time", r, tyrs)
        if fl[1]:
            wp.append("p", r, _sub(p, s))
        if fl[2]:
            wp.append("q", r, _sub(q, s))
        if fl[4]:
            wp.append("h", r, _sub(self._eta(p), s))
        if fl[5]:
            tx = forcing.tauxa if self.atmos else forcing.tauxo
            ty = forcing.tauya if self.atmos else forcing.tauyo
            wp.append("taux", r, _sub(tx, s))
            wp.append("tauy", r, _sub(ty, s))
        if fl[0]:
            t = state.ast if self.atmos else state.sst
            wt.append(self.tname, r, _sub(t, s))
        if fl[3]:
            wk = forcing.wekta if self.atmos else forcing.wekto
            wt.append("wekt", r, _sub(wk, s))
        if self.atmos and fl[6]:
            wt.append("hmixa", r, _sub(state.hmixa, s))
        self.rec += 1

    def close(self):
        self.wp.close()
        self.wt.close()


class OceanSnapshots(_Snapshots):
    def __init__(self, outdir, model, flags=(1, 1, 1, 1, 1, 1, 0),
                 stride=1):
        super().__init__(f"{outdir}/ocpo.nc", f"{outdir}/ocsst.nc",
                         model, flags, stride, atmos=False)


class AtmosSnapshots(_Snapshots):
    def __init__(self, outdir, model, flags=(1, 1, 1, 1, 1, 1, 1),
                 stride=1):
        super().__init__(f"{outdir}/atpa.nc", f"{outdir}/atast.nc",
                         model, flags, stride, atmos=True)
