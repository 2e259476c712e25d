"""Monitoring diagnostics incl. the energy budget (monit.nc); port of
qgcm_tpu/diags/monitor.py.

Replaces reference src/monitor_diag.F monnc_comp/monnc_init/monnc_out
and writes the reference's monit.nc variable names. Formulas as in
qgcm_tpu (monitor_data.F:72-220 docs):
  kealoc  = 0.5 rho H(k) <u^2+v^2>          (u,v geostrophic faces)
  ddtke   = rho H(k) <u du/dt + v dv/dt>    (du/dt from p - pm)
  ddtpe   = rho gp(k) <eta d(eta)/dt>
  pken    = rho gp(1) <eta1 * entrainment>
  utau    = rho <u1 taux + v1 tauy>         (monitor_diag.F:590-617)
  btdg    = 0.5 rho delek |f0| <u_nlo^2 + v_nlo^2>   (lagged)
  ah2d/ah4d: -/+ rho Ah H(k) <u del2/del4 u + v ...> (lagged)
  olrtop  = Bup(nla)(hmlmat-hmat) + Cup(nla) davgat
            + Dup(nla) tmlmat + sum Aup(nla,i) etamat(i)
All <.> are area means with trapezoidal edge weights (genint,
monitor_diag.F:1155-1210). The record is computed on the model's
device; MonitorWriter copies it to the host in one transfer per record.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .cfl import cfl_numbers


def _genint(f, xfac, yfac):
    """Weighted sum over the last two axes with end-row/column factors
    (genint); one value per leading index."""
    wx = torch.ones(f.shape[-1], dtype=f.dtype, device=f.device)
    wy = torch.ones(f.shape[-2], dtype=f.dtype, device=f.device)
    wx[0] = wx[-1] = xfac
    wy[0] = wy[-1] = yfac
    return (f * wy[:, None] * wx[None, :]).sum(dim=(-2, -1))


class FluidMonitor(NamedTuple):
    kea: torch.Tensor      # (nl,) layer KE (J m^-2)
    ddtke: torch.Tensor    # (nl,) d/dt KE (W m^-2)
    ddtpe: torch.Tensor    # (nl-1,) d/dt PE per interface (W m^-2)
    pken: torch.Tensor     # scalar: eta1*entrainment exchange (W m^-2)
    utau: torch.Tensor     # scalar: wind work (W m^-2)
    ah2d: torch.Tensor     # (nl,) del2 dissipation (W m^-2)
    ah4d: torch.Tensor     # (nl,) del4 dissipation (W m^-2)
    etam: torch.Tensor     # (nl-1,) mean eta (m)
    et2m: torch.Tensor     # (nl-1,) mean eta^2 (m^2)
    pavg: torch.Tensor     # (nl,)
    qavg: torch.Tensor     # (nl,)
    wetm: torch.Tensor     # mean Ekman w at T points (m/s)
    watm: torch.Tensor     # mean |Ekman w| at T points
    wepm: torch.Tensor     # mean Ekman w at p points
    wapm: torch.Tensor     # mean |Ekman w| at p points
    entm: torch.Tensor     # mean entrainment
    enam: torch.Tensor     # mean |entrainment|
    tmlm: torch.Tensor     # mean mixed layer temperature
    tmin: torch.Tensor
    tmax: torch.Tensor
    jetpos: torch.Tensor   # (nl,) j row (1-based) of the max |zonal-
                           # mean u| -- jet/storm-track position
                           # (ocjpos/atstpos, monitor_diag.F:382,697)
    jetval: torch.Tensor   # (nl,) that max zonal-mean speed (m/s)


def _lap(f, dx):
    """Interior 5-point Laplacian, zero on the boundary rows/columns."""
    out = torch.zeros_like(f)
    out[..., 1:-1, 1:-1] = (f[..., :-2, 1:-1] + f[..., 2:, 1:-1]
                            + f[..., 1:-1, :-2] + f[..., 1:-1, 2:]
                            - 4.0 * f[..., 1:-1, 1:-1]) / dx**2
    return out


def _fluid_monitor(p, pm, q, eta_sign, gp, h, rho, f0, dx, dt,
                   ah2, ah4, wekt, wekp, ent, tml, norm,
                   tau=None, delek=0.0):
    """Shared ocean/atmos monitoring. eta_sign: +1 if eta = (p(k+1)-
    p(k))/gp (ocean), -1 for the atmosphere convention."""
    rdxf0 = 1.0 / (dx * f0)
    z = p.new_zeros(())

    # geostrophic faces, current and lagged
    u = -rdxf0 * (p[:, 1:, :] - p[:, :-1, :])          # (nl, nyt, nxp)
    v = rdxf0 * (p[:, :, 1:] - p[:, :, :-1])           # (nl, nyp, nxt)
    dp = p - pm
    udot = -(rdxf0 / dt) * (dp[:, 1:, :] - dp[:, :-1, :])
    vdot = (rdxf0 / dt) * (dp[:, :, 1:] - dp[:, :, :-1])
    um = -rdxf0 * (pm[:, 1:, :] - pm[:, :-1, :])
    vm = rdxf0 * (pm[:, :, 1:] - pm[:, :, :-1])

    def gu(f):   # u-grid integral: x ends are p points
        return _genint(f, 0.5, 1.0)

    def gv(f):
        return _genint(f, 1.0, 0.5)

    def gp_(f):
        return _genint(f, 0.5, 0.5)

    kea = 0.5 * rho * h * (gu(u ** 2) + gv(v ** 2)) * norm
    ddtke = rho * h * (gu(u * udot) + gv(v * vdot)) * norm

    # del2/del4 dissipation on the lagged velocities (interior stencil)
    d2um, d2vm = _lap(um, dx), _lap(vm, dx)
    d4um, d4vm = _lap(d2um, dx), _lap(d2vm, dx)
    ah2d = -rho * ah2 * h * (gu(um * d2um) + gv(vm * d2vm)) * norm
    ah4d = rho * ah4 * h * (gu(um * d4um) + gv(vm * d4vm)) * norm

    # interface displacement terms
    eta = eta_sign * (p[1:] - p[:-1]) / gp[:, None, None]
    etam_f = eta_sign * (pm[1:] - pm[:-1]) / gp[:, None, None]
    etadot = (eta - etam_f) / dt
    etam = gp_(eta) * norm
    et2m = gp_(eta ** 2) * norm
    ddtpe = rho * gp * gp_(eta * etadot) * norm

    pavg = gp_(p) * norm
    qavg = gp_(q) * norm

    # entrainment exchange (interface 1 only)
    pken = (rho * gp[0] * gp_(eta[0] * ent) * norm
            if ent is not None else z)

    # wind work (monitor_diag.F:590-617)
    if tau is not None:
        taux, tauy = tau
        txav = 0.5 * (taux[1:, :] + taux[:-1, :])
        tyav = 0.5 * (tauy[:, 1:] + tauy[:, :-1])
        utau = rho * (gu(u[0] * txav) + gv(v[0] * tyav)) * norm
    else:
        utau = z

    # bottom Ekman drag (ocean only; lagged velocities)
    if delek:
        btdg = 0.5 * rho * delek * abs(f0) * (
            gu(um[-1] ** 2) + gv(vm[-1] ** 2)) * norm
    else:
        btdg = z

    # jet (storm-track) position: row of max |zonal-mean u|
    # (monitor_diag.F:357-390 atmos, :672-705 ocean). The zonal sum
    # runs over the nxt distinct u faces (the duplicated/zero end
    # column is dropped).
    ujet = u[:, :, :-1].sum(dim=-1).abs() / (u.shape[-1] - 1)
    jetval = ujet.amax(dim=-1)
    jetpos = torch.argmax(ujet, dim=-1) + 1       # 1-based j

    mon = FluidMonitor(
        kea=kea, ddtke=ddtke, ddtpe=ddtpe, pken=pken, utau=utau,
        ah2d=ah2d, ah4d=ah4d, etam=etam, et2m=et2m, pavg=pavg,
        qavg=qavg,
        wetm=wekt.mean(), watm=wekt.abs().mean(),
        wepm=gp_(wekp) * norm,
        wapm=gp_(wekp.abs()) * norm,
        entm=(gp_(ent) * norm if ent is not None else z),
        enam=(gp_(ent.abs()) * norm if ent is not None else z),
        tmlm=tml.mean(), tmin=tml.min(), tmax=tml.max(),
        jetpos=jetpos, jetval=jetval)
    return mon, btdg


class MonitorRecord(NamedTuple):
    oc: Optional[FluidMonitor]
    at: Optional[FluidMonitor]
    btdgoc: torch.Tensor
    osfmin: torch.Tensor    # (nlo,) transport streamfunction min (Sv)
    osfmax: torch.Tensor
    occirc: torch.Tensor    # (nlo,) zonal transport (Sv, cyclic only)
    occtot: torch.Tensor
    hfmloc: torch.Tensor
    hcmlat: torch.Tensor
    tmaooc: torch.Tensor
    hmlmat: torch.Tensor
    olrtop: torch.Tensor
    ermaso: torch.Tensor
    emfroc: torch.Tensor
    ermasa: torch.Tensor
    emfrat: torch.Tensor
    cfraoc: torch.Tensor   # fraction of convecting ocean ML points
    centoc: torch.Tensor   # integrated convective entrainment
    cfraat: torch.Tensor
    centat: torch.Tensor
    slhfav: torch.Tensor   # xforc heat-flux means (arlaav etc.)
    oradav: torch.Tensor
    arocav: torch.Tensor
    arlaav: torch.Tensor
    bflux: dict            # sb/nb_hflux boundary fluxes (ttmads etc.)
    cfl: object


def compute_monitor(model, ocean=None, atmos=None, oc_forcing=None,
                    at_forcing=None, odiags=None, adiags=None,
                    xdiags=None) -> MonitorRecord:
    """Compute the monitoring record from current states. Entrainment
    fields are recomputed from the (lagged) states via the mixed-layer
    code, mirroring the values the next step will use."""
    cfg = model.cfg
    g = model.grids
    z = torch.zeros((), device=model.device, dtype=model.dtype)
    zv = torch.zeros((1,), device=model.device, dtype=model.dtype)
    mon_oc = mon_at = None
    btdg = hfml = hcml = tmaooc = olrtop = hmlmat = z
    osfmin = osfmax = occirc = zv
    occtot = z
    ermaso = emfroc = ermasa = emfrat = zv
    cfraoc = centoc = cfraat = centat = z
    slhfav = oradav = arocav = arlaav = z
    bflux = {n: z for n in ("ttmads", "vfmads", "ttmdfs", "ttmadn",
                            "vfmadn", "ttmdfn")}

    if ocean is not None and oc_forcing is not None:
        if cfg.no_oml:
            entoc = None
        else:
            from ..models.ocean import _oml
            _omlout = _oml(model, ocean, oc_forcing)
            entoc = _omlout[2]
            cfraoc, centoc = _omlout[6], _omlout[7]
        if cfg.sb_hflux or cfg.nb_hflux:
            from ..models.ocean import boundary_flux_diags
            bflux = boundary_flux_diags(model, ocean, oc_forcing)
        mon_oc, btdg = _fluid_monitor(
            ocean.po, ocean.pom, ocean.qo, +1.0, model.gpoc, model.hoc,
            cfg.rhooc, cfg.fnot, g.dxo, cfg.dto, model.ah2oc, model.ah4oc,
            oc_forcing.wekto, oc_forcing.wekpo, entoc, ocean.sst,
            cfg.ocnorm, tau=(oc_forcing.tauxo, oc_forcing.tauyo),
            delek=cfg.ocean.delek)
        # transport streamfunction extrema / zonal transport
        pref = ocean.po[:, 0, 0][:, None, None]
        psi = ((ocean.po - pref) / cfg.fnot).flatten(1)
        osfmin = 1e-6 * model.hoc * psi.min(dim=1).values
        osfmax = 1e-6 * model.hoc * psi.max(dim=1).values
        occirc = 1e-6 * model.hoc * (ocean.po[:, 0, 0]
                                     - ocean.po[:, -1, 0]) / cfg.fnot
        occtot = occirc.sum()
        hfml = cfg.rhooc * cfg.cpoc * (ocean.sst * oc_forcing.wekto).mean()
        # without a step's diagnostics the continuity errors read zero
        # at every interface (qgcm_tpu stores a (1,) zero here, which
        # its native writer extends past its end; ROADMAP.md section 3)
        ermaso = emfroc = torch.zeros_like(model.gpoc)
        if odiags is not None:
            ermaso, emfroc = odiags.ermaso, odiags.emfroc

    if atmos is not None and at_forcing is not None:
        from ..models.atmos import _aml
        _amlout = _aml(model, atmos, at_forcing)
        entat = _amlout[4]
        cfraat, centat = _amlout[8], _amlout[9]
        if xdiags is not None:
            # xforc heat-flux means, computed by the caller's xforc
            # pass ("computed in xforc, so no duplication",
            # monitor_data.F:110-113)
            slhfav, oradav = xdiags.slhfav, xdiags.oradav
            arocav, arlaav = xdiags.arocav, xdiags.arlaav
        mon_at, _ = _fluid_monitor(
            atmos.pa, atmos.pam, atmos.qa, -1.0, model.gpat, model.hat,
            cfg.rhoat, cfg.fnot, g.dxa, cfg.dta,
            torch.zeros_like(model.hat), model.ah4at,
            at_forcing.wekta, at_forcing.wekpa, entat, atmos.ast,
            cfg.atnorm, tau=(at_forcing.tauxa, at_forcing.tauya))
        hcml = cfg.rhoat * cfg.cpat * (atmos.ast * atmos.hmixa).mean()
        tmaooc = atmos.ast[cfg.ny1 - 1:cfg.ny1 - 1 + cfg.nyaooc,
                           cfg.nx1 - 1:cfg.nx1 - 1 + cfg.nxaooc].mean()
        hmlmat = atmos.hmixa.mean()
        rad = model.rad
        aup = torch.as_tensor(rad.Aup[-1, :]).to(model.device, model.dtype)
        olrtop = (float(rad.Bup[-1]) * (hmlmat - cfg.mixed.hmat)
                  + float(rad.Cup[-1]) * model.topo.davgat
                  + float(rad.Dup[-1]) * mon_at.tmlm
                  + (aup * mon_at.etam).sum())
        ermasa = emfrat = torch.zeros_like(model.gpat)
        if adiags is not None:
            ermasa, emfrat = adiags.ermasa, adiags.emfrat

    cfl = cfl_numbers(model, ocean, atmos, oc_forcing, at_forcing)
    return MonitorRecord(
        oc=mon_oc, at=mon_at, btdgoc=btdg, osfmin=osfmin,
        osfmax=osfmax, occirc=occirc, occtot=occtot, hfmloc=hfml,
        hcmlat=hcml, tmaooc=tmaooc, hmlmat=hmlmat, olrtop=olrtop,
        ermaso=ermaso, emfroc=emfroc, ermasa=ermasa, emfrat=emfrat,
        cfraoc=cfraoc, centoc=centoc, cfraat=cfraat, centat=centat,
        slhfav=slhfav, oradav=oradav, arocav=arocav, arlaav=arlaav,
        bflux=bflux, cfl=cfl)


# ----------------------------------------------------------------------
# monit.nc writer (reference variable names, monnc_init :1934-3008)
# ----------------------------------------------------------------------

_OC_VECNL = ["kealoc", "ddtkeoc", "ah2doc", "ah4doc", "pavgoc",
             "qavgoc", "osfmin", "osfmax", "occirc", "ugminoc",
             "ugmaxoc", "vgminoc", "vgmaxoc", "ocjval"]
_OC_VECNI = ["ddtpeoc", "etamoc", "et2moc", "ermaso", "emfroc"]
_OC_SCAL = ["pkenoc", "utauoc", "btdgoc", "occtot", "hfmloc", "wetmoc",
            "watmoc", "wepmoc", "wapmoc", "entmoc", "enamoc", "tmlmoc",
            "sstmin", "sstmax", "cnqgoc", "cnmloc", "cfraoc", "centoc",
            "umminoc", "ummaxoc", "vmminoc", "vmmaxoc",
            "ttmads", "vfmads", "ttmdfs", "ttmadn", "vfmadn", "ttmdfn"]
_AT_VECNL = ["kealat", "ddtkeat", "ah4dat", "pavgat", "qavgat",
             "ugminat", "ugmaxat", "vgminat", "vgmaxat", "atstval"]
_AT_VECNI = ["ddtpeat", "etamat", "et2mat", "ermasa", "emfrat"]
_AT_SCAL = ["pkenat", "utauat", "hcmlat", "tmaooc", "olrtop", "wetmat",
            "watmat", "wepmat", "wapmat", "entmat", "enamat", "tmlmat",
            "hmlmat", "astmin", "astmax", "cnqgat", "cnmlat", "cfraat",
            "centat", "slhfav", "oradav", "arocav", "arlaav",
            "umminat", "ummaxat", "vmminatat", "vmmaxat"]


def monitor_values(rec: MonitorRecord) -> dict:
    """{monit.nc variable name: tensor} of a record, in the writer's
    order: the ocean's names, then the atmosphere's."""
    vals = {}
    m = rec.oc
    if m is not None:
        vals.update(
            kealoc=m.kea, ddtkeoc=m.ddtke, ah2doc=m.ah2d,
            ah4doc=m.ah4d, pavgoc=m.pavg, qavgoc=m.qavg,
            osfmin=rec.osfmin, osfmax=rec.osfmax,
            occirc=rec.occirc, ddtpeoc=m.ddtpe, etamoc=m.etam,
            et2moc=m.et2m, ermaso=rec.ermaso, emfroc=rec.emfroc,
            pkenoc=m.pken, utauoc=m.utau, btdgoc=rec.btdgoc,
            occtot=rec.occtot, hfmloc=rec.hfmloc, wetmoc=m.wetm,
            watmoc=m.watm, wepmoc=m.wepm, wapmoc=m.wapm,
            entmoc=m.entm, enamoc=m.enam, tmlmoc=m.tmlm,
            sstmin=m.tmin, sstmax=m.tmax,
            cnqgoc=rec.cfl.cnqgoc, cnmloc=rec.cfl.cnmloc,
            cfraoc=rec.cfraoc, centoc=rec.centoc,
            ugminoc=rec.cfl.ugminoc_s, ugmaxoc=rec.cfl.ugmaxoc_s,
            vgminoc=rec.cfl.vgminoc_s, vgmaxoc=rec.cfl.vgmaxoc_s,
            umminoc=rec.cfl.umminoc, ummaxoc=rec.cfl.ummaxoc,
            vmminoc=rec.cfl.vmminoc, vmmaxoc=rec.cfl.vmmaxoc,
            ocjpos=m.jetpos, ocjval=m.jetval,
            **rec.bflux)
    m = rec.at
    if m is not None:
        vals.update(
            kealat=m.kea, ddtkeat=m.ddtke, ah4dat=m.ah4d,
            pavgat=m.pavg, qavgat=m.qavg, ddtpeat=m.ddtpe,
            etamat=m.etam, et2mat=m.et2m, ermasa=rec.ermasa,
            emfrat=rec.emfrat, pkenat=m.pken, utauat=m.utau,
            hcmlat=rec.hcmlat, tmaooc=rec.tmaooc,
            olrtop=rec.olrtop, wetmat=m.wetm, watmat=m.watm,
            wepmat=m.wepm, wapmat=m.wapm, entmat=m.entm,
            enamat=m.enam, tmlmat=m.tmlm,
            hmlmat=rec.hmlmat, astmin=m.tmin, astmax=m.tmax,
            cnqgat=rec.cfl.cnqgat, cnmlat=rec.cfl.cnmlat,
            cfraat=rec.cfraat, centat=rec.centat,
            slhfav=rec.slhfav, oradav=rec.oradav,
            arocav=rec.arocav, arlaav=rec.arlaav,
            ugminat=rec.cfl.ugminat_s, ugmaxat=rec.cfl.ugmaxat_s,
            vgminat=rec.cfl.vgminat_s, vgmaxat=rec.cfl.vgmaxat_s,
            umminat=rec.cfl.umminat, ummaxat=rec.cfl.ummaxat,
            vmminatat=rec.cfl.vmminat, vmmaxat=rec.cfl.vmmaxat,
            atstpos=m.jetpos, atstval=m.jetval)
    return vals


def monitor_to_host(rec: MonitorRecord) -> dict:
    """{name: NumPy float64 array} of a record, copied from the device
    in ONE transfer (the values are concatenated on the device first)."""
    vals = monitor_values(rec)
    flat = [torch.as_tensor(v).reshape(-1).to(torch.float64)
            for v in vals.values()]
    allv = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for (name, v), f in zip(vals.items(), flat):
        n = f.numel()
        out[name] = allv[i:i + n].reshape(tuple(v.shape))
        i += n
    return out


class MonitorWriter:
    def __init__(self, path: str, model):
        from ..io.ncdf import make_writer as NcWriter
        cfg = model.cfg
        self.model = model
        self.rec = 0
        w = NcWriter(path)
        w.dim("time", None)
        w.var("time", "f", ("time",), units="years")
        has_oc = not cfg.atmos_only
        has_at = not cfg.ocean_only

        def middepths(h):
            """Mid-layer depths, km (monnc_init, monitor_diag.F:2966)."""
            z = np.cumsum(h) - 0.5 * np.asarray(h)
            return 1e-3 * z

        if has_oc:
            w.dim("zo", cfg.nlo); w.dim("zio", cfg.nlo - 1)
            w.var("zo", "f", ("zo",), units="km",
                  data=middepths(cfg.ocean.hoc))
            w.var("zom", "f", ("zio",), units="km",
                  data=1e-3 * np.cumsum(cfg.ocean.hoc[:-1]))
            for n in _OC_VECNL:
                w.var(n, "f", ("time", "zo"))
            w.var("ocjpos", "i", ("time", "zo"), units="gridsquare")
            for n in _OC_VECNI:
                w.var(n, "f", ("time", "zio"))
            for n in _OC_SCAL:
                w.var(n, "f", ("time",))
        if has_at:
            w.dim("za", cfg.nla); w.dim("zia", cfg.nla - 1)
            w.var("za", "f", ("za",), units="km",
                  data=middepths(cfg.atmos.hat))
            w.var("zam", "f", ("zia",), units="km",
                  data=1e-3 * np.cumsum(cfg.atmos.hat[:-1]))
            for n in _AT_VECNL:
                w.var(n, "f", ("time", "za"))
            w.var("atstpos", "i", ("time", "za"), units="gridsquare")
            for n in _AT_VECNI:
                w.var(n, "f", ("time", "zia"))
            for n in _AT_SCAL:
                w.var(n, "f", ("time",))
        self.w = w

    def append(self, rec: MonitorRecord, tyrs: float):
        w, r = self.w, self.rec
        w.append("time", r, tyrs)
        for n, v in monitor_to_host(rec).items():
            if n in ("ocjpos", "atstpos"):
                v = v.astype(np.int64)
            w.append(n, r, v)
        self.rec += 1

    def close(self):
        self.w.close()
