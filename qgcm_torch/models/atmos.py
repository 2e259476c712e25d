"""Atmospheric component: mixed layer, QG vorticity step, PV inversion
(port of qgcm_tpu/models/atmos.py).

Replaces reference src/amlsubs.F (aml/amladf), src/qgasubs.F
(qgastep/atadif) and src/atisubs.F (atinvq) with one functional step on
tensors. The atmosphere is always a zonally-cyclic channel. Its
vorticity step is a plain chain of tensor operators: qgcm_tpu has no
fused kernel for it either.

Differences from the ocean component (models/ocean.py):
  * the mixed layer has a prognostic THICKNESS hmixa as well as a
    temperature, with a diabatic relaxation and min-thickness fixer
    (amlsubs.F:118-137);
  * advection uses the Ekman velocity components uekat/vekat that xforc
    computes, besides the geostrophic flow (amlsubs.F:246-531);
  * layer 1 is the BOTTOM layer: topography and entrainment act there,
    there is no bottom drag and no Del-sqd dissipation (qgasubs.F);
  * entrainment and windstress enter the momentum constraints with the
    opposite signs (atisubs.F:160-180 vs ocisubs.F:174-193).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ml_f64_enabled
from ..model import Model
from ..ops.integrals import line_sum, xintp
from ..ops.stencils import (del2_bc, jacobian9, _eshift, _pad_y, _row_mask,
                            _wshift)
from ..ops.vorticity import atqzbd, qcomp
from ..radiation import fsprim
from ..state import AtmosForcing, AtmosState
from .ocean import (_as_field, _channel_pressure, _continuity, _entrain_to_p,
                    _interface_jump, _lap_padded, _pad_t_grid, _wrap_x,
                    momentum_constraints)


class AtmosStepDiags(NamedTuple):
    ermasa: torch.Tensor  # (nla-1,) continuity constraint error
    emfrat: torch.Tensor  # (nla-1,) fractional error
    xan1: torch.Tensor    # area integral of interface-1 entrainment
    cfraat: torch.Tensor  # fraction of convecting a.m.l. points
    centat: torch.Tensor  # integrated convective entrainment


# ----------------------------------------------------------------------
# Mixed layer (src/amlsubs.F)
# ----------------------------------------------------------------------

def _amladf(model: Model, ast, astm, hmixa, hmixam, pa1,
            forcing: AtmosForcing):
    """Advective + diffusive RHS of the AST and hmixa equations
    (amladf, src/amlsubs.F:246-560). C-grid advection by geostrophic
    + Ekman flow; AST has Del-sqd and Del-4th diffusion with no-flux
    zonal boundaries; hmixa has Del-sqd diffusion with hmixa = hmat
    outside the zonal boundaries."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    hdxam1 = 0.5 / g.dxa
    d2tfac = cfg.mixed.at2d / g.dxa**2
    d4tfac = cfg.mixed.at4d / g.dxa**4
    hmdfac = cfg.mixed.ahmd / g.dxa**2
    hmat = cfg.mixed.hmat

    # u at T-cell W/E faces (nyta, nxpa): faces line up with p columns.
    # Same formula on all rows incl. zonal boundaries (amlsubs.F:391).
    uface = -rdxaf0 * (pa1[1:, :] - pa1[:-1, :]) + forcing.uekat

    def tsum_x(f):
        wrap = f[:, :1] + f[:, -1:]
        return torch.cat([wrap, f[:, :-1] + f[:, 1:], wrap], dim=1)

    xflux_t = uface * tsum_x(ast)
    xflux_h = uface * tsum_x(hmixa)
    xadvt = hdxam1 * (xflux_t[:, 1:] - xflux_t[:, :-1])
    xadvh = hdxam1 * (xflux_h[:, 1:] - xflux_h[:, :-1])

    # v at T-cell S/N faces (nypa, nxta). On the zonal walls p is
    # constant along the row so the geostrophic part vanishes; the
    # reference uses the Ekman part only there (amlsubs.F:398,418).
    vgeo = rdxaf0 * (pa1[:, 1:] - pa1[:, :-1])
    walls = _row_mask(forcing.vekat, 0) | _row_mask(forcing.vekat, -1)
    vface = torch.where(walls, forcing.vekat, vgeo + forcing.vekat)

    # temperature: no normal heat flux through the walls
    zrow = torch.zeros_like(ast[:1])
    tyf = torch.cat([zrow, ast[:-1, :] + ast[1:, :], zrow])
    yflux_t = torch.where(walls, 0.0, vface * tyf)
    yadvt = hdxam1 * (yflux_t[1:, :] - yflux_t[:-1, :])

    # thickness: normal flux allowed, hmixa = hmat outside the walls
    hyf = torch.cat([hmat + hmixa[:1], hmixa[:-1, :] + hmixa[1:, :],
                     hmat + hmixa[-1:]])
    yflux_h = vface * hyf
    yadvh = hdxam1 * (yflux_h[1:, :] - yflux_h[:-1, :])

    # AST diffusion on the lagged field (cyclic x, no-flux y)
    del2t = _lap_padded(_pad_t_grid(astm, True))
    del4t = _lap_padded(_pad_t_grid(del2t, True))
    tmrhs = -(xadvt + yadvt) + d2tfac * del2t - d4tfac * del4t

    # hmixa diffusion: ghost rows hold hmat (amlsubs.F:406-409)
    hx = _wrap_x(hmixam, True)
    grow = torch.full_like(hx[:1], hmat)
    hmrhs = (-(xadvh + yadvh)
             + hmdfac * _lap_padded(torch.cat([grow, hx, grow])))
    return tmrhs, hmrhs


def _aml(model: Model, state: AtmosState, forcing: AtmosForcing):
    """Step the atmospheric mixed layer (aml, src/amlsubs.F:47-240).
    Returns (ast, astm, hmixa, hmixam, entat, xan1, enis1, enin1,
    cfraat, centat).

    On float32 models the AST/hmixa prediction and its clamps run in
    float64 by default and are stored in float32 (config.ml_f64): the
    min-thickness fixer and the diabatic-limit branches are non-smooth
    switches of the same class as the ocean's convection clamp, which
    can decouple the f32 leapfrog levels at a switching front and run
    away (see models/ocean._oml). The stencil RHS (_amladf), the
    entrainment and the reductions stay in the storage dtype."""
    cfg = model.cfg
    g = model.grids
    sdt = state.ast.dtype
    tat = [float(t) for t in model.rad.tat]
    tdta = 2.0 * cfg.dta
    hmat = cfg.mixed.hmat
    hmainv = 1.0 / hmat
    rrcpat = 1.0 / (cfg.rhoat * cfg.cpat)
    hdrcdt = cfg.mixed.hmadmp * rrcpat * tdta
    diabcr = tat[0] - 2.0 * hdrcdt
    entfac = 1.0 / (tdta * (tat[1] - tat[0]))
    xbfac = cfg.xcexp * model.rad.bface
    cface = model.rad.cface
    dface = model.rad.dface

    tmrhs, hmrhs = _amladf(model, state.ast, state.astm, state.hmixa,
                           state.hmixam, state.pa[0], forcing)

    ct = (torch.float64 if ml_f64_enabled(cfg) and sdt == torch.float32
          else sdt)
    astm, hmixam = state.astm.to(ct), state.hmixam.to(ct)

    # hmixa prediction (7.16) with min-thickness fixer, in `ct`
    diab = astm <= diabcr
    denom = torch.where(diab, tat[0] - astm, 1.0)
    dhdiab = hdrcdt * (hmixam - hmat) / denom
    hnew0 = hmixam + tdta * hmrhs.to(ct) - dhdiab
    dhfix = torch.clamp(cfg.mixed.hmamin - hnew0, min=0.0)
    hnew = torch.where(diab, hnew0 + dhfix, hmat).to(sdt)
    dtfix = torch.where(diab, dhfix * (tat[0] - astm) / hmixam, 0.0)

    # AST prediction (7.17), in `ct`
    trhtot = (tmrhs.to(ct)
              + rrcpat * forcing.fnetat.to(ct) / hmixam
              - hmainv * forcing.wekta.to(ct) * astm)
    astnew = astm + tdta * trhtot + dtfix
    dtanew = tat[0] - astnew
    astnew = (astnew + torch.clamp(dtanew, max=0.0)).to(sdt)
    dtanew = dtanew.to(sdt)
    astm, hmixam = state.astm, state.hmixam

    # Entrainment across interface 1 at T points (7.18), then the
    # convective correction (7.19), in the storage dtype
    xfaent = (xbfac * (hmixam - hmat)
              + dface * (cfg.xcexp * astm + model.xc1ast))
    conena = entfac * state.hmixa * torch.clamp(dtanew, max=0.0)
    xfa = xfaent - cfg.xcexp * conena

    cfraat = (dtanew < 0.0).to(sdt).mean()
    centat = -conena.sum() * g.dxa * g.dya

    # Average onto p points; add the eta and topography terms there
    entat = _entrain_to_p(xfa, True)
    delpm = state.pam[:-1] - state.pam[1:]          # (nla-1, nypa, nxpa)
    entat = entat + torch.einsum("l,lyx->yx", model.afacdp, delpm)
    entat = entat + cface * model.dtopat

    xan1 = xintp(entat) * g.dxa * g.dya
    enis1 = g.dxa * line_sum(entat[0, :])
    enin1 = g.dxa * line_sum(entat[-1, :])
    return (astnew, state.ast, hnew, state.hmixa, entat, xan1,
            enis1, enin1, cfraat, centat)


# ----------------------------------------------------------------------
# QG vorticity step (src/qgasubs.F)
# ----------------------------------------------------------------------

def _qgastep(model: Model, state: AtmosState, forcing: AtmosForcing,
             entat: torch.Tensor):
    """Leapfrog step of the atmospheric PV equation (7.14): channel
    geometry, Del-4th dissipation only, no bottom drag. Returns
    (qa_new, qam_new, the momentum-constraint boundary integrals)."""
    cfg = model.cfg
    g = model.grids
    dxam2 = 1.0 / g.dxa**2
    adfaca = 1.0 / (12.0 * g.dxa * g.dya * cfg.fnot)
    zbfaca = cfg.atmos.bccoat * dxam2 / (0.5 * cfg.atmos.bccoat + 1.0)
    ah4 = model.ah4at
    tdta = 2.0 * cfg.dta

    pa, pam, qa, qam = state.pa, state.pam, state.qa, state.qam

    del2p = del2_bc(pam, zbfaca, dxam2, True)
    d4p = del2_bc(del2p, zbfaca, dxam2, True)
    zonal = _row_mask(pa, 0) | _row_mask(pa, -1)
    d4pp = _pad_y(d4p)
    d6p = dxam2 * (d4pp[:, :-2, :] + d4pp[:, 2:, :] + _wshift(d4p)
                   + _eshift(d4p) - 4.0 * d4p)
    d6full = torch.where(zonal, 0.0, d6p)

    qdot = (adfaca * jacobian9(qa, pa, True)
            - (ah4[:, None, None] / cfg.fnot) * d6full)
    qdot[0] += (cfg.fnot / cfg.atmos.hat[0]) * (entat - forcing.wekpa)
    qdot[1] -= (cfg.fnot / cfg.atmos.hat[1]) * entat

    qa_new = torch.where(zonal, qa, qam + tdta * qdot)

    # Boundary constraint integrals (atadif, qgasubs.F:186-218,294-318)
    pdx = _eshift(pa) - _wshift(pa)
    pdx_s, pdx_n = pdx[:, 1, :], pdx[:, -2, :]
    aj5s = line_sum(qa[:, 0, :] * pdx_s)
    aj9s = line_sum(qa[:, 1, :] * pdx_s)
    aj5n = -line_sum(qa[:, -1, :] * pdx_n)
    aj9n = -line_sum(qa[:, -2, :] * pdx_n)
    ajfac = cfg.fnot * adfaca * g.dxa * g.dya
    cyc = dict(ajis=ajfac * (aj5s + 2.0 * aj9s),
               ajin=ajfac * (aj5n + 2.0 * aj9n),
               ap5s=ah4 * (d4p[:, 1, :-1] - d4p[:, 0, :-1]).sum(-1),
               ap5n=ah4 * (d4p[:, -1, :-1] - d4p[:, -2, :-1]).sum(-1))
    return qa_new, qa, cyc


# ----------------------------------------------------------------------
# PV inversion (src/atisubs.F atinvq)
# ----------------------------------------------------------------------

def _atinvq(model: Model, state: AtmosState, qa_new: torch.Tensor,
            xan1, enis1, enin1, cyc, forcing: AtmosForcing):
    """Invert PV to pressure under the channel's momentum and mass
    constraints: the cyclic ocean's inversion with the atmosphere's
    signs (atisubs.F:160-180), entrainment and windstress entering
    with the opposite sign because layer 1 is at the BOTTOM of the
    fluid. Returns (pa_new, pam_new, dpiat, dpiatp, atmcs, atmcn,
    atmcsp, atmcnp, ermasa, emfrat)."""
    cfg = model.cfg
    g = model.grids
    nla = cfg.nla
    tdta = 2.0 * cfg.dta

    ql = qa_new - (cfg.beta * model.yparel)[None, :, None]
    ql[0] -= model.ddyn_at
    wrk = cfg.fnot * torch.einsum("mk,kyx->myx", model.cl2m_at, ql)
    sol = model.inv_at.helm.solve(wrk)

    ent = (0.5 * g.dya * cfg.fnot**2) / model.hat
    rhss = -ent * _interface_jump(enis1, nla) + cyc["ajis"] + cyc["ap5s"]
    rhsn = -ent * _interface_jump(enin1, nla) + cyc["ajin"] - cyc["ap5n"]
    rhss[0] -= (cfg.fnot / model.hat[0]) * forcing.txisat
    rhsn[0] += (cfg.fnot / model.hat[0]) * forcing.txinat
    atsnew = state.atmcsp + tdta * rhss
    atnnew = state.atmcnp + tdta * rhsn

    pa_new, aiplay = _channel_pressure(model.inv_at, sol, model.cm2l_at,
                                       atsnew, atnnew, g.dxa, g.dya)
    est1 = aiplay[:-1] - aiplay[1:]
    ermasa, emfrat = _continuity(est1, state.dpiatp, model.gpat, xan1,
                                 tdta, g.xla * g.yla)
    return (pa_new, state.pa, est1, state.dpiat, atsnew, atnnew,
            state.atmcs, state.atmcn, ermasa, emfrat)


# ----------------------------------------------------------------------
# Full step + init helpers
# ----------------------------------------------------------------------

def make_atmos_step(model: Model):
    """Build the atmospheric step aml -> qgastep -> atinvq -> atqzbd
    (main loop q-gcm.F:1259-1268). Returns step(state, forcing) ->
    (state, AtmosStepDiags)."""
    cfg = model.cfg
    dxam2 = 1.0 / model.grids.dxa**2

    def step(state: AtmosState, forcing: AtmosForcing):
        (ast_new, astm_new, hmixa_new, hmixam_new, entat, xan1,
         enis1, enin1, cfraat, centat) = _aml(model, state, forcing)
        qa_new, qam_new, cyc = _qgastep(model, state, forcing, entat)
        (pa_new, pam_new, dpiat, dpiatp, atmcs, atmcn, atmcsp, atmcnp,
         ermasa, emfrat) = _atinvq(model, state, qa_new, xan1,
                                   enis1, enin1, cyc, forcing)
        qa_new = atqzbd(qa_new, pa_new, model.amat_at, model.yparel, dxam2,
                        cfg.fnot, cfg.beta, cfg.atmos.bccoat, model.ddyn_at)
        new_state = AtmosState(
            pa=pa_new, pam=pam_new, qa=qa_new, qam=qam_new,
            ast=ast_new, astm=astm_new,
            hmixa=hmixa_new, hmixam=hmixam_new,
            dpiat=dpiat, dpiatp=dpiatp,
            atmcs=atmcs, atmcn=atmcn, atmcsp=atmcsp, atmcnp=atmcnp)
        diags = AtmosStepDiags(ermasa=ermasa, emfrat=emfrat, xan1=xan1,
                               cfraat=cfraat, centat=centat)
        return new_state, diags

    return step


def init_atmos_state(model: Model, init: str = "rbal",
                     pa=None, pam=None, ast=None, astm=None,
                     hmixa=None, hmixam=None) -> AtmosState:
    """Initial atmospheric state: 'zero' (zeroin, q-gcm.F:1615), 'rbal'
    (rbalin, q-gcm.F:1712: pa from the radiative-balance eta coeffts
    plfac, ast = astbar, hmixa = hmat), or explicit arrays (NumPy or
    tensors)."""
    cfg = model.cfg
    g = model.grids
    dev, dtype = model.device, model.dtype
    nla, nypa, nxpa = cfg.nla, cfg.nypa, cfg.nxpa
    nyta, nxta = cfg.nyta, cfg.nxta

    if pa is None:
        pa = np.zeros((nla, nypa, nxpa))
        if init == "rbal":
            # plfac(1)=0; plfac(k) = plfac(k-1) - gpat(k-1)*rbetat(k-1)
            plfac = np.zeros(nla)
            for k in range(1, nla):
                plfac[k] = (plfac[k - 1]
                            - cfg.atmos.gpat[k - 1] * model.rad.rbetat[k - 1])
            prof = fsprim(cfg, model.rad.fspco, g.yparel)     # (nypa,)
            pa[:] = (plfac[:, None] * prof[None, :])[:, :, None]
    pa = _as_field(model, pa)
    pam = pa if pam is None else _as_field(model, pam)

    if ast is None:
        if init == "rbal":
            ast = _as_field(model, model.rad.astbar)[:, None].expand(
                nyta, nxta).contiguous()
        else:
            ast = torch.zeros((nyta, nxta), device=dev, dtype=dtype)
    else:
        ast = _as_field(model, ast)
    astm = ast if astm is None else _as_field(model, astm)
    hmixa = (torch.full((nyta, nxta), cfg.mixed.hmat, device=dev,
                        dtype=dtype)
             if hmixa is None else _as_field(model, hmixa))
    hmixam = hmixa if hmixam is None else _as_field(model, hmixam)

    dxam2 = 1.0 / g.dxa**2

    def q_from_p(p):
        q = qcomp(p, model.amat_at, model.yparel, dxam2, cfg.fnot, cfg.beta,
                  model.ddyn_at, 0, True)
        return atqzbd(q, p, model.amat_at, model.yparel, dxam2, cfg.fnot,
                      cfg.beta, cfg.atmos.bccoat, model.ddyn_at)

    # constr (conhoms.F:203-310)
    area = g.dxa * g.dya
    atmcs, atmcn = momentum_constraints(pa, model.amat_at, g.dxa, g.dya,
                                        cfg.fnot)
    atmcsp, atmcnp = momentum_constraints(pam, model.amat_at, g.dxa, g.dya,
                                          cfg.fnot)
    return AtmosState(pa=pa, pam=pam, qa=q_from_p(pa), qam=q_from_p(pam),
                      ast=ast, astm=astm, hmixa=hmixa, hmixam=hmixam,
                      dpiat=xintp(pa[:-1] - pa[1:]) * area,
                      dpiatp=xintp(pam[:-1] - pam[1:]) * area,
                      atmcs=atmcs, atmcn=atmcn,
                      atmcsp=atmcsp, atmcnp=atmcnp)
