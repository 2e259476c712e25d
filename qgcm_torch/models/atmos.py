"""Atmospheric component: mixed layer, QG vorticity step, PV inversion
(port of qgcm_tpu/models/atmos.py).

Replaces reference src/amlsubs.F (aml/amladf), src/qgasubs.F
(qgastep/atadif) and src/atisubs.F (atinvq) with one functional step on
tensors. The atmosphere is always a zonally-cyclic channel. Its
vorticity step is a plain chain of tensor operators: qgcm_tpu has no
fused kernel for it either.

In a run decomposed over a mesh (parallel/mesh.py) the atmosphere is
cut by rows over all the mesh's ranks (parallel/mesh.atmos_mesh), every
column whole: each step exchanges ghost rows, takes its grid sums by
all_reduce and solves its inversion by the pencil transposes of
parallel/spectral.py (make_atmos_step's mesh path). The single-device
step keeps its own mixed-layer and vorticity forms, as the ocean does.

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
import torch.nn.functional as F

from ..config import ml_f64_enabled
from ..model import Model
from ..ops.integrals import line_sum, xintp
from ..ops.qgstep import jacobian_rows, lap_bc_rows
from ..ops.stencils import (del2_bc, jacobian9, _eshift, _pad_y, _row_mask,
                            _wshift)
from ..ops.vorticity import atqzbd, atqzbd_block, qcomp
from ..parallel.halo import _with_halo
from ..radiation import fsprim
from ..state import AtmosForcing, AtmosState
from .ocean import (_Rows, _as_field, _channel_pressure, _continuity,
                    _edge_d2d4, _entrain_to_p, _ghost_rows, _interface_jump,
                    _lap_padded, _pad_t_grid, _wrap_x, boundary_ghosts,
                    momentum_constraints)

# collective call sites of the atmosphere on row blocks (Mesh.counts);
# the inversion's sums and the wall strips are models/ocean.py's
# ATM_INV_SUMS and ATM_WALLS (_Rows)
AML_ROWS = "atmos.aml.rows"
AML_SUMS = "atmos.aml.sums"
ROWS = "atmos.rows"
BDY_ROWS = "atmos.atqzbd.rows"


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


def _amladf_rows(model: Model, rows: _Rows, ext):
    """_amladf on a row block: `ext` is the stack of astm, ast, hmixa,
    hmixam, pa[0], uekat and vekat on rows r0-2 .. r0+n+1 (two exchanged
    ghost rows each side; the fields nxta wide padded by a column to
    nxpa). The walls' rows and the ghost rows beyond them are taken by
    global row. Returns (tmrhs, hmrhs) on the block's T rows."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    hdxam1 = 0.5 / g.dxa
    d2tfac = cfg.mixed.at2d / g.dxa**2
    d4tfac = cfg.mixed.at4d / g.dxa**4
    hmdfac = cfg.mixed.ahmd / g.dxa**2
    hmat = cfg.mixed.hmat
    nt = rows.nxt
    astm, ast, hmixa, hmixam = (f[:, :nt] for f in ext[:4])
    pa1, uekat, vekat = ext[4], ext[5], ext[6, :, :nt]
    own = slice(2, -2)

    def tsum_x(f):
        wrap = f[:, :1] + f[:, -1:]
        return torch.cat([wrap, f[:, :-1] + f[:, 1:], wrap], dim=1)

    # W/E faces of the block's T rows, from the p rows r0 .. r0+n
    pr = pa1[2:-1]
    uface = -rdxaf0 * (pr[1:, :] - pr[:-1, :]) + uekat[own]
    xflux_t = uface * tsum_x(ast[own])
    xflux_h = uface * tsum_x(hmixa[own])
    xadvt = hdxam1 * (xflux_t[:, 1:] - xflux_t[:, :-1])
    xadvh = hdxam1 * (xflux_h[:, 1:] - xflux_h[:, :-1])

    # S/N faces on the p rows r0 .. r0+n, between the T rows below and
    # above each
    gp = rows.r0 + torch.arange(pr.shape[0], device=pr.device)[:, None]
    walls = (gp == 0) | (gp == rows.nyp - 1)
    vgeo = rdxaf0 * (pr[:, 1:] - pr[:, :-1])
    vface = torch.where(walls, vekat[2:-1], vgeo + vekat[2:-1])
    yflux_t = torch.where(walls, 0.0, vface * (ast[1:-2] + ast[2:-1]))
    yadvt = hdxam1 * (yflux_t[1:, :] - yflux_t[:-1, :])
    below, above = hmixa[1:-2], hmixa[2:-1]
    hyf = torch.where(gp == 0, hmat + above,
                      torch.where(gp == rows.nyp - 1, hmat + below,
                                  below + above))
    yflux_h = vface * hyf
    yadvh = hdxam1 * (yflux_h[1:, :] - yflux_h[:-1, :])

    # AST diffusion on the lagged field (cyclic x, no-flux y)
    del2t = _lap_padded(_wrap_x(_ghost_rows(rows, astm, 2), True))
    del4t = _lap_padded(_wrap_x(_ghost_rows(rows, del2t, 1), True))
    tmrhs = (-(xadvt + yadvt) + d2tfac * del2t[1:-1]
             - d4tfac * del4t)

    # hmixa diffusion: ghost rows hold hmat beyond the walls
    full = torch.full_like(hmixam, hmat)
    hp = _wrap_x(_ghost_rows(rows, hmixam, 2, south=full, north=full), True)
    hmrhs = -(xadvh + yadvh) + hmdfac * _lap_padded(hp)[1:-1]
    return tmrhs, hmrhs


def _aml(model: Model, state: AtmosState, forcing: AtmosForcing):
    """Step the atmospheric mixed layer (aml, src/amlsubs.F:47-240).
    Returns (ast, astm, hmixa, hmixam, entat, xan1, enis1, enin1,
    cfraat, centat)."""
    cfg = model.cfg
    g = model.grids
    sdt = state.ast.dtype
    tmrhs, hmrhs = _amladf(model, state.ast, state.astm, state.hmixa,
                           state.hmixam, state.pa[0], forcing)
    astnew, hnew, dtanew, conena, xfa = _aml_point(model, state, forcing,
                                                   tmrhs, hmrhs)
    cfraat = (dtanew < 0.0).to(sdt).mean()
    centat = -conena.sum() * g.dxa * g.dya

    # Average onto p points; add the eta and topography terms there
    entat = _entat(model, state, _entrain_to_p(xfa, True))
    xan1 = xintp(entat) * g.dxa * g.dya
    enis1 = g.dxa * line_sum(entat[0, :])
    enin1 = g.dxa * line_sum(entat[-1, :])
    return (astnew, state.ast, hnew, state.hmixa, entat, xan1,
            enis1, enin1, cfraat, centat)


def _entat(model: Model, state: AtmosState, entat):
    """The entrainment at p points plus its eta and topography terms."""
    delpm = state.pam[:-1] - state.pam[1:]          # (nla-1, ny, nxpa)
    entat = entat + torch.einsum("l,lyx->yx", model.afacdp, delpm)
    return entat + model.rad.cface * model.dtopat


def _aml_point(model: Model, state: AtmosState, forcing: AtmosForcing,
               tmrhs, hmrhs):
    """The pointwise part of aml from the stencil RHS (_amladf): the
    hmixa and AST predictions with their clamps, and the entrainment
    across interface 1 at T points. Returns (ast_new, hmixa_new,
    dtanew, conena, xfa).

    On float32 models the AST/hmixa prediction and its clamps run in
    float64 by default and are stored in float32 (config.ml_f64): the
    min-thickness fixer and the diabatic-limit branches are non-smooth
    switches of the same class as the ocean's convection clamp, which
    can decouple the f32 leapfrog levels at a switching front and run
    away (see models/ocean._oml). The stencil RHS (_amladf), the
    entrainment and the reductions stay in the storage dtype."""
    cfg = model.cfg
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
    dface = model.rad.dface

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
    return astnew, hnew, dtanew, conena, xfaent - cfg.xcexp * conena


def _aml_rows(model: Model, rows: _Rows, state: AtmosState,
              forcing: AtmosForcing):
    """_aml on this rank's row blocks; the sums go through one
    all_reduce. The padding rows of hmixam take hmat in the pointwise
    part, which divides by it, so that no padding point is infinite in
    a forward or backward pass; every output's padding is zero."""
    cfg = model.cfg
    g = model.grids
    mesh = rows.mesh
    t = rows.t_true

    def wide(f):
        return F.pad(f, (0, 1))

    stack = torch.stack([wide(state.astm), wide(state.ast),
                         wide(state.hmixa), wide(state.hmixam), state.pa[0],
                         forcing.uekat, wide(forcing.vekat)])
    ext = _with_halo(rows.mesh, stack, 2, AML_ROWS)
    tmrhs, hmrhs = _amladf_rows(model, rows, ext)
    safe = state._replace(hmixam=torch.where(t, state.hmixam,
                                             cfg.mixed.hmat))
    astnew, hnew, dtanew, conena, xfa = _aml_point(model, safe, forcing,
                                                   tmrhs, hmrhs)
    astnew = torch.where(t, astnew, 0.0)
    hnew = torch.where(t, hnew, 0.0)
    conena = torch.where(t, conena, 0.0)
    xfa = torch.where(t, xfa, 0.0)

    # _entrain_to_p on the block's p points from the T rows below and
    # above them (one ghost row; beyond the walls the walls' copies)
    xe = _with_halo(rows.mesh, xfa, 1, AML_ROWS)
    xp = _wrap_x(_ghost_rows(rows, xe, 1)[:-1], True)
    entat = 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])
    entat = torch.where(rows.p_true, _entat(model, state, entat), 0.0)

    parts = [(t & (dtanew < 0.0)).sum().to(xfa.dtype), conena.sum(),
             rows.xintp_share(entat)]
    for gr in (0, rows.nyp - 1):
        i = rows.local(gr)
        parts.append(g.dxa * line_sum(entat[i, :]) if i is not None
                     else entat.new_zeros(()))
    count, cen, xan1, enis1, enin1 = mesh.all_reduce(torch.stack(parts),
                                                     AML_SUMS)
    return (astnew, state.ast, hnew, state.hmixa, entat,
            xan1 * g.dxa * g.dya, enis1, enin1,
            count / (cfg.nyta * cfg.nxta), -cen * g.dxa * g.dya)


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
    cyc = _boundary_terms(model, pa, qa, d4p[:, :2], d4p[:, -2:])
    return qa_new, qa, cyc


def _boundary_terms(model: Model, pa, qa, d4_s, d4_n) -> dict:
    """The momentum-constraint boundary integrals (atadif,
    qgasubs.F:186-218,294-318) from pa and qa, whose rows 0, 1, -2, -1
    are the grid's, and the two rows of del4(pam) at each wall (d4_s:
    rows 0, 1; d4_n: rows -2, -1)."""
    cfg = model.cfg
    g = model.grids
    adfaca = 1.0 / (12.0 * g.dxa * g.dya * cfg.fnot)
    ah4 = model.ah4at
    pdx = _eshift(pa) - _wshift(pa)
    pdx_s, pdx_n = pdx[:, 1, :], pdx[:, -2, :]
    aj5s = line_sum(qa[:, 0, :] * pdx_s)
    aj9s = line_sum(qa[:, 1, :] * pdx_s)
    aj5n = -line_sum(qa[:, -1, :] * pdx_n)
    aj9n = -line_sum(qa[:, -2, :] * pdx_n)
    ajfac = cfg.fnot * adfaca * g.dxa * g.dya
    return dict(ajis=ajfac * (aj5s + 2.0 * aj9s),
                ajin=ajfac * (aj5n + 2.0 * aj9n),
                ap5s=ah4 * (d4_s[:, 1, :-1] - d4_s[:, 0, :-1]).sum(-1),
                ap5n=ah4 * (d4_n[:, 1, :-1] - d4_n[:, 0, :-1]).sum(-1))


def _qgastep_rows(model: Model, rows: _Rows, state: AtmosState,
                  forcing: AtmosForcing, entat: torch.Tensor):
    """_qgastep on a row block: one exchange of 3 ghost rows of pam, pa
    and qa feeds the del2 -> del4 -> del6 chain (lap_bc_rows, the walls
    by global row) and the Jacobian (one ghost row); the columns wrap
    locally. The constraint integrals come from the wall strips, which
    every rank gets whole (rows.wall_strips), so they are the same bits
    on every rank. Padding rows come out zero."""
    cfg = model.cfg
    g = model.grids
    nla = cfg.nla
    dxam2 = 1.0 / g.dxa**2
    adfaca = 1.0 / (12.0 * g.dxa * g.dya * cfg.fnot)
    zbfaca = cfg.atmos.bccoat * dxam2 / (0.5 * cfg.atmos.bccoat + 1.0)
    ah4 = model.ah4at
    tdta = 2.0 * cfg.dta
    pa, pam, qa, qam = state.pa, state.pam, state.qa, state.qam
    r0, nyp = rows.r0, rows.nyp

    ext = _with_halo(rows.mesh, torch.cat([pam, pa, qa]), 3, ROWS)
    pam_e, pa_e, qa_e = ext.split(nla)
    d2p = lap_bc_rows(pam_e, r0 - 3, nyp, zbfaca, dxam2, True)
    d4p = lap_bc_rows(d2p, r0 - 2, nyp, zbfaca, dxam2, True)
    c = d4p[:, 1:-1]
    d6p = dxam2 * (d4p[:, :-2] + d4p[:, 2:] + _wshift(c) + _eshift(c)
                   - 4.0 * c)
    zonal = (rows.gy == 0) | (rows.gy == nyp - 1)
    d6full = torch.where(zonal, 0.0, d6p)
    jac = jacobian_rows(qa_e[:, 2:-2], pa_e[:, 2:-2], r0 - 1, nyp, True)

    qdot = adfaca * jac - (ah4[:, None, None] / cfg.fnot) * d6full
    qdot[0] += (cfg.fnot / cfg.atmos.hat[0]) * (entat - forcing.wekpa)
    qdot[1] -= (cfg.fnot / cfg.atmos.hat[1]) * entat
    qa_new = torch.where(zonal, qa, qam + tdta * qdot)
    qa_new = torch.where(rows.p_true, qa_new, 0.0)

    pam_s, pa_s, qa_s = rows.wall_strips([pam, pa, qa])
    _, _, d4_s, d4_n = _edge_d2d4(pam_s, zbfaca, dxam2)
    return qa_new, qa, _boundary_terms(model, pa_s, qa_s, d4_s, d4_n)


# ----------------------------------------------------------------------
# PV inversion (src/atisubs.F atinvq)
# ----------------------------------------------------------------------

def _atinvq(model: Model, state: AtmosState, qa_new: torch.Tensor,
            xan1, enis1, enin1, cyc, forcing: AtmosForcing, rows=None):
    """Invert PV to pressure under the channel's momentum and mass
    constraints: the cyclic ocean's inversion with the atmosphere's
    signs (atisubs.F:160-180), entrainment and windstress entering
    with the opposite sign because layer 1 is at the BOTTOM of the
    fluid. Returns (pa_new, pam_new, dpiat, dpiatp, atmcs, atmcn,
    atmcsp, atmcnp, ermasa, emfrat).

    On a row block (`rows`, a _Rows of the atmosphere; model.inv_at.helm
    a sharded solver and model's y profiles the block's) the area and
    line integrals of the modal solutions are the blocks' shares summed
    over the ranks; the constraint algebra is the same on every rank."""
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

    pa_new, aiplay = _channel_pressure(
        model.inv_at, sol, model.cm2l_at, atsnew, atnnew, g.dxa, g.dya,
        sums=None if rows is None else rows.channel_sums(sol, g.dxa, g.dya),
        rows=None if rows is None else rows.profile)
    est1 = aiplay[:-1] - aiplay[1:]
    ermasa, emfrat = _continuity(est1, state.dpiatp, model.gpat, xan1,
                                 tdta, g.xla * g.yla)
    return (pa_new, state.pa, est1, state.dpiat, atsnew, atnnew,
            state.atmcs, state.atmcn, ermasa, emfrat)


# ----------------------------------------------------------------------
# Full step + init helpers
# ----------------------------------------------------------------------

def make_atmos_step(model: Model, mesh=None):
    """Build the atmospheric step aml -> qgastep -> atinvq -> atqzbd
    (main loop q-gcm.F:1259-1268). Returns step(state, forcing) ->
    (state, AtmosStepDiags).

    With `mesh` (a mesh of a decomposed run, the ocean's, of any shape)
    the step takes and returns this rank's row blocks of the atmosphere
    on parallel/mesh.atmos_mesh(mesh, cfg), state and forcing alike
    (mesh.shard_tree on that mesh): the ghost rows are exchanged, the
    sums all_reduced and the inversion solved by pencil transposes; the
    diagnostics and the constraint vectors come out the same bits on
    every rank."""
    cfg = model.cfg
    dxam2 = 1.0 / model.grids.dxa**2
    if mesh is not None:
        return _make_rows_step(model, mesh)

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


def block_model(model: Model, mesh) -> Model:
    """The model as a rank of a run decomposed over `mesh` sees its
    atmosphere: both inversions on blocks (parallel/spectral.
    wrap_inversions; the atmosphere's on atmos_mesh(mesh, cfg)) and the
    atmosphere's y profiles and fields (yparel, xc1ast, ddyn_at, dtopat)
    cut to the rank's rows."""
    import dataclasses
    from ..parallel.mesh import atmos_mesh, shard
    from ..parallel.spectral import wrap_inversions
    amesh = atmos_mesh(mesh, model.cfg)
    rows = _Rows(amesh, model.cfg, model.device, atmos=True)

    def field(f):
        return f if f.dim() == 0 else shard(f, amesh)

    return dataclasses.replace(
        wrap_inversions(model, mesh), yparel=rows.profile(model.yparel),
        xc1ast=rows.profile(model.xc1ast[:, 0])[:, None],
        ddyn_at=field(model.ddyn_at), dtopat=field(model.dtopat))


def check_atmos_mesh(cfg, amesh):
    """Refuse an atmosphere's rows mesh whose blocks are thinner than the
    vorticity step's 3 ghost rows, or that leaves a rank no row."""
    if amesh.by < 3:
        raise ValueError(f"atmosphere row blocks of {amesh.by} rows are too "
                         "thin for the vorticity step's 3 ghost rows: use "
                         "fewer ranks")
    if (amesh.size - 1) * amesh.by >= cfg.nypa:
        raise ValueError(f"{amesh.size} ranks leave the last one no row of "
                         f"the atmosphere's {cfg.nypa}: use fewer ranks")


def _make_rows_step(model: Model, mesh):
    """make_atmos_step's step on this rank's row blocks."""
    from ..parallel.mesh import atmos_mesh
    cfg = model.cfg
    amesh = atmos_mesh(mesh, cfg)
    check_atmos_mesh(cfg, amesh)
    bm = block_model(model, mesh)
    rows = _Rows(amesh, cfg, model.device, atmos=True)
    dxam2 = 1.0 / model.grids.dxa**2
    # atqzbd needs the row inside the north wall from the block below
    # only when the wall row starts a block
    bdy_rows = (rows.nyp - 1) % amesh.by == 0

    def step(state: AtmosState, forcing: AtmosForcing):
        (ast_new, astm_new, hmixa_new, hmixam_new, entat, xan1,
         enis1, enin1, cfraat, centat) = _aml_rows(bm, rows, state, forcing)
        qa_new, qam_new, cyc = _qgastep_rows(bm, rows, state, forcing,
                                             entat)
        (pa_new, pam_new, dpiat, dpiatp, atmcs, atmcn, atmcsp, atmcnp,
         ermasa, emfrat) = _atinvq(bm, state, qa_new, xan1, enis1, enin1,
                                   cyc, forcing, rows=rows)
        ghosts = {}
        if bdy_rows:
            pa_new, south, north = boundary_ghosts(amesh, pa_new, "y",
                                                   BDY_ROWS)
            ghosts.update(south=south[:, 0], north=north[:, 0])
        qa_new = atqzbd_block(qa_new, pa_new, bm.amat_at, bm.yparel, dxam2,
                              cfg.fnot, cfg.beta, cfg.atmos.bccoat,
                              bm.ddyn_at, rows.r0, rows.nyp, **ghosts)
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
