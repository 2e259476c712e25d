"""Oceanic component: mixed layer, QG vorticity step, PV inversion, in
the box and in the zonally-cyclic channel (port of
qgcm_tpu/models/ocean.py).

Replaces reference src/omlsubs.F (oml/omladf), src/qgosubs.F (qgostep)
and src/ocisubs.F (ocinvq) with one functional substep on tensors. The
vorticity step goes through ops.qgstep: the hand-written CUDA kernel on
the card, its plain PyTorch version on the CPU. In the channel the
momentum-constraint integrals the kernel does not return come from thin
wall slices (_edge_d2d4), as in qgcm_tpu's fused-kernel path, and every
p-grid field keeps its east column equal to its west one. Equation
references are to the Q-GCM v1.5.0 users' guide numbering (7.x).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig, ml_f64_enabled
from ..grids import Grids
from ..model import Model
from ..ops.integrals import edge_weights, line_sum, xintp, xintp_block
from ..ops.qgstep import qgstep
from ..ops.stencils import del2_bc, _col_mask, _eshift, _wshift
from ..ops.vorticity import qcomp, ocqbdy, ocqbdy_block
from ..state import OceanState, OceanForcing

# threshold of the continuity monitors emfroc/emfrat (ocisubs.F:281,
# atisubs.F:248)
ECRIT = 1.0e-13


class OceanStepDiags(NamedTuple):
    """Per-step cheap diagnostics (monitoring subset)."""
    ermaso: torch.Tensor  # (nlo-1,) continuity constraint error (cyclic)
    emfroc: torch.Tensor  # (nlo-1,) fractional error
    xon1: torch.Tensor    # scalar: area integral of layer-1/2 entrainment
    cfraoc: torch.Tensor  # scalar: fraction of convecting o.m.l. points
    centoc: torch.Tensor  # scalar: integrated convective entrainment


def _first(x: torch.Tensor, n: int) -> torch.Tensor:
    """The (n,) vector (x, 0, ..., 0) of a 0-d tensor x."""
    return F.pad(x.reshape(1), (0, n - 1))


def _interface_jump(e: torch.Tensor, nl: int) -> torch.Tensor:
    """(e, -e, 0, ...): the per-layer difference of an entrainment that
    acts across interface 1 only (ocisubs.F:176-193)."""
    return F.pad(torch.stack([e, -e]), (0, nl - 2))


def _wrap_x(f: torch.Tensor, cyclic: bool) -> torch.Tensor:
    """One ghost column on each side of a T-grid field: the wraparound
    in the channel, edge-replicated (no normal flux) in the box."""
    if cyclic:
        return torch.cat([f[:, -1:], f, f[:, :1]], dim=1)
    return torch.cat([f[:, :1], f, f[:, -1:]], dim=1)


def _pad_t_grid(f: torch.Tensor, cyclic: bool, south=None,
                north=None) -> torch.Tensor:
    """Pad a T-grid field by one ghost cell on each side: _wrap_x in x,
    edge-replicate in y unless a constant boundary value is given
    (sb_hflux/nb_hflux)."""
    f = _wrap_x(f, cyclic)
    srow = f[:1] if south is None else torch.full_like(f[:1], south)
    nrow = f[-1:] if north is None else torch.full_like(f[-1:], north)
    return torch.cat([srow, f, nrow], dim=0)


def _lap_padded(fp: torch.Tensor) -> torch.Tensor:
    """Unscaled 5-point stencil sum of a ghost-padded field."""
    return (fp[:-2, 1:-1] + fp[2:, 1:-1] + fp[1:-1, :-2] + fp[1:-1, 2:]
            - 4.0 * fp[1:-1, 1:-1])


# ----------------------------------------------------------------------
# Mixed layer (src/omlsubs.F)
# ----------------------------------------------------------------------

def _hxadv(model: Model, sst, po1, tauyo):
    """The x part of omladf's advection, hdxom1 * d(u T)/dx, on the T rows
    of `sst` from the p rows that bound them (po1, tauyo: one row more)."""
    cfg = model.cfg
    g = model.grids
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    # u at T-cell W/E faces: faces line up with p columns. (nyto, nxpo)
    uface = (-uvgfac * (po1[1:, :] - po1[:-1, :])
             + rhf0hm * (tauyo[1:, :] + tauyo[:-1, :]))
    # T at W/E faces (sum of adjacent cells; the 1/2 is in hdxom1); no
    # flux through the box walls
    if cfg.cyclic_ocean:
        twrap = sst[:, :1] + sst[:, -1:]
        xflux = uface * torch.cat([twrap, sst[:, :-1] + sst[:, 1:], twrap],
                                  dim=1)
    else:
        zcol = torch.zeros_like(sst[:, :1])
        tface = torch.cat([zcol, sst[:, :-1] + sst[:, 1:], zcol], dim=1)
        wecols = _col_mask(uface, 0) | _col_mask(uface, -1)
        xflux = torch.where(wecols, 0.0, uface * tface)
    return (0.5 / g.dxo) * (xflux[:, 1:] - xflux[:, :-1])


def _vface(model: Model, po1, tauxo):
    """v at T-cell S/N faces, which line up with p rows: (rows of po1,
    nxto)."""
    cfg = model.cfg
    uvgfac = cfg.ycexp / (model.grids.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    return (uvgfac * (po1[:, 1:] - po1[:, :-1])
            - rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1]))


def _omladf(model: Model, sst, sstm, po1, tauxo, tauyo):
    """Advective + diffusive RHS of the SST equation (omladf,
    src/omlsubs.F:244-763): 2nd-order C-grid advection of sst by
    geostrophic + Ekman velocities, del2 and del4 diffusion of sstm."""
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    d4tfac = cfg.mixed.st4d / g.dxo**4
    tsbdy, tnbdy = model.rad.tsbdy, model.rad.tnbdy

    hxadv = _hxadv(model, sst, po1, tauyo)
    vface = _vface(model, po1, tauxo)
    zrow = torch.zeros_like(sst[:1])
    tyface = torch.cat([zrow, sst[:-1, :] + sst[1:, :], zrow], dim=0)
    yflux = vface * tyface
    if cfg.sb_hflux:
        vs = -rhf0hm * (tauxo[0, 1:] + tauxo[0, :-1])
        yflux[0] = vs * (sst[0, :] + tsbdy)
    else:
        yflux[0] = 0.0
    if cfg.nb_hflux:
        vn = -rhf0hm * (tauxo[-1, 1:] + tauxo[-1, :-1])
        yflux[-1] = vn * (sst[-1, :] + tnbdy)
    else:
        yflux[-1] = 0.0
    hyadv = hdxom1 * (yflux[1:, :] - yflux[:-1, :])

    rhs = -(hxadv + hyadv)

    # del2 of lagged SST with no-flux (or specified-T) boundaries
    sstm_p = _pad_t_grid(sstm, cyclic,
                         south=tsbdy if cfg.sb_hflux else None,
                         north=tnbdy if cfg.nb_hflux else None)
    del2t = _lap_padded(sstm_p)
    # del4: second application, always no-flux in y (omlsubs.F:748-758)
    del4t = _lap_padded(_pad_t_grid(del2t, cyclic))
    return rhs + d2tfac * del2t - d4tfac * del4t


def _entrain_to_p(xfo: torch.Tensor, cyclic: bool) -> torch.Tensor:
    """Average T-grid entrainment onto p points, conserving the area
    integral (omlsubs.F:158-206): wraparound (channel) or
    edge-replicate (box) ghosts make the reference's half and quarter
    wall and corner weights fall out of one 4-point average. In the
    channel the east column repeats the west one bit for bit."""
    xp = _wrap_x(xfo, cyclic)
    xp = torch.cat([xp[:1], xp, xp[-1:]], dim=0)
    return 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])


def boundary_flux_diags(model: Model, state: OceanState,
                        forcing: OceanForcing) -> dict:
    """Mean advective/diffusive SST fluxes through the modified
    sb_hflux / nb_hflux boundaries and the mean Ekman outflow velocity
    (monitoring section of omladf, src/omlsubs.F:684-727; +ve into the
    domain). Zeros when the modified conditions are inactive."""
    cfg = model.cfg
    g = model.grids
    z = state.sst.new_zeros(())
    ttmads = vfmads = ttmdfs = ttmadn = vfmadn = ttmdfn = z
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    nxto = cfg.nxto
    if cfg.sb_hflux:
        tsbdy = model.rad.tsbdy
        vm = -rhf0hm * (forcing.tauxo[0, 1:] + forcing.tauxo[0, :-1])
        tm = state.sst[0, :] + tsbdy
        ttmads = hdxom1 * (vm * tm).sum() / nxto
        vfmads = vm.sum() / nxto
        ttmdfs = -d2tfac * (state.sstm[0, :] - tsbdy).sum() / nxto
    if cfg.nb_hflux:
        tnbdy = model.rad.tnbdy
        vp = -rhf0hm * (forcing.tauxo[-1, 1:] + forcing.tauxo[-1, :-1])
        tp = state.sst[-1, :] + tnbdy
        ttmadn = -hdxom1 * (vp * tp).sum() / nxto
        vfmadn = -vp.sum() / nxto
        ttmdfn = d2tfac * (tnbdy - state.sstm[-1, :]).sum() / nxto
    return dict(ttmads=ttmads, vfmads=vfmads, ttmdfs=ttmdfs,
                ttmadn=ttmadn, vfmadn=vfmadn, ttmdfn=ttmdfn)


def _oml(model: Model, state: OceanState, forcing: OceanForcing):
    """Step the ocean mixed layer (oml, src/omlsubs.F:47-236).
    Returns (sst_new, sstm_new, entoc, xon1, enis1, enin1, cfraoc,
    centoc); enis1/enin1 are the boundary line integrals of entoc that
    the channel's momentum constraints take."""
    cfg = model.cfg
    rhs = _omladf(model, state.sst, state.sstm, state.po[0],
                  forcing.tauxo, forcing.tauyo)
    sstnew, dtonew, coneno, xfo = _oml_point(model, state, forcing, rhs)
    cfraoc = (dtonew > 0.0).to(dtonew.dtype).mean()
    centoc = -coneno.sum() * model.grids.dxo * model.grids.dyo

    # Remove mean so net entrainment (deep-ocean heat flux) is zero
    xfo = xfo - xfo.sum() * cfg.ocnorm

    entoc = _entrain_to_p(xfo, cfg.cyclic_ocean)
    xon1 = xintp(entoc) * model.grids.dxo * model.grids.dyo
    enis1 = model.grids.dxo * line_sum(entoc[0, :])
    enin1 = model.grids.dxo * line_sum(entoc[-1, :])
    return sstnew, state.sst, entoc, xon1, enis1, enin1, cfraoc, centoc


def _oml_point(model: Model, state: OceanState, forcing: OceanForcing, rhs):
    """The pointwise part of oml from the SST equation's stencil RHS:
    the SST prediction and convection clamp, and the entrainment before
    its mean is removed. Returns (sst_new, dtonew, coneno, xfo).

    On float32 models the SST prediction and the convection clamp run
    in float64 by default and are stored in float32 (config.ml_f64): the
    clamp is a non-smooth switch, and under f32 roundoff it can decouple
    the SST leapfrog levels at a convecting front, after which the
    advection-diffusion runs away (see qgcm_tpu/models/ocean.py:_oml).
    The stencil RHS, the entrainment and all reductions stay in the
    storage dtype."""
    cfg = model.cfg
    sdt = state.sst.dtype
    toc = [float(t) for t in model.rad.toc]
    tdto = 2.0 * cfg.dto
    hmoinv = 1.0 / cfg.mixed.hmoc
    dtoinv = 1.0 / (toc[0] - toc[1])
    entfac = cfg.mixed.hmoc * dtoinv / tdto
    rrcpoc = 1.0 / (cfg.rhooc * cfg.cpoc)

    ct = (torch.float64 if ml_f64_enabled(cfg) and sdt == torch.float32
          else sdt)

    # SST prediction (7.11) + convection clamp (7.13) in `ct`
    sstm_c = state.sstm.to(ct)
    diabat = 0.5 * forcing.wekto.to(ct) * (sstm_c + toc[0])
    sstnew = sstm_c + tdto * (
        rhs.to(ct) + hmoinv * (rrcpoc * forcing.fnetoc.to(ct) + diabat))
    dtonew = toc[0] - sstnew
    conv = torch.clamp(dtonew, min=0.0)
    sstnew = (sstnew + conv).to(sdt)
    conv = conv.to(sdt)
    dtonew = dtonew.to(sdt)

    # entrainment (7.12) and everything downstream in the storage dtype
    xfoent = -(0.5 * dtoinv) * forcing.wekto * (state.sstm - toc[0])
    coneno = entfac * conv
    return sstnew, dtonew, coneno, xfoent - coneno


# ----------------------------------------------------------------------
# QG vorticity step (src/qgosubs.F)
# ----------------------------------------------------------------------

def qgstep_consts(cfg: ModelConfig, g: Grids) -> tuple:
    """The float constants of ops.qgstep: (dxm2, bcfac, adfac, 1/f0,
    2dt, bdrfac, c1spl, beta*y0, beta*dy, f0/H0, f0/H1)."""
    dxom2 = 1.0 / g.dxo**2
    return (dxom2, cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0),
            1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot), 1.0 / cfg.fnot,
            2.0 * cfg.dto,
            0.5 * (1.0 if cfg.fnot > 0 else -1.0) * cfg.ocean.delek
            / cfg.ocean.hoc[-1],
            cfg.sponge.c1_spl, cfg.beta * float(g.yporel[0]),
            cfg.beta * g.dyo,
            cfg.fnot / cfg.ocean.hoc[0], cfg.fnot / cfg.ocean.hoc[1])


def _qgostep(model: Model, state: OceanState, forcing: OceanForcing,
             entoc: torch.Tensor):
    """Leapfrog step of the PV equation (7.14) through the fused
    vorticity kernel. Returns (qo_new, qom_new); qom_new is the old qo."""
    cfg = model.cfg
    qo_new = qgstep(state.pom, state.po, state.qo, state.qom,
                    forcing.wekpo, entoc, model.r_spl,
                    qgstep_consts(cfg, model.grids),
                    cfg.ocean.ah2oc, cfg.ocean.ah4oc,
                    cyclic=cfg.cyclic_ocean, sponge=cfg.sponge.enabled)
    return qo_new, state.qo


def _edge_d2d4(pom, bcfac, dxm2):
    """The two wall-adjacent rows of del2(pom) and del4(pom) in the
    channel, from thin slices (the constraint integrals need no more).
    Returns (d2_s, d2_n, d4_s, d4_n), each (nl, 2, nxp): south rows
    [wall, wall+1], north rows [wall-1, wall]."""

    def lap_row(r3):
        return dxm2 * (r3[:, 0] + r3[:, 2] + _wshift(r3[:, 1])
                       + _eshift(r3[:, 1]) - 4.0 * r3[:, 1])

    d2s = del2_bc(pom[:, :5], bcfac, dxm2, True)[:, :3]
    d2n = del2_bc(pom[:, -5:], bcfac, dxm2, True)[:, -3:]
    d4_s = torch.stack([bcfac * (d2s[:, 1] - d2s[:, 0]), lap_row(d2s)],
                       dim=1)
    d4_n = torch.stack([lap_row(d2n), bcfac * (d2n[:, -2] - d2n[:, -1])],
                       dim=1)
    return d2s[:, :2], d2n[:, -2:], d4_s, d4_n


def _cyclic_boundary_terms(model: Model, state: OceanState, d2_s, d2_n,
                           d4_s, d4_n) -> dict:
    """Momentum-constraint boundary integrals of the channel
    (qgosubs.F:150-163 bottom drag; ocadif:279-297, 404-443) from the
    wall slices of del2/del4 (_edge_d2d4) and the state's wall rows."""
    cfg = model.cfg
    g = model.grids
    po, pom, qo = state.po, state.pom, state.qo
    ah2, ah4 = model.ah2oc, model.ah4oc
    adfaco = 1.0 / (12.0 * g.dxo * g.dyo * cfg.fnot)

    pdx = _eshift(po) - _wshift(po)
    pdx_s, pdx_n = pdx[:, 1, :], pdx[:, -2, :]
    aj5s = line_sum(qo[:, 0, :] * pdx_s)
    aj9s = line_sum(qo[:, 1, :] * pdx_s)
    aj5n = -line_sum(qo[:, -1, :] * pdx_n)
    aj9n = -line_sum(qo[:, -2, :] * pdx_n)
    ajfac = cfg.fnot * adfaco * g.dxo * g.dyo
    half_ek = 0.5 * (1.0 if cfg.fnot > 0 else -1.0) * cfg.ocean.delek
    return dict(
        ajis=ajfac * (aj5s + 2.0 * aj9s), ajin=ajfac * (aj5n + 2.0 * aj9n),
        ap3s=ah2 * (d2_s[:, 1, :-1] - d2_s[:, 0, :-1]).sum(-1),
        ap3n=ah2 * (d2_n[:, 1, :-1] - d2_n[:, 0, :-1]).sum(-1),
        ap5s=ah4 * (d4_s[:, 1, :-1] - d4_s[:, 0, :-1]).sum(-1),
        ap5n=ah4 * (d4_n[:, 1, :-1] - d4_n[:, 0, :-1]).sum(-1),
        bdrins=half_ek * (pom[-1, 1, :-1] - pom[-1, 0, :-1]).sum(),
        bdrinn=half_ek * (pom[-1, -1, :-1] - pom[-1, -2, :-1]).sum())


# ----------------------------------------------------------------------
# PV inversion (src/ocisubs.F ocinvq)
# ----------------------------------------------------------------------

def _channel_pressure(inv, sol, cm2l, cs_new, cn_new, dx, dy, sums=None,
                      rows=None):
    """Layer pressures of a channel inversion, and their area integrals
    (ocisubs.F:208-264, atisubs.F:181-230): the homogeneous solutions
    that the new momentum-constraint vectors cs_new/cn_new call for are
    added to the inhomogeneous modal solutions `sol`, and the modes
    turned into layers. The east column is the west one, bit for bit.

    The constraints are solved in float64 (inv's data is float64): the
    line integrals of `sol` nearly cancel the constraint vectors, and in
    float32 their rounding, fed back every step into the zonal-mean
    flow, took a float32 channel 5-20x farther from its float64 run
    than qgcm_tpu's float32 goes (PERF.md, section 6). Only the grid
    assembly runs in sol's dtype. On a row block, `sums` are
    _channel_sums over the whole grid and `rows` the block's slice of
    the y profiles (padded). Returns (p, aiplay)."""
    f64 = torch.float64
    xinhom, ayis, ayin = (_channel_sums(sol, dx, dy) if sums is None
                          else sums)
    clhss = inv.cl2m @ cs_new.to(f64) + ayis
    clhsn = inv.cl2m @ cn_new.to(f64) - ayin
    # homogeneous solution coefficients (ocisubs.F:238-246)
    c3 = clhss[0] * inv.hbsi
    c1 = inv.hc2n * clhss[1:] - inv.hc2s * clhsn[1:]
    c2 = inv.hc1s * clhsn[1:] - inv.hc1n * clhss[1:]
    aipmod = torch.cat([xinhom[:1] + c3 * inv.aipbh,
                        xinhom[1:] + (c1 + c2) * inv.aipch])
    homcor = torch.cat([(c3 * inv.pbh)[None],
                        c1[:, None] * inv.pch1 + c2[:, None] * inv.pch2])
    if rows is not None:
        homcor = rows(homcor)
    p = torch.einsum("km,myx->kyx", cm2l,
                     sol[..., :-1] + homcor.to(sol.dtype)[:, :, None])
    return (torch.cat([p, p[..., :1]], dim=-1),
            (inv.cm2l @ aipmod).to(sol.dtype))


def _channel_sums(sol, dx, dy):
    """The float64 area integrals and the line integrals of dp/dy next to
    the walls of the inhomogeneous modal solutions (nm, nyp, nxp)."""
    f64 = torch.float64
    return (xintp(sol, dtype=f64) * dx * dy,
            line_sum(sol[:, 1, :], dtype=f64) * (dx / dy),
            -line_sum(sol[:, -2, :], dtype=f64) * (dx / dy))


def _continuity(est1, dpip, gp, xn1, tdt, area):
    """Continuity monitor of a channel (ocisubs.F:266-294): the layer
    integrals' new interface displacements est1 against the leapfrog
    of the old ones with the interface-1 entrainment. Returns
    (ermas, emfr)."""
    est2 = dpip - tdt * gp * _first(xn1, gp.shape[0])
    edif = est1 - est2
    esum = est1.abs() + est2.abs()
    thresh = ECRIT * area * tdt * gp
    return edif, torch.where(esum > thresh, 2.0 * edif / esum, 0.0)


def _ocinvq(model: Model, state: OceanState, qo_new: torch.Tensor, xon1,
            enis1, enin1, cyc, forcing: OceanForcing, rows=None):
    """Invert PV to pressure under the mass constraint, and in the
    channel the momentum constraints too. Returns (po_new, pom_new,
    dpioc, dpiocp, ocncs, ocncn, ocncsp, ocncnp, ermaso, emfroc).

    On a row block (`rows`, a _Rows; model.inv_oc.helm a sharded solver
    and model's y profiles the block's) the grid sums are the blocks'
    shares summed over the ranks, and po_new's padding rows are zero."""
    cfg = model.cfg
    g = model.grids
    inv = model.inv_oc
    nlo = cfg.nlo
    tdto = 2.0 * cfg.dto

    # Modal vorticity RHS (8.13): wrk_m = f0 * sum_k cl2m[m,k] (q_k - by)
    ql = qo_new - (cfg.beta * model.yporel)[None, :, None]
    ql[nlo - 1] -= model.ddyn
    wrk = cfg.fnot * torch.einsum("mk,kyx->myx", model.cl2m, ql)

    if cfg.cyclic_ocean:
        # momentum constraints, leapfrogged (ocisubs.F:169-206)
        sol = inv.helm.solve(wrk)
        ent = (0.5 * g.dyo * cfg.fnot**2) / model.hoc
        rhss = (ent * _interface_jump(enis1, nlo) + cyc["ajis"]
                - cyc["ap3s"] + cyc["ap5s"])
        rhsn = (ent * _interface_jump(enin1, nlo) + cyc["ajin"]
                + cyc["ap3n"] - cyc["ap5n"])
        rhss[0] += (cfg.fnot / model.hoc[0]) * forcing.txisoc
        rhsn[0] -= (cfg.fnot / model.hoc[0]) * forcing.txinoc
        rhss[-1] += (cfg.fnot / model.hoc[-1]) * cyc["bdrins"]
        rhsn[-1] -= (cfg.fnot / model.hoc[-1]) * cyc["bdrinn"]
        ocsnew = state.ocncsp + tdto * rhss
        ocnnew = state.ocncnp + tdto * rhsn
        sums = None if rows is None else rows.channel_sums(sol, g.dxo, g.dyo)
        po_new, aiplay = _channel_pressure(
            inv, sol, model.cm2l, ocsnew, ocnnew, g.dxo, g.dyo, sums=sums,
            rows=None if rows is None else rows.profile)
        est1 = aiplay[1:] - aiplay[:-1]
        ermaso, emfroc = _continuity(est1, state.dpiocp, model.gpoc, xon1,
                                     tdto, g.xlo * g.ylo)
        return (po_new, state.po, est1, state.dpioc, ocsnew, ocnnew,
                state.ocncs, state.ocncn, ermaso, emfroc)

    # Box (ocisubs.F:328-401). Everything stays in spectral space until
    # one inverse transform: the inhomogeneous-solution area integrals
    # come from a Parseval contraction with the DST of the ones vector,
    # and the homogeneous correction hclco * (1 + rdm2*sol0), with
    # Helm(sol0) = 1, is added as a separable spectrum.
    helm = inv.helm
    fwd = helm.forward(wrk)
    denom = helm._denom()
    parseval = torch.einsum("myx,y,x->m", fwd / denom, helm.gy, helm.gx)
    if rows is not None:
        parseval = rows.mesh.all_reduce(parseval, INV_SUMS)
    xinhom = helm.norm * parseval * g.dxo * g.dyo

    dpioc_new = state.dpiocp - tdto * model.gpoc * _first(xon1, nlo - 1)
    rhsum = torch.einsum("mk,m->k", inv.cdiffo, xinhom)
    hclco = inv.cdhinv @ (dpioc_new - rhsum)

    zero1 = hclco.new_zeros(1)
    coef = torch.cat([zero1, hclco * helm.rdm2[1:]])
    gyx = helm.gy[None, :, None] * helm.gx[None, None, :]
    spec = (fwd + coef[:, None, None] * gyx) / denom
    pm = helm.inverse(spec) + torch.cat([zero1, hclco])[:, None, None]
    po_new = torch.einsum("km,myx->kyx", model.cm2l, pm)
    if rows is not None:
        po_new = torch.where(rows.p_true, po_new, 0.0)
    zero = torch.zeros_like(dpioc_new)
    return (po_new, state.po, dpioc_new, state.dpioc, state.ocncs,
            state.ocncn, state.ocncsp, state.ocncnp, zero, zero)


# ----------------------------------------------------------------------
# Full substep + init helpers
# ----------------------------------------------------------------------

def make_ocean_step(model: Model, halo=None, sharded: bool = False):
    """Build the ocean substep oml -> qgostep -> ocinvq -> ocqbdy (main
    loop q-gcm.F:1222-1255). Returns step(state, forcing) ->
    (state, OceanStepDiags).

    halo: a (mesh, variant) pair (qgcm_tpu/models/ocean.py:666-677): the
    step then takes and returns this rank's blocks of a run decomposed
    over `mesh` (parallel/mesh.py: rows, or for a box any (y, x)
    shape), the vorticity step
    exchanging its ghosts by `variant` ('staged', 'deep' or 'overlap',
    parallel/halo.py) and the inversions transposing (parallel/
    spectral.py). sharded=True without a halo pair is qgcm_tpu's bare
    GSPMD partitioning, which has no PyTorch counterpart: it raises."""
    if halo is not None:
        return _make_rows_step(model, *halo)
    if sharded:
        raise ValueError(
            "a decomposed ocean step needs halo=(mesh, variant): qgcm_tpu's "
            "automatic GSPMD partitioning (sharded=True alone) has no "
            "PyTorch counterpart")
    cfg = model.cfg
    cyclic = cfg.cyclic_ocean
    dxom2 = 1.0 / model.grids.dxo**2
    bcfaco = cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0)

    def step(state: OceanState, forcing: OceanForcing):
        if cfg.no_oml:
            zero = state.po.new_zeros(())
            entoc = torch.zeros_like(state.po[0])
            sst_new, sstm_new = state.sst, state.sstm
            xon1 = enis1 = enin1 = cfraoc = centoc = zero
        else:
            (sst_new, sstm_new, entoc, xon1, enis1, enin1, cfraoc,
             centoc) = _oml(model, state, forcing)

        qo_new, qom_new = _qgostep(model, state, forcing, entoc)
        cyc = (_cyclic_boundary_terms(model, state,
                                      *_edge_d2d4(state.pom, bcfaco, dxom2))
               if cyclic else None)
        (po_new, pom_new, dpioc, dpiocp, ocncs, ocncn, ocncsp, ocncnp,
         ermaso, emfroc) = _ocinvq(model, state, qo_new, xon1, enis1,
                                   enin1, cyc, forcing)
        qo_new = ocqbdy(qo_new, po_new, model.amat, model.yporel, dxom2,
                        cfg.fnot, cfg.beta, cfg.ocean.bccooc, model.ddyn,
                        cyclic=cyclic)

        new_state = OceanState(
            po=po_new, pom=pom_new, qo=qo_new, qom=qom_new,
            sst=sst_new, sstm=sstm_new, dpioc=dpioc, dpiocp=dpiocp,
            ocncs=ocncs, ocncn=ocncn, ocncsp=ocncsp, ocncnp=ocncnp)
        diags = OceanStepDiags(ermaso=ermaso, emfroc=emfroc, xon1=xon1,
                               cfraoc=cfraoc, centoc=centoc)
        return new_state, diags

    return step


# ----------------------------------------------------------------------
# The substep on blocks (a run decomposed over parallel/mesh.py)
# ----------------------------------------------------------------------

# collective call sites (Mesh.counts)
OML_ROWS = "ocean.oml.rows"
OML_COLS = "ocean.oml.cols"
OML_SUMS = "ocean.oml.sums"
WALLS = "ocean.walls"
INV_SUMS = "ocean.inversion.sums"
BDY_ROWS = "ocean.ocqbdy.rows"
BDY_COLS = "ocean.ocqbdy.cols"
FORCING_WALLS = "ocean.forcing.walls"
# the atmosphere's (models/atmos.py)
ATM_INV_SUMS = "atmos.inversion.sums"
ATM_WALLS = "atmos.walls"
# the global rows of the wall strips the channel's constraint terms read
# (_edge_d2d4 and _cyclic_boundary_terms: 5 rows at each wall)
_STRIP = 5


class _Rows:
    """This rank's block of the ocean's grids in a run decomposed over
    `mesh`: p rows [r0, r0 + n) of nyp and the T rows of the same indices
    of nyt = nyp - 1 and, on a mesh with x > 1 (`two_d`), p columns
    [c0, c0 + m) of nxp and the T columns of the same indices of nxt =
    nxp - 1; those at or beyond the grid's end are padding. On a rows
    mesh every field keeps its own columns (m = nxp; a T field nxt).
    With `atmos` the same for the atmosphere's grids on its rows mesh
    (parallel/mesh.atmos_mesh): a cyclic channel, its collectives
    counted under the atmosphere's sites."""

    def __init__(self, mesh, cfg, device, atmos: bool = False):
        self.mesh = mesh
        self.cyclic = atmos or cfg.cyclic_ocean
        self.r0, self.n = mesh.iy * mesh.by, mesh.by
        if atmos:
            self.nyp, self.nyt = cfg.nypa, cfg.nyta
            self.nxp, self.nxt = cfg.nxpa, cfg.nxta
            self.sums_site, self.walls_site = ATM_INV_SUMS, ATM_WALLS
        else:
            self.nyp, self.nyt = cfg.nypo, cfg.nyto
            self.nxp, self.nxt = cfg.nxpo, cfg.nxto
            self.sums_site, self.walls_site = INV_SUMS, WALLS
        self.two_d = mesh.mx > 1
        self.c0, self.m = ((mesh.ix * mesh.bx, mesh.bx) if self.two_d
                           else (0, cfg.nxpo))
        g = self.r0 + torch.arange(self.n, device=device)
        self.gy = g[:, None]                      # global rows, (n, 1)
        self.gx = (self.c0 + torch.arange(self.m, device=device))[None, :]
        rows_p, rows_t = self.gy < self.nyp, self.gy < self.nyt
        if self.two_d:
            cols_p, cols_t = self.gx < self.nxp, self.gx < self.nxt
            self.p_true, self.t_true = rows_p & cols_p, rows_t & cols_t
            # the faces of the running means: T rows x p columns (W/E
            # faces), p rows x T columns (S/N faces)
            self.tp_true, self.pt_true = rows_t & cols_p, rows_p & cols_t
        else:
            self.p_true = self.tp_true = rows_p
            self.t_true = self.pt_true = rows_t
        # wall_strips' rows: the block's index of each (0 where the block
        # does not hold it) and whether the block holds it
        held = [self.local(g) for g in (*range(_STRIP),
                                        *range(self.nyp - _STRIP, self.nyp))]
        self.strip_rows = torch.tensor([i or 0 for i in held], device=device)
        self.strip_held = torch.tensor([i is not None for i in held],
                                       device=device)[:, None]

    def local(self, g: int):
        """The block's index of global row g, or None."""
        i = g - self.r0
        return i if 0 <= i < self.n else None

    def profile(self, v: torch.Tensor) -> torch.Tensor:
        """The block's rows of a (..., nyp) profile, zero-padded."""
        part = v[..., self.r0:self.r0 + self.n]
        return F.pad(part, (0, self.n - part.shape[-1]))

    def ext(self, f: torch.Tensor) -> torch.Tensor:
        """The block's p points of a whole (ny, nx) field with one more
        row (and, on a 2-D mesh, column) each side, zero off the grid."""
        if not self.two_d:
            f = F.pad(f, (0, 0, 1, self.mesh.my * self.n + 1 - f.shape[0]))
            return f[self.r0:self.r0 + self.n + 2]
        f = F.pad(f, (1, self.mesh.mx * self.m + 1 - f.shape[1],
                      1, self.mesh.my * self.n + 1 - f.shape[0]))
        return f[self.r0:self.r0 + self.n + 2, self.c0:self.c0 + self.m + 2]

    def inner(self, f: torch.Tensor, h: int = 1) -> torch.Tensor:
        """f without its h ghost rows (and, on a 2-D mesh, columns) each
        side."""
        f = f[..., h:-h, :]
        return f[..., h:-h] if self.two_d else f

    def t_wide(self, f: torch.Tensor) -> torch.Tensor:
        """A T field as wide as the p fields of the block: on a rows mesh
        padded by the one column it lacks."""
        return f if self.two_d else F.pad(f, (0, 1))

    def t_narrow(self, f: torch.Tensor) -> torch.Tensor:
        """The inverse of t_wide."""
        return f if self.two_d else f[..., :self.nxt]

    def with_ghosts(self, f: torch.Tensor, h: int, rows_site: str,
                    cols_site: str) -> torch.Tensor:
        """The block f (..., n, m) with h exchanged ghost rows each side
        and then h ghost columns of the row-extended block (corners
        included, as _qgstep_halo_2d's); zeros at the domain's ends. On a
        rows mesh the ghost columns are zeros, with no exchange (the
        walls' ghosts come from ghost_cols)."""
        south, north = self.mesh.start_exchange(f, h, "y", rows_site).wait()
        ys = torch.cat([south, f, north], dim=-2)
        if not self.two_d:
            return F.pad(ys, (h, h))
        west, east = self.mesh.start_exchange(ys, h, "x", cols_site).wait()
        return torch.cat([west, ys, east], dim=-1)

    def ghost_cols(self, ext: torch.Tensor, lo: int) -> torch.Tensor:
        """The T columns of `ext` (columns c0-lo, ...) outside the grid as
        its walls have them (_wrap_x): column -1 and column nxt take
        copies of columns 0 and nxt-1 in the box, of nxt-1 and 0 in the
        channel (whose rows mesh holds every column). A block that holds
        neither is returned as it is."""
        w, e = -1 - (self.c0 - lo), self.nxt - (self.c0 - lo)
        copies = [(i, j) for i, j in (
            (w, lo + self.nxt - 1 if self.cyclic else w + 1),
            (e, lo if self.cyclic else e - 1)) if 0 <= i < ext.shape[-1]]
        if not copies:
            return ext
        out = ext.clone()
        for i, j in copies:
            out[..., i] = ext[..., j]
        return out

    def wx(self, dtype) -> torch.Tensor:
        """The trapezoid's column weights of the block's p columns."""
        return edge_weights(self.c0, self.m, self.nxp,
                            self.gx.device).to(dtype)

    def line_share(self, row: torch.Tensor, dtype=None) -> torch.Tensor:
        """The block's share of line_sum along a global p row."""
        if not self.two_d:
            return line_sum(row, dtype=dtype)
        t = dtype or row.dtype
        return (row.to(t) * self.wx(t)).sum(-1)

    def xintp_share(self, f: torch.Tensor, dtype=None) -> torch.Tensor:
        """The block's share of xintp(f)."""
        return xintp_block(f, self.r0, self.nyp, self.c0,
                           self.nxp if self.two_d else None, dtype=dtype)

    def channel_sums(self, sol, dx, dy):
        """_channel_sums of the whole grid from the blocks of sol: the
        shares of the area integral and the wall-side line integrals
        (each held by one block), summed over the ranks in float64."""
        f64 = torch.float64
        nm = sol.shape[0]
        parts = [self.xintp_share(sol, dtype=f64)]
        for g, sign in ((1, 1.0), (self.nyp - 2, -1.0)):
            i = self.local(g)
            parts.append(sign * line_sum(sol[:, i, :], dtype=f64)
                         * (dx / dy) if i is not None
                         else sol.new_zeros(nm, dtype=f64))
        tot = self.mesh.all_reduce(torch.cat(parts), self.sums_site)
        return tot[:nm] * dx * dy, tot[nm:2 * nm], tot[2 * nm:]

    def wall_strips(self, fields):
        """(len, nl, 2*_STRIP, nx) every rank's copy of the global rows
        0 .. _STRIP-1 and nyp-_STRIP .. nyp-1 of the row-blocked (nl, n,
        nx) `fields`: each row from the block that holds it (the others
        add zeros, so the sum is exact). Every rank's share is made from
        `fields`, one that holds no strip row too, so that autograd
        records the all_reduce on every rank alike (parallel/mesh.py)."""
        stack = torch.stack(fields)
        out = torch.where(self.strip_held,
                          stack.index_select(2, self.strip_rows), 0.0)
        return self.mesh.all_reduce(out, self.walls_site)


def _ghost_rows(rows: _Rows, ext, lo: int, south=None, north=None):
    """The T-grid rows of `ext` (rows r0-lo, ...) outside the grid as its
    walls have them (_pad_t_grid): row -1 takes `south` or a copy of row
    0, row nyt takes `north` or a copy of row nyt-1."""
    g = rows.r0 - lo + torch.arange(ext.shape[0], device=ext.device)[:, None]
    below = torch.cat([ext[1:], ext[-1:]]) if south is None else south
    above = torch.cat([ext[:1], ext[:-1]]) if north is None else north
    return torch.where(g == -1, below, torch.where(g == rows.nyt, above, ext))


def _t_ghosts(rows: _Rows, ext, lo: int, south=None, north=None):
    """_ghost_rows, then the ghost columns (_Rows.ghost_cols)."""
    return rows.ghost_cols(_ghost_rows(rows, ext, lo, south, north), lo)


def _omladf_rows(model: Model, rows: _Rows, ext):
    """_omladf on a block: `ext` is the stack of sstm, sst, po[0], tauxo
    and tauyo with 2 ghost rows and columns each side (_Rows.with_ghosts;
    the T fields as wide as the p fields, _Rows.t_wide). The walls'
    ghosts and the S/N flux rows and W/E flux columns apply where the
    block holds them (global rows and columns). Returns the RHS on the
    block's T points, as wide as its p fields."""
    cfg = model.cfg
    g = model.grids
    cyclic = cfg.cyclic_ocean
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    d4tfac = cfg.mixed.st4d / g.dxo**4
    tsbdy, tnbdy = model.rad.tsbdy, model.rad.tnbdy
    sstm = ext[0]                            # T rows r0-2 .., cols c0-2 ..
    sst = rows.ghost_cols(ext[1, 1:-1, 1:-1], 1)   # rows r0-1 .., cols c0-1 ..
    # p rows r0 .. r0+n, columns c0 .. c0+m
    po1, tauxo, tauyo = (f[2:-1, 2:-1] for f in ext[2:])

    # W/E faces (p columns c0 .. c0+m) of the T rows r0 .. r0+n-1; no flux
    # through the box walls
    uface = (-uvgfac * (po1[1:] - po1[:-1])
             + rhf0hm * (tauyo[1:] + tauyo[:-1]))
    xflux = uface * (sst[1:-1, :-1] + sst[1:-1, 1:])
    if not cyclic:
        gx = rows.c0 + torch.arange(xflux.shape[-1], device=xflux.device)
        xflux = torch.where((gx == 0) | (gx == rows.nxp - 1), 0.0, xflux)
    hxadv = hdxom1 * (xflux[:, 1:] - xflux[:, :-1])

    # S/N faces on p rows r0 .. r0+n (T columns c0 .. c0+m-1), the walls'
    # rows where held
    sst = sst[:, 1:-1]
    yflux = _vface(model, po1, tauxo) * (sst[:-1, :] + sst[1:, :])
    gp = rows.r0 + torch.arange(po1.shape[0], device=po1.device)[:, None]
    vwall = -rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1])
    south = vwall * (sst[1:, :] + tsbdy) if cfg.sb_hflux else 0.0
    north = vwall * (sst[:-1, :] + tnbdy) if cfg.nb_hflux else 0.0
    yflux = torch.where(gp == 0, south,
                        torch.where(gp == rows.nyp - 1, north, yflux))
    hyadv = hdxom1 * (yflux[1:, :] - yflux[:-1, :])
    rhs = -(hxadv + hyadv)

    full = torch.full_like
    sstm_g = _t_ghosts(rows, sstm, 2,
                       south=full(sstm, tsbdy) if cfg.sb_hflux else None,
                       north=full(sstm, tnbdy) if cfg.nb_hflux else None)
    del2t = _lap_padded(sstm_g)              # T rows r0-1 .., cols c0-1 ..
    del4t = _lap_padded(_t_ghosts(rows, del2t, 1))
    return rhs + d2tfac * del2t[1:-1, 1:-1] - d4tfac * del4t


def _oml_rows(model: Model, rows: _Rows, state: OceanState,
              forcing: OceanForcing):
    """_oml on this rank's blocks; the sums go through all_reduce."""
    cfg = model.cfg
    mesh = rows.mesh
    dxo, dyo = model.grids.dxo, model.grids.dyo
    stack = torch.stack([rows.t_wide(state.sstm), rows.t_wide(state.sst),
                         state.po[0], forcing.tauxo, forcing.tauyo])
    ext = rows.with_ghosts(stack, 2, OML_ROWS, OML_COLS)
    rhs = rows.t_narrow(_omladf_rows(model, rows, ext))
    sstnew, dtonew, coneno, xfo = _oml_point(model, state, forcing, rhs)
    t = rows.t_true
    sstnew = torch.where(t, sstnew, 0.0)
    coneno = torch.where(t, coneno, 0.0)
    xfo = torch.where(t, xfo, 0.0)
    sums = mesh.all_reduce(torch.stack([
        xfo.sum(), (t & (dtonew > 0.0)).sum().to(xfo.dtype), coneno.sum()]),
        OML_SUMS)
    cfraoc = sums[1] / (cfg.nyto * cfg.nxto)
    centoc = -sums[2] * dxo * dyo
    xfo = torch.where(t, xfo - sums[0] * cfg.ocnorm, 0.0)

    # _entrain_to_p on the block's p points from the T rows and columns
    # one south and west of them
    xe = rows.with_ghosts(rows.t_wide(xfo), 1, OML_ROWS, OML_COLS)
    xp = _t_ghosts(rows, xe, 1)[:-1, :-1]
    entoc = 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])
    entoc = torch.where(rows.p_true, entoc, 0.0)

    parts = [rows.xintp_share(entoc)]
    for g in (0, rows.nyp - 1):
        i = rows.local(g)
        parts.append(dxo * rows.line_share(entoc[i, :]) if i is not None
                     else entoc.new_zeros(()))
    xon1, enis1, enin1 = mesh.all_reduce(torch.stack(parts), OML_SUMS)
    return (sstnew, state.sst, entoc, xon1 * dxo * dyo, enis1, enin1,
            cfraoc, centoc)


def _qgostep_halo(model: Model, state: OceanState, forcing: OceanForcing,
                  entoc: torch.Tensor, mesh, variant: str):
    """_qgostep on this rank's blocks through parallel/halo.py
    (qgcm_tpu/models/ocean.py:463); `model` holds the block's r_spl.
    Returns (qo_new, qom_new)."""
    from ..parallel.halo import qgstep_halo
    cfg = model.cfg
    qo_new = qgstep_halo(state.pom, state.po, state.qo, state.qom,
                         forcing.wekpo, entoc, model.r_spl,
                         qgstep_consts(cfg, model.grids), cfg.ocean.ah2oc,
                         cfg.ocean.ah4oc, cyclic=cfg.cyclic_ocean,
                         sponge=cfg.sponge.enabled, mesh=mesh,
                         variant=variant)
    return qo_new, state.qo


def _cyclic_terms_rows(model: Model, rows: _Rows, state: OceanState,
                       bcfac, dxm2) -> dict:
    """_cyclic_boundary_terms of the channel from the wall strips, which
    every rank gets whole (rows.wall_strips): the same values on every
    rank, bit for bit those of the whole grid."""
    pom, po, qo = rows.wall_strips([state.pom, state.po, state.qo])
    strips = state._replace(pom=pom, po=po, qo=qo)
    return _cyclic_boundary_terms(model, strips,
                                  *_edge_d2d4(pom, bcfac, dxm2))


def block_model(model: Model, mesh) -> Model:
    """The model as a rank of a run decomposed over `mesh` sees it: its
    PV inversion on blocks (parallel/spectral.py) and its y profiles and
    fields (yporel, ddyn, r_spl) cut to the rank's rows and columns."""
    import dataclasses
    from ..parallel.mesh import shard
    from ..parallel.spectral import wrap_inversions
    model = wrap_inversions(model, mesh)
    rows = _Rows(mesh, model.cfg, model.device)
    return dataclasses.replace(
        model, yporel=rows.profile(model.yporel),
        ddyn=model.ddyn if model.ddyn.dim() == 0 else shard(model.ddyn, mesh),
        r_spl=None if model.r_spl is None else shard(model.r_spl, mesh))


def check_mesh_grid(cfg, mesh, what: str = "the decomposed substep"):
    """Refuse a mesh that the decomposed ocean cannot take: one made for
    another grid, a channel's mesh with x > 1, blocks too thin for the
    mixed layer's two ghost rows and columns (3 at least)."""
    from ..parallel.mesh import cyclic_x_refusal
    if mesh.grid != (cfg.nypo, cfg.nxpo):
        raise ValueError(f"the mesh was made for the grid {mesh.grid}, the "
                         f"ocean's is {(cfg.nypo, cfg.nxpo)}")
    if mesh.mx > 1 and cfg.cyclic_ocean:
        raise cyclic_x_refusal(f"{what} on a {mesh.my}x{mesh.mx} mesh")
    if mesh.by < 3:
        raise ValueError(f"row blocks of {mesh.by} rows are too thin for "
                         "the mixed layer's ghost rows (3 at least)")
    if mesh.mx > 1 and mesh.bx < 3:
        raise ValueError(f"column blocks of {mesh.bx} columns are too thin "
                         "for the mixed layer's ghost columns (3 at least)")


def boundary_ghosts(mesh, f, axis: str, site: str):
    """(f, lo, hi): the block f and the one ghost row ('y') or column
    ('x') each side that the boundary PV reads where a wall starts a
    block. Only the ranks whose block holds that wall read the ghosts; so
    that the exchange's backward runs on every rank (parallel/mesh.py),
    under autograd f comes back read through the exchange's output, on
    which every rank's result then depends."""
    from ..parallel.mesh import _records
    dim = -2 if axis == "y" else -1
    lo, hi = mesh.start_exchange(f, 1, axis, site).wait()
    if not _records(f):
        return f, lo, hi
    n = f.shape[dim]
    ext = torch.cat([lo, f, hi], dim=dim)
    return (ext.narrow(dim, 1, n).contiguous(), ext.narrow(dim, 0, 1),
            ext.narrow(dim, n + 1, 1))


def _make_rows_step(model: Model, mesh, variant: str):
    """make_ocean_step's substep on this rank's blocks: row blocks, or in
    the box 2-D blocks of a mesh with x > 1."""
    cfg = model.cfg
    check_mesh_grid(cfg, mesh)
    cyclic = cfg.cyclic_ocean
    bm = block_model(model, mesh)
    rows = _Rows(mesh, cfg, model.device)
    dxom2 = 1.0 / model.grids.dxo**2
    bcfaco = cfg.ocean.bccooc * dxom2 / (0.5 * cfg.ocean.bccooc + 1.0)
    # ocqbdy needs the row inside the north wall from the block below
    # only when the wall row starts a block, and the column inside the
    # east wall from the block west of it when the wall column starts one
    bdy_rows = rows.nyp - 1 > 0 and (rows.nyp - 1) % mesh.by == 0
    bdy_cols = rows.two_d and (rows.nxp - 1) % mesh.bx == 0
    cols = dict(c0=rows.c0, nx=rows.nxp) if rows.two_d else {}

    def step(state: OceanState, forcing: OceanForcing):
        if cfg.no_oml:
            zero = state.po.new_zeros(())
            entoc = torch.zeros_like(state.po[0])
            sst_new, sstm_new = state.sst, state.sstm
            xon1 = enis1 = enin1 = cfraoc = centoc = zero
        else:
            (sst_new, sstm_new, entoc, xon1, enis1, enin1, cfraoc,
             centoc) = _oml_rows(bm, rows, state, forcing)

        qo_new, qom_new = _qgostep_halo(bm, state, forcing, entoc, mesh,
                                        variant)
        cyc = (_cyclic_terms_rows(bm, rows, state, bcfaco, dxom2)
               if cyclic else None)
        (po_new, pom_new, dpioc, dpiocp, ocncs, ocncn, ocncsp, ocncnp,
         ermaso, emfroc) = _ocinvq(bm, state, qo_new, xon1, enis1, enin1,
                                   cyc, forcing, rows=rows)
        ghosts = {}
        if bdy_rows:
            po_new, south, north = boundary_ghosts(mesh, po_new, "y",
                                                   BDY_ROWS)
            ghosts.update(south=south[:, 0], north=north[:, 0])
        if bdy_cols:
            po_new, west, east = boundary_ghosts(mesh, po_new, "x",
                                                 BDY_COLS)
            ghosts.update(west=west[..., 0], east=east[..., 0])
        qo_new = ocqbdy_block(qo_new, po_new, bm.amat, bm.yporel, dxom2,
                              cfg.fnot, cfg.beta, cfg.ocean.bccooc, bm.ddyn,
                              cyclic, rows.r0, rows.nyp, **ghosts, **cols)
        if rows.two_d:
            # the zonal walls' rows are written over the padding columns
            qo_new = torch.where(rows.p_true, qo_new, 0.0)

        new_state = OceanState(
            po=po_new, pom=pom_new, qo=qo_new, qom=qom_new,
            sst=sst_new, sstm=sstm_new, dpioc=dpioc, dpiocp=dpiocp,
            ocncs=ocncs, ocncn=ocncn, ocncsp=ocncsp, ocncnp=ocncnp)
        diags = OceanStepDiags(ermaso=ermaso, emfroc=emfroc, xon1=xon1,
                               cfraoc=cfraoc, centoc=centoc)
        return new_state, diags

    return step


def _as_field(model: Model, a) -> torch.Tensor:
    """A copy of an array or tensor in the model's dtype on its device."""
    return torch.as_tensor(a).to(device=model.device, dtype=model.dtype,
                                 copy=True)


def momentum_constraints(p: torch.Tensor, amat: torch.Tensor, dx: float,
                         dy: float, fnot: float):
    """The channel's momentum-constraint vectors of a pressure field
    (constr, src/conhoms.F:93-199 ocean, :203-310 atmosphere): the S
    and N line integrals of dp/dy plus the f0^2 A p line integrals."""
    fsq = 0.5 * dy * fnot**2
    pins = dx * line_sum(p[:, 0, :])
    pinn = dx * line_sum(p[:, -1, :])
    cs = line_sum(p[:, 1, :] - p[:, 0, :]) * (dx / dy)
    cn = line_sum(p[:, -1, :] - p[:, -2, :]) * (dx / dy)
    return -cs + fsq * (amat @ pins), cn + fsq * (amat @ pinn)


def init_ocean_state(model: Model, init: str = "zero",
                     po=None, pom=None, sst=None, sstm=None) -> OceanState:
    """Initial ocean state: 'zero' (q-gcm.F zeroin:1615), 'rbal'
    (rbalin:1712 -- zero pressure, sstbar SST), or explicit arrays
    (NumPy or tensors). PV is derived from pressure (q-gcm.F:715-732),
    the constraint values from `constr` (src/conhoms.F:44-199).

    In the channel the east column of po and pom is set to the west one
    before q is derived: every p-grid field of the channel keeps that
    duplicate, and a q derived from a pressure without it would carry
    the offset for good (the leapfrog never rederives q), which a
    restart, rederiving q from the saved p, would drop. qgcm_tpu takes
    such a pressure as it is."""
    cfg = model.cfg
    g = model.grids
    dev, dtype = model.device, model.dtype
    nlo, nypo, nxpo = cfg.nlo, cfg.nypo, cfg.nxpo
    nyto, nxto = cfg.nyto, cfg.nxto
    cyclic = cfg.cyclic_ocean

    po = (torch.zeros((nlo, nypo, nxpo), device=dev, dtype=dtype)
          if po is None else _as_field(model, po))
    pom = po if pom is None else _as_field(model, pom)
    if cyclic:
        po = torch.cat([po[..., :-1], po[..., :1]], dim=-1)
        pom = torch.cat([pom[..., :-1], pom[..., :1]], dim=-1)
    if sst is None:
        if init == "rbal":
            sst = _as_field(model, model.rad.sstbar)[:, None].expand(
                nyto, nxto).contiguous()
        else:
            sst = torch.zeros((nyto, nxto), device=dev, dtype=dtype)
    else:
        sst = _as_field(model, sst)
    sstm = sst if sstm is None else _as_field(model, sstm)

    dxom2 = 1.0 / g.dxo**2

    def q_from_p(p):
        q = qcomp(p, model.amat, model.yporel, dxom2, cfg.fnot, cfg.beta,
                  model.ddyn, nlo - 1, cyclic=cyclic)
        return ocqbdy(q, p, model.amat, model.yporel, dxom2, cfg.fnot,
                      cfg.beta, cfg.ocean.bccooc, model.ddyn, cyclic=cyclic)

    area = g.dxo * g.dyo
    if cyclic:
        ocncs, ocncn = momentum_constraints(po, model.amat, g.dxo, g.dyo,
                                            cfg.fnot)
        ocncsp, ocncnp = momentum_constraints(pom, model.amat, g.dxo,
                                              g.dyo, cfg.fnot)
    else:
        ocncs = ocncn = ocncsp = ocncnp = torch.zeros(nlo, device=dev,
                                                      dtype=dtype)
    return OceanState(po=po, pom=pom, qo=q_from_p(po), qom=q_from_p(pom),
                      sst=sst, sstm=sstm,
                      dpioc=xintp(po[1:] - po[:-1]) * area,
                      dpiocp=xintp(pom[1:] - pom[:-1]) * area,
                      ocncs=ocncs, ocncn=ocncn, ocncsp=ocncsp, ocncnp=ocncnp)


def ekman_forcing(model: Model, tauxo: torch.Tensor, tauyo: torch.Tensor,
                  fnetoc: torch.Tensor, rows=None) -> OceanForcing:
    """OceanForcing of the model's dtype and device from the windstress
    and heat flux: the Ekman velocities and, in the channel, the
    boundary stress integrals, as the ocean section of xforc derives
    them (src/xfosubs.F:568-707).

    With `rows` (a _Rows of a decomposed run) the forcing is this rank's
    blocks: tauxo and tauyo hold its p points and one more row (and, on
    a 2-D mesh, column) each side (_Rows.ext; points off the grid are
    not read), fnetoc its T points. The T points beyond the walls take
    the walls' copies, as _entrain_to_p's edge rows and columns do;
    padding comes out zero. In the channel the ranks that hold the wall
    rows form txisoc and txinoc, and an all_reduce gives them to every
    rank."""
    cfg = model.cfg
    g = model.grids
    hxofac = 0.5 / (g.dxo * cfg.fnot)
    # Ekman velocity at T points (7.7): curl of tau around the T cell
    wekto = hxofac * (
        tauyo[:-1, 1:] + tauyo[1:, 1:] - tauyo[:-1, :-1] - tauyo[1:, :-1]
        + tauxo[:-1, :-1] + tauxo[:-1, 1:] - tauxo[1:, :-1] - tauxo[1:, 1:])
    if rows is not None:
        return _ekman_rows(model, rows, tauxo, tauyo, fnetoc, wekto)
    # wekpo by averaging wekto (xfosubs.F:589-646)
    wekpo = _entrain_to_p(wekto, cfg.cyclic_ocean)
    if cfg.cyclic_ocean:
        txis = 0.5 * g.dxo * line_sum(tauxo[0, :] + tauxo[1, :])
        txin = 0.5 * g.dxo * line_sum(tauxo[-2, :] + tauxo[-1, :])
    else:
        txis = txin = tauxo.new_zeros(())
    return OceanForcing(tauxo=tauxo, tauyo=tauyo, fnetoc=fnetoc,
                        wekto=wekto, wekpo=wekpo, txisoc=txis, txinoc=txin)


def _ekman_rows(model: Model, rows, tauxo, tauyo, fnetoc, wekto):
    """ekman_forcing's block half: `wekto` is on the T points between the
    stresses' points (T rows r0-1 .. r0+n-1 and, on a 2-D mesh, T
    columns c0-1 .. c0+m-1)."""
    cfg = model.cfg
    dxo = model.grids.dxo
    if not rows.two_d:
        wekto = F.pad(wekto, (1, 1))
    xp = _t_ghosts(rows, wekto, 1)
    wekpo = 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])
    txis = txin = tauxo.new_zeros(())
    if cfg.cyclic_ocean:
        # the stresses' row i is global row r0 - 1 + i; a block that holds
        # no wall still makes its zero share from tauxo, so that autograd
        # records the all_reduce on every rank alike (parallel/mesh.py)
        s, nth = rows.local(0), rows.local(rows.nyp - 1)
        held = torch.tensor([s is not None, nth is not None],
                            device=tauxo.device)
        i = nth or 0
        walls = torch.where(held, 0.5 * dxo * torch.stack([
            line_sum(tauxo[1, :] + tauxo[2, :]),
            line_sum(tauxo[i, :] + tauxo[i + 1, :])]), 0.0)
        txis, txin = rows.mesh.all_reduce(walls, FORCING_WALLS)
    return OceanForcing(
        tauxo=torch.where(rows.p_true, rows.inner(tauxo), 0.0),
        tauyo=torch.where(rows.p_true, rows.inner(tauyo), 0.0),
        fnetoc=torch.where(rows.t_true, fnetoc, 0.0),
        wekto=torch.where(rows.t_true, rows.t_narrow(
            wekto[1:, 1:-1] if not rows.two_d else wekto[1:, 1:]), 0.0),
        wekpo=torch.where(rows.p_true, wekpo, 0.0),
        txisoc=txis, txinoc=txin)


def ocean_forcing_from_mean(model: Model, tauxo, tauyo, fnetoc,
                            rows=None) -> OceanForcing:
    """Static OceanForcing for ocean_only runs from mean windstress and
    heat flux (arrays or tensors), through ekman_forcing (whose `rows`
    takes a rank's blocks)."""
    return ekman_forcing(model, *(_as_field(model, a)
                                  for a in (tauxo, tauyo, fnetoc)),
                         rows=rows)
