"""Oceanic component, box geometry: mixed layer, QG vorticity step, PV
inversion (port of qgcm_tpu/models/ocean.py).

Replaces reference src/omlsubs.F (oml/omladf), src/qgosubs.F (qgostep)
and src/ocisubs.F (ocinvq) with one functional substep on tensors. The
vorticity step goes through ops.qgstep: the hand-written CUDA kernel on
the card, its plain PyTorch version on the CPU. Equation references are
to the Q-GCM v1.5.0 users' guide numbering (7.x). The cyclic channel
(momentum constraints, CyclicHelmholtz) is a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig, ml_f64_enabled
from ..grids import Grids
from ..model import Model
from ..ops.integrals import xintp
from ..ops.qgstep import qgstep
from ..ops.stencils import _col_mask
from ..ops.vorticity import qcomp, ocqbdy
from ..state import OceanState, OceanForcing


class OceanStepDiags(NamedTuple):
    """Per-step cheap diagnostics (monitoring subset)."""
    ermaso: torch.Tensor  # (nlo-1,) continuity constraint error (cyclic)
    emfroc: torch.Tensor  # (nlo-1,) fractional error
    xon1: torch.Tensor    # scalar: area integral of layer-1/2 entrainment
    cfraoc: torch.Tensor  # scalar: fraction of convecting o.m.l. points
    centoc: torch.Tensor  # scalar: integrated convective entrainment


def _pad_t_grid(f: torch.Tensor, south=None, north=None) -> torch.Tensor:
    """Pad a T-grid field by one ghost cell on each side: edge-replicate
    in x (no normal flux through the box walls) and in y, unless a
    constant boundary value is given (sb_hflux/nb_hflux)."""
    f = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
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

def _omladf(model: Model, sst, sstm, po1, tauxo, tauyo):
    """Advective + diffusive RHS of the SST equation (omladf,
    src/omlsubs.F:244-763): 2nd-order C-grid advection of sst by
    geostrophic + Ekman velocities, del2 and del4 diffusion of sstm."""
    cfg = model.cfg
    g = model.grids
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    hdxom1 = 0.5 / g.dxo
    d2tfac = cfg.mixed.st2d / g.dxo**2
    d4tfac = cfg.mixed.st4d / g.dxo**4
    tsbdy, tnbdy = model.rad.tsbdy, model.rad.tnbdy

    # u at T-cell W/E faces: faces line up with p columns. (nyto, nxpo)
    uface = (-uvgfac * (po1[1:, :] - po1[:-1, :])
             + rhf0hm * (tauyo[1:, :] + tauyo[:-1, :]))
    # T at W/E faces (sum of adjacent cells; the 1/2 is in hdxom1); no
    # flux through the box walls
    zcol = torch.zeros_like(sst[:, :1])
    tface = torch.cat([zcol, sst[:, :-1] + sst[:, 1:], zcol], dim=1)
    wecols = _col_mask(uface, 0) | _col_mask(uface, -1)
    xflux = torch.where(wecols, 0.0, uface * tface)
    hxadv = hdxom1 * (xflux[:, 1:] - xflux[:, :-1])

    # v at T-cell S/N faces: faces line up with p rows. (nypo, nxto)
    vface = (uvgfac * (po1[:, 1:] - po1[:, :-1])
             - rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1]))
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
    sstm_p = _pad_t_grid(sstm, south=tsbdy if cfg.sb_hflux else None,
                         north=tnbdy if cfg.nb_hflux else None)
    del2t = _lap_padded(sstm_p)
    # del4: second application, always no-flux in y (omlsubs.F:748-758)
    del4t = _lap_padded(_pad_t_grid(del2t))
    return rhs + d2tfac * del2t - d4tfac * del4t


def _entrain_to_p(xfo: torch.Tensor) -> torch.Tensor:
    """Average T-grid entrainment onto p points, conserving the area
    integral (omlsubs.F:158-206): edge-replicate ghosts make the
    reference's half and quarter wall and corner weights fall out of one
    4-point average."""
    xp = torch.cat([xfo[:, :1], xfo, xfo[:, -1:]], dim=1)
    xp = torch.cat([xp[:1], xp, xp[-1:]], dim=0)
    return 0.25 * (xp[:-1, :-1] + xp[:-1, 1:] + xp[1:, :-1] + xp[1:, 1:])


def _oml(model: Model, state: OceanState, forcing: OceanForcing):
    """Step the ocean mixed layer (oml, src/omlsubs.F:47-236).
    Returns (sst_new, sstm_new, entoc, xon1, cfraoc, centoc).

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

    rhs = _omladf(model, state.sst, state.sstm, state.po[0],
                  forcing.tauxo, forcing.tauyo)

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
    xfo = xfoent - coneno

    cfraoc = (dtonew > 0.0).to(sdt).mean()
    centoc = -coneno.sum() * model.grids.dxo * model.grids.dyo

    # Remove mean so net entrainment (deep-ocean heat flux) is zero
    xfo = xfo - xfo.sum() * cfg.ocnorm

    entoc = _entrain_to_p(xfo)
    xon1 = xintp(entoc) * model.grids.dxo * model.grids.dyo
    return sstnew, state.sst, entoc, xon1, cfraoc, centoc


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
                    cyclic=False, sponge=cfg.sponge.enabled)
    return qo_new, state.qo


# ----------------------------------------------------------------------
# PV inversion, box (src/ocisubs.F ocinvq:328-401)
# ----------------------------------------------------------------------

def _ocinvq(model: Model, state: OceanState, qo_new: torch.Tensor, xon1):
    """Invert PV to pressure under the box's mass constraint.

    Everything stays in spectral space until one inverse transform: the
    inhomogeneous-solution area integrals come from a Parseval
    contraction with the DST of the ones vector, and the homogeneous
    correction hclco * (1 + rdm2*sol0), with Helm(sol0) = 1, is added as
    a separable spectrum. Returns (po_new, pom_new, dpioc, dpiocp)."""
    cfg = model.cfg
    g = model.grids
    inv = model.inv_oc
    helm = inv.helm
    nlo = cfg.nlo
    tdto = 2.0 * cfg.dto
    betay = (cfg.beta * model.yporel)[None, :, None]

    # Modal vorticity RHS (8.13): wrk_m = f0 * sum_k cl2m[m,k] (q_k - by)
    ql = qo_new - betay
    ql[nlo - 1] -= model.ddyn
    wrk = cfg.fnot * torch.einsum("mk,kyx->myx", model.cl2m, ql)

    fwd = helm.forward(wrk)
    denom = helm._denom()
    xinhom = helm.norm * torch.einsum(
        "myx,y,x->m", fwd / denom, helm.gy, helm.gx) * g.dxo * g.dyo

    aient = torch.zeros_like(model.gpoc)
    aient[0] = xon1
    dpioc_new = state.dpiocp - tdto * model.gpoc * aient
    rhsum = torch.einsum("mk,m->k", inv.cdiffo, xinhom)
    hclco = inv.cdhinv @ (dpioc_new - rhsum)

    zero1 = hclco.new_zeros(1)
    coef = torch.cat([zero1, hclco * helm.rdm2[1:]])
    gyx = helm.gy[None, :, None] * helm.gx[None, None, :]
    spec = (fwd + coef[:, None, None] * gyx) / denom
    pm = helm.inverse(spec) + torch.cat([zero1, hclco])[:, None, None]
    po_new = torch.einsum("km,myx->kyx", model.cm2l, pm)
    return po_new, state.po, dpioc_new, state.dpioc


# ----------------------------------------------------------------------
# Full substep + init helpers
# ----------------------------------------------------------------------

def make_ocean_step(model: Model):
    """Build the ocean substep oml -> qgostep -> ocinvq -> ocqbdy (main
    loop q-gcm.F:1222-1255). Returns step(state, forcing) ->
    (state, OceanStepDiags)."""
    cfg = model.cfg
    dxom2 = 1.0 / model.grids.dxo**2

    def step(state: OceanState, forcing: OceanForcing):
        if cfg.no_oml:
            zero = state.po.new_zeros(())
            entoc = torch.zeros_like(state.po[0])
            sst_new, sstm_new = state.sst, state.sstm
            xon1 = cfraoc = centoc = zero
        else:
            (sst_new, sstm_new, entoc, xon1, cfraoc,
             centoc) = _oml(model, state, forcing)

        qo_new, qom_new = _qgostep(model, state, forcing, entoc)
        po_new, pom_new, dpioc, dpiocp = _ocinvq(model, state, qo_new,
                                                 xon1)
        qo_new = ocqbdy(qo_new, po_new, model.amat, model.yporel, dxom2,
                        cfg.fnot, cfg.beta, cfg.ocean.bccooc, model.ddyn,
                        cyclic=False)

        new_state = state._replace(
            po=po_new, pom=pom_new, qo=qo_new, qom=qom_new,
            sst=sst_new, sstm=sstm_new, dpioc=dpioc, dpiocp=dpiocp)
        zero = torch.zeros_like(dpioc)
        diags = OceanStepDiags(ermaso=zero, emfroc=zero, xon1=xon1,
                               cfraoc=cfraoc, centoc=centoc)
        return new_state, diags

    return step


def _as_field(model: Model, a) -> torch.Tensor:
    """A copy of an array or tensor in the model's dtype on its device."""
    return torch.as_tensor(a).to(device=model.device, dtype=model.dtype,
                                 copy=True)


def init_ocean_state(model: Model, init: str = "zero",
                     po=None, pom=None, sst=None, sstm=None) -> OceanState:
    """Initial ocean state: 'zero' (q-gcm.F zeroin:1615), 'rbal'
    (rbalin:1712 -- zero pressure, sstbar SST), or explicit arrays
    (NumPy or tensors). PV is derived from pressure (q-gcm.F:715-732),
    the mass-constraint values from `constr` (src/conhoms.F:44-199)."""
    cfg = model.cfg
    dev, dtype = model.device, model.dtype
    nlo, nypo, nxpo = cfg.nlo, cfg.nypo, cfg.nxpo
    nyto, nxto = cfg.nyto, cfg.nxto

    po = (torch.zeros((nlo, nypo, nxpo), device=dev, dtype=dtype)
          if po is None else _as_field(model, po))
    pom = po if pom is None else _as_field(model, pom)
    if sst is None:
        if init == "rbal":
            sst = _as_field(model, model.rad.sstbar)[:, None].expand(
                nyto, nxto).contiguous()
        else:
            sst = torch.zeros((nyto, nxto), device=dev, dtype=dtype)
    else:
        sst = _as_field(model, sst)
    sstm = sst if sstm is None else _as_field(model, sstm)

    dxom2 = 1.0 / model.grids.dxo**2

    def q_from_p(p):
        q = qcomp(p, model.amat, model.yporel, dxom2, cfg.fnot, cfg.beta,
                  model.ddyn, nlo - 1, cyclic=False)
        return ocqbdy(q, p, model.amat, model.yporel, dxom2, cfg.fnot,
                      cfg.beta, cfg.ocean.bccooc, model.ddyn, cyclic=False)

    area = model.grids.dxo * model.grids.dyo
    z = torch.zeros(nlo, device=dev, dtype=dtype)
    return OceanState(po=po, pom=pom, qo=q_from_p(po), qom=q_from_p(pom),
                      sst=sst, sstm=sstm,
                      dpioc=xintp(po[1:] - po[:-1]) * area,
                      dpiocp=xintp(pom[1:] - pom[:-1]) * area,
                      ocncs=z, ocncn=z, ocncsp=z, ocncnp=z)


def ocean_forcing_from_mean(model: Model, tauxo, tauyo,
                            fnetoc) -> OceanForcing:
    """Static OceanForcing for ocean_only runs from mean windstress and
    heat flux: the Ekman velocities as the ocean section of xforc
    derives them (src/xfosubs.F:568-707)."""
    cfg = model.cfg
    g = model.grids

    tauxo, tauyo, fnetoc = (_as_field(model, a)
                            for a in (tauxo, tauyo, fnetoc))
    hxofac = 0.5 / (g.dxo * cfg.fnot)
    # Ekman velocity at T points (7.7): curl of tau around the T cell
    wekto = hxofac * (
        tauyo[:-1, 1:] + tauyo[1:, 1:] - tauyo[:-1, :-1] - tauyo[1:, :-1]
        + tauxo[:-1, :-1] + tauxo[:-1, 1:] - tauxo[1:, :-1] - tauxo[1:, 1:])
    # wekpo by averaging wekto (xfosubs.F:589-646)
    wekpo = _entrain_to_p(wekto)
    zero = tauxo.new_zeros(())
    return OceanForcing(tauxo=tauxo, tauyo=tauyo, fnetoc=fnetoc,
                        wekto=wekto, wekpo=wekpo, txisoc=zero, txinoc=zero)
