"""Potential vorticity from dynamic pressure, equation 7.15 (port of
qgcm_tpu/ops/vorticity.py; reference src/vorsubs.F). Fields are
(nl, nyp, nxp).

  q = (1/f0) del^2 p + beta*y - f0 * (A @ p) [ + ddyn in layer kbot ]

qcomp fills the interior (plus the periodic meridional boundaries in
the cyclic case); ocqbdy (ocean) and atqzbd (atmosphere) fill the solid
boundaries, where the tangential derivative vanishes and the normal
derivative obeys the mixed condition.
"""

from __future__ import annotations

import torch

from .stencils import _wshift, _eshift, _row_mask, _col_mask, _pad_y, \
    _pad_xy


def _apply_amat(amat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(A @ p) over the layer axis: amat (nl, nl), p (nl, ny, nx)."""
    return torch.einsum("kl,lyx->kyx", amat, p)


def _kbot_mask(nl: int, kbot: int, p: torch.Tensor) -> torch.Tensor:
    return (torch.arange(nl, device=p.device) == (kbot % nl)).to(
        p.dtype)[:, None, None]


def qcomp(p: torch.Tensor, amat: torch.Tensor, yprel: torch.Tensor,
          dxm2: float, fnot: float, beta: float,
          ddyn: torch.Tensor, kbot: int, cyclic: bool) -> torch.Tensor:
    """PV at internal points (src/vorsubs.F:49-138; the cyclic-x case
    merqcy :142-239 by wraparound). Zonal boundary rows (and box
    meridional columns) are left zero for ocqbdy."""
    betay = (beta * yprel)[None, :, None]
    ap = _apply_amat(amat, p)
    kb = _kbot_mask(p.shape[0], kbot, p)
    if cyclic:
        pp = _pad_y(p)
        lap = dxm2 * (pp[:, :-2, :] + pp[:, 2:, :] + _wshift(p)
                      + _eshift(p) - 4.0 * p)
        edge = _row_mask(p, 0) | _row_mask(p, -1)
    else:
        pp = _pad_xy(p)
        lap = dxm2 * (pp[:, :-2, 1:-1] + pp[:, 2:, 1:-1]
                      + pp[:, 1:-1, :-2] + pp[:, 1:-1, 2:] - 4.0 * p)
        edge = (_row_mask(p, 0) | _row_mask(p, -1)
                | _col_mask(p, 0) | _col_mask(p, -1))
    q = lap / fnot + betay - fnot * ap + kb * ddyn
    return torch.where(edge, 0.0, q)


def _ddyn_row(ddyn, j):
    return ddyn if ddyn.dim() == 0 else ddyn[j, :]


def _ddyn_col(ddyn, i):
    return ddyn if ddyn.dim() == 0 else ddyn[:, i]


def _bc_rowcol(q, p, amat, yprel, bcfac_f, beta, ddyn, kbot, fnot,
               cyclic):
    """Write the mixed-BC PV bcfac_f*(p_in - p_wall) + base onto the
    wall rows (and, box case, wall columns) of a copy of q. Columns
    first so rows win the corners (the reference's loop order,
    vorsubs.F:245-388)."""
    nl = p.shape[0]
    kbv = (torch.arange(nl, device=p.device) == (kbot % nl)).to(
        p.dtype)[:, None]

    def base_row(j):
        ap = torch.einsum("kl,lx->kx", amat, p[:, j, :])
        return -fnot * ap + beta * yprel[j] + kbv * _ddyn_row(ddyn, j)

    q = q.clone()
    if not cyclic:
        def base_col(i):
            ap = torch.einsum("kl,ly->ky", amat, p[:, :, i])
            return (-fnot * ap + (beta * yprel)[None, :]
                    + kbv * _ddyn_col(ddyn, i))
        q[:, :, 0] = bcfac_f * (p[:, :, 1] - p[:, :, 0]) + base_col(0)
        q[:, :, -1] = bcfac_f * (p[:, :, -2] - p[:, :, -1]) + base_col(-1)
    q[:, 0, :] = bcfac_f * (p[:, 1, :] - p[:, 0, :]) + base_row(0)
    q[:, -1, :] = bcfac_f * (p[:, -2, :] - p[:, -1, :]) + base_row(-1)
    return q


def ocqbdy(q: torch.Tensor, p: torch.Tensor, amat: torch.Tensor,
           yprel: torch.Tensor, dxm2: float, fnot: float, beta: float,
           bcco: float, ddyn: torch.Tensor, cyclic: bool) -> torch.Tensor:
    """Oceanic solid-boundary PV (src/vorsubs.F:245-388). Topography
    lives in the BOTTOM layer (kbot = nlo-1). Fills zonal boundaries,
    and meridional boundaries too in the box case."""
    bcfac_f = bcco * dxm2 / (0.5 * bcco + 1.0) / fnot
    return _bc_rowcol(q, p, amat, yprel, bcfac_f, beta, ddyn,
                      p.shape[0] - 1, fnot, cyclic)


def atqzbd(q: torch.Tensor, p: torch.Tensor, amat: torch.Tensor,
           yprel: torch.Tensor, dxm2: float, fnot: float, beta: float,
           bcco: float, ddyn: torch.Tensor) -> torch.Tensor:
    """Atmospheric zonal-boundary PV (src/vorsubs.F:396-480). Topography
    lives in the BOTTOM layer, which for the atmosphere is layer 0.
    The reference's pa(i,2,nla) at src/vorsubs.F:470 is taken as the
    boundary row, as every analogous line has it (as qgcm_tpu does)."""
    bcfac_f = bcco * dxm2 / (0.5 * bcco + 1.0) / fnot
    return _bc_rowcol(q, p, amat, yprel, bcfac_f, beta, ddyn, 0, fnot,
                      cyclic=True)
