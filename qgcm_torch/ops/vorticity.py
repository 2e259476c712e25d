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
               cyclic, r0=0, ny=None, south=None, north=None, c0=0,
               nx=None, west=None, east=None):
    """Write the mixed-BC PV bcfac_f*(p_in - p_wall) + base onto the
    wall rows (and, box case, wall columns) of a copy of q. Columns
    first so rows win the corners (the reference's loop order,
    vorsubs.F:245-388).

    On a block (r0, ny: the block's first global row and the grid's
    height; c0, nx the same for columns; yprel and ddyn the block's
    rows and columns) only the walls the block holds are written;
    `south`/`north` are the (nl, ncols) p rows just outside it and
    `west`/`east` the (nl, nrows) p columns, read where a wall's inner
    neighbour lies in the next block."""
    nl, nrows, ncols = p.shape
    ny = nrows if ny is None else ny
    nx = ncols if nx is None else nx
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
        lo, hi = -c0, nx - 1 - c0          # the walls' columns in the block
        if 0 <= lo < ncols:
            inner = p[:, :, lo + 1] if lo + 1 < ncols else east
            q[:, :, lo] = bcfac_f * (inner - p[:, :, lo]) + base_col(lo)
        if 0 <= hi < ncols:
            inner = p[:, :, hi - 1] if hi >= 1 else west
            q[:, :, hi] = bcfac_f * (inner - p[:, :, hi]) + base_col(hi)
    lo, hi = -r0, ny - 1 - r0              # the walls' rows in the block
    if 0 <= lo < nrows:
        inner = p[:, lo + 1, :] if lo + 1 < nrows else north
        q[:, lo, :] = bcfac_f * (inner - p[:, lo, :]) + base_row(lo)
    if 0 <= hi < nrows:
        inner = p[:, hi - 1, :] if hi >= 1 else south
        q[:, hi, :] = bcfac_f * (inner - p[:, hi, :]) + base_row(hi)
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


def ocqbdy_block(q, p, amat, yprel, dxm2, fnot, beta, bcco, ddyn, cyclic,
                 r0: int, ny: int, south=None, north=None, c0: int = 0,
                 nx: int = None, west=None, east=None):
    """ocqbdy on a block of a decomposed run: q and p hold rows r0, r0+1,
    ... of a grid ny rows tall and, with `nx`, columns c0, c0+1, ... of
    its nx (without, every column); yprel and ddyn the same rows and
    columns. The walls exist on the end blocks only; in the box the
    corners belong to the zonal rows, as in ocqbdy. `south`/`north` are
    the p rows just outside the block and `west`/`east` its columns,
    needed only where a wall is the block's first or last row or column
    and its inner neighbour lies in the next block."""
    bcfac_f = bcco * dxm2 / (0.5 * bcco + 1.0) / fnot
    return _bc_rowcol(q, p, amat, yprel, bcfac_f, beta, ddyn,
                      p.shape[0] - 1, fnot, cyclic, r0=r0, ny=ny,
                      south=south, north=north, c0=c0, nx=nx, west=west,
                      east=east)


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


def atqzbd_block(q, p, amat, yprel, dxm2, fnot, beta, bcco, ddyn,
                 r0: int, ny: int, south=None, north=None):
    """atqzbd on a row block of a decomposed run: q and p hold rows r0,
    r0+1, ... of a grid ny rows tall, every column; yprel and ddyn the
    same rows. `south`/`north` are the p rows just outside the block,
    needed only where a wall is the block's first or last row and its
    inner neighbour lies in the next block."""
    bcfac_f = bcco * dxm2 / (0.5 * bcco + 1.0) / fnot
    return _bc_rowcol(q, p, amat, yprel, bcfac_f, beta, ddyn, 0, fnot,
                      cyclic=True, r0=r0, ny=ny, south=south, north=north)
