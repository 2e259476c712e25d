"""Finite-difference stencils on the C-grid p-array (port of
qgcm_tpu/ops/stencils.py).

Fields are [..., y, x]; a p-grid field has shape (..., nyp, nxp). In
the cyclic (channel) case column nxp-1 duplicates column 0. Boundary
conditions are applied with row/column masks on full-size shifted
expressions, as in the JAX package.

Reference semantics:
  del2_bc     -- src/qgosubs.F:94-127 (mixed BCs via bcfac, or cyclic-x)
  jacobian9   -- Arakawa 9-point energy/enstrophy-conserving J(q,p),
                 src/qgosubs.F:374-389 (interior), :354-368 (cyclic west)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _wshift(f: torch.Tensor) -> torch.Tensor:
    """x-west neighbour for a cyclic p-array (column -1 duplicates 0):
    west of column 0 is column nx-2 (= nxp-2)."""
    return torch.cat([f[..., -2:-1], f[..., :-1]], dim=-1)


def _eshift(f: torch.Tensor) -> torch.Tensor:
    """x-east neighbour for a cyclic p-array: east of column nxp-1
    (duplicate of 0) is column 1."""
    return torch.cat([f[..., 1:], f[..., 1:2]], dim=-1)


def _row_mask(f: torch.Tensor, j: int) -> torch.Tensor:
    """Boolean (ny, 1) mask selecting row j (negative ok)."""
    ny = f.shape[-2]
    return (torch.arange(ny, device=f.device) == (j % ny))[:, None]


def _col_mask(f: torch.Tensor, i: int) -> torch.Tensor:
    """Boolean (1, nx) mask selecting column i (negative ok)."""
    nx = f.shape[-1]
    return (torch.arange(nx, device=f.device) == (i % nx))[None, :]


def _pad_y(f: torch.Tensor) -> torch.Tensor:
    """One zero ghost row on each side."""
    return F.pad(f, (0, 0, 1, 1))


def _pad_xy(f: torch.Tensor) -> torch.Tensor:
    """One zero ghost ring."""
    return F.pad(f, (1, 1, 1, 1))


def del2_bc(p: torch.Tensor, bcfac: float, dxm2: float,
            cyclic: bool) -> torch.Tensor:
    """Laplacian of a p-field with mixed boundary conditions.

    On solid boundaries the tangential second derivative vanishes and
    the normal second derivative is the mixed condition
    bcfac*(p_inner - p_wall) (src/qgosubs.F:96-126). Box: all four
    walls solid, the S/N rows winning at the corners. Cyclic: W/E
    periodic, N/S solid. Ghost values feed only masked points, so zero
    ghosts give the same result as the JAX package's edge padding.
    """
    if cyclic:
        pw, pe = _wshift(p), _eshift(p)
        pp = _pad_y(p)
        ps, pn = pp[..., :-2, :], pp[..., 2:, :]
        lap = dxm2 * (ps + pn + pw + pe - 4.0 * p)
        out = lap
    else:
        pp = _pad_xy(p)
        ps, pn = pp[..., :-2, 1:-1], pp[..., 2:, 1:-1]
        pw, pe = pp[..., 1:-1, :-2], pp[..., 1:-1, 2:]
        lap = dxm2 * (ps + pn + pw + pe - 4.0 * p)
        out = torch.where(_col_mask(p, 0), bcfac * (pe - p),
                          torch.where(_col_mask(p, -1), bcfac * (pw - p),
                                      lap))
    return torch.where(_row_mask(p, 0), bcfac * (pn - p),
                       torch.where(_row_mask(p, -1), bcfac * (ps - p), out))


def jacobian9(q: torch.Tensor, p: torch.Tensor,
              cyclic: bool) -> torch.Tensor:
    """Arakawa 9-point Jacobian sum J(q,p)*(12 dx dy) (unscaled; multiply
    by adfac = 1/(12 dx dy f0) for the PV tendency contribution).

    Interior formula src/qgosubs.F:378-388. Zonal boundary rows are left
    zero; in the box the W/E columns are zero too, in the cyclic case
    they use wraparound. Output has the same shape as q/p.
    """
    if cyclic:
        def nbrs(f):
            fp = _pad_y(f)
            fn, fs = fp[..., 2:, :], fp[..., :-2, :]
            return (_eshift(f), _wshift(f), fn, fs,
                    _eshift(fn), _wshift(fn), _eshift(fs), _wshift(fs))
    else:
        def nbrs(f):
            fp = _pad_xy(f)
            return (fp[..., 1:-1, 2:], fp[..., 1:-1, :-2],
                    fp[..., 2:, 1:-1], fp[..., :-2, 1:-1],
                    fp[..., 2:, 2:], fp[..., 2:, :-2],
                    fp[..., :-2, 2:], fp[..., :-2, :-2])

    qe, qw, qn, qs, qne, qnw, qse, qsw = nbrs(q)
    pe, pw, pn, ps, pne, pnw, pse, psw = nbrs(p)
    jac = (
        (qe - qw) * (pn - ps)
        + (qs - qn) * (pe - pw)
        + qe * (pne - pse)
        - qw * (pnw - psw)
        - qn * (pne - pnw)
        + qs * (pse - psw)
        + pn * (qne - qnw)
        - ps * (qse - qsw)
        - pe * (qne - qse)
        + pw * (qnw - qsw)
    )
    edge = _row_mask(q, 0) | _row_mask(q, -1)
    if not cyclic:
        edge = edge | _col_mask(q, 0) | _col_mask(q, -1)
    return torch.where(edge, 0.0, jac)
