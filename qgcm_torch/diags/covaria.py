"""Covariance statistics -> covar.nc (reference src/covaria_diag.F; port
of qgcm_tpu/diags/covaria.py).

The reference streams spatially-subsampled fields through an
incremental mean/SSP update and writes the packed results at the end
of the run:

- tsampl (covaria_diag.F:359-423): T-grid fields are reduced to BLOCK
  SUMS over nsi x nsi cells (no division -- the subsample vector holds
  sums).
- psampl (:431-488): p-grid fields are reduced to trapezoid-weighted
  sums over (nsi+1) x (nsi+1) point windows that share their edge
  points with the neighbouring blocks (half weights at window edges,
  quarter at corners).
- dssp (:496-600, Algorithm AS 41): streaming update of the mean
  vector and the CORRECTED sum-of-squares-and-products matrix, stored
  packed by lower triangle row-by-row (k = i(i+1)/2 + j, j <= i).
- covout (:241-357) writes covpo/covto/avgpo/avgto/swtpo/swtto (and
  atmos equivalents): the packed UNNORMALISED SSP, the mean, and the
  weight sum.

As in qgcm_tpu the update is shift-compensated: deviations d = x - x0
from the first snapshot are accumulated with their packed outer
products, and SSP = sum d_i d_j - s_i s_j / n is formed at output time.
The subsampling runs on the field's device; the accumulator lives in
float64 on the CPU, because the packed triangle outgrows a card at the
reference dimensions (57,600 ocean variables at 961^2 with nsi = 4 is
1.66e9 entries, 13 GB), and is updated in row blocks so that no index
array of the triangle's size is ever made.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BLOCK = 1 << 22     # packed entries updated per block


class CovAccum(NamedTuple):
    n: float             # count (= reference sumwt with wt=1)
    x0: torch.Tensor     # (nv,) shift vector (first snapshot), CPU f64
    s: torch.Tensor      # (nv,) running sum of (x - x0)
    ssp: torch.Tensor    # (nm,) packed lower-triangle sum of d_i d_j


def subsample_t(field: torch.Tensor, nsi: int) -> torch.Tensor:
    """Block sums over nsi x nsi T cells (tsampl), flattened row-major
    (y-major) like the reference's ivs = (js-1)*(nx/nsi) + is."""
    if nsi == 1:
        return field.reshape(-1)
    ny, nx = field.shape
    by, bx = ny // nsi, nx // nsi
    f = field[:by * nsi, :bx * nsi].reshape(by, nsi, bx, nsi)
    return f.sum(dim=(1, 3)).reshape(-1)


def _wsum(x: torch.Tensor, nsi: int, dim: int) -> torch.Tensor:
    """Overlapping-window sums of length nsi+1 with stride nsi along
    `dim`, via a cumulative sum (windows share their edge points)."""
    nb = (x.shape[dim] - 1) // nsi
    cs = torch.cumsum(x, dim=dim)
    zshape = list(x.shape)
    zshape[dim] = 1
    cs = torch.cat([x.new_zeros(zshape), cs], dim=dim)
    idx = torch.arange(nb, device=x.device) * nsi
    return cs.index_select(dim, idx + nsi + 1) - cs.index_select(dim, idx)


def subsample_p(field: torch.Tensor, nsi: int) -> torch.Tensor:
    """Trapezoid-weighted block sums over (nsi+1)^2 p-point windows
    (psampl): half weight on window-edge rows/columns, quarter at
    corners; adjacent windows share their edge points."""
    ny, nx = field.shape
    dev = field.device
    gy = torch.where(torch.arange(ny, device=dev) % nsi == 0, 0.5, 1.0
                     ).to(field.dtype)
    gx = torch.where(torch.arange(nx, device=dev) % nsi == 0, 0.5, 1.0
                     ).to(field.dtype)
    wf = field * gy[:, None] * gx[None, :]
    return _wsum(_wsum(wf, nsi, 0), nsi, 1).reshape(-1)


def cov_size(ny: int, nx: int, nsi: int, grid: str = "t") -> int:
    """Length of the subsample vector (nvcv*); for p grids the window
    count is over the ny-1 x nx-1 cell extent."""
    if grid == "p":
        return ((ny - 1) // nsi) * ((nx - 1) // nsi)
    return (ny // nsi) * (nx // nsi)


def zero_cov(nv: int) -> CovAccum:
    nm = nv * (nv + 1) // 2
    z = dict(dtype=torch.float64, device="cpu")
    return CovAccum(n=0.0, x0=torch.zeros(nv, **z), s=torch.zeros(nv, **z),
                    ssp=torch.zeros(nm, **z))


def _add_packed_outer(ssp: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """ssp + (d_i d_j for j <= i, packed row by row), in row blocks."""
    out = ssp.clone()
    nv = d.shape[0]
    r0 = 0
    while r0 < nv:
        r1 = r0 + 1
        while r1 < nv and (r1 + 1) * (r1 + 2) // 2 - r0 * (r0 + 1) // 2 \
                <= _BLOCK:
            r1 += 1
        rows = torch.arange(r0, r1)
        cols = torch.arange(r1)
        outer = d[r0:r1, None] * d[None, :r1]
        lower = cols[None, :] <= rows[:, None]
        k0, k1 = r0 * (r0 + 1) // 2, r1 * (r1 + 1) // 2
        out[k0:k1] += outer[lower]
        r0 = r1
    return out


def accumulate_cov(acc: CovAccum, field: torch.Tensor, nsi: int,
                   grid: str = "t") -> CovAccum:
    """One sample: subsample `field` on its device, copy the (nv,)
    vector to the host, update the float64 accumulator there."""
    sub = subsample_p if grid == "p" else subsample_t
    x = sub(field, nsi).cpu().to(torch.float64)
    x0 = x if acc.n == 0 else acc.x0
    d = x - x0
    return CovAccum(n=acc.n + 1.0, x0=x0, s=acc.s + d,
                    ssp=_add_packed_outer(acc.ssp, d))


def finalize_cov(acc: CovAccum):
    """-> (mean, packed SSP, sumwt) as NumPy arrays. The SSP is the
    reference's covpo/covto content: the UNNORMALISED corrected sum of
    squares and products (AS41), packed by lower triangle."""
    n = float(acc.n)
    mean = acc.x0 + acc.s / max(n, 1.0)
    ssp = acc.ssp
    if n >= 1:
        ssp = ssp - _add_packed_outer(torch.zeros_like(ssp), acc.s) / n
    return mean.numpy(), ssp.numpy(), n


def unpack_cov(packed: np.ndarray, nv: int) -> np.ndarray:
    """Packed lower triangle -> dense symmetric matrix (for analysis)."""
    out = np.zeros((nv, nv), np.float64)
    i, j = np.tril_indices(nv)
    out[i, j] = packed
    out[j, i] = packed
    return out


def write_covar(path: str, entries: dict):
    """entries: suffix -> CovAccum (suffixes 'po','to','pa','ta').
    Writes cov<sfx>, avg<sfx>, swt<sfx> in the reference covar.nc
    schema (covout, covaria_diag.F:241-357)."""
    from ..io.ncdf import make_writer as NcWriter
    w = NcWriter(path)
    w.dim("s", 1)
    dims_done = set()
    for sfx, acc in entries.items():
        mean, ssp, swt = finalize_cov(acc)
        nv = mean.shape[0]
        fluid = "at" if sfx.endswith("a") else "oc"
        nvd, nmd = f"nvcv{fluid}", f"nmcv{fluid}"
        if nvd not in dims_done:
            w.dim(nvd, nv)
            w.dim(nmd, nv * (nv + 1) // 2)
            dims_done.add(nvd)
        w.var(f"cov{sfx}", "f", (nmd,), data=ssp)
        w.var(f"avg{sfx}", "f", (nvd,), data=mean)
        w.var(f"swt{sfx}", "f", ("s",), data=np.array([swt]))
    w.close()
