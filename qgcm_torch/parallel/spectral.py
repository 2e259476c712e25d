"""The PV inversions' Helmholtz solves on row blocks, by all_to_all
pencil transposes (port of qgcm_tpu/parallel/spectral.py, rows meshes).

The x-transform needs whole rows and the y-transform whole columns.
Each rank holds a block of rows (parallel/mesh.py); an
`all_to_all_single` hands every rank a block of columns over the whole
height and back, moving O(N^2 / P) bytes a rank where a gather would
move the whole grid. The transforms are the single-device solvers' own
(solver/helmholtz.py: cuFFT, or a float32 channel's y-DST as a GEMM with
the sine matrix), applied to whole axes, so the sharded solve matches
the single-device one to roundoff.

  ShardedBoxHelmholtz     DST-x on row blocks -> a2a -> DST-y on column
                          blocks; the spectrum stays in that layout
                          (nm, nyi, Xs / P) for _ocinvq's constraint
                          algebra, whose Parseval sums each rank takes
                          over its columns before an all_reduce; the
                          inverse mirrors it.
  ShardedCyclicHelmholtz  a2a -> DST-y on column blocks -> a2a -> rfft in
                          x, divide, irfft on row chunks -> a2a -> DST-y
                          -> a2a back to row blocks.

Transform lengths are the true extents; the padding the transposes need
(rows up to P * by, spectral columns up to Xs = P * ceil(nxi / P), or
spectral rows up to Ys) is zero and stays zero: the padded eigenvalues
are 1.0 and the padded Parseval weights 0.0 (spectral.py:57-62). The
2-D pencils of a mesh with x > 1 are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..solver.helmholtz import BoxHelmholtz, CyclicHelmholtz, dst1

A2A = "spectral.a2a"


def _pad_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _pad_vec(v: torch.Tensor, target: int, fill: float) -> torch.Tensor:
    return F.pad(v, (0, target - v.shape[0]), value=fill)


def _pad_dim(f: torch.Tensor, dim: int, target: int, offset: int = 0):
    """f embedded at `offset` in zeros of extent `target` along dim."""
    n = f.shape[dim]
    pads = [0, 0] * (f.dim() - dim % f.dim() - 1) + [offset,
                                                      target - offset - n]
    return F.pad(f, pads)


def _rows_to_cols(mesh, f: torch.Tensor) -> torch.Tensor:
    """(nm, by, P*c) row blocks -> (nm, P*by, c) column chunks: chunk i of
    the columns goes to rank i, which stacks the ranks' rows in order."""
    nm, by, w = f.shape
    p = mesh.size
    t = f.reshape(nm, by, p, w // p).permute(2, 0, 1, 3).contiguous()
    t = mesh.all_to_all(t, A2A)
    return t.permute(1, 0, 2, 3).reshape(nm, p * by, w // p)


def _cols_to_rows(mesh, f: torch.Tensor) -> torch.Tensor:
    """The inverse of _rows_to_cols: (nm, P*by, c) -> (nm, by, P*c)."""
    nm, h, c = f.shape
    p = mesh.size
    t = f.reshape(nm, p, h // p, c).permute(1, 0, 2, 3).contiguous()
    t = mesh.all_to_all(t, A2A)
    return t.permute(1, 2, 0, 3).reshape(nm, h // p, p * c)


def _check_rows(mesh):
    if mesh.mx != 1:
        raise NotImplementedError(
            "the sharded solvers take rows meshes (x = 1); the 2-D pencil "
            "transposes of an x > 1 mesh are not ported yet")


class ShardedBoxHelmholtz:
    """BoxHelmholtz on row blocks (spectral.py:136): the attributes
    _ocinvq reads (norm, rdm2, gx, gy, _denom, forward, inverse, solve),
    with the spectrum in the column-chunk layout (nm, nyi, Xs / P) and gx
    and the denominator this rank's chunk of it."""

    def __init__(self, base: BoxHelmholtz, mesh):
        _check_rows(mesh)
        self.base, self.mesh = base, mesh
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nxi, self.nyi = base.nxp - 2, base.nyp - 2
        self.by = mesh.block(self.nyp, "y")
        self.xs = _pad_up(self.nxi, mesh.size)
        xc = self.xs // mesh.size
        sl = slice(mesh.rank * xc, (mesh.rank + 1) * xc)
        self.norm, self.rdm2 = base.norm, base.rdm2
        self.lamy, self.gy = base.lamy, base.gy
        # x-side vectors padded to Xs: lamx with 1.0 (the denominator
        # stays nonzero), gx with 0.0 (the padding leaves the Parseval
        # sums alone); this rank keeps its chunk
        self.lamx = _pad_vec(base.lamx, self.xs, 1.0)[sl]
        self.gx = _pad_vec(base.gx, self.xs, 0.0)[sl]

    def _denom(self) -> torch.Tensor:
        return (self.lamx[None, None, :] + self.lamy[None, :, None]
                - self.rdm2[:, None, None])

    def forward(self, rhs: torch.Tensor) -> torch.Tensor:
        """(nm, by, nxp) row blocks -> this rank's spectral chunk
        (nm, nyi, Xs / P)."""
        b = dst1(rhs[..., 1:1 + self.nxi], dim=-1)
        c = _rows_to_cols(self.mesh, _pad_dim(b, -1, self.xs))
        return dst1(c[..., 1:1 + self.nyi, :], dim=-2)

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """Spectral chunk -> (nm, by, nxp) row blocks with zero walls and
        padding, scaled by norm."""
        c = _pad_dim(dst1(spec, dim=-2), -2, self.mesh.size * self.by, 1)
        b = _cols_to_rows(self.mesh, c)
        sol = dst1(b[..., :self.nxi], dim=-1) * self.norm
        sol = _pad_dim(sol, -1, self.nxp, 1)
        # the walls' and the padding rows' zeros: the inverse DST leaves
        # zeros in the rows that were zero on the way in
        return sol

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.inverse(self.forward(rhs) / self._denom())


class ShardedCyclicHelmholtz:
    """CyclicHelmholtz on row blocks (spectral.py:259): solve() only, as
    the inversions need. The east column comes out equal to the west one
    bit for bit."""

    def __init__(self, base: CyclicHelmholtz, mesh):
        _check_rows(mesh)
        self.base, self.mesh = base, mesh
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nx, self.nyi = base.nxp - 1, base.nyp - 2
        self.by = mesh.block(self.nyp, "y")
        self.bx2 = _pad_up(self.nxp, mesh.size)
        self.ys = _pad_up(self.nyi, mesh.size)
        yc = self.ys // mesh.size
        sl = slice(mesh.rank * yc, (mesh.rank + 1) * yc)
        self.norm = base.norm
        lamy = _pad_vec(base.lamy, self.ys, 1.0)[sl]
        self.denom = (base.lamx[None, None, :] + lamy[None, :, None]
                      - base.rdm2[:, None, None])

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """(nm, by, nxp) row blocks -> the solution's row blocks, zero on
        the walls and the padding rows."""
        mesh, nyi = self.mesh, self.nyi
        b = _rows_to_cols(mesh, _pad_dim(rhs, -1, self.bx2))
        sy = _pad_dim(self.base._ydst(b[..., 1:1 + nyi, :]), -2, self.ys)
        c = _cols_to_rows(mesh, sy)[..., :self.nx]
        spec = torch.fft.rfft(c, dim=-1) / self.denom
        sy = torch.fft.irfft(spec, n=self.nx, dim=-1)
        sy = torch.cat([sy, sy[..., :1]], dim=-1)
        d = _rows_to_cols(mesh, _pad_dim(sy, -1, self.bx2))
        sol = self.base._ydst(d[..., :nyi, :]) * self.norm
        e = _cols_to_rows(mesh, _pad_dim(sol, -2, mesh.size * self.by, 1))
        return e[..., :self.nxp]


def wrap_inversions(model, mesh):
    """A Model whose ocean PV inversion solves on row blocks of `mesh`
    through the pencil transposes above (spectral.py:340); the constraint
    algebra around it is models/ocean.py's. The decomposed runner is
    ocean-only, so the atmosphere's inversion is left as it is."""
    helm = model.inv_oc.helm
    wrapped = (ShardedCyclicHelmholtz(helm, mesh)
               if isinstance(helm, CyclicHelmholtz)
               else ShardedBoxHelmholtz(helm, mesh))
    return dataclasses.replace(
        model, inv_oc=dataclasses.replace(model.inv_oc, helm=wrapped))
