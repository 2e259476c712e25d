"""The PV inversions' Helmholtz solves on row blocks and on 2-D blocks, by
all_to_all pencil transposes (port of qgcm_tpu/parallel/spectral.py).

The x-transform needs whole rows and the y-transform whole columns.
Each rank holds a block of the grid (parallel/mesh.py); all_to_all
transposes hand every rank whole rows, then whole columns, and back,
moving O(N^2 / P) bytes a rank where a gather would move the whole grid.
The transforms are the single-device solvers' own (solver/helmholtz.py:
cuFFT, or the GEMM DST in its packed order under transform 'matmul', as
qgcm_tpu's spectral.py:172-181 dispatches), applied to whole axes, so the
sharded solve matches the single-device one to roundoff. On a (my, mx) mesh with P = my * mx ranks:

  ShardedBoxHelmholtz     blocks (By, Bx) -> a2a over 'x' -> x-pencils
                          (By2 / mx, mx * Bx), DST-x -> a2a over the
                          whole group in ('y', 'x') order -> y-pencils
                          (nyp, Xs / P), DST-y; the spectrum stays in
                          that layout (nm, nyi, Xs / P) for _ocinvq's
                          constraint algebra, whose Parseval sums each
                          rank takes over its columns before an
                          all_reduce; the inverse mirrors it.
  ShardedCyclicHelmholtz  blocks -> a2a over 'y' -> y-pencils, DST-y ->
                          a2a in ('x', 'y') order -> x-pencils, rfft in
                          x, divide, irfft -> the mirror transposes.

On a rows mesh (mx = 1) the transposes along the mesh's one-rank axis
are no collective, so a box solve is two all_to_alls and a channel
solve four; on a 2-D mesh a box solve is four.

Chunk order: a transpose over the whole group concatenates what it
receives in rank order, iy * mx + ix, which is ('y', 'x') order: the box
chain, whose first transpose is over 'x', needs that. The cyclic chain
transposes over 'y' first and needs ('x', 'y') order, so its chunks are
put in that order before the transpose and after it, and a rank's chunk
of the spectral rows (of lamy) is ix * my + iy (qgcm_tpu's
spectral.py:296-327). A transpose along one axis is an all_to_all over
the ranks of that axis only (Mesh.all_to_all).

Padding, qgcm_tpu's ceil-aligned scheme (its spectral.py:33-50): the
entry blocks are the mesh's ceil blocks; inside, a block's rows are
padded to By2 = pad_up(By, mx) (the box) or its columns to Bx2 =
pad_up(Bx, my) (the channel) so that an axis transpose splits them
evenly; the spectral extents are Xs = pad_up(nxi, P) (the box) and Ys =
pad_up(nyi, P) (the channel). After the whole-group transpose the
blocks' pads are dropped (by the blocks' true sizes) so that a transform
sees the axis whole and contiguous, and put back on the way out.
Transform lengths are the true extents; the padding is zero and stays
zero: the padded eigenvalues are 1.0 and the padded Parseval weights
0.0 (spectral.py:57-62), appended after the vectors in the solver's
spectral order (packed under 'matmul').
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..solver.helmholtz import BoxHelmholtz, CyclicHelmholtz

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


def _true_sizes(n: int, nb: int, b: int) -> list:
    """The true entries of each of nb ceil blocks of b of an extent n."""
    return [max(0, min(b, n - i * b)) for i in range(nb)]


def _drop_block_pads(f, dim: int, b2: int, sizes) -> torch.Tensor:
    """Blocks of b2 along dim, each end-padded -> their true entries,
    contiguous."""
    return torch.cat([f.narrow(dim, i * b2, n) for i, n in enumerate(sizes)
                      if n], dim=dim)


def _insert_block_pads(f, dim: int, b2: int, sizes) -> torch.Tensor:
    """The inverse of _drop_block_pads."""
    return torch.cat([_pad_dim(part, dim, b2) for part in
                      f.split(sizes, dim=dim)], dim=dim)


def _to_pencils(mesh, f: torch.Tensor, split: int, join: int, axis=None,
                order=None) -> torch.Tensor:
    """The all_to_all of a pencil transpose: dim `split` of f (nm, a, b)
    is cut into one chunk a rank along `axis` (Mesh.axis_ranks; None:
    the whole group), chunk k to the k-th rank, and what comes back is
    joined along dim `join`. `order` lists, for each chunk position of
    the join, the rank (index into the axis) it comes from, and for each
    chunk of the split the rank it goes to: qgcm_tpu's group order where
    it is not the axis' own."""
    k = len(mesh.axis_ranks(axis))
    nm, a, b = f.shape
    if split == 1:
        t = f.reshape(nm, k, a // k, b).permute(1, 0, 2, 3)
    else:
        t = f.reshape(nm, a, k, b // k).permute(2, 0, 1, 3)
    if order is not None:
        t = t[_inverse(order)]
    t = mesh.all_to_all(t.contiguous(), A2A, axis)
    if order is not None:
        t = t[order]
    # t: (k, nm, rows, cols) of the k senders
    if join == 1:
        return t.permute(1, 0, 2, 3).reshape(nm, -1, t.shape[-1])
    return t.permute(1, 2, 0, 3).reshape(nm, t.shape[2], -1)


def _inverse(order):
    inv = [0] * len(order)
    for k, r in enumerate(order):
        inv[r] = k
    return inv


def _rows_to_cols(mesh, f: torch.Tensor) -> torch.Tensor:
    """(nm, r, P*c) pencils of rows -> (nm, P*r, c) pencils of columns
    over the whole group: chunk i of the columns goes to rank i, which
    stacks the ranks' rows in rank order."""
    return _to_pencils(mesh, f, 2, 1)


def _cols_to_rows(mesh, f: torch.Tensor) -> torch.Tensor:
    """The inverse of _rows_to_cols: (nm, P*r, c) -> (nm, r, P*c)."""
    return _to_pencils(mesh, f, 1, 2)


class ShardedBoxHelmholtz:
    """BoxHelmholtz on blocks (qgcm_tpu's spectral.py:136): the attributes
    _ocinvq reads (norm, rdm2, gx, gy, _denom, forward, inverse, solve),
    with the spectrum in the y-pencil layout (nm, nyi, Xs / P) and gx and
    the denominator this rank's chunk of it."""

    def __init__(self, base: BoxHelmholtz, mesh):
        self.base, self.mesh = base, mesh
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nxi, self.nyi = base.nxp - 2, base.nyp - 2
        self.by = mesh.block(self.nyp, "y")
        self.bx = mesh.block(self.nxp, "x")
        self.by2 = _pad_up(self.by, mesh.mx)
        self.ysizes = _true_sizes(self.nyp, mesh.my, self.by)
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
        """(nm, by, bx) blocks -> this rank's spectral chunk
        (nm, nyi, Xs / P)."""
        mesh = self.mesh
        if mesh.mx > 1:      # x-pencils of By2 / mx rows of the block
            rhs = _to_pencils(mesh, _pad_dim(rhs, -2, self.by2), 1, 2, "x")
        b = self.base.xdst(rhs[..., 1:1 + self.nxi])
        c = _rows_to_cols(mesh, _pad_dim(b, -1, self.xs))
        if mesh.mx > 1:
            c = _drop_block_pads(c, -2, self.by2, self.ysizes)
        return self.base.ydst(c[..., 1:1 + self.nyi, :])

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """Spectral chunk -> (nm, by, bx) blocks with zero walls and
        padding, scaled by norm."""
        mesh = self.mesh
        c = self.base.iydst(spec)
        if mesh.mx > 1:
            c = _insert_block_pads(_pad_dim(c, -2, self.nyp, 1), -2,
                                   self.by2, self.ysizes)
        else:
            c = _pad_dim(c, -2, mesh.size * self.by, 1)
        b = _cols_to_rows(mesh, c)
        sol = self.base.ixdst(b[..., :self.nxi]) * self.norm
        # the walls' and the padding's zeros: the inverse DST leaves
        # zeros in the rows that were zero on the way in
        if mesh.mx == 1:
            return _pad_dim(sol, -1, self.nxp, 1)
        sol = _pad_dim(sol, -1, mesh.mx * self.bx, 1)
        return _to_pencils(mesh, sol, 2, 1, "x")[:, :self.by]

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.inverse(self.forward(rhs) / self._denom())


class ShardedCyclicHelmholtz:
    """CyclicHelmholtz on blocks (qgcm_tpu's spectral.py:259): solve()
    only, as the inversions need. The east column comes out equal to the
    west one bit for bit."""

    def __init__(self, base: CyclicHelmholtz, mesh):
        self.base, self.mesh = base, mesh
        my, mx = mesh.my, mesh.mx
        self.nxp, self.nyp = base.nxp, base.nyp
        self.nx, self.nyi = base.nxp - 1, base.nyp - 2
        self.by = mesh.block(self.nyp, "y")
        self.bx = mesh.block(self.nxp, "x")
        # a rows mesh pads the whole width to a multiple of the ranks,
        # a 2-D mesh each column block to a multiple of my
        self.bx2 = _pad_up(self.bx, my)
        self.xsizes = _true_sizes(self.nxp, mx, self.bx)
        self.ys = _pad_up(self.nyi, mesh.size)
        # ('x', 'y') order: group index k is rank (k % my) * mx + k // my
        self.order = (None if mx == 1 else
                      [(k % my) * mx + k // my for k in range(mesh.size)])
        yc = self.ys // mesh.size
        r = mesh.ix * my + mesh.iy
        sl = slice(r * yc, (r + 1) * yc)
        self.norm = base.norm
        lamy = _pad_vec(base.lamy, self.ys, 1.0)[sl]
        self.denom = (base.lamx[None, None, :] + lamy[None, :, None]
                      - base.rdm2[:, None, None])

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """(nm, by, bx) blocks -> the solution's blocks, zero on the walls
        and the padding."""
        mesh, nyi, mx = self.mesh, self.nyi, self.mesh.mx
        b = _to_pencils(mesh, _pad_dim(rhs, -1, self.bx2), 2, 1, "y")
        sy = _pad_dim(self.base.ydst(b[..., 1:1 + nyi, :]), -2, self.ys)
        c = _to_pencils(mesh, sy, 1, 2, order=self.order)
        if mx > 1:
            c = _drop_block_pads(c, -1, self.bx2, self.xsizes)
        spec = torch.fft.rfft(c[..., :self.nx], dim=-1) / self.denom
        sy = torch.fft.irfft(spec, n=self.nx, dim=-1)
        sy = torch.cat([sy, sy[..., :1]], dim=-1)
        sy = (_insert_block_pads(sy, -1, self.bx2, self.xsizes) if mx > 1
              else _pad_dim(sy, -1, self.bx2))
        d = _to_pencils(mesh, sy, 2, 1, order=self.order)
        sol = self.base.iydst(d[..., :nyi, :]) * self.norm
        e = _to_pencils(mesh, _pad_dim(sol, -2, mesh.my * self.by, 1), 1, 2,
                        "y")
        return e[..., :self.bx]


def wrap_inversions(model, mesh):
    """A Model whose PV inversions solve on blocks through the pencil
    transposes above (spectral.py:340): the ocean's on the blocks of
    `mesh`, the atmosphere's on its rows mesh (parallel/mesh.atmos_mesh),
    as qgcm_tpu wraps both. The constraint algebra around them is
    models/ocean.py's and models/atmos.py's."""
    from .mesh import atmos_mesh
    inv_oc, inv_at = model.inv_oc, model.inv_at
    if inv_oc is not None:
        helm = inv_oc.helm
        wrapped = (ShardedCyclicHelmholtz(helm, mesh)
                   if isinstance(helm, CyclicHelmholtz)
                   else ShardedBoxHelmholtz(helm, mesh))
        inv_oc = dataclasses.replace(inv_oc, helm=wrapped)
    if inv_at is not None:
        inv_at = dataclasses.replace(inv_at, helm=ShardedCyclicHelmholtz(
            inv_at.helm, atmos_mesh(mesh, model.cfg)))
    return dataclasses.replace(model, inv_oc=inv_oc, inv_at=inv_at)
