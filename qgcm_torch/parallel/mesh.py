"""Row and column blocks of a decomposed grid, and their collectives
(port of qgcm_tpu/parallel/mesh.py).

qgcm_tpu lays its fields over a ('y', 'x') device mesh and lets GSPMD
insert the halo exchanges and transposes. PyTorch has no partitioner, so
here each rank of a torch.distributed process group holds one block of
every grid field and calls the collectives itself: exchanges of ghost
rows (y) and columns (x) with its neighbours, `all_reduce` of sums, and
`all_to_all_single` for the spectral transposes (parallel/spectral.py),
over the whole group or along one mesh axis.

Ranks are laid out row-major over (my, mx): rank = iy * mx + ix, row
block iy counting northwards, which is qgcm_tpu's ('y', 'x') chunk
order. Blocks are ceil blocks, as qgcm_tpu's (spectral.py:33-50): rank
(iy, ix) of a grid (ny, nx) holds rows [iy*by, iy*by + by) and columns
[ix*bx, ix*bx + bx) with by = ceil(ny / my), bx = ceil(nx / mx); the
rows and columns past the grid's end are padding, zero on input and kept
zero by every stage. The ocean's T-grid (nyp - 1 rows, nxp - 1 columns)
takes the p-grid's blocks: T row j sits between p rows j and j + 1, T
column i between p columns i and i + 1. On a rows mesh (mx = 1) every
field keeps its own columns. The atmosphere of a decomposed run has a
mesh of its own (atmos_mesh): row blocks of its grid over all the
ranks, whatever the ocean's mesh's shape; so has the ocean grid of a
channel or an atmosphere-only case on a mesh with x > 1 (ocean_mesh).

An all_to_all along one axis (the ranks of a mesh row, or of a mesh
column) is one all_to_all_single over the whole group whose chunks for
the ranks off that axis are empty: no group is made per mesh row, so a
mesh costs no collective to make and a mesh of a subgroup needs nothing
of the ranks outside it (torch.distributed.new_group is collective over
the whole world). gloo and NCCL both take uneven split sizes.

With the gloo backend and CUDA tensors every collective stages its
tensors through pinned host memory (gloo moves host memory); with NCCL
it does not. `counts` counts the collectives by call site, as
ops.qgstep counts kernel launches; an exchange of ghosts counts one for
each direction, as qgcm_tpu's collective-permutes do. `staged_bytes`
counts the bytes copied to and from the host for the collectives.
qgcm_tpu's HLO census of collectives (parallel/inspect.py) has no
counterpart here; these counts take its place.

Autograd sees through every collective (the distributed adjoint,
adjoint.py), where it records one: an input that requires grad under
grad mode. The rules take one convention for a tensor every rank holds
the same (a replicated tensor): the cotangent a rank holds of it is
that rank's part, and its whole cotangent is the sum over the ranks.
So the backward of `all_reduce` is the all_reduce of the cotangent;
that of `all_to_all` the same all_to_all (with equal chunks its own
transpose); that of `all_gather` (and of `gather`) the sum over the
ranks of each rank's cotangent of this rank's chunk, one all_to_all;
that of an exchange of ghosts a reverse exchange, each neighbour adding
the ghosts' cotangent to that of the rows or columns it sent (the walls
received zeros and send nothing back). A value every rank computes the
same from replicated inputs (a loss of a gathered state) is therefore
differentiated with its cotangent seeded on one rank, and the gradient
of a replicated input is the all_reduce of its ranks' gradients
(adjoint.py does both). The backward's collectives are counted under
the site's name with ".T" appended. Each rule's backward first unpacks
what its forward saved, so that a checkpointed region is recomputed
(its forward collectives replayed) before any of its backward
collectives, on every rank alike. Each rank decides by its own input
whether a collective takes its rule, so a call site must make that
input from the differentiated values on every rank, a rank whose share
is zeros too (torch.where on what it holds, not a fresh zero tensor):
else the ranks that record issue a backward collective that the others
never match. Likewise autograd runs a rule's backward only on a rank
whose differentiated value its output reaches, so a collective's output
must reach it on every rank: a rank that receives ghosts it does not
read reads its block back through them (models/ocean.boundary_ghosts).
Then every rank runs the backward's collectives in the same order, the
reverse of the forward's.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..state import T_COL_FIELDS, T_GRID_FIELDS


def _ceil_div(n: int, d: int) -> int:
    return -(-n // d)


class Mesh:
    """A (my, mx) layout of the ranks of the default process group (one
    rank when none is initialised), or of `group`, a group of it that
    holds this rank; this rank's (iy, ix), and, when made for a grid
    (ny, nx) -- the ocean's p-grid -- its block sizes (by, bx)."""

    def __init__(self, shape, grid=None, group=None, tally=None):
        self.my, self.mx = shape
        self.group = group
        if dist.is_initialized():
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        else:
            self.size, self.rank, self.backend = 1, 0, None
        if self.my * self.mx != self.size:
            raise ValueError(f"a {self.my}x{self.mx} mesh needs "
                             f"{self.my * self.mx} ranks, the group has "
                             f"{self.size}")
        self.iy, self.ix = divmod(self.rank, self.mx)
        self.grid = None if grid is None else tuple(grid)
        if self.grid is not None:
            self.by = self.block(self.grid[0], "y")
            self.bx = self.block(self.grid[1], "x")
        # the collective counts and staged bytes, shared with the mesh
        # `tally` when given (atmos_mesh's)
        self.counts = Counter() if tally is None else tally.counts
        self._staged = [0] if tally is None else tally._staged
        self._atmos = self._rows = None

    @property
    def staged_bytes(self) -> int:
        return self._staged[0]

    @staged_bytes.setter
    def staged_bytes(self, n: int):
        self._staged[0] = n

    def block(self, n: int, axis: str) -> int:
        """The ceil block of an extent n over the mesh axis 'y' or 'x'."""
        return _ceil_div(n, self.my if axis == "y" else self.mx)

    def _peer(self, dy: int, dx: int):
        """The global rank of the neighbour (iy + dy, ix + dx), or
        None."""
        iy, ix = self.iy + dy, self.ix + dx
        if not (0 <= iy < self.my and 0 <= ix < self.mx):
            return None
        peer = iy * self.mx + ix
        return (peer if self.group is None
                else dist.get_global_rank(self.group, peer))

    # -- staging ------------------------------------------------------
    @property
    def stages(self) -> bool:
        return self.backend == "gloo"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """t as a contiguous tensor the backend can move: a pinned host
        copy of a CUDA tensor under gloo (the caller synchronises before
        the backend reads it), else t itself."""
        if not (self.stages and t.is_cuda):
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        self.staged_bytes += t.numel() * t.element_size()
        return h

    def _recv_buffer(self, like: torch.Tensor, shape) -> torch.Tensor:
        if self.stages and like.is_cuda:
            self.staged_bytes += math.prod(shape) * like.element_size()
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _sync(self, t: torch.Tensor):
        if self.stages and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device, non_blocking=True)

    # -- collectives ------------------------------------------------
    def all_reduce(self, t: torch.Tensor, site: str) -> torch.Tensor:
        """The sum of t over the ranks (a new tensor)."""
        if _records(t):
            return _AllReduce.apply(t, self, site)
        return self._all_reduce(t, site)

    def _all_reduce(self, t: torch.Tensor, site: str) -> torch.Tensor:
        self.counts[site] += 1
        if self.size == 1:
            return t.clone()
        h = self._host(t)
        if h.device != t.device:
            self.staged_bytes += t.numel() * t.element_size()
        else:
            h = h.clone()
        self._sync(t)
        dist.all_reduce(h, group=self.group)
        return self._back(h, t) if h.device != t.device else h

    def axis_ranks(self, axis=None) -> list:
        """The mesh ranks along `axis` through this rank, in order: 'x'
        the ranks of its mesh row, 'y' those of its mesh column, None
        all of them."""
        if axis is None:
            return list(range(self.size))
        if axis == "x":
            return [self.iy * self.mx + j for j in range(self.mx)]
        return [i * self.mx + self.ix for i in range(self.my)]

    def all_to_all(self, t: torch.Tensor, site: str,
                   axis=None) -> torch.Tensor:
        """all_to_all_single over dim 0 of t, whose extent is the number
        of ranks along `axis` (axis_ranks): chunk k goes to the k-th of
        them, and chunk k of the result came from it. Along an axis of
        one rank it is no collective, and is not counted."""
        if _records(t):
            return _AllToAll.apply(t, self, site, axis)
        return self._all_to_all(t, site, axis)

    def _all_to_all(self, t: torch.Tensor, site: str,
                    axis=None) -> torch.Tensor:
        peers = self.axis_ranks(axis)
        if axis is not None and len(peers) == 1:
            return t.clone()
        self.counts[site] += 1
        if len(peers) == 1:
            return t.clone()
        h = self._host(t)
        out = self._recv_buffer(t, t.shape)
        self._sync(t)
        if len(peers) == self.size:
            dist.all_to_all_single(out, h, group=self.group)
        else:
            # chunks of one dim-0 row for the axis' ranks, empty for the
            # rest of the group
            mine = set(peers)
            splits = [int(r in mine) for r in range(self.size)]
            dist.all_to_all_single(out, h, splits, splits, group=self.group)
        return self._back(out, t) if out.device != t.device else out

    def all_gather(self, t: torch.Tensor, site: str) -> list:
        """[t of rank 0, t of rank 1, ...]: every rank's t."""
        if self.size > 1 and _records(t):
            return list(_AllGather.apply(t, self, site))
        return self._all_gather(t, site)

    def _all_gather(self, t: torch.Tensor, site: str) -> list:
        self.counts[site] += 1
        if self.size == 1:
            return [t]
        h = self._host(t)
        outs = [self._recv_buffer(t, t.shape) for _ in range(self.size)]
        self._sync(t)
        dist.all_gather(outs, h, group=self.group)
        return [self._back(o, t) if o.device != t.device else o
                for o in outs]

    def start_exchange(self, f: torch.Tensor, h: int, axis: str,
                       site: str) -> "Exchange":
        """Post the exchange of h ghost rows (axis 'y', dim -2) or columns
        ('x', dim -1) of the block f with its two neighbours along that
        axis, as qgcm_tpu's ppermute pair (halo.py:_exchange): this
        block's last h rows go north (to iy + 1), its first h rows south.
        Returns an Exchange whose wait() gives (south, north) ghosts, or
        (west, east) for 'x'; the ends of the domain receive zeros (the
        wall convention, halo.py:33-35). Under autograd the rule spans
        the post and the wait (the ghosts come out of wait())."""
        self.counts[site] += 2
        dim = -2 if axis == "y" else -1
        ex = self._post(f.narrow(dim, 0, h),
                        f.narrow(dim, f.shape[dim] - h, h), axis, f)
        if _records(f):
            ex.rule = (self, f, axis, h, site)
        return ex

    def _post(self, lo: torch.Tensor, hi: torch.Tensor, axis: str,
              like: torch.Tensor) -> "Exchange":
        """Send lo to the neighbour below along `axis` and hi to the one
        above, and post the receipt of theirs (of lo's shape)."""
        lo_peer = self._peer(-1, 0) if axis == "y" else self._peer(0, -1)
        hi_peer = self._peer(1, 0) if axis == "y" else self._peer(0, 1)
        shape = list(lo.shape)
        ops, recvs, sends = [], {}, []
        for name, peer, part in (("lo", lo_peer, lo), ("hi", hi_peer, hi)):
            if peer is None:
                continue
            s = self._host(part)
            sends.append(s)
            recvs[name] = self._recv_buffer(like, shape)
            ops += [dist.P2POp(dist.isend, s, peer, self.group),
                    dist.P2POp(dist.irecv, recvs[name], peer, self.group)]
        if ops:
            self._sync(like)
        works = dist.batch_isend_irecv(ops) if ops else []
        return Exchange(works, recvs, sends, like, shape)


class Exchange:
    """A posted ghost exchange (Mesh.start_exchange)."""

    def __init__(self, works, recvs, sends, like, shape):
        self._works, self._recvs, self._sends = works, recvs, sends
        self._like, self._shape = like, shape
        self.rule = None

    def wait(self):
        """(lo, hi) ghosts on the block's device: (south, north) rows or
        (west, east) columns; zeros where there is no neighbour."""
        if self.rule is not None:
            return _Ghosts.apply(self.rule[1], self)
        return self._finish()

    def _finish(self):
        for w in self._works:
            w.wait()
        like = self._like
        out = []
        for name in ("lo", "hi"):
            r = self._recvs.get(name)
            if r is None:
                out.append(like.new_zeros(self._shape))
            else:
                out.append(r.to(like.device, non_blocking=True)
                           if r.device != like.device else r)
        return tuple(out)


def _records(t: torch.Tensor) -> bool:
    """Whether autograd records an operation on t (the collectives take
    their rules only then: the forward-only path keeps its launches)."""
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduce(torch.autograd.Function):
    """Mesh.all_reduce under autograd: the backward is the all_reduce of
    the cotangent."""

    @staticmethod
    def forward(ctx, t, mesh, site):
        out = mesh._all_reduce(t, site)
        ctx.mesh, ctx.site = mesh, site
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors       # a checkpointed region recomputes here
        return ctx.mesh._all_reduce(g.contiguous(), ctx.site + ".T"), \
            None, None


class _AllToAll(torch.autograd.Function):
    """Mesh.all_to_all under autograd: chunk k went to the k-th rank, so
    the cotangent of chunk k comes back from it by the same
    all_to_all."""

    @staticmethod
    def forward(ctx, t, mesh, site, axis):
        out = mesh._all_to_all(t, site, axis)
        ctx.mesh, ctx.site, ctx.axis = mesh, site, axis
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        return ctx.mesh._all_to_all(g.contiguous(), ctx.site + ".T",
                                    ctx.axis), None, None, None


class _AllGather(torch.autograd.Function):
    """Mesh.all_gather under autograd: every rank holds a part of the
    cotangent of each rank's chunk, and this rank's chunk takes the sum
    of the parts, which one all_to_all brings together."""

    @staticmethod
    def forward(ctx, t, mesh, site):
        outs = mesh._all_gather(t, site)
        ctx.mesh, ctx.site = mesh, site
        ctx.save_for_backward(outs[mesh.rank])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        parts = ctx.mesh._all_to_all(
            torch.stack([g.contiguous() for g in grads]), ctx.site + ".T")
        return parts.sum(0), None, None


class _Ghosts(torch.autograd.Function):
    """An Exchange's wait() under autograd: the ghosts as a function of
    the block f. The backward sends each ghost's cotangent back to the
    neighbour it came from, which adds it to the cotangent of the rows
    (or columns) it sent; a blocking reverse exchange."""

    @staticmethod
    def forward(ctx, f, ex):
        mesh, _, axis, h, site = ex.rule
        lo, hi = ex._finish()
        ctx.mesh, ctx.axis, ctx.h, ctx.site = mesh, axis, h, site
        ctx.shape = f.shape
        ctx.save_for_backward(lo, hi)
        return lo, hi

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        ctx.saved_tensors
        mesh, h = ctx.mesh, ctx.h
        mesh.counts[ctx.site + ".T"] += 2
        back_lo, back_hi = mesh._post(g_lo.contiguous(), g_hi.contiguous(),
                                      ctx.axis, g_lo)._finish()
        dim = -2 if ctx.axis == "y" else -1
        n = ctx.shape[dim]
        g = g_lo.new_zeros(ctx.shape)
        g.narrow(dim, 0, h).add_(back_lo)
        g.narrow(dim, n - h, h).add_(back_hi)
        return g, None


def make_mesh(rows_only: bool = False, grid=None) -> Mesh:
    """A (my, mx) mesh of the process group's ranks, as square as their
    number allows; rows_only=True puts every rank on 'y' (row blocks, the
    analogue of the reference's OpenMP loops over rows, and the layout
    for channels: qgcm_tpu/parallel/mesh.py:make_mesh). `grid` is the
    ocean's p-grid (nyp, nxp), whose blocks shard_tree and gather_tree
    deal out."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    my = n if rows_only else int(math.sqrt(n))
    while n % my:
        my -= 1
    return Mesh((my, n // my), grid=grid)


def cyclic_x_refusal(what: str) -> ValueError:
    """The refusal of a cyclic ocean's halo path on a mesh with x > 1,
    with qgcm_tpu's reason (qgcm_tpu/parallel/halo.py:379-385)."""
    return ValueError(
        f"{what}: the port decomposes cyclic channels over rows only (the "
        "wraparound of the duplicated east column would cross column "
        "blocks): use make_mesh(rows_only=True) / --mesh rows, or pass no "
        "halo variant")


def _all_rows(mesh: Mesh) -> Mesh:
    """Row blocks of mesh's grid over all of mesh's ranks, in rank order,
    every column whole; its collectives count in mesh's counts and staged
    bytes. mesh itself when it is a rows mesh; made once per mesh."""
    if mesh.mx == 1:
        return mesh
    if mesh._rows is None:
        mesh._rows = Mesh((mesh.size, 1), grid=mesh.grid, group=mesh.group,
                          tally=mesh)
    return mesh._rows


def ocean_mesh(mesh: Mesh, cfg) -> Mesh:
    """The mesh that the ocean's grid takes in a run decomposed over
    `mesh`: mesh itself for a box; for a channel, or an atmosphere-only
    case (whose ocean grid carries only the prescribed SST), on a mesh
    with x > 1, row blocks of the ocean's p-grid over all of mesh's
    ranks, in rank order, as atmos_mesh cuts the atmosphere. qgcm_tpu
    runs those under GSPMD's partitioning (qgcm_tpu/run.py:147-167),
    which has no PyTorch counterpart; the rows mesh of the same ranks
    computes the same numbers, and a run on it is the same program, bit
    for bit, as one on `--mesh rows`. The runners take this layout where
    they are given no halo variant, the Driver and make_xforc always."""
    if cfg.cyclic_ocean or cfg.atmos_only:
        return _all_rows(mesh)
    return mesh


def rows_warning(spec: str, n: int) -> str:
    """What a run says when a mesh with x > 1 is cut by rows (ocean_mesh),
    where qgcm_tpu's Driver warns as it falls back to GSPMD."""
    return (f"mesh {spec} decomposes x on a zonally cyclic case (a channel, "
            "or the atmosphere alone): the halo schedule and the fused "
            "kernel decompose those over rows only, so the run takes row "
            f"blocks over all {n} ranks, where qgcm_tpu falls back to "
            "GSPMD. Rows-only meshes (--mesh rows|auto) are the measured-"
            "best channel layout.")


def atmos_mesh(mesh: Mesh, cfg) -> Mesh:
    """The atmosphere's mesh in a run decomposed over `mesh` (the ocean's,
    of any shape): row blocks of the atmosphere's p-grid over all of
    mesh's ranks, in rank order, every column whole (the atmosphere is a
    zonally cyclic channel, cut by rows only as the port's ocean channel
    is). qgcm_tpu lays the atmosphere over the ocean's (y, x) mesh; on a
    rows mesh the blocks are the same. Its collectives count in mesh's
    counts and staged bytes; made once per mesh."""
    if mesh._atmos is None:
        mesh._atmos = Mesh((mesh.size, 1), grid=(cfg.nypa, cfg.nxpa),
                           group=mesh.group, tally=mesh)
    return mesh._atmos


def make_hybrid_mesh(rows_only: bool = False, grid=None) -> Mesh:
    """qgcm_tpu's mesh for runs over several hosts
    (qgcm_tpu/parallel/mesh.py:60): the hosts split 'y' and each host's
    ranks (LOCAL_WORLD_SIZE, torchrun's count of a node's ranks) fill
    'x', so one node of 4 ranks gives 1 x 4; rows_only=True puts every
    rank on 'y', in node order (torchrun numbers the ranks node by
    node)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if rows_only or local == 1:
        return Mesh((n, 1), grid=grid)
    if n % local:
        raise ValueError(f"{n} ranks are not whole hosts of {local}")
    return Mesh((n // local, local), grid=grid)


def mesh_from_spec(spec: str, cyclic: bool, grid) -> Mesh:
    """The mesh of the CLI's --mesh (qgcm_tpu/cli.py:152-181) for the
    ocean's p-grid `grid`: 'auto' and 'rows' every rank on 'y';
    'hybrid' make_hybrid_mesh, rows only when `cyclic` (a channel, or an
    atmosphere-only case); 'NYxNX' that shape, which when `cyclic` and
    NX > 1 is cut by rows over its NY x NX ranks (ocean_mesh), with a
    warning where qgcm_tpu warns and falls back to GSPMD."""
    if spec in ("auto", "rows"):
        return make_mesh(rows_only=True, grid=grid)
    if spec == "hybrid":
        return make_hybrid_mesh(rows_only=cyclic, grid=grid)
    try:
        ny, nx = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes auto, rows, hybrid or NYxNX, not "
                         f"{spec!r}") from None
    mesh = Mesh((ny, nx), grid=grid)
    if nx > 1 and cyclic:
        import warnings
        warnings.warn(rows_warning(spec, mesh.size), stacklevel=2)
        return _all_rows(mesh)
    return mesh


class Block(NamedTuple):
    """Where this rank's block of a field lies: rows [r0, r0 + nr) and
    columns [c0, c0 + nc) of the global field, of which `rows` and
    `cols` are the true ones (the rest is padding)."""
    r0: int
    nr: int
    rows: int
    c0: int
    nc: int
    cols: int


def block_of(mesh: Mesh, ny: int, nx: int, rank: int = None) -> Block:
    """This rank's block (or that of the mesh's rank `rank`) of a (ny, nx)
    field of the mesh's p-grid or of its T-grid (one row and one column
    fewer), which takes the same blocks; on a rows mesh the field keeps
    its own columns."""
    if mesh.grid is None:
        raise ValueError("the mesh was made without a grid")
    iy, ix = (mesh.iy, mesh.ix) if rank is None else divmod(rank, mesh.mx)
    r0, c0 = iy * mesh.by, ix * mesh.bx
    rows = max(0, min(mesh.by, ny - r0))
    if mesh.mx == 1:
        return Block(r0, mesh.by, rows, 0, nx, nx)
    cols = max(0, min(mesh.bx, nx - c0))
    return Block(r0, mesh.by, rows, c0, mesh.bx, cols)


def replicated(x) -> bool:
    """Whether x is held whole by every rank and not in blocks: a tensor
    of fewer than two dimensions (the state's scalars and mode vectors)
    or a value that is not a tensor (a running mean's count)."""
    return not torch.is_tensor(x) or x.dim() < 2


def field_extent(x: torch.Tensor, mesh: Mesh, t_rows: bool = False,
                 t_cols: bool = False):
    """(ny, nx) of the whole field of which x is this rank's block:
    t_rows / t_cols say whether its rows / columns are the T-grid's (one
    fewer than the p-grid's); on a rows mesh a block has its field's own
    columns."""
    nyp, nxp = mesh.grid
    return (nyp - 1 if t_rows else nyp,
            x.shape[-1] if mesh.mx == 1 else nxp - 1 if t_cols else nxp)


def shard(x: torch.Tensor, mesh: Mesh):
    """This rank's block of a full field (..., ny, nx), zero-padded to
    (..., by, bx); contiguous. Replicated values are returned as they
    are."""
    if replicated(x):
        return x
    ny, nx = x.shape[-2:]
    b = block_of(mesh, ny, nx)
    part = x[..., b.r0:b.r0 + b.rows, b.c0:b.c0 + b.cols]
    return F.pad(part, (0, b.nc - b.cols, 0, b.nr - b.rows)).contiguous()


def gather(x: torch.Tensor, mesh: Mesh, t_rows: bool = False,
           t_cols: bool = False, site: str = "gather"):
    """The full field from every rank's block (the inverse of shard), on
    every rank: t_rows / t_cols as field_extent's. Replicated values are
    returned as they are."""
    if replicated(x):
        return x
    ny, nx = field_extent(x, mesh, t_rows, t_cols)
    parts = mesh.all_gather(x.contiguous(), site)
    rows = [torch.cat(parts[iy * mesh.mx:(iy + 1) * mesh.mx], dim=-1)
            for iy in range(mesh.my)]
    return torch.cat(rows, dim=-2)[..., :ny, :nx]


def shard_tree(tree, mesh: Mesh):
    """This rank's blocks of a full OceanState, OceanForcing or
    OceanAverages on the ocean's mesh, or of an AtmosState, AtmosForcing
    or AtmosAverages on the atmosphere's (atmos_mesh): a NamedTuple of
    tensors; scalars and mode vectors are replicated."""
    return type(tree)(**{k: shard(v, mesh)
                         for k, v in tree._asdict().items()})


def gather_tree(tree, mesh: Mesh):
    """The full NamedTuple from its blocks (the inverse of shard_tree), on
    every rank; the fields of state.T_GRID_FIELDS have the T-grid's rows,
    those of state.T_COL_FIELDS its columns."""
    return type(tree)(**{k: gather(v, mesh, k in T_GRID_FIELDS,
                                   k in T_COL_FIELDS)
                         for k, v in tree._asdict().items()})


def zero_padding(tree, mesh: Mesh):
    """A NamedTuple of blocks (as shard_tree gives them) with each block's
    padding, the rows and columns at or beyond its field's end, set to
    zero; replicated values as they are."""

    def one(k, x):
        if replicated(x):
            return x
        ny, nx = field_extent(x, mesh, k in T_GRID_FIELDS, k in T_COL_FIELDS)
        b = block_of(mesh, ny, nx)
        out = torch.zeros_like(x)
        out[..., :b.rows, :b.cols] = x[..., :b.rows, :b.cols]
        return out

    return type(tree)(**{k: one(k, v) for k, v in tree._asdict().items()})
