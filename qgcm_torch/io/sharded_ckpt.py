"""Sharded checkpoints: every rank writes its own blocks of the state and
reads back only what its blocks need (the port's counterpart of
qgcm_tpu/io/orbax_ckpt.py; the Driver's and the CLI's ckpt_format
'sharded', where qgcm_tpu's is 'orbax', a format of JAX's).

restart.nc (io/restart.py) stays the interoperable format, but the
primary rank writes it whole and every rank reads all of it: at NAtl 1 km
(3 x 4801^2 ocean) po and pom alone are 1.1 GB of float64.

The payload is qgcm_tpu's (orbax_ckpt.py:19-25), the reference's restart
contract: po, pom, sst, sstm, pa, pam, ast, astm, hmixa, hmixam and tyrs.
A fluid given as None (the inactive fluid of a single-fluid run) is
stored as its init="zero" state, as qgcm_tpu stores it. Vorticity and the
constraint values are derived again on load (q-gcm.F:715-750), as with
restart.nc, which keeps a resume exact.

A checkpoint is a directory:
  <field>.<rank>.npy  one file per field and writing rank, in the
                      model's dtype: that rank's true rows and columns of
                      the field, without the padding of parallel/mesh.shard.
                      Ocean fields take the blocks of parallel/mesh.
                      ocean_mesh(mesh, cfg), atmosphere fields those of
                      atmos_mesh(mesh, cfg); without a mesh each field is
                      one block.
  manifest.json       written last by the primary rank, by atomic rename:
                      the format version, the grid (nypo, nxpo, nypa, nxpa,
                      nlo, nla), the dtype, tyrs (a float64), and each
                      field's global shape and blocks (file, r0, rows, c0,
                      cols). A directory without it is an incomplete
                      checkpoint, and load_checkpoint refuses it.
A new checkpoint replaces the directory (qgcm_tpu's force=True).

A restore takes any target: one device, a rows mesh of any count, a
(y, x) box mesh, a channel on rows. Each rank reads, through memory maps,
the parts of the stored blocks that overlap its own block and the one
row and column of ghosts around it that the derivation of q reads; it
derives q and the boundary PV on its block, and the constraint integrals
as block sums all-reduced in float64, as the decomposed inversion makes
its sums. So a restored block is shard_tree(init_ocean_state(model,
<the whole fields>)) but for the order of those sums; on one device the
two are the same bits.

Why not another format: torch.save pickles; torch.distributed.checkpoint
chunks a DTensor as torch.chunk does, where the port's blocks are ceil
blocks padded at the edges and the blocks of a restore depend on the
target mesh. With the manifest's own block list, resharding is a slice
read.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.integrals import xintp_block
from ..ops.vorticity import atqzbd_block, ocqbdy_block, qcomp
from ..parallel.mesh import atmos_mesh, block_of, ocean_mesh
from ..state import AtmosState, OceanState

FORMAT = 1
MANIFEST = "manifest.json"
OCEAN_FIELDS = ("po", "pom", "sst", "sstm")
ATMOS_FIELDS = ("pa", "pam", "ast", "astm", "hmixa", "hmixam")
# the collective call sites (Mesh.counts): the save's three barriers (the
# old directory gone, every block written, the manifest written), and a
# restore's constraint integrals (one all_reduce a fluid)
SYNC = "ckpt.sync"
SUMS = "ckpt.sums"


def _grid(cfg) -> dict:
    return dict(nypo=cfg.nypo, nxpo=cfg.nxpo, nypa=cfg.nypa, nxpa=cfg.nxpa,
                nlo=cfg.nlo, nla=cfg.nla)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _extent(name: str, grid: dict) -> tuple:
    """The (ny, nx) of a payload field."""
    if name in ("po", "pom"):
        return grid["nypo"], grid["nxpo"]
    if name in ("sst", "sstm"):
        return grid["nypo"] - 1, grid["nxpo"] - 1
    if name in ("pa", "pam"):
        return grid["nypa"], grid["nxpa"]
    return grid["nypa"] - 1, grid["nxpa"] - 1


def _zero_states(model):
    from ..models.atmos import init_atmos_state
    from ..models.ocean import init_ocean_state
    return (init_ocean_state(model, init="zero"),
            init_atmos_state(model, init="zero"))


def _sync(mesh, device):
    if mesh is not None and mesh.size > 1:
        mesh.all_reduce(torch.zeros(1, device=device), SYNC)


def save_checkpoint(path: str, ocean, atmos, tyrs: float, model=None,
                    mesh=None) -> int:
    """Write a checkpoint directory; with `mesh` a collective of its ranks,
    each of which passes its blocks (parallel/mesh.shard_tree: the ocean on
    ocean_mesh(mesh, cfg), the atmosphere on atmos_mesh(mesh, cfg)) and
    writes them without a gather. In single-fluid modes pass the inactive
    state as None together with `model` (needed with a mesh too): its
    init="zero" state is stored. Returns the bytes this rank wrote."""
    if model is None and (mesh is not None or ocean is None
                          or atmos is None):
        raise ValueError("model= is needed with a mesh or a None state")
    if ocean is None or atmos is None:
        zoc, zat = _zero_states(model)
        if mesh is not None:
            from ..parallel.mesh import shard_tree
            zoc = shard_tree(zoc, ocean_mesh(mesh, model.cfg))
            zat = shard_tree(zat, atmos_mesh(mesh, model.cfg))
        ocean = zoc if ocean is None else ocean
        atmos = zat if atmos is None else atmos
    if model is not None:
        grid = _grid(model.cfg)
    else:
        (nlo, nypo, nxpo), (nla, nypa, nxpa) = ocean.po.shape, atmos.pa.shape
        grid = dict(nypo=nypo, nxpo=nxpo, nypa=nypa, nxpa=nxpa, nlo=nlo,
                    nla=nla)
    meshes = {}
    if mesh is not None:
        omesh, amesh = ocean_mesh(mesh, model.cfg), atmos_mesh(mesh, model.cfg)
        meshes = {**dict.fromkeys(OCEAN_FIELDS, omesh),
                  **dict.fromkeys(ATMOS_FIELDS, amesh)}
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    device = ocean.po.device
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
    _sync(mesh, device)
    fields = {**{k: getattr(ocean, k) for k in OCEAN_FIELDS},
              **{k: getattr(atmos, k) for k in ATMOS_FIELDS}}
    written = 0
    entries = {}
    for name, t in fields.items():
        ny, nx = _extent(name, grid)
        fm = meshes.get(name)
        blocks = ([block_of(fm, ny, nx, r) for r in range(size)] if fm
                  else [None])
        mine = blocks[rank]
        rows, cols = (ny, nx) if mine is None else (mine.rows, mine.cols)
        if rows and cols:
            a = t.detach()[..., :rows, :cols].cpu().numpy()
            np.save(os.path.join(path, f"{name}.{rank}.npy"),
                    np.ascontiguousarray(a))
            written += a.nbytes
        entries[name] = dict(
            shape=[*t.shape[:-2], ny, nx],
            blocks=[dict(file=f"{name}.{r}.npy", r0=0, rows=ny, c0=0, cols=nx)
                    if b is None else
                    dict(file=f"{name}.{r}.npy", r0=b.r0, rows=b.rows,
                         c0=b.c0, cols=b.cols)
                    for r, b in enumerate(blocks)
                    if b is None or (b.rows and b.cols)])
    _sync(mesh, device)
    if rank == 0:
        manifest = dict(format=FORMAT, grid=grid,
                        dtype=_dtype_name(ocean.po.dtype), tyrs=float(tyrs),
                        fields=entries)
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, MANIFEST))
    # no rank returns before the checkpoint is whole
    _sync(mesh, device)
    return written


def read_manifest(path: str) -> dict:
    """The manifest of a checkpoint directory; raises for a directory
    without one (an incomplete checkpoint) or of another format."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        raise ValueError(f"{path} holds no {MANIFEST}: an incomplete "
                         "checkpoint (its writer did not finish)")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: checkpoint format "
                         f"{manifest.get('format')!r}, this reader's is "
                         f"{FORMAT}")
    return manifest


class _Reader:
    """Rectangles of a checkpoint's fields, read from the stored blocks
    that overlap them through memory maps."""

    def __init__(self, path: str, manifest: dict):
        self.path, self.fields = path, manifest["fields"]
        self.dtype = np.dtype(manifest["dtype"])

    def __call__(self, name, r0, r1, c0=0, c1=None) -> np.ndarray:
        entry = self.fields[name]
        lead = tuple(entry["shape"][:-2])
        c1 = entry["shape"][-1] if c1 is None else c1
        out = np.empty(lead + (r1 - r0, c1 - c0), self.dtype)
        filled = 0
        for b in entry["blocks"]:
            a0, a1 = max(r0, b["r0"]), min(r1, b["r0"] + b["rows"])
            d0, d1 = max(c0, b["c0"]), min(c1, b["c0"] + b["cols"])
            if a0 >= a1 or d0 >= d1:
                continue
            src = np.load(os.path.join(self.path, b["file"]), mmap_mode="r")
            out[..., a0 - r0:a1 - r0, d0 - c0:d1 - c0] = \
                src[..., a0 - b["r0"]:a1 - b["r0"], d0 - b["c0"]:d1 - b["c0"]]
            filled += (a1 - a0) * (d1 - d0)
        if filled != (r1 - r0) * (c1 - c0):
            raise ValueError(f"{self.path}: the blocks of {name} do not "
                             f"cover rows {r0}:{r1}, columns {c0}:{c1} once")
        return out


def load_checkpoint(path: str, model, mesh=None):
    """-> (OceanState, AtmosState, tyrs). Without a mesh the whole state,
    as init_ocean_state and init_atmos_state derive it from the stored
    fields; with `mesh` (a collective of its ranks) this rank's blocks:
    the ocean's on ocean_mesh(mesh, cfg), the atmosphere's on
    atmos_mesh(mesh, cfg), as shard_tree lays them out. The checkpoint
    may come from any mesh and any dtype: each field is cast to the
    model's dtype as it is read, and q and the constraint values are
    derived in the model's dtype, as qgcm_tpu's Orbax restore does through
    init_ocean_state and init_atmos_state. A manifest made for another
    grid raises before any read."""
    manifest = read_manifest(path)
    cfg = model.cfg
    if manifest["grid"] != _grid(cfg):
        raise ValueError(f"{path} was written for the grid "
                         f"{manifest['grid']}; the model's is {_grid(cfg)}")
    read = _Reader(path, manifest)
    tyrs = float(manifest["tyrs"])
    if mesh is None:
        from ..models.atmos import init_atmos_state
        from ..models.ocean import init_ocean_state
        whole = {k: read(k, 0, _extent(k, manifest["grid"])[0])
                 for k in OCEAN_FIELDS + ATMOS_FIELDS}
        return (init_ocean_state(model, **{k: whole[k] for k in OCEAN_FIELDS}),
                init_atmos_state(model, **{k: whole[k] for k in ATMOS_FIELDS}),
                tyrs)
    return (_ocean_blocks(model, ocean_mesh(mesh, cfg), read),
            _atmos_blocks(model, atmos_mesh(mesh, cfg), read), tyrs)


def _window(mesh, ny, nx, b):
    """The rows [w0, w1) and columns [v0, v1) of the block b with one
    more each side, inside the grid; on a rows mesh every column."""
    w0, w1 = max(b.r0 - 1, 0), min(b.r0 + b.rows + 1, ny)
    if mesh.mx == 1:
        return w0, w1, 0, nx
    return w0, w1, max(b.c0 - 1, 0), min(b.c0 + b.cols + 1, nx)


def _padded(x: torch.Tensor, b) -> torch.Tensor:
    """x, the block's true part, zero-padded to the block (shard's form)."""
    return F.pad(x, (0, b.nc - x.shape[-1], 0, b.nr - x.shape[-2]))


def _tensor(model, a) -> torch.Tensor:
    return torch.as_tensor(a).to(device=model.device, dtype=model.dtype)


def _constraints(p_w, b, ny, amat, dx, dy, fnot):
    """This block's share of a channel's momentum-constraint vectors of
    the pressure whose rows p_w holds (the window): the south wall's
    vector where the block holds row 0, the north wall's where it holds
    row ny - 1, zeros elsewhere; each from the wall's two rows, as
    momentum_constraints forms it."""
    from ..models.ocean import momentum_constraints
    zero = p_w.new_zeros(p_w.shape[0])
    south = (momentum_constraints(p_w[:, :2], amat, dx, dy, fnot)[0]
             if b.r0 == 0 and b.rows else zero)
    north = (momentum_constraints(p_w[:, -2:], amat, dx, dy, fnot)[1]
             if b.rows and b.r0 + b.rows == ny else zero)
    return south, north


def _field_pair(model, read, names, mesh, ny, nx, b, fix_column):
    """The windows of a fluid's two pressures (tensors), the channel's
    duplicate east column set to the west one where fix_column (as
    init_ocean_state does before it derives q)."""
    w0, w1, v0, v1 = _window(mesh, ny, nx, b)
    out = []
    for name in names:
        p = _tensor(model, read(name, w0, w1, v0, v1))
        if fix_column:
            p = torch.cat([p[..., :-1], p[..., :1]], dim=-1)
        out.append(p)
    return out, (w0, v0)


def _cut(f, b, origin):
    """The block's true part of a window f whose first row and column are
    global (w0, v0)."""
    w0, v0 = origin
    i, j = b.r0 - w0, b.c0 - v0
    return f[..., i:i + b.rows, j:j + b.cols]


def _ddyn(ddyn, w0, w1, v0, v1):
    return ddyn if ddyn.dim() == 0 else ddyn[w0:w1, v0:v1]


def _ocean_blocks(model, mesh, read) -> OceanState:
    cfg, g = model.cfg, model.grids
    nyp, nxp, nlo = cfg.nypo, cfg.nxpo, cfg.nlo
    cyclic, two_d = cfg.cyclic_ocean, mesh.mx > 1
    b = block_of(mesh, nyp, nxp)
    bt = block_of(mesh, cfg.nyto, cfg.nxto)
    f64 = torch.float64
    dxom2 = 1.0 / g.dxo**2
    shares = []
    out = {}
    if b.rows and b.cols:
        (po, pom), origin = _field_pair(model, read, ("po", "pom"), mesh,
                                        nyp, nxp, b, cyclic)
        w0, v0 = origin
        w1, v1 = w0 + po.shape[-2], v0 + po.shape[-1]
        yprel = model.yporel[w0:w1]
        ddyn = _ddyn(model.ddyn, w0, w1, v0, v1)
        cols = dict(c0=v0, nx=nxp) if two_d else {}
        for name, p in (("po", po), ("pom", pom)):
            q = qcomp(p, model.amat, yprel, dxom2, cfg.fnot, cfg.beta, ddyn,
                      nlo - 1, cyclic=cyclic)
            q = ocqbdy_block(q, p, model.amat, yprel, dxom2, cfg.fnot,
                             cfg.beta, cfg.ocean.bccooc, ddyn, cyclic, w0,
                             nyp, **cols)
            blk = _cut(p, b, origin)
            out[name] = _padded(blk, b)
            out["qo" if name == "po" else "qom"] = _padded(_cut(q, b, origin),
                                                          b)
            shares.append(xintp_block(blk[1:] - blk[:-1], b.r0, nyp, b.c0,
                                      nxp if two_d else None, dtype=f64))
            if cyclic:
                shares += [c.to(f64) for c in _constraints(
                    p, b, nyp, model.amat, g.dxo, g.dyo, cfg.fnot)]
    else:
        zeros = torch.zeros((nlo, b.nr, b.nc), device=model.device,
                            dtype=model.dtype)
        out = dict(po=zeros, pom=zeros, qo=zeros, qom=zeros)
        n = 2 * (3 * nlo - 1 if cyclic else nlo - 1)
        shares = [torch.zeros(n, device=model.device, dtype=f64)]
    for name in ("sst", "sstm"):
        part = read(name, bt.r0, bt.r0 + bt.rows, bt.c0, bt.c0 + bt.cols) \
            if bt.rows and bt.cols else np.zeros((bt.rows, bt.cols))
        out[name] = _padded(_tensor(model, part), bt)
    tot = mesh.all_reduce(torch.cat(shares), SUMS).to(model.dtype)
    area = g.dxo * g.dyo
    if cyclic:
        dpioc, ocncs, ocncn, dpiocp, ocncsp, ocncnp = tot.split(
            [nlo - 1, nlo, nlo, nlo - 1, nlo, nlo])
    else:
        dpioc, dpiocp = tot.split([nlo - 1, nlo - 1])
        ocncs = ocncn = ocncsp = ocncnp = torch.zeros(
            nlo, device=model.device, dtype=model.dtype)
    return OceanState(**out, dpioc=dpioc * area, dpiocp=dpiocp * area,
                      ocncs=ocncs, ocncn=ocncn, ocncsp=ocncsp, ocncnp=ocncnp)


def _atmos_blocks(model, mesh, read) -> AtmosState:
    cfg, g = model.cfg, model.grids
    nyp, nxp, nla = cfg.nypa, cfg.nxpa, cfg.nla
    b = block_of(mesh, nyp, nxp)
    bt = block_of(mesh, cfg.nyta, cfg.nxta)
    f64 = torch.float64
    dxam2 = 1.0 / g.dxa**2
    out, shares = {}, []
    if b.rows:
        (pa, pam), origin = _field_pair(model, read, ("pa", "pam"), mesh,
                                        nyp, nxp, b, False)
        w0 = origin[0]
        w1 = w0 + pa.shape[-2]
        yprel = model.yparel[w0:w1]
        ddyn = _ddyn(model.ddyn_at, w0, w1, 0, nxp)
        for name, p in (("pa", pa), ("pam", pam)):
            q = qcomp(p, model.amat_at, yprel, dxam2, cfg.fnot, cfg.beta,
                      ddyn, 0, cyclic=True)
            q = atqzbd_block(q, p, model.amat_at, yprel, dxam2, cfg.fnot,
                             cfg.beta, cfg.atmos.bccoat, ddyn, w0, nyp)
            blk = _cut(p, b, origin)
            out[name] = _padded(blk, b)
            out["qa" if name == "pa" else "qam"] = _padded(_cut(q, b, origin),
                                                          b)
            shares.append(xintp_block(blk[:-1] - blk[1:], b.r0, nyp,
                                      dtype=f64))
            shares += [c.to(f64) for c in _constraints(
                p, b, nyp, model.amat_at, g.dxa, g.dya, cfg.fnot)]
    else:
        zeros = torch.zeros((nla, b.nr, b.nc), device=model.device,
                            dtype=model.dtype)
        out = dict(pa=zeros, pam=zeros, qa=zeros, qam=zeros)
        shares = [torch.zeros(2 * (3 * nla - 1), device=model.device,
                              dtype=f64)]
    for name in ("ast", "astm", "hmixa", "hmixam"):
        part = read(name, bt.r0, bt.r0 + bt.rows) if bt.rows \
            else np.zeros((0, bt.nc))
        out[name] = _padded(_tensor(model, part), bt)
    tot = mesh.all_reduce(torch.cat(shares), SUMS).to(model.dtype)
    dpiat, atmcs, atmcn, dpiatp, atmcsp, atmcnp = tot.split(
        [nla - 1, nla, nla, nla - 1, nla, nla])
    area = g.dxa * g.dya
    return AtmosState(**out, dpiat=dpiat * area, dpiatp=dpiatp * area,
                      atmcs=atmcs, atmcn=atmcn, atmcsp=atmcsp, atmcnp=atmcnp)
