"""The vorticity step on row blocks (and, in the box, on 2-D blocks)
with an explicit exchange of ghost rows and columns (port of
qgcm_tpu/parallel/halo.py).

Each rank holds its block of pom, po, qo, qom, wek, ent and r_spl
(parallel/mesh.py) and gets back its block of the new qo, bit for bit
the rows the single-device step computes: the arithmetic at a point is
the same, only where its neighbours come from changes. The schedules are
qgcm_tpu's:

  'staged'  one exchange of one ghost row per stencil stage (pom/po/qo
            together, then del2, then del4), no redundant work; the
            stages are the plain PyTorch ones, on the card too: a step
            that exchanges between its stages is not one kernel launch,
            and qgcm_tpu runs them as XLA ops as well;
  'deep'    one exchange of 3 ghost rows of (pom, po, qo), then one
            kernel launch on the block's window (ops.qgstep's row mode,
            or its x_ext mode on a 2-D mesh);
  'overlap' the exchange of 'deep' is posted first; the kernel runs on
            the block with zero ghosts while it is in flight (its 3 rows
            nearest each edge are wrong); then two 9-row band windows
            built from the ghosts replace those rows (on a 2-D mesh the
            column exchange of the row-extended block follows and four
            bands patch the frame). qgcm_tpu leaves the overlap to XLA's
            scheduler; here the order of the calls makes it.
  'local'   taken for blocks too small for ghosts (qgcm_tpu's
            coercions, halo.py:392-400, :539-551): every rank gathers
            the whole field and computes the whole step, keeping its
            block.

The ends of the domain receive zeros from the exchange (the wall
convention, halo.py:33-35); walls, zonal rows and padding are masked on
global rows and columns. Channels decompose over rows only: a mesh with
x > 1 is refused for them (halo.py:379-385).
"""

from __future__ import annotations

import torch

from ..ops.qgstep import (HALO, assemble_rows, jacobian_rows, lap_bc_rows,
                          qgstep)

# collective call sites (Mesh.counts)
ROWS = "halo.rows"
COLS = "halo.cols"
GATHER = "halo.gather"


def _with_halo(mesh, f, h, site=ROWS):
    """f with h exchanged ghost rows each side (zeros at the walls)."""
    south, north = mesh.start_exchange(f, h, "y", site).wait()
    return torch.cat([south, f, north], dim=-2)


def _rows(t, lo, hi):
    return None if t is None else t[..., lo:hi, :].contiguous()


def _cols(t, lo, hi):
    return None if t is None else t[..., lo:hi].contiguous()


def qgstep_halo(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                *, cyclic: bool, sponge: bool, mesh, variant="overlap"):
    """The vorticity leapfrog of this rank's blocks (nl, by, bx) of a grid
    mesh.grid = (ny, nx): ops.qgstep's contract (the zonal rows carry the
    old qo), on blocks. A mesh with x > 1 takes the 2-D decomposition
    (box only)."""
    ny, nx = mesh.grid
    if mesh.mx > 1:
        if cyclic:
            raise ValueError(
                "the halo path decomposes cyclic channels over rows only "
                "(the duplicated east column's wrap would cross blocks): "
                "use make_mesh(rows_only=True)")
        return _qgstep_halo_2d(pom, po, qo, qom, wekpo, entoc, r_spl,
                               consts, ah2, ah4, sponge=sponge, mesh=mesh,
                               variant=variant)
    if variant not in ("staged", "deep", "overlap", "local"):
        raise ValueError(f"unknown halo variant {variant!r}")
    nl = pom.shape[0]
    by = mesh.by
    if variant == "overlap" and by < 2 * HALO:
        variant = "deep"
    if by < HALO:
        variant = "local"
    gtop = mesh.iy * by
    kw = dict(cyclic=cyclic, sponge=sponge, ny_total=ny)

    if variant == "local":
        return _local(mesh, (pom, po, qo, qom, wekpo, entoc, r_spl),
                      consts, ah2, ah4, cyclic, sponge, x_ext=False)

    stack = torch.cat([pom, po, qo], dim=0)
    if variant == "staged":
        dxm2, bcfac = consts[0], consts[1]
        sp1 = _with_halo(mesh, stack, 1)
        d2 = lap_bc_rows(sp1[:nl], gtop - 1, ny, bcfac, dxm2, cyclic)
        d4 = lap_bc_rows(_with_halo(mesh, d2, 1), gtop - 1, ny, bcfac,
                         dxm2, cyclic)
        jac = jacobian_rows(sp1[2 * nl:], sp1[nl:2 * nl], gtop - 1, ny,
                            cyclic)
        return assemble_rows(jac, d2, _with_halo(mesh, d4, 1), qo, qom,
                             wekpo, entoc, r_spl, gtop, ny, consts, ah2,
                             ah4, cyclic, sponge)

    if variant == "deep":
        full = _with_halo(mesh, stack, HALO)
        return qgstep(*full.split(nl), qom, wekpo, entoc, r_spl, consts,
                      ah2, ah4, row0=gtop - HALO, **kw)

    # 'overlap': post the exchange, run the interior on zero ghosts while
    # it is in flight, then patch the 3 rows nearest each edge
    pending = mesh.start_exchange(stack, HALO, "y", ROWS)
    zero = torch.zeros_like(stack[..., :HALO, :])
    full0 = torch.cat([zero, stack, zero], dim=-2)
    q_int = qgstep(*full0.split(nl), qom, wekpo, entoc, r_spl, consts,
                   ah2, ah4, row0=gtop - HALO, **kw)
    south, north = pending.wait()

    def band(strip, lo, g0):
        return qgstep(*strip.split(nl), _rows(qom, lo, lo + HALO),
                      _rows(wekpo, lo, lo + HALO), _rows(entoc, lo, lo + HALO),
                      _rows(r_spl, lo, lo + HALO), consts, ah2, ah4,
                      row0=g0, **kw)

    q_s = band(torch.cat([south, stack[..., :2 * HALO, :]], dim=-2), 0,
               gtop - HALO)
    q_n = band(torch.cat([stack[..., -2 * HALO:, :], north], dim=-2),
               by - HALO, gtop + by - 2 * HALO)
    return torch.cat([q_s, q_int[..., HALO:-HALO, :], q_n], dim=-2)


def _local(mesh, fields, consts, ah2, ah4, cyclic, sponge, x_ext):
    """Blocks too small for ghosts: gather every field, step the whole
    (padded) grid with zero ghosts, keep this rank's block."""
    pom, po, qo, qom, wek, ent, rspl = fields
    nl = pom.shape[0]
    planes = [wek, ent] + ([rspl] if sponge else [])
    mine = torch.cat([pom, po, qo, qom] + [p[None] for p in planes], dim=0)
    parts = mesh.all_gather(mine, GATHER)
    rows = [torch.cat(parts[iy * mesh.mx:(iy + 1) * mesh.mx], dim=-1)
            for iy in range(mesh.my)]
    whole = torch.cat(rows, dim=-2)
    ny, nx = mesh.grid
    pad = (HALO, HALO) if x_ext else (0, 0)
    win = torch.nn.functional.pad(whole[:3 * nl], pad + (HALO, HALO))
    planes = list(whole[4 * nl:])
    out = qgstep(*win.split(nl), whole[3 * nl:4 * nl].contiguous(),
                 planes[0].contiguous(), planes[1].contiguous(),
                 planes[2].contiguous() if sponge else None, consts, ah2,
                 ah4, cyclic=cyclic, sponge=sponge, row0=-HALO,
                 ny_total=ny, col0=0,
                 nx_total=nx if x_ext else whole.shape[-1], x_ext=x_ext)
    r0, c0 = mesh.iy * pom.shape[-2], mesh.ix * pom.shape[-1]
    return out[:, r0:r0 + pom.shape[-2], c0:c0 + pom.shape[-1]].contiguous()


def _qgstep_halo_2d(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2,
                    ah4, *, sponge, mesh, variant):
    """The box step decomposed over both mesh axes (halo.py:488): 3 ghost
    rows exchanged over 'y', then 3 ghost columns of the row-extended
    block over 'x' (the corners ride the second exchange). 'staged'
    exchanges intermediates and has no 2-D form: it takes 'deep'."""
    if variant not in ("staged", "deep", "overlap", "local"):
        raise ValueError(f"unknown halo variant {variant!r}")
    ny, nx = mesh.grid
    nl = pom.shape[0]
    by, bx = mesh.by, mesh.bx
    if variant == "staged":
        variant = "deep"
    if variant == "overlap" and (by < 2 * HALO or bx < 2 * HALO):
        variant = "deep"
    if by < HALO or bx < HALO:
        variant = "local"
    if variant == "local":
        return _local(mesh, (pom, po, qo, qom, wekpo, entoc, r_spl),
                      consts, ah2, ah4, False, sponge, x_ext=True)
    gtop, gleft = mesh.iy * by, mesh.ix * bx
    stack = torch.cat([pom, po, qo], dim=0)

    def run(win, qom_, wek_, ent_, rspl_, gtop3, gleft3):
        return qgstep(*win.split(nl), qom_, wek_, ent_, rspl_, consts, ah2,
                      ah4, cyclic=False, sponge=sponge, row0=gtop3,
                      ny_total=ny, col0=gleft3 + HALO, nx_total=nx,
                      x_ext=True)

    if variant == "deep":
        ys = _with_halo(mesh, stack, HALO)
        west, east = mesh.start_exchange(ys, HALO, "x", COLS).wait()
        full = torch.cat([west, ys, east], dim=-1)
        return run(full, qom, wekpo, entoc, r_spl, gtop - HALO,
                   gleft - HALO)

    # 'overlap': the interior runs on a zero ring while the row exchange
    # is in flight; the column exchange of the row-extended block follows
    pending = mesh.start_exchange(stack, HALO, "y", ROWS)
    full0 = torch.nn.functional.pad(stack, (HALO, HALO, HALO, HALO))
    q_int = run(full0, qom, wekpo, entoc, r_spl, gtop - HALO, gleft - HALO)
    south, north = pending.wait()
    ys = torch.cat([south, stack, north], dim=-2)      # rows -3 .. by+3
    west, east = mesh.start_exchange(ys, HALO, "x", COLS).wait()

    def band_y(lo, g0):
        strip = torch.cat([west[..., lo:lo + 3 * HALO, :],
                           ys[..., lo:lo + 3 * HALO, :],
                           east[..., lo:lo + 3 * HALO, :]], dim=-1)
        return run(strip, _rows(qom, lo, lo + HALO),
                   _rows(wekpo, lo, lo + HALO), _rows(entoc, lo, lo + HALO),
                   _rows(r_spl, lo, lo + HALO), g0, gleft - HALO)

    def band_x(strip, lo, g0x):
        return run(strip, _cols(qom, lo, lo + HALO),
                   _cols(wekpo, lo, lo + HALO), _cols(entoc, lo, lo + HALO),
                   _cols(r_spl, lo, lo + HALO), gtop - HALO, g0x)

    q_s = band_y(0, gtop - HALO)
    q_n = band_y(by - HALO, gtop + by - 2 * HALO)
    q_w = band_x(torch.cat([west, ys[..., :2 * HALO]], dim=-1), 0,
                 gleft - HALO)
    q_e = band_x(torch.cat([ys[..., -2 * HALO:], east], dim=-1), bx - HALO,
                 gleft + bx - 2 * HALO)
    mid = torch.cat([q_w[..., HALO:by - HALO, :],
                     q_int[..., HALO:-HALO, HALO:-HALO],
                     q_e[..., HALO:by - HALO, :]], dim=-1)
    return torch.cat([q_s, mid, q_n], dim=-2)
