"""The fused ocean vorticity leapfrog: the CUDA kernel's wrapper and its
plain PyTorch versions.

`qgstep` has the signature and meaning of the Pallas TPU kernel
qgcm_tpu/ops/pallas_qg.py::qgstep_pallas, in its three modes: the full
field, a row window (`row0`, `ny_total`) and, in the box, a window with
real ghost columns (`x_ext`, `col0`, `nx_total`), the last two for the
row blocks of a decomposed run (parallel/halo.py). On CUDA tensors it
launches the hand-written kernel of csrc/qgstep.cu (built on first use,
see ops/_cuda.py) and adds one to `qgstep.launches` and to its mode's
entry of `qgstep.mode_launches`; on CPU tensors it returns the plain
version: `qgstep_reference`, the chain of stencil operators
(qgcm_tpu/models/ocean.py:272-317), for the full field, and
`window_reference`, the chain on a ghost-extended window with its masks
on global rows and columns (qgcm_tpu/parallel/halo.py:142-337), for the
windows. There is no fallback between the two: a CUDA tensor gets the
kernel or an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from .stencils import del2_bc, jacobian9, _row_mask, _col_mask, _pad_y, \
    _pad_xy, _wshift, _eshift

# consts: (dxm2, bcfac, adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0,
#          beta*dy, f0/H0, f0/H1)
N_CONSTS = 11
MAX_LAYERS = 8      # kMaxLayers in csrc/qgstep.cu
STRIP_W = 122       # kStripW in csrc/qgstep.cu: output columns per strip
# Bounds of the strip height (output rows per strip). A strip re-reads
# 6 halo rows of pom (2 of po and qo) and spends 6 iterations filling its
# pipeline: at 3x4801^2 heights 48-96 time within 0.2% of each other and
# 16 is 6% slower. Where one wave of resident blocks covers the grid at
# some height in between, the shortest such height is best: at 3x961^2 a
# second, partial wave costs 15-30% (chip_smoke.py phase 5, PERF.md).
MIN_STRIP_H = 16
MAX_STRIP_H = 64
# The window design's tile (kTileW, kTileH in csrc/qgstep.cu): output
# columns and rows of one block.
TILE_W = 58
TILE_H = 8
# ghost rows (and, in x_ext mode, columns) on each side of a window:
# del6 is three nested 5-point stencils (kHalo in csrc/qgstep.cu)
HALO = 3
MODES = ("full", "rows", "x_ext")
# the kernel's tensor inputs, in argument order (mstride in csrc/qgstep.cu)
INPUT_NAMES = ("pom", "po", "qo", "qom", "wekpo", "entoc", "r_spl")
N_INPUTS = len(INPUT_NAMES)


def qgstep_reference(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                     ah2, ah4, *, cyclic: bool, sponge: bool):
    """Plain PyTorch chain of the fused step: del2/del4/del6 of the lagged
    pressure, the Arakawa Jacobian, layer forcing and the leapfrog update.
    Returns qo_new with the zonal rows carrying the old qo."""
    (dxm2, bcfac, adfac, rfnot, tdt, bdrfac, c1spl, beta_y0, beta_dy,
     fohfac0, fohfac1) = consts
    nl, ny, _ = pom.shape
    dt = pom.dtype
    dev = pom.device
    del2p = del2_bc(pom, bcfac, dxm2, cyclic)
    d4p = del2_bc(del2p, bcfac, dxm2, cyclic)
    zonal = _row_mask(pom, 0) | _row_mask(pom, -1)
    if cyclic:
        d4pp = _pad_y(d4p)
        d6p = dxm2 * (d4pp[:, :-2, :] + d4pp[:, 2:, :] + _wshift(d4p)
                      + _eshift(d4p) - 4.0 * d4p)
        edge = zonal
    else:
        d4pp = _pad_xy(d4p)
        d6p = dxm2 * (d4pp[:, :-2, 1:-1] + d4pp[:, 2:, 1:-1]
                      + d4pp[:, 1:-1, :-2] + d4pp[:, 1:-1, 2:]
                      - 4.0 * d4p)
        we = _col_mask(pom, 0) | _col_mask(pom, -1)
        edge = zonal | we
    d6full = torch.where(edge, 0.0, d6p)

    ah2v = torch.tensor(ah2, dtype=dt, device=dev)[:, None, None]
    ah4v = torch.tensor(ah4, dtype=dt, device=dev)[:, None, None]
    dqdt = (adfac * jacobian9(qo, po, cyclic)
            + (ah2v * rfnot) * d4p - (ah4v * rfnot) * d6full)
    if not cyclic:
        dqdt = torch.where(we, 0.0, dqdt)

    # layer forcing: Ekman pumping, entrainment, bottom drag (with
    # nl == 2 layer 1 takes both the entrainment and the drag)
    dqdt[0] += fohfac0 * (wekpo - entoc)
    dqdt[1] += fohfac1 * entoc
    dqdt[nl - 1] -= bdrfac * del2p[-1]
    qnew = qom + tdt * dqdt
    if sponge:
        betay = beta_y0 + beta_dy * torch.arange(ny, dtype=dt, device=dev)
        qnew = qnew + (tdt * c1spl) * r_spl * (qom - betay[:, None])
    return torch.where(zonal, qo, qnew)


# ----------------------------------------------------------------------
# The plain chain on a window (port of qgcm_tpu/parallel/halo.py:115-337)
# ----------------------------------------------------------------------

def _xnbrs(f, cyclic):
    """West and east neighbour columns, as ops/stencils does: the cyclic
    wrap (west of column 0 is column nx-2) or zero shifts in the box."""
    if cyclic:
        return _wshift(f), _eshift(f)
    z = torch.zeros_like(f[..., :1])
    return (torch.cat([z, f[..., :-1]], dim=-1),
            torch.cat([f[..., 1:], z], dim=-1))


def _grows(g0, n, dev):
    """Global indices g0 .. g0+n-1 as a (n, 1) column."""
    return (g0 + torch.arange(n, device=dev))[:, None]


def _gcols(g0, n, dev):
    return (g0 + torch.arange(n, device=dev))[None, :]


def lap_bc_rows(fp, gtop, ny, bcfac, dxm2, cyclic):
    """Mixed-BC Laplacian of a field with >= 1 ghost rows (halo.py:142);
    the output loses a row each side. `gtop` is the global row of fp's
    row 0; padding rows (>= ny) come out zero."""
    c = fp[..., 1:-1, :]
    s, n = fp[..., :-2, :], fp[..., 2:, :]
    w, e = _xnbrs(c, cyclic)
    lap = dxm2 * (s + n + w + e - 4.0 * c)
    gr = _grows(gtop + 1, c.shape[-2], fp.device)
    south, north = gr == 0, gr == ny - 1
    out = torch.where(south, bcfac * (n - c),
                      torch.where(north, bcfac * (s - c), lap))
    if not cyclic:
        nx = c.shape[-1]
        gc = _gcols(0, nx, fp.device)
        west, east = gc == 0, gc == nx - 1
        zonal = south | north
        out = torch.where(west & ~zonal, bcfac * (e - c), out)
        out = torch.where(east & ~zonal, bcfac * (w - c), out)
    return torch.where(gr > ny - 1, 0.0, out)


def _arakawa(qe, qw, qn, qs, qne, qnw, qse, qsw,
             pe, pw, pn, ps, pne, pnw, pse, psw):
    return ((qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
            + qe * (pne - pse) - qw * (pnw - psw)
            - qn * (pne - pnw) + qs * (pse - psw)
            + pn * (qne - qnw) - ps * (qse - qsw)
            - pe * (qne - qse) + pw * (qnw - qsw))


def jacobian_rows(qp, pp, gtop, ny, cyclic):
    """Arakawa sum (x 12 dx dy) from fields with one ghost row
    (halo.py:162); zonal (and box W/E) outputs zeroed."""
    def nb(f):
        c, n_, s_ = f[..., 1:-1, :], f[..., 2:, :], f[..., :-2, :]
        w, e = _xnbrs(c, cyclic)
        nw, ne = _xnbrs(n_, cyclic)
        sw, se = _xnbrs(s_, cyclic)
        return e, w, n_, s_, ne, nw, se, sw

    jac = _arakawa(*nb(qp), *nb(pp))
    gr = _grows(gtop + 1, jac.shape[-2], qp.device)
    edge = (gr == 0) | (gr >= ny - 1)
    if not cyclic:
        nx = jac.shape[-1]
        gc = _gcols(0, nx, qp.device)
        edge = edge | (gc == 0) | (gc == nx - 1)
    return torch.where(edge, 0.0, jac)


def _assemble(jac, d2c, d4c, d6, qo_c, qom, wek, ent, rspl, zonal, pad,
              wecols, gtop, consts, ah2, ah4, sponge):
    """dq/dt, the layer forcing, the leapfrog, the sponge and the zonal
    keep-old mask (halo.py:189, :299), in qgstep_reference's order."""
    (dxm2, bcfac, adfac, rfnot, tdt, bdrfac, c1spl, beta_y0, beta_dy,
     fohfac0, fohfac1) = consts
    nl = qom.shape[0]
    dt, dev = qom.dtype, qom.device
    edge = zonal if wecols is None else zonal | wecols
    d6 = torch.where(edge, 0.0, d6)
    ah2v = torch.tensor(ah2, dtype=dt, device=dev)[:, None, None]
    ah4v = torch.tensor(ah4, dtype=dt, device=dev)[:, None, None]
    dqdt = adfac * jac + (ah2v * rfnot) * d4c - (ah4v * rfnot) * d6
    if wecols is not None:
        dqdt = torch.where(wecols, 0.0, dqdt)
    dqdt[0] += fohfac0 * (wek - ent)
    dqdt[1] += fohfac1 * ent
    dqdt[nl - 1] -= bdrfac * d2c[nl - 1]
    qnew = qom + tdt * dqdt
    if sponge:
        gr = _grows(gtop, qom.shape[-2], dev)
        betay = beta_y0 + beta_dy * gr.to(dt)
        qnew = qnew + (tdt * c1spl) * rspl * (qom - betay)
    qnew = torch.where(zonal, qo_c, qnew)
    return torch.where(pad, 0.0, qnew)


def assemble_rows(jac, d2c, d4p1, qo_c, qom, wek, ent, rspl, gtop, ny,
                  consts, ah2, ah4, cyclic, sponge):
    """The tail of the row-window step (halo.py:189): del6 from del4
    with one ghost row (d4p1), then _assemble; everything else is the
    core's shape, whose row 0 is global row gtop."""
    dxm2 = consts[0]
    nx = d4p1.shape[-1]
    c = d4p1[..., 1:-1, :]
    w, e = _xnbrs(c, cyclic)
    d6 = dxm2 * (d4p1[..., :-2, :] + d4p1[..., 2:, :] + w + e - 4.0 * c)
    gr = _grows(gtop, c.shape[-2], c.device)
    wecols = None
    if not cyclic:
        gc = _gcols(0, nx, c.device)
        wecols = (gc == 0) | (gc == nx - 1)
    return _assemble(jac, d2c, c, d6, qo_c, qom, wek, ent, rspl,
                     (gr == 0) | (gr == ny - 1), gr > ny - 1, wecols, gtop,
                     consts, ah2, ah4, sponge)


def _chain(pomp, pop, qop, qom, wek, ent, rspl, gtop3, ny, consts, ah2,
           ah4, cyclic, sponge):
    """The step from 3-ghost-row windows pomp/pop/qop (nl, R+6, nx);
    qom/wek/ent/rspl are core-shaped; gtop3 is the global row of the
    window's row 0 (halo.py:230)."""
    dxm2, bcfac = consts[0], consts[1]
    d2 = lap_bc_rows(pomp, gtop3, ny, bcfac, dxm2, cyclic)
    d4 = lap_bc_rows(d2, gtop3 + 1, ny, bcfac, dxm2, cyclic)
    jac = jacobian_rows(qop[..., 2:-2, :], pop[..., 2:-2, :], gtop3 + 2,
                        ny, cyclic)
    return assemble_rows(jac, d2[..., 2:-2, :], d4, qop[..., 3:-3, :], qom,
                         wek, ent, rspl, gtop3 + 3, ny, consts, ah2, ah4,
                         cyclic, sponge)


def _lap_bc2(fp, gtop, gleft, ny, nx, bcfac, dxm2):
    """Mixed-BC box Laplacian of a field with >= 1 ghost rings
    (halo.py:257); the output loses a ring; padding comes out zero."""
    c = fp[..., 1:-1, 1:-1]
    s, n = fp[..., :-2, 1:-1], fp[..., 2:, 1:-1]
    w, e = fp[..., 1:-1, :-2], fp[..., 1:-1, 2:]
    lap = dxm2 * (s + n + w + e - 4.0 * c)
    gr = _grows(gtop + 1, c.shape[-2], fp.device)
    gc = _gcols(gleft + 1, c.shape[-1], fp.device)
    south, north = gr == 0, gr == ny - 1
    west, east = gc == 0, gc == nx - 1
    out = torch.where(south, bcfac * (n - c),
                      torch.where(north, bcfac * (s - c), lap))
    zonal = south | north
    out = torch.where(west & ~zonal, bcfac * (e - c), out)
    out = torch.where(east & ~zonal, bcfac * (w - c), out)
    return torch.where((gr > ny - 1) | (gc > nx - 1), 0.0, out)


def _jacobian2(qp, pp, gtop, gleft, ny, nx):
    """Arakawa sum from fields with one ghost ring (halo.py:277)."""
    def nb(f):
        return (f[..., 1:-1, 2:], f[..., 1:-1, :-2], f[..., 2:, 1:-1],
                f[..., :-2, 1:-1], f[..., 2:, 2:], f[..., 2:, :-2],
                f[..., :-2, 2:], f[..., :-2, :-2])

    jac = _arakawa(*nb(qp), *nb(pp))
    gr = _grows(gtop + 1, jac.shape[-2], qp.device)
    gc = _gcols(gleft + 1, jac.shape[-1], qp.device)
    edge = (gr == 0) | (gr >= ny - 1) | (gc == 0) | (gc >= nx - 1)
    return torch.where(edge, 0.0, jac)


def _chain2(pomp, pop, qop, qom, wek, ent, rspl, gtop3, gleft3, ny, nx,
            consts, ah2, ah4, sponge):
    """The box step from 3-ghost-ring windows (nl, R+6, C+6); (gtop3,
    gleft3) is the global index of the window's [0, 0] (halo.py:337)."""
    dxm2, bcfac = consts[0], consts[1]
    d2 = _lap_bc2(pomp, gtop3, gleft3, ny, nx, bcfac, dxm2)
    d4 = _lap_bc2(d2, gtop3 + 1, gleft3 + 1, ny, nx, bcfac, dxm2)
    jac = _jacobian2(qop[..., 2:-2, 2:-2], pop[..., 2:-2, 2:-2],
                     gtop3 + 2, gleft3 + 2, ny, nx)
    c = d4[..., 1:-1, 1:-1]
    d6 = dxm2 * (d4[..., :-2, 1:-1] + d4[..., 2:, 1:-1] + d4[..., 1:-1, :-2]
                 + d4[..., 1:-1, 2:] - 4.0 * c)
    gr = _grows(gtop3 + 3, c.shape[-2], pomp.device)
    gc = _gcols(gleft3 + 3, c.shape[-1], pomp.device)
    return _assemble(jac, d2[..., 2:-2, 2:-2], c, d6,
                     qop[..., 3:-3, 3:-3], qom, wek, ent, rspl,
                     (gr == 0) | (gr == ny - 1),
                     (gr > ny - 1) | (gc > nx - 1),
                     (gc == 0) | (gc == nx - 1), gtop3 + 3, consts, ah2,
                     ah4, sponge)


def window_reference(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2,
                     ah4, *, cyclic: bool, sponge: bool, row0: int,
                     ny_total: int, col0: int = 0, nx_total=None,
                     x_ext: bool = False):
    """Plain PyTorch version of qgstep's window modes: `pom`, `po`, `qo`
    are (nl, R+6, W) windows whose row 0 is global row `row0`;
    qom/wekpo/entoc/r_spl and the result are the (nl, R, C) core. Row
    mode: C = W, the whole width. x_ext (box): W = C + 6, the core's
    column 0 is global column `col0` of a grid `nx_total` wide."""
    if x_ext:
        return _chain2(pom, po, qo, qom, wekpo, entoc, r_spl, row0,
                       col0 - HALO, ny_total, nx_total, consts, ah2, ah4,
                       sponge)
    return _chain(pom, po, qo, qom, wekpo, entoc, r_spl, row0, ny_total,
                  consts, ah2, ah4, cyclic, sponge)


class Geometry(NamedTuple):
    """The kernel's launch geometry. Block (bx, by, z) of the grid
    (strips_x, strips_y, members * nl) owns member z // nl, layer z % nl,
    rows [by*strip_h, min((by+1)*strip_h, ny)) and columns [bx*strip_w,
    min((bx+1)*strip_w, nx)), as csrc/qgstep.cu computes them; a strip
    of the march, or with `tiled` a tile of the window design."""
    strip_w: int
    strip_h: int
    strips_x: int
    strips_y: int
    tiled: bool = False


def launch_geometry(nl: int, ny: int, nx: int, resident: int) -> Geometry:
    """Strips of STRIP_W columns, and of the fewest rows that keep the
    launch within one wave of `resident` blocks (those the card holds at
    once), within [MIN_STRIP_H, MAX_STRIP_H]. `nl` counts the launch's
    layers: members x layers. The last strip of each direction may be
    narrower or shorter."""
    strips_x = -(-nx // STRIP_W)
    per_column = resident // (nl * strips_x)
    h = -(-ny // per_column) if per_column else MAX_STRIP_H
    h = min(max(h, MIN_STRIP_H), MAX_STRIP_H)
    return Geometry(STRIP_W, h, strips_x, -(-ny // h))


def window_geometry(nl: int, rows: int, cols: int, resident: int,
                    resident_tile: int) -> Geometry:
    """The geometry of a window launch of (nl, rows, cols) outputs: the
    march (launch_geometry) where it fills a wave of the `resident` march
    blocks the card holds at once, as at a full-width window of 961
    rows; else tiles of TILE_H x TILE_W, of which the card holds
    `resident_tile` at once (a rank's 241-row window, the 3-row bands,
    2-D blocks)."""
    march = launch_geometry(nl, rows, cols, resident)
    if nl * march.strips_x * march.strips_y >= resident:
        return march
    return Geometry(TILE_W, TILE_H, -(-cols // TILE_W), -(-rows // TILE_H),
                    True)


class _QgParams(ctypes.Structure):
    # Mirrors struct QgParams in csrc/qgstep.cu.
    _fields_ = [("nl", ctypes.c_int), ("ny", ctypes.c_int),
                ("nx", ctypes.c_int), ("cyclic", ctypes.c_int),
                ("sponge", ctypes.c_int), ("strip_w", ctypes.c_int),
                ("strip_h", ctypes.c_int), ("strips_x", ctypes.c_int),
                ("strips_y", ctypes.c_int), ("tiled", ctypes.c_int),
                ("ny_in", ctypes.c_int), ("nx_in", ctypes.c_int),
                ("gy", ctypes.c_int), ("gx", ctypes.c_int),
                ("row0", ctypes.c_int), ("col0", ctypes.c_int),
                ("ny_total", ctypes.c_int), ("nx_total", ctypes.c_int),
                ("members", ctypes.c_int),
                ("mstride", ctypes.c_int * N_INPUTS),
                ("c", ctypes.c_double * N_CONSTS),
                ("ah2", ctypes.c_double * MAX_LAYERS),
                ("ah4", ctypes.c_double * MAX_LAYERS)]


@functools.cache
def build_kernel():
    """Build (or find) and load csrc/qgstep.cu, once per process; called
    at the first launch. Returns the ops._cuda.Library."""
    from ._cuda import build
    lib = build("qgstep")
    for fn in (lib.cdll.qgstep_f32, lib.cdll.qgstep_f64):
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.POINTER(_QgParams), ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cdll.qgstep_resident_blocks.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.cdll.qgstep_resident_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def resident_blocks(device: torch.device, dtype: torch.dtype,
                    sponge: bool, batched: bool = False,
                    tiled: bool = False) -> int:
    """Blocks of the kernel that the card holds at once, for this type,
    sponge setting (the sponge's ring takes the march's shared memory)
    and instance (the march for one member or several, or the window
    tile)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build_kernel().cdll.qgstep_resident_blocks(
            int(dtype == torch.float64), int(sponge),
            2 if tiled else int(batched), ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"qgstep occupancy query failed: CUDA error {err}, "
                           f"{n.value} blocks")
    return n.value


def _check(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
           sponge, window, members=None):
    """Check the arguments; `window` is None for the full field, else
    the (R, C) of the output, which qom and the planes take. With
    `members` (M) every field carries a leading member axis, (M, nl, ny,
    nx) and planes (M, ny, nx), whose contiguity the launch checks."""
    fields = {"pom": pom, "po": po, "qo": qo}
    planes = {"wekpo": wekpo, "entoc": entoc}
    if sponge:
        planes["r_spl"] = r_spl
    lead = () if members is None else (members,)
    if pom.dim() != 3 + len(lead):
        raise ValueError(f"pom must be ({'[M,] ' if lead else ''}nl, ny, "
                         f"nx), got {tuple(pom.shape)}")
    nl, ny, nx = pom.shape[-3:]
    out = (ny, nx) if window is None else window
    if nl < 2 or min(out) < (3 if window is None else 1):
        raise ValueError(f"need nl >= 2 and a larger grid; got "
                         f"{tuple(pom.shape)}")
    for name, t in {**fields, "qom": qom, **planes}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        want = lead + ((nl, ny, nx) if name in fields
                       else (nl, *out) if name == "qom" else out)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            "float32 or float64")
        if t.dtype != pom.dtype or t.device != pom.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, pom is "
                             f"{pom.dtype} on {pom.device}")
        if members is None and not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if len(consts) != N_CONSTS:
        raise ValueError(f"consts needs {N_CONSTS} values, got {len(consts)}")
    if len(ah2) != nl or len(ah4) != nl:
        raise ValueError(f"ah2/ah4 need one value per layer (nl={nl})")


def _inner_contiguous(t) -> bool:
    """Whether t is contiguous apart from its leading (member) axis."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def _launch(inputs, consts, ah2, ah4, cyclic, sponge, mode, window=None,
            row0=None, ny_total=None, col0=0, nx_total=None, x_ext=False):
    """Launch the kernel on CUDA tensors. `inputs` are (pom, po, qo, qom,
    wekpo, entoc, r_spl) with a leading member axis of M (1 in the window
    modes), each contiguous apart from it (the callers check); the member
    stride is free (0 shares one copy among the members). Returns the
    (M, nl, R, C) output and counts the launch."""
    pom = inputs[0]
    for name, t in zip(INPUT_NAMES, inputs):
        if t is not None and t.shape[0] > 1 and not 0 <= t.stride(0) < 2**31:
            raise ValueError(f"{name} has member stride {t.stride(0)}")
    members, nl, ny_in, nx_in = pom.shape
    ny, nx = (ny_in, nx_in) if window is None else window
    if nl > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, "
                         f"got {nl}")
    lib = build_kernel().cdll
    resident = resident_blocks(pom.device, pom.dtype, sponge, members > 1)
    geom = (launch_geometry(members * nl, ny, nx, resident) if window is None
            else window_geometry(nl, ny, nx, resident, resident_blocks(
                pom.device, pom.dtype, sponge, tiled=True)))
    gy = 0 if window is None else HALO
    gx = HALO if x_ext else 0
    prm = _QgParams(nl=nl, ny=ny, nx=nx, cyclic=int(cyclic),
                    sponge=int(sponge), strip_w=geom.strip_w,
                    strip_h=geom.strip_h, strips_x=geom.strips_x,
                    strips_y=geom.strips_y, tiled=int(geom.tiled),
                    ny_in=ny_in, nx_in=nx_in, gy=gy, gx=gx,
                    row0=0 if window is None else int(row0) + HALO,
                    col0=int(col0),
                    ny_total=ny if window is None else int(ny_total),
                    nx_total=nx if window is None else int(nx_total),
                    members=members)
    prm.mstride[:] = [t.stride(0) if t is not None and members > 1 else 0
                      for t in inputs]
    prm.c[:] = [float(c) for c in consts]
    prm.ah2[:nl] = [float(a) for a in ah2]
    prm.ah4[:nl] = [float(a) for a in ah4]
    out = torch.empty((members, nl, ny, nx), dtype=pom.dtype,
                      device=pom.device)
    fn = lib.qgstep_f32 if pom.dtype == torch.float32 else lib.qgstep_f64
    with torch.cuda.device(pom.device):
        stream = torch.cuda.current_stream(pom.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in inputs),
                 out.data_ptr(), ctypes.byref(prm), stream)
    if err != 0:
        raise RuntimeError(f"qgstep kernel launch failed: CUDA error {err}")
    qgstep.launches += 1
    qgstep.mode_launches[mode] += 1
    qgstep.members += members
    return out


def plain_members(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                  cyclic, sponge):
    """The plain version of a member-batched step: qgstep_reference over
    the leading member axis of every input (torch.func.vmap; one member
    directly)."""
    def one(*xs):
        return qgstep_reference(*xs, consts, ah2, ah4, cyclic=cyclic,
                                sponge=sponge)
    if pom.shape[0] == 1:
        return one(*(None if t is None else t[0] for t in (
            pom, po, qo, qom, wekpo, entoc, r_spl))).unsqueeze(0)
    dims = (0,) * 6 + (None if r_spl is None else 0,)
    return torch.func.vmap(one, in_dims=dims)(pom, po, qo, qom, wekpo,
                                              entoc, r_spl)


def step_members(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                 cyclic, sponge):
    """The member-batched full-field step: fields (M, nl, ny, nx), planes
    (M, ny, nx), each contiguous apart from its member axis, whose stride
    may be 0 (an input all members share). CUDA: one launch of the kernel
    for all members. CPU: plain_members. Profiles name it
    `qgcm_torch::qgstep`."""
    inputs = (pom, po, qo, qom, wekpo, entoc, r_spl)
    for name, t in zip(INPUT_NAMES, inputs):
        if t is not None and not (t.is_contiguous() or _inner_contiguous(t)):
            raise ValueError(f"{name} is not contiguous within a member")
    with (torch.profiler.record_function("qgcm_torch::qgstep")
          if torch.autograd._profiler_enabled() else contextlib.nullcontext()):
        if pom.device.type == "cuda":
            return _launch(inputs, consts, ah2, ah4, cyclic, sponge, "full")
        return plain_members(*inputs, consts, ah2, ah4, cyclic, sponge)


class _Step(torch.autograd.Function):
    """step_members with its rules. Gradients (reverse and forward mode)
    are those of plain_members, recomputed from the saved inputs, as
    qgcm_tpu differentiates its op chain (qgcm_tpu/adjoint.py:89-98): on
    the card the forward is the kernel and the backward the plain chain.
    Under torch.func.vmap the batch axis folds into the member axis, so a
    vmap over members is one launch whatever their number."""

    @staticmethod
    def forward(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                cyclic, sponge):
        return step_members(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                            ah2, ah4, cyclic, sponge)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:N_INPUTS])
        ctx.save_for_forward(*inputs[:N_INPUTS])
        ctx.rest = inputs[N_INPUTS:]

    @staticmethod
    def _plain(ctx):
        """(plain function of the differentiable inputs, those inputs)."""
        saved = ctx.saved_tensors
        primals = [t for t in saved if t is not None]
        sponge_in = saved[-1] is not None

        def fn(*xs):
            return plain_members(*xs[:6], xs[6] if sponge_in else None,
                                 *ctx.rest)
        return fn, primals

    @staticmethod
    def backward(ctx, grad):
        fn, primals = _Step._plain(ctx)
        grads = list(torch.func.vjp(fn, *primals)[1](grad))
        if len(grads) < N_INPUTS:
            grads.append(None)
        return (*grads, *(None,) * len(ctx.rest))

    @staticmethod
    def jvp(ctx, *tangents):
        fn, primals = _Step._plain(ctx)
        # forward-mode duals cannot be made of tensors whose elements
        # share memory (a member stride of 0)
        tans = [torch.zeros_like(p) if t is None else t.contiguous()
                for p, t in zip(primals, tangents)]
        return torch.func.jvp(fn, tuple(p.contiguous() for p in primals),
                              tuple(tans))[1]

    @staticmethod
    def vmap(info, in_dims, *args):
        b = info.batch_size

        def fold(x, d):
            if x is None:
                return None
            x = x.movedim(d, 0) if d is not None else x.expand(b, *x.shape)
            x = x.reshape(-1, *x.shape[2:])
            return x if _inner_contiguous(x) else x.contiguous()

        tensors = [fold(x, d) for x, d in zip(args[:N_INPUTS],
                                              in_dims[:N_INPUTS])]
        out = _Step.apply(*tensors, *args[N_INPUTS:])
        return out.unflatten(0, (b, -1)), 0


def qgstep(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, *,
           cyclic: bool, sponge: bool, row0=None, ny_total=None, col0=0,
           nx_total=None, x_ext: bool = False):
    """Fused vorticity leapfrog. `consts`: float tuple (dxm2, bcfac,
    adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0, beta*dy, f0/H0, f0/H1);
    ah2/ah4: per-layer floats; r_spl may be None without the sponge.
    Returns qo_new with the zonal rows carrying the old qo.

    Members: pom, po, qo and qom of shape (M, nl, ny, nx) step M members
    in one launch, the planes (wekpo, entoc, r_spl) either (M, ny, nx) or
    (ny, nx), shared by all; the result is (M, nl, ny, nx). The full
    field goes through step_members and its autograd and vmap rules
    (_Step), so the step can be differentiated and vmapped: a vmap over
    members is one launch too.

    With `row0` (an int) the call is a window's (pallas_qg.py:227-244),
    of one member:
    pom, po and qo are (nl, R+6, W) windows of 3 ghost rows each side
    whose row 0 sits at global row `row0` of a grid `ny_total` rows
    tall; qom, wekpo, entoc, r_spl and the result are the (nl, R, C)
    core, whose rows at or beyond ny_total are padding (zero out). Row
    mode: C = W, the grid's whole width. x_ext (box only): W = C + 6
    with 3 real ghost columns each side, the core's column 0 at global
    column `col0` of a grid `nx_total` wide (columns beyond are
    padding). A window goes through step_window, and through its rules
    (_Window) where autograd or a transform sees the call."""
    if row0 is None:
        if x_ext or ny_total is not None or nx_total is not None or col0:
            raise ValueError("window arguments need row0")
        return _full(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2,
                     ah4, cyclic, sponge)
    if x_ext and cyclic:
        raise ValueError("x_ext windows are for the box only")
    if ny_total is None:
        raise ValueError("a window needs ny_total")
    ghost = 2 * HALO
    if pom.dim() != 3 or pom.shape[1] <= ghost or (
            x_ext and pom.shape[2] <= ghost):
        raise ValueError(f"a window needs {HALO} ghost rows (and "
                         f"x_ext columns) each side, and one member; "
                         f"got {tuple(pom.shape)}")
    window = (pom.shape[1] - ghost, pom.shape[2] - (ghost if x_ext else 0))
    nx_total = window[1] if nx_total is None else nx_total
    if not x_ext and (col0 != 0 or nx_total != window[1]):
        raise ValueError("a row window spans the whole width")
    _check(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, sponge,
           window)
    _device_ok(pom)
    where = _Where(bool(cyclic), bool(sponge), int(row0), int(ny_total),
                   int(col0), int(nx_total), bool(x_ext))
    args = (pom, po, qo, qom, wekpo, entoc, r_spl if sponge else None,
            [float(c) for c in consts], [float(a) for a in ah2],
            [float(a) for a in ah4], where)
    step = _Window.apply if _seen(args[:N_INPUTS]) else step_window
    return step(*args)


class _Where(NamedTuple):
    """Where a window lies (qgstep's window arguments), and the step's
    two switches."""
    cyclic: bool
    sponge: bool
    row0: int
    ny_total: int
    col0: int
    nx_total: int
    x_ext: bool


def _window_plain(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                  where):
    return window_reference(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                            ah2, ah4, cyclic=where.cyclic,
                            sponge=where.sponge, row0=where.row0,
                            ny_total=where.ny_total, col0=where.col0,
                            nx_total=where.nx_total, x_ext=where.x_ext)


def step_window(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                where):
    """A window's step: on CUDA one launch of the kernel in the row or
    x_ext mode, on the CPU window_reference."""
    if pom.device.type == "cpu":
        return _window_plain(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                             ah2, ah4, where)
    rows = pom.shape[1] - 2 * HALO
    window = (rows, pom.shape[2] - (2 * HALO if where.x_ext else 0))
    inputs = [None if t is None else t.unsqueeze(0)
              for t in (pom, po, qo, qom, wekpo, entoc, r_spl)]
    return _launch(inputs, consts, ah2, ah4, where.cyclic, where.sponge,
                   "x_ext" if where.x_ext else "rows", window, where.row0,
                   where.ny_total, where.col0, where.nx_total,
                   where.x_ext)[0]


class _Window(torch.autograd.Function):
    """step_window with its reverse-mode rule, as _Step is the full
    field's: the forward is the kernel on the card (window_reference on
    the CPU); the gradient is window_reference's VJP, recomputed from the
    saved inputs. A window's padding rows and columns (at or beyond
    ny_total / nx_total) come out zero, so their cotangents reach no
    input, and the inputs' padding gets none. Windows run only in the
    mesh runners, whose collectives have no forward-mode or vmap rules,
    so neither has this one: under those transforms it raises."""

    @staticmethod
    def forward(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
                where):
        return step_window(pom, po, qo, qom, wekpo, entoc, r_spl, consts,
                           ah2, ah4, where)

    setup_context = staticmethod(_Step.setup_context)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        primals = [t for t in saved if t is not None]
        sponge_in = saved[-1] is not None

        def fn(*xs):
            return _window_plain(*xs[:6], xs[6] if sponge_in else None,
                                 *ctx.rest)
        grads = list(torch.func.vjp(fn, *primals)[1](grad))
        if len(grads) < N_INPUTS:
            grads.append(None)
        return (*grads, *(None,) * len(ctx.rest))


def _device_ok(pom):
    if pom.device.type not in ("cuda", "cpu"):
        raise ValueError(f"qgstep runs on cuda or cpu, not {pom.device}")


def _full(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, cyclic,
          sponge):
    """The full field, with one member or with M: through _Step where a
    transform or autograd may see the step, else straight to
    step_members, which checks contiguity within a member (under vmap a
    tensor's layout is the batch's, not the caller's)."""
    batched = pom.dim() == 4
    r_spl = r_spl if sponge else None
    fields = [pom, po, qo, qom]
    planes = [wekpo, entoc, r_spl]
    if not batched:
        fields = [t.unsqueeze(0) if torch.is_tensor(t) else t
                  for t in fields]
    m = fields[0].shape[0]
    planes = [t.expand(m, *t.shape) if torch.is_tensor(t) and t.dim() == 2
              else t for t in planes]
    _check(*fields, *planes, consts, ah2, ah4, sponge, None, m)
    _device_ok(pom)
    args = (*fields, *planes, [float(c) for c in consts],
            [float(a) for a in ah2], [float(a) for a in ah4], bool(cyclic),
            bool(sponge))
    step = _Step.apply if _seen(fields + planes) else step_members
    out = step(*args)
    return out if batched else out[0]


def _seen(tensors) -> bool:
    """Whether the step must go through its rules (_Step): a torch.func
    transform or a forward-mode AD level is active, or autograd would
    record it. Otherwise the rules' bookkeeping is host time and
    nothing more (about 60 us a call)."""
    return (torch._C._functorch.maybe_current_level() is not None
            or torch.autograd.forward_ad._current_level >= 0
            or (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in tensors)))


def reset_launches():
    """Set qgstep's counts to zero: its launches, by mode, and the members
    its full-field launches stepped."""
    qgstep.launches = 0
    qgstep.mode_launches = dict.fromkeys(MODES, 0)
    qgstep.members = 0


reset_launches()
