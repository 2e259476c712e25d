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
# ghost rows (and, in x_ext mode, columns) on each side of a window:
# del6 is three nested 5-point stencils (kHalo in csrc/qgstep.cu)
HALO = 3
MODES = ("full", "rows", "x_ext")


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
    """The kernel's launch geometry. Block (bx, by, k) of the grid
    (strips_x, strips_y, nl) owns layer k, rows [by*strip_h,
    min((by+1)*strip_h, ny)) and columns [bx*strip_w, min((bx+1)*strip_w,
    nx)), as csrc/qgstep.cu computes them."""
    strip_w: int
    strip_h: int
    strips_x: int
    strips_y: int


def launch_geometry(nl: int, ny: int, nx: int, resident: int) -> Geometry:
    """Strips of STRIP_W columns, and of the fewest rows that keep the
    launch within one wave of `resident` blocks (those the card holds at
    once), within [MIN_STRIP_H, MAX_STRIP_H]. The last strip of each
    direction may be narrower or shorter."""
    strips_x = -(-nx // STRIP_W)
    per_column = resident // (nl * strips_x)
    h = -(-ny // per_column) if per_column else MAX_STRIP_H
    h = min(max(h, MIN_STRIP_H), MAX_STRIP_H)
    return Geometry(STRIP_W, h, strips_x, -(-ny // h))


class _QgParams(ctypes.Structure):
    # Mirrors struct QgParams in csrc/qgstep.cu.
    _fields_ = [("nl", ctypes.c_int), ("ny", ctypes.c_int),
                ("nx", ctypes.c_int), ("cyclic", ctypes.c_int),
                ("sponge", ctypes.c_int), ("strip_w", ctypes.c_int),
                ("strip_h", ctypes.c_int), ("strips_x", ctypes.c_int),
                ("strips_y", ctypes.c_int), ("pad", ctypes.c_int),
                ("ny_in", ctypes.c_int), ("nx_in", ctypes.c_int),
                ("gy", ctypes.c_int), ("gx", ctypes.c_int),
                ("row0", ctypes.c_int), ("col0", ctypes.c_int),
                ("ny_total", ctypes.c_int), ("nx_total", ctypes.c_int),
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
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.cdll.qgstep_resident_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def resident_blocks(device: torch.device, dtype: torch.dtype,
                    sponge: bool) -> int:
    """Blocks of the kernel that the card holds at once, for this type and
    sponge setting (the sponge's ring takes shared memory)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build_kernel().cdll.qgstep_resident_blocks(
            int(dtype == torch.float64), int(sponge), ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"qgstep occupancy query failed: CUDA error {err}, "
                           f"{n.value} blocks")
    return n.value


def _check(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4,
           sponge, window):
    """Check the arguments; `window` is None for the full field, else
    the (R, C) of the output, which qom and the planes take."""
    fields = {"pom": pom, "po": po, "qo": qo}
    planes = {"wekpo": wekpo, "entoc": entoc}
    if sponge:
        planes["r_spl"] = r_spl
    if pom.dim() != 3:
        raise ValueError(f"pom must be (nl, ny, nx), got {tuple(pom.shape)}")
    nl, ny, nx = pom.shape
    out = (ny, nx) if window is None else window
    if nl < 2 or min(out) < (3 if window is None else 1):
        raise ValueError(f"need nl >= 2 and a larger grid; got "
                         f"{tuple(pom.shape)}")
    for name, t in {**fields, "qom": qom, **planes}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        want = ((nl, ny, nx) if name in fields
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
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if len(consts) != N_CONSTS:
        raise ValueError(f"consts needs {N_CONSTS} values, got {len(consts)}")
    if len(ah2) != nl or len(ah4) != nl:
        raise ValueError(f"ah2/ah4 need one value per layer (nl={nl})")


def qgstep(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, *,
           cyclic: bool, sponge: bool, row0=None, ny_total=None, col0=0,
           nx_total=None, x_ext: bool = False):
    """Fused vorticity leapfrog. `consts`: float tuple (dxm2, bcfac,
    adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0, beta*dy, f0/H0, f0/H1);
    ah2/ah4: per-layer floats; r_spl may be None without the sponge.
    Returns qo_new with the zonal rows carrying the old qo.

    With `row0` (an int) the call is a window's (pallas_qg.py:227-244):
    pom, po and qo are (nl, R+6, W) windows of 3 ghost rows each side
    whose row 0 sits at global row `row0` of a grid `ny_total` rows
    tall; qom, wekpo, entoc, r_spl and the result are the (nl, R, C)
    core, whose rows at or beyond ny_total are padding (zero out). Row
    mode: C = W, the grid's whole width. x_ext (box only): W = C + 6
    with 3 real ghost columns each side, the core's column 0 at global
    column `col0` of a grid `nx_total` wide (columns beyond are
    padding)."""
    window = None
    mode = "full"
    if row0 is not None:
        mode = "x_ext" if x_ext else "rows"
        if x_ext and cyclic:
            raise ValueError("x_ext windows are for the box only")
        if ny_total is None:
            raise ValueError("a window needs ny_total")
        ghost = 2 * HALO
        if pom.dim() != 3 or pom.shape[1] <= ghost or (
                x_ext and pom.shape[2] <= ghost):
            raise ValueError(f"a window needs {HALO} ghost rows (and "
                             f"x_ext columns) each side; got "
                             f"{tuple(pom.shape)}")
        window = (pom.shape[1] - ghost,
                  pom.shape[2] - (ghost if x_ext else 0))
        nx_total = window[1] if nx_total is None else nx_total
        if not x_ext and (col0 != 0 or nx_total != window[1]):
            raise ValueError("a row window spans the whole width")
    elif x_ext or ny_total is not None or nx_total is not None or col0:
        raise ValueError("window arguments need row0")
    _check(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, sponge,
           window)
    if pom.device.type == "cpu":
        if window is None:
            return qgstep_reference(pom, po, qo, qom, wekpo, entoc, r_spl,
                                    consts, ah2, ah4, cyclic=cyclic,
                                    sponge=sponge)
        return window_reference(pom, po, qo, qom, wekpo, entoc, r_spl,
                                consts, ah2, ah4, cyclic=cyclic,
                                sponge=sponge, row0=row0, ny_total=ny_total,
                                col0=col0, nx_total=nx_total, x_ext=x_ext)
    if pom.device.type != "cuda":
        raise ValueError(f"qgstep runs on cuda or cpu, not {pom.device}")

    nl, ny_in, nx_in = pom.shape
    ny, nx = (ny_in, nx_in) if window is None else window
    if nl > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, "
                         f"got {nl}")
    lib = build_kernel().cdll
    geom = launch_geometry(nl, ny, nx,
                           resident_blocks(pom.device, pom.dtype, sponge))
    gy = 0 if window is None else HALO
    gx = HALO if x_ext else 0
    prm = _QgParams(nl=nl, ny=ny, nx=nx, cyclic=int(cyclic),
                    sponge=int(sponge), strip_w=geom.strip_w,
                    strip_h=geom.strip_h, strips_x=geom.strips_x,
                    strips_y=geom.strips_y, pad=0, ny_in=ny_in,
                    nx_in=nx_in, gy=gy, gx=gx,
                    row0=0 if window is None else int(row0) + HALO,
                    col0=int(col0),
                    ny_total=ny if window is None else int(ny_total),
                    nx_total=nx if window is None else int(nx_total))
    prm.c[:] = [float(c) for c in consts]
    prm.ah2[:nl] = [float(a) for a in ah2]
    prm.ah4[:nl] = [float(a) for a in ah4]
    out = torch.empty((nl, ny, nx), dtype=pom.dtype, device=pom.device)
    fn = lib.qgstep_f32 if pom.dtype == torch.float32 else lib.qgstep_f64
    with torch.cuda.device(pom.device):
        stream = torch.cuda.current_stream(pom.device).cuda_stream
        err = fn(pom.data_ptr(), po.data_ptr(), qo.data_ptr(),
                 qom.data_ptr(), wekpo.data_ptr(), entoc.data_ptr(),
                 r_spl.data_ptr() if sponge else None, out.data_ptr(),
                 ctypes.byref(prm), stream)
    if err != 0:
        raise RuntimeError(f"qgstep kernel launch failed: CUDA error {err}")
    qgstep.launches += 1
    qgstep.mode_launches[mode] += 1
    return out


def reset_launches():
    """Set qgstep's launch counts to zero."""
    qgstep.launches = 0
    qgstep.mode_launches = dict.fromkeys(MODES, 0)


reset_launches()
