"""The fused ocean vorticity leapfrog: the CUDA kernel's wrapper and its
plain PyTorch version.

`qgstep` has the signature and meaning of the Pallas TPU kernel
qgcm_tpu/ops/pallas_qg.py::qgstep_pallas in its full-field mode. On
CUDA tensors it launches the hand-written kernel of csrc/qgstep.cu
(built on first use, see ops/_cuda.py) and adds one to
`qgstep.launches`; on CPU tensors it returns `qgstep_reference`, the
plain chain of stencil operators (qgcm_tpu/models/ocean.py:272-317).
There is no fallback between the two: a CUDA tensor gets the kernel or
an exception.
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
           sponge):
    fields = {"pom": pom, "po": po, "qo": qo, "qom": qom}
    planes = {"wekpo": wekpo, "entoc": entoc}
    if sponge:
        planes["r_spl"] = r_spl
    if pom.dim() != 3:
        raise ValueError(f"pom must be (nl, ny, nx), got {tuple(pom.shape)}")
    nl, ny, nx = pom.shape
    if nl < 2 or ny < 3 or nx < 3:
        raise ValueError(f"need nl >= 2, ny >= 3, nx >= 3; got "
                         f"{tuple(pom.shape)}")
    for name, t in {**fields, **planes}.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        want = (nl, ny, nx) if name in fields else (ny, nx)
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
           cyclic: bool, sponge: bool):
    """Fused vorticity leapfrog. `consts`: float tuple (dxm2, bcfac,
    adfac, 1/f0, 2dt, bdrfac, c1spl, beta*y0, beta*dy, f0/H0, f0/H1);
    ah2/ah4: per-layer floats; r_spl may be None without the sponge.
    Returns qo_new with the zonal rows carrying the old qo."""
    _check(pom, po, qo, qom, wekpo, entoc, r_spl, consts, ah2, ah4, sponge)
    if pom.device.type == "cpu":
        return qgstep_reference(pom, po, qo, qom, wekpo, entoc, r_spl,
                                consts, ah2, ah4, cyclic=cyclic,
                                sponge=sponge)
    if pom.device.type != "cuda":
        raise ValueError(f"qgstep runs on cuda or cpu, not {pom.device}")

    nl, ny, nx = pom.shape
    if nl > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, "
                         f"got {nl}")
    lib = build_kernel().cdll
    geom = launch_geometry(nl, ny, nx,
                           resident_blocks(pom.device, pom.dtype, sponge))
    prm = _QgParams(nl=nl, ny=ny, nx=nx, cyclic=int(cyclic),
                    sponge=int(sponge), strip_w=geom.strip_w,
                    strip_h=geom.strip_h, strips_x=geom.strips_x,
                    strips_y=geom.strips_y, pad=0)
    prm.c[:] = [float(c) for c in consts]
    prm.ah2[:nl] = [float(a) for a in ah2]
    prm.ah4[:nl] = [float(a) for a in ah4]
    out = torch.empty_like(pom)
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
    return out


qgstep.launches = 0
