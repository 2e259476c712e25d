"""Model assembly: one-time host-side initialisation (port of
qgcm_tpu/model.py).

Everything is computed in float64 NumPy on the host, exactly as in the
JAX package, and the arrays the steps read are moved to the model's
device and dtype once, here: the ocean's (box or zonally-cyclic
channel), the atmosphere's (always a channel) and the coupling's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .device import resolve_device
from .grids import Grids, build_grids
from .modes import Modes, eigenmodes
from .radiation import Radiation, radiat
from .topo import Topography, TopoSpec, build_topography
from .coupling import Coupling, build_coupling
from .ops.integrals import xintp_weights
from .solver.helmholtz import (PRECISIONS, TRANSFORMS, BoxHelmholtz,
                               CyclicHelmholtz, make_box_helmholtz,
                               make_cyclic_helmholtz, resolve_transform,
                               resolve_ytransform)


@dataclass(frozen=True)
class OceanInversion:
    """Static data of the box PV inversion (ocinvq, conhoms.F:544-641).
    The homogeneous-solution field is never stored: the step applies it
    spectrally (models/ocean.py)."""
    helm: BoxHelmholtz
    cdiffo: torch.Tensor             # (nlo, nlo-1)
    cdhinv: torch.Tensor             # (nlo-1, nlo-1) inverse of cdhoc


@dataclass(frozen=True)
class ChannelInversion:
    """Static data of a zonally-cyclic channel's PV inversion: the
    cyclic ocean's (conhoms.F:376-543) and the atmosphere's
    (conhoms.F:644-811). Profiles are along y; the homogeneous
    solutions are constant in x. All but `helm` are float64 in any
    model dtype: models/ocean.py::_channel_pressure solves the
    momentum constraints in float64 (a few scalars and profiles a
    step)."""
    helm: CyclicHelmholtz
    cl2m: torch.Tensor               # (m, k) layer -> mode
    cm2l: torch.Tensor               # (k, m) mode -> layer
    pbh: torch.Tensor                # (nyp,) barotropic homog. profile
    pch1: torch.Tensor               # (nl-1, nyp) baroclinic, 1 at S
    pch2: torch.Tensor               # (nl-1, nyp) baroclinic, 1 at N
    hbsi: float
    aipbh: float
    aipch: torch.Tensor              # (nl-1,) area integrals
    hc1s: torch.Tensor               # (nl-1,) boundary-coefficient
    hc2s: torch.Tensor               #   inverses (ocisubs.F:238-246)
    hc1n: torch.Tensor
    hc2n: torch.Tensor


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    # host-side float64 init (NumPy)
    grids: Grids
    modes_oc: Modes
    modes_at: Modes
    rad: Radiation
    topo: Topography
    # device tensors in `dtype`: ocean (None when atmos_only) ...
    inv_oc: Optional[OceanInversion | ChannelInversion]
    amat: torch.Tensor               # (nlo, nlo) modes_oc.amat
    cl2m: torch.Tensor               # (nlo, nlo) layer -> mode
    cm2l: torch.Tensor               # (nlo, nlo) mode -> layer
    gpoc: torch.Tensor               # (nlo-1,) reduced gravities
    hoc: torch.Tensor                # (nlo,) layer thicknesses
    ah2oc: torch.Tensor              # (nlo,) Del-sqd viscosities
    ah4oc: torch.Tensor              # (nlo,) Del-4th viscosities
    yporel: torch.Tensor             # (nypo,) p-row y relative to centre
    ddyn: torch.Tensor               # () zero, or (nypo, nxpo) topography
    dtopoc: torch.Tensor             # () zero, or (nypo, nxpo) topography (m)
    r_spl: Optional[torch.Tensor]    # (nypo, nxpo) k247 sponge ramp
    # ... atmosphere (inv_at None when ocean_only) ...
    inv_at: Optional[ChannelInversion]
    amat_at: torch.Tensor            # (nla, nla) modes_at.amat
    cl2m_at: torch.Tensor
    cm2l_at: torch.Tensor
    gpat: torch.Tensor               # (nla-1,)
    hat: torch.Tensor                # (nla,)
    ah4at: torch.Tensor              # (nla,) Del-4th viscosities
    afacdp: torch.Tensor             # (nla-1,) rad.aface / gpat
    xc1ast: torch.Tensor             # (nyta, 1) (1 - xcexp) * rad.astbar
    yparel: torch.Tensor             # (nypa,)
    ddyn_at: torch.Tensor            # () zero, or (nypa, nxpa)
    dtopat: torch.Tensor             # () zero, or (nypa, nxpa) topography
    # ... and the coupling (None when ocean_only without tau_udiff)
    coupling: Optional[Coupling]


def _sponge_ramp(cfg: ModelConfig) -> np.ndarray:
    """k247 sponge ramp (reference src/q-gcm.F:1152-1181): Gaussian-like
    ramps rising towards the N/S (and optionally W/E) boundaries. The
    reference uses 1-based indices i,j in the distance formula; so do
    we."""
    dxo = cfg.ocean.dxo
    dyo = dxo
    l_spl = cfg.sponge.l_spl
    i = np.arange(1, cfg.nxpo + 1, dtype=np.float64)
    j = np.arange(1, cfg.nypo + 1, dtype=np.float64)
    dy = (0.5 * dyo * cfg.nypo - np.abs(dyo * j - 0.5 * dyo * cfg.nypo))
    ry = np.exp(-2.0 * np.pi * (dy / l_spl) ** 2)
    r = np.broadcast_to(ry[:, None], (cfg.nypo, cfg.nxpo)).copy()
    if not cfg.sponge.nospl_in_ewbdy:
        dx = (0.5 * dxo * cfg.nxpo - np.abs(dxo * i - 0.5 * dxo * cfg.nxpo))
        rx = np.exp(-2.0 * np.pi * (dx / l_spl) ** 2)
        r = r + rx[None, :]
    return r


def _tensor(a, device, dtype) -> torch.Tensor:
    """float64 NumPy -> tensor of `dtype` on `device` (one rounding)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
        device=device, dtype=dtype)


def _channel_homogeneous(nyp: int, nxp: int, yp: np.ndarray,
                         rdm2: np.ndarray, dx: float, dy: float,
                         wp: np.ndarray):
    """Homogeneous solutions of a zonally-cyclic channel, float64 on
    the host (conhoms.F:376-543 ocean / :644-811 atmosphere).

    Returns (pbh, pch1, pch2, hbsi, aipbh, aipch, hc1s, hc2s, hc1n, hc2n).
    """
    nl = len(rdm2)
    yl = yp[-1] - yp[0]
    xl = (nxp - 1) * dx
    jj = np.arange(1, nyp + 1, dtype=np.float64)
    pbh = (nyp - jj) / (nyp - 1)
    hbsi = yl / xl
    aipbh = 0.5 * xl * yl

    # Baroclinic: pch = L(y) + rdm2*sol0 with Helmholtz{sol0} = L(y)
    L1 = (yp[-1] - yp) / yl                      # 1 at S, 0 at N
    L2 = (yp - yp[0]) / yl                       # 0 at S, 1 at N
    rhs = np.zeros((2 * (nl - 1), nyp, nxp))
    for m in range(nl - 1):
        rhs[2 * m] = L1[:, None]
        rhs[2 * m + 1] = L2[:, None]
    # a solver over the baroclinic modes, each repeated twice
    sub = make_cyclic_helmholtz(nxp, nyp, dx, dy, np.repeat(rdm2[1:], 2),
                                device="cpu")
    sol = sub.solve_np(rhs)

    pch1 = np.empty((nl - 1, nyp))
    pch2 = np.empty((nl - 1, nyp))
    aipch = np.empty(nl - 1)
    hc1s = np.empty(nl - 1)
    hc2s = np.empty(nl - 1)
    hc1n = np.empty(nl - 1)
    hc2n = np.empty(nl - 1)
    for m in range(nl - 1):
        f1 = L1[:, None] + rdm2[m + 1] * sol[2 * m]
        f2 = L2[:, None] + rdm2[m + 1] * sol[2 * m + 1]
        pch1[m] = f1[:, 0]
        pch2[m] = f2[:, 0]
        ai1 = (f1 * wp).sum() * dx * dy
        ai2 = (f2 * wp).sum() * dx * dy
        aipch[m] = 0.5 * (ai1 + ai2)
        # dp/dy half a gridpoint in from the boundaries, corrected and
        # converted to line integrals (conhoms.F:514-534)
        p1ys = -(pch1[m][1] - pch1[m][0]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch1[m][0]
        p2ys = -(pch2[m][1] - pch2[m][0]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch2[m][0]
        p1yn = (pch1[m][-1] - pch1[m][-2]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch1[m][-1]
        p2yn = (pch2[m][-1] - pch2[m][-2]) / dy \
            + 0.5 * dy * rdm2[m + 1] * pch2[m][-1]
        p1ys, p2ys, p1yn, p2yn = (xl * v for v in (p1ys, p2ys, p1yn, p2yn))
        det = p1ys * p2yn - p2ys * p1yn
        hc1s[m] = p1ys / det
        hc2s[m] = p2ys / det
        hc1n[m] = p1yn / det
        hc2n[m] = p2yn / det
    return pbh, pch1, pch2, hbsi, aipbh, aipch, hc1s, hc2s, hc1n, hc2n


def _build_channel_inversion(nxp: int, nyp: int, yp: np.ndarray,
                             modes: Modes, dx: float, dy: float, device,
                             dtype, ytransform: str,
                             mm_precision: str) -> ChannelInversion:
    helm = make_cyclic_helmholtz(nxp, nyp, dx, dy, modes.rdm2,
                                 dtype=dtype, device=device,
                                 ytransform=ytransform,
                                 mm_precision=mm_precision)
    (pbh, pch1, pch2, hbsi, aipbh, aipch, hc1s, hc2s, hc1n,
     hc2n) = _channel_homogeneous(nyp, nxp, yp, modes.rdm2, dx, dy,
                                  xintp_weights(nyp, nxp))

    def dev(a):
        return _tensor(a, device, torch.float64)

    return ChannelInversion(
        helm=helm, cl2m=dev(modes.cl2m), cm2l=dev(modes.cm2l),
        pbh=dev(pbh), pch1=dev(pch1), pch2=dev(pch2),
        hbsi=float(hbsi), aipbh=float(aipbh), aipch=dev(aipch),
        hc1s=dev(hc1s), hc2s=dev(hc2s), hc1n=dev(hc1n), hc2n=dev(hc2n))


def _build_ocean_inversion(cfg: ModelConfig, grids: Grids, modes: Modes,
                           device, dtype):
    """The ocean's inversion data: the channel's when cyclic, else the
    box's (conhoms.F:544-641), float64 on the host."""
    nxpo, nypo = cfg.nxpo, cfg.nypo
    dxo, dyo = grids.dxo, grids.dyo
    nlo = cfg.nlo
    if cfg.cyclic_ocean:
        return _build_channel_inversion(nxpo, nypo, grids.ypo, modes, dxo,
                                        dyo, device, dtype,
                                        resolve_ytransform(cfg, nypo),
                                        cfg.solver_precision)
    wop = xintp_weights(nypo, nxpo)
    helm = make_box_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2,
                              dtype=dtype, device=device,
                              transform=resolve_transform(cfg, nxpo, nypo),
                              mm_precision=cfg.solver_precision)
    sub = make_box_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2[1:],
                             device="cpu")
    sol0 = sub.solve_np(np.ones((nlo - 1, nypo, nxpo)))
    ochom = 1.0 + modes.rdm2[1:, None, None] * sol0
    aipohs = (ochom * wop[None]).sum(axis=(1, 2)) * dxo * dyo

    cm2l = modes.cm2l                              # (k, m)
    cdiffo = (cm2l[1:, :] - cm2l[:-1, :]).T        # (m, k): cdiffo[m,k]
    cdhoc = np.empty((nlo - 1, nlo - 1))
    for k in range(nlo - 1):
        for m in range(nlo - 1):
            cdhoc[k, m] = (cm2l[k + 1, m + 1] - cm2l[k, m + 1]) * aipohs[m]
    cdhinv = np.linalg.inv(cdhoc)
    return OceanInversion(helm=helm, cdiffo=_tensor(cdiffo, device, dtype),
                          cdhinv=_tensor(cdhinv, device, dtype))


def _check_supported(cfg: ModelConfig):
    if cfg.solver_transform not in ("auto", *TRANSFORMS):
        raise ValueError(f"unknown solver_transform {cfg.solver_transform!r}")
    if cfg.solver_precision not in PRECISIONS:
        raise ValueError(f"unknown solver_precision {cfg.solver_precision!r}")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, not {cfg.dtype}")


def _or_scalar(field: np.ndarray) -> np.ndarray:
    """A zero topography as a scalar, so that the steps add nothing
    grid-sized for it."""
    return field if field.any() else np.zeros(())


def build_model(cfg: ModelConfig, device="cuda",
                topocname: TopoSpec = "flat", topatname: TopoSpec = "flat",
                extant_oc=None, extant_at=None) -> Model:
    """Build the static model data of a configuration (ocean-only,
    coupled or atmosphere-only; box or cyclic ocean) on `device`
    ('cuda[:n]', the default, or 'cpu'; see device.py). The topography
    arguments are those of topo.build_topography: 'flat', 'define',
    'extant' (with extant_oc/extant_at), an array, or a netCDF path."""
    cfg = cfg.validate()
    _check_supported(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # The steps' float32 matmuls (the layer <-> mode einsums and the
        # coupling's bicubic contractions) must run in full float32:
        # TF32 keeps about three decimal digits, far fewer than the PV
        # inversion carries. PyTorch's switches are process-wide, so
        # they are set here, where a model is put on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg.dtype)

    def to_dev(a):
        return _tensor(a, device, dtype)

    grids = build_grids(cfg)
    modes_oc = eigenmodes(cfg.ocean.gpoc, cfg.ocean.hoc, cfg.fnot)
    modes_at = eigenmodes(cfg.atmos.gpat, cfg.atmos.hat, cfg.fnot)
    rad = radiat(cfg, grids)
    topo = build_topography(cfg, grids, topocname, topatname,
                            extant_oc=extant_oc, extant_at=extant_at)
    inv_oc = None if cfg.atmos_only else _build_ocean_inversion(
        cfg, grids, modes_oc, device, dtype)
    inv_at = None if cfg.ocean_only else _build_channel_inversion(
        cfg.nxpa, cfg.nypa, grids.ypa, modes_at, grids.dxa, grids.dya,
        device, dtype, resolve_ytransform(cfg, cfg.nypa),
        cfg.solver_precision)
    coupling = (build_coupling(cfg, grids, rad, device, dtype)
                if not cfg.ocean_only or cfg.tau_udiff else None)
    return Model(
        cfg=cfg, device=device, dtype=dtype,
        grids=grids, modes_oc=modes_oc, modes_at=modes_at, rad=rad,
        topo=topo,
        inv_oc=inv_oc,
        amat=to_dev(modes_oc.amat), cl2m=to_dev(modes_oc.cl2m),
        cm2l=to_dev(modes_oc.cm2l), gpoc=to_dev(cfg.ocean.gpoc),
        hoc=to_dev(cfg.ocean.hoc), ah2oc=to_dev(cfg.ocean.ah2oc),
        ah4oc=to_dev(cfg.ocean.ah4oc), yporel=to_dev(grids.yporel),
        ddyn=to_dev(_or_scalar(topo.ddynoc)),
        dtopoc=to_dev(_or_scalar(topo.dtopoc)),
        r_spl=to_dev(_sponge_ramp(cfg)) if cfg.sponge.enabled else None,
        inv_at=inv_at,
        amat_at=to_dev(modes_at.amat), cl2m_at=to_dev(modes_at.cl2m),
        cm2l_at=to_dev(modes_at.cm2l), gpat=to_dev(cfg.atmos.gpat),
        hat=to_dev(cfg.atmos.hat), ah4at=to_dev(cfg.atmos.ah4at),
        afacdp=to_dev(rad.aface) / to_dev(cfg.atmos.gpat),
        xc1ast=(1.0 - cfg.xcexp) * to_dev(rad.astbar)[:, None],
        yparel=to_dev(grids.yparel),
        ddyn_at=to_dev(_or_scalar(topo.ddynat)),
        dtopat=to_dev(_or_scalar(topo.dtopat)),
        coupling=coupling,
    )
