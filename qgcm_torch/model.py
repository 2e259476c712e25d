"""Model assembly: one-time host-side initialisation (port of
qgcm_tpu/model.py, ocean-only box configurations).

Everything is computed in float64 NumPy on the host, exactly as in the
JAX package, and the arrays the step reads are moved to the model's
device and dtype once, here. Coupled, atmosphere-only and cyclic
configurations come in later slices of the port and are refused.
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
from .topo import Topography, build_topography
from .ops.integrals import xintp_weights
from .solver.helmholtz import BoxHelmholtz, make_box_helmholtz


@dataclass(frozen=True)
class OceanInversion:
    """Static data of the box PV inversion (ocinvq, conhoms.F:544-641).
    The homogeneous-solution field is never stored: the step applies it
    spectrally (models/ocean.py)."""
    helm: BoxHelmholtz
    cdiffo: torch.Tensor             # (nlo, nlo-1)
    cdhinv: torch.Tensor             # (nlo-1, nlo-1) inverse of cdhoc


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    # host-side float64 init (NumPy)
    grids: Grids
    modes_oc: Modes
    rad: Radiation
    topo: Topography
    # device tensors in `dtype`
    inv_oc: OceanInversion
    amat: torch.Tensor               # (nlo, nlo) modes_oc.amat
    cl2m: torch.Tensor               # (nlo, nlo) layer -> mode
    cm2l: torch.Tensor               # (nlo, nlo) mode -> layer
    gpoc: torch.Tensor               # (nlo-1,) reduced gravities
    yporel: torch.Tensor             # (nypo,) p-row y relative to centre
    ddyn: torch.Tensor               # () zero, or (nypo, nxpo) topography
    r_spl: Optional[torch.Tensor]    # (nypo, nxpo) k247 sponge ramp


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


def _build_ocean_inversion(cfg: ModelConfig, grids: Grids, modes: Modes,
                           wop: np.ndarray, device,
                           dtype) -> OceanInversion:
    """Box inversion data (conhoms.F:544-641), float64 on the host."""
    nxpo, nypo = cfg.nxpo, cfg.nypo
    dxo, dyo = grids.dxo, grids.dyo
    nlo = cfg.nlo
    helm = make_box_helmholtz(nxpo, nypo, dxo, dyo, modes.rdm2,
                              dtype=dtype, device=device)
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
    if cfg.atmos_only or not cfg.ocean_only or cfg.tau_udiff:
        raise NotImplementedError(
            "qgcm_torch runs ocean-only configurations so far; coupled "
            "and atmosphere-only models come in a later slice")
    if cfg.cyclic_ocean:
        raise NotImplementedError(
            "qgcm_torch runs the box ocean so far; the cyclic channel "
            "comes in a later slice")
    if cfg.solver_transform == "matmul":
        raise NotImplementedError(
            "solver_transform='matmul' (the GEMM DST) is not ported; use "
            "'fft' or 'auto'")
    if cfg.solver_transform not in ("auto", "fft"):
        raise ValueError(f"unknown solver_transform {cfg.solver_transform!r}")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, not {cfg.dtype}")


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Build the static model data of an ocean-only box configuration,
    over flat topography, on `device` ('cuda[:n]', the default, or
    'cpu'; see device.py)."""
    cfg = cfg.validate()
    _check_supported(cfg)
    device = resolve_device(device)
    if device.type == "cuda":
        # The step's float32 matmuls (the layer <-> mode einsums) must
        # run in full float32: TF32 keeps about three decimal digits,
        # far fewer than the PV inversion carries. PyTorch's switches
        # are process-wide, so they are set here, where a model is put
        # on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cfg.dtype)

    def to_dev(a):
        return _tensor(a, device, dtype)

    grids = build_grids(cfg)
    modes_oc = eigenmodes(cfg.ocean.gpoc, cfg.ocean.hoc, cfg.fnot)
    rad = radiat(cfg, grids)
    topo = build_topography(cfg, grids)
    wop = xintp_weights(cfg.nypo, cfg.nxpo)
    inv_oc = _build_ocean_inversion(cfg, grids, modes_oc, wop, device,
                                    dtype)
    ddyn = topo.ddynoc if topo.ddynoc.any() else np.zeros(())
    return Model(
        cfg=cfg, device=device, dtype=dtype,
        grids=grids, modes_oc=modes_oc, rad=rad, topo=topo,
        inv_oc=inv_oc,
        amat=to_dev(modes_oc.amat), cl2m=to_dev(modes_oc.cl2m),
        cm2l=to_dev(modes_oc.cm2l), gpoc=to_dev(cfg.ocean.gpoc),
        yporel=to_dev(grids.yporel), ddyn=to_dev(ddyn),
        r_spl=to_dev(_sponge_ramp(cfg)) if cfg.sponge.enabled else None,
    )
