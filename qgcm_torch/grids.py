"""C-grid coordinates and the ocean-in-atmosphere embedding.

Replaces the coordinate construction in the reference main program
(src/q-gcm.F:389-431). Pressure (p) points sit at cell corners,
temperature (T) points at cell centres. Ocean coordinates include the
offset of the ocean box within the atmospheric domain.

All arrays here are host-side NumPy float64 (init-time only).

Copied from qgcm_tpu/grids.py, which is NumPy-only but cannot be
imported without JAX (the qgcm_tpu package __init__ imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import ModelConfig


@dataclass(frozen=True)
class Grids:
    # atmosphere
    dxa: float
    dya: float
    xla: float
    yla: float
    xpa: np.ndarray   # (nxpa,)
    ypa: np.ndarray   # (nypa,)
    xta: np.ndarray   # (nxta,)
    yta: np.ndarray   # (nyta,)
    yparel: np.ndarray
    ytarel: np.ndarray
    # ocean
    dxo: float
    dyo: float
    xlo: float
    ylo: float
    xpo: np.ndarray   # (nxpo,)
    ypo: np.ndarray   # (nypo,)
    xto: np.ndarray   # (nxto,)
    yto: np.ndarray   # (nyto,)
    yporel: np.ndarray
    ytorel: np.ndarray


def build_grids(cfg: ModelConfig) -> Grids:
    dxo = cfg.ocean.dxo
    dyo = dxo
    dxa = cfg.dxa
    dya = dxa

    xla = cfg.nxta * dxa
    yla = cfg.nyta * dya
    xlo = cfg.nxto * dxo
    ylo = cfg.nyto * dyo

    i_a = np.arange(cfg.nxpa, dtype=np.float64)
    j_a = np.arange(cfg.nypa, dtype=np.float64)
    xpa = i_a * dxa
    ypa = j_a * dya
    xta = xpa[: cfg.nxta] + 0.5 * dxa
    yta = ypa[: cfg.nyta] + 0.5 * dya

    # Ocean p points offset by (nx1-1, ny1-1) atmospheric cells
    # (reference src/q-gcm.F:418-431).
    i_o = np.arange(cfg.nxpo, dtype=np.float64)
    j_o = np.arange(cfg.nypo, dtype=np.float64)
    xpo = i_o * dxo + (cfg.nx1 - 1) * dxa
    ypo = (cfg.ny1 - 1) * dya + j_o * dyo
    xto = xpo[: cfg.nxto] + 0.5 * dxo
    yto = ypo[: cfg.nyto] + 0.5 * dyo

    return Grids(
        dxa=dxa, dya=dya, xla=xla, yla=yla,
        xpa=xpa, ypa=ypa, xta=xta, yta=yta,
        yparel=ypa - 0.5 * yla, ytarel=yta - 0.5 * yla,
        dxo=dxo, dyo=dyo, xlo=xlo, ylo=ylo,
        xpo=xpo, ypo=ypo, xto=xto, yto=yto,
        yporel=ypo - 0.5 * yla, ytorel=yto - 0.5 * yla,
    )
