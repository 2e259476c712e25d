"""Initial-condition and forcing factories.

Replaces the k247 fork's standalone Fortran tools:
  src/k247_make_restart_q-gcm.F90 -- analytic Gaussian-eddy (Early et
    al. 2011 JPO) initial condition (and eddy pairs);
  src/k247_make_forcing_q-gcm.F90 -- mean-forcing file for ocean-only
    runs (the k247 tool writes zero forcing for unforced eddy runs).

Also provides an analytic double-gyre windstress for forced
ocean-only benchmarks.

Copied from qgcm_tpu/generators.py, which is NumPy-only but cannot be
imported without JAX (the qgcm_tpu package __init__ imports jax).
"""

from __future__ import annotations

import numpy as np

from .config import ModelConfig
from .grids import Grids

GRAV = 9.8


def eddy_pressure(cfg: ModelConfig, ssh_amp: float = 0.15,
                  l_efold: float = 80.0e3, po2_percent: float = 0.0,
                  cnt_dist: float = 0.0, pair_amp: float = 0.0):
    """Gaussian-eddy initial pressure (k247_make_restart_q-gcm.F90:
    220-262): ssh = A exp(-r^2/L^2) centred at the domain centre,
    po(1) = g*ssh, po(2) = (po2_percent/100)*po(1), deeper layers 0.
    Optionally an eddy pair offset by +-cnt_dist*l_efold in y.

    Returns po of shape (nlo, nypo, nxpo)."""
    dxo = cfg.ocean.dxo
    dyo = dxo
    nxpo, nypo, nlo = cfg.nxpo, cfg.nypo, cfg.nlo
    i_e, j_e = cfg.nxto // 2, cfg.nyto // 2
    # reference loop index i in -ini_ilen..ini_ilen maps to column i+i_e
    # (1-based) => 0-based column index c has i = c + 1 - i_e
    ii = np.arange(nxpo) + 1 - i_e
    jj = np.arange(nypo) + 1 - j_e
    j_dist = int((cnt_dist * l_efold) / dyo)

    def gauss(joff):
        r2 = ((dxo * ii[None, :]) ** 2
              + (dyo * (jj[:, None] - joff)) ** 2)
        return np.exp(-r2 / l_efold**2)

    ssh = ssh_amp * gauss(j_dist) + pair_amp * ssh_amp * gauss(-j_dist)
    po = np.zeros((nlo, nypo, nxpo))
    po[0] = GRAV * ssh
    if nlo > 1:
        po[1] = (po2_percent / 100.0) * po[0]
    return po


def zero_forcing(cfg: ModelConfig):
    """k247_make_forcing equivalent: zero mean forcing
    (tauxo, tauyo, fnetoc)."""
    return (np.zeros((cfg.nypo, cfg.nxpo)),
            np.zeros((cfg.nypo, cfg.nxpo)),
            np.zeros((cfg.nyto, cfg.nxto)))


def double_gyre_windstress(cfg: ModelConfig, grids: Grids,
                           tau0: float = 2.0e-5):
    """Classic double-gyre dynamic windstress for forced box-ocean
    runs: tau_x = -tau0 * cos(2 pi y / ylo), tau_y = 0.
    tau0 is a KINEMATIC (dynamic) stress in m^2 s^-2; the default
    2e-5 m^2 s^-2 corresponds to ~0.02 N m^-2 over 1000 kg m^-3 water,
    a gentle forcing comparable to the coupled model's own stress."""
    yrel = (grids.ypo - grids.ypo[0]) / grids.ylo
    taux = -tau0 * np.cos(2.0 * np.pi * yrel)
    tauxo = np.broadcast_to(taux[:, None], (cfg.nypo, cfg.nxpo)).copy()
    tauyo = np.zeros((cfg.nypo, cfg.nxpo))
    fnetoc = np.zeros((cfg.nyto, cfg.nxto))
    return tauxo, tauyo, fnetoc


def channel_windstress(cfg: ModelConfig, grids: Grids,
                       tau0: float = 2.0e-5,
                       wall_frac: float = 0.25, asym: float = 0.5):
    """Zonal westerly jet for forced CYCLIC-channel runs (Southern
    Ocean style): tau_x(y) = tau0*(w(y) + (1-wall_frac) *
    sin^2(pi*y/L)), tau_y = 0 -- an ACC-like stress maximum at
    mid-channel.  The stress is deliberately NONZERO at the channel
    walls (w = wall_frac*(1 +- asym/2), linearly blended) AND
    DIFFERENT at the two walls, so the boundary stress integrals
    txis/txin (reference src/xfosubs.F:568-707) independently force
    the southern and northern leapfrogged momentum constraints
    (src/ocisubs.F:169-327) -- the machinery a forced-channel
    production run exists to validate.  x-uniform, hence exactly
    cyclic.  tau0 is kinematic stress in m^2 s^-2 (2e-5 ~ 0.02 N m^-2
    over seawater)."""
    yrel = (grids.ypo - grids.ypo[0]) / grids.ylo
    wall = wall_frac * (1.0 + asym * (0.5 - yrel))
    taux = tau0 * (wall
                   + (1.0 - wall_frac) * np.sin(np.pi * yrel) ** 2)
    tauxo = np.broadcast_to(taux[:, None], (cfg.nypo, cfg.nxpo)).copy()
    tauyo = np.zeros((cfg.nypo, cfg.nxpo))
    fnetoc = np.zeros((cfg.nyto, cfg.nxto))
    return tauxo, tauyo, fnetoc


def modon_pressure(cfg: ModelConfig, rdef: float,
                   a: float = 4.0, q: float = 10.0, k: float = 4.6985):
    """Larichev-Reznik modon (dipole) initial pressure for layer 1
    (k247_make_restart_q-gcm.F90:123-219, use_modon branch; parameters
    from Flierl et al. 1980 Table III: the pair (a, q) fixes c and the
    matching wavenumber k).

    Interior (r < a):  p ~ b1 J1(k r / a) - r1 r, times sin(theta);
    exterior: p ~ d1 K1(sqrt(1 + 1/c) r); all scaled by
    beta Rdef^3 f0. `rdef` is the deformation radius (m); the model's
    computed modes_oc.rdef[1] is the natural choice (the reference
    hard-wires the equivalent value).
    """
    from scipy.special import j1, k1
    if not np.isfinite(q):
        # stationary modon (q -> infinity): c = 0, matching
        # wavenumber k = 5.1356 (k247_make_restart_q-gcm.F90:138)
        c = 0.0
    elif q <= a:
        raise ValueError(
            f"modon requires q > a (got a={a}, q={q}); c = "
            "1/((q/a)^2 - 1) is singular or negative otherwise")
    else:
        c = 1.0 / ((q / a) ** 2 - 1.0)
    b1 = (1.0 + c) * a**3 / (k**2 * j1(k))
    r1 = (1.0 + c * ((k / a) ** 2 + 1.0)) / (k / a) ** 2
    d1 = (-c * a / k1(a * np.sqrt(1.0 + 1.0 / c))) if c != 0 else 0.0

    dxo = cfg.ocean.dxo
    nxpo, nypo, nlo = cfg.nxpo, cfg.nypo, cfg.nlo
    i_e, j_e = cfg.nxto // 2, cfg.nyto // 2
    ii = (np.arange(nxpo) + 1 - i_e) * dxo
    jj = (np.arange(nypo) + 1 - j_e) * dxo
    x, y = ii[None, :], jj[:, None]
    r = np.sqrt(x**2 + y**2) / rdef
    sinth = np.sin(np.arctan2(y, x))
    amp = cfg.beta * rdef**3 * cfg.fnot
    interior = amp * (b1 * j1((k / a) * np.clip(r, 0, a)) - r1 * r) \
        * sinth
    if c != 0:
        exterior = amp * d1 * k1(np.sqrt(1.0 + 1.0 / c)
                                 * np.maximum(r, a)) * sinth
    else:
        exterior = np.zeros_like(r)
    po1 = np.where(r < a, interior, exterior)
    po = np.zeros((nlo, nypo, nxpo))
    po[0] = po1
    return po
