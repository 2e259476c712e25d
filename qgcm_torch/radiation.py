"""Radiation scheme: mean-state radiative balance and linearised
perturbation coefficients.

Replaces reference src/radsubs.f:44-592 with host-side NumPy. All outputs
are O(nla) scalars/vectors computed once at init; they parameterise the
diabatic forcing (xforc), mixed-layer entrainment, and the 'rbal'
initial state.

The scheme: each atmospheric layer is a grey absorber with optical depth
zopt(k); the mixed layer has optical depth zm. Mean-state up/down fluxes
are vertical integrals of sigma/2 * T(z)^4 * exp(-|z'-z|/zopt) evaluated
by trapezoidal quadrature with nz=10001 points (radsubs.f:71). Newton
iterations find the mixed-layer temperatures that close the balance.

Copied from qgcm_tpu/radiation.py, which is NumPy-only but cannot be
imported without JAX (the qgcm_tpu package __init__ imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import ModelConfig
from .grids import Grids

STEFAN = 5.67040e-8
SIGOV2 = 0.5 * STEFAN
NZ = 10001
NITMAX = 200
TMBTOL = 1.0e-13


@dataclass(frozen=True)
class Radiation:
    fspco: float                 # signed perturbation coefficient
    tmbara: float                # mean atmos mixed layer temperature (K)
    tmbaro: float                # mean ocean mixed layer temperature (K)
    toc: np.ndarray              # (nlo,) ocean layer temp anomalies (K)
    tat: np.ndarray              # (nla,) atmos layer temp anomalies (K)
    # linearised radiation coefficients
    Aup: np.ndarray              # (nla, nla-1)
    Adown: np.ndarray            # (nla, nla-1)
    Bup: np.ndarray              # (nla,)
    Cup: np.ndarray              # (nla,)
    Dup: np.ndarray              # (nla,)
    Bmup: float
    B1down: float
    Cmup: float
    C1down: float
    D0up: float
    Dmup: float
    Dmdown: float
    # radiative balance initialisation coefficients
    rbetat: np.ndarray           # (nla-1,)
    rbtmat: float
    rbtmoc: float
    astbar: np.ndarray           # (nyta,) equilibrium AST anomaly profile
    sstbar: np.ndarray           # (nyto,) equilibrium SST anomaly profile
    tsbdy: float                 # southern boundary SST (for sb_hflux)
    tnbdy: float                 # northern boundary SST (for nb_hflux)
    # entrainment factors (radsubs.f:551-560)
    aface: np.ndarray            # (nla-1,)
    bface: float
    cface: float
    dface: float


def _trapz(f: np.ndarray, delz: float) -> float:
    """Extended trapezoidal rule (reference trapin, radsubs.f:596-634).

    The reference uses Kahan summation; NumPy's pairwise float64 sum has
    comparable accuracy at these sizes.
    """
    return float(delz * (0.5 * f[0] + f[1:-1].sum() + 0.5 * f[-1]))


def fsprim(cfg: ModelConfig, fspco: float, yrel):
    """Perturbative radiation forcing profile (xfosubs.F:862-887):
    fspco * 0.5 * sin(pi * yrel / yla); zero mean over the atmosphere."""
    yla = cfg.nyta * cfg.dxa
    return fspco * 0.5 * np.sin(np.pi * yrel / yla)


def radiat(cfg: ModelConfig, grids: Grids) -> Radiation:
    nla = cfg.nla
    nlo = cfg.nlo
    hat = np.asarray(cfg.atmos.hat)
    tabsat = np.asarray(cfg.atmos.tabsat)
    tabsoc = np.asarray(cfg.ocean.tabsoc)
    zopt = np.asarray(cfg.radiation.zopt)
    zm = cfg.radiation.zm
    gamma = cfg.radiation.gamma
    fsbar = cfg.radiation.fsbar
    fspamp = cfg.radiation.fspamp
    hmat = cfg.mixed.hmat
    xlamda = cfg.mixed.xlamda
    hta = hat.sum()

    # Layer transmissivities (radsubs.f:91-97)
    taum = np.exp(-hmat / zm)
    tauk = np.empty(nla)
    tauk[0] = np.exp(-(hat[0] - hmat) / zopt[0])
    tauk[1:] = np.exp(-hat[1:] / zopt[1:])
    tupmul = tauk.prod()

    # Mean up/down-going radiation integrals per layer (radsubs.f:99-147)
    uprad = np.empty(nla)
    dnrad = np.empty(nla)
    hbot, htop = hmat, hat[0]
    rhstat = 0.0
    for k in range(nla):
        if k > 0:
            hbot, htop = htop, htop + hat[k]
        delz = (htop - hbot) / (NZ - 1)
        zz = hbot + delz * np.arange(NZ)
        t4 = (tabsat[k] - gamma * zz) ** 4
        fup = t4 * np.exp(-(htop - zz) / zopt[k])
        fdn = t4 * np.exp((hbot - zz) / zopt[k])
        uprad[k] = SIGOV2 * _trapz(fup, delz) / zopt[k]
        dnrad[k] = SIGOV2 * _trapz(fdn, delz) / zopt[k]
        rhstat = (rhstat * tauk[k] + uprad[k]) if k > 0 else uprad[0]

    # Atmos mixed layer mean temperature (radsubs.f:149-184)
    rhstat = (-rhstat - fsbar) / tupmul
    rhstat = 2.0 * zm * rhstat / STEFAN
    tmbara = 300.0
    delz = hmat / (NZ - 1)
    zz = delz * np.arange(NZ)
    emz = np.exp(-(hmat - zz) / zm)
    for it in range(NITMAX + 1):
        upint = _trapz((tmbara - gamma * zz) ** 4 * emz, delz)
        deltm = 0.25 * (rhstat - upint) * tmbara / upint
        tmbara = tmbara + 0.75 * deltm
        if abs(deltm) <= TMBTOL:
            break
    else:
        raise RuntimeError("tmbara iteration did not converge")
    # recompute upint at converged tmbara for Fmupbar below
    upint = _trapz((tmbara - gamma * zz) ** 4 * emz, delz)

    # Ocean mixed layer mean temperature (radsubs.f:186-204)
    rhstoc = xlamda * tmbara + SIGOV2 * tmbara**4 - fsbar
    tmbaro = tmbara
    for it in range(NITMAX + 1):
        tocold = tmbaro
        tmbaro = rhstoc / (xlamda + STEFAN * tocold**3)
        if abs(tmbaro - tocold) <= TMBTOL:
            break
    else:
        raise RuntimeError("tmbaro iteration did not converge")

    toc = tabsoc - tmbaro
    tat = tabsat - tmbara

    # Mean state fluxes (radsubs.f:214-236)
    Fmupbar = SIGOV2 * upint / zm
    Fupbar = np.empty(nla)
    Fupbar[0] = Fmupbar * tauk[0] + uprad[0]
    for k in range(1, nla):
        Fupbar[k] = Fupbar[k - 1] * tauk[k] + uprad[k]
    Fdnbar = np.empty(nla)
    Fdnbar[nla - 1] = -dnrad[nla - 1]
    for k in range(nla - 2, -1, -1):
        Fdnbar[k] = Fdnbar[k + 1] * tauk[k] - dnrad[k]

    fspco = float(np.sign(cfg.fnot) * fspamp)

    # Perturbation (linearised) coefficients (radsubs.f:285-372)
    Aup = np.zeros((nla, nla - 1))
    Adown = np.zeros((nla, nla - 1))
    Bup = np.zeros(nla)
    Cup = np.zeros(nla)
    Dup = np.zeros(nla)

    D0up = 4.0 * STEFAN * tmbaro**3
    Bmup = (SIGOV2 * (tmbara - gamma * hmat) ** 4 - Fmupbar) / zm
    Cmup = Bmup
    Dmup = 2.0 * STEFAN * _trapz((tmbara - gamma * zz) ** 3 * emz, delz) / zm

    # Layer 1 upgoing
    hbot, htop = hmat, hat[0]
    Aup[0, 0] = (-tauk[0] * Fmupbar - uprad[0]
                 + SIGOV2 * (tabsat[0] - gamma * hat[0]) ** 4) / zopt[0]
    Bup[0] = tauk[0] * (Bmup + Fmupbar / zopt[0]
                        - SIGOV2 * (tabsat[0] - gamma * hmat) ** 4 / zopt[0])
    Cup[0] = tauk[0] * (Cmup + Fmupbar / zopt[0]
                        - SIGOV2 * (tabsat[0] - gamma * hmat) ** 4 / zopt[0])
    Dup[0] = Dmup * tauk[0]
    # Upper layers upgoing (radsubs.f:325-341); k, l are 0-based here
    for k in range(1, nla):
        hbot, htop = htop, htop + hat[k]
        Bup[k] = Bup[k - 1] * tauk[k]
        Cup[k] = Cup[k - 1] * tauk[k]
        Dup[k] = Dup[k - 1] * tauk[k]
        for l in range(0, k - 1):
            Aup[k, l] = Aup[k - 1, l] * tauk[k]
        Aup[k, k - 1] = tauk[k] * (
            Aup[k - 1, k - 1] + Fupbar[k - 1] / zopt[k]
            - SIGOV2 * (tabsat[k] - gamma * hbot) ** 4 / zopt[k])
        if k < nla - 1:
            Aup[k, k] = (-tauk[k] * Fupbar[k - 1] - uprad[k]
                         + SIGOV2 * (tabsat[k] - gamma * htop) ** 4) / zopt[k]

    # Downgoing (radsubs.f:343-372)
    htop = hta
    hbot = htop - hat[nla - 1]
    Adown[nla - 1, nla - 2] = (
        SIGOV2 * (tabsat[nla - 1] - gamma * hbot) ** 4
        - dnrad[nla - 1]) / zopt[nla - 1]
    for k in range(nla - 2, 0, -1):
        htop = hbot
        hbot = htop - hat[k]
        for l in range(k + 1, nla - 1):
            Adown[k, l] = Adown[k + 1, l] * tauk[k]
        Adown[k, k - 1] = (Fdnbar[k + 1] * tauk[k] - dnrad[k]
                           + SIGOV2 * (tabsat[k] - gamma * hbot) ** 4) / zopt[k]
        Adown[k, k] = tauk[k] * (
            Adown[k + 1, k] - Fdnbar[k + 1] / zopt[k]
            - SIGOV2 * (tabsat[k] - gamma * htop) ** 4 / zopt[k])
    for l in range(1, nla - 1):
        Adown[0, l] = Adown[1, l] * tauk[0]
    Adown[0, 0] = tauk[0] * (
        Adown[1, 0] - Fdnbar[1] / zopt[0]
        - SIGOV2 * (tabsat[0] - gamma * hat[0]) ** 4 / zopt[0])
    B1down = (Fdnbar[1] * tauk[0] - dnrad[0]
              + SIGOV2 * (tabsat[0] - gamma * hmat) ** 4) / zopt[0]
    C1down = B1down
    Dmdown = -2.0 * STEFAN * tmbara**3

    # Radiative balance initialisation coefficients (radsubs.f:406-492):
    # solve rbalar @ x = -1 for interface-displacement and Tm' coeffts.
    rbalar = np.zeros((nla, nla))
    rbalar[0, : nla - 1] = Adown[0, :]
    rbalar[0, nla - 1] = Dmup
    for k in range(1, nla - 1):
        rbalar[k, : nla - 1] = Adown[k + 1, :] + Aup[k, :]
        rbalar[k, nla - 1] = Dup[k]
    rbalar[nla - 1, : nla - 1] = Aup[nla - 1, :]
    rbalar[nla - 1, nla - 1] = Dup[nla - 1]
    rbafac = np.linalg.solve(rbalar, -np.ones(nla))
    rbetat = rbafac[: nla - 1].copy()
    rbtmat = float(rbafac[nla - 1])
    rbtmoc = float(((xlamda - Dmdown) * rbtmat - 1.0) / (xlamda + D0up))

    astbar = rbtmat * fsprim(cfg, fspco, grids.ytarel)
    sstbar = rbtmoc * fsprim(cfg, fspco, grids.ytorel)
    tnbdy = float(sstbar[-1])
    tsbdy = float(sstbar[0])

    # Entrainment factors (radsubs.f:551-560)
    rrcpat = 1.0 / (cfg.rhoat * cfg.cpat)
    rrcpdt = rrcpat / (tat[1] - tat[0])
    aface = rrcpdt * (Adown[0, :] - Aup[nla - 1, :])
    bface = float(rrcpdt * (B1down + Bmup - Bup[nla - 1]))
    cface = float(rrcpdt * (C1down + Cmup - Cup[nla - 1]))
    dface = float(rrcpdt * (Dmup - Dup[nla - 1]))

    return Radiation(
        fspco=fspco, tmbara=float(tmbara), tmbaro=float(tmbaro),
        toc=toc, tat=tat,
        Aup=Aup, Adown=Adown, Bup=Bup, Cup=Cup, Dup=Dup,
        Bmup=float(Bmup), B1down=float(B1down), Cmup=float(Cmup),
        C1down=float(C1down), D0up=float(D0up), Dmup=float(Dmup),
        Dmdown=float(Dmdown),
        rbetat=rbetat, rbtmat=rbtmat, rbtmoc=rbtmoc,
        astbar=astbar, sstbar=sstbar, tsbdy=tsbdy, tnbdy=tnbdy,
        aface=aface, bface=bface, cface=cface, dface=dface,
    )
