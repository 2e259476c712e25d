"""Vertical eigenmode decomposition.

Replaces the reference's LAPACK-based eigensolver (src/eigmode.f:41-538)
with host-side NumPy. The A matrix links layer pressures to interface
displacements (eigmode.f:115-144); its eigendecomposition yields modal
phase speeds, deformation radii and the layer<->mode transform matrices.

Normalisation: right eigenvectors get the Flierl (1978) normalisation
sqrt(H_total / sum_k H_k R_m(k)^2) with a positive value in layer 1
(surface sign convention of Killworth & Blundell) -- the reference
applies this to the ocean only (eigmode.f:310-345) and leaves the
atmosphere with LAPACK's arbitrary scaling. Layer-space dynamics are
invariant under per-mode rescaling (cl2m picks up the inverse factor
through the biorthogonality normalisation), so we apply the Flierl
convention to BOTH fluids for determinism.

Copied from qgcm_tpu/modes.py, which is NumPy-only but cannot be
imported without JAX (the qgcm_tpu package __init__ imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class Modes:
    amat: np.ndarray    # (nl, nl)  A matrix: q contribution is -f0 * A @ p
    cphs: np.ndarray    # (nl,)  modal phase speeds, barotropic -> 0
    rdef: np.ndarray    # (nl,)  modal deformation radii, barotropic -> 0
    rdm2: np.ndarray    # (nl,)  1/Rd^2, barotropic -> 0
    cl2m: np.ndarray    # (nl, nl)  layer->mode:  p_m = sum_k cl2m[m,k] p_k
    cm2l: np.ndarray    # (nl, nl)  mode->layer:  p_k = sum_m cm2l[k,m] p_m


def amatrix(gpr: Tuple[float, ...], h: Tuple[float, ...]) -> np.ndarray:
    """Build the tridiagonal A matrix (reference src/eigmode.f:115-144)."""
    nl = len(h)
    a = np.zeros((nl, nl), dtype=np.float64)
    a[0, 1] = -1.0 / (gpr[0] * h[0])
    a[0, 0] = -a[0, 1]
    for k in range(1, nl - 1):
        a[k, k - 1] = -1.0 / (gpr[k - 1] * h[k])
        a[k, k + 1] = -1.0 / (gpr[k] * h[k])
        a[k, k] = -a[k, k - 1] - a[k, k + 1]
    a[nl - 1, nl - 2] = -1.0 / (gpr[nl - 2] * h[nl - 1])
    a[nl - 1, nl - 1] = -a[nl - 1, nl - 2]
    return a


def eigenmodes(gpr: Tuple[float, ...], h: Tuple[float, ...],
               fnot: float) -> Modes:
    """Eigen-decompose A; order modes by increasing |eigenvalue|
    (barotropic first), Flierl-normalise, and form transform matrices.

    Mirrors src/eigmode.f:382-438.
    """
    nl = len(h)
    a = amatrix(gpr, h)

    evals, evecr = np.linalg.eig(a)
    if np.iscomplexobj(evals) and np.abs(evals.imag).max() > 0:
        if np.abs(evals.imag).max() > 1e-12 * np.abs(evals.real).max():
            raise ValueError("complex eigenvalues in vertical mode problem")
    evals = evals.real
    evecr = evecr.real

    order = np.argsort(np.abs(evals))
    evals = np.abs(evals[order])
    evecr = evecr[:, order]

    # Flierl normalisation + surface-positive sign convention
    hvec = np.asarray(h, dtype=np.float64)
    htotal = hvec.sum()
    for m in range(nl):
        dotp = np.sum(hvec * evecr[:, m] ** 2)
        flfac = np.sqrt(htotal / dotp) * np.sign(evecr[0, m])
        evecr[:, m] = flfac * evecr[:, m]

    # Left eigenvectors: rows of inv(evecr) are the biorthogonal duals,
    # which equals the reference's evecl[:, m] / <evecl_m, evecr_m>.
    cl2m = np.linalg.inv(evecr)      # (m, k)
    cm2l = evecr                     # (k, m)

    eigval = evals.copy()
    eigval[0] = 0.0                  # barotropic eigenvalue is exactly 0
    cphs = np.zeros(nl)
    rdef = np.zeros(nl)
    rdm2 = np.zeros(nl)
    cphs[1:] = 1.0 / np.sqrt(eigval[1:])
    rdef[1:] = 1.0 / np.sqrt(eigval[1:]) / abs(fnot)
    rdm2[1:] = fnot * fnot * eigval[1:]

    return Modes(amat=a, cphs=cphs, rdef=rdef, rdm2=rdm2,
                 cl2m=cl2m, cm2l=cm2l)
