"""Model state and forcing of both fluids (port of qgcm_tpu/state.py).

NamedTuples of tensors threaded through the functional step; leapfrog
keeps two time levels of each prognostic field (x and xm). Fields are
[layer, y, x] / [y, x].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Fields with the rows of the ocean's T-grid (nyto rows), and those with
# its columns (nxto): a decomposed run gives them the p-grid's blocks
# (parallel/mesh.py), and these sets say how far each is true when the
# blocks are put back together. They are the T-grid fields and, of the
# running means (diags/timavge.py), the fields on the T cells' W/E faces
# (T rows, p columns) and S/N faces (p rows, T columns). Every other field
# of two or more dimensions is on the p-grid; scalars and mode vectors
# are replicated, as on the TPU.
T_GRID_FIELDS = frozenset({"sst", "sstm", "fnetoc", "wekto", "uufo",
                           "tufo", "utufo"})
T_COL_FIELDS = frozenset({"sst", "sstm", "fnetoc", "wekto", "vvfo",
                          "tvfo", "vtvfo"})


class OceanState(NamedTuple):
    po: torch.Tensor      # (nlo, nypo, nxpo) dynamic pressure
    pom: torch.Tensor     # lagged pressure
    qo: torch.Tensor      # (nlo, nypo, nxpo) potential vorticity
    qom: torch.Tensor
    sst: torch.Tensor     # (nyto, nxto) mixed layer temperature anomaly
    sstm: torch.Tensor
    # mass constraint: area integrals of interface displacement
    # (src/ochomog_data.F dpioc/dpiocp)
    dpioc: torch.Tensor   # (nlo-1,)
    dpiocp: torch.Tensor
    # momentum constraints, cyclic ocean only (zeros otherwise)
    ocncs: torch.Tensor   # (nlo,)
    ocncn: torch.Tensor
    ocncsp: torch.Tensor
    ocncnp: torch.Tensor


class AtmosState(NamedTuple):
    pa: torch.Tensor      # (nla, nypa, nxpa)
    pam: torch.Tensor
    qa: torch.Tensor
    qam: torch.Tensor
    ast: torch.Tensor     # (nyta, nxta)
    astm: torch.Tensor
    hmixa: torch.Tensor   # (nyta, nxta) mixed layer thickness
    hmixam: torch.Tensor
    dpiat: torch.Tensor   # (nla-1,)
    dpiatp: torch.Tensor
    atmcs: torch.Tensor   # (nla,)
    atmcn: torch.Tensor
    atmcsp: torch.Tensor
    atmcnp: torch.Tensor


class OceanForcing(NamedTuple):
    """Surface forcing of the ocean; static in ocean_only runs,
    recomputed by xforc when coupled."""
    tauxo: torch.Tensor   # (nypo, nxpo) dynamic stress (m^2 s^-2)
    tauyo: torch.Tensor
    fnetoc: torch.Tensor  # (nyto, nxto) net diabatic forcing (W m^-2)
    wekto: torch.Tensor   # (nyto, nxto) Ekman velocity at T points
    wekpo: torch.Tensor   # (nypo, nxpo) Ekman velocity at p points
    txisoc: torch.Tensor  # scalar: S-boundary taux line integral (cyclic)
    txinoc: torch.Tensor  # scalar: N-boundary taux line integral (cyclic)


class AtmosForcing(NamedTuple):
    """Surface and diabatic forcing of the atmosphere (from xforc)."""
    tauxa: torch.Tensor   # (nypa, nxpa)
    tauya: torch.Tensor
    fnetat: torch.Tensor  # (nyta, nxta)
    wekta: torch.Tensor   # (nyta, nxta)
    wekpa: torch.Tensor   # (nypa, nxpa)
    uekat: torch.Tensor   # (nyta, nxpa) Ekman u at T-cell W/E faces
    vekat: torch.Tensor   # (nypa, nxta) Ekman v at T-cell S/N faces
    txisat: torch.Tensor  # scalar: S-boundary taux line integral
    txinat: torch.Tensor  # scalar
