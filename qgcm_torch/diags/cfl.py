"""Courant number / velocity extrema diagnostics (port of
qgcm_tpu/diags/cfl.py).

Reference: `cfltry` (src/q-gcm.F:2121-2440) and `couroc`/`courat`
(src/monitor_diag.F:1215-1555). Geostrophic velocities are face values
u = -p_y/(f0 dx), v = p_x/(f0 dx); the mixed layer adds the Ekman
velocity tau/(f0 h_m). The Courant number is |u|max * dt / dx summed
over components. Everything stays on the model's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.stencils import _col_mask, _row_mask


class CflReport(NamedTuple):
    cnqgoc: torch.Tensor   # max QG-layer Courant number, ocean
    cnmloc: torch.Tensor   # max mixed-layer Courant number, ocean
    cnqgat: torch.Tensor
    cnmlat: torch.Tensor
    ugmaxoc: torch.Tensor  # (nlo,) max |u_g| per ocean layer
    vgmaxoc: torch.Tensor
    ugmaxat: torch.Tensor  # (nla,)
    vgmaxat: torch.Tensor
    # signed component extrema (monitor_data.F ummin/ummax/ugmin/ugmax)
    ugminoc_s: torch.Tensor   # (nlo,)
    ugmaxoc_s: torch.Tensor
    vgminoc_s: torch.Tensor
    vgmaxoc_s: torch.Tensor
    ugminat_s: torch.Tensor   # (nla,)
    ugmaxat_s: torch.Tensor
    vgminat_s: torch.Tensor
    vgmaxat_s: torch.Tensor
    umminoc: torch.Tensor     # mixed-layer velocity extrema (scalars)
    ummaxoc: torch.Tensor
    vmminoc: torch.Tensor
    vmmaxoc: torch.Tensor
    umminat: torch.Tensor
    ummaxat: torch.Tensor
    vmminat: torch.Tensor
    vmmaxat: torch.Tensor


def _uv_faces(p, rdxf0):
    u = -rdxf0 * (p[:, 1:, :] - p[:, :-1, :])
    v = rdxf0 * (p[:, :, 1:] - p[:, :, :-1])
    return u, v


def _minmax(f):
    """Per-layer minimum and maximum of an (nl, ny, nx) field."""
    f = f.flatten(1)
    return f.min(dim=1).values, f.max(dim=1).values


def cfl_numbers(model, ocean=None, atmos=None, oc_forcing=None,
                at_forcing=None) -> CflReport:
    cfg = model.cfg
    g = model.grids
    z = torch.zeros((), device=model.device, dtype=model.dtype)
    zv = torch.zeros((1,), device=model.device, dtype=model.dtype)
    cnqgoc = cnmloc = cnqgat = cnmlat = z
    ugoc = vgoc = ugat = vgat = zv
    ugminoc = ugmaxoc = vgminoc = vgmaxoc = zv
    ugminat = ugmaxat = vgminat = vgmaxat = zv
    umminoc = ummaxoc = vmminoc = vmmaxoc = z
    umminat = ummaxat = vmminat = vmmaxat = z

    if ocean is not None:
        rdxof0 = 1.0 / (g.dxo * cfg.fnot)
        uo, vo = _uv_faces(ocean.po, rdxof0)
        ugminoc, ugmaxoc = _minmax(uo)
        vgminoc, vgmaxoc = _minmax(vo)
        ugoc = torch.maximum(ugmaxoc, -ugminoc)
        vgoc = torch.maximum(vgmaxoc, -vgminoc)
        cnqgoc = (ugoc.max() + vgoc.max()) * cfg.dto / g.dxo
        if oc_forcing is not None:
            rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
            ue = (uo[0] + rhf0hm * (oc_forcing.tauyo[1:, :]
                                    + oc_forcing.tauyo[:-1, :]))
            ve = (vo[0] - rhf0hm * (oc_forcing.tauxo[:, 1:]
                                    + oc_forcing.tauxo[:, :-1]))
            # no normal flow through solid walls: the Ekman component
            # is zeroed on wall faces (couroc, monitor_diag.F:1718-1731)
            if not cfg.cyclic_ocean:
                ue = torch.where(_col_mask(ue, 0) | _col_mask(ue, -1),
                                 0.0, ue)
            ve = torch.where(_row_mask(ve, 0) | _row_mask(ve, -1), 0.0, ve)
            cnmloc = (ue.abs().max() + ve.abs().max()) * cfg.dto / g.dxo
            umminoc, ummaxoc = ue.min(), ue.max()
            vmminoc, vmmaxoc = ve.min(), ve.max()

    if atmos is not None:
        rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
        ua, va = _uv_faces(atmos.pa, rdxaf0)
        ugminat, ugmaxat = _minmax(ua)
        vgminat, vgmaxat = _minmax(va)
        ugat = torch.maximum(ugmaxat, -ugminat)
        vgat = torch.maximum(vgmaxat, -vgminat)
        cnqgat = (ugat.max() + vgat.max()) * cfg.dta / g.dxa
        if at_forcing is not None:
            ue = ua[0] + at_forcing.uekat
            ve = va[0] + at_forcing.vekat
            ve = torch.where(_row_mask(ve, 0) | _row_mask(ve, -1), 0.0, ve)
            cnmlat = (ue.abs().max() + ve.abs().max()) * cfg.dta / g.dxa
            umminat, ummaxat = ue.min(), ue.max()
            vmminat, vmmaxat = ve.min(), ve.max()

    return CflReport(cnqgoc=cnqgoc, cnmloc=cnmloc, cnqgat=cnqgat,
                     cnmlat=cnmlat, ugmaxoc=ugoc, vgmaxoc=vgoc,
                     ugmaxat=ugat, vgmaxat=vgat,
                     ugminoc_s=ugminoc, ugmaxoc_s=ugmaxoc,
                     vgminoc_s=vgminoc, vgmaxoc_s=vgmaxoc,
                     ugminat_s=ugminat, ugmaxat_s=ugmaxat,
                     vgminat_s=vgminat, vgmaxat_s=vgmaxat,
                     umminoc=umminoc, ummaxoc=ummaxoc,
                     vmminoc=vmminoc, vmmaxoc=vmmaxoc,
                     umminat=umminat, ummaxat=ummaxat,
                     vmminat=vmminat, vmmaxat=vmmaxat)
