"""Solution validity scan (reference src/valsubs.F valids; port of
qgcm_tpu/diags/valids.py).

Range-checks the prognostic and forcing fields against the reference's
hard limits (valsubs.F:77-81) and checks full perturbed layer
thicknesses against thkmin with a bad-point-percentage criterion
(valsubs.F:93-98). Runs on the model's device and returns one 0-d bool
tensor plus the extrema; the host decides whether to dump and abort
(fail-fast with post-mortem artifacts, q-gcm.F:1278-1322), so the only
host sync is the caller's bool(report.ok).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..io.ncdf import host

# Hard limits (valsubs.F:77-81)
TAUEXT = 10.0     # |tau| (m^2 s^-2)
WTAEXT = 1.0      # |wekta| (m/s)
WTOEXT = 1.0e-3   # |wekto| (m/s)
ASTEXT = 90.0     # |ast| (K)
PATEXT = 1.0e7    # |pa| (m^2 s^-2)
QATEXT = 0.05     # |qa| (s^-1)
SSTEXT = 75.0     # |sst| (K)
POCEXT = 1.0e4    # |po| (m^2 s^-2)
QOCEXT = 0.05     # |qo| (s^-1)
THKMIN = 100.0    # min acceptable ocean layer thickness (m)
CRITPC = 20.0     # max acceptable % of too-thin points


class ValidityReport(NamedTuple):
    ok: torch.Tensor          # 0-d bool
    pomax: torch.Tensor
    qomax: torch.Tensor
    sstmax: torch.Tensor
    wektomax: torch.Tensor
    pamax: torch.Tensor
    qamax: torch.Tensor
    astmax: torch.Tensor
    wektamax: torch.Tensor
    taumax: torch.Tensor
    thinpc: torch.Tensor      # % of thin ocean points (worst interface)


def _absmax(x) -> torch.Tensor:
    return x.abs().max()


def valids(model, ocean=None, atmos=None, oc_forcing=None,
           at_forcing=None) -> ValidityReport:
    dev = model.device
    z = torch.zeros((), device=dev, dtype=model.dtype)
    ok = torch.ones((), device=dev, dtype=torch.bool)

    pomax = qomax = sstmax = wektomax = thinpc = z
    pamax = qamax = astmax = wektamax = taumax = z

    def finite_and(ok, x, lim):
        m = _absmax(x)
        return ok & torch.isfinite(m) & (m < lim), m

    if ocean is not None:
        ok, pomax = finite_and(ok, ocean.po, POCEXT)
        ok, qomax = finite_and(ok, ocean.qo, QOCEXT)
        ok, sstmax = finite_and(ok, ocean.sst, SSTEXT)
        if oc_forcing is not None:
            ok, wektomax = finite_and(ok, oc_forcing.wekto, WTOEXT)
        # full layer thickness check (valsubs.F:93-98):
        # h_k = hoc(k) + eta(k-1) - eta(k), eta = (p(k+1)-p(k))/gp(k),
        # bottom layer also loses the topography height.
        thick = _ocean_thickness(model, ocean.po)
        frac_thin = 100.0 * (thick < THKMIN).to(model.dtype).mean(
            dim=(1, 2))
        thinpc = frac_thin.max()
        ok = ok & (thinpc <= CRITPC)

    if atmos is not None:
        ok, pamax = finite_and(ok, atmos.pa, PATEXT)
        ok, qamax = finite_and(ok, atmos.qa, QATEXT)
        ok, astmax = finite_and(ok, atmos.ast, ASTEXT)
        if at_forcing is not None:
            ok, wektamax = finite_and(ok, at_forcing.wekta, WTAEXT)
            ok, taumax = finite_and(
                ok, torch.maximum(_absmax(at_forcing.tauxa),
                                  _absmax(at_forcing.tauya)), TAUEXT)

    return ValidityReport(ok=ok, pomax=pomax, qomax=qomax, sstmax=sstmax,
                          wektomax=wektomax, pamax=pamax, qamax=qamax,
                          astmax=astmax, wektamax=wektamax,
                          taumax=taumax, thinpc=thinpc)


# ----------------------------------------------------------------------
# Post-mortem neighbourhood dumps (scan2D/scan3D, valsubs.F:631-744)
# ----------------------------------------------------------------------

_JWID, _IWID = 4, 3     # rows j+-4, cols i+-3 around the extremum


def _locate(x, take_min=False):
    """(value, layer, j, i, j0, i0, patch) of the extremum of x: |max|
    by default, plain minimum for the thickness scan; a NaN counts as
    the largest value, as in qgcm_tpu. The patch window is shifted (not
    shrunk) at domain edges. Returns host values."""
    field = x if x.dim() == 3 else x[None]
    score = -field if take_min else field.abs()
    flat = int(torch.argmax(score))      # argmax takes NaN as the largest
    nl, ny, nx = field.shape
    k, rem = divmod(flat, ny * nx)
    j, i = divmod(rem, nx)
    pj = 2 * _JWID + 1 if ny >= 2 * _JWID + 1 else ny
    pi = 2 * _IWID + 1 if nx >= 2 * _IWID + 1 else nx
    j0 = min(max(j - _JWID, 0), ny - pj)
    i0 = min(max(i - _IWID, 0), nx - pi)
    patch = host(field[k, j0:j0 + pj, i0:i0 + pi])
    return float(field[k, j, i]), k, j, i, j0, i0, patch


def _ocean_thickness(model, po):
    """Full perturbed layer thicknesses (valsubs.F:93-98 logic)."""
    eta = (po[1:] - po[:-1]) / model.gpoc[:, None, None]
    zero = torch.zeros_like(eta[:1])
    etup = torch.cat([zero, eta], dim=0)
    etdn = torch.cat([eta, zero], dim=0)
    thick = model.hoc[:, None, None] + etup - etdn
    return torch.cat([thick[:-1], thick[-1:] - model.dtopoc], dim=0)


def _format_dump(name: str, loc) -> str:
    """Format one extremum like scan2D/3D: location line, column-index
    header, then patch rows printed north-to-south."""
    val, k, j, i, j0, i0, patch = loc
    nl = [f"  {name} = {float(val):.6e} located at k, j, i = "
          f"{int(k)} {int(j)} {int(i)}"]
    cols = "".join(f"{int(i0) + c:13d}" for c in range(patch.shape[1]))
    nl.append("   " + cols)
    for r in range(patch.shape[0] - 1, -1, -1):
        row = "".join(f"{patch[r, c]:13.5e}"
                      for c in range(patch.shape[1]))
        nl.append(f"{int(j0) + r:7d}" + row)
    return "\n".join(nl)


def post_mortem(model, ocean=None, atmos=None, oc_forcing=None,
                at_forcing=None) -> str:
    """Locate the extremum of every checked field and its 9x7
    neighbourhood (the reference's scan2D/scan3D dumps on a validity
    failure, valsubs.F:101-628) as one formatted report. Runs only on
    the failure path, so its host syncs cost nothing in a healthy run."""
    locs = {}
    if ocean is not None:
        locs["po"] = _locate(ocean.po)
        locs["qo"] = _locate(ocean.qo)
        locs["sst"] = _locate(ocean.sst)
        locs["h_min"] = _locate(_ocean_thickness(model, ocean.po),
                                take_min=True)
        if oc_forcing is not None:
            locs["wekto"] = _locate(oc_forcing.wekto)
    if atmos is not None:
        locs["pa"] = _locate(atmos.pa)
        locs["qa"] = _locate(atmos.qa)
        locs["ast"] = _locate(atmos.ast)
        if at_forcing is not None:
            locs["wekta"] = _locate(at_forcing.wekta)
            locs["taux"] = _locate(at_forcing.tauxa)
            locs["tauy"] = _locate(at_forcing.tauya)
    # fields in name order, as qgcm_tpu's report lists them
    parts = ["validity post-mortem (field extrema and neighbourhoods):"]
    for name in sorted(locs):
        parts.append(_format_dump(name, locs[name]))
    return "\n".join(parts)
