"""Startup derived-parameter report.

Replaces the reference main program's stdout report (q-gcm.F:454-570
with `diffts` q-gcm.F:2938-3050): deformation radii and modal phase
speeds, gravity-wave Courant numbers, Munk boundary-layer widths,
diffusive decay timescales on the gridscale and deformation radii, and
the run/grid summary. Useful both as a human sanity check and as the
machine-readable `derived` block consumed by analysis.

Copied from qgcm_tpu/report.py (host code); `sample_report` copies
its nine sample points per field to the host in one transfer."""

from __future__ import annotations

import numpy as np

from .io.ncdf import host
from .params import SECDAY


def _diffts(order: int, coeff: float, scales, dx: float):
    """Decay timescale (days) of diffusion of given order on a length
    scale: t = L^order / coeff with L = 2dx sin(pi dx/L')... the
    reference's diffts uses the wavenumber of wavelength 2*scale:
    t = 1 / (coeff * k^order), k = pi / scale."""
    out = []
    for L in scales:
        if coeff <= 0 or L <= 0:
            out.append(np.inf)
            continue
        k = np.pi / L
        out.append(1.0 / (coeff * k**order) / SECDAY)
    return out


def derived_parameters(model) -> dict:
    cfg = model.cfg
    g = model.grids
    d = {}
    if not cfg.atmos_only:
        rd = model.modes_oc.rdef
        d["rdefoc_km"] = (rd[1:] * 1e-3).tolist()
        d["cphsoc"] = model.modes_oc.cphs[1:].tolist()
        # gravity-wave Courant number (fastest baroclinic mode)
        d["cfl_gw_oc"] = float(max(model.modes_oc.cphs[1:])
                               * cfg.dto / g.dxo)
        # Munk width (m): (Ah4 / beta)^(1/5)
        ah4 = max(cfg.ocean.ah4oc)
        d["munk_width_oc_km"] = float((ah4 / cfg.beta) ** 0.2 * 1e-3) \
            if ah4 > 0 else 0.0
        d["spindown_del4_gridscale_days"] = _diffts(
            4, max(cfg.ocean.ah4oc), [2 * g.dxo], g.dxo)[0]
        d["spindown_del4_rdef_days"] = _diffts(
            4, max(cfg.ocean.ah4oc), [2 * r for r in rd[1:]], g.dxo)
        if max(cfg.ocean.ah2oc) > 0:
            d["spindown_del2_gridscale_days"] = _diffts(
                2, max(cfg.ocean.ah2oc), [2 * g.dxo], g.dxo)[0]
        # leapfrog diffusive stability factor (diffts, q-gcm.F:3029-
        # 3049): nord * dt / t_grid with t_grid = (dx/2)^nord / coeff;
        # must be < 1 for stable timestepping.
        if ah4 > 0:
            d["del4_stability_factor"] = float(
                4.0 * cfg.dto * ah4 / (0.5 * g.dxo) ** 4)
        if max(cfg.ocean.ah2oc) > 0:
            d["del2_stability_factor"] = float(
                2.0 * cfg.dto * max(cfg.ocean.ah2oc)
                / (0.5 * g.dxo) ** 2)
        if cfg.ocean.delek > 0:
            # bottom Ekman spindown: 2H / (delek |f0|)
            d["ekman_spindown_days"] = float(
                2 * cfg.ocean.hoc[-1]
                / (cfg.ocean.delek * abs(cfg.fnot)) / SECDAY)
    if not cfg.ocean_only:
        rd = model.modes_at.rdef
        d["rdefat_km"] = (rd[1:] * 1e-3).tolist()
        d["cphsat"] = model.modes_at.cphs[1:].tolist()
        d["cfl_gw_at"] = float(max(model.modes_at.cphs[1:])
                               * cfg.dta / g.dxa)
    d["tmbara_K"] = float(model.rad.tmbara)
    d["tmbaro_K"] = float(model.rad.tmbaro)
    return d


def startup_report(model) -> str:
    cfg = model.cfg
    g = model.grids
    d = derived_parameters(model)
    L = []
    mode = ("atmos_only" if cfg.atmos_only else
            "ocean_only" if cfg.ocean_only else "coupled")
    geom = "cyclic" if cfg.cyclic_ocean else "box"
    L.append("qgcm_torch derived parameters")
    L.append("---------------------------")
    L.append(f"mode: {mode}; ocean geometry: {geom}; dtype: {cfg.dtype}")
    L.append(f"atmos grid: {cfg.nxta} x {cfg.nyta} x {cfg.nla} "
             f"@ {g.dxa / 1e3:.1f} km, dta = {cfg.dta:.1f} s")
    L.append(f"ocean grid: {cfg.nxto} x {cfg.nyto} x {cfg.nlo} "
             f"@ {g.dxo / 1e3:.1f} km, dto = {cfg.dto:.1f} s "
             f"(nstr = {cfg.nstr})")
    L.append(f"f0 = {cfg.fnot:.6e} s^-1, beta = {cfg.beta:.5e}")
    if "rdefoc_km" in d:
        L.append("ocean deformation radii (km): "
                 + " ".join(f"{r:.2f}" for r in d["rdefoc_km"]))
        L.append("ocean modal phase speeds (m/s): "
                 + " ".join(f"{c:.3f}" for c in d["cphsoc"]))
        L.append(f"gravity-wave CFL (ocean) = {d['cfl_gw_oc']:.4f}")
        if d.get("munk_width_oc_km"):
            L.append(f"Munk width = {d['munk_width_oc_km']:.2f} km "
                     f"({d['munk_width_oc_km'] * 1e3 / g.dxo:.2f} dx)")
        L.append("del4 spindown on 2dx = "
                 f"{d['spindown_del4_gridscale_days']:.3f} days")
        if "del4_stability_factor" in d:
            L.append("del4 timestep stability factor = "
                     f"{d['del4_stability_factor']:.3g} (must be < 1)")
        if "del2_stability_factor" in d:
            L.append("del2 timestep stability factor = "
                     f"{d['del2_stability_factor']:.3g} (must be < 1)")
        if "ekman_spindown_days" in d:
            L.append(f"bottom Ekman spindown = "
                     f"{d['ekman_spindown_days']:.1f} days")
    if "rdefat_km" in d:
        L.append("atmos deformation radii (km): "
                 + " ".join(f"{r:.1f}" for r in d["rdefat_km"]))
        L.append(f"gravity-wave CFL (atmos) = {d['cfl_gw_at']:.4f}")
    L.append(f"mean mixed-layer temps: atmos {d['tmbara_K']:.3f} K, "
             f"ocean {d['tmbaro_K']:.3f} K")
    return "\n".join(L)


def memory_report(model) -> str:
    """Static memory estimate (memreq, q-gcm.F:143,2444-2934): bytes
    per stepped field and the total device-resident state/forcing
    footprint at the configured dtype."""
    cfg = model.cfg
    esz = 4 if cfg.dtype == "float32" else 8
    items = []
    tot = 0

    def add(name, n):
        nonlocal tot
        b = n * esz
        tot += b
        items.append((name, b))

    if not cfg.atmos_only:
        npo = cfg.nxpo * cfg.nypo
        nto = cfg.nxto * cfg.nyto
        add("po/pom/qo/qom", 4 * cfg.nlo * npo)
        add("sst/sstm", 2 * nto)
        add("ocean forcing", 3 * npo + 2 * nto)
        add("ocean averaging accumulators", 2 * cfg.nlo * npo
            + 3 * npo + 5 * nto)
    if not cfg.ocean_only:
        npa = cfg.nxpa * cfg.nypa
        nta = cfg.nxta * cfg.nyta
        add("pa/pam/qa/qam", 4 * cfg.nla * npa)
        add("ast/astm/hmixa/hmixam", 4 * nta)
        add("atmos forcing", 3 * npa + 4 * nta)
        add("atmos averaging accumulators", 2 * cfg.nla * npa
            + 3 * npa + 4 * nta)
        add("xforc fine grid (transient)", 5 * cfg.nxpaor * cfg.nypaor)
    L = [f"memory estimate ({cfg.dtype}):"]
    for name, b in items:
        L.append(f"  {name}: {b / 1e6:.1f} MB")
    L.append(f"  total (excl. PyTorch workspace): {tot / 1e6:.1f} MB")
    return "\n".join(L)


def sample_report(model, ocean=None, atmos=None) -> str:
    """prsamp (q-gcm.F:1933-2120): print a coarse sample of the state
    for eyeballing runaway values."""
    L = []

    def samp(name, f):
        ny, nx = f.shape[-2:]
        ii = [1, nx // 2, nx - 2]
        jj = [1, ny // 2, ny - 2]
        pts = f[..., jj, :][..., ii].reshape(-1, 9)[0]
        vals = " ".join(f"{v: .4e}" for v in host(pts))
        L.append(f"  {name}: {vals}")

    if ocean is not None:
        samp("po[0]", ocean.po[0])
        samp("qo[0]", ocean.qo[0])
        samp("sst", ocean.sst)
    if atmos is not None:
        samp("pa[0]", atmos.pa[0])
        samp("ast", atmos.ast)
        samp("hmixa", atmos.hmixa)
    return "\n".join(L)
