"""Running time means -> avges.nc (reference src/timavge.F; port of
qgcm_tpu/diags/timavge.py).

The reference accumulates sums every step inside the main loop
(tavatm/tavocn, q-gcm.F:1477-1482) and writes means at interval end
(tavout -> avges.nc, variable list timavge.F:911-1256). Here the sums
are tensors on the model's device, updated after each (sub)step; the
count `n` is a Python float, so accumulating never waits for the
device, and the host divides and writes at interval boundaries.

Eddy heat fluxes follow the reference's C-grid face-point semantics
(tavocn timavge.F:486-556, tavatm :340-400): velocity u is accumulated
at T-cell W/E faces (p-grid columns x T rows) and v at S/N faces
(T columns x p rows), along with T interpolated to the same faces and
the product u*T; the output uptp = <uT> - <u><T> (tavout
timavge.F:780-796, 850-870) lives on those face grids, boundary
conditions (box no-normal-flux, cyclic wrap, sb/nb_hflux outflow)
matching omladf/amladf.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..io.ncdf import host


class OceanAverages(NamedTuple):
    n: float
    sst: torch.Tensor
    wekto: torch.Tensor
    fnetoc: torch.Tensor
    tauxo: torch.Tensor
    tauyo: torch.Tensor
    wekpo: torch.Tensor
    po: torch.Tensor
    qo: torch.Tensor
    uufo: torch.Tensor     # (nyto, nxpo) u at T-cell W/E faces
    tufo: torch.Tensor     # (nyto, nxpo) sst at W/E faces
    utufo: torch.Tensor    # (nyto, nxpo) u*T product
    vvfo: torch.Tensor     # (nypo, nxto) v at T-cell S/N faces
    tvfo: torch.Tensor     # (nypo, nxto) sst at S/N faces
    vtvfo: torch.Tensor    # (nypo, nxto) v*T product


class AtmosAverages(NamedTuple):
    n: float
    ast: torch.Tensor
    hmixa: torch.Tensor
    wekta: torch.Tensor
    fnetat: torch.Tensor
    tauxa: torch.Tensor
    tauya: torch.Tensor
    wekpa: torch.Tensor
    pa: torch.Tensor
    qa: torch.Tensor
    uufa: torch.Tensor     # (nyta, nxpa)
    tufa: torch.Tensor     # (nyta, nxpa)
    utufa: torch.Tensor    # (nyta, nxpa)
    vvfa: torch.Tensor     # (nypa, nxta)
    tvfa: torch.Tensor     # (nypa, nxta)
    vtvfa: torch.Tensor    # (nypa, nxta)


def _zeros(model, *shape):
    return torch.zeros(shape, device=model.device, dtype=model.dtype)


def zero_ocean_averages(model) -> OceanAverages:
    cfg = model.cfg
    zt = _zeros(model, cfg.nyto, cfg.nxto)
    zp = _zeros(model, cfg.nypo, cfg.nxpo)
    zl = _zeros(model, cfg.nlo, cfg.nypo, cfg.nxpo)
    zu = _zeros(model, cfg.nyto, cfg.nxpo)
    zv = _zeros(model, cfg.nypo, cfg.nxto)
    return OceanAverages(n=0.0, sst=zt, wekto=zt, fnetoc=zt, tauxo=zp,
                         tauyo=zp, wekpo=zp, po=zl, qo=zl, uufo=zu,
                         tufo=zu, utufo=zu, vvfo=zv, tvfo=zv, vtvfo=zv)


def zero_atmos_averages(model) -> AtmosAverages:
    cfg = model.cfg
    zt = _zeros(model, cfg.nyta, cfg.nxta)
    zp = _zeros(model, cfg.nypa, cfg.nxpa)
    zl = _zeros(model, cfg.nla, cfg.nypa, cfg.nxpa)
    zu = _zeros(model, cfg.nyta, cfg.nxpa)
    zv = _zeros(model, cfg.nypa, cfg.nxta)
    return AtmosAverages(n=0.0, ast=zt, hmixa=zt, wekta=zt, fnetat=zt,
                         tauxa=zp, tauya=zp, wekpa=zp, pa=zl, qa=zl,
                         uufa=zu, tufa=zu, utufa=zu, vvfa=zv, tvfa=zv,
                         vtvfa=zv)


def _ocean_faces(model, sst, po1, tauxo, tauyo, tsbdy, tnbdy):
    """Face-point (u, T_u, v, T_v) exactly as tavocn builds them
    (timavge.F:486-556), [y, x] layout."""
    cfg = model.cfg
    g = model.grids
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)

    # u at W/E faces (T rows x p columns)
    uuf = (-uvgfac * (po1[1:, :] - po1[:-1, :])
           + rhf0hm * (tauyo[1:, :] + tauyo[:-1, :]))
    if cfg.cyclic_ocean:
        twrap = 0.5 * (sst[:, :1] + sst[:, -1:])
        tuf = torch.cat([twrap, 0.5 * (sst[:, :-1] + sst[:, 1:]), twrap],
                        dim=1)
    else:
        tuf = torch.cat([sst[:, :1], 0.5 * (sst[:, :-1] + sst[:, 1:]),
                         sst[:, -1:]], dim=1)
        uuf[:, 0] = 0.0
        uuf[:, -1] = 0.0

    # v at S/N faces (p rows x T columns)
    vvf = (uvgfac * (po1[:, 1:] - po1[:, :-1])
           - rhf0hm * (tauxo[:, 1:] + tauxo[:, :-1]))
    tvf = torch.cat([sst[:1, :], 0.5 * (sst[:-1, :] + sst[1:, :]),
                     sst[-1:, :]], dim=0)
    if cfg.sb_hflux:
        vvf[0] = -rhf0hm * (tauxo[0, 1:] + tauxo[0, :-1])
        tvf[0] = 0.5 * (sst[0, :] + tsbdy)
    else:
        vvf[0] = 0.0
    if cfg.nb_hflux:
        vvf[-1] = -rhf0hm * (tauxo[-1, 1:] + tauxo[-1, :-1])
        tvf[-1] = 0.5 * (sst[-1, :] + tnbdy)
    else:
        vvf[-1] = 0.0
    return uuf, tuf, vvf, tvf


def _atmos_faces(model, ast, pa1, tauxa, tauya):
    """Face-point (u, T_u, v, T_v) as tavatm builds them
    (timavge.F:340-400). x always periodic; Ekman signs are the
    atmospheric ones (u gets -tau_y/f0 h, v gets +tau_x/f0 h)."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmat)

    uuf = (-rdxaf0 * (pa1[1:, :] - pa1[:-1, :])
           - rhf0hm * (tauya[1:, :] + tauya[:-1, :]))
    twrap = 0.5 * (ast[:, :1] + ast[:, -1:])
    tuf = torch.cat([twrap, 0.5 * (ast[:, :-1] + ast[:, 1:]), twrap], dim=1)

    vvf = (rdxaf0 * (pa1[:, 1:] - pa1[:, :-1])
           + rhf0hm * (tauxa[:, 1:] + tauxa[:, :-1]))
    vvf[0] = 0.0
    vvf[-1] = 0.0
    tvf = torch.cat([ast[:1, :], 0.5 * (ast[:-1, :] + ast[1:, :]),
                     ast[-1:, :]], dim=0)
    return uuf, tuf, vvf, tvf


# the collective call sites of the face fields on blocks (Mesh.counts):
# the ocean's, and the atmosphere's
FACE_ROWS = "timavge.rows"
FACE_COLS = "timavge.cols"
ATM_FACE_ROWS = "timavge.atmos.rows"


def _ocean_faces_rows(model, rows, sst, po1, tauxo, tauyo):
    """_ocean_faces on this rank's blocks of a decomposed run (`rows`,
    models/ocean._Rows): the W/E faces of its T rows read the p row north
    of the block and the T column west of it, the S/N faces of its p rows
    the T row south of it and the p column east of it (one exchange of
    rows, and on a 2-D mesh one of columns); the walls and padding by
    global row and column."""
    cfg = model.cfg
    g = model.grids
    uvgfac = cfg.ycexp / (g.dxo * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmoc)
    tsbdy, tnbdy = model.rad.tsbdy, model.rad.tnbdy
    stack = torch.stack([po1, tauyo, tauxo, rows.t_wide(sst)])
    ext = rows.with_ghosts(stack, 1, FACE_ROWS, FACE_COLS)
    # W/E faces: T rows r0 .. r0+n-1, p columns c0 .. c0+m-1
    pn, tyn = (ext[k, 1:, 1:-1] for k in (0, 1))
    uuf = -uvgfac * (pn[1:] - pn[:-1]) + rhf0hm * (tyn[1:] + tyn[:-1])
    tw = rows.ghost_cols(ext[3, 1:-1, :-1], 1)     # T columns c0-1 ..
    tuf = 0.5 * (tw[:, :-1] + tw[:, 1:])
    if not cfg.cyclic_ocean:
        gx = rows.c0 + torch.arange(uuf.shape[-1], device=uuf.device)
        wall = (gx == 0) | (gx == rows.nxp - 1)
        uuf = torch.where(wall, 0.0, uuf)
        # the wall faces take the wall cells' T
        tuf = torch.where(gx == 0, tw[:, 1:], torch.where(
            gx == rows.nxp - 1, tw[:, :-1], tuf))

    # S/N faces: p rows r0 .. r0+n-1, T columns c0 .. c0+m-1
    pe, txe = (ext[k, 1:-1, 1:] for k in (0, 2))
    vvf = rows.t_narrow(uvgfac * (pe[:, 1:] - pe[:, :-1])
                        - rhf0hm * (txe[:, 1:] + txe[:, :-1]))
    vwall = rows.t_narrow(-rhf0hm * (txe[:, 1:] + txe[:, :-1]))
    # the T rows south and north of each p row
    ts = rows.t_narrow(ext[3, :-1, 1:-1])
    below, above = ts[:-1], ts[1:]
    tvf = 0.5 * (below + above)
    gp = rows.gy
    vvf = torch.where(gp == 0, vwall if cfg.sb_hflux else 0.0,
                      torch.where(gp == rows.nyp - 1,
                                  vwall if cfg.nb_hflux else 0.0, vvf))
    tvf = torch.where(gp == 0, 0.5 * (above + tsbdy) if cfg.sb_hflux
                      else above,
                      torch.where(gp == rows.nyp - 1,
                                  0.5 * (below + tnbdy) if cfg.nb_hflux
                                  else below, tvf))
    tp, pt = rows.tp_true, rows.pt_true
    return (torch.where(tp, uuf, 0.0), torch.where(tp, tuf, 0.0),
            torch.where(pt, vvf, 0.0), torch.where(pt, tvf, 0.0))


def accumulate_ocean(acc: OceanAverages, state, forcing, model,
                     rows=None) -> OceanAverages:
    """acc plus one (sub)step's state and forcing; with `rows` (a
    decomposed run's models/ocean._Rows) all of them are this rank's
    blocks (parallel/mesh.shard_tree's layout)."""
    if rows is None:
        uuf, tuf, vvf, tvf = _ocean_faces(
            model, state.sst, state.po[0], forcing.tauxo, forcing.tauyo,
            model.rad.tsbdy, model.rad.tnbdy)
    else:
        uuf, tuf, vvf, tvf = _ocean_faces_rows(
            model, rows, state.sst, state.po[0], forcing.tauxo,
            forcing.tauyo)
    return OceanAverages(
        n=acc.n + 1.0,
        sst=acc.sst + state.sst,
        wekto=acc.wekto + forcing.wekto,
        fnetoc=acc.fnetoc + forcing.fnetoc,
        tauxo=acc.tauxo + forcing.tauxo,
        tauyo=acc.tauyo + forcing.tauyo,
        wekpo=acc.wekpo + forcing.wekpo,
        po=acc.po + state.po,
        qo=acc.qo + state.qo,
        uufo=acc.uufo + uuf, tufo=acc.tufo + tuf,
        utufo=acc.utufo + uuf * tuf,
        vvfo=acc.vvfo + vvf, tvfo=acc.tvfo + tvf,
        vtvfo=acc.vtvfo + vvf * tvf)


def _atmos_faces_rows(model, rows, ast, pa1, tauxa, tauya):
    """_atmos_faces on this rank's row blocks of the atmosphere (`rows`,
    a models/ocean._Rows of its grid): the W/E faces of its T rows read
    the p row north of the block, the S/N faces of its p rows the T row
    south of it (one exchange of a ghost row); the walls and padding by
    global row."""
    cfg = model.cfg
    g = model.grids
    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    rhf0hm = 0.5 / (cfg.fnot * cfg.mixed.hmat)
    nt = rows.nxt
    stack = torch.stack([pa1, tauya, tauxa, F.pad(ast, (0, 1))])
    south, north = rows.mesh.start_exchange(stack, 1, "y",
                                            ATM_FACE_ROWS).wait()
    ext = torch.cat([south, stack, north], dim=-2)  # rows r0-1 .. r0+n
    pn, tyn = ext[0, 1:], ext[1, 1:]
    uuf = (-rdxaf0 * (pn[1:, :] - pn[:-1, :])
           - rhf0hm * (tyn[1:, :] + tyn[:-1, :]))
    twrap = 0.5 * (ast[:, :1] + ast[:, -1:])
    tuf = torch.cat([twrap, 0.5 * (ast[:, :-1] + ast[:, 1:]), twrap], dim=1)

    vvf = (rdxaf0 * (pa1[:, 1:] - pa1[:, :-1])
           + rhf0hm * (tauxa[:, 1:] + tauxa[:, :-1]))
    gp = rows.gy
    walls = (gp == 0) | (gp == rows.nyp - 1)
    vvf = torch.where(walls, 0.0, vvf)
    below, above = ext[3, :-2, :nt], ext[3, 1:-1, :nt]
    tvf = torch.where(gp == 0, above, torch.where(
        gp == rows.nyp - 1, below, 0.5 * (below + above)))
    t, p = rows.t_true, rows.p_true
    return (torch.where(t, uuf, 0.0), torch.where(t, tuf, 0.0),
            torch.where(p, vvf, 0.0), torch.where(p, tvf, 0.0))


def accumulate_atmos(acc: AtmosAverages, state, forcing, model,
                     rows=None) -> AtmosAverages:
    """acc plus one step's state and forcing; with `rows` (the
    atmosphere's models/ocean._Rows in a decomposed run) all of them are
    this rank's row blocks."""
    if rows is None:
        uuf, tuf, vvf, tvf = _atmos_faces(
            model, state.ast, state.pa[0], forcing.tauxa, forcing.tauya)
    else:
        uuf, tuf, vvf, tvf = _atmos_faces_rows(
            model, rows, state.ast, state.pa[0], forcing.tauxa,
            forcing.tauya)
    return AtmosAverages(
        n=acc.n + 1.0,
        ast=acc.ast + state.ast,
        hmixa=acc.hmixa + state.hmixa,
        wekta=acc.wekta + forcing.wekta,
        fnetat=acc.fnetat + forcing.fnetat,
        tauxa=acc.tauxa + forcing.tauxa,
        tauya=acc.tauya + forcing.tauya,
        wekpa=acc.wekpa + forcing.wekpa,
        pa=acc.pa + state.pa,
        qa=acc.qa + state.qa,
        uufa=acc.uufa + uuf, tufa=acc.tufa + tuf,
        utufa=acc.utufa + uuf * tuf,
        vvfa=acc.vvfa + vvf, tvfa=acc.tvfa + tvf,
        vtvfa=acc.vtvfa + vvf * tvf)


def eddy_fluxes(acc):
    """uptp = <uT> - <u><T>, vptp = <vT> - <v><T> (tavout,
    timavge.F:780-796 atmos / 850-870 ocean). Returns NumPy float64
    arrays."""
    n = max(float(acc.n), 1.0)
    if isinstance(acc, OceanAverages):
        uu, tu, utu = acc.uufo, acc.tufo, acc.utufo
        vv, tv, vtv = acc.vvfo, acc.tvfo, acc.vtvfo
    else:
        uu, tu, utu = acc.uufa, acc.tufa, acc.utufa
        vv, tv, vtv = acc.vvfa, acc.tvfa, acc.vtvfa
    uu, tu, utu, vv, tv, vtv = (host(a).astype(np.float64) / n
                                for a in (uu, tu, utu, vv, tv, vtv))
    return utu - uu * tu, vtv - vv * tv


def write_avges(path: str, model, oc_acc: Optional[OceanAverages],
                at_acc: Optional[AtmosAverages]):
    """Divide the accumulated sums by the counts and write avges.nc.
    The ocean variables double as a mean-forcing file for later
    ocean-only runs (q-gcm.F:791-808 reads fnetoc/tauxo/tauyo; the
    atmos-only mode reads sst)."""
    from ..io.ncdf import make_writer as NcWriter
    cfg = model.cfg
    w = NcWriter(path)
    if oc_acc is not None:
        n = max(float(oc_acc.n), 1.0)
        w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
        w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
        w.dim("zo", cfg.nlo)
        for nm in ["sst", "wekto", "fnetoc"]:
            w.var(nm, "d", ("yto", "xto"),
                  data=host(getattr(oc_acc, nm)) / n)
        for nm in ["tauxo", "tauyo", "wekpo"]:
            w.var(nm, "d", ("ypo", "xpo"),
                  data=host(getattr(oc_acc, nm)) / n)
        for nm in ["po", "qo"]:
            w.var(nm, "d", ("zo", "ypo", "xpo"),
                  data=host(getattr(oc_acc, nm)) / n)
        uptpoc, vptpoc = eddy_fluxes(oc_acc)
        w.var("uptpoc", "d", ("yto", "xpo"), data=uptpoc,
              units="K.m/s")
        w.var("vptpoc", "d", ("ypo", "xto"), data=vptpoc,
              units="K.m/s")
    if at_acc is not None:
        n = max(float(at_acc.n), 1.0)
        w.dim("xpa", cfg.nxpa); w.dim("ypa", cfg.nypa)
        w.dim("xta", cfg.nxta); w.dim("yta", cfg.nyta)
        w.dim("za", cfg.nla)
        for nm in ["ast", "hmixa", "wekta", "fnetat"]:
            w.var(nm, "d", ("yta", "xta"),
                  data=host(getattr(at_acc, nm)) / n)
        for nm in ["tauxa", "tauya", "wekpa"]:
            w.var(nm, "d", ("ypa", "xpa"),
                  data=host(getattr(at_acc, nm)) / n)
        for nm in ["pa", "qa"]:
            w.var(nm, "d", ("za", "ypa", "xpa"),
                  data=host(getattr(at_acc, nm)) / n)
        uptpat, vptpat = eddy_fluxes(at_acc)
        w.var("uptpat", "d", ("yta", "xpa"), data=uptpat,
              units="K.m/s")
        w.var("vptpat", "d", ("ypa", "xta"), data=vptpat,
              units="K.m/s")
    w.close()
