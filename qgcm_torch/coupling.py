"""Air-sea coupling: the xforc forcing computation (port of
qgcm_tpu/coupling.py, single-device form).

Replaces reference src/xfosubs.F. From the lagged model states xforc
computes the windstress on the ocean-resolution atmospheric grid by
quadratic drag on the (optionally ocean-relative, tau_udiff) geostrophic
wind (xfosubs.F:310-355, eqs 7.1-7.4), the Ekman velocities on both
grids (7.6-7.7) with their boundary integrals for the momentum
constraints, and the diabatic mixed-layer forcings fnetoc / fnetat
(7.8-7.10).

The host half (the bicubic weight tensors of bcuini/wts2bb and the
bilinear AST map of bilint, xfosubs.F:891-1630) is NumPy float64 run
once, copied from qgcm_tpu/coupling.py, which is NumPy here but cannot
be imported without JAX; `build_coupling` moves its results to the
device once. The device half is plain tensor code: the bicubic
refinement is a separable x-then-y contraction (torch.einsum, full FP32
with TF32 off on the card), the bilinear map a gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .config import ModelConfig
from .grids import Grids
from .ops.integrals import line_sum
from .radiation import fsprim
from .state import AtmosForcing


class XforcDiags(NamedTuple):
    """Monitoring scalars (monitor_data.F arlaav/slhfav/oradav/arocav)."""
    arlaav: torch.Tensor  # mean land AST radiation
    slhfav: torch.Tensor  # mean sensible+latent heat flux over ocean
    oradav: torch.Tensor  # mean oceanic IR radiation
    arocav: torch.Tensor  # mean atmos ML radiation into ocean


# ----------------------------------------------------------------------
# Bicubic weight tensors (host-side; bcuini/wts2bb, xfosubs.F:1238-1630)
# ----------------------------------------------------------------------

def _stinv() -> np.ndarray:
    """Inverse of the bicubic corner-constraint matrix: maps the vector
    {f, fs, ft, fst} at the 4 unit-cell corners to the 16 coefficients
    c_ij of f(s,t) = sum c_ij s^i t^j (the DATA matrix at
    xfosubs.F:1655-1670, derived instead of transcribed)."""
    M = np.zeros((16, 16))
    for jp in (0, 1):
        for ip in (0, 1):
            kp = 2 * jp + ip
            s, t = float(ip), float(jp)
            for j in range(4):
                for i in range(4):
                    m = 4 * j + i
                    M[kp, m] = s**i * t**j
                    M[kp + 4, m] = i * s**(i - 1) * t**j if i > 0 else 0.0
                    M[kp + 8, m] = j * s**i * t**(j - 1) if j > 0 else 0.0
                    M[kp + 12, m] = (i * j * s**(i - 1) * t**(j - 1)
                                     if (i > 0 and j > 0) else 0.0)
    return np.linalg.inv(M)


def _wts2bb(wfcn, wfnx, wfny, wfxy, stinv) -> np.ndarray:
    """B matrix: 16 data values -> 16 bicubic coefficients
    (wts2bb, xfosubs.F:1633-1729). Weight arrays are [id+1,jd+1,ip,jp]."""
    u2f = np.zeros((16, 16))
    for jp in (0, 1):
        for ip in (0, 1):
            kp = 2 * jp + ip
            kd = 0
            for jd in range(4):
                for id_ in range(4):
                    u2f[kp, kd] = wfcn[id_, jd, ip, jp]
                    u2f[kp + 4, kd] = wfnx[id_, jd, ip, jp]
                    u2f[kp + 8, kd] = wfny[id_, jd, ip, jp]
                    u2f[kp + 12, kd] = wfxy[id_, jd, ip, jp]
                    kd += 1
    return stinv @ u2f


def _weight_arrays(case: str, bccoat: float, dya: float):
    """Finite-difference weight sets of the five bcuini cases:
    'bbb' interior, 'us'/'un' u near the S/N wall (mixed pressure BC),
    'vs'/'vn' v near the S/N wall (v_y = -u_x from continuity, taking u
    data from the otherwise-empty jd=-1 / jd=+2 slots)."""
    wfcn = np.zeros((4, 4, 2, 2))
    wfnx = np.zeros((4, 4, 2, 2))
    wfny = np.zeros((4, 4, 2, 2))
    wfxy = np.zeros((4, 4, 2, 2))
    bod = bccoat / dya
    for jp in (0, 1):
        for ip in (0, 1):
            # id/jd are offset by +1 into the arrays (range -1..2)
            I, J = ip + 1, jp + 1
            wfcn[I, J, ip, jp] = 1.0
            wfnx[I + 1, J, ip, jp] = 0.5
            wfnx[I - 1, J, ip, jp] = -0.5
            special = (case in ("us", "vs") and jp == 0) or \
                      (case in ("un", "vn") and jp == 1)
            if not special:
                wfny[I, J + 1, ip, jp] = 0.5
                wfny[I, J - 1, ip, jp] = -0.5
                wfxy[I + 1, J + 1, ip, jp] = 0.25
                wfxy[I - 1, J + 1, ip, jp] = -0.25
                wfxy[I + 1, J - 1, ip, jp] = -0.25
                wfxy[I - 1, J - 1, ip, jp] = 0.25
            elif case == "us":
                wfny[I, J, ip, jp] = bod
                wfxy[I + 1, J, ip, jp] = bod * 0.5
                wfxy[I - 1, J, ip, jp] = -bod * 0.5
            elif case == "un":
                wfny[I, J, ip, jp] = -bod
                wfxy[I + 1, J, ip, jp] = -bod * 0.5
                wfxy[I - 1, J, ip, jp] = bod * 0.5
            elif case == "vs":
                wfny[I + 1, J - 1, ip, jp] = -0.5
                wfny[I - 1, J - 1, ip, jp] = 0.5
                wfxy[I + 1, J - 1, ip, jp] = -1.0
                wfxy[I, J - 1, ip, jp] = 2.0
                wfxy[I - 1, J - 1, ip, jp] = -1.0
            elif case == "vn":
                wfny[I + 1, J + 1, ip, jp] = -0.5
                wfny[I - 1, J + 1, ip, jp] = 0.5
                wfxy[I + 1, J + 1, ip, jp] = -1.0
                wfxy[I, J + 1, ip, jp] = 2.0
                wfxy[I - 1, J + 1, ip, jp] = -1.0
    return wfcn, wfnx, wfny, wfxy


def _bcu_weights(ndxr: int, bccoat: float, dya: float):
    """Fine-point weight tensors W[jd, a, ii, jj]: the contribution of
    coarse point (row offset jd-1, col offset a-1) to fine point
    (ii, jj) of the cell. Interior/south use jj=0..ndxr-1; north
    includes the wall row jj=ndxr."""
    stinv = _stinv()
    ss = np.arange(ndxr + 1) / ndxr
    # stfn[m, jj, ii] = ss[ii]^i * tt[jj]^j, m = 4j + i
    pow_s = ss[None, :] ** np.arange(4)[:, None]          # (4, ndxr+1)
    stfn = (pow_s[None, :, None, :] * pow_s[:, None, :, None])
    stfn = stfn.reshape(16, ndxr + 1, ndxr + 1)

    def tensor(case, njj):
        B = _wts2bb(*_weight_arrays(case, bccoat, dya), stinv)  # (16m,16k)
        stb = np.einsum("mji,mk->kij", stfn[:, :njj, :ndxr], B)
        # stb[k, ii, jj] with k = 4*jd + a
        return stb.reshape(4, 4, ndxr, njj)               # [jd, a, ii, jj]

    return (tensor("bbb", ndxr), tensor("us", ndxr), tensor("un", ndxr + 1),
            tensor("vs", ndxr), tensor("vn", ndxr + 1))


def _sep_factors(w: np.ndarray, max_rank: int = 2):
    """Split W[jd, a, ii, jj] into separable rank terms
    sum_r wy[jd, jj, r] * wx[r, a, ii], float64 (exact: the bicubic of
    tensor-product corner stencils is rank 1; the v-wall variants add
    one continuity term, rank 2). Separability lets the refinement run
    x-first at coarse-row cost; a construction change that raises the
    rank fails here instead of truncating the refinement."""
    jd, a, nii, njj = w.shape
    M = np.asarray(w, np.float64).transpose(0, 3, 1, 2)
    M = M.reshape(jd * njj, a * nii)
    U, s, Vt = np.linalg.svd(M, full_matrices=False)
    r = int((s > 1e-10 * s[0]).sum())
    if r > max_rank:
        raise ValueError(
            f"bicubic weight tensor has separable rank {r} > "
            f"{max_rank}; the refinement would be truncated")
    wy = (U[:, :r] * s[:r]).reshape(jd, njj, r)
    wx = Vt[:r].reshape(r, a, nii)
    return wy, wx


# ----------------------------------------------------------------------
# Static coupling data
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Coupling:
    """Operators and factors of xforc, built once on the host and held
    on the model's device in its dtype (indices as int64)."""
    # separable bicubic weight factors (wy[jd, jj, r], wx[r, a, ii]) per
    # bcuini case (see _sep_factors)
    w_bbb: tuple
    w_us: tuple
    w_un: tuple
    w_vs: tuple
    w_vn: tuple
    # bilinear astm -> ocean-T-grid gather
    bil_ix_m: torch.Tensor   # (nxto,) int64
    bil_ix_p: torch.Tensor
    bil_wx_p: torch.Tensor   # (nxto,)
    bil_jy_m: torch.Tensor   # (nyto,) int64
    bil_jy_p: torch.Tensor
    bil_wy_p: torch.Tensor
    # radiative forcing profiles fsprim at ocean/atmos T latitudes
    fsp_oc: torch.Tensor     # (nyto,)
    fsp_at: torch.Tensor     # (nyta,)
    # fine T points in each wekpa averaging box (data-independent)
    wekpa_count: torch.Tensor  # (nypa, nxpa)


def build_coupling(cfg: ModelConfig, grids: Grids, rad, device,
                   dtype) -> Coupling:
    """Host-side float64 set-up, moved to `device` in `dtype` once."""
    w = _bcu_weights(cfg.ndxr, cfg.atmos.bccoat, grids.dya)

    # bilint index/weight vectors (xfosubs.F:920-960): ocean T points in
    # the atmospheric T grid, cyclic x, constant-extrapolation y.
    xa0, ya0 = grids.xta[0], grids.yta[0]
    iam = np.floor(1.0 + (grids.xto - xa0) / grids.dxa).astype(int)  # 1-based
    xam = np.where(iam >= 1, (iam - 1) * grids.dxa + xa0,
                   xa0 - grids.dxa)
    wpx = (grids.xto - xam) / grids.dxa
    ix_m = (iam - 1) % cfg.nxta
    ix_p = iam % cfg.nxta
    jam = np.floor(1.0 + (grids.yto - ya0) / grids.dya).astype(int)
    jap = np.minimum(jam + 1, cfg.nyta)
    jam = np.maximum(jam, 1)
    wpy = (grids.yto - (ya0 + (jam - 1) * grids.dya)) / grids.dya

    fsp_oc = fsprim(cfg, rad.fspco, grids.ytorel)
    fsp_at = fsprim(cfg, rad.fspco, grids.ytarel)
    count = _box_sums(torch.ones(cfg.nytaor, cfg.nxtaor,
                                 dtype=torch.float64), cfg.ndxr, cfg.nypa,
                      cfg.nxpa)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            device=device, dtype=dtype)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def factors(wi, max_rank=2):
        return tuple(dev(f) for f in _sep_factors(wi, max_rank))

    return Coupling(
        w_bbb=factors(w[0], 1), w_us=factors(w[1], 1),
        w_un=factors(w[2], 1), w_vs=factors(w[3]), w_vn=factors(w[4]),
        bil_ix_m=idx(ix_m), bil_ix_p=idx(ix_p), bil_wx_p=dev(wpx),
        bil_jy_m=idx(jam - 1), bil_jy_p=idx(jap - 1), bil_wy_p=dev(wpy),
        fsp_oc=dev(fsp_oc), fsp_at=dev(fsp_at), wekpa_count=dev(count))


# ----------------------------------------------------------------------
# Bicubic refinement (auvbcu)
# ----------------------------------------------------------------------

def _xtaps(f: torch.Tensor) -> torch.Tensor:
    """(rows, nxta) -> (rows, nxta, 4): taps at columns (c+a-1) mod nxta."""
    return torch.stack([torch.roll(f, 1 - a, dims=-1) for a in range(4)],
                       dim=-1)


def _xrefine(taps: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(rows, nxta, 4 taps) x wx(4, nii) -> (rows, nxta*nii), the fine
    x axis merged."""
    out = torch.einsum("zca,ai->zci", taps, wx)
    return out.reshape(out.shape[0], -1)


def _band_refine(taps_rows: torch.Tensor, factors) -> torch.Tensor:
    """Wall band: (4 jd-slots, nxta, 4 taps) -> (njj, nxtaor), summing
    the separable rank terms (rank 2 for the v walls: the continuity
    term takes an x-derivative of the wall-u data)."""
    wy, wx = factors
    out = None
    for r in range(wx.shape[0]):
        X = _xrefine(taps_rows, wx[r])               # (4, m)
        t = torch.einsum("dm,dj->jm", X, wy[:, :, r])
        out = t if out is None else out + t
    return out


def bicubic_refine_uv(coup: Coupling, u1at: torch.Tensor,
                      v1at: torch.Tensor, ndxr: int):
    """Refine coarse p-grid velocities (nypa, nxpa) to the
    ocean-resolution atmospheric p grid (nypaor, nxpaor): x-refine the
    coarse rows first, then contract the y taps band-wise. The east
    column repeats the west one."""
    nypa = u1at.shape[0]
    nyta = nypa - 1
    U = _xtaps(u1at[:, :-1])                   # (nypa, nxta, 4)
    V = _xtaps(v1at[:, :-1])
    wy_b, wx_b = coup.w_bbb                    # rank 1
    wyv = wy_b[:, :, 0]

    def general(T):
        # d-th y-tap of interior bands 1..nyta-2: x-refined rows band-1+d
        X = torch.nn.functional.pad(_xrefine(T, wx_b[0]), (0, 0, 1, 1))
        S = torch.stack([X[d + 1:d + nyta - 1] for d in range(4)], dim=0)
        g = torch.einsum("dzm,dj->zjm", S, wyv)
        return g.reshape(-1, g.shape[-1])

    # south band (jc0 = 0): u pads jd=-1 with zeros, v pads with wall u
    sou_u = _band_refine(torch.cat([torch.zeros_like(U[:1]), U[0:3]]),
                         coup.w_us)
    sou_v = _band_refine(torch.cat([U[0:1], V[0:3]]), coup.w_vs)
    # north band (jc0 = nyta-1): jd=+2 slot: zeros for u, wall u for v
    nor_u = _band_refine(torch.cat([U[nyta - 2:nyta + 1],
                                    torch.zeros_like(U[:1])]), coup.w_un)
    nor_v = _band_refine(torch.cat([V[nyta - 2:nyta + 1],
                                    U[nypa - 1:nypa]]), coup.w_vn)

    ufin = torch.cat([sou_u, general(U), nor_u])
    vfin = torch.cat([sou_v, general(V), nor_v])
    return (torch.cat([ufin, ufin[:, :1]], dim=1),
            torch.cat([vfin, vfin[:, :1]], dim=1))


# ----------------------------------------------------------------------
# Helper reductions
# ----------------------------------------------------------------------

def _edge_integrals(field_rows: torch.Tensor, ndxr: int) -> torch.Tensor:
    """Line integrals of a fine-grid field sampled on coarse-aligned
    rows: (nrows, nxtaor+1) -> per-coarse-cell sums with half weights
    at both cell ends (xfosubs.F:370-381)."""
    nxta = (field_rows.shape[-1] - 1) // ndxr
    full = field_rows[..., :-1].reshape(
        field_rows.shape[:-1] + (nxta, ndxr)).sum(-1)
    ends = field_rows[..., ::ndxr]
    return full - 0.5 * ends[..., :-1] + 0.5 * ends[..., 1:]


def _block_sums(x: torch.Tensor, k: int, ny: int, nx: int) -> torch.Tensor:
    """Sums over the first (ny, nx) non-overlapping k x k blocks of x."""
    return x[:ny * k, :nx * k].reshape(ny, k, nx, k).sum((1, 3))


def _box_sums(f: torch.Tensor, ndxr: int, nypa: int,
              nxpa: int) -> torch.Tensor:
    """Weighted box sums of a fine T-grid field around each coarse p
    point (xfosubs.F:440-470): even ndxr, the ndxr x ndxr block around
    the point; odd, the mean of the four blocks offset by one fine cell,
    which is the half-weighted (ndxr+1)-wide box. Cyclic in x; rows
    beyond the N/S walls count as zero."""
    half = (ndxr - 1) // 2 + 1
    f = torch.cat([f[:, -half:], f, f[:, :half]], dim=1)
    f = torch.nn.functional.pad(f, (0, 0, half, half))
    if ndxr % 2 == 0:
        return _block_sums(f, ndxr, nypa, nxpa)
    return 0.25 * (_block_sums(f, ndxr, nypa, nxpa)
                   + _block_sums(f[:, 1:], ndxr, nypa, nxpa)
                   + _block_sums(f[1:], ndxr, nypa, nxpa)
                   + _block_sums(f[1:, 1:], ndxr, nypa, nxpa))


def _bilint_ast(coup: Coupling, astm: torch.Tensor) -> torch.Tensor:
    """Bilinear astm (nyta, nxta) -> ocean T grid (nyto, nxto)."""
    wpx = coup.bil_wx_p[None, :]
    wpy = coup.bil_wy_p[:, None]
    rows_m, rows_p = astm[coup.bil_jy_m], astm[coup.bil_jy_p]
    a_mm = rows_m[:, coup.bil_ix_m]
    a_mp = rows_m[:, coup.bil_ix_p]
    a_pm = rows_p[:, coup.bil_ix_m]
    a_pp = rows_p[:, coup.bil_ix_p]
    return ((1 - wpx) * (1 - wpy) * a_mm + wpx * (1 - wpy) * a_mp
            + (1 - wpx) * wpy * a_pm + wpx * wpy * a_pp)


# ----------------------------------------------------------------------
# xforc proper
# ----------------------------------------------------------------------

def make_xforc(model):
    """Build xforc(pam, pom, sstm, astm, hmixam)
    -> (OceanForcing | None, AtmosForcing, XforcDiags).

    pom may be None in atmos_only mode, where sstm is the prescribed
    mean SST field; pam/astm/hmixam may not. With tau_udiff the ocean's
    geostrophic velocity is subtracted from the wind inside the ocean
    footprint of the fine grid before the drag is taken. The fine-grid
    fields live only inside one call."""
    from .models.ocean import ekman_forcing
    from .ops.stencils import _col_mask, _row_mask

    cfg: ModelConfig = model.cfg
    g: Grids = model.grids
    coup: Coupling = model.coupling
    rad = model.rad
    ndxr = cfg.ndxr
    dev, dtype = model.device, model.dtype

    nxpa, nypa = cfg.nxpa, cfg.nypa
    nxta, nyta = cfg.nxta, cfg.nyta
    nxpo, nypo = cfg.nxpo, cfg.nypo

    rdxaf0 = 1.0 / (g.dxa * cfg.fnot)
    rdxof0 = 1.0 / (g.dxo * cfg.fnot)
    hxafac = 0.5 * rdxaf0
    hxofac = 0.5 * rdxof0
    zbfcat = rdxaf0 / (0.5 * cfg.atmos.bccoat + 1.0)
    zbfcoc = rdxof0 / (0.5 * cfg.ocean.bccooc + 1.0)
    hmat = cfg.mixed.hmat
    uvekfc = 1.0 / (hmat * cfg.fnot * ndxr)
    hmrdxa = hmat / g.dxa
    raoro = cfg.rhoat / cfg.rhooc

    # quadratic-drag coefficients (xfosubs.F:148-160)
    cdhfaa = (cfg.cdat / cfg.fnot) / hmat
    cdhfab = (cfg.cdat / cfg.fnot) * (1.0 / hmat
                                      + raoro / cfg.mixed.hmoc)
    cdrfaa = cfg.cdat / abs(cdhfaa)
    cdrfab = cfg.cdat / abs(cdhfab)
    qu2faa = 4.0 * cdhfaa * cdhfaa
    qu2fab = 4.0 * cdhfab * cdhfab

    # ocean window offsets in the fine grid (0-based)
    ioc0 = (cfg.nx1 - 1) * ndxr
    joc0 = (cfg.ny1 - 1) * ndxr
    # constraint rows jsou/jnor (0-based; xfosubs.F:93)
    jsou = ndxr // 2
    jnor = cfg.nypaor - 1 - ndxr // 2
    ndxodd = ndxr % 2 == 1
    # the ocean footprint on the coarse T grid
    oc_rows = slice(cfg.ny1 - 1, cfg.ny1 - 1 + cfg.nyaooc)
    oc_cols = slice(cfg.nx1 - 1, cfg.nx1 - 1 + cfg.nxaooc)

    # heat-flux factors (xfosubs.F:770-780); float() keeps NumPy
    # scalars from entering the tensor arithmetic
    ocfrac = (g.dxo * g.dyo) / (g.dxa * g.dya)
    fmafac = float(rad.Adown[0, 0]) * 0.25 / cfg.atmos.gpat[0]
    fmatop = 0.25 * (rad.Cmup + rad.C1down)
    hmafac = -cfg.mixed.hmadmp - rad.Bmup - rad.B1down
    dtopat = model.dtopat
    xlamda = cfg.mixed.xlamda

    # tau_udiff coefficient fields over the fine grid (xfosubs.F:322-335)
    if cfg.tau_udiff:
        cdrfac, qu2fac = (torch.full((cfg.nypaor, cfg.nxpaor), outside,
                                     dtype=dtype, device=dev)
                          for outside in (cdrfaa, qu2faa))
        cdrfac[joc0:joc0 + nypo, ioc0:ioc0 + nxpo] = cdrfab
        qu2fac[joc0:joc0 + nypo, ioc0:ioc0 + nxpo] = qu2fab
    else:
        cdrfac, qu2fac = cdrfaa, qu2faa
    # the ocean footprint's offsets as F.pad widths
    widths = (ioc0, cfg.nxpaor - ioc0 - nxpo, joc0, cfg.nypaor - joc0 - nypo)

    def quad_drag(u, v, cdr, qu2):
        """Quadratic-drag windstress (7.1-7.4) from velocities."""
        sp2 = u * u + v * v
        scasqd = -0.5 + 0.5 * torch.sqrt(1.0 + qu2 * sp2)
        scashr = torch.sqrt(scasqd)
        cdochi = cdr * scashr / (1.0 + scasqd)
        return cdochi * (u - scashr * v), cdochi * (v + scashr * u)

    def ocean_velocity(po1):
        """Geostrophic velocity of the ocean's top layer at p points,
        with the mixed-BC wall rows (and box columns)."""
        ppy = torch.cat([po1[:1], po1, po1[-1:]])
        ps, pn = ppy[:-2], ppy[2:]
        south, north = _row_mask(po1, 0), _row_mask(po1, -1)
        u = torch.where(south, -zbfcoc * (pn - po1),
                        torch.where(north, -zbfcoc * (po1 - ps),
                                    -hxofac * (pn - ps)))
        if cfg.cyclic_ocean:
            poe = torch.cat([po1[:, 1:], po1[:, 1:2]], dim=1)
            pow_ = torch.cat([po1[:, -2:-1], po1[:, :-1]], dim=1)
            v = hxofac * (poe - pow_)
        else:
            ppx = torch.cat([po1[:, :1], po1, po1[:, -1:]], dim=1)
            pw, pe = ppx[:, :-2], ppx[:, 2:]
            west, east = _col_mask(po1, 0), _col_mask(po1, -1)
            v = torch.where(west, zbfcoc * (pe - po1),
                            torch.where(east, zbfcoc * (po1 - pw),
                                        hxofac * (pe - pw)))
            u = torch.where(west | east, 0.0, u)
        # zonal walls: v = 0 there (p constant along the wall)
        return u, torch.where(south | north, 0.0, v)

    def xforc(pam, pom, sstm, astm, hmixam):
        # --- atmospheric geostrophic velocity at p points ---
        pa1 = pam[0]
        u1at = torch.cat([-zbfcat * (pa1[1:2] - pa1[0:1]),
                          -hxafac * (pa1[2:] - pa1[:-2]),
                          -zbfcat * (pa1[-1:] - pa1[-2:-1])])
        pe = torch.cat([pa1[:, 1:], pa1[:, 1:2]], dim=1)
        pw = torch.cat([pa1[:, -2:-1], pa1[:, :-1]], dim=1)
        v1at = hxafac * (pe - pw)
        v1at[0] = 0.0
        v1at[-1] = 0.0

        u1ator, v1ator = bicubic_refine_uv(coup, u1at, v1at, ndxr)

        # --- subtract the ocean's geostrophic velocity (tau_udiff) ---
        if cfg.tau_udiff and pom is not None:
            u1oc, v1oc = ocean_velocity(pom[0])
            u1ator = u1ator - torch.nn.functional.pad(u1oc, widths)
            v1ator = v1ator - torch.nn.functional.pad(v1oc, widths)

        # --- quadratic-drag windstress on the fine grid (7.1-7.4) ---
        tauxaor, tauyaor = quad_drag(u1ator, v1ator, cdrfac, qu2fac)

        # --- tau on the coarse atmospheric p grid (copies: a view would
        # keep the fine grid alive as long as the forcing) ---
        tauxa = tauxaor[::ndxr, ::ndxr].contiguous()
        tauya = tauyaor[::ndxr, ::ndxr].contiguous()

        # --- Ekman components for amladf (cell-edge integrals) ---
        vekat = uvekfc * _edge_integrals(tauxaor[::ndxr, :], ndxr)
        # uekat: integrate tauy along meridional cell sides
        ucol = _edge_integrals(tauyaor[:, ::ndxr].T, ndxr).T
        uekat = -uvekfc * ucol                      # (nyta, nxpa)
        wekta = -hmrdxa * (uekat[:, 1:] - uekat[:, :-1]
                           + vekat[1:, :] - vekat[:-1, :])

        # --- fine-grid Ekman velocity and wekpa box means (7.6) ---
        wektaor = hxofac * (
            tauyaor[:-1, 1:] + tauyaor[1:, 1:]
            - tauyaor[:-1, :-1] - tauyaor[1:, :-1]
            + tauxaor[:-1, :-1] + tauxaor[:-1, 1:]
            - tauxaor[1:, :-1] - tauxaor[1:, 1:])
        wekpa = _box_sums(wektaor, ndxr, nypa, nxpa) / coup.wekpa_count

        # --- atmospheric momentum-constraint stress integrals ---
        if ndxodd:
            txisat = 0.5 * g.dxo * line_sum(
                tauxaor[jsou, :] + tauxaor[jsou + 1, :])
            txinat = 0.5 * g.dxo * line_sum(
                tauxaor[jnor, :] + tauxaor[jnor - 1, :])
        else:
            txisat = g.dxo * line_sum(tauxaor[jsou, :])
            txinat = g.dxo * line_sum(tauxaor[jnor, :])

        # --- oceanic stresses and Ekman velocities ---
        ocean_forcing = None
        asto = _bilint_ast(coup, astm)
        ocnrad = rad.D0up * sstm
        slhf = xlamda * (sstm - asto)
        if not cfg.atmos_only:
            tauxo = raoro * tauxaor[joc0:joc0 + nypo, ioc0:ioc0 + nxpo]
            tauyo = raoro * tauyaor[joc0:joc0 + nypo, ioc0:ioc0 + nxpo]
            atmrad_oc = rad.Dmdown * asto
            fnetoc = -coup.fsp_oc[:, None] - atmrad_oc - ocnrad - slhf
            ocean_forcing = ekman_forcing(model, tauxo, tauyo, fnetoc)
            arocav = atmrad_oc.sum() * cfg.ocnorm
        else:
            arocav = torch.zeros((), dtype=dtype, device=dev)

        # --- atmospheric diabatic forcing (7.8-7.9) ---
        fnetat = -coup.fsp_at[:, None] - rad.Dmup * astm
        arlasm = astm.sum() - astm[oc_rows, oc_cols].sum()
        natlan = nxta * nyta - cfg.nxaooc * cfg.nyaooc
        arlaav = (rad.Dmup * arlasm / natlan if natlan > 0
                  else torch.zeros((), dtype=dtype, device=dev))

        # over-ocean contribution, aggregated to atmos cells
        contrib = ocnrad + (rad.Dmdown - rad.Dmup) * asto + slhf
        blocks = contrib.reshape(cfg.nyaooc, ndxr,
                                 cfg.nxaooc, ndxr).sum((1, 3))
        fnetat[oc_rows, oc_cols] = ocfrac * blocks

        # eta / topography / thickness terms (7.8 first three terms)
        dp12 = pam[0] - pam[1]
        four = (dp12[:-1, :-1] + dp12[:-1, 1:]
                + dp12[1:, :-1] + dp12[1:, 1:])
        fnetat = fnetat - fmafac * four
        if dtopat.dim():
            fnetat = fnetat - fmatop * (dtopat[:-1, :-1] + dtopat[:-1, 1:]
                                        + dtopat[1:, :-1] + dtopat[1:, 1:])
        fnetat = fnetat + hmafac * (hmixam - hmat)

        atmos_forcing = AtmosForcing(
            tauxa=tauxa, tauya=tauya, fnetat=fnetat,
            wekta=wekta, wekpa=wekpa, uekat=uekat, vekat=vekat,
            txisat=txisat, txinat=txinat)
        diags = XforcDiags(arlaav=arlaav, slhfav=slhf.sum() * cfg.ocnorm,
                           oradav=ocnrad.sum() * cfg.ocnorm, arocav=arocav)
        return ocean_forcing, atmos_forcing, diags

    return xforc

