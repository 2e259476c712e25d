"""Air-sea coupling: the xforc forcing computation (port of
qgcm_tpu/coupling.py), on one device or on the ocean's blocks.

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
import torch.nn.functional as F

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
                      v1at: torch.Tensor, ndxr: int, lo: int = 0,
                      hi: int = None, clo: int = 0, chi: int = None):
    """Refine coarse p-grid velocities (nypa, nxpa) to the
    ocean-resolution atmospheric p grid (nypaor, nxpaor), or to its rows
    [lo, hi) and columns [clo, chi) only: x-refine the coarse cells that
    those columns lie in, of the coarse rows that those rows' bands
    read, then contract the y taps band-wise. Band b holds the fine rows
    [b*ndxr, (b+1)*ndxr); the south band (b = 0) and the north band (b =
    nyta-1, one row taller) take the wall weights, every band between
    them reads coarse rows b-1 .. b+2. A point is the same arithmetic
    whatever the ranges. The east column repeats the west one."""
    nypa, nxpa = u1at.shape
    nyta, nxta = nypa - 1, nxpa - 1
    hi = nyta * ndxr + 1 if hi is None else hi
    chi = nxta * ndxr + 1 if chi is None else chi
    U = _xtaps(u1at[:, :-1])                   # (nypa, nxta, 4)
    V = _xtaps(v1at[:, :-1])
    # the coarse cells of the columns, and cell 0 again for the
    # duplicate east column
    q0, q1 = clo // ndxr, min(chi - 1, nxta * ndxr - 1) // ndxr
    whole = q0 == 0 and q1 == nxta - 1
    dup = chi == nxta * ndxr + 1
    if not whole:
        cells = list(range(q0, q1 + 1)) + ([0] if dup else [])
        U, V = U[:, cells], V[:, cells]
    wy_b, wx_b = coup.w_bbb                    # rank 1
    wyv = wy_b[:, :, 0]
    parts = []      # (first fine row, u rows, v rows) of each band range
    if lo < ndxr:
        # south band (jc0 = 0): u pads jd=-1 with zeros, v pads with wall u
        parts.append((0, _band_refine(torch.cat([torch.zeros_like(U[:1]),
                                                 U[0:3]]), coup.w_us),
                      _band_refine(torch.cat([U[0:1], V[0:3]]), coup.w_vs)))
    b0, b1 = max(1, lo // ndxr), min(nyta - 2, (hi - 1) // ndxr)
    if b0 <= b1:
        def general(T):
            # the d-th y-tap of band b: x-refined coarse row b-1+d
            X = _xrefine(T[b0 - 1:b1 + 3], wx_b[0])
            S = torch.stack([X[d:d + b1 - b0 + 1] for d in range(4)], dim=0)
            g = torch.einsum("dzm,dj->zjm", S, wyv)
            return g.reshape(-1, g.shape[-1])

        parts.append((b0 * ndxr, general(U), general(V)))
    if hi > (nyta - 1) * ndxr:
        # north band (jc0 = nyta-1): jd=+2 slot: zeros for u, wall u for v
        parts.append(((nyta - 1) * ndxr,
                      _band_refine(torch.cat([U[nyta - 2:nyta + 1],
                                              torch.zeros_like(U[:1])]),
                                   coup.w_un),
                      _band_refine(torch.cat([V[nyta - 2:nyta + 1],
                                              U[nypa - 1:nypa]]), coup.w_vn)))
    start = parts[0][0]
    out = []
    for k in (1, 2):
        f = torch.cat([p[k] for p in parts])[lo - start:hi - start]
        if whole:
            f = torch.cat([f, f[:, :1]], dim=1)[:, clo:chi]
        else:
            w = (q1 - q0 + 1) * ndxr
            f = torch.cat([f[:, :w], f[:, w:w + 1]], dim=1)[
                :, clo - q0 * ndxr:chi - q0 * ndxr]
        out.append(f)
    return tuple(out)


def bicubic_refine_window(coup: Coupling, u1at: torch.Tensor,
                          v1at: torch.Tensor, cfg):
    """The refinement on the ocean's window of the fine grid only,
    (nypo, nxpo) (qgcm_tpu's bicubic_refine_window, whose mesh xforc
    recomputes the ocean's windstress so because GSPMD would gather a
    slice of its sharded fine grid). The port's decomposed xforc slices
    its own row block instead (make_xforc)."""
    r0, c0 = (cfg.ny1 - 1) * cfg.ndxr, (cfg.nx1 - 1) * cfg.ndxr
    return tuple(f[:, c0:c0 + cfg.nxpo] for f in bicubic_refine_uv(
        coup, u1at, v1at, cfg.ndxr, r0, r0 + cfg.nypo))


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


def _box_sums(f: torch.Tensor, ndxr: int, nypa: int, nxpa: int,
              t0: int = 0) -> torch.Tensor:
    """Weighted box sums of a fine T-grid field around each coarse p
    point (xfosubs.F:440-470): even ndxr, the ndxr x ndxr block around
    the point; odd, the mean of the four blocks offset by one fine cell,
    which is the half-weighted (ndxr+1)-wide box. Cyclic in x; rows
    beyond the N/S walls count as zero. `f` holds the fine T rows t0,
    t0+1, ... and every other row counts as zero, so that the sums of
    row blocks add up to those of the whole; only the coarse rows whose
    boxes meet f's rows are summed, each from the same rows in the same
    order whatever the block."""
    half = (ndxr - 1) // 2 + 1
    odd = ndxr % 2
    t1 = t0 + f.shape[0]
    jlo = (t0 + half - odd) // ndxr
    jhi = min(nypa - 1, (t1 + half - 1) // ndxr)
    f = torch.cat([f[:, -half:], f, f[:, :half]], dim=1)
    f = F.pad(f, (0, 0, t0 + half - jlo * ndxr,
                  (jhi + 1) * ndxr + odd - t1 - half))
    ny = jhi - jlo + 1
    if odd:
        s = 0.25 * (_block_sums(f, ndxr, ny, nxpa)
                    + _block_sums(f[:, 1:], ndxr, ny, nxpa)
                    + _block_sums(f[1:], ndxr, ny, nxpa)
                    + _block_sums(f[1:, 1:], ndxr, ny, nxpa))
    else:
        s = _block_sums(f, ndxr, ny, nxpa)
    return F.pad(s, (0, 0, jlo, nypa - 1 - jhi))


def _bilint_ast(coup: Coupling, astm: torch.Tensor, t0: int = 0,
                t1: int = None, s0: int = 0, s1: int = None) -> torch.Tensor:
    """Bilinear astm (nyta, nxta) -> ocean T grid (nyto, nxto), or its
    rows [t0, t1) and columns [s0, s1)."""
    wpx = coup.bil_wx_p[None, s0:s1]
    wpy = coup.bil_wy_p[t0:t1, None]
    rows_m, rows_p = astm[coup.bil_jy_m[t0:t1]], astm[coup.bil_jy_p[t0:t1]]
    ixm, ixp = coup.bil_ix_m[s0:s1], coup.bil_ix_p[s0:s1]
    a_mm = rows_m[:, ixm]
    a_mp = rows_m[:, ixp]
    a_pm = rows_p[:, ixm]
    a_pp = rows_p[:, ixp]
    return ((1 - wpx) * (1 - wpy) * a_mm + wpx * (1 - wpy) * a_mp
            + (1 - wpx) * wpy * a_pm + wpx * wpy * a_pp)


# ----------------------------------------------------------------------
# xforc proper
# ----------------------------------------------------------------------

# collective call sites of the decomposed xforc (Mesh.counts)
XFORC_ROWS = "coupling.rows"
XFORC_COLS = "coupling.cols"
XFORC_SUMS = "coupling.sums"
XFORC_GATHER = "coupling.gather"


def make_xforc(model, mesh=None):
    """Build xforc(pam, pom, sstm, astm, hmixam)
    -> (OceanForcing | None, AtmosForcing, XforcDiags).

    pom may be None in atmos_only mode, where sstm is the prescribed
    mean SST field; pam/astm/hmixam may not. With tau_udiff the ocean's
    geostrophic velocity is subtracted from the wind inside the ocean
    footprint of the fine grid before the drag is taken. The fine-grid
    fields live only inside one call.

    With `mesh` (parallel/mesh.py: a mesh made for the ocean's p-grid, of
    any (y, x) shape) pom and sstm are this rank's blocks on
    parallel/mesh.ocean_mesh(mesh, cfg) (mesh itself for a box, rows
    over all its ranks for a channel or an atmosphere-only case) and so
    is the ocean forcing (mesh.shard_tree's layout); pam, astm and hmixam
    are its row blocks of the atmosphere (on parallel/mesh.atmos_mesh(
    mesh, cfg)), and so is the atmospheric forcing; the diagnostics are
    the same bits on every rank. An atmosphere-only case passes pom None
    and as sstm its block of the prescribed SST. No collective is larger
    than the coarse atmospheric grid, as in qgcm_tpu (coupling.py:
    600-604, 731-736):
      * one gather puts together the coarse fields xforc reads (pam's
        two bottom layers, astm, hmixam), so that every rank refines the
        atmosphere rows its fine rows need, wherever they lie, and
        computes the coarse velocities from the whole pam;
      * the fine grid is cut into the ocean's blocks: a rank refines the
        fine rows of its ocean rows (rank 0 also those south of the
        ocean, the rank with the ocean's north wall those north of it)
        and one more each side, and on a 2-D mesh only the fine columns
        of its ocean columns (the ranks of the west column also those
        west of the ocean, those with the east wall those east of it,
        the duplicated east column included) and one more each side.
        Its ocean windstress, with the row and column each side that the
        Ekman curl and its average onto p points read, is a slice of
        that block; qgcm_tpu recomputes it instead
        (bicubic_refine_window) because GSPMD would gather a slice of
        its sharded fine grid;
      * tau_udiff's ocean velocity reads two ghost rows (and columns) of
        pom[0] (one exchange each);
      * a rank sums what its own fine points give the coarse outputs
        (tauxa, tauya, vekat, uekat, the wekpa box sums, the
        atmosphere's stress integrals: its columns are put in zeros as
        wide as the fine grid for those sums, which wrap in x) and what
        its own ocean points give the heat-flux blocks over the ocean
        and the diagnostics' sums; one all_reduce of coarse size adds
        the ranks' shares;
      * in the channel the ranks that hold the wall rows form txisoc and
        txinoc, which an all_reduce hands to every rank (ekman_forcing);
      * every rank forms the whole atmospheric forcing from the summed
        coarse outputs, the same bits on every rank, and keeps its rows.
    Under autograd the gather's backward hands each rank the sum of the
    ranks' cotangents of its rows, and the all_reduce's that of the
    coarse outputs, each rank's nonzero only where its rows read them.
    A coarse value that one rank's rows form whole comes out bit for bit
    the single-device one; a sum split across a block boundary differs
    from it by roundoff, as qgcm_tpu's own does (:733-735). A footprint
    that reaches the atmosphere's wall bands (qgcm_tpu's
    _footprint_interior false, where its mesh path slices the sharded
    fine grid and GSPMD gathers it) needs nothing else here: the wall
    bands are rows of a block like any other."""
    from .models.ocean import _Rows, check_mesh_grid, ekman_forcing
    from .ops.stencils import _col_mask
    from .parallel.mesh import atmos_mesh, gather, ocean_mesh, shard_tree

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

    if mesh is not None:
        mesh = ocean_mesh(mesh, cfg)
        check_mesh_grid(cfg, mesh, "the decomposed xforc")
        amesh = atmos_mesh(mesh, cfg)
        rows = _Rows(mesh, cfg, dev)
        if rows.r0 >= nypo or rows.c0 >= nxpo:
            raise ValueError(f"rank {mesh.rank} of {mesh.size} holds no "
                             f"ocean point of {(nypo, nxpo)}: use fewer "
                             "ranks")
        r0, n, c0, m = rows.r0, rows.n, rows.c0, rows.m
        o1 = min(r0 + n, nypo)             # past the rank's last true row
        nt = max(0, min(r0 + n, cfg.nyto) - r0)   # its true T rows
        # the fine rows the rank owns, [f0, f1), and those it refines
        f0 = 0 if r0 == 0 else joc0 + r0
        f1 = cfg.nypaor if o1 == nypo else joc0 + o1
        e0, e1 = max(f0 - 1, 0), min(f1 + 1, cfg.nypaor)
        # the same for the fine columns on a 2-D mesh (rank ix = 0 also
        # owns those west of the ocean, the rank with the ocean's east
        # wall those east of it); on a rows mesh every column
        ct = max(0, min(c0 + m, cfg.nxto) - c0)   # its true T columns
        if rows.two_d:
            o2 = min(c0 + m, nxpo)
            g0 = 0 if c0 == 0 else ioc0 + c0
            g1 = cfg.nxpaor if o2 == nxpo else ioc0 + o2
            h0, h1 = max(g0 - 1, 0), min(g1 + 1, cfg.nxpaor)
        else:
            g0, g1 = h0, h1 = 0, cfg.nxpaor
        if cfg.tau_udiff:
            cdrfac, qu2fac = (c[e0:e1, h0:h1].contiguous()
                              for c in (cdrfac, qu2fac))

    def quad_drag(u, v, cdr, qu2):
        """Quadratic-drag windstress (7.1-7.4) from velocities."""
        sp2 = u * u + v * v
        scasqd = -0.5 + 0.5 * torch.sqrt(1.0 + qu2 * sp2)
        scashr = torch.sqrt(scasqd)
        cdochi = cdr * scashr / (1.0 + scasqd)
        return cdochi * (u - scashr * v), cdochi * (v + scashr * u)

    def ocean_velocity(ext, gy, gx=None):
        """Geostrophic velocity of the ocean's top layer at the p rows of
        global indices gy ((n, 1)) from `ext`, those rows and one more
        each side, with the mixed-BC wall rows (and box columns). With
        `gx` (the columns' global indices, (1, m)) ext has one more
        column each side as well; without, it holds every column."""
        if gx is not None:
            pw, pe = ext[1:-1, :-2], ext[1:-1, 2:]
            ext = ext[:, 1:-1]
        po1, ps, pn = ext[1:-1], ext[:-2], ext[2:]
        south, north = gy == 0, gy == nypo - 1
        u = torch.where(south, -zbfcoc * (pn - po1),
                        torch.where(north, -zbfcoc * (po1 - ps),
                                    -hxofac * (pn - ps)))
        if cfg.cyclic_ocean:
            poe = torch.cat([po1[:, 1:], po1[:, 1:2]], dim=1)
            pow_ = torch.cat([po1[:, -2:-1], po1[:, :-1]], dim=1)
            v = hxofac * (poe - pow_)
        else:
            if gx is None:
                ppx = torch.cat([po1[:, :1], po1, po1[:, -1:]], dim=1)
                pw, pe = ppx[:, :-2], ppx[:, 2:]
                west, east = _col_mask(po1, 0), _col_mask(po1, -1)
            else:
                west, east = gx == 0, gx == nxpo - 1
            v = torch.where(west, zbfcoc * (pe - po1),
                            torch.where(east, zbfcoc * (po1 - pw),
                                        hxofac * (pe - pw)))
            u = torch.where(west | east, 0.0, u)
        # zonal walls: v = 0 there (p constant along the wall)
        return u, torch.where(south | north, 0.0, v)

    def coarse_velocity(pam):
        """The atmosphere's geostrophic velocity at its p points."""
        pa1 = pam[0]
        u1at = torch.cat([-zbfcat * (pa1[1:2] - pa1[0:1]),
                          -hxafac * (pa1[2:] - pa1[:-2]),
                          -zbfcat * (pa1[-1:] - pa1[-2:-1])])
        pe = torch.cat([pa1[:, 1:], pa1[:, 1:2]], dim=1)
        pw = torch.cat([pa1[:, -2:-1], pa1[:, :-1]], dim=1)
        v1at = hxafac * (pe - pw)
        v1at[0] = 0.0
        v1at[-1] = 0.0
        return u1at, v1at

    def wekt(tx, ty):
        """The fine-grid Ekman velocity on the T rows between the rows of
        the stresses (7.6)."""
        return hxofac * (ty[:-1, 1:] + ty[1:, 1:] - ty[:-1, :-1]
                         - ty[1:, :-1] + tx[:-1, :-1] + tx[:-1, 1:]
                         - tx[1:, :-1] - tx[1:, 1:])

    def stress_integral(tx, j, inward):
        """The atmosphere's momentum-constraint stress integral along the
        fine row j of tx (with its neighbour `inward` when ndxr is
        odd)."""
        if ndxodd:
            return 0.5 * g.dxo * line_sum(tx[j, :] + tx[j + inward, :])
        return g.dxo * line_sum(tx[j, :])

    def atmos_tail(pam, astm, hmixam, tauxa, tauya, uekat, vekat, wekpa,
                   txisat, txinat, blocks, sums):
        """The atmospheric forcing and the diagnostics from the coarse
        outputs, `blocks` (the over-ocean heat flux summed to atmosphere
        cells) and `sums` (the ocean's slhf, ocnrad and atmrad_oc
        sums)."""
        wekta = -hmrdxa * (uekat[:, 1:] - uekat[:, :-1]
                           + vekat[1:, :] - vekat[:-1, :])
        # --- atmospheric diabatic forcing (7.8-7.9) ---
        fnetat = -coup.fsp_at[:, None] - rad.Dmup * astm
        arlasm = astm.sum() - astm[oc_rows, oc_cols].sum()
        natlan = nxta * nyta - cfg.nxaooc * cfg.nyaooc
        arlaav = (rad.Dmup * arlasm / natlan if natlan > 0
                  else torch.zeros((), dtype=dtype, device=dev))
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
        slhf_sum, ocnrad_sum, atmrad_sum = sums
        arocav = (atmrad_sum * cfg.ocnorm if not cfg.atmos_only
                  else torch.zeros((), dtype=dtype, device=dev))
        diags = XforcDiags(arlaav=arlaav, slhfav=slhf_sum * cfg.ocnorm,
                           oradav=ocnrad_sum * cfg.ocnorm, arocav=arocav)
        return atmos_forcing, diags

    def xforc(pam, pom, sstm, astm, hmixam):
        u1ator, v1ator = bicubic_refine_uv(coup, *coarse_velocity(pam),
                                           ndxr)

        # --- subtract the ocean's geostrophic velocity (tau_udiff) ---
        if cfg.tau_udiff and pom is not None:
            po1 = pom[0]
            u1oc, v1oc = ocean_velocity(
                torch.cat([po1[:1], po1, po1[-1:]]),
                torch.arange(nypo, device=dev)[:, None])
            widths = (ioc0, cfg.nxpaor - ioc0 - nxpo,
                      joc0, cfg.nypaor - joc0 - nypo)
            u1ator = u1ator - F.pad(u1oc, widths)
            v1ator = v1ator - F.pad(v1oc, widths)

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

        # --- fine-grid Ekman velocity and wekpa box means (7.6) ---
        wekpa = (_box_sums(wekt(tauxaor, tauyaor), ndxr, nypa, nxpa)
                 / coup.wekpa_count)

        # --- atmospheric momentum-constraint stress integrals ---
        txisat = stress_integral(tauxaor, jsou, 1)
        txinat = stress_integral(tauxaor, jnor, -1)

        # --- oceanic stresses and Ekman velocities ---
        ocean_forcing = None
        asto = _bilint_ast(coup, astm)
        ocnrad = rad.D0up * sstm
        slhf = xlamda * (sstm - asto)
        atmrad_oc = rad.Dmdown * asto
        if not cfg.atmos_only:
            tauxo = raoro * tauxaor[joc0:joc0 + nypo, ioc0:ioc0 + nxpo]
            tauyo = raoro * tauyaor[joc0:joc0 + nypo, ioc0:ioc0 + nxpo]
            fnetoc = -coup.fsp_oc[:, None] - atmrad_oc - ocnrad - slhf
            ocean_forcing = ekman_forcing(model, tauxo, tauyo, fnetoc)
        # over-ocean contribution, aggregated to atmos cells
        contrib = ocnrad + (rad.Dmdown - rad.Dmup) * asto + slhf
        blocks = contrib.reshape(cfg.nyaooc, ndxr,
                                 cfg.nxaooc, ndxr).sum((1, 3))
        return (ocean_forcing, *atmos_tail(
            pam, astm, hmixam, tauxa, tauya, uekat, vekat, wekpa, txisat,
            txinat, blocks, (slhf.sum(), ocnrad.sum(), atmrad_oc.sum())))

    if mesh is None:
        return xforc

    def owned(t, cols):
        """The rank's fine columns [g0, g1) of a block of the refined
        columns [h0, h1), in zeros as wide as `cols`, the fine grid's p
        (nxpaor) or T (nxpaor - 1) width: every other rank adds zeros
        there, so the sums of the ranks' shares are those of the
        whole."""
        if not rows.two_d:
            return t
        hi = min(g1, cols)
        return F.pad(t[:, g0 - h0:hi - h0], (g0, cols - hi))

    def xforc_rows(pam, pom, sstm, astm, hmixam):
        # the coarse atmosphere whole on every rank from its row blocks:
        # the two bottom layers of pam (all that xforc reads of it), astm
        # and hmixam (padded to the p-grid's width), in one gather
        wide = (F.pad(f, (0, 1))[None] for f in (astm, hmixam))
        coarse = gather(torch.cat([pam[:2], *wide]), amesh, site=XFORC_GATHER)
        pam, astm, hmixam = (coarse[:2], coarse[2, :nyta, :nxta],
                             coarse[3, :nyta, :nxta])
        # the fine rows [e0, e1) and columns [h0, h1): the rank's own and
        # one more each side
        u1ator, v1ator = bicubic_refine_uv(coup, *coarse_velocity(pam),
                                           ndxr, e0, e1, h0, h1)
        if cfg.tau_udiff and pom is not None:
            # the velocity on ocean rows r0-1 .. r0+n (and columns c0-1 ..
            # c0+m), of which the footprint's points in the fine block
            # are subtracted
            ext = rows.with_ghosts(pom[0], 2, XFORC_ROWS, XFORC_COLS)
            gy = r0 - 1 + torch.arange(n + 2, device=dev)[:, None]
            if rows.two_d:
                u1oc, v1oc = ocean_velocity(ext, gy, c0 - 1 + torch.arange(
                    m + 2, device=dev)[None, :])
            else:           # every column, without the zero ghost columns
                u1oc, v1oc = ocean_velocity(ext[:, 2:-2], gy)
            a, b = max(e0 - joc0, 0), min(e1 - joc0, nypo)
            ca, cb = max(h0 - ioc0, 0), min(h1 - ioc0, nxpo)
            i, j = a - (r0 - 1), ca - (c0 - 1 if rows.two_d else 0)
            widths = (ioc0 + ca - h0, h1 - ioc0 - cb, joc0 + a - e0,
                      e1 - joc0 - b)
            u1ator = u1ator - F.pad(u1oc[i:i + b - a, j:j + cb - ca], widths)
            v1ator = v1ator - F.pad(v1oc[i:i + b - a, j:j + cb - ca], widths)
        tau_x, tau_y = quad_drag(u1ator, v1ator, cdrfac, qu2fac)
        # the rank's own columns, every other column zero
        tauxaor, tauyaor = owned(tau_x, cfg.nxpaor), owned(tau_y, cfg.nxpaor)

        # the shares of the fine rows [f0, f1) in the coarse outputs
        j0, j1 = -(-f0 // ndxr), -(-f1 // ndxr)    # p rows j*ndxr in them
        sampled = slice(j0 * ndxr - e0, f1 - e0, ndxr)
        coarse_rows = (0, 0, j0, nypa - j1)
        tauxa = F.pad(tauxaor[sampled, ::ndxr], coarse_rows)
        tauya = F.pad(tauyaor[sampled, ::ndxr], coarse_rows)
        vekat = uvekfc * F.pad(_edge_integrals(tauxaor[sampled], ndxr),
                               coarse_rows)
        # the T cells whose sides [c*ndxr, (c+1)*ndxr] meet the rows
        k0, k1 = max(0, -(-f0 // ndxr) - 1), min(nyta - 1, (f1 - 1) // ndxr)
        sides = F.pad(tauyaor[f0 - e0:f1 - e0, ::ndxr],
                      (0, 0, f0 - k0 * ndxr, (k1 + 1) * ndxr + 1 - f1))
        uekat = -uvekfc * F.pad(_edge_integrals(sides.T, ndxr).T,
                                (0, 0, k0, nyta - 1 - k1))
        # the fine T rows [f0, t1) between the rank's p rows, and its
        # fine T columns (each between the rank's p column and the next)
        t1 = min(f1, cfg.nypaor - 1) + 1 - e0
        wekpa = _box_sums(owned(wekt(tau_x[f0 - e0:t1], tau_y[f0 - e0:t1]),
                                cfg.nxpaor - 1),
                          ndxr, nypa, nxpa, t0=f0)
        zero = tauxa.new_zeros(())
        txisat = (stress_integral(tauxaor, jsou - e0, 1)
                  if f0 <= jsou < f1 else zero)
        txinat = (stress_integral(tauxaor, jnor - e0, -1)
                  if f0 <= jnor < f1 else zero)

        # the ocean's points: the stress on rows r0-1 .. r0+n (and on a 2-D
        # mesh columns c0-1 .. c0+m; zero off the grid), the heat flux on
        # the rank's T points
        lo, hi = max(r0 - 1, 0), min(r0 + n + 1, nypo)
        clo, chi = ((max(c0 - 1, 0), min(c0 + m + 1, nxpo)) if rows.two_d
                    else (0, nxpo))
        cpad = ((clo - c0 + 1, c0 + m + 1 - chi) if rows.two_d else (0, 0))

        def ocean_block(t):
            return F.pad(raoro * t[joc0 + lo - e0:joc0 + hi - e0,
                                   ioc0 + clo - h0:ioc0 + chi - h0],
                         cpad + (lo - r0 + 1, r0 + n + 1 - hi))

        wt = m if rows.two_d else cfg.nxto      # the T fields' width
        asto = F.pad(_bilint_ast(coup, astm, r0, r0 + nt, c0, c0 + ct),
                     (0, wt - ct, 0, n - nt))
        ocnrad = rad.D0up * sstm
        slhf = xlamda * (sstm - asto)
        atmrad_oc = rad.Dmdown * asto
        ocean_forcing = None
        if not cfg.atmos_only:
            fsp = F.pad(coup.fsp_oc[r0:r0 + nt], (0, n - nt))[:, None]
            fnetoc = torch.where(rows.t_true,
                                 -fsp - atmrad_oc - ocnrad - slhf, 0.0)
            ocean_forcing = ekman_forcing(model, ocean_block(tau_x),
                                          ocean_block(tau_y), fnetoc,
                                          rows=rows)
        # the T points' share of the atmosphere cells over the ocean
        contrib = ocnrad + (rad.Dmdown - rad.Dmup) * asto + slhf
        blocks = contrib.new_zeros(cfg.nyaooc, cfg.nxaooc)
        if nt and ct:
            k0, k1 = r0 // ndxr, (r0 + nt - 1) // ndxr
            q0, q1 = c0 // ndxr, (c0 + ct - 1) // ndxr
            cells = F.pad(contrib[:nt, :ct],
                          (c0 - q0 * ndxr, (q1 + 1) * ndxr - c0 - ct,
                           r0 - k0 * ndxr, (k1 + 1) * ndxr - r0 - nt))
            blocks = F.pad(cells.reshape(k1 - k0 + 1, ndxr, q1 - q0 + 1,
                                         ndxr).sum((1, 3)),
                           (q0, cfg.nxaooc - 1 - q1,
                            k0, cfg.nyaooc - 1 - k1))

        shares = [tauxa, tauya, vekat, uekat, wekpa, blocks,
                  torch.stack([txisat, txinat, slhf.sum(), ocnrad.sum(),
                               atmrad_oc.sum()])]
        tot = mesh.all_reduce(torch.cat([s.reshape(-1) for s in shares]),
                              XFORC_SUMS)
        (tauxa, tauya, vekat, uekat, wekpa, blocks, sums) = (
            t.reshape(s.shape) for t, s in zip(
                tot.split([s.numel() for s in shares]), shares))
        afor, diags = atmos_tail(
            pam, astm, hmixam, tauxa, tauya, uekat, vekat,
            wekpa / coup.wekpa_count, sums[0], sums[1], blocks, sums[2:])
        return ocean_forcing, shard_tree(afor, amesh), diags

    return xforc_rows
