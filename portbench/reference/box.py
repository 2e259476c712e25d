"""Plain PyTorch reference of the box ocean's substep: the mixed layer,
the vorticity leapfrog, the PV inversion under the mass constraint, the
boundary PV and the two-level averaging of Q-GCM v1.5.0's ocean-only
box (src/omlsubs.F, src/qgosubs.F, src/ocisubs.F, src/vorsubs.F,
src/q-gcm.F:1222-1366).

It imports nothing of the program under test. Everything the program's
set-up derives is worked out again here from the configuration's numbers
(`model` in a configuration file of portbench/configs): the grid, the
vertical modes, the ocean's layer temperatures from the radiative
balance, the Helmholtz eigenvalues, the homogeneous solution of the
mass constraint, the forcing's Ekman velocities, and PV from pressure.

States carry a leading member axis: 3-D fields are (M, nl, ny, nx),
T-grid fields (M, nyt, nxt), constraint values (M, nl-1). The forcing is
one (ny, nx) set that all members share. The DST-I is the real FFT of
the odd extension, the form the program's FFT DST also takes; the
modal solve is done in grid space (inhomogeneous solution plus a
multiple of the homogeneous one) rather than spectrally.

`tf32=True` rounds both operands of every layer/mode product to TF32
(10 mantissa bits), as a float32 matmul with TF32 allowed computes it:
the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

AVG_PERIOD = 25          # substeps between time-level averagings

# radiative balance (src/radsubs.f)
_STEFAN = 5.67040e-8
_SIGOV2 = 0.5 * _STEFAN
_NZ = 10001
_NITMAX = 200
_TMBTOL = 1.0e-13

FIELDS = ("po", "pom", "qo", "qom", "sst", "sstm", "dpioc", "dpiocp")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (float32 with 10 mantissa bits,
    ties away from zero), in x's float32 type."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _trapz(f: np.ndarray, delz: float) -> float:
    return float(delz * (0.5 * f[0] + f[1:-1].sum() + 0.5 * f[-1]))


def ocean_layer_temperatures(m: dict) -> np.ndarray:
    """The ocean layers' temperature anomalies toc (K): tabsoc less the
    ocean mixed layer's mean temperature of the radiative balance
    (src/radsubs.f:91-204)."""
    at, rad, mix = m["atmos"], m["radiation"], m["mixed"]
    hat = np.asarray(at["hat"], dtype=np.float64)
    tabsat = np.asarray(at["tabsat"], dtype=np.float64)
    zopt = np.asarray(rad["zopt"], dtype=np.float64)
    zm, gamma, fsbar = rad["zm"], rad["gamma"], rad["fsbar"]
    hmat, xlamda = mix["hmat"], mix["xlamda"]
    nla = len(hat)
    tauk = np.empty(nla)
    tauk[0] = math.exp(-(hat[0] - hmat) / zopt[0])
    tauk[1:] = np.exp(-hat[1:] / zopt[1:])
    hbot, htop = hmat, hat[0]
    rhstat = 0.0
    for k in range(nla):
        if k > 0:
            hbot, htop = htop, htop + hat[k]
        delz = (htop - hbot) / (_NZ - 1)
        zz = hbot + delz * np.arange(_NZ)
        fup = (tabsat[k] - gamma * zz) ** 4 * np.exp(-(htop - zz) / zopt[k])
        uprad = _SIGOV2 * _trapz(fup, delz) / zopt[k]
        rhstat = rhstat * tauk[k] + uprad if k > 0 else uprad
    rhstat = 2.0 * zm * ((-rhstat - fsbar) / tauk.prod()) / _STEFAN
    tmbara = 300.0
    delz = hmat / (_NZ - 1)
    zz = delz * np.arange(_NZ)
    emz = np.exp(-(hmat - zz) / zm)
    for _ in range(_NITMAX + 1):
        upint = _trapz((tmbara - gamma * zz) ** 4 * emz, delz)
        deltm = 0.25 * (rhstat - upint) * tmbara / upint
        tmbara += 0.75 * deltm
        if abs(deltm) <= _TMBTOL:
            break
    else:
        raise RuntimeError("atmospheric mixed layer balance did not converge")
    rhstoc = xlamda * tmbara + _SIGOV2 * tmbara**4 - fsbar
    tmbaro = tmbara
    for _ in range(_NITMAX + 1):
        old = tmbaro
        tmbaro = rhstoc / (xlamda + _STEFAN * old**3)
        if abs(tmbaro - old) <= _TMBTOL:
            break
    else:
        raise RuntimeError("oceanic mixed layer balance did not converge")
    return np.asarray(m["ocean"]["tabsoc"], dtype=np.float64) - tmbaro


def vertical_modes(gp, h, fnot):
    """(amat, cl2m, cm2l, rdm2) of the layer model (src/eigmode.f): the
    A matrix, its eigenvectors ordered by |eigenvalue| (barotropic first)
    with the Flierl normalisation and a positive surface value, their
    inverse, and 1/Rd^2 (0 for the barotropic mode)."""
    nl = len(h)
    a = np.zeros((nl, nl))
    a[0, 1] = -1.0 / (gp[0] * h[0])
    a[0, 0] = -a[0, 1]
    for k in range(1, nl - 1):
        a[k, k - 1] = -1.0 / (gp[k - 1] * h[k])
        a[k, k + 1] = -1.0 / (gp[k] * h[k])
        a[k, k] = -a[k, k - 1] - a[k, k + 1]
    a[nl - 1, nl - 2] = -1.0 / (gp[nl - 2] * h[nl - 1])
    a[nl - 1, nl - 1] = -a[nl - 1, nl - 2]
    vals, vecs = np.linalg.eig(a)
    vals, vecs = vals.real, vecs.real
    order = np.argsort(np.abs(vals))
    vals, vecs = np.abs(vals[order]), vecs[:, order]
    hv = np.asarray(h, dtype=np.float64)
    for j in range(nl):
        vecs[:, j] *= (math.sqrt(hv.sum() / np.sum(hv * vecs[:, j] ** 2))
                       * np.sign(vecs[0, j]))
    vals[0] = 0.0
    return a, np.linalg.inv(vecs), vecs, fnot * fnot * vals


def dst1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unnormalised DST-I along dim: X_k = 2 sum_j x_j sin(pi j k/(N+1))."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    zero = x.new_zeros(x.shape[:-1] + (1,))
    z = torch.cat([zero, x, zero, -x.flip(-1)], dim=-1)
    return (-torch.fft.rfft(z, dim=-1).imag[..., 1:n + 1]).movedim(-1, dim)


def xintp(f: torch.Tensor) -> torch.Tensor:
    """Trapezoidal sum over the last two axes (1/2 edges, 1/4 corners)."""
    w = torch.ones(f.shape[-2:], dtype=f.dtype, device=f.device)
    w[0] *= 0.5
    w[-1] *= 0.5
    w[:, 0] *= 0.5
    w[:, -1] *= 0.5
    return (f * w).sum((-2, -1))


def _pad1(f: torch.Tensor) -> torch.Tensor:
    """One zero ring around the last two axes."""
    return torch.nn.functional.pad(f, (1, 1, 1, 1))


def _edge_pad(f: torch.Tensor) -> torch.Tensor:
    """One ring of copies of the edge values (the no-flux T-grid ghosts)."""
    f = torch.cat([f[..., :, :1], f, f[..., :, -1:]], dim=-1)
    return torch.cat([f[..., :1, :], f, f[..., -1:, :]], dim=-2)


def _lap5(fp: torch.Tensor) -> torch.Tensor:
    """Unscaled 5-point sum of a ring-padded field."""
    return (fp[..., :-2, 1:-1] + fp[..., 2:, 1:-1] + fp[..., 1:-1, :-2]
            + fp[..., 1:-1, 2:] - 4.0 * fp[..., 1:-1, 1:-1])


def _t_to_p(f: torch.Tensor) -> torch.Tensor:
    """A T-grid field averaged onto the p points (4 cells, edge copies
    outside): the area integral is kept."""
    fp = _edge_pad(f)
    return 0.25 * (fp[..., :-1, :-1] + fp[..., :-1, 1:] + fp[..., 1:, :-1]
                   + fp[..., 1:, 1:])


class BoxOcean:
    """The ocean-only box of a configuration's `model` numbers, on
    `device` in `dtype` (float64 for the reference)."""

    def __init__(self, m: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        oc = m["ocean"]
        for flag in ("cyclic_ocean", "sb_hflux", "nb_hflux", "no_oml",
                     "tau_udiff", "atmos_only"):
            if m[flag]:
                raise ValueError(f"the reference has no {flag} path")
        if not m["ocean_only"] or m["sponge"]["enabled"]:
            raise ValueError("the reference is the ocean-only box")
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 rounds float32 products")
        self.device, self.dtype, self.tf32 = torch.device(device), dtype, tf32
        self.nl = oc["nlo"]
        self.dx = self.dy = float(oc["dxo"])
        self.fnot, self.beta = float(m["fnot"]), float(m["beta"])
        self.dto = m["nstr"] * m["dta"]
        self.nxt, self.nyt = m["ndxr"] * m["nxaooc"], m["ndxr"] * m["nyaooc"]
        self.nxp, self.nyp = self.nxt + 1, self.nyt + 1
        dya = m["ndxr"] * self.dx
        ny1 = 1 + (m["nyta"] - m["nyaooc"]) // 2
        ypo = (ny1 - 1) * dya + np.arange(self.nyp) * self.dy
        yporel = ypo - 0.5 * m["nyta"] * dya

        def vec(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
                self.device, dtype)

        self.hoc = np.asarray(oc["hoc"], dtype=np.float64)
        self.gpoc = vec(oc["gpoc"])
        self.ah2 = vec(oc["ah2oc"])[:, None, None]
        self.ah4 = vec(oc["ah4oc"])[:, None, None]
        self.betay = vec(self.beta * yporel)[:, None]          # (ny, 1)
        amat, cl2m, cm2l, rdm2 = vertical_modes(oc["gpoc"], oc["hoc"],
                                                self.fnot)
        self.amat, self.cl2m, self.cm2l = vec(amat), vec(cl2m), vec(cm2l)
        self.rdm2 = vec(rdm2)

        # constants of the vorticity step and the boundary PV
        self.dxm2 = 1.0 / self.dx**2
        bcco = oc["bccooc"]
        self.bcfac = bcco * self.dxm2 / (0.5 * bcco + 1.0)
        self.adfac = 1.0 / (12.0 * self.dx * self.dy * self.fnot)
        self.bdrfac = (0.5 * math.copysign(1.0, self.fnot) * oc["delek"]
                       / self.hoc[-1])

        # the mixed layer (src/omlsubs.F)
        mix = m["mixed"]
        toc = ocean_layer_temperatures(m)
        self.toc0, self.toc1 = float(toc[0]), float(toc[1])
        self.hmoc = mix["hmoc"]
        self.st2d, self.st4d = mix["st2d"], mix["st4d"]
        self.ycexp = m["ycexp"]
        self.rrcpoc = 1.0 / (m["rhooc"] * m["cpoc"])
        self.ocnorm = 1.0 / (self.nxt * self.nyt)

        # the Helmholtz solve of each mode, del2 p - rdm2 p = rhs with
        # p = 0 on the walls, by the DST-I in both directions
        nx, ny = self.nxp - 1, self.nyp - 1
        lamx = 2.0 / self.dx**2 * (np.cos(np.pi * np.arange(1, nx) / nx) - 1)
        lamy = 2.0 / self.dy**2 * (np.cos(np.pi * np.arange(1, ny) / ny) - 1)
        self.lam = vec(lamy[:, None] + lamx[None, :])
        self.norm = 1.0 / (2.0 * nx) / (2.0 * ny)

        # the mass constraint's homogeneous solutions 1 + rdm2 * sol0 of
        # the baroclinic modes, Helm(sol0) = 1, and their area integrals
        ones = torch.ones((self.nl - 1, self.nyp, self.nxp),
                          dtype=dtype, device=self.device)
        sol0 = self.helmholtz(ones, self.rdm2[1:])
        self.ochom = 1.0 + self.rdm2[1:, None, None] * sol0
        aipohs = (xintp(self.ochom) * self.dx * self.dy).double().cpu()
        c = torch.as_tensor(cm2l)
        cdhoc = (c[1:, 1:] - c[:-1, 1:]) * aipohs[None, :]
        self.cdiff = vec(c[1:, :] - c[:-1, :])                 # (nl-1, nl)
        self.cdhinv = vec(np.linalg.inv(cdhoc.numpy()))

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------

    def mix(self, mat: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """sum_l mat[k, l] f[..., l, y, x]: a layer/mode product."""
        if self.tf32:
            mat, f = tf32_round(mat), tf32_round(f)
        return torch.einsum("kl,...lyx->...kyx", mat, f)

    def helmholtz(self, rhs: torch.Tensor, rdm2: torch.Tensor):
        """The solution with zero walls of del2 p - rdm2 p = rhs, one
        mode a leading index of rhs (..., nm, ny, nx)."""
        spec = dst1(dst1(rhs[..., 1:-1, 1:-1], -1), -2)
        spec = spec / (self.lam - rdm2[:, None, None])
        return _pad1(dst1(dst1(spec, -1), -2) * self.norm)

    def del2_bc(self, p: torch.Tensor) -> torch.Tensor:
        """Laplacian with the mixed condition on the four walls, the
        zonal rows winning the corners (src/qgosubs.F:94-127)."""
        pp = _pad1(p)
        pn, ps = pp[..., 2:, 1:-1], pp[..., :-2, 1:-1]
        pe, pw = pp[..., 1:-1, 2:], pp[..., 1:-1, :-2]
        out = self.dxm2 * (pn + ps + pe + pw - 4.0 * p)
        out[..., :, 0] = (self.bcfac * (pe - p))[..., :, 0]
        out[..., :, -1] = (self.bcfac * (pw - p))[..., :, -1]
        out[..., 0, :] = (self.bcfac * (pn - p))[..., 0, :]
        out[..., -1, :] = (self.bcfac * (ps - p))[..., -1, :]
        return out

    @staticmethod
    def jacobian(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """Arakawa's 9-point J(q, p) times 12 dx dy at interior points,
        zero on the walls (src/qgosubs.F:374-389)."""
        def nb(f):
            fp = _pad1(f)
            return (fp[..., 1:-1, 2:], fp[..., 1:-1, :-2], fp[..., 2:, 1:-1],
                    fp[..., :-2, 1:-1], fp[..., 2:, 2:], fp[..., 2:, :-2],
                    fp[..., :-2, 2:], fp[..., :-2, :-2])
        qe, qw, qn, qs, qne, qnw, qse, qsw = nb(q)
        pe, pw, pn, ps, pne, pnw, pse, psw = nb(p)
        jac = ((qe - qw) * (pn - ps) + (qs - qn) * (pe - pw)
               + qe * (pne - pse) - qw * (pnw - psw)
               - qn * (pne - pnw) + qs * (pse - psw)
               + pn * (qne - qnw) - ps * (qse - qsw)
               - pe * (qne - qse) + pw * (qnw - qsw))
        return _interior(jac)

    def qcomp(self, p: torch.Tensor) -> torch.Tensor:
        """PV at interior points (7.15), zero on the walls."""
        lap = self.dxm2 * _lap5(_pad1(p))
        q = lap / self.fnot + self.betay - self.fnot * self.mix(self.amat, p)
        return _interior(q)

    def ocqbdy(self, q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """PV on the walls by the mixed condition (src/vorsubs.F:245-388):
        columns first, so that the zonal rows win the corners."""
        q = q.clone()
        f = self.bcfac / self.fnot
        base = self.betay - self.fnot * self.mix(self.amat, p)
        q[..., :, 0] = f * (p[..., :, 1] - p[..., :, 0]) + base[..., :, 0]
        q[..., :, -1] = f * (p[..., :, -2] - p[..., :, -1]) + base[..., :, -1]
        q[..., 0, :] = f * (p[..., 1, :] - p[..., 0, :]) + base[..., 0, :]
        q[..., -1, :] = f * (p[..., -2, :] - p[..., -1, :]) + base[..., -1, :]
        return q

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def forcing(self, tauxo, tauyo, fnetoc) -> dict:
        """Wind stress (p grid) and heat flux (T grid) with the Ekman
        velocities at T and p points (src/xfosubs.F:568-646)."""
        tauxo, tauyo, fnetoc = (self.cast(a) for a in (tauxo, tauyo, fnetoc))
        wekto = (0.5 / (self.dx * self.fnot)) * (
            tauyo[:-1, 1:] + tauyo[1:, 1:] - tauyo[:-1, :-1] - tauyo[1:, :-1]
            + tauxo[:-1, :-1] + tauxo[:-1, 1:] - tauxo[1:, :-1]
            - tauxo[1:, 1:])
        return dict(tauxo=tauxo, tauyo=tauyo, fnetoc=fnetoc, wekto=wekto,
                    wekpo=_t_to_p(wekto))

    def cast(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, self.dtype)

    def initial_state(self, po, sst=None) -> dict:
        """Members (M, nl, ny, nx) at rest in time (pom = po), SST zero
        unless given; PV and the mass constraint from the pressure
        (q-gcm.F:715-750, src/conhoms.F)."""
        po = self.cast(po)
        sst = (torch.zeros(po.shape[:-3] + (self.nyt, self.nxt),
                           dtype=self.dtype, device=self.device)
               if sst is None else self.cast(sst))
        qo = self.ocqbdy(self.qcomp(po), po)
        dpi = xintp(po[..., 1:, :, :] - po[..., :-1, :, :]) * self.dx * self.dy
        return dict(po=po, pom=po, qo=qo, qom=qo, sst=sst, sstm=sst,
                    dpioc=dpi, dpiocp=dpi)

    # ------------------------------------------------------------------
    # the substep
    # ------------------------------------------------------------------

    def mixed_layer(self, s: dict, f: dict):
        """SST leapfrog with the convection clamp and the entrainment
        onto the p grid (src/omlsubs.F:47-763). Returns (sst_new, entoc,
        xon1)."""
        sst, sstm, po1 = s["sst"], s["sstm"], s["po"][..., 0, :, :]
        tauxo, tauyo = f["tauxo"], f["tauyo"]
        uvg = self.ycexp / (self.dx * self.fnot)
        rhf = 0.5 / (self.fnot * self.hmoc)
        uface = (-uvg * (po1[..., 1:, :] - po1[..., :-1, :])
                 + rhf * (tauyo[1:, :] + tauyo[:-1, :]))
        zc = torch.zeros_like(sst[..., :, :1])
        xflux = uface * torch.cat([zc, sst[..., :, :-1] + sst[..., :, 1:], zc],
                                  dim=-1)
        vface = (uvg * (po1[..., :, 1:] - po1[..., :, :-1])
                 - rhf * (tauxo[:, 1:] + tauxo[:, :-1]))
        zr = torch.zeros_like(sst[..., :1, :])
        yflux = vface * torch.cat([zr, sst[..., :-1, :] + sst[..., 1:, :], zr],
                                  dim=-2)
        adv = (0.5 / self.dx) * (xflux[..., :, 1:] - xflux[..., :, :-1]
                                 + yflux[..., 1:, :] - yflux[..., :-1, :])
        del2t = _lap5(_edge_pad(sstm))
        del4t = _lap5(_edge_pad(del2t))
        rhs = (-adv + self.st2d / self.dx**2 * del2t
               - self.st4d / self.dx**4 * del4t)
        tdto = 2.0 * self.dto
        diabat = 0.5 * f["wekto"] * (sstm + self.toc0)
        new = sstm + tdto * (rhs + (self.rrcpoc * f["fnetoc"] + diabat)
                             / self.hmoc)
        conv = torch.clamp(self.toc0 - new, min=0.0)
        new = new + conv
        dtoinv = 1.0 / (self.toc0 - self.toc1)
        xfo = (-(0.5 * dtoinv) * f["wekto"] * (sstm - self.toc0)
               - self.hmoc * dtoinv / tdto * conv)
        xfo = xfo - xfo.sum((-2, -1), keepdim=True) * self.ocnorm
        entoc = _t_to_p(xfo)
        return new, entoc, xintp(entoc) * self.dx * self.dy

    def vorticity(self, s: dict, f: dict, entoc) -> torch.Tensor:
        """The PV leapfrog (7.14): advection by Arakawa's Jacobian,
        del4 and del6 friction of the lagged pressure, Ekman pumping,
        entrainment and bottom drag; the walls keep the old PV."""
        pom, po, qo, qom = s["pom"], s["po"], s["qo"], s["qom"]
        d2 = self.del2_bc(pom)
        d4 = self.del2_bc(d2)
        d6 = _interior(self.dxm2 * _lap5(_pad1(d4)))
        dq = (self.adfac * self.jacobian(qo, po)
              + (self.ah2 / self.fnot) * d4 - (self.ah4 / self.fnot) * d6)
        dq = _interior(dq)
        dq[..., 0, :, :] += (self.fnot / self.hoc[0]) * (f["wekpo"] - entoc)
        dq[..., 1, :, :] += (self.fnot / self.hoc[1]) * entoc
        dq[..., -1, :, :] -= self.bdrfac * d2[..., -1, :, :]
        new = qom + 2.0 * self.dto * dq
        new[..., 0, :] = qo[..., 0, :]
        new[..., -1, :] = qo[..., -1, :]
        new[..., :, 0] = qo[..., :, 0]
        new[..., :, -1] = qo[..., :, -1]
        return new

    def invert(self, q: torch.Tensor, s: dict, xon1):
        """Pressure from PV under the mass constraint (src/ocisubs.F:
        328-401). Returns (po_new, dpioc_new)."""
        wrk = self.fnot * self.mix(self.cl2m, q - self.betay)
        sol = self.helmholtz(wrk, self.rdm2)
        xinhom = xintp(sol) * self.dx * self.dy                 # (..., nl)
        tdto = 2.0 * self.dto
        jump = torch.zeros_like(s["dpiocp"])
        jump[..., 0] = xon1
        dpioc = s["dpiocp"] - tdto * self.gpoc * jump
        rhsum = torch.einsum("km,...m->...k", self.cdiff, xinhom)
        hclco = torch.einsum("kj,...j->...k", self.cdhinv, dpioc - rhsum)
        bc = sol[..., 1:, :, :] + hclco[..., None, None] * self.ochom
        pm = torch.cat([sol[..., :1, :, :], bc], dim=-3)
        return self.mix(self.cm2l, pm), dpioc

    def step(self, s: dict, f: dict, n: int) -> dict:
        """Substep n (0-based) of the run: mixed layer, PV leapfrog,
        inversion, boundary PV, then the averaging of the two time levels
        when n is a multiple of AVG_PERIOD."""
        sst, entoc, xon1 = self.mixed_layer(s, f)
        q = self.vorticity(s, f, entoc)
        po, dpioc = self.invert(q, s, xon1)
        out = dict(po=po, pom=s["po"], qo=self.ocqbdy(q, po), qom=s["qo"],
                   sst=sst, sstm=s["sst"], dpioc=dpioc, dpiocp=s["dpioc"])
        if n % AVG_PERIOD == 0:
            for k in ("po", "qo", "sst", "dpioc"):
                out[k] = 0.5 * (out[k] + out[k + ("p" if k == "dpioc"
                                                  else "m")])
        return out

    def run(self, s: dict, f: dict, n_steps: int, step0: int = 0) -> dict:
        for n in range(step0, step0 + n_steps):
            s = self.step(s, f, n)
        return s


def _interior(f: torch.Tensor) -> torch.Tensor:
    """f with its wall rows and columns set to zero."""
    out = torch.zeros_like(f)
    out[..., 1:-1, 1:-1] = f[..., 1:-1, 1:-1]
    return out


# the name portbench/cell.py looks for in a reference module
Reference = BoxOcean
