"""Modified-Helmholtz solvers of the PV inversions (port of the 'fft'
transforms of qgcm_tpu/solver/helmholtz.py: BoxHelmholtz and
CyclicHelmholtz).

Solves del^2(p) - rdm2 * p = rhs (5-point FD Laplacian) with p = 0 on
the zonal walls, and on the meridional walls too in the box (periodic
in x in the channel), as one 2-D transform solve:

    p = T^-1 [ T(rhs) / (lam_x + lam_y - rdm2) ]

which is the same discrete solution as the reference's
transform-plus-tridiagonal method (src/ocisubs.F:415-618,
src/atisubs.F:301-400). T is a DST-I in both directions in the box, and
a real FFT in x with a DST-I in y in the channel. The DST-I is an odd
extension fed to torch.fft.rfft (cuFFT on the card), or in the channel's
y direction a GEMM with the sine matrix where qgcm_tpu picks its
'matmul' y-transform (resolve_ytransform). The box's GEMM DST and
qgcm_tpu's packed and block forms are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


# Interior rows from which a float32 channel takes its y-DST as a GEMM
# under solver_transform='auto' (qgcm_tpu/solver/helmholtz.py:48,64-74).
# With the float64 constraint algebra of models/ocean.py::_channel_pressure
# it keeps the port's float32 channel as near its float64 run as
# qgcm_tpu's; with the FFT form the forced southern-ocean channel drifted
# farther from float64 in ten days (PERF.md, section 6).
MATMUL_DST_MIN = 512


def resolve_ytransform(cfg, nyp: int) -> str:
    """The y-DST of a channel of nyp p-rows: 'matmul' (a GEMM with the
    sine matrix) for float32 under solver_transform='auto' when it has
    at least MATMUL_DST_MIN interior rows, as qgcm_tpu resolves it;
    otherwise 'fft'."""
    if (cfg.solver_transform == "auto" and cfg.dtype == "float32"
            and nyp - 2 >= MATMUL_DST_MIN):
        return "matmul"
    return "fft"


def sine_matrix(n: int) -> np.ndarray:
    """The DST-I of length n as a symmetric float64 matrix in dst1's
    convention: K[k-1, j-1] = 2 sin(pi j k / (n+1)), so K @ x equals
    dst1(x) along the first axis. j*k is reduced modulo 2(n+1) before
    the sine so that the argument stays exact."""
    j = np.arange(1, n + 1)
    jk = np.outer(j, j) % (2 * (n + 1))
    return 2.0 * np.sin(np.pi * jk / (n + 1))


def dst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalised type-I discrete sine transform along `dim`.

    X_k = 2 * sum_{j=1..N} x_j sin(pi j k / (N+1)),  k = 1..N
    (FFTPACK `dsint` convention, so dst1(dst1(x)) == 2*(N+1)*x), from the
    real FFT of the odd extension [0, x, 0, -reverse(x)].
    """
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    zero = x.new_zeros(x.shape[:-1] + (1,))
    z = torch.cat([zero, x, zero, -x.flip(-1)], dim=-1)
    X = -torch.fft.rfft(z, dim=-1).imag[..., 1:n + 1]
    return X.movedim(-1, dim)


def dst1_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """NumPy float64 twin of `dst1` for host-side (init-time) solves."""
    x = np.moveaxis(np.asarray(x, dtype=np.float64), axis, -1)
    n = x.shape[-1]
    z = np.zeros(x.shape[:-1] + (2 * (n + 1),), dtype=np.float64)
    z[..., 1:n + 1] = x
    z[..., n + 2:] = -x[..., ::-1]
    X = -np.fft.rfft(z, axis=-1).imag[..., 1:n + 1]
    return np.moveaxis(X, -1, axis)


@dataclass(frozen=True)
class BoxHelmholtz:
    """Solver for the finite box (Dirichlet on all boundaries).

    Grid: p-array of shape (nyp, nxp); the unknowns are the
    (nyp-2) x (nxp-2) interior points. The O(N) vectors are tensors on
    the solver's device in the model dtype; the spectral denominators
    are formed from them on the fly.
    """

    nxp: int
    nyp: int
    lamx: torch.Tensor       # (nxp-2,) x-eigenvalues
    lamy: torch.Tensor       # (nyp-2,)
    rdm2: torch.Tensor       # (nm,)
    gx: torch.Tensor         # (nxp-2,) DST of the ones vector
    gy: torch.Tensor         # (nyp-2,)
    norm: float              # combined inverse-transform normalisation

    def _denom(self) -> torch.Tensor:
        return (self.lamx[None, None, :] + self.lamy[None, :, None]
                - self.rdm2[:, None, None])

    def forward(self, rhs: torch.Tensor) -> torch.Tensor:
        """Interior 2-D DST of a p-grid field."""
        return dst1(dst1(rhs[..., 1:-1, 1:-1], dim=-1), dim=-2)

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """Inverse 2-D DST, scaled by norm, with zero boundaries."""
        sol = dst1(dst1(spec, dim=-1), dim=-2) * self.norm
        return torch.nn.functional.pad(sol, (1, 1, 1, 1))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs: (nm, nyp, nxp); returns the solution with zero walls."""
        return self.inverse(self.forward(rhs) / self._denom())

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only) of a
        float64 solver on the CPU."""
        if self.lamx.dtype != torch.float64 or self.lamx.device.type != "cpu":
            raise ValueError("solve_np needs a float64 solver on the cpu")
        rhs = np.asarray(rhs, dtype=np.float64)
        spec = dst1_np(dst1_np(rhs[..., 1:-1, 1:-1], axis=-1), axis=-2)
        spec = spec * (1.0 / self._denom().numpy())
        sol = dst1_np(dst1_np(spec, axis=-1), axis=-2) * self.norm
        return np.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (1, 1)])


def make_box_helmholtz(nxp: int, nyp: int, dx: float, dy: float,
                       rdm2: np.ndarray, dtype=torch.float64,
                       device="cuda") -> BoxHelmholtz:
    """rdm2: (nm,) vector of 1/Rd^2 values (0 for barotropic). The
    vectors are computed in float64 NumPy and moved to `device` ('cuda',
    the default, or 'cpu') once."""
    device = resolve_device(device)
    nx, ny = nxp - 1, nyp - 1
    k = np.arange(1, nx)                       # x wavenumbers (DST-I)
    l = np.arange(1, ny)                       # y wavenumbers (DST-I)
    lamx = 2.0 / dx**2 * (np.cos(np.pi * k / nx) - 1.0)
    lamy = 2.0 / dy**2 * (np.cos(np.pi * l / ny) - 1.0)
    norm = 1.0 / (2.0 * nx) / (2.0 * ny)
    # DST-I of the ones vector: g[k] = 2 sum_j sin(pi j k/(N+1))
    gx = dst1_np(np.ones((1, nx - 1)))[0]
    gy = dst1_np(np.ones((1, ny - 1)))[0]

    def dev(a):
        return _vector(a, device, dtype)

    return BoxHelmholtz(nxp=nxp, nyp=nyp, lamx=dev(lamx), lamy=dev(lamy),
                        rdm2=dev(rdm2), gx=dev(gx), gy=dev(gy), norm=norm)


def _vector(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
        device=device, dtype=dtype)


@dataclass(frozen=True)
class CyclicHelmholtz:
    """Solver for the zonally periodic channel (Dirichlet N/S).

    Grid: p-array of shape (nyp, nxp) whose column nxp-1 duplicates
    column 0. The transform works on the nx = nxp-1 distinct columns;
    the solution repeats column 0 at the east edge, bit for bit. The
    y-DST is dst1's FFT form, or a GEMM with `ysine` where it is set.
    """

    nxp: int
    nyp: int
    lamx: torch.Tensor       # (nx//2+1,) rfft eigenvalues
    lamy: torch.Tensor       # (nyp-2,)
    rdm2: torch.Tensor       # (nm,)
    norm: float              # the DST's; rfft/irfft normalise themselves
    ysine: torch.Tensor = None   # (nyp-2, nyp-2) sine_matrix, or None

    def _denom(self) -> torch.Tensor:
        return (self.lamx[None, None, :] + self.lamy[None, :, None]
                - self.rdm2[:, None, None])

    def _ydst(self, f: torch.Tensor) -> torch.Tensor:
        if self.ysine is None:
            return dst1(f, dim=-2)
        return torch.matmul(self.ysine, f)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs: (nm, nyp, nxp); returns the solution with zero zonal
        walls. The y-DST runs on the real field, before the forward and
        after the inverse x-transform (the two commute): two real sine
        transforms instead of four on the real and imaginary parts."""
        nx = self.nxp - 1
        sy = self._ydst(rhs[..., 1:-1, :nx])
        spec = torch.fft.rfft(sy, dim=-1) / self._denom()
        sy = torch.fft.irfft(spec, n=nx, dim=-1)
        sol = self._ydst(sy) * self.norm
        sol = torch.cat([sol, sol[..., :1]], dim=-1)
        return torch.nn.functional.pad(sol, (0, 0, 1, 1))

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only) of a
        float64 solver on the CPU."""
        if self.lamx.dtype != torch.float64 or self.lamx.device.type != "cpu":
            raise ValueError("solve_np needs a float64 solver on the cpu")
        rhs = np.asarray(rhs, dtype=np.float64)
        nx = self.nxp - 1
        spec = np.fft.rfft(rhs[..., 1:-1, :nx], axis=-1)
        spec = dst1_np(spec.real, axis=-2) + 1j * dst1_np(spec.imag, axis=-2)
        spec = spec * (1.0 / self._denom().numpy())
        spec = dst1_np(spec.real, axis=-2) + 1j * dst1_np(spec.imag, axis=-2)
        sol = np.fft.irfft(spec, n=nx, axis=-1) * self.norm
        sol = np.concatenate([sol, sol[..., :1]], axis=-1)
        return np.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (0, 0)])


def make_cyclic_helmholtz(nxp: int, nyp: int, dx: float, dy: float,
                          rdm2: np.ndarray, dtype=torch.float64,
                          device="cuda",
                          ytransform: str = "fft") -> CyclicHelmholtz:
    """Channel solver; the vectors (and with ytransform='matmul' the
    sine matrix of the y-DST) are computed in float64 NumPy and moved to
    `device` ('cuda', the default, or 'cpu') once."""
    if ytransform not in ("fft", "matmul"):
        raise ValueError(f"unknown ytransform {ytransform!r}")
    device = resolve_device(device)
    nx, ny = nxp - 1, nyp - 1
    k = np.arange(nx // 2 + 1)                 # rfft wavenumbers
    l = np.arange(1, ny)
    lamx = 2.0 / dx**2 * (np.cos(2.0 * np.pi * k / nx) - 1.0)
    lamy = 2.0 / dy**2 * (np.cos(np.pi * l / ny) - 1.0)
    ysine = (_vector(sine_matrix(ny - 1), device, dtype)
             if ytransform == "matmul" else None)
    return CyclicHelmholtz(nxp=nxp, nyp=nyp,
                           lamx=_vector(lamx, device, dtype),
                           lamy=_vector(lamy, device, dtype),
                           rdm2=_vector(rdm2, device, dtype),
                           norm=1.0 / (2.0 * ny), ysine=ysine)
