"""Modified-Helmholtz solvers of the PV inversions (port of
qgcm_tpu/solver/helmholtz.py: BoxHelmholtz and CyclicHelmholtz, with both
of their transforms).

Solves del^2(p) - rdm2 * p = rhs (5-point FD Laplacian) with p = 0 on
the zonal walls, and on the meridional walls too in the box (periodic
in x in the channel), as one 2-D transform solve:

    p = T^-1 [ T(rhs) / (lam_x + lam_y - rdm2) ]

which is the same discrete solution as the reference's
transform-plus-tridiagonal method (src/ocisubs.F:415-618,
src/atisubs.F:301-400). T is a DST-I in both directions in the box, and
a real FFT in x with a DST-I in y in the channel. The DST-I is either an
odd extension fed to torch.fft.rfft (cuFFT on the card; transform
'fft'), or qgcm_tpu's GEMM DST (transform 'matmul'): the radix-2
even/odd split into GEMMs with half-size kernels, whose spectrum stays
in the split's packed order (PackedDST; the solvers' eigenvalue and
Parseval vectors are permuted to match when they are built). In a
float32 run its products are float64 GEMMs rounded once to float32 at
solver_precision 'highest' (ops/gemm.py::plain; on the H100 a DGEMM runs
at the float32 SGEMM's rate, and a float32 GEMM's accumulation over
480-2400 terms left the solve 4-8 times the FFT DST's error,
chip_smoke.py phase 22), and the hand-written 3xTF32 kernel of
ops/gemm.py at 'high'; a float64 run's products are torch.matmul's at
either.
On the card the FFT DST's glue is hand-written (csrc/dst.cu, through
ops/dst.py): one kernel writes the odd extension that cuFFT's r2c reads,
straight from the caller's view, and another reads the spectrum's -imag
back. The box's 2-D transform turns the x-DST's spectrum into the
y-DST's extension in one pass, and its inverse writes the scaled
solution into the zero-walled p-grid. Every value is the torch chain's
bit for bit; CPU tensors take that chain.
qgcm_tpu's block (tree) interface of the packed form is not ported: it
computes the same values and exists to spare XLA misaligned
concatenations on the TPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import gemm
from ..ops.dst import dst, dst2


# Interior rows from which a float32 channel takes its y-DST as a GEMM
# under solver_transform='auto' (qgcm_tpu/solver/helmholtz.py:48,64-74).
# With the float64 constraint algebra of models/ocean.py::_channel_pressure
# it keeps the port's float32 channel as near its float64 run as
# qgcm_tpu's; with the FFT form the forced southern-ocean channel drifted
# farther from float64 in ten days (PERF.md, section 6).
MATMUL_DST_MIN = 512

# Half-size below which the GEMM DST stops its even/odd split and takes
# the dense sine matrix (qgcm_tpu/solver/helmholtz.py:99).
_MM_SPLIT_MIN = 240

TRANSFORMS = ("fft", "matmul")
PRECISIONS = ("highest", "high")


def resolve_transform(cfg, nxp: int, nyp: int) -> str:
    """The box's DST: cfg.solver_transform where it names one; under
    'auto' the FFT DST at every size and type. This departs from qgcm_tpu
    (qgcm_tpu/solver/helmholtz.py:51-61), whose 'auto' takes the GEMM DST
    for float32 boxes of 512 or more interior points a side, on the TPU's
    numbers: on the H100 the FFT DST is the faster solve at 961^2 and
    4801^2 (chip_smoke.py phase 22; PERF.md)."""
    if cfg.solver_transform != "auto":
        return cfg.solver_transform
    return "fft"


def resolve_ytransform(cfg, nyp: int) -> str:
    """The y-DST the port builds for a channel of nyp p-rows:
    cfg.solver_transform where it names one; under 'auto' a GEMM for
    float32 when the channel has at least MATMUL_DST_MIN interior rows,
    as qgcm_tpu resolves it (qgcm_tpu/solver/helmholtz.py:64-74),
    otherwise 'fft'. That GEMM is 'sine', one float32 GEMM with the dense
    sine matrix (the port's y-DST there since it was ported), at
    solver_precision 'highest', and qgcm_tpu's packed GEMM DST
    ('matmul') at 'high'.

    The 'sine' is a departure, kept on a measurement of the forced
    southern-ocean channel's first 10 days (chip_smoke.py
    --channel-spread, on an H100; PERF.md, section 6), each run's
    monit.nc distance from the float64 run over the record's maximum.
    Float64 runs from starts perturbed by noise of RMS 1e-7 of the
    flow's max|po| stay within 2.1e-4 of it in every series that decides
    phase 11's witness (kealoc 5.6e-8): the gap of a float32 run is
    accumulated roundoff, not a chaotic path. There the packed form ('matmul' at 'highest' or
    'high') and the FFT lie above the range of four float32 'sine' runs
    from perturbed starts in all 11 such series, by 1.2-111x their
    largest, and above the 'sine' run from rest in 8-10 of them
    (ugminoc: 7.84e-3, 1.48e-3 and 2.82e-3 against 9.67e-4-1.19e-3;
    kealoc 4.18e-4, 1.16e-3, 6.11e-4 against 8.0e-6-1.35e-4), and miss
    the witness in 8, 6 and 2 series where 'sine' from rest holds it.
    Over a whole year both 'sine' and the packed form meet the record's
    bars."""
    if cfg.solver_transform != "auto":
        return cfg.solver_transform
    if cfg.dtype == "float32" and nyp - 2 >= MATMUL_DST_MIN:
        return "sine" if cfg.solver_precision == "highest" else "matmul"
    return "fft"


def sine_matrix(n: int) -> np.ndarray:
    """The DST-I of length n as a symmetric float64 matrix in dst1's
    convention: K[k-1, j-1] = 2 sin(pi j k / (n+1)), so K @ x equals
    dst1(x) along the first axis. j*k is reduced modulo 2(n+1) before
    the sine so that the argument stays exact."""
    j = np.arange(1, n + 1)
    jk = np.outer(j, j) % (2 * (n + 1))
    return 2.0 * np.sin(np.pi * jk / (n + 1))


def _split_perm(n: int) -> np.ndarray:
    """Wavenumber permutation of the packed split order: packed[i] =
    natural[_split_perm(n)[i]] (qgcm_tpu/solver/helmholtz.py:198)."""
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return np.arange(n)
    return np.concatenate([2 * np.arange(m), 2 * _split_perm(m - 1) + 1])


def _split_sizes(n: int) -> list:
    """Packed-order spectral block lengths [m, ...recurse(m - 1)]: the
    half-sizes of the split levels, then the dense base's length
    (qgcm_tpu/solver/helmholtz.py:296)."""
    m = (n + 1) // 2
    if n % 2 == 0 or m < _MM_SPLIT_MIN:
        return [n]
    return [m] + _split_sizes(m - 1)


def _odd_kernel2(m: int) -> np.ndarray:
    """(m-1, m) float64 kernel K2[j, t] = 2 sin(pi (j+1) (2t+1) / 2m) of a
    split level (qgcm_tpu/solver/helmholtz.py:217): the odd wavenumbers
    2t+1 of the symmetric part, with the radix step's scales folded in.
    The integer (j+1)(2t+1) is reduced modulo the sine's period 4m first,
    so that the argument stays exact."""
    j = np.arange(1, m)
    t = np.arange(m)
    a = np.outer(j, 2 * t + 1) % (4 * m)
    return 2.0 * np.sin(np.pi * a / (2 * m))


def _mid_signs(m: int) -> np.ndarray:
    """2 (-1)^t, t = 0..m-1: the midpoint row of a level's kernel, applied
    elementwise (qgcm_tpu/solver/helmholtz.py:237)."""
    return 2.0 - 4.0 * (np.arange(m) % 2)


def _mm(x: torch.Tensor, K, dim: int) -> torch.Tensor:
    """Contract axis dim (-1 or -2) of x with the first axis of K (K may
    be a transposed view): x @ K or K.mT @ x, neither of which copies x.
    A float32 solver's K at 'high' is an ops.gemm.Constant and goes
    through ops.gemm.contract (the 3xTF32 kernel on the card, its plain
    version on the CPU); every other K is a tensor and takes
    ops.gemm.plain, torch.matmul in float64 rounded to x's type."""
    if isinstance(K, gemm.Constant):
        return gemm.contract(x, K, dim)
    return gemm.plain(x, K, dim)


class PackedDST:
    """The DST-I of length n as GEMMs, in the radix split's packed order
    (qgcm_tpu/solver/helmholtz.py:246-294, _dst1_mm_packed and
    _idst1_mm_packed): while n is odd and its half m = (n+1)/2 is at least
    _MM_SPLIT_MIN, the front half xf and the reversed back half xb give
    the odd wavenumbers as K2-products of xf + xb (plus the midpoint
    times _mid_signs) and the even ones as the packed DST of xf - xb, of
    length m - 1; the last length takes the dense sine matrix. `forward`
    returns the spectrum permuted by _split_perm; `inverse` is the DST of
    a packed spectrum, the exact transpose of `forward` (the DST-I is
    symmetric), so inverse(forward(x)) = 2 (n+1) x.

    Each level's kernel is made once, here, in float64 NumPy with its
    argument reduced modulo its period, and rounded to `dtype` on
    `device`; a float32 run at 'highest' keeps those float32 values in
    float64, the type of its products (_mm), and one at 'high' holds each
    as an ops.gemm.Constant, split here, once, into the 3xTF32 kernel's
    planes with those of its transpose (the inverse's K2.mT). qgcm_tpu
    instead makes its kernels from iota in the working type at every
    call (for XLA, :77-87), which in float32 puts up to about 5e-5 rad
    into the sines of its 239-point base kernel: in float32 the two
    differ by qgcm_tpu's own error, and the tests compare them in
    float64."""

    def __init__(self, n: int, dtype, device, precision: str = "highest"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown solver_precision {precision!r}")
        self.n, self.precision = n, precision
        wide = dtype == torch.float32 and precision == "highest"
        split = dtype == torch.float32 and precision == "high"

        def matrix(a):
            k = _vector(a, device, dtype)
            if split:
                return gemm.Constant(k)
            return k.double() if wide else k

        sizes = _split_sizes(n)
        self.levels = [(m, matrix(_odd_kernel2(m)),
                        _vector(_mid_signs(m), device, dtype))
                       for m in sizes[:-1]]
        self.base = matrix(sine_matrix(sizes[-1]))

    @staticmethod
    def _signs(s, dim):
        return s if dim == -1 else s[:, None]

    def forward(self, x: torch.Tensor, dim: int, level: int = 0):
        """Packed-order DST-I along dim (-1 or -2)."""
        if level == len(self.levels):
            return _mm(x, self.base, dim)
        m, K2, s = self.levels[level]
        xf = x.narrow(dim, 0, m - 1)
        xb = x.narrow(dim, m, m - 1).flip(dim)
        odd = (_mm(xf + xb, K2, dim)
               + x.narrow(dim, m - 1, 1) * self._signs(s, dim))
        even = self.forward(xf - xb, dim, level + 1)
        return torch.cat([odd, even], dim=dim)

    def inverse(self, y: torch.Tensor, dim: int, level: int = 0):
        """DST-I along dim (-1 or -2) of a packed-order spectrum, in
        natural order."""
        if level == len(self.levels):
            return _mm(y, self.base, dim)
        m, K2, s = self.levels[level]
        yo = y.narrow(dim, 0, m)
        uf = _mm(yo, K2.mT, dim)
        um = (yo * self._signs(s, dim)).sum(dim=dim, keepdim=True)
        v = self.inverse(y.narrow(dim, m, m - 1), dim, level + 1)
        return torch.cat([uf + v, um, (uf - v).flip(dim)], dim=dim)


def dst1(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalised type-I discrete sine transform along `dim`.

    X_k = 2 * sum_{j=1..N} x_j sin(pi j k / (N+1)),  k = 1..N
    (FFTPACK `dsint` convention, so dst1(dst1(x)) == 2*(N+1)*x), from the
    real FFT of the odd extension [0, x, 0, -reverse(x)]: ops/dst.py::dst.
    A CUDA tensor (float32 or float64) has the extension and the
    spectrum's -imag made by the hand-written kernels of csrc/dst.cu
    around cuFFT's r2c, bit for bit the torch chain (ops/dst.py::chain)
    that CPU tensors take.
    """
    return dst(x, dim)


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
    are formed from them on the fly. Under transform 'matmul' the
    spectrum is in packed split order (tx, ty) and the vectors are
    permuted to match, so the division and the Parseval contractions of
    models/ocean.py::_ocinvq read them as they are.
    """

    nxp: int
    nyp: int
    lamx: torch.Tensor       # (nxp-2,) x-eigenvalues
    lamy: torch.Tensor       # (nyp-2,)
    rdm2: torch.Tensor       # (nm,)
    gx: torch.Tensor         # (nxp-2,) DST of the ones vector
    gy: torch.Tensor         # (nyp-2,)
    norm: float              # combined inverse-transform normalisation
    transform: str = "fft"   # 'fft' | 'matmul' (the GEMM DST)
    mm_precision: str = "highest"    # the GEMM DST's: 'highest' | 'high'
    tx: PackedDST = None     # the GEMM DSTs along x and y ('matmul')
    ty: PackedDST = None

    def _denom(self) -> torch.Tensor:
        return (self.lamx[None, None, :] + self.lamy[None, :, None]
                - self.rdm2[:, None, None])

    # The 1-D transforms of the interior, along x (dim -1) and y (dim -2);
    # the inverse ones take a spectrum in the solver's order.
    def xdst(self, f: torch.Tensor) -> torch.Tensor:
        return dst1(f, dim=-1) if self.tx is None else self.tx.forward(f, -1)

    def ixdst(self, f: torch.Tensor) -> torch.Tensor:
        return dst1(f, dim=-1) if self.tx is None else self.tx.inverse(f, -1)

    def ydst(self, f: torch.Tensor) -> torch.Tensor:
        return dst1(f, dim=-2) if self.ty is None else self.ty.forward(f, -2)

    def iydst(self, f: torch.Tensor) -> torch.Tensor:
        return dst1(f, dim=-2) if self.ty is None else self.ty.inverse(f, -2)

    def forward(self, rhs: torch.Tensor) -> torch.Tensor:
        """Interior 2-D DST of a p-grid field (packed order under
        'matmul'); under 'fft' ops/dst.py::dst2, which on the card reads
        the interior in place and turns the x-DST's spectrum into the
        y-DST's extension in one pass."""
        if self.tx is None:
            return dst2(rhs[..., 1:-1, 1:-1])
        return self.ydst(self.xdst(rhs[..., 1:-1, 1:-1]))

    def inverse(self, spec: torch.Tensor) -> torch.Tensor:
        """Inverse 2-D DST, scaled by norm, with zero boundaries (under
        'fft' dst2 with norm: on the card its last pass writes the scaled
        solution into the zero-walled p-grid)."""
        if self.tx is None:
            return dst2(spec, self.norm)
        sol = self.iydst(self.ixdst(spec)) * self.norm
        return torch.nn.functional.pad(sol, (1, 1, 1, 1))

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs: (nm, nyp, nxp); returns the solution with zero walls."""
        return self.inverse(self.forward(rhs) / self._denom())

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only) of a
        float64 'fft' solver (natural spectral order) on the CPU."""
        _host_solver(self.lamx, self.transform)
        rhs = np.asarray(rhs, dtype=np.float64)
        spec = dst1_np(dst1_np(rhs[..., 1:-1, 1:-1], axis=-1), axis=-2)
        spec = spec * (1.0 / self._denom().numpy())
        sol = dst1_np(dst1_np(spec, axis=-1), axis=-2) * self.norm
        return np.pad(sol, [(0, 0)] * (rhs.ndim - 2) + [(1, 1), (1, 1)])


def _host_solver(lamx, transform):
    if (lamx.dtype != torch.float64 or lamx.device.type != "cpu"
            or transform != "fft"):
        raise ValueError("solve_np needs a float64 'fft' solver on the cpu")


def _check_transform(transform, mm_precision, allowed=TRANSFORMS):
    if transform not in allowed:
        raise ValueError(f"unknown transform {transform!r}")
    if mm_precision not in PRECISIONS:
        raise ValueError(f"unknown mm_precision {mm_precision!r}")


def make_box_helmholtz(nxp: int, nyp: int, dx: float, dy: float,
                       rdm2: np.ndarray, dtype=torch.float64,
                       device="cuda", transform: str = "fft",
                       mm_precision: str = "highest") -> BoxHelmholtz:
    """rdm2: (nm,) vector of 1/Rd^2 values (0 for barotropic). The
    vectors (and under transform='matmul' the GEMM DST's kernels, with the
    vectors permuted into packed order as qgcm_tpu's
    make_box_helmholtz does, its helmholtz.py:603-630) are computed in
    float64 NumPy and moved to `device` ('cuda', the default, or 'cpu')
    once. mm_precision: the GEMM DST's float32 products, 'highest' (full
    float32) or 'high' (the 3xTF32 kernel)."""
    _check_transform(transform, mm_precision)
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
    tx = ty = None
    if transform == "matmul":
        px, py = _split_perm(nx - 1), _split_perm(ny - 1)
        lamx, gx, lamy, gy = lamx[px], gx[px], lamy[py], gy[py]
        tx = PackedDST(nx - 1, dtype, device, mm_precision)
        ty = tx if ny == nx else PackedDST(ny - 1, dtype, device,
                                           mm_precision)

    def dev(a):
        return _vector(a, device, dtype)

    return BoxHelmholtz(nxp=nxp, nyp=nyp, lamx=dev(lamx), lamy=dev(lamy),
                        rdm2=dev(rdm2), gx=dev(gx), gy=dev(gy), norm=norm,
                        transform=transform, mm_precision=mm_precision,
                        tx=tx, ty=ty)


def _vector(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
        device=device, dtype=dtype)


@dataclass(frozen=True)
class CyclicHelmholtz:
    """Solver for the zonally periodic channel (Dirichlet N/S).

    Grid: p-array of shape (nyp, nxp) whose column nxp-1 duplicates
    column 0. The transform works on the nx = nxp-1 distinct columns;
    the solution repeats column 0 at the east edge, bit for bit. The
    y-DST is dst1's FFT form ('fft'), the GEMM DST `ty` ('matmul': its y
    spectrum in packed order, lamy permuted to match, solve's inverse
    y-DST taking it back), or one GEMM with the dense sine matrix
    `ysine` in the model's type ('sine', natural order), the y-DST that
    solver_transform='auto' gives a float32 channel (resolve_ytransform).
    """

    nxp: int
    nyp: int
    lamx: torch.Tensor       # (nx//2+1,) rfft eigenvalues
    lamy: torch.Tensor       # (nyp-2,)
    rdm2: torch.Tensor       # (nm,)
    norm: float              # the DST's; rfft/irfft normalise themselves
    ytransform: str = "fft"  # 'fft' | 'matmul' | 'sine'
    mm_precision: str = "highest"
    ty: PackedDST = None     # the GEMM DST along y ('matmul')
    ysine: torch.Tensor = None   # (nyp-2, nyp-2) sine_matrix ('sine')

    def _denom(self) -> torch.Tensor:
        return (self.lamx[None, None, :] + self.lamy[None, :, None]
                - self.rdm2[:, None, None])

    # the y-DST of the interior rows, and its inverse from the solver's
    # spectral order
    def ydst(self, f: torch.Tensor) -> torch.Tensor:
        if self.ty is not None:
            return self.ty.forward(f, -2)
        if self.ysine is not None:
            return torch.matmul(self.ysine, f)
        return dst1(f, dim=-2)

    def iydst(self, f: torch.Tensor) -> torch.Tensor:
        if self.ty is not None:
            return self.ty.inverse(f, -2)
        return self.ydst(f)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """rhs: (nm, nyp, nxp); returns the solution with zero zonal
        walls. The y-DST runs on the real field, before the forward and
        after the inverse x-transform (the two commute): two real sine
        transforms instead of four on the real and imaginary parts."""
        nx = self.nxp - 1
        sy = self.ydst(rhs[..., 1:-1, :nx])
        spec = torch.fft.rfft(sy, dim=-1) / self._denom()
        sy = torch.fft.irfft(spec, n=nx, dim=-1)
        sol = self.iydst(sy) * self.norm
        sol = torch.cat([sol, sol[..., :1]], dim=-1)
        return torch.nn.functional.pad(sol, (0, 0, 1, 1))

    def solve_np(self, rhs: np.ndarray) -> np.ndarray:
        """Host-side float64 solve (model initialisation only) of a
        float64 'fft' solver (natural spectral order) on the CPU."""
        _host_solver(self.lamx, self.ytransform)
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
                          device="cuda", ytransform: str = "fft",
                          mm_precision: str = "highest") -> CyclicHelmholtz:
    """Channel solver; the vectors (and with ytransform='matmul' the GEMM
    DST's kernels along y, lamy permuted into packed order as qgcm_tpu's
    make_cyclic_helmholtz does, its helmholtz.py:640-665; with 'sine' the
    dense sine matrix) are computed in float64 NumPy and moved to
    `device` ('cuda', the default, or 'cpu') once."""
    _check_transform(ytransform, mm_precision, (*TRANSFORMS, "sine"))
    device = resolve_device(device)
    nx, ny = nxp - 1, nyp - 1
    k = np.arange(nx // 2 + 1)                 # rfft wavenumbers
    l = np.arange(1, ny)
    lamx = 2.0 / dx**2 * (np.cos(2.0 * np.pi * k / nx) - 1.0)
    lamy = 2.0 / dy**2 * (np.cos(np.pi * l / ny) - 1.0)
    ty = ysine = None
    if ytransform == "matmul":
        lamy = lamy[_split_perm(ny - 1)]
        ty = PackedDST(ny - 1, dtype, device, mm_precision)
    elif ytransform == "sine":
        ysine = _vector(sine_matrix(ny - 1), device, dtype)
    return CyclicHelmholtz(nxp=nxp, nyp=nyp,
                           lamx=_vector(lamx, device, dtype),
                           lamy=_vector(lamy, device, dtype),
                           rdm2=_vector(rdm2, device, dtype),
                           norm=1.0 / (2.0 * ny), ytransform=ytransform,
                           mm_precision=mm_precision, ty=ty, ysine=ysine)
