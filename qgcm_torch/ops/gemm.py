"""The GEMM DST's float32 product at solver_precision='high': the CUDA
kernel's wrapper, its launch plan and its plain version.

`contract(x, K, dim)` contracts axis `dim` (-1 or -2) of x with the first
axis of the constant matrix K: x @ K for dim -1, K.mT @ x for dim -2
(qgcm_tpu/solver/helmholtz.py:109-120, `_mm`), K held as a `Constant`. On a
CUDA float32 tensor it launches the hand-written 3xTF32 GEMM of
csrc/gemm3xtf32.cu (built on first use, see ops/_cuda.py) and adds one to
`contract.launches`; on a CPU tensor it returns the plain version,
`plain`: torch.matmul in float64 rounded to float32, the full-precision
product (qgcm_tpu on the CPU ignores the precision too). There is no
fallback between the two: a CUDA tensor gets the kernel or an exception.

The kernel holds the field in registers and reads the constant from
shared memory as wgmma takes it: K-major TF32 planes. So each constant is
split once, where the solver makes it: `Constant(K)` holds K, its hi and
lo planes (`split_planes`: rounded as cvt.rna.tf32.f32 rounds,
`tf32_round`, transposed to K-major and padded to a 16-byte pitch), on
CUDA their TMA descriptors for every tile width, and the same of K.mT
(`Constant.mT`, which the gradient contracts with). `plan` is the launch
as a pure function of the field's shape and strides: the field is A,
through its transposed strides for dim -2 (C^T = x^T K, written
transposed), the batch folded into A's rows where the strides allow it,
and the tile width that fills the card. The gradient is the same
contraction with K.mT (only x gets one: K is a build-time constant), and
under torch.func.vmap the mapped axis folds into the batch (the ensemble
runner vmaps the steps over members, models/ensemble.py).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .qgstep import _seen

# the kernel's tile: 128 rows of C (two consumer warpgroups of 64), one of
# TILE_NS columns, the depth in stages of 32 (csrc/gemm3xtf32.cu)
TILE_M = 128
TILE_NS = (128, 96, 64)
# SMs of an H100 SXM: the plan of a CPU tensor (the tests) assumes one
NUM_SMS = 132


def plain(x: torch.Tensor, K: torch.Tensor, dim: int) -> torch.Tensor:
    """The contraction of axis dim (-1 or -2) of x with K's first axis by
    torch.matmul, its products in float64 (DGEMM) and the result rounded
    once to x's type: the float32 result the 3xTF32 kernel approximates.
    The GEMM DST's float32 products at 'highest' are this too
    (solver/helmholtz.py::_mm)."""
    xd, kd = x.double(), K.double()
    return (xd @ kd if dim == -1 else kd.mT @ xd).to(x.dtype)


@functools.cache
def build_kernel():
    """Build (or find) and load csrc/gemm3xtf32.cu, once per process;
    called at the first launch. Returns the ops._cuda.Library."""
    from ._cuda import build
    lib = build("gemm3xtf32")
    lib.cdll.gemm3xtf32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6
        + [ctypes.c_int, ctypes.c_void_p])
    lib.cdll.gemm3xtf32.restype = ctypes.c_int
    lib.cdll.gemm3xtf32_planes_map.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)
    lib.cdll.gemm3xtf32_planes_map.restype = ctypes.c_int
    return lib


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32
    rounds: to nearest, ties away from zero (adding half a unit to the
    magnitude's bits), the 13 low bits zero; finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_planes(K: torch.Tensor) -> torch.Tensor:
    """K (k, n) float32 as the kernel reads it: (2, n, pitch) on K's
    device, plane 0 hi = tf32(K), plane 1 lo = tf32(K - hi), K-major
    (planes[p, j, i] is K[i, j]'s part) with the pitch k rounded up to a
    multiple of 4 floats (16 bytes, TMA's stride unit) and the pad zero.
    hi + lo is K to 2^-22 of |K|."""
    k, n = K.shape
    kt = K.mT.contiguous()
    hi = tf32_round(kt)
    lo = tf32_round(kt - hi)
    planes = K.new_zeros((2, n, -(-k // 4) * 4))
    planes[0, :, :k] = hi
    planes[1, :, :k] = lo
    return planes


def _tensor_map(planes: torch.Tensor, bn: int):
    """The kernel's TMA descriptor of CUDA planes for tiles of bn
    columns."""
    buf = ctypes.create_string_buffer(128)
    _, n, pitch = planes.shape
    err = build_kernel().cdll.gemm3xtf32_planes_map(
        buf, planes.data_ptr(), n, pitch, bn)
    if err != 0:
        raise RuntimeError(f"gemm3xtf32: cuTensorMapEncodeTiled failed "
                           f"with {err}")
    return buf


class Constant:
    """A constant matrix K (k, n) of the contraction, float32, as the
    kernel reads it, made once: its planes (split_planes), on CUDA their
    TMA descriptors for each tile width of TILE_NS (`maps`), and `mT`,
    the same of K.mT, made with it (the gradient contracts with it; a
    symmetric K is its own). The GEMM DST makes one of each of its
    matrices when it is built (solver/helmholtz.py::PackedDST)."""

    def __init__(self, K: torch.Tensor, mT: "Constant" = None):
        if K.dim() != 2 or K.dtype != torch.float32:
            raise TypeError(f"a Constant is a float32 matrix, got "
                            f"{K.dtype} of shape {tuple(K.shape)}")
        self.K = K
        self.planes = split_planes(K)
        self.maps = ({bn: _tensor_map(self.planes, bn) for bn in TILE_NS}
                     if K.is_cuda else None)
        if mT is None:
            mT = self if torch.equal(K, K.mT) else Constant(K.mT, self)
        self.mT = mT


@dataclass(frozen=True)
class Plan:
    """One launch of the kernel: C[b] = A[b] . K for b < batch, A (batch,
    m, k) the field through a_strides (the register operand in both
    orientations), C[b, i, j] written at c_strides into a contiguous
    result of out_shape; transposed for dim -2 (C^T = x^T K); folded where
    the field's batch merged into A's rows; tiles of TILE_M x bn, `grid`
    persistent blocks walking `tiles`."""
    batch: int
    m: int
    n: int
    k: int
    a_strides: tuple
    c_strides: tuple
    out_shape: tuple
    transposed: bool
    folded: bool
    bn: int
    tiles: int
    grid: int


def _tiles(batch, m, n, bn):
    return batch * -(-m // TILE_M) * -(-n // bn)


@functools.lru_cache(maxsize=256)
def plan(shape, strides, k_shape, dim: int, num_sms: int = NUM_SMS) -> Plan:
    """The launch for a field of `shape` (batch, rows, cols) and `strides`
    (elements, all three tuples) contracted on axis dim with a (k, n)
    constant; cached, as the DST makes the same few calls. The tile
    width is the one of TILE_NS whose waves over num_sms blocks take the
    least time, a tile's time taken as its width plus 16 columns of fixed
    cost (its epilogue and the ring's fill). Raises ValueError for a
    field without a unit stride on its last two axes (the kernel copies
    along one) or a product past the kernel's 32-bit limits."""
    batch, rows, cols = shape
    s0, s1, s2 = strides
    k, n = k_shape
    if dim == -1:
        m, depth, sam, sak = rows, cols, s1, s2
        out_shape, c_strides = (batch, rows, n), (rows * n, n, 1)
    else:
        m, depth, sam, sak = cols, rows, s2, s1
        out_shape, c_strides = (batch, n, cols), (n * cols, 1, cols)
    if depth != k:
        raise ValueError(f"axis {dim} of the field ({depth}) does not match "
                         f"the constant's first axis ({k})")
    folded = (batch > 1 and s0 == m * sam
              and c_strides[0] == m * c_strides[1])
    if folded:
        batch, m, s0, c_strides = 1, batch * m, 0, (0, *c_strides[1:])
    if 1 not in (sam, sak):
        raise ValueError(f"the kernel copies the field along a unit stride; "
                         f"its strides are {strides}")
    bn = min(TILE_NS, key=lambda t: (
        -(-_tiles(batch, m, n, t) // num_sms) * (t + 16), -t))
    tiles = _tiles(batch, m, n, bn)
    if max(m, n, k, tiles, TILE_M * max(sam, sak)) >= 2**31:
        raise ValueError(f"product too large for the kernel: batch {batch}, "
                         f"{m}x{n}x{k}, {tiles} tiles, strides {strides}")
    return Plan(batch=batch, m=m, n=n, k=k, a_strides=(s0, sam, sak),
                c_strides=c_strides, out_shape=out_shape,
                transposed=dim == -2, folded=folded, bn=bn, tiles=tiles,
                grid=min(tiles, num_sms))


@functools.cache
def _num_sms(device: torch.device) -> int:
    if device.type != "cuda":
        return NUM_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, C, dim):
    if dim not in (-1, -2):
        raise ValueError(f"dim must be -1 or -2, got {dim}")
    if not (torch.is_tensor(x) and isinstance(C, Constant)):
        raise TypeError("x must be a tensor and K a Constant")
    K = C.K
    if x.dim() < 2:
        raise ValueError(f"x must have 2 or more axes, got "
                         f"{tuple(x.shape)}")
    if x.shape[dim] != K.shape[0]:
        raise ValueError(f"axis {dim} of x ({x.shape[dim]}) does not match "
                         f"K's first axis ({K.shape[0]})")
    if x.dtype != torch.float32:
        raise TypeError(f"the 3xTF32 GEMM takes float32, got {x.dtype}")
    if x.device != K.device or x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"x on {x.device} and K on {K.device}: both on one "
                         "cuda device or the cpu")


def _launch(p: Plan, x: torch.Tensor, C: Constant) -> torch.Tensor:
    """Run plan p by the kernel: x the 3-D field, C the constant."""
    tmap = C.maps[p.bn]
    c = torch.empty(p.out_shape, dtype=torch.float32, device=x.device)
    lib = build_kernel().cdll
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gemm3xtf32(x.data_ptr(), c.data_ptr(), tmap, p.bn,
                             p.batch, p.m, p.n, p.k, *p.a_strides,
                             *p.c_strides, p.grid, stream)
    if err != 0:
        raise RuntimeError(f"gemm3xtf32 kernel launch failed: CUDA error "
                           f"{err}")
    contract.launches += 1
    return c


def _batched(t: torch.Tensor) -> torch.Tensor:
    """t (..., r, c) as (batch, r, c): a view where the leading axes
    merge, else a copy (torch.reshape)."""
    return t if t.dim() == 3 else t.reshape(-1, *t.shape[-2:])


def _planned(x: torch.Tensor, C: Constant, dim: int,
             launch) -> torch.Tensor:
    """The contraction as one planned launch: x's leading axes as one
    batch (copied where neither of its last two axes has a unit stride),
    `plan` of that, launch(plan, x3, C) (the kernel's `_launch`), the
    result given x's leading axes back."""
    xb = _batched(x)
    strides = xb.stride()
    if 1 not in strides[1:]:        # the kernel copies along a unit stride
        xb = torch.empty(xb.shape, dtype=xb.dtype,
                         device=xb.device).copy_(xb)
        strides = xb.stride()
    p = plan(xb.shape, strides, tuple(C.K.shape), dim, _num_sms(x.device))
    out = launch(p, xb, C)
    return out if x.dim() == 3 else out.reshape(*x.shape[:-2],
                                                *out.shape[-2:])


def _apply(x: torch.Tensor, C: Constant, dim: int) -> torch.Tensor:
    """The contraction without autograd's rules: the kernel on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return plain(x, C.K, dim)
    return _planned(x, C, dim, _launch)


class _Contract(torch.autograd.Function):
    """_apply with its rules. Reverse mode: x's cotangent is the same
    contraction with C.mT; C, a constant of the solver, gets none. Forward
    mode: the tangent goes through the same contraction. vmap: the mapped
    axis folds into the batch, one launch for all members."""

    @staticmethod
    def forward(x, C, dim):
        return _apply(x, C, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, C, dim = inputs
        ctx.C, ctx.dim = C, dim

    @staticmethod
    def backward(ctx, grad):
        return contract(grad, ctx.C.mT, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, x_t, C_t, dim_t):
        return contract(x_t, ctx.C, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, C, dim):
        x = x.movedim(in_dims[0], 0)
        out = _Contract.apply(_batched(x), C, dim)
        return out.reshape(*x.shape[:-2], *out.shape[-2:]), 0


def contract(x: torch.Tensor, C: Constant, dim: int) -> torch.Tensor:
    """Contract axis dim (-1 or -2) of x with the first axis of C's
    matrix, in float32: on the card the 3xTF32 kernel (one launch) with
    C's planes, on the CPU `plain`. Goes through the autograd,
    forward-mode and vmap rules (_Contract) where a transform or autograd
    may see the call."""
    _check(x, C, dim)
    if _seen((x,)):
        return _Contract.apply(x, C, dim)
    return _apply(x, C, dim)


def reset_launches():
    """Set the kernel's launch count to zero."""
    contract.launches = 0


reset_launches()
