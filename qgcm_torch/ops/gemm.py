"""The GEMM DST's float32 product at solver_precision='high': the CUDA
kernel's wrapper and its plain version.

`contract(x, K, dim)` contracts axis `dim` (-1 or -2) of x with the first
axis of the constant matrix K: x @ K for dim -1, K.mT @ x for dim -2
(qgcm_tpu/solver/helmholtz.py:109-120, `_mm`). On a CUDA float32 tensor it
launches the hand-written 3xTF32 GEMM of csrc/gemm3xtf32.cu (built on first
use, see ops/_cuda.py) and adds one to `contract.launches`; on a CPU tensor
it returns the plain version, `plain`: torch.matmul in float64 rounded to
float32, the full-precision product (qgcm_tpu on the CPU ignores the
precision too). There is no fallback between the two: a CUDA tensor gets
the kernel or an exception.

The kernel takes strided batches, so neither orientation copies the
field: for dim -1 the field is A (its rows and columns as they lie) and K
is B with a batch stride of 0; for dim -2, K.mT is A with a batch stride
of 0 and the field is B. The gradient is the same kernel on the
transposed strides (only x gets one: K is a build-time constant), and
under torch.func.vmap the mapped axis folds into the batch (the ensemble
runner vmaps the steps over members, models/ensemble.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .qgstep import _seen


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
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
        + [ctypes.c_void_p])
    lib.cdll.gemm3xtf32.restype = ctypes.c_int
    return lib


def _check(x, K, dim):
    if dim not in (-1, -2):
        raise ValueError(f"dim must be -1 or -2, got {dim}")
    if not (torch.is_tensor(x) and torch.is_tensor(K)):
        raise TypeError("x and K must be tensors")
    if x.dim() < 2 or K.dim() != 2:
        raise ValueError(f"x must have 2 or more axes and K 2, got "
                         f"{tuple(x.shape)} and {tuple(K.shape)}")
    if x.shape[dim] != K.shape[0]:
        raise ValueError(f"axis {dim} of x ({x.shape[dim]}) does not match "
                         f"K's first axis ({K.shape[0]})")
    if x.dtype != torch.float32 or K.dtype != torch.float32:
        raise TypeError(f"the 3xTF32 GEMM takes float32, got {x.dtype} and "
                        f"{K.dtype}")
    if x.device != K.device or x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"x on {x.device} and K on {K.device}: both on one "
                         "cuda device or the cpu")


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B by the kernel: a (batch, M, K) and b (batch, K, N), any
    strides (a batch stride of 0 shares one matrix), C contiguous."""
    batch, m, k = a.shape
    n = b.shape[2]
    if b.shape[0] != batch or b.shape[1] != k:
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} do not "
                         "make a batched product")
    if max(batch, (m + 63) // 64) > 65535 or max(m, n, k) >= 2**31:
        raise ValueError(f"product too large for the kernel's grid: batch "
                         f"{batch}, {m}x{n}x{k}")
    c = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    lib = build_kernel().cdll
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gemm3xtf32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                             batch, m, n, k, *a.stride(), *b.stride(),
                             stream)
    if err != 0:
        raise RuntimeError(f"gemm3xtf32 kernel launch failed: CUDA error "
                           f"{err}")
    contract.launches += 1
    return c


def _batched(t: torch.Tensor) -> torch.Tensor:
    """t (..., r, c) as (batch, r, c): a view where the leading axes
    merge, else a copy (torch.reshape)."""
    return t if t.dim() == 3 else t.reshape(-1, *t.shape[-2:])


def _apply(x: torch.Tensor, K: torch.Tensor, dim: int) -> torch.Tensor:
    """The contraction without autograd's rules: the kernel on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return plain(x, K, dim)
    lead = x.shape[:-2]
    xb = _batched(x)
    if dim == -1:
        out = _launch(xb, K.expand(xb.shape[0], *K.shape))
    else:
        out = _launch(K.mT.expand(xb.shape[0], K.shape[1], K.shape[0]), xb)
    return out.reshape(*lead, *out.shape[-2:])


class _Contract(torch.autograd.Function):
    """_apply with its rules. Reverse mode: x's cotangent is the same
    contraction with K.mT; K, a constant of the solver, gets none. Forward
    mode: the tangent goes through the same contraction. vmap: the mapped
    axis folds into the batch, one launch for all members."""

    @staticmethod
    def forward(x, K, dim):
        return _apply(x, K, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, K, dim = inputs
        ctx.K, ctx.dim = K, dim

    @staticmethod
    def backward(ctx, grad):
        return contract(grad, ctx.K.mT, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, x_t, K_t, dim_t):
        return contract(x_t, ctx.K, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, K, dim):
        if in_dims[1] is not None:
            raise ValueError("the GEMM DST's matrix is a constant; it "
                             "cannot be mapped over")
        x = x.movedim(in_dims[0], 0)
        out = _Contract.apply(_batched(x), K, dim)
        return out.reshape(*x.shape[:-2], *out.shape[-2:]), 0


def contract(x: torch.Tensor, K: torch.Tensor, dim: int) -> torch.Tensor:
    """Contract axis dim (-1 or -2) of x with K's first axis, in float32:
    on the card the 3xTF32 kernel (one launch), on the CPU `plain`.
    Goes through the autograd, forward-mode and vmap rules (_Contract)
    where a transform or autograd may see the call."""
    _check(x, K, dim)
    if _seen((x,)):
        return _Contract.apply(x, K, dim)
    return _apply(x, K, dim)


def reset_launches():
    """Set the kernel's launch count to zero."""
    contract.launches = 0


reset_launches()
