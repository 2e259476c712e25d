"""The FFT solvers' DST-I: the torch chain, and on the card its glue as the
hand-written kernels of csrc/dst.cu around cuFFT's r2c.

`dst(x, dim)` is the unnormalised DST-I along dim (FFTPACK `dsint`'s
convention, solver/helmholtz.py::dst1), from the real FFT of the odd
extension [0, x, 0, -rev x]. `dst2(x)` is the box's 2-D transform of
(..., ny, nx): the x-DST of every row, then the y-DST of every column;
`dst2(x, norm)` the same times norm with a zero ring around it (the box
solve's inverse, ready for the p-grid). `chain` and `chain2` are the
torch chain that computes them (a flip, negations, a cat, torch.fft.rfft,
a strided slice): every CPU tensor takes it.

Every CUDA tensor takes the kernels (built on first use, see
ops/_cuda.py; float32 or float64, any other type refused; a DST along
another axis than -1 or -2 moves it last and back, as the chain does),
each launch adding one to `dst.launches`, with
torch.fft.rfft between them on the same contiguous extension the chain
builds: a 1-D DST is an `extend` and an `extract` (two launches), a 2-D
one an `extend`, a `turn` (the x-DST's -imag written transposed as the
y-DST's extension) and an `extract` or, with norm, an `extract_pad`
(three). The results are the chain's bit for bit, in the chain's
layout: a DST along -2, and dst2's spectrum, come back as transposed
views of a contiguous array, as the chain's do, so what follows sums
in the same order. The wrapper allocates each extension and output with
torch.empty (the spectra are rfft's) and lets each extension and
spectrum go after its one use; the kernels allocate nothing. Profiles
name the kernel path `qgcm_torch::dst`.

Autograd, forward mode and torch.func.vmap go through `_Dst`: the DST-I
is symmetric, so the cotangent and the tangent take the same transform
(dst2 with norm: the cotangent's interior, times norm), and under vmap
the mapped axis is one more batch axis of the same launches. Under a
vmap alone (`_vmapped`) the mapped axis is unwrapped directly, without
the Function's bookkeeping.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch._C import _functorch

from .qgstep import _seen

# dst_run's operations (csrc/dst.cu, Op)
EXTEND_ROWS, EXTEND_TILE, EXTRACT_ROWS, EXTRACT_PAD = range(4)
KERNEL_DTYPES = (torch.float32, torch.float64)


def chain(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The DST-I along dim by torch operations: the odd extension by
    flip and cat, torch.fft.rfft, -imag of the bins 1..N."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    zero = x.new_zeros(x.shape[:-1] + (1,))
    z = torch.cat([zero, x, zero, -x.flip(-1)], dim=-1)
    X = -torch.fft.rfft(z, dim=-1).imag[..., 1:n + 1]
    return X.movedim(-1, dim)


def chain2(x: torch.Tensor, norm: float = None) -> torch.Tensor:
    """dst2 by the chain: the y-DST of the x-DST; with norm, times norm
    and padded with a ring of zeros."""
    s = chain(chain(x, -1), -2)
    if norm is None:
        return s
    return torch.nn.functional.pad(s * norm, (1, 1, 1, 1))


class _Plane(ctypes.Structure):
    """DstPlane of csrc/dst.cu: an input (b1, b2, p, q) by its strides."""
    _fields_ = [("sb1", ctypes.c_longlong), ("sb2", ctypes.c_longlong),
                ("sp", ctypes.c_longlong), ("sq", ctypes.c_longlong),
                ("b1", ctypes.c_int), ("b2", ctypes.c_int),
                ("p", ctypes.c_int), ("q", ctypes.c_int)]


@functools.cache
def build_kernel():
    """Build (or find) and load csrc/dst.cu, once per process; called at
    the first launch. Returns the ops._cuda.Library."""
    from ._cuda import build
    lib = build("dst")
    lib.cdll.dst_run.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.POINTER(_Plane), ctypes.c_double, ctypes.c_void_p])
    lib.cdll.dst_run.restype = ctypes.c_int
    return lib


def batch_axes(shape, strides):
    """The leading axes of a view as two (size, stride) batch axes, the
    adjacent ones merged where one steps over the other and axes of one
    dropped, an axis (1, 0) put in front of one left; None where more
    than two remain."""
    merged = []
    for n, s in zip(shape, strides):
        if n == 1:
            continue
        if merged and merged[-1][1] == n * s:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    if len(merged) > 2:
        return None
    return [(1, 0)] * (2 - len(merged)) + merged


@functools.lru_cache(maxsize=256)
def _plane_of(shape, strides):
    """The _Plane of a view (..., P, Q) by its sizes and strides; None
    where no two batch axes describe its leading ones."""
    axes = batch_axes(shape[:-2], strides[:-2])
    if axes is None:
        return None
    (b1, sb1), (b2, sb2) = axes
    p, q = shape[-2:]
    if max(p + 2, 2 * q + 2, b1 * b2 * p) >= 2**31:
        raise ValueError(f"a DST too large for the kernels: {shape}")
    sp, sq = strides[-2:]
    return _Plane(sb1=sb1, sb2=sb2, sp=sp, sq=sq, b1=b1, b2=b2, p=p, q=q)


def plane(v: torch.Tensor):
    """(the view the kernel reads, its _Plane): v (..., P, Q) real, made
    contiguous first where no two batch axes describe its leading ones."""
    prm = _plane_of(tuple(v.shape), v.stride())
    if prm is None:
        v = v.contiguous()
        prm = _plane_of(tuple(v.shape), v.stride())
    return v, prm


@functools.cache
def _dst_run():
    """csrc/dst.cu's entry point, looked up once."""
    return build_kernel().cdll.dst_run


def launch(op: int, negate: bool, v: torch.Tensor, out: torch.Tensor,
           prm: _Plane, scale: float = 0.0):
    """One kernel of csrc/dst.cu on PyTorch's current stream of v's card
    (made the current card for the call only where it is not)."""
    index = v.device.index
    args = (op, int(v.dtype == torch.float64), int(negate), v.data_ptr(),
            out.data_ptr(), ctypes.byref(prm), float(scale),
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = _dst_run()(*args)
    else:
        with torch.cuda.device(index):
            err = _dst_run()(*args)
    if err != 0:
        raise RuntimeError(f"dst kernel {op} launch failed on "
                           f"{tuple(v.shape)}: CUDA error {err}")


def _run(op: int, v: torch.Tensor, out: torch.Tensor, negate=False,
         scale=0.0) -> torch.Tensor:
    v, prm = plane(v)
    launch(op, negate, v, out, prm, scale)
    dst.launches += 1
    return out


def _extend(v: torch.Tensor, negate: bool = False) -> torch.Tensor:
    """The contiguous odd extension (..., P, 2Q+2) of v (..., P, Q) along
    its last axis (of -v with negate): the row kernel where v's last axis
    is its fastest, the tile kernel where its rows' axis is."""
    p_stride, q_stride = v.stride()[-2:]
    op = EXTEND_TILE if p_stride < q_stride else EXTEND_ROWS
    z = torch.empty((*v.shape[:-1], 2 * v.shape[-1] + 2), dtype=v.dtype,
                    device=v.device)
    return _run(op, v, z, negate)


def _spectrum(z: torch.Tensor) -> torch.Tensor:
    """cuFFT's r2c of an extension (..., P, 2Q+2), as the real view
    (..., P, Q) of its bins' 1..Q imaginary parts."""
    q = z.shape[-1] // 2 - 1
    return torch.view_as_real(torch.fft.rfft(z, dim=-1))[..., 1:q + 1, 1]


def _extract(v: torch.Tensor) -> torch.Tensor:
    """-v, contiguous."""
    return _run(EXTRACT_ROWS, v, torch.empty(v.shape, dtype=v.dtype,
                                             device=v.device))


def _extract_pad(v: torch.Tensor, norm: float) -> torch.Tensor:
    """(-v).mT * norm inside a ring of zeros: (..., Q+2, P+2)."""
    *lead, p, q = v.shape
    out = torch.empty((*lead, q + 2, p + 2), dtype=v.dtype, device=v.device)
    return _run(EXTRACT_PAD, v, out, scale=norm)


def kernels(x: torch.Tensor, op: str, norm: float = None) -> torch.Tensor:
    """The kernels' path of `op`: 'x' (dst along -1), 'y' (along -2) or
    'xy' (dst2, with norm or without)."""
    if x.dim() == 1:
        return kernels(x[None], op, norm)[0]
    if op == "xy":
        # the turn: each array is let go as soon as the next is made
        z = _extend(_spectrum(_extend(x)).mT, negate=True)
        v = _spectrum(z)
        del z
        return _extract(v).mT if norm is None else _extract_pad(v, norm)
    v = _spectrum(_extend(x if op == "x" else x.mT))
    out = _extract(v)
    return out if op == "x" else out.mT


def _span():
    return (torch.profiler.record_function("qgcm_torch::dst")
            if torch.autograd._profiler_enabled()
            else contextlib.nullcontext())


def _apply(x: torch.Tensor, op: str, norm: float = None) -> torch.Tensor:
    """`op` without autograd's rules: the kernels on CUDA, the chain on
    the CPU."""
    if not x.is_cuda:
        if op == "xy":
            return chain2(x, norm)
        return chain(x, -1 if op == "x" else -2)
    with _span():
        return kernels(x, op, norm)


class _Dst(torch.autograd.Function):
    """_apply with its rules. The transforms are linear and symmetric:
    reverse mode gives the cotangent the same transform (after 'xy' with
    norm, its interior's, times norm), forward mode the tangent. vmap:
    the mapped axis leads, one more batch axis of the same launches."""

    @staticmethod
    def forward(x, op, norm):
        return _apply(x, op, norm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.op, ctx.norm = inputs

    @staticmethod
    def backward(ctx, grad):
        if ctx.op == "xy" and ctx.norm is not None:
            return dst2(grad[..., 1:-1, 1:-1]) * ctx.norm, None, None
        return _transform(grad, ctx.op, None), None, None

    @staticmethod
    def jvp(ctx, x_t, op_t, norm_t):
        return _transform(x_t, ctx.op, ctx.norm)

    @staticmethod
    def vmap(info, in_dims, x, op, norm):
        # through the rules again only where the level below needs them
        return _routed(x.movedim(in_dims[0], 0), op, norm), 0


def _transform(x, op, norm):
    return dst2(x, norm) if op == "xy" else dst(x, -1 if op == "x" else -2)


def _vmapped(x: torch.Tensor, op: str, norm):
    """`op` of x where x is batched by the innermost vmap over a plain
    tensor and nothing else is recorded (the ensemble's case): the
    launches on the plain tensor, its batch axis leading, and the result
    batched again, which is what _Dst's vmap rule does without the
    rules' bookkeeping (its host cost, 0.2-0.4 ms a call, more than the
    launches'); None for any other x."""
    ft = _functorch
    level = ft.maybe_current_level()
    if (not ft.is_batchedtensor(x) or ft.maybe_get_level(x) != level
            or torch.autograd.forward_ad._current_level >= 0):
        return None
    inner = ft.get_unwrapped(x)
    if ft.is_functorch_wrapped_tensor(inner) or (torch.is_grad_enabled()
                                                 and inner.requires_grad):
        return None
    out = _apply(inner.movedim(ft.maybe_get_bdim(x), 0), op, norm)
    return ft._add_batch_dim(out, 0, level)


def _routed(x: torch.Tensor, op: str, norm) -> torch.Tensor:
    if x.is_cuda and x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the DST's kernels take float32 or float64, "
                        f"not {x.dtype}")
    if not _seen((x,)):
        return _apply(x, op, norm)
    out = _vmapped(x, op, norm)
    return _Dst.apply(x, op, norm) if out is None else out


def dst(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The unnormalised DST-I along dim,
    X_k = 2 sum_{j=1..N} x_j sin(pi j k / (N+1)), k = 1..N:
    on the card the kernels (float32 or float64; a dim other than -1 or
    -2 moved last and back), on the CPU the chain."""
    d = dim - x.dim() if dim >= 0 else dim
    if not -x.dim() <= d < 0:
        raise IndexError(f"dim {dim} of a tensor of {x.dim()} axes")
    if d == -2:
        return _routed(x, "y", None)
    if d == -1:
        return _routed(x, "x", None)
    return _routed(x.movedim(d, -1), "x", None).movedim(-1, d)


def dst2(x: torch.Tensor, norm: float = None) -> torch.Tensor:
    """The 2-D DST-I of x (..., ny, nx): the y-DST of the x-DST; with
    norm, times norm inside a ring of zeros (..., ny+2, nx+2). On the
    card the kernels (float32 or float64), on the CPU the chain."""
    if x.dim() < 2:
        raise ValueError(f"dst2 of a tensor of {x.dim()} axes")
    return _routed(x, "xy", norm)


def reset_launches():
    """Set the kernels' launch count to zero."""
    dst.launches = 0


reset_launches()
