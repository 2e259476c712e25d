"""The FFT DST's kernel path (qgcm_torch/ops/dst.py, csrc/dst.cu).

On the CPU: the autograd, forward-mode and vmap rules of `_Dst` (whose
forward runs the torch chain there) against autograd and torch.func
through the chain; the routing; and the kernels' launches composed as on
the card, each launch emulated from the very strides it would be given,
bit for bit the chain in the chain's layout, along any axis. On the card
(the `card` tests, skipped without one): the kernels bit for bit the
chain, along any axis, the box solver's transforms, a NAtl-sized
substep that takes the kernels for every DST, other types refused, and
gradcheck. Run them there with

    python -m pytest --noconftest tests/test_torch_dst_kernels.py -q
"""

import numpy as np
import pytest
import torch

from qgcm_torch.ops import dst as D
from qgcm_torch.solver import helmholtz as H

OPS = ("x", "y", "xy", "xy_norm")
NORM = 0.37


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tensors are tiny: one intra-op thread a process. Under the
    suite's parallel workers, torch's default of a thread per core spins
    them 20 times as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def field(shape, dtype=torch.float64, device="cpu", seed=5, interior=False):
    """Seeded normal values; with `interior`, the interior view of a field
    one point larger on each side of its last two axes."""
    if interior:
        shape = (*shape[:-2], shape[-2] + 2, shape[-1] + 2)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))
    x = x.to(dtype=dtype, device=device)
    return x[..., 1:-1, 1:-1] if interior else x


def via_chain(x, op):
    if op == "x":
        return D.chain(x, -1)
    if op == "y":
        return D.chain(x, -2)
    return D.chain2(x, NORM if op == "xy_norm" else None)


def via_function(x, op):
    if op in ("x", "y"):
        return D._Dst.apply(x, op, None)
    return D._Dst.apply(x, "xy", NORM if op == "xy_norm" else None)


def via_routing(x, op):
    if op in ("x", "y"):
        return D.dst(x, -1 if op == "x" else -2)
    return D.dst2(x, NORM if op == "xy_norm" else None)


@pytest.fixture
def function_calls(monkeypatch):
    """The calls that go through _Dst's rules, counted."""
    calls = []
    function = D._Dst

    class Counted:
        @staticmethod
        def apply(*args):
            calls.append(args[1:])
            return function.apply(*args)
    monkeypatch.setattr(D, "_Dst", Counted)
    return calls


def bits(t):
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def same_bits(a, b) -> bool:
    """The same shape, strides and bits (signed zeros included)."""
    return (a.shape == b.shape and a.stride() == b.stride()
            and torch.equal(bits(a), bits(b)))


# (shape, interior view): odd and even lengths, a member axis
SHAPES = [((3, 9, 12), False), ((3, 10, 7), True), ((2, 3, 9, 12), True),
          ((5, 8), False)]


# ----------------------------------------------------------------------
# The rules of _Dst on the CPU, float64
# ----------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape,interior", SHAPES)
def test_function_backward(op, shape, interior):
    x = field(shape, interior=interior).requires_grad_()
    out = via_function(x, op)
    assert same_bits(out.detach(), via_chain(x.detach(), op))
    w = field(out.shape, seed=6)
    got, = torch.autograd.grad((out * w).sum(), x)
    want, = torch.autograd.grad((via_chain(x, op) * w).sum(), x)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12 * want.abs().max())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape,interior", SHAPES)
def test_function_jvp(op, shape, interior):
    x = field(shape, interior=interior)
    t = field(shape, seed=7)
    out, got = torch.func.jvp(lambda a: via_function(a, op), (x,), (t,))
    want_out, want = torch.func.jvp(lambda a: via_chain(a, op), (x,), (t,))
    assert torch.equal(out, want_out)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12 * want.abs().max())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("in_dim", [0, 1])
def test_function_vmap(op, in_dim):
    x = field((4, 3, 9, 12), interior=True).movedim(0, in_dim)
    got = torch.func.vmap(lambda a: via_function(a, op), in_dims=in_dim)(x)
    want = torch.func.vmap(lambda a: via_chain(a, op), in_dims=in_dim)(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_function_grad_of_vmap(op):
    """Reverse mode through the vmap rule, as the ensemble's adjoint
    would take it."""
    x = field((3, 2, 6, 7))

    def loss(f, a):
        return (torch.func.vmap(f)(a) ** 2).sum()
    got = torch.func.grad(lambda a: loss(lambda b: via_function(b, op), a))(x)
    want = torch.func.grad(lambda a: loss(lambda b: via_chain(b, op), a))(x)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12 * want.abs().max())


@pytest.mark.parametrize("op", OPS)
def test_function_gradcheck(op):
    x = field((2, 5, 6)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a: via_function(a, op), (x,))
    assert torch.autograd.gradgradcheck(lambda a: via_function(a, op), (x,))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("in_dim", [0, 1])
def test_vmap_alone_unwraps(function_calls, op, in_dim):
    """Under a vmap alone, dst and dst2 run on the unwrapped tensor, not
    through _Dst's rules, and give the chain's vmap."""
    x = field((4, 3, 9, 12), interior=True).movedim(0, in_dim)
    got = torch.func.vmap(lambda a: via_routing(a, op), in_dims=in_dim)(x)
    want = torch.func.vmap(lambda a: via_chain(a, op), in_dims=in_dim)(x)
    assert torch.equal(got, want)
    assert function_calls == []


@pytest.mark.parametrize("op", OPS)
def test_vmap_nested_and_under_transforms(function_calls, op):
    """Nested vmaps, and vmap under grad and jvp, take _Dst's rules where
    the level below needs them, and give the chain's results."""
    x = field((2, 3, 3, 9, 12), interior=True)

    def vv(f):
        return torch.func.vmap(torch.func.vmap(f))
    assert torch.equal(vv(lambda a: via_routing(a, op))(x),
                       vv(lambda a: via_chain(a, op))(x))

    def loss(f, a):
        return (vv(f)(a) ** 2).sum()
    got = torch.func.grad(lambda a: loss(lambda b: via_routing(b, op), a))(x)
    want = torch.func.grad(lambda a: loss(lambda b: via_chain(b, op), a))(x)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12 * want.abs().max())
    t = field(x.shape, seed=9)
    _, got = torch.func.jvp(vv(lambda a: via_routing(a, op)), (x,), (t,))
    _, want = torch.func.jvp(vv(lambda a: via_chain(a, op)), (x,), (t,))
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12 * want.abs().max())
    assert function_calls


# ----------------------------------------------------------------------
# Routing
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dim", [0, 1, 2, -1, -2, -3])
def test_cpu_takes_the_chain(dim):
    D.reset_launches()
    x = field((3, 9, 12))
    assert same_bits(D.dst(x, dim), D.chain(x, dim))
    assert same_bits(H.dst1(x, dim), D.chain(x, dim))
    assert same_bits(D.dst2(x), D.chain2(x))
    assert same_bits(D.dst2(x, NORM), D.chain2(x, NORM))
    assert D.dst.launches == 0


@pytest.mark.parametrize("call", [lambda x: D.dst(x, 3),
                                  lambda x: D.dst(x, -4),
                                  lambda x: D.dst(x[0, 0], -2),
                                  lambda x: D.dst2(x[0, 0])])
def test_axes_out_of_range(call):
    with pytest.raises((IndexError, ValueError)):
        call(field((3, 9, 12)))


def test_cpu_box_solver_is_the_chain():
    """The CPU box solver's transforms are the chain's composition that
    BoxHelmholtz wrote out before the kernels."""
    rdm2 = np.array([0.0, 1.2e-9, 5.0e-9])
    helm = H.make_box_helmholtz(14, 11, 2e4, 2e4, rdm2, device="cpu")
    rhs = field((3, 11, 14))
    fwd = helm.forward(rhs)
    assert same_bits(fwd, D.chain(D.chain(rhs[..., 1:-1, 1:-1], -1), -2))
    sol = torch.nn.functional.pad(D.chain(D.chain(fwd, -1), -2) * helm.norm,
                                  (1, 1, 1, 1))
    assert same_bits(helm.inverse(fwd), sol)


@pytest.mark.parametrize("shape,strides,want", [
    ((), (), [(1, 0), (1, 0)]),
    ((3,), (100,), [(1, 0), (3, 100)]),
    ((2, 3), (300, 100), [(1, 0), (6, 100)]),       # contiguous members
    ((2, 3), (100, 200), [(2, 100), (3, 200)]),     # the member axis inside
    ((2, 1, 3), (999, 7, 100), [(2, 999), (3, 100)]),
    ((2, 3, 4), (1, 50, 7), None),
])
def test_batch_axes(shape, strides, want):
    assert D.batch_axes(shape, strides) == want


# ----------------------------------------------------------------------
# The kernels' launches composed as on the card, each emulated
# ----------------------------------------------------------------------

def emulate(op, negate, v, out, prm, scale=0.0):
    """What csrc/dst.cu's kernel `op` writes, read through the plane's
    strides and sizes alone (as the kernel is given them)."""
    src = torch.as_strided(v, (prm.b1, prm.b2, prm.p, prm.q),
                           (prm.sb1, prm.sb2, prm.sp, prm.sq),
                           v.storage_offset()).reshape(-1, prm.p, prm.q)
    q = prm.q
    if op in (D.EXTEND_ROWS, D.EXTEND_TILE):
        s = -src if negate else src
        z = out.view(-1, prm.p, 2 * q + 2)
        z[..., 0] = 0.0
        z[..., q + 1] = 0.0
        z[..., 1:q + 1] = s
        z[..., q + 2:] = -s.flip(-1)
    elif op == D.EXTRACT_ROWS:
        out.view(-1, prm.p, q).copy_(-src)
    else:
        o = out.view(-1, q + 2, prm.p + 2)
        o.zero_()
        o[..., 1:-1, 1:-1] = ((-src) * scale).mT


@pytest.fixture
def emulated(monkeypatch):
    ops = []

    def launch(op, negate, v, out, prm, scale=0.0):
        ops.append(op)
        emulate(op, negate, v, out, prm, scale)
    monkeypatch.setattr(D, "launch", launch)
    D.reset_launches()
    return ops


# the layouts the solvers hand over: a p-grid's interior, a spectrum in
# the chain's transposed layout, members, members inside the layers
LAYOUTS = ("interior", "transposed", "members", "members_inside")


def layout(name, dtype):
    if name == "interior":
        return field((3, 11, 14), dtype, interior=True)
    if name == "transposed":
        return field((3, 14, 11), dtype).mT
    if name == "members":
        return field((2, 3, 11, 14), dtype, interior=True)
    return field((3, 2, 11, 14), dtype, interior=True).movedim(1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("op", OPS)
def test_kernel_path_emulated(emulated, dtype, name, op):
    x = layout(name, dtype)
    got = D.kernels(x, "xy" if op == "xy_norm" else op,
                    NORM if op == "xy_norm" else None)
    assert same_bits(got, via_chain(x, op))
    # the tile where the input's fast axis is the one across the DST
    tiled = (name == "transposed") != (op == "y")
    extend = D.EXTEND_TILE if tiled else D.EXTEND_ROWS
    if op in ("x", "y"):
        assert emulated == [extend, D.EXTRACT_ROWS]
    else:
        last = D.EXTRACT_PAD if op == "xy_norm" else D.EXTRACT_ROWS
        assert emulated == [extend, D.EXTEND_TILE, last]
    assert D.dst.launches == len(emulated)


def test_kernel_path_emulated_one_axis(emulated):
    x = field((13,))
    assert same_bits(D.kernels(x, "x"), D.chain(x))


@pytest.fixture
def as_on_card(emulated, monkeypatch):
    """dst and dst2 routed as a CUDA tensor is: through the kernels'
    path, its launches emulated."""
    monkeypatch.setattr(D, "_apply",
                        lambda x, op, norm=None: D.kernels(x, op, norm))
    return emulated


@pytest.mark.parametrize("dim", [0, 1, 2, -1, -2, -3])
def test_every_dim_takes_the_kernels(as_on_card, dim):
    """A DST along any axis is the kernels' (the axis moved last and
    back), bit for bit the chain in the chain's layout."""
    x = field((3, 9, 12), interior=True)
    assert same_bits(D.dst(x, dim), D.chain(x, dim))
    assert D.dst.launches == 2


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

# (shape, ops): the box at 961^2 (and 8 members), the atmosphere's rows
CARD_CASES = [((3, 961, 961), OPS), ((8, 3, 961, 961), OPS),
              ((3, 97, 385), ("x", "y"))]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,ops", CARD_CASES)
def test_card_bit_for_bit(card, dtype, shape, ops):
    x = field(shape, dtype, card, interior=True)
    for op in ops:
        D.reset_launches()
        got = (D.dst2(x, NORM if op == "xy_norm" else None) if op[:2] == "xy"
               else D.dst(x, -1 if op == "x" else -2))
        torch.cuda.synchronize()
        assert D.dst.launches == (2 if op in ("x", "y") else 3)
        assert same_bits(got, via_chain(x, op)), op
        torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_box_helmholtz(card, dtype):
    rdm2 = np.array([0.0, 1.2e-9, 5.0e-9])
    helm = H.make_box_helmholtz(961, 961, 5e3, 5e3, rdm2, dtype=dtype,
                                device=card)
    rhs = field((3, 961, 961), dtype, card)
    fwd = helm.forward(rhs)
    want = D.chain2(rhs[..., 1:-1, 1:-1])
    assert same_bits(fwd, want)
    spec = fwd / helm._denom()
    assert same_bits(helm.inverse(spec), D.chain2(spec, helm.norm))
    assert same_bits(helm.solve(rhs), torch.nn.functional.pad(
        D.chain2(want / helm._denom()) * helm.norm, (1, 1, 1, 1)))
    torch.cuda.synchronize()


@pytest.mark.card
def test_card_natl_substep_takes_no_chain(card):
    from qgcm_torch.config import natl_1km
    from qgcm_torch.generators import eddy_pressure, zero_forcing
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    cfg = natl_1km(ocean_only=True, dtype="float32")
    model = build_model(cfg, card)
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)
    D.reset_launches()
    st = run(st, f, 1)
    torch.cuda.synchronize()
    assert D.dst.launches == 6          # forward and inverse, 3 each
    assert all(bool(torch.isfinite(t).all()) for t in st)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim", [0, 1, -3])
def test_card_any_dim(card, dtype, dim):
    x = field((5, 6, 7), dtype, card)
    D.reset_launches()
    got = D.dst(x, dim)
    torch.cuda.synchronize()
    assert D.dst.launches == 2
    assert same_bits(got, D.chain(x, dim))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_card_refuses_other_types(card, dtype):
    x = field((3, 9, 12), dtype, card)
    with pytest.raises(TypeError):
        D.dst(x)
    with pytest.raises(TypeError):
        D.dst2(x)


@pytest.mark.card
@pytest.mark.parametrize("op", OPS)
def test_card_vmap_alone(card, function_calls, op):
    xs = field((8, 3, 97, 129), torch.float32, card, interior=True)
    D.reset_launches()
    got = torch.func.vmap(lambda a: via_routing(a, op))(xs)
    torch.cuda.synchronize()
    assert D.dst.launches == (2 if op in ("x", "y") else 3)
    assert function_calls == []
    assert same_bits(got, via_chain(xs, op))


@pytest.mark.card
@pytest.mark.parametrize("op", OPS)
def test_card_rules(card, op):
    x = field((2, 5, 6), device=card).requires_grad_()
    assert torch.autograd.gradcheck(lambda a: via_function(a, op), (x,))
    xs = field((4, 3, 9, 12), device=card, interior=True)
    got = torch.func.vmap(lambda a: via_function(a, op))(xs)
    assert same_bits(got, via_chain(xs, op))
    t = field(xs.shape, device=card, seed=8)
    _, jt = torch.func.jvp(lambda a: via_function(a, op), (xs,), (t,))
    assert same_bits(jt, via_chain(t, op))
    torch.cuda.synchronize()
