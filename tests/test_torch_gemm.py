"""The 3xTF32 GEMM's host side (qgcm_torch/ops/gemm.py) on the CPU: the
TF32 rounding that splits the constant, the split planes' layout, the
GEMM DST's constants split once where it is built, and the launch plan,
executed in float64 against the plain product. Pure torch and NumPy; the kernel itself runs on the card only
(chip_smoke.py, phase 22)."""

import numpy as np
import pytest
import torch

from qgcm_torch.ops import gemm
from qgcm_torch.solver import helmholtz


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """float32 x rounded to 11 significant bits, to nearest with ties away
    from zero, computed in float64 from the significand: the rounding of
    cvt.rna.tf32.f32, independent of gemm.tf32_round's bit arithmetic."""
    x = x.astype(np.float64)
    m, e = np.frexp(np.abs(x))                  # |x| = m 2^e, m in [0.5, 1)
    return np.sign(x) * np.floor(m * 2.0**11 + 0.5) * 2.0**(e - 11)


def _values(kind, rng):
    if kind == "normal":
        return rng.standard_normal(4000).astype(np.float32)
    if kind == "wide":
        return (rng.standard_normal(4000)
                * 10.0**rng.uniform(-25, 25, 4000)).astype(np.float32)
    # ties: the 13 dropped bits exactly half a unit, both signs (exponents
    # from 2^-111, so that x - hi is no subnormal)
    bits = (rng.integers(0x08000000, 0x7F000000, 4000, dtype=np.int64)
            & ~0x1FFF) | 0x1000
    bits[::2] |= 0x80000000
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_tf32_round_is_cvt_rna(kind):
    """tf32_round: the low 13 bits zero, to nearest with ties away from
    zero (against rna_tf32), and hi + tf32(x - hi) within 2^-22 |x|."""
    x = _values(kind, np.random.default_rng(13))
    hi = gemm.tf32_round(torch.from_numpy(x))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert np.array_equal(hi.numpy().astype(np.float64), rna_tf32(x))
    if kind == "ties":
        assert (np.abs(hi.numpy()) > np.abs(x)).all()
    lo = gemm.tf32_round(torch.from_numpy(x) - hi)
    rest = x.astype(np.float64) - hi.double().numpy() - lo.double().numpy()
    assert (np.abs(rest) <= 2.0**-22 * np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("view", ["K", "K.mT"])
def test_split_planes_layout(view):
    """split_planes of K (37, 22) and of its transposed view: (2, n,
    pitch), K-major (planes[p, j, i] from K[i, j]), the pitch k rounded up
    to 4 floats with a zero pad, hi = tf32(K), hi + lo = K to 2^-22."""
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.standard_normal((37, 22)).astype(np.float32))
    K = base if view == "K" else base.mT
    k, n = K.shape
    planes = gemm.split_planes(K)
    pitch = -(-k // 4) * 4
    assert planes.shape == (2, n, pitch) and pitch % 4 == 0
    assert planes.is_contiguous() and planes.dtype == torch.float32
    assert not planes[:, :, k:].any()
    hi, lo = planes[0, :, :k], planes[1, :, :k]
    assert torch.equal(hi, gemm.tf32_round(K.mT))
    assert not (lo.contiguous().view(torch.int32) & 0x1FFF).any()
    kd = K.mT.double()
    assert ((hi.double() + lo.double() - kd).abs()
            <= 2.0**-22 * kd.abs()).all()


def planes_matrix(C):
    """The float64 matrix that a Constant's planes hold: (hi + lo) read
    back from K-major, the pad dropped."""
    k, _ = C.K.shape
    return (C.planes[0, :, :k].double() + C.planes[1, :, :k].double()).mT


@pytest.mark.parametrize("dim", [-1, -2])
def test_packed_dst_splits_its_constants_once(dim, monkeypatch):
    """A float32 'high' PackedDST holds each of its matrices as a
    Constant made when it is built: each level's K2 and K2.mT (its mT)
    and the symmetric base (its own mT), their planes split_planes of
    each, bit for bit. A forward, an inverse and a gradient through
    them, each product run through the launch plan from the planes it is
    handed (executed in float64), split nothing, hand over only the
    solver's Constants, and give the 'highest' solver's transform to
    float32 accuracy."""
    monkeypatch.setattr(helmholtz, "_MM_SPLIT_MIN", 4)
    n = 15                      # levels of half-size 8 and 4, a base of 3
    dst = helmholtz.PackedDST(n, torch.float32, "cpu", "high")
    ref = helmholtz.PackedDST(n, torch.float32, "cpu", "highest")
    assert [m for m, _, _ in dst.levels] == [8, 4]
    held = {id(dst.base)}
    for (_, K2, _), (_, K2_ref, _) in zip(dst.levels, ref.levels):
        assert isinstance(K2, gemm.Constant) and K2.mT.mT is K2
        assert torch.equal(K2.K.double(), K2_ref)
        held |= {id(K2), id(K2.mT)}
        for C in (K2, K2.mT):
            assert torch.equal(C.K, K2.K if C is K2 else K2.K.mT)
            assert torch.equal(C.planes.view(torch.int32),
                               gemm.split_planes(C.K).view(torch.int32))
    assert dst.base.mT is dst.base
    assert torch.equal(dst.base.planes, gemm.split_planes(dst.base.K.mT))
    assert dst.base.maps is None            # TMA descriptors: CUDA only

    def no_split(K):
        raise AssertionError("a call split a constant")
    handed = []

    def launch(p, x3, C):
        handed.append(id(C))
        return run_plan(p, x3, planes_matrix(C)).float()
    monkeypatch.setattr(gemm, "split_planes", no_split)
    monkeypatch.setattr(gemm, "_apply",
                        lambda x, C, d: gemm._planned(x, C, d, launch))
    rng = np.random.default_rng(15 - dim)
    shape = (3, n, 5) if dim == -2 else (3, 5, n)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xg = x.clone().requires_grad_()
    (dst.forward(xg, dim) * w).sum().backward()
    xr = x.clone().requires_grad_()
    (ref.forward(xr, dim) * w).sum().backward()
    scale = float(ref.forward(x, dim).abs().max())
    for got, want in ((dst.forward(x, dim), ref.forward(x, dim)),
                      (dst.inverse(x, dim), ref.inverse(x, dim)),
                      (xg.grad, xr.grad)):
        assert float((got - want).abs().max()) <= 1e-6 * scale
    assert handed and set(handed) == held
    assert gemm.contract.launches == 0


def run_plan(p, x, K):
    """Execute plan p in float64 as the kernel does: A from the field's
    storage through p.a_strides, C = A . K written through p.c_strides
    into a result of p.out_shape."""
    a = torch.as_strided(x, (p.batch, p.m, p.k), p.a_strides,
                         x.storage_offset()).double()
    out = torch.zeros(int(np.prod(p.out_shape)), dtype=torch.float64)
    torch.as_strided(out, (p.batch, p.m, p.n), p.c_strides).copy_(
        a @ K.double())
    return out.view(p.out_shape)


def _field(dim, narrowed, rng):
    """A (3, 11, 13) field contracted over its 13 (dim -1) or 11 (dim -2)
    axis, contiguous or a narrowed view of a wider field."""
    wide = torch.from_numpy(rng.standard_normal((3, 12, 15)).astype(
        np.float32))
    x = wide[:, :11, :13] if narrowed else wide[:, :11, :13].contiguous()
    k = 13 if dim == -1 else 11
    K = torch.from_numpy(rng.standard_normal((k, 6)).astype(np.float32))
    return x, K


@pytest.mark.parametrize("narrowed", [False, True])
@pytest.mark.parametrize("dim", [-1, -2])
def test_launch_plan(dim, narrowed, monkeypatch):
    """plan: the field is the register operand A in both orientations
    (through its transposed strides for dim -2, C^T = x^T K written
    transposed), the batch folded into A's rows where the strides allow
    it (contiguous, dim -1); executed in float64 it gives the product,
    directly and through contract under vmap (one planned call for the
    members, folded into the batch)."""
    rng = np.random.default_rng(100 * narrowed - dim)
    x, K = _field(dim, narrowed, rng)
    s0, s1, s2 = x.stride()
    p = gemm.plan(tuple(x.shape), x.stride(), tuple(K.shape), dim)
    assert p.transposed == (dim == -2)
    assert p.folded == (dim == -1 and not narrowed)
    if dim == -1:
        want_a = (0, s1, s2) if p.folded else (s0, s1, s2)
        assert p.out_shape == (3, 11, 6)
        assert p.c_strides == ((0, 6, 1) if p.folded else (66, 6, 1))
    else:
        want_a = (s0, s2, s1)
        assert p.out_shape == (3, 6, 13) and p.c_strides == (78, 1, 13)
    assert p.a_strides == want_a
    assert (p.batch, p.m) == ((1, 33) if p.folded else
                              (3, 11 if dim == -1 else 13))
    assert p.k == K.shape[0] and p.n == 6 and p.bn in gemm.TILE_NS
    assert p.tiles == p.batch * -(-p.m // gemm.TILE_M) * -(-p.n // p.bn)
    assert p.grid == min(p.tiles, gemm.NUM_SMS)
    want = x.double() @ K.double() if dim == -1 else K.double().mT @ x.double()
    assert torch.allclose(run_plan(p, x, K), want, rtol=1e-12, atol=1e-12)

    calls = []

    def planned(t, Km, d):
        calls.append(tuple(t.shape))
        return gemm._planned(t, Km, d,
                             lambda q, t3, k3: run_plan(q, t3, k3.K).float())
    monkeypatch.setattr(gemm, "_apply", planned)
    members = torch.stack([x, 2.0 * x, -x, 0.5 * x])
    if narrowed:
        members = torch.cat([members, members], dim=-1)[..., :13]
    C = gemm.Constant(K)
    got = torch.func.vmap(lambda t: gemm.contract(t, C, dim))(members)
    assert calls == [(12, 11, 13)]
    assert torch.allclose(got, gemm.plain(members, K, dim), rtol=1e-6,
                          atol=1e-6)


@pytest.mark.parametrize("case", ["no unit stride", "too large"])
def test_plan_refuses(case):
    """plan raises for what the kernel cannot take: a field with no unit
    stride on its last two axes (contract copies such a field first) and
    a product past the kernel's 32-bit indices."""
    if case == "no unit stride":
        shape, strides, k_shape = (3, 11, 13), (429, 26, 2), (13, 6)
    else:
        shape, strides, k_shape = (1, 2**31, 8), (2**34, 8, 1), (8, 6)
    with pytest.raises(ValueError):
        gemm.plan(shape, strides, k_shape, -1)
