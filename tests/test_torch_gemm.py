"""The 3xTF32 GEMM's host side (qgcm_torch/ops/gemm.py) on the CPU: the
TF32 rounding that splits the constant, the split planes' layout, their
cache, and the launch plan, executed in float64 against the plain
product. Pure torch and NumPy; the kernel itself runs on the card only
(chip_smoke.py, phase 22)."""

import numpy as np
import pytest
import torch

from qgcm_torch.ops import gemm


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


def test_planes_cache():
    """planes_entry: one split per matrix and per view (K and K.mT are two
    entries), found again without a split, and a fresh entry after an
    in-place edit of the matrix."""
    gemm._PLANES.clear()
    gemm.reset_launches()
    rng = np.random.default_rng(3)
    K = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    first = gemm.planes_entry(K)
    assert gemm.planes_entry(K) is first
    assert gemm.planes_entry(K[:, :]) is first      # same storage and view
    kt = gemm.planes_entry(K.mT)
    assert kt is not first and gemm.planes_entry(K.mT) is kt
    assert len(gemm._PLANES) == 2 and gemm.contract.splits == 2
    assert torch.equal(kt.planes, gemm.split_planes(K.mT))
    K.mul_(2.0)
    fresh = gemm.planes_entry(K)
    assert fresh is not first and gemm.contract.splits == 3
    assert len(gemm._PLANES) == 2
    assert torch.equal(fresh.planes, 2.0 * first.planes)
    gemm._PLANES.clear()
    gemm.reset_launches()


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
                             lambda q, t3, k3: run_plan(q, t3, k3).float())
    monkeypatch.setattr(gemm, "_apply", planned)
    members = torch.stack([x, 2.0 * x, -x, 0.5 * x])
    if narrowed:
        members = torch.cat([members, members], dim=-1)[..., :13]
    got = torch.func.vmap(lambda t: gemm.contract(t, K, dim))(members)
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
