"""The forced channel's spread (chip_smoke.py --channel-spread) on the CPU:
the perturbed start that chip_smoke.py writes into a prepared restart.nc
(its duplicate column, its RMS, its seed), and the y-DSTs it gives the
channel by a local swap while the model's ocean inversion is built,
against the FFT solve. Pure torch and NumPy on a cut southern-ocean
channel."""

import numpy as np
import pytest
import torch

import chip_smoke
from qgcm_torch.config import southern_ocean_ocean_only
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.io import save_restart
from qgcm_torch.io.ncdf import read_vars
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.ops import gemm
from qgcm_torch.solver.helmholtz import PackedDST, make_cyclic_helmholtz

# the channel cut to 3 x 17 x 65 p-points, float64
CUT = dict(nxaooc=16, nyaooc=4, nxta=16, nyta=4, ndxr=4)
RMS = 1e-7 * 1.3


@pytest.fixture(scope="module")
def restart(tmp_path_factory):
    """A restart.nc of the cut channel holding an eddy, and its po."""
    model = build_model(southern_ocean_ocean_only(**CUT), "cpu")
    oc = init_ocean_state(model, po=eddy_pressure(model.cfg, ssh_amp=0.2))
    path = tmp_path_factory.mktemp("restart") / "restart.nc"
    save_restart(str(path), model, oc, init_atmos_state(model, init="rbal"),
                 0.0)
    return path, read_vars(str(path), ["po", "pom"])


def perturbed(restart, tmp_path, seed):
    """A copy of the restart perturbed with `seed`: (noise, po, pom)."""
    src, _ = restart
    path = tmp_path / f"restart_{seed}.nc"
    path.write_bytes(src.read_bytes())
    noise = chip_smoke.perturbed_restart(path, seed, RMS)
    got = read_vars(str(path), ["po", "pom"])
    return noise, got["po"], got["pom"]


def test_perturbed_start_keeps_duplicate_column(restart, tmp_path):
    """The noise, and po and pom with it, keep the channel's east column
    the west one bit for bit, and vanish on the zonal walls."""
    noise, po, pom = perturbed(restart, tmp_path, 3)
    for field in (noise, po, pom):
        assert np.array_equal(field[..., -1], field[..., 0])
    assert not noise[:, [0, -1], :].any()
    assert np.array_equal(po[:, [0, -1], :], restart[1]["po"][:, [0, -1], :])


def test_perturbed_start_rms(restart, tmp_path):
    """The noise's RMS over all layers and points is the one asked for,
    and the same noise is added to po and pom."""
    noise, po, pom = perturbed(restart, tmp_path, 5)
    assert noise.shape == po.shape
    assert abs(np.sqrt(np.mean(noise**2)) / RMS - 1.0) <= 1e-12
    for field, name in ((po, "po"), (pom, "pom")):
        added = field - restart[1][name]
        assert np.abs(added - noise).max() <= 1e-15 * np.abs(field).max()


def test_perturbed_start_is_seeded(restart, tmp_path):
    """The same seed gives the same field, bit for bit; another seed
    another."""
    a, po_a, _ = perturbed(restart, tmp_path, 7)
    (tmp_path / "again").mkdir()
    b, po_b, _ = perturbed(restart, tmp_path / "again", 7)
    c, _, _ = perturbed(restart, tmp_path, 8)
    assert np.array_equal(a, b) and np.array_equal(po_a, po_b)
    assert np.abs(a - c).max() > 0.1 * RMS


@pytest.mark.parametrize("ydst,precision", [("sine", "highest"),
                                            ("matmul", "high"),
                                            ("fft", "highest")])
def test_channel_ydst_swap(ydst, precision):
    """channel_ydst gives build_model's ocean channel the y-DST named (the
    dense sine matrix, or the GEMM DST at 'high' holding its constants
    split, or the FFT DST) whatever the configuration's solver_transform,
    and leaves the policy as it was outside the swap. In float64 the
    swapped solver solves as the FFT solver does, to 1e-12 of the
    solution's maximum, keeping the duplicate column."""
    cfg = southern_ocean_ocean_only(**CUT)
    with chip_smoke.channel_ydst(ydst, precision):
        helm = build_model(cfg.replace(solver_transform="fft"),
                           "cpu").inv_oc.helm
    fft = build_model(cfg, "cpu").inv_oc.helm
    assert fft.ytransform == "fft" and fft.ty is None
    assert helm.ytransform == ydst and helm.mm_precision == precision
    if ydst == "sine":
        assert helm.ysine.shape == (cfg.nypo - 2, cfg.nypo - 2)
    elif ydst == "matmul":
        assert isinstance(helm.ty, PackedDST) and helm.ty.precision == "high"
        f32 = make_cyclic_helmholtz(cfg.nxpo, cfg.nypo, 5e3, 5e3,
                                    np.zeros(1), dtype=torch.float32,
                                    device="cpu", ytransform="matmul",
                                    mm_precision="high")
        assert isinstance(f32.ty.base, gemm.Constant)
    rng = np.random.default_rng(17)
    rhs = rng.standard_normal((3, cfg.nypo, cfg.nxpo))
    rhs[..., -1] = rhs[..., 0]
    got = helm.solve(torch.from_numpy(rhs))
    want = fft.solve(torch.from_numpy(rhs))
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    assert torch.equal(got[..., -1], got[..., 0])
