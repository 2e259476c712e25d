"""The ported zonally-cyclic channel against qgcm_tpu on the CPU: the
channel Helmholtz solver, the homogeneous solutions of both fluids'
channel inversions, one cyclic ocean substep (nlo 3, and nlo 2 with the
k247 sponge), the presets that run a channel, the oracles of
tests/test_southern_ocean.py through the port's coupled runner, and the
channel's Rossby-wave dispersion oracles of tests/test_ocean_step.py."""

import jax
import numpy as np
import pytest
import torch

import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.ocean import make_ocean_step as jax_make_ocean_step
from qgcm_tpu.solver.helmholtz import make_cyclic_helmholtz as jax_cyclic
from qgcm_torch.convert import to_numpy
from qgcm_torch.coupling import make_xforc
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state, make_atmos_step
from qgcm_torch.models.ocean import init_ocean_state, make_ocean_step
from qgcm_torch.models.stepper import make_coupled_runner
from qgcm_torch.solver.helmholtz import make_cyclic_helmholtz

from test_torch_cases import (cfg_pair, coupled_pair, jax_case,
                              one_torch_thread, rel_err, to_jax, to_port)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = 1e-12


@pytest.mark.parametrize("nxp,nyp", [(25, 13), (97, 25)])
def test_cyclic_helmholtz_matches_jax(nxp, nyp):
    """solve (device form) and solve_np (host float64) against qgcm_tpu
    on a seeded cyclic right-hand side; the east column of the solution
    is its west column, bit for bit."""
    rng = np.random.default_rng(nxp)
    rdm2 = np.array([0.0, 2.5e-9, 9.0e-9])
    rhs = rng.standard_normal((3, nyp, nxp))
    rhs[..., -1] = rhs[..., 0]
    jh = jax_cyclic(nxp, nyp, 20e3, 20e3, rdm2)
    th = make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, rdm2, device="cpu")
    want = np.asarray(jh.solve(rhs))
    got = th.solve(torch.from_numpy(rhs))
    assert rel_err(got, want) <= TOL
    assert torch.equal(got[..., -1], got[..., 0])
    assert not got[:, [0, -1]].any()
    assert rel_err(th.solve_np(rhs), jh.solve_np(rhs)) <= TOL


@pytest.mark.parametrize("nxp,nyp", [(25, 13), (97, 25)])
def test_cyclic_helmholtz_gemm_ydst_matches_jax(nxp, nyp):
    """The y-DST as a GEMM (ytransform='matmul', at these heights the
    packed form's dense base, the split's levels being
    tests/test_torch_dst_matmul.py's; and 'sine', one GEMM with the sine
    matrix) against qgcm_tpu's 'matmul' y-transform and the port's FFT
    form, in float64; the duplicate east column is kept."""
    rng = np.random.default_rng(nyp)
    rdm2 = np.array([0.0, 2.5e-9, 9.0e-9])
    rhs = rng.standard_normal((3, nyp, nxp))
    rhs[..., -1] = rhs[..., 0]
    jh = jax_cyclic(nxp, nyp, 20e3, 20e3, rdm2, ytransform="matmul")
    th = make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, rdm2, device="cpu",
                               ytransform="matmul")
    fft = make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, rdm2, device="cpu")
    sine = make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, rdm2, device="cpu",
                                 ytransform="sine")
    for solver in (th, sine):
        got = solver.solve(torch.from_numpy(rhs))
        assert rel_err(got, np.asarray(jh.solve(rhs))) <= TOL
        assert rel_err(got, fft.solve(torch.from_numpy(rhs))) <= TOL
        assert torch.equal(got[..., -1], got[..., 0])


def test_ytransform_policy_is_jax():
    """The channel's y-DST is chosen as qgcm_tpu chooses it: a GEMM for
    the float32 southern-ocean ocean (575 interior rows) under 'auto',
    the FFT for its atmosphere (107 rows), in float64 and under 'fft'.
    There the port's GEMM is one with the float32 sine matrix ('sine',
    where qgcm_tpu's is 'matmul') at 'highest', and the packed GEMM DST
    under an explicit 'matmul' or at 'high'. At that height both float32
    solves match qgcm_tpu's within float32 roundoff (1e-5 of the
    solution's maximum): 'sine', the one 'auto' builds, and the packed
    form (one split level, 575 = 2 * 288 - 1; float64 products at
    'highest')."""
    from qgcm_tpu.solver.helmholtz import (
        resolve_ytransform as jax_resolve)
    from qgcm_torch.solver.helmholtz import resolve_ytransform
    picked = set()
    for dtype in ("float32", "float64"):
        for transform in ("auto", "fft"):
            kw = dict(dtype=dtype, solver_transform=transform)
            cj = jax_config.southern_ocean_coupled(**kw)
            ct = torch_config.southern_ocean_coupled(**kw)
            for nyp in (ct.nypo, ct.nypa):
                got = resolve_ytransform(ct, nyp)
                picked.add((dtype, transform, nyp, got))
                assert {"sine": "matmul"}.get(got, got) == jax_resolve(cj,
                                                                       nyp)
    assert ("float32", "auto", 577, "sine") in picked
    assert ("float32", "auto", 109, "fft") in picked
    cfg = torch_config.southern_ocean_ocean_only(nxaooc=2, nxta=2,
                                                 dtype="float32")
    helm = build_model(cfg, "cpu").inv_oc.helm
    assert helm.ysine.shape == (575, 575) and helm.ysine.dtype == torch.float32
    for over, want in (({}, "sine"), ({"solver_transform": "matmul"},
                                      "matmul"),
                       ({"solver_precision": "high"}, "matmul")):
        assert resolve_ytransform(cfg.replace(**over), 577) == want, over
    th = make_cyclic_helmholtz(33, 577, 5e3, 5e3, np.zeros(1),
                               dtype=torch.float32, device="cpu",
                               ytransform="matmul")
    (m, k2, _), = th.ty.levels
    assert (m, tuple(k2.shape), tuple(th.ty.base.shape)) == (
        288, (287, 288), (287, 287))
    # float32 values, held in float64 for the 'highest' float64 products
    for k in (k2, th.ty.base):
        assert k.dtype == torch.float64 and torch.equal(k.float().double(), k)
    rng = np.random.default_rng(577)
    rdm2 = np.array([0.0, 2.5e-9, 9.0e-9])
    rhs = rng.standard_normal((3, 577, 33)).astype(np.float32)
    rhs[..., -1] = rhs[..., 0]
    jh = jax_cyclic(33, 577, 5e3, 5e3, rdm2, dtype=np.float32,
                    ytransform="matmul")
    want = np.asarray(jh.solve(rhs))
    for yt in ("sine", "matmul"):
        th = make_cyclic_helmholtz(33, 577, 5e3, 5e3, rdm2,
                                   dtype=torch.float32, device="cpu",
                                   ytransform=yt)
        assert rel_err(th.solve(torch.from_numpy(rhs)), want) <= 1e-5, yt


def test_channel_constraints_solved_in_float64():
    """A float32 channel solves its momentum constraints in float64: on
    the southern-ocean channel's full 4609-point rows (one ocean cell
    high), with constraint vectors that cancel the inhomogeneous
    solution's line integrals to 1e-4, the float32 model's pressure and
    layer area integrals equal the float64 model's on the same float32
    inputs within 1e-6. In float32 that algebra misses the area
    integrals by 1.7e-4."""
    from qgcm_torch.models.ocean import _channel_pressure
    from qgcm_torch.ops.integrals import line_sum
    cfg = torch_config.southern_ocean_ocean_only(nyaooc=1, nyta=16)
    m32 = build_model(cfg.replace(dtype="float32"), "cpu")
    m64 = build_model(cfg.replace(dtype="float64"), "cpu")
    g = m64.grids
    rng = np.random.default_rng(5)
    sol = torch.from_numpy(rng.standard_normal((3, cfg.nypo, cfg.nxpo)))
    sol[..., -1] = sol[..., 0]
    sol[:, [0, -1]] = 0.0
    sol[:, 1] += 1.0
    sol[:, -2] -= 1.0
    sol = sol.float()
    ayis = line_sum(sol[:, 1, :].double()) * (g.dxo / g.dyo)
    ayin = -line_sum(sol[:, -2, :].double()) * (g.dxo / g.dyo)
    inv = torch.linalg.inv(torch.from_numpy(m64.modes_oc.cl2m))
    cs = (inv @ (-ayis * (1.0 - 1e-4))).float()
    cn = (inv @ (ayin * (1.0 - 1e-4))).float()
    p32, ai32 = _channel_pressure(m32.inv_oc, sol, m32.cm2l, cs, cn,
                                  g.dxo, g.dyo)
    p64, ai64 = _channel_pressure(m64.inv_oc, sol.double(), m64.cm2l,
                                  cs.double(), cn.double(), g.dxo, g.dyo)
    assert p32.dtype == ai32.dtype == torch.float32
    assert rel_err(p32, p64) <= 1e-6
    assert rel_err(ai32, ai64) <= 1e-6


@pytest.mark.parametrize("fluid", ["ocean", "atmos"])
def test_channel_homogeneous_data_matches_jax(fluid):
    """The channel inversion's homogeneous data (conhoms.F:376-543 and
    :644-811), ocean of the cyclic channel and atmosphere of the coupled
    box, as qgcm_tpu builds them."""
    cfg_j, cfg_t = coupled_pair("channel")
    jm = jax_build_model(cfg_j)
    tm = build_model(cfg_t, "cpu")
    if fluid == "ocean":
        ji, ti = jm.inv_oc, tm.inv_oc
        names = dict(pbh="pbhoc", pch1="pch1oc", pch2="pch2oc",
                     hbsi="hbsioc", aipbh="aipbho", aipch="aipcho")
    else:
        ji, ti = jm.inv_at, tm.inv_at
        names = dict(pbh="pbhat", pch1="pch1at", pch2="pch2at",
                     hbsi="hbsiat", aipbh="aipbha", aipch="aipcha")
    names.update(hc1s="hc1s", hc2s="hc2s", hc1n="hc1n", hc2n="hc2n")
    for mine, theirs in names.items():
        assert rel_err(np.asarray(getattr(ti, mine)),
                       np.asarray(getattr(ji, theirs))) <= TOL, mine
    for name in ("lamx", "lamy", "rdm2"):
        assert rel_err(getattr(ti.helm, name),
                       getattr(ji.helm, name)) <= TOL, name


@pytest.mark.parametrize("kw", [dict(nlo=3), dict(nlo=2, sponge=True)],
                         ids=["nlo3", "nlo2-sponge"])
def test_one_cyclic_substep_matches_jax(kw):
    """One substep of the cyclic ocean from the same state (JAX's, one
    substep after an eddy start under the double-gyre wind): every field
    of the state, the constraint vectors included, at 1e-12 of its max."""
    cfg_j, cfg_t = cfg_pair("pallas", cyclic=True, **kw)
    jm, st, f, _ = jax_case(cfg_j)
    st_j, d_j = jax.jit(jax_make_ocean_step(jm))(st, f)
    st_t, f_t = to_port(st, f)
    step = make_ocean_step(build_model(cfg_t, "cpu"))
    got, d_t = step(st_t, f_t)
    for name, arr in to_numpy(got).items():
        assert rel_err(arr, np.asarray(getattr(st_j, name))) <= TOL, name
    # the continuity monitor, a fractional error, within 1e-12 of JAX's
    assert np.abs(d_t.emfroc.numpy() - np.asarray(d_j.emfroc)).max() \
        <= TOL
    assert torch.equal(got.po[..., -1], got.po[..., 0])


def test_channel_presets_build_and_step():
    """southern_ocean_ocean_only and k247_default, their grids cut to a
    few cells (every other setting kept), build and step through the
    port; the channel keeps its duplicate column bit for bit."""
    from qgcm_torch.generators import eddy_pressure, zero_forcing
    from qgcm_torch.models.ocean import ocean_forcing_from_mean
    from qgcm_torch.models.stepper import make_ocean_only_runner
    for preset in (torch_config.southern_ocean_ocean_only,
                   torch_config.k247_default):
        cfg = preset(nxta=12, nxaooc=12, nyta=6, nyaooc=4, ndxr=4)
        model = build_model(cfg, "cpu")
        st = init_ocean_state(model, po=eddy_pressure(cfg))
        f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
        st = make_ocean_only_runner(model)(st, f, 30)
        assert all(bool(torch.isfinite(t).all()) for t in st)
        assert torch.equal(st.po[..., -1], st.po[..., 0])


@pytest.fixture(scope="module")
def southern():
    """tests/test_southern_ocean.py's set-up through the port: the
    miniature southern_ocean_coupled (55S, cyclic ocean channel), 120
    atmosphere steps from the radiative-balance state."""
    cfg_j, cfg_t = coupled_pair("channel")
    model = build_model(cfg_t, "cpu")
    oc, at = make_coupled_runner(model)(init_ocean_state(model, init="rbal"),
                                        init_atmos_state(model, init="rbal"),
                                        120)
    return cfg_j, model, oc, at


def test_southern_ocean_stable_and_cyclic(southern):
    _, model, oc, at = southern
    for f in (oc.po, oc.qo, oc.sst, at.pa, at.ast, at.hmixa):
        assert bool(torch.isfinite(f).all())
    assert torch.equal(oc.po[..., 0], oc.po[..., -1])


def test_southern_ocean_forcing_window_and_constraints(southern):
    """With nxaooc == nxta the ocean's stress window is the whole fine
    grid: tauxo is x-cyclic and nonzero once the atmosphere spins up;
    both fluids' continuity monitors stay tiny, and qgcm_tpu's validity
    scan passes on the port's states."""
    from qgcm_tpu.diags import valids
    from qgcm_tpu.state import (AtmosForcing, AtmosState, OceanForcing,
                                OceanState)
    cfg_j, model, oc, at = southern
    ofor, afor, _ = make_xforc(model)(at.pam, oc.pom, oc.sstm, at.astm,
                                      at.hmixam)
    assert ofor.tauxo.abs().max() > 0
    assert torch.equal(ofor.tauxo[:, 0], ofor.tauxo[:, -1])
    assert torch.equal(ofor.wekpo[:, 0], ofor.wekpo[:, -1])
    assert bool(torch.isfinite(ofor.txisoc)) and \
        bool(torch.isfinite(afor.txisat))
    _, od = make_ocean_step(model)(oc, ofor)
    _, ad = make_atmos_step(model)(at, afor)
    assert float(od.emfroc.abs().max()) < 1e-3
    assert float(ad.emfrat.abs().max()) < 1e-3
    rep = valids(jax_build_model(cfg_j), to_jax(OceanState, oc),
                 to_jax(AtmosState, at), to_jax(OceanForcing, ofor),
                 to_jax(AtmosForcing, afor))
    assert bool(rep.ok)


def test_southern_hemisphere_signs(southern):
    """f0 < 0: qgcm_tpu's monitor of the port's states gives positive
    kinetic energies (sign-sensitive paths: uvekfc, bdrfac, fsprim)."""
    from qgcm_tpu.diags import compute_monitor
    from qgcm_tpu.state import (AtmosForcing, AtmosState, OceanForcing,
                                OceanState)
    cfg_j, model, oc, at = southern
    ofor, afor, _ = make_xforc(model)(at.pam, oc.pom, oc.sstm, at.astm,
                                      at.hmixam)
    jm = jax_build_model(cfg_j)
    rec = jax.jit(lambda *a: compute_monitor(jm, *a))(
        to_jax(OceanState, oc), to_jax(AtmosState, at),
        to_jax(OceanForcing, ofor), to_jax(AtmosForcing, afor))
    assert (np.asarray(rec.oc.kea) >= 0).all()
    assert (np.asarray(rec.at.kea) >= 0).all()
    assert float(rec.btdgoc) >= 0
    assert model.rad.fspco < 0


def test_cyclic_port_config_is_jax_config():
    """The presets the port runs are qgcm_tpu's, field for field."""
    for name in ("southern_ocean_ocean_only", "southern_ocean_coupled",
                 "k247_default", "double_gyre_coupled"):
        cj = getattr(jax_config, name)()
        ct = getattr(torch_config, name)()
        for field in ("nxta", "nyta", "nxaooc", "nyaooc", "ndxr", "fnot",
                      "beta", "dta", "nstr", "cyclic_ocean", "ocean_only",
                      "nb_hflux", "ocean", "atmos", "sponge"):
            assert getattr(cj, field).__repr__() == \
                getattr(ct, field).__repr__(), (name, field)


def _inviscid_channel(**kw):
    """An unforced, inviscid cyclic ocean (tests/test_ocean_step.py's
    oracle configurations) in the port, on the CPU."""
    oc = torch_config.OceanConfig(delek=0.0, **kw.pop("ocean"))
    return build_model(torch_config.ModelConfig(
        ocean=oc, ocean_only=True, cyclic_ocean=True, **kw).validate(),
        "cpu")


@pytest.mark.parametrize("mode,chunk", [(0, 50), (1, 300)],
                         ids=["barotropic", "baroclinic"])
def test_rossby_wave_dispersion(mode, chunk):
    """tests/test_ocean_step.py's barotropic and baroclinic Rossby-wave
    oracles in the port: one harmonic in vertical mode `mode` of the
    unforced inviscid channel is an exact nonlinear solution, whose
    phase turns westward at omega = -beta k / (k^2 + l^2 + rdm2) within
    5% (the 5-point discrete dispersion at ~21 points a wavelength)."""
    from qgcm_torch.generators import zero_forcing
    from qgcm_torch.models.ocean import ocean_forcing_from_mean
    from qgcm_torch.models.stepper import make_ocean_only_runner
    model = _inviscid_channel(
        nxta=64, nyta=16, nxaooc=64, nyaooc=16, ndxr=1, fnot=9.4e-5,
        beta=1.75e-11, dta=200.0, nstr=3,
        ocean=dict(nlo=3, dxo=10e3, hoc=(350., 750., 2900.),
                   gpoc=(0.025, 0.0125), tabsoc=(287., 282., 276.),
                   ah2oc=(0., 0., 0.), ah4oc=(0., 0., 0.)))
    cfg = model.cfg
    nx, ny = cfg.nxpo - 1, cfg.nypo - 1
    dx = model.grids.dxo
    kx = 2 * np.pi * 3 / (nx * dx)
    ly = np.pi / (ny * dx)
    x = np.arange(cfg.nxpo) * dx
    y = np.arange(cfg.nypo) * dx
    wave = (1e-4 * cfg.fnot * dx * dx * np.sin(ly * y)[:, None]
            * np.cos(kx * x)[None, :])
    layers = model.modes_oc.cm2l[:, mode]
    state = init_ocean_state(model, po=layers[:, None, None] * wave)
    forcing = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)
    cy = np.sin(ly * y)[:, None]

    def phase(st):
        p = np.einsum("k,kyx->yx", model.modes_oc.cl2m[mode],
                      st.po.numpy())[:, :nx]
        return np.arctan2((p * cy * np.sin(kx * x[:nx])).sum(),
                          (p * cy * np.cos(kx * x[:nx])).sum())

    ths = [phase(state)]
    for k in range(6):
        state = run(state, forcing, chunk, step0=k * chunk)
        ths.append(phase(state))
    omega = np.unwrap(np.diff(ths)).mean() / (chunk * cfg.dto)
    omega_ref = -cfg.beta * kx / (kx**2 + ly**2 + model.modes_oc.rdm2[mode])
    assert omega < 0, "Rossby waves propagate westward"
    assert abs(omega - omega_ref) < 0.05 * abs(omega_ref), (omega, omega_ref)
