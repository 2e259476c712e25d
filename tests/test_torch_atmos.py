"""The ported atmosphere against qgcm_tpu on the CPU, module by module,
in float64 from the same seeded inputs: init_atmos_state, the mixed
layer _aml, the vorticity step _qgastep, the channel inversion _atinvq,
the boundary PV atqzbd, and whole steps (float64, and float32 with the
float64 mixed layer); then the atmosphere's oracles of
tests/test_atmos_step.py and tests/test_ml_f64.py through the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgcm_tpu.coupling import make_xforc as jax_make_xforc
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models import atmos as jax_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_tpu.ops.vorticity import atqzbd as jax_atqzbd
from qgcm_tpu.state import AtmosState as JaxAtmosState
from qgcm_torch.convert import atmos_forcing_to_torch, atmos_state_to_torch
from qgcm_torch.coupling import make_xforc
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.model import build_model
from qgcm_torch.models import atmos
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.models.stepper import make_coupled_runner
from qgcm_torch.ops.vorticity import atqzbd, qcomp

from test_torch_cases import (coupled_pair, numpy_of, one_torch_thread,
                              rel_err, to_jax)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = 1e-12


def _seeded_fields(cfg, seed=0):
    """The radiative-balance atmosphere of `cfg` with seeded noise of a
    few percent on both pressure levels, AST and mixed-layer depth (east
    column the duplicate of the west one), as NumPy float64 arrays."""
    rng = np.random.default_rng(seed)
    model = build_model(cfg, "cpu")
    rbal = atmos.init_atmos_state(model, init="rbal")

    def noisy(base, amp, cyclic):
        base = base.numpy()
        noise = rng.standard_normal(base.shape)
        if cyclic:
            noise[..., -1] = noise[..., 0]
        return base + amp * noise

    scale = float(rbal.pa.abs().max())
    return dict(pa=noisy(rbal.pa, 0.03 * scale, True),
                pam=noisy(rbal.pa, 0.03 * scale, True),
                ast=noisy(rbal.ast, 0.5, False),
                astm=noisy(rbal.ast, 0.5, False),
                hmixa=noisy(rbal.hmixa, 30.0, False),
                hmixam=noisy(rbal.hmixa, 30.0, False))


@pytest.fixture(scope="module")
def case():
    """Both packages' models of the small coupled box, JAX's state of
    the seeded atmosphere (also in the port's tensors), and JAX's xforc
    of it as both packages' forcing."""
    cfg_j, cfg_t = coupled_pair("box")
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t, "cpu")
    at_j = jax_atmos.init_atmos_state(jm, **_seeded_fields(cfg_t))
    at_t = atmos_state_to_torch(numpy_of(at_j), "cpu")
    oc_j = jax_init_ocean(jm, po=eddy_pressure(cfg_t))
    _, afor_j, _ = jax.jit(jax_make_xforc(jm))(
        at_j.pam, oc_j.pom, oc_j.sstm, at_j.astm, at_j.hmixam)
    afor_t = atmos_forcing_to_torch(numpy_of(afor_j), "cpu")
    return jm, tm, at_j, at_t, afor_j, afor_t


def _integral_of_abs(model, f):
    """dxa*dya * sum|f|: the scale of roundoff in an area integral of f."""
    return float(np.abs(np.asarray(f)).sum()) * model.grids.dxa \
        * model.grids.dya


def _close(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    assert rel_err(got, want) <= TOL, (what, rel_err(got, want))


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "rbal"])
def test_init_atmos_state_matches_jax(case, seeded):
    """From the seeded arrays (above) and from the radiative balance;
    the interface-displacement integrals, which cancel to roundoff in
    the balanced state, at the roundoff of the integral of |pa|."""
    jm, tm = case[:2]
    fields = _seeded_fields(tm.cfg) if seeded else {}
    want = numpy_of(jax_atmos.init_atmos_state(jm, **fields))
    got = numpy_of(atmos.init_atmos_state(tm, **fields))
    for name in want:
        if name in ("dpiat", "dpiatp"):
            assert np.abs(got[name] - want[name]).max() <= \
                TOL * _integral_of_abs(tm, want["pa"]), name
        else:
            _close(got[name], want[name], name)


def test_aml_matches_jax(case):
    jm, tm, at_j, at_t, afor_j, afor_t = case
    want = jax_atmos._aml(jm, at_j, afor_j)
    got = atmos._aml(tm, at_t, afor_t)
    # xan1, enis1, enin1 (5-7) are integrals of entat that nearly cancel:
    # held to roundoff of the integral of |entat|
    scale = _integral_of_abs(tm, want[4])
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (5, 6, 7):
            assert abs(float(g) - float(w)) <= TOL * scale, i
        else:
            _close(g, w, f"_aml[{i}]")


def test_qgastep_matches_jax(case):
    jm, tm, at_j, at_t, afor_j, afor_t = case
    entat = jax_atmos._aml(jm, at_j, afor_j)[4]
    want = jax_atmos._qgastep(jm, at_j, afor_j, entat)
    got = atmos._qgastep(tm, at_t, afor_t, torch.tensor(np.asarray(entat)))
    _close(got[0], want[0], "qa_new")
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2], "cyc")


def test_atinvq_matches_jax(case):
    """The inversion from the same PV, entrainment integrals and
    boundary integrals (JAX's): all ten outputs."""
    jm, tm, at_j, at_t, afor_j, afor_t = case
    aml = jax_atmos._aml(jm, at_j, afor_j)
    qa_new, _, cyc = jax_atmos._qgastep(jm, at_j, afor_j, aml[4])
    want = jax_atmos._atinvq(jm, at_j, qa_new, aml[5], aml[6], aml[7], cyc,
                             afor_j)

    def t(x):
        return torch.tensor(np.asarray(x))

    got = atmos._atinvq(tm, at_t, t(qa_new), t(aml[5]), t(aml[6]),
                        t(aml[7]), {k: t(v) for k, v in cyc.items()},
                        afor_t)
    names = ("pa", "pam", "dpiat", "dpiatp", "atmcs", "atmcn", "atmcsp",
             "atmcnp")
    for name, g, w in zip(names, got[:8], want[:8]):
        _close(g, w, name)
    assert torch.equal(got[0][..., -1], got[0][..., 0])
    # ermasa/emfrat: continuity errors, roundoff in both
    assert np.abs(got[9].numpy() - np.asarray(want[9])).max() <= TOL


def test_atqzbd_matches_jax(case):
    jm, tm, at_j, at_t, _, _ = case
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    q = rng.standard_normal(tuple(at_t.qa.shape))
    args = (1.0 / tm.grids.dxa**2, cfg.fnot, cfg.beta, cfg.atmos.bccoat)
    want = jax_atqzbd(jnp.asarray(q), at_j.pa, jnp.asarray(jm.modes_at.amat),
                      jnp.asarray(jm.grids.yparel), *args, jnp.zeros(()))
    got = atqzbd(torch.from_numpy(q), at_t.pa, tm.amat_at, tm.yparel, *args,
                 tm.ddyn_at)
    _close(got, want, "atqzbd")


@pytest.mark.parametrize("dtype,tol", [("float64", TOL),
                                       ("float32", 1e-5)])
def test_atmos_step_matches_jax(case, dtype, tol):
    """make_atmos_step from the same state and forcing; float32 (with
    the float64 mixed layer in both) at 1e-5 of each field's max: the
    two float32 FFTs and sums round differently by a few ulp."""
    _, _, at_j, _, afor_j, _ = case
    cfg_j, cfg_t = coupled_pair("box", dtype=dtype)
    cast = (lambda nt: jax.tree.map(lambda x: x.astype(dtype), nt))
    jm = jax_build_model(cfg_j)
    want, _ = jax.jit(jax_atmos.make_atmos_step(jm))(cast(at_j),
                                                     cast(afor_j))
    tdt = getattr(torch, dtype)
    tm = build_model(cfg_t, "cpu")
    got, _ = atmos.make_atmos_step(tm)(
        atmos_state_to_torch(numpy_of(at_j), "cpu", tdt),
        atmos_forcing_to_torch(numpy_of(afor_j), "cpu", tdt))
    want = numpy_of(want)
    for name, arr in numpy_of(got).items():
        assert arr.dtype == np.dtype(dtype), name
        if name == "dpiat":
            # differences of nearly equal layer integrals: held to the
            # roundoff of the integral of |pa|
            assert np.abs(arr - want[name]).max() <= \
                tol * _integral_of_abs(tm, want["pa"]), name
        else:
            assert rel_err(arr, want[name]) <= tol, name


@pytest.fixture(scope="module")
def spun_up():
    """tests/test_atmos_step.py's set-up through the port: 51 coupled
    atmosphere steps of the small box from the radiative balance."""
    _, cfg = coupled_pair("box")
    model = build_model(cfg, "cpu")
    oc, at = make_coupled_runner(model)(init_ocean_state(model, init="rbal"),
                                        atmos.init_atmos_state(model), 51)
    return model, oc, at


def test_atmos_inversion_exact_and_constraints_close(spun_up):
    """After a step, qcomp(pa) reproduces qa at interior points, the
    continuity monitor is tiny, the mixed-layer fixer keeps hmixa above
    hmamin, and every p field keeps its duplicate column."""
    model, oc, at = spun_up
    cfg = model.cfg
    assert float(at.hmixa.min()) >= cfg.mixed.hmamin
    _, afor, _ = make_xforc(model)(at.pam, oc.pom, oc.sstm, at.astm,
                                   at.hmixam)
    at3, diags = atmos.make_atmos_step(model)(at, afor)
    q2 = qcomp(at3.pa, model.amat_at, model.yparel, 1.0 / model.grids.dxa**2,
               cfg.fnot, cfg.beta, model.ddyn_at, 0, True)
    err = float((q2[:, 1:-1, :] - at3.qa[:, 1:-1, :]).abs().max())
    assert err < 1e-12 * float(at3.qa.abs().max())
    assert float(diags.emfrat.abs().max()) < 1e-6
    assert torch.equal(at3.pa[..., 0], at3.pa[..., -1])
    for name in ("pa", "qa"):
        f = getattr(at3, name)
        assert torch.allclose(f[..., 0], f[..., -1], rtol=0,
                              atol=1e-10 * float(f.abs().max())), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ml_f64_coupled(dtype):
    """tests/test_ml_f64.py's coupled cases in the port: on float32
    models the float64 prediction core of both mixed layers runs
    (values differ from ml_f64=False) and storage stays float32; on
    float64 models the flag is bit-identical either way."""
    _, cfg = coupled_pair("box", dtype=dtype)
    model = build_model(cfg, "cpu")
    oc = init_ocean_state(model, po=eddy_pressure(cfg))
    at = atmos.init_atmos_state(model)
    runs = [make_coupled_runner(dataclasses.replace(
        model, cfg=cfg.replace(ml_f64=flag)))(oc, at, 24)
        for flag in (None, False)]
    (o1, a1), (o2, a2) = runs
    for t in (o1.sst, a1.ast, a1.hmixa):
        assert t.dtype == getattr(torch, dtype)
        assert bool(torch.isfinite(t).all())
    if dtype == "float32":
        assert not torch.equal(o1.sst, o2.sst)
        assert not torch.equal(a1.ast, a2.ast)
    else:
        for x, y in zip((*o1, *a1), (*o2, *a2)):
            assert torch.equal(x, y)


def test_port_atmos_state_round_trip(case):
    """convert.py: port atmosphere state -> NumPy -> JAX NamedTuple ->
    port again is the identity."""
    _, _, _, at_t, _, _ = case
    back = atmos_state_to_torch(numpy_of(to_jax(JaxAtmosState, at_t)),
                                "cpu")
    for a, b in zip(at_t, back):
        assert torch.equal(a, b)
