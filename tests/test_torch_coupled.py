"""The coupled slice as a whole on the CPU: the golden coupled run
(tests/test_golden.py::test_golden_coupled) through the port's runner,
30-step coupled runs of the box and of the cyclic channel and a 30-step
atmosphere-only run against qgcm_tpu (float64, rel 1e-9 of each field's
max), one float32 coupling cycle (1e-5), and the runners' cadence
rules."""

import numpy as np
import pytest
import torch

from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.atmos import init_atmos_state as jax_init_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_tpu.models.stepper import make_atmos_only_runner as jax_atmos_only
from qgcm_tpu.models.stepper import make_coupled_runner as jax_coupled
from qgcm_torch.convert import atmos_state_to_torch, state_to_torch
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.models.stepper import (make_atmos_only_runner,
                                       make_coupled_runner)
from qgcm_torch.ops.qgstep import qgstep

from test_torch_cases import (coupled_pair, numpy_of, one_torch_thread,
                              rel_err)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

GOLDEN = dict(pa_l1=4494126.575996573, pa_max=10034.029753613597,
              ast_l1=3013.375749852249, hmixa_sum=287999.9999953847,
              po_l1=8.576337767308004, sst_l1=7884.8790379866205)


def test_golden_coupled():
    """30 atmosphere steps (10 coupling cycles, the averagings of step
    and cycle 0 included) of the small coupled box from the radiative
    balance reproduce qgcm_tpu's golden numbers at rel 1e-9."""
    _, cfg = coupled_pair("box")
    model = build_model(cfg, "cpu")
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    n0 = qgstep.launches
    oc, at = make_coupled_runner(model)(oc, at, 30)
    assert qgstep.launches == n0, "CPU tensors must not launch the kernel"
    got = dict(pa_l1=float(at.pa.abs().sum()), pa_max=float(at.pa.max()),
               ast_l1=float(at.ast.abs().sum()),
               hmixa_sum=float(at.hmixa.sum()),
               po_l1=float(oc.po.abs().sum()),
               sst_l1=float(oc.sst.abs().sum()))
    for k, v in GOLDEN.items():
        assert got[k] == pytest.approx(v, rel=1e-9), (k, got)


def _start(jm, cfg):
    """The same start in both packages: an eddy in the ocean under the
    radiative-balance atmosphere (JAX's state, and its arrays as the
    port's tensors)."""
    oc = jax_init_ocean(jm, init="rbal", po=eddy_pressure(cfg))
    at = jax_init_atmos(jm, init="rbal")
    dt = getattr(torch, cfg.dtype)
    return (oc, at, state_to_torch(numpy_of(oc), "cpu", dt),
            atmos_state_to_torch(numpy_of(at), "cpu", dt))


def _assert_close(got_nts, want_nts, tol, model):
    """Every field at `tol` of its max; the interface-displacement
    integrals, differences of nearly equal layer integrals, at `tol` of
    the domain's area times the layer pressure's max."""
    g = model.grids
    for got, want in zip(got_nts, want_nts):
        want = numpy_of(want)
        for name, arr in numpy_of(got).items():
            assert arr.dtype == want[name].dtype, name
            if name.startswith("dpio"):
                scale = g.xlo * g.ylo * np.abs(want["po"]).max()
            elif name.startswith("dpia"):
                scale = g.xla * g.yla * np.abs(want["pa"]).max()
            else:
                assert rel_err(arr, want[name]) <= tol, name
                continue
            assert np.abs(arr - want[name]).max() <= tol * scale, name


@pytest.mark.parametrize("kind,over", [("box", {}),
                                       ("channel", dict(tau_udiff=True))],
                         ids=["box", "channel-tau_udiff"])
def test_coupled_run_matches_jax(kind, over):
    cfg_j, cfg_t = coupled_pair(kind, **over)
    jm = jax_build_model(cfg_j)
    oc, at, oc_t, at_t = _start(jm, cfg_t)
    want = jax_coupled(jm)(oc, at, 30)
    model = build_model(cfg_t, "cpu")
    got = make_coupled_runner(model)(oc_t, at_t, 30)
    _assert_close(got, want, 1e-9, model)


def test_one_float32_cycle_matches_jax():
    """One coupling cycle (xforc, an ocean substep, three atmosphere
    steps) in float32 with the float64 mixed layers, at 1e-5 of each
    field's max: the float32 FFTs and sums of the two packages round
    differently by a few ulp."""
    cfg_j, cfg_t = coupled_pair("box", dtype="float32")
    jm = jax_build_model(cfg_j)
    oc, at, oc_t, at_t = _start(jm, cfg_t)
    want = jax_coupled(jm)(oc, at, 3, step0=3)
    model = build_model(cfg_t, "cpu")
    got = make_coupled_runner(model)(oc_t, at_t, 3, step0=3)
    _assert_close(got, want, 1e-5, model)


def test_atmos_only_run_matches_jax():
    """30 steps of the atmosphere over a prescribed, seeded SST."""
    cfg_j, cfg_t = coupled_pair("box", atmos_only=True)
    jm = jax_build_model(cfg_j)
    at = jax_init_atmos(jm, init="rbal")
    rng = np.random.default_rng(2)
    sst = (jm.rad.sstbar[:, None]
           + rng.standard_normal((cfg_t.nyto, cfg_t.nxto)))
    want = jax_atmos_only(jm)(at, sst, 30)
    model = build_model(cfg_t, "cpu")
    assert model.inv_oc is None and model.coupling is not None
    got = make_atmos_only_runner(model)(
        atmos_state_to_torch(numpy_of(at), "cpu"), sst, 30)
    _assert_close([got], [want], 1e-9, model)


def test_coupled_runner_cadence():
    """Chunks aligned by step0 reproduce the whole run bit for bit; a
    run or a start that is not a whole number of cycles is refused."""
    _, cfg = coupled_pair("box")
    model = build_model(cfg, "cpu")
    run = make_coupled_runner(model)
    oc0 = init_ocean_state(model, po=eddy_pressure(cfg))
    at0 = init_atmos_state(model)
    whole = run(oc0, at0, 12)
    half = run(oc0, at0, 6)
    chunked = run(*half, 6, step0=6)
    for a, b in zip((*whole[0], *whole[1]), (*chunked[0], *chunked[1])):
        assert torch.equal(a, b)
    for n, s0 in ((4, 0), (6, 2)):
        with pytest.raises(ValueError):
            run(oc0, at0, n, step0=s0)
    with pytest.raises(ValueError):
        make_atmos_only_runner(build_model(
            cfg.replace(ocean_only=False, atmos_only=True), "cpu"))(
            at0, model.rad.sstbar[:, None] + np.zeros((1, cfg.nxto)), 5)
