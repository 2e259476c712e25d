"""The port's adjoint sensitivities (qgcm_torch/adjoint.py) against
qgcm_tpu's and against finite differences, on the CPU in float64.

On the _setup grids of tests/test_adjoint.py (box and channel, 48x24,
2 layers): the value and every gradient field of ocean_sensitivity
within 1e-9 of each field's max of qgcm_tpu's (30 substeps); the
directional derivative along the wind stress against a central finite
difference at rel 1e-6 (qgcm_tpu's bar); reverse against forward mode
(torch.func.jvp) at 1e-9 (qgcm_tpu's bar); remat True, "dots" and 3
and host-level segments equal to the stored gradient at 1e-12 of each
field's max (the same arithmetic recomputed, qgcm_tpu's bar); the
coupled runner with remat against a finite difference at rel 1e-5
(qgcm_tpu's bar); the fused step's gradient rule against
torch.autograd.gradcheck; and a mesh without a halo variant refused."""

import jax
import numpy as np
import pytest
import torch

from qgcm_tpu.adjoint import layer1_energy_proxy as jax_energy
from qgcm_tpu.adjoint import ocean_sensitivity as jax_sensitivity
from qgcm_tpu.adjoint import transport_proxy as jax_transport
import qgcm_torch.config as torch_config
from qgcm_torch.adjoint import (layer1_energy_proxy, ocean_sensitivity,
                                transport_proxy)
from qgcm_torch.convert import sensitivity_to_torch, state_to_torch
from qgcm_torch.generators import (channel_windstress,
                                   double_gyre_windstress, eddy_pressure)
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state, ocean_forcing_from_mean
from qgcm_torch.models.stepper import (make_coupled_runner,
                                       make_ocean_only_runner)
from qgcm_torch.ops.qgstep import qgstep

from test_adjoint import _setup as jax_setup
from test_torch_cases import (coupled_cfg, numpy_of, one_torch_thread,
                              quick_compile)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STEPS = 30


def setup(cyclic):
    """tests/test_adjoint.py::_setup in the port: model, eddy state and
    the mean wind (double gyre in the box, channel stress)."""
    oc = torch_config.OceanConfig(nlo=2, dxo=20e3, delek=2.0,
                                  hoc=(800.0, 3200.0), gpoc=(0.01,),
                                  tabsoc=(287.0, 282.0), ah2oc=(0.0, 0.0),
                                  ah4oc=(1e10, 1e10))
    cfg = torch_config.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2, fnot=5.92e-5,
        beta=2.08e-11, dta=150.0, ocean=oc, ocean_only=True,
        cyclic_ocean=cyclic).validate()
    model = build_model(cfg, "cpu")
    st0 = init_ocean_state(model, po=eddy_pressure(cfg))
    gen = channel_windstress if cyclic else double_gyre_windstress
    return model, st0, tuple(torch.as_tensor(a) for a in gen(cfg,
                                                             model.grids))


def objective(model):
    return (transport_proxy if model.cfg.cyclic_ocean
            else layer1_energy_proxy)(model)


def assert_grads(got, want, tol):
    """Every gradient field within tol of its max (exactly zero where
    the reference is)."""
    for name, a, b in zip(got.state0._fields, got.state0, want.state0):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, name
    for i, (a, b) in enumerate(zip(got.forcing, want.forcing)):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), i


@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "channel"])
def test_sensitivity_matches_jax(cyclic):
    jm, jst, jmf = jax_setup(cyclic)
    jobj = (jax_transport if cyclic else jax_energy)(jm)
    fn = jax.jit(jax_sensitivity(jm, jobj, remat=False, jit=False),
                 static_argnames=("n_steps",))
    jval, jg = quick_compile(fn, jst, jmf, STEPS)(jst, jmf)
    want = sensitivity_to_torch(
        {"state0": numpy_of(jg.state0),
         "forcing": [np.asarray(a) for a in jg.forcing]}, "cpu")
    model, _, _ = setup(cyclic)
    st0 = state_to_torch(numpy_of(jst), "cpu")
    val, got = ocean_sensitivity(model, objective(model))(
        st0, tuple(np.asarray(a) for a in jmf), STEPS)
    assert abs(float(val) - float(jval)) <= 1e-9 * abs(float(jval))
    assert_grads(got, want, 1e-9)


@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "channel"])
def test_directional_derivative_matches_finite_difference(cyclic):
    """d/da L(a tau) at a = 1 from the adjoint's tauxo field against the
    central difference of the primal (the channel's gradient runs
    through the momentum-constraint algebra and txis/txin)."""
    model, st0, (tauxo, tauyo, fnetoc) = setup(cyclic)
    obj = objective(model)
    _, g = ocean_sensitivity(model, obj)(st0, (tauxo, tauyo, fnetoc), STEPS)
    directional = float((g.forcing[0] * tauxo).sum())
    run = make_ocean_only_runner(model)

    def primal(a):
        f = ocean_forcing_from_mean(model, a * tauxo, tauyo, fnetoc)
        return float(obj(run(st0, f, STEPS)))

    eps = 1e-3
    fd = (primal(1.0 + eps) - primal(1.0 - eps)) / (2 * eps)
    assert fd != 0.0
    assert abs(directional - fd) < 1e-6 * abs(fd), (directional, fd)
    assert all(bool(torch.isfinite(a).all()) for a in g.forcing)


def test_reverse_mode_matches_forward_mode():
    """The reverse-mode gradient of the initial state against
    torch.func.jvp through the same run, along a random pressure
    perturbation of both time levels."""
    model, st0, mf = setup(False)
    obj = layer1_energy_proxy(model)
    _, g = ocean_sensitivity(model, obj, remat=False)(st0, mf, STEPS)
    gen = torch.Generator().manual_seed(0)
    dpo = 1e-3 * torch.randn(st0.po.shape, generator=gen,
                             dtype=torch.float64)
    tangent = type(st0)(*(torch.zeros_like(t) for t in st0))._replace(
        po=dpo, pom=dpo)
    f = ocean_forcing_from_mean(model, *mf)
    run = make_ocean_only_runner(model)
    _, jvp = torch.func.jvp(lambda s: obj(run(s, f, STEPS)), (st0,),
                            (tangent,))
    vjp = sum(float((a * b).sum()) for a, b in zip(g.state0, tangent))
    assert abs(float(jvp) - vjp) < 1e-9 * abs(float(jvp))


@pytest.fixture(scope="module")
def stored():
    """The box's gradient over 50 substeps with every step stored."""
    model, st0, mf = setup(False)
    obj = layer1_energy_proxy(model)
    return model, st0, mf, ocean_sensitivity(model, obj, remat=False)(
        st0, mf, 50)


@pytest.mark.parametrize("remat", [True, "dots", 3])
def test_remat_gradient_equals_stored_gradient(stored, remat):
    """Checkpointed pairs of substeps (True), with the products and FFTs
    kept ("dots"), and nested in levels of 3 (25 pairs: three levels)."""
    model, st0, mf, (v0, g0) = stored
    v, g = ocean_sensitivity(model, layer1_energy_proxy(model),
                             remat=remat)(st0, mf, 50)
    assert float(v) == float(v0)
    assert_grads(g, g0, 1e-12)


def test_segmented_adjoint_equals_one_program(stored):
    model, st0, mf, (v0, g0) = stored
    obj = layer1_energy_proxy(model)
    v, g = ocean_sensitivity(model, obj, segment_steps=10)(st0, mf, 50)
    assert abs(float(v) - float(v0)) <= 1e-12 * abs(float(v0))
    assert_grads(g, g0, 1e-12)
    with pytest.raises(ValueError, match="multiple"):
        ocean_sensitivity(model, obj, segment_steps=15)(st0, mf, 50)


def test_distributed_adjoint_is_not_ported(stored):
    """qgcm_tpu's GSPMD form of the distributed adjoint (a mesh without
    halo_variant) has no PyTorch counterpart: the port takes 'overlap'
    there, the same program, so on a one-rank mesh its value and
    gradients are those of halo_variant='overlap' bit for bit; the
    distributed adjoint on ranks is tests/test_torch_parallel_adjoint.py's."""
    from qgcm_torch.parallel.mesh import make_mesh, shard_tree
    model, st0, mf = stored[:3]
    obj = layer1_energy_proxy(model)
    mesh = make_mesh(rows_only=True, grid=(model.cfg.nypo, model.cfg.nxpo))
    got, want = (ocean_sensitivity(model, obj, mesh=mesh, halo_variant=h)(
        shard_tree(st0, mesh), mf, 4) for h in (None, "overlap"))
    assert torch.equal(got[0], want[0])
    for a, b in zip((*got[1].state0, *got[1].forcing),
                    (*want[1].state0, *want[1].forcing)):
        assert torch.equal(a, b)


def test_coupled_runner_differentiates_with_remat():
    """d(mean square of the final atmospheric mixed-layer temperature)/
    d(initial SST) through 4 checkpointed coupling cycles (xforc and
    both fluids) against a central finite difference along a random
    direction (tests/test_adjoint.py's coupled case)."""
    cfg = coupled_cfg(torch_config)
    model = build_model(cfg, "cpu")
    oc0 = init_ocean_state(model, po=eddy_pressure(cfg))
    at0 = init_atmos_state(model, init="rbal")
    run = make_coupled_runner(model, remat=True)
    n = 4 * cfg.nstr

    def loss(sst):
        _, at = run(oc0._replace(sst=sst, sstm=sst), at0, n)
        return torch.mean(torch.square(at.ast))

    sst = oc0.sst.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(sst), sst)
    assert bool(torch.isfinite(g).all())
    gen = torch.Generator().manual_seed(1)
    dsst = 1e-2 * torch.randn(sst.shape, generator=gen, dtype=sst.dtype)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(oc0.sst + eps * dsst))
              - float(loss(oc0.sst - eps * dsst))) / (2 * eps)
    assert fd != 0.0
    assert abs(float((g * dsst).sum()) - fd) <= 1e-5 * abs(fd)


@pytest.mark.parametrize("cyclic,sponge", [(False, False), (True, True)],
                         ids=["box", "cyclic+sponge"])
def test_fused_step_gradient_rule(cyclic, sponge):
    """The fused step's backward (the plain chain's VJP, recomputed)
    against finite differences of the step on a 2x12x12 grid, every
    input, along random directions (gradcheck's fast mode), one member
    and two."""
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    consts = tuple((0.2 + torch.rand(11, generator=gen,
                                     dtype=torch.float64)).tolist())
    for m in ((), (2,)):
        args = [rnd(*m, 2, 12, 12) for _ in range(4)] + [
            rnd(12, 12), rnd(*m, 12, 12), rnd(12, 12) if sponge else None]
        inputs = tuple(a for a in args if a is not None)

        def fn(*xs):
            it = iter(xs)
            full = [next(it) if a is not None else None for a in args]
            return qgstep(*full, consts, (1.0, 2.0), (0.5, 0.7),
                          cyclic=cyclic, sponge=sponge)

        assert torch.autograd.gradcheck(fn, inputs, fast_mode=True)
