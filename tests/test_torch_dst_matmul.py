"""The GEMM DST (solver_transform='matmul') of the port against qgcm_tpu's
on the CPU, in float64.

Both packages' split threshold _MM_SPLIT_MIN is set to 4 (monkeypatch,
as tests/test_ocean_step.py:173-194 does for qgcm_tpu), so that the small
grids here recurse through several split levels. The packed permutation
equals qgcm_tpu's; the packed DST and its inverse match qgcm_tpu's
_dst1_mm_packed / _idst1_mm_packed at 1e-13 of max on both axes; the box
and channel solves and their permuted vectors match qgcm_tpu's 'matmul'
solvers; 24-substep float64 trajectories (box, channel, and a coupled
box whose channel atmosphere takes the GEMM y-DST too) match qgcm_tpu's
'matmul' runs at 1e-10 of max (qgcm_tpu's box takes its blocks branch of
_ocinvq there, which the port leaves out: same values, another order of
the Parseval sum); the float64 ocean_sensitivity matches qgcm_tpu's at
1e-9. solver_precision='high' is the plain torch.matmul on the CPU, so
it equals 'highest' there bit for bit, through the wrapper's vmap and
autograd rules too (the ensemble runner, a gradient).
"""

import jax
import numpy as np
import pytest
import torch

import qgcm_tpu.solver.helmholtz as J_h
import qgcm_torch.solver.helmholtz as T_h
from qgcm_tpu.adjoint import layer1_energy_proxy as jax_energy
from qgcm_tpu.adjoint import ocean_sensitivity as jax_sensitivity
from qgcm_tpu.generators import double_gyre_windstress, eddy_pressure
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.atmos import init_atmos_state as jax_init_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_tpu.models.ocean import ocean_forcing_from_mean as jax_mf
from qgcm_tpu.models.stepper import make_coupled_runner as jax_coupled
from qgcm_tpu.models.stepper import make_ocean_only_runner as jax_ocean
import qgcm_torch.config as torch_config
from qgcm_torch.adjoint import layer1_energy_proxy, ocean_sensitivity
from qgcm_torch.convert import (atmos_state_to_torch, forcing_to_torch,
                                sensitivity_to_torch, state_to_torch)
from qgcm_torch.generators import double_gyre_windstress as t_windstress
from qgcm_torch.generators import eddy_pressure as t_eddy
from qgcm_torch.model import build_model
from qgcm_torch.models import ensemble as ens
from qgcm_torch.models.ocean import init_ocean_state as t_init_ocean
from qgcm_torch.models.ocean import ocean_forcing_from_mean as t_mf
from qgcm_torch.models.stepper import (make_coupled_runner,
                                       make_ocean_only_runner)
from qgcm_torch.ops import gemm

from test_adjoint import _setup as jax_adjoint_setup
from test_torch_cases import (cfg_pair, coupled_pair, numpy_of,
                              one_torch_thread, quick_compile, rel_err)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

PREC = jax.lax.Precision.HIGHEST
STEPS = 24
RDM2 = np.array([0.0, 2.5e-9, 9.0e-9])


@pytest.fixture
def split4(monkeypatch):
    monkeypatch.setattr(J_h, "_MM_SPLIT_MIN", 4)
    monkeypatch.setattr(T_h, "_MM_SPLIT_MIN", 4)


@pytest.mark.parametrize("n", [7, 12, 15, 31])
def test_packed_transforms_match_qgcm_tpu(n, split4):
    """_split_perm, _split_sizes and the packed forward and inverse DST
    on axes -1 and -2 against qgcm_tpu's (float64, 1e-13 of max); the
    inverse undoes the forward up to 2(n+1); in float32 'high' (the
    wrapper's plain version on the CPU) equals 'highest' bit for bit."""
    assert np.array_equal(T_h._split_perm(n), J_h._split_perm(n))
    assert T_h._split_sizes(n) == J_h._split_sizes(n)
    rng = np.random.default_rng(n)
    dst = T_h.PackedDST(n, torch.float64, "cpu")
    assert len(dst.levels) == len(J_h._split_sizes(n)) - 1
    for dim, shape in ((-1, (3, 5, n)), (-2, (3, n, 6))):
        x = rng.standard_normal(shape)
        xt = torch.from_numpy(x)
        fwd = dst.forward(xt, dim)
        assert rel_err(fwd, J_h._dst1_mm_packed(x, dim, PREC)) <= 1e-13
        assert rel_err(dst.inverse(xt, dim),
                       J_h._idst1_mm_packed(x, dim, PREC)) <= 1e-13
        # natural order: the packed spectrum un-permuted is dst1's
        nat = torch.empty_like(fwd).index_copy_(
            dim % 3, torch.from_numpy(T_h._split_perm(n)), fwd)
        assert rel_err(nat, T_h.dst1(xt, dim)) <= 1e-13
        assert rel_err(dst.inverse(fwd, dim) / (2 * (n + 1)), x) <= 1e-13
        x32 = xt.float()
        hi, hst = (T_h.PackedDST(n, torch.float32, "cpu", p)
                   for p in ("high", "highest"))
        assert torch.equal(hi.forward(x32, dim), hst.forward(x32, dim))
        assert torch.equal(hi.inverse(x32, dim), hst.inverse(x32, dim))


@pytest.mark.parametrize("kind,nxp,nyp", [("box", 33, 17),
                                          ("channel", 25, 33)])
def test_matmul_solve_matches_qgcm_tpu(kind, nxp, nyp, split4):
    """A 'matmul' solve (float64) against qgcm_tpu's 'matmul' solve and
    the port's FFT solve at 1e-12 of max; its permuted vectors are
    qgcm_tpu's bit for bit; solve_np refuses the packed order."""
    rng = np.random.default_rng(nxp + nyp)
    rhs = rng.standard_normal((3, nyp, nxp))
    if kind == "box":
        jh = J_h.make_box_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                    transform="matmul")
        th = T_h.make_box_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                    device="cpu", transform="matmul")
        fft = T_h.make_box_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                     device="cpu")
        names = ("lamx", "lamy", "gx", "gy")
    else:
        rhs[..., -1] = rhs[..., 0]
        jh = J_h.make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                       ytransform="matmul")
        th = T_h.make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                       device="cpu", ytransform="matmul")
        fft = T_h.make_cyclic_helmholtz(nxp, nyp, 20e3, 20e3, RDM2,
                                        device="cpu")
        names = ("lamx", "lamy")
    for name in names:
        assert np.array_equal(getattr(th, name).numpy(),
                              np.asarray(getattr(jh, name))), name
    got = th.solve(torch.from_numpy(rhs))
    assert rel_err(got, np.asarray(jh.solve(rhs))) <= 1e-12
    assert rel_err(got, fft.solve(torch.from_numpy(rhs))) <= 1e-12
    if kind == "channel":
        assert torch.equal(got[..., -1], got[..., 0])
    with pytest.raises(ValueError):
        th.solve_np(rhs)


def _ocean_start(jm, cfg):
    """qgcm_tpu's eddy state under the double-gyre wind, and the same
    arrays as the port's tensors."""
    st = jax_init_ocean(jm, po=eddy_pressure(cfg))
    f = jax_mf(jm, *double_gyre_windstress(cfg, jm.grids))
    return st, f, (state_to_torch(numpy_of(st), "cpu"),
                   forcing_to_torch(numpy_of(f), "cpu"))


@pytest.mark.parametrize("case", ["box", "channel", "coupled"])
def test_matmul_trajectory_matches_qgcm_tpu(case, split4):
    """24 float64 ocean substeps under solver_transform='matmul' (the
    coupled box: 24 coupling cycles' substeps, its atmosphere's channel
    on the GEMM y-DST too): po, qo and sst within 1e-10 of each field's
    max of qgcm_tpu's 'matmul' run."""
    if case == "coupled":
        cfg_j, cfg_t = coupled_pair("box", solver_transform="matmul")
    else:
        cfg_j, cfg_t = (c.replace(solver_transform="matmul")
                        for c in cfg_pair("pallas", nlo=3,
                                          cyclic=case == "channel"))
    jm = jax_build_model(cfg_j)
    model = build_model(cfg_t, "cpu")
    helm = model.inv_oc.helm
    assert (helm.ty if case == "channel" else helm.tx) is not None
    if case == "coupled":
        assert model.inv_at.helm.ty is not None
        oc = jax_init_ocean(jm, init="rbal", po=eddy_pressure(cfg_j))
        at = jax_init_atmos(jm, init="rbal")
        n = STEPS * cfg_j.nstr
        fn = jax.jit(jax_coupled(jm, jit=False), static_argnames=("n_steps",))
        want = quick_compile(fn, oc, at, n)(oc, at)[0]
        got = make_coupled_runner(model)(
            state_to_torch(numpy_of(oc), "cpu"),
            atmos_state_to_torch(numpy_of(at), "cpu"), n)[0]
    else:
        st, f, (st_t, f_t) = _ocean_start(jm, cfg_j)
        fn = jax.jit(jax_ocean(jm, jit=False), static_argnames=("n_steps",))
        want = quick_compile(fn, st, f, STEPS)(st, f)
        got = make_ocean_only_runner(model)(st_t, f_t, STEPS)
    for name in ("po", "qo", "sst"):
        assert rel_err(getattr(got, name),
                       np.asarray(getattr(want, name))) <= 1e-10, name


def test_matmul_sensitivity_matches_qgcm_tpu(split4):
    """The float64 box adjoint (tests/test_adjoint.py's setup, 30
    substeps) under 'matmul': the value and every gradient field within
    1e-9 of each field's max of qgcm_tpu's 'matmul' adjoint."""
    jm0, jst, jmf = jax_adjoint_setup(False)
    jm = jax_build_model(jm0.cfg.replace(solver_transform="matmul"))
    fn = jax.jit(jax_sensitivity(jm, jax_energy(jm), remat=False, jit=False),
                 static_argnames=("n_steps",))
    jval, jg = quick_compile(fn, jst, jmf, 30)(jst, jmf)
    want = sensitivity_to_torch(
        {"state0": numpy_of(jg.state0),
         "forcing": [np.asarray(a) for a in jg.forcing]}, "cpu")
    oc = torch_config.OceanConfig(nlo=2, dxo=20e3, delek=2.0,
                                  hoc=(800.0, 3200.0), gpoc=(0.01,),
                                  tabsoc=(287.0, 282.0), ah2oc=(0.0, 0.0),
                                  ah4oc=(1e10, 1e10))
    cfg = torch_config.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2, fnot=5.92e-5,
        beta=2.08e-11, dta=150.0, ocean=oc, ocean_only=True,
        solver_transform="matmul").validate()
    model = build_model(cfg, "cpu")
    val, got = ocean_sensitivity(model, layer1_energy_proxy(model))(
        state_to_torch(numpy_of(jst), "cpu"),
        tuple(np.asarray(a) for a in jmf), 30)
    assert abs(float(val) - float(jval)) <= 1e-9 * abs(float(jval))
    for a, b in zip((*got.state0, *got.forcing),
                    (*want.state0, *want.forcing)):
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max())


@pytest.mark.parametrize("dim", [-1, -2])
def test_gemm_wrapper_rules(dim, monkeypatch):
    """ops.gemm.contract on a CPU tensor: the plain product, launching
    nothing; its vmap rule folds the mapped axis into one call; its
    gradient and forward-mode tangent are the plain product's; float64
    (field or constant) and a mismatched axis are refused."""
    rng = np.random.default_rng(-dim)
    x = torch.from_numpy(rng.standard_normal((4, 3, 9, 9))).float()
    K = torch.from_numpy(rng.standard_normal((9, 7))).float()
    C = gemm.Constant(K)
    calls = []
    apply = gemm._apply
    monkeypatch.setattr(gemm, "_apply",
                        lambda *a: calls.append(a[0].shape) or apply(*a))
    gemm.reset_launches()
    want = gemm.plain(x, K, dim)
    assert torch.equal(gemm.contract(x, C, dim), want)
    got = torch.func.vmap(lambda t: gemm.contract(t, C, dim))(x)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    assert calls[-1] == (12, 9, 9)          # one call for the 4 members
    w = torch.from_numpy(rng.standard_normal(tuple(want.shape))).float()
    grads = []
    for fn, k in ((gemm.contract, C), (gemm.plain, K)):
        xg = x.clone().requires_grad_()
        (fn(xg, k, dim) * w).sum().backward()
        grads.append(xg.grad)
    assert torch.allclose(*grads, rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(rng.standard_normal(tuple(x.shape))).float()
    tan = torch.func.jvp(lambda v: gemm.contract(v, C, dim), (x,), (t,))[1]
    assert torch.allclose(tan, gemm.plain(t, K, dim), rtol=1e-6, atol=1e-6)
    assert gemm.contract.launches == 0
    with pytest.raises(TypeError):
        gemm.contract(x.double(), C, dim)
    with pytest.raises(TypeError):
        gemm.Constant(K.double())
    with pytest.raises(ValueError):
        gemm.contract(x, gemm.Constant(K[:8]), dim)


def test_high_ensemble_equals_highest(split4):
    """Two float32 members of the box for 4 substeps through the ensemble
    runner (vmap over members, the wrapper's rule at 'high'): 'high'
    equals 'highest' on the CPU bit for bit, member by member."""
    _, cfg = cfg_pair("pallas", nlo=2, dtype="float32")
    runs = []
    for prec in ("highest", "high"):
        model = build_model(cfg.replace(solver_transform="matmul",
                                        solver_precision=prec), "cpu")
        base = t_init_ocean(model, po=t_eddy(cfg))
        members = ens.stack_members([base, base._replace(
            po=base.po * 1.001, pom=base.pom * 1.001)])
        f = t_mf(model, *t_windstress(cfg, model.grids))
        runs.append(ens.make_ensemble_runner(model)(members, f, 4))
    for name, a, b in zip(runs[0]._fields, *runs):
        assert torch.equal(a, b), name
