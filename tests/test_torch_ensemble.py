"""The port's ensembles against qgcm_tpu's, on the CPU in float64.

The fused step's member axis (ops.qgstep: one call for M members, and
torch.func.vmap folded into it) against a per-member loop of its plain
version; the ensemble runner (models/ensemble.py) on qgcm_tpu's own
perturbed members, handed across as NumPy (torch's generators do not
reproduce jax.random), against qgcm_tpu's make_ensemble_runner and
against the port's single-trajectory runner member by member; and the
port's member generator by its properties. Bars: the member op within
1e-15 max|q| of the loop (batched and single calls of one chain); the
runners within 1e-11 of each field's max of qgcm_tpu's (the bar of the
port's runners against qgcm_tpu's; the interface-displacement integrals,
differences of nearly equal layer integrals, against the domain's area
times the pressure's max, as tests/test_torch_coupled.py holds them) and
at rtol 1e-12 of the port's single runs (qgcm_tpu's own bar,
tests/test_ensemble.py)."""

import jax
import numpy as np
import pytest
import torch

import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_tpu.generators import eddy_pressure as jax_eddy
from qgcm_tpu.generators import zero_forcing as jax_zero_forcing
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models import ensemble as jax_ens
from qgcm_tpu.models.atmos import init_atmos_state as jax_init_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_tpu.models.ocean import ocean_forcing_from_mean as jax_mf
from qgcm_torch.convert import (atmos_state_to_torch, forcing_to_torch,
                                state_to_torch)
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.model import build_model
from qgcm_torch.models import ensemble as ens
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.models.stepper import (make_coupled_runner,
                                       make_ocean_only_runner)
from qgcm_torch.ops import qgstep as qgstep_mod
from qgcm_torch.ops.qgstep import qgstep, qgstep_reference
from qgcm_torch.ops.vorticity import ocqbdy, qcomp

from test_torch_cases import (assert_match, coupled_cfg, numpy_of,
                              one_torch_thread, quick_compile)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

STEPS = 12


def box_cfg(cfgmod, **kw):
    """tests/test_ensemble.py::_box_cfg in `cfgmod`."""
    return cfgmod.ModelConfig(
        nxta=16, nyta=16, nxaooc=8, nyaooc=8, ndxr=3, ocean_only=True,
        cyclic_ocean=False, dta=200.0, nstr=3).replace(**kw).validate()


def _port(cls, nt):
    return cls(numpy_of(nt), "cpu")


def assert_members_match(got, want, model, tol=1e-11):
    """assert_match, with the mass-constraint integrals dpio*/dpia* held
    at tol of area x max|p| (_assert_close of test_torch_coupled.py)."""
    g = model.grids
    p = "po" if hasattr(want, "po") else "pa"
    area = g.xlo * g.ylo if p == "po" else g.xla * g.yla
    big = area * float(np.abs(np.asarray(getattr(want, p))).max())
    assert_match(got, want, tol=tol, scale={
        name: big for name in want._fields if name.startswith("dpi")})


@pytest.fixture
def count_plain(monkeypatch):
    """Calls of the member op's plain version, with their member counts:
    the CPU's stand-in for the kernel's launch counter."""
    calls = []
    plain = qgstep_mod.plain_members

    def counted(pom, *args):
        calls.append(pom.shape[0])
        return plain(pom, *args)

    monkeypatch.setattr(qgstep_mod, "plain_members", counted)
    return calls


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("cyclic,sponge", [(False, False), (True, False),
                                           (True, True)],
                         ids=["box", "cyclic", "cyclic+sponge"])
def test_member_op_matches_a_member_loop(cyclic, sponge, m, count_plain):
    """qgstep on (M, nl, ny, nx) fields, and under torch.func.vmap over
    members (the wind's plane shared, entrainment per member), against
    qgstep_reference member by member; each is one call of the op."""
    g = torch.Generator().manual_seed(7)
    nl, ny, nx = 3, 13, 17

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    fields = [rnd(m, nl, ny, nx) for _ in range(4)]
    if cyclic:
        for f in fields:
            f[..., -1] = f[..., 0]
    wek, ent, r_spl = rnd(ny, nx), rnd(m, ny, nx), rnd(ny, nx)
    consts = tuple((0.2 + torch.rand(11, generator=g,
                                     dtype=torch.float64)).tolist())
    ah2, ah4 = (1.0, 2.0, 3.0), (0.5, 0.7, 0.9)
    kw = dict(cyclic=cyclic, sponge=sponge)
    loop = torch.stack([qgstep_reference(*(f[i] for f in fields), wek,
                                         ent[i], r_spl, consts, ah2, ah4,
                                         **kw) for i in range(m)])
    scale = loop.abs().max()
    with ens.strict_vmap():
        mapped = torch.func.vmap(
            lambda a, b, c, d, e: qgstep(a, b, c, d, wek, e, r_spl, consts,
                                         ah2, ah4, **kw))(*fields, ent)
    direct = qgstep(*fields, wek, ent, r_spl, consts, ah2, ah4, **kw)
    assert count_plain == [m, m]
    for got in (mapped, direct):
        assert got.shape == (m, nl, ny, nx)
        assert (got - loop).abs().max() <= 1e-15 * scale


@pytest.mark.parametrize("how", ["plain", "grad", "vmap", "jvp"])
def test_step_rules_only_where_seen(how, monkeypatch):
    """A call that no transform and no autograd sees goes straight to
    step_members; with an input that requires grad, under vmap or under
    torch.func.jvp it goes through the step's rules (_Step). Each gives
    the plain call's q bit for bit."""
    g = torch.Generator().manual_seed(11)
    nl, ny, nx = 2, 9, 11
    fields = [torch.randn(nl, ny, nx, generator=g, dtype=torch.float64)
              for _ in range(4)]
    wek, ent = (torch.randn(ny, nx, generator=g, dtype=torch.float64)
                for _ in range(2))
    consts, ah = tuple(0.1 * (i + 1) for i in range(11)), (1.0, 2.0)

    def step(pom):
        return qgstep(pom, *fields[1:], wek, ent, None, consts, ah, ah,
                      cyclic=False, sponge=False)

    want = step(fields[0])
    rules = []
    apply = qgstep_mod._Step.apply

    def counted(*args):
        rules.append(args[0].shape)
        return apply(*args)

    monkeypatch.setattr(qgstep_mod._Step, "apply", counted)
    if how == "plain":
        got = step(fields[0])
    elif how == "grad":
        got = step(fields[0].clone().requires_grad_())
        assert got.grad_fn is not None
    elif how == "vmap":
        got = torch.func.vmap(step)(fields[0][None])[0]
    else:
        got = torch.func.jvp(step, (fields[0],),
                             (torch.ones_like(fields[0]),))[0]
    assert bool(rules) == (how != "plain")
    assert torch.equal(got.detach(), want)


@pytest.fixture(scope="module")
def ocean_pair():
    """qgcm_tpu's 3 perturbed members of the box eddy and its forcing,
    and the port's model and members from them."""
    cfg_j = box_cfg(jax_config)
    jm = jax_build_model(cfg_j)
    po = jax_eddy(cfg_j, ssh_amp=0.05, l_efold=3 * cfg_j.ocean.dxo)
    control = jax_init_ocean(jm, po=po)
    f = jax_mf(jm, *jax_zero_forcing(cfg_j))
    members = jax_ens.perturbed_ocean_members(
        jm, control, jax.random.PRNGKey(0), 3, amp=1e-3)
    run = jax_ens.make_ensemble_runner(jm, kind="ocean", jit=False)
    out = quick_compile(jax.jit(run, static_argnames=("n_steps",)),
                        members, f, STEPS)(members, f)
    model = build_model(box_cfg(torch_config), "cpu")
    return (model, _port(state_to_torch, members),
            _port(forcing_to_torch, f), out)


def test_ensemble_runner_matches_jax(ocean_pair, count_plain):
    """12 substeps of the port's ensemble runner on qgcm_tpu's members:
    each field within 1e-11 of its max of qgcm_tpu's ensemble runner,
    and one call of the fused step per substep for the 3 members."""
    model, members, f, want = ocean_pair
    got = ens.make_ensemble_runner(model)(members, f, STEPS)
    assert count_plain == [3] * STEPS
    assert_members_match(got, want, model)


def test_ensemble_runner_matches_single_runs(ocean_pair):
    model, members, f, _ = ocean_pair
    got = ens.make_ensemble_runner(model, kind="ocean")(members, f, STEPS)
    run1 = make_ocean_only_runner(model)
    for i in range(ens.n_members(members)):
        ref = run1(ens.member(members, i), f, STEPS)
        for name, a, b in zip(ref._fields, ens.member(got, i), ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-13, err_msg=name)


def test_coupled_ensemble_matches_jax():
    """2 members of the small coupled box for 2 coupling cycles: ocean
    and atmosphere within 1e-11 of each field's max of qgcm_tpu's
    coupled ensemble runner."""
    cfg_j = coupled_cfg(jax_config)
    jm = jax_build_model(cfg_j)
    ocm = jax_ens.perturbed_ocean_members(
        jm, jax_init_ocean(jm, init="rbal"), jax.random.PRNGKey(3), 2,
        amp=1e-3)
    atm = jax_ens.perturbed_atmos_members(
        jm, jax_init_atmos(jm, init="rbal"), jax.random.PRNGKey(4), 2,
        amp=1e-2)
    n = 2 * cfg_j.nstr
    run = jax_ens.make_ensemble_runner(jm, kind="coupled", jit=False)
    want = quick_compile(jax.jit(run, static_argnames=("n_steps",)),
                         ocm, atm, n)(ocm, atm)
    model = build_model(coupled_cfg(torch_config), "cpu")
    got = ens.make_ensemble_runner(model)(
        _port(state_to_torch, ocm), _port(atmos_state_to_torch, atm), n)
    assert_members_match(got[0], want[0], model)
    assert_members_match(got[1], want[1], model)
    ref = make_coupled_runner(model)(
        ens.member(_port(state_to_torch, ocm), 1),
        ens.member(_port(atmos_state_to_torch, atm), 1), n)
    np.testing.assert_allclose(ens.member(got[0], 1).po.numpy(),
                               ref[0].po.numpy(), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("cyclic", [False, True], ids=["box", "channel"])
def test_port_generator_properties(cyclic):
    """The port's own members: member 0 is the control, the perturbation
    is zero on the solid walls, the channel's duplicate east column is
    the west one bit for bit, the spread is of the asked amplitude, and
    PV is qcomp(p) with the boundary PV of the perturbed pressure."""
    cfg = box_cfg(torch_config, cyclic_ocean=cyclic, nxta=8)
    model = build_model(cfg, "cpu")
    po = eddy_pressure(cfg, ssh_amp=0.05, l_efold=3 * cfg.ocean.dxo)
    if cyclic:
        po[..., -1] = po[..., 0]     # a state of the channel's convention
    control = init_ocean_state(model, po=po)
    amp = 2e-3
    gen = torch.Generator().manual_seed(11)
    members = ens.perturbed_ocean_members(model, control, gen, 4, amp=amp)
    assert ens.n_members(members) == 4
    for a, b in zip(ens.member(members, 0), control):
        assert torch.equal(a, b)
    dp = members.po[1:] - control.po
    assert torch.equal(members.pom[1:] - control.pom, dp)
    rms = dp.square().mean(dim=(1, 2, 3)).sqrt()
    assert bool(((0.1 * amp < rms) & (rms < 3 * amp)).all())
    assert not dp[..., 0, :].any() and not dp[..., -1, :].any()
    if cyclic:
        assert torch.equal(dp[..., -1], dp[..., 0])
        assert torch.equal(members.po[..., -1], members.po[..., 0])
    else:
        assert not dp[..., 0].any() and not dp[..., -1].any()
    assert ens.spread_rms(members, "po") > 0
    assert float(ens.ensemble_std(members).po.max()) > 0
    assert ens.ensemble_mean(members).po.shape == control.po.shape
    dxm2 = 1.0 / model.grids.dxo**2
    for i in range(1, 4):
        p = members.po[i]
        q = qcomp(p, model.amat, model.yporel, dxm2, cfg.fnot, cfg.beta,
                  model.ddyn, cfg.nlo - 1, cyclic=cyclic)
        q = ocqbdy(q, p, model.amat, model.yporel, dxm2, cfg.fnot, cfg.beta,
                   cfg.ocean.bccooc, model.ddyn, cyclic=cyclic)
        assert torch.equal(members.qo[i], q)
    # the same seed gives the same members
    again = ens.perturbed_ocean_members(
        model, control, torch.Generator().manual_seed(11), 4, amp=amp)
    assert torch.equal(again.po, members.po)


def test_operator_without_batching_rule_raises(ocean_pair, monkeypatch):
    """On the ensemble path vmap's member-by-member fallback for an
    operator without a batching rule is an error, not a warning."""
    model, members, f, _ = ocean_pair

    def runner(model):
        def run(state, forcing, n_steps, step0=0):
            return state._replace(po=torch.histc(state.po, bins=4).sum()
                                  + state.po)
        return run

    monkeypatch.setattr(ens, "make_ocean_only_runner", runner)
    with pytest.raises(UserWarning, match=ens.SLOW_VMAP):
        ens.make_ensemble_runner(model)(members, f, 1)


def test_member_meshes_are_not_ported(ocean_pair):
    """Member meshes are ported now: without a process group the member
    mesh is one rank, whose runner steps every member bit for bit as the
    runner without a mesh; qgcm_tpu's divisibility check is kept (the
    multi-rank meshes: tests/test_torch_parallel_driver.py)."""
    model, members, f, _ = ocean_pair
    mesh = ens.ensemble_mesh()
    assert mesh.size == 1
    got = ens.make_ensemble_runner(model, mesh=mesh)(members, f, 2)
    want = ens.make_ensemble_runner(model)(members, f, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mesh.size = 2
    with pytest.raises(ValueError, match="must be a multiple of the "
                       "member-mesh device count"):
        ens.shard_members(members, mesh)
