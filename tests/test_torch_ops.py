"""qgcm_torch operators against qgcm_tpu in float64: stencils, PV from
pressure, the boundary PV and the trapezoidal integral, box and cyclic,
on seeded random fields fed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgcm_tpu.ops import integrals as J_int, stencils as J_st, \
    vorticity as J_vor
from qgcm_torch.ops import integrals as T_int, stencils as T_st, \
    vorticity as T_vor
from qgcm_torch.model import build_model
from qgcm_torch.models.ocean import init_ocean_state, \
    ocean_forcing_from_mean
from qgcm_torch.models.stepper import make_ocean_only_runner
from qgcm_torch.generators import eddy_pressure, double_gyre_windstress

from test_torch_cases import cfg_pair, rel_err

TOL = 1e-13          # relative to max|result|: float64 roundoff only
NL, NY, NX = 3, 19, 26
DXM2 = 1.0 / 20e3**2
BCFAC = 0.2 * DXM2 / (0.5 * 0.2 + 1.0)
FNOT, BETA = 5.92e-5, 2.08e-11


def _fields(seed, n=2, shape=(NL, NY, NX)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _amat():
    return np.array([[2.0, -1.5, 0.0], [-0.7, 1.9, -1.2],
                     [0.0, -0.4, 0.4]]) * 1e-4


@pytest.mark.parametrize("cyclic", [False, True])
def test_del2_bc(cyclic):
    (p,) = _fields(1, 1)
    want = J_st.del2_bc(jnp.asarray(p), BCFAC, DXM2, cyclic)
    got = T_st.del2_bc(torch.from_numpy(p), BCFAC, DXM2, cyclic)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("cyclic", [False, True])
def test_jacobian9(cyclic):
    q, p = _fields(2)
    want = J_st.jacobian9(jnp.asarray(q), jnp.asarray(p), cyclic)
    got = T_st.jacobian9(torch.from_numpy(q), torch.from_numpy(p), cyclic)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("cyclic", [False, True])
@pytest.mark.parametrize("topo", [False, True])
def test_qcomp_and_ocqbdy(cyclic, topo):
    (p,) = _fields(3, 1)
    yprel = np.linspace(-4e5, 4e5, NY)
    ddyn = (_fields(4, 1, (NY, NX))[0] * 1e-6 if topo else np.zeros(()))
    amat = _amat()
    args_j = (jnp.asarray(p), jnp.asarray(amat), jnp.asarray(yprel))
    args_t = (torch.from_numpy(p), torch.from_numpy(amat),
              torch.from_numpy(yprel))
    q_j = J_vor.qcomp(*args_j, DXM2, FNOT, BETA, jnp.asarray(ddyn), NL - 1,
                      cyclic)
    q_t = T_vor.qcomp(*args_t, DXM2, FNOT, BETA, torch.from_numpy(ddyn),
                      NL - 1, cyclic)
    assert rel_err(q_t, q_j) <= TOL
    b_j = J_vor.ocqbdy(q_j, *args_j, DXM2, FNOT, BETA, 0.2,
                       jnp.asarray(ddyn), cyclic)
    b_t = T_vor.ocqbdy(q_t, *args_t, DXM2, FNOT, BETA, 0.2,
                       torch.from_numpy(ddyn), cyclic)
    assert rel_err(b_t, b_j) <= TOL


def test_ocqbdy_rows_win_corners():
    """Box corners carry the S/N row value, not the W/E column value."""
    (p,) = _fields(5, 1)
    yprel = np.linspace(-4e5, 4e5, NY)
    amat = torch.from_numpy(_amat())
    pt = torch.from_numpy(p)
    zero = torch.zeros(())
    q = T_vor.ocqbdy(torch.zeros_like(pt), pt, amat,
                     torch.from_numpy(yprel), DXM2, FNOT, BETA, 0.2, zero,
                     cyclic=False)
    bcf = 0.2 * DXM2 / (0.5 * 0.2 + 1.0) / FNOT
    south = bcf * (pt[:, 1, :] - pt[:, 0, :]) \
        - FNOT * torch.einsum("kl,lx->kx", amat, pt[:, 0, :]) \
        + BETA * yprel[0]
    assert rel_err(q[:, 0, :], south) <= TOL
    west = bcf * (pt[:, 0, 1] - pt[:, 0, 0]) \
        - FNOT * torch.einsum("kl,l->k", amat, pt[:, 0, 0]) \
        + BETA * yprel[0]
    assert rel_err(q[:, 0, 0], west) > 1e-3


def test_xintp():
    (f,) = _fields(6, 1)
    want = J_int.xintp(jnp.asarray(f))
    assert rel_err(T_int.xintp(torch.from_numpy(f)), want) <= TOL
    w = T_int.xintp_weights(NY, NX)
    assert np.array_equal(w, J_int.xintp_weights(NY, NX))
    np.testing.assert_allclose(T_int.xintp(torch.from_numpy(f)).numpy(),
                               (f * w).sum(axis=(-2, -1)), rtol=1e-13)


def test_xintt():
    """The plain T-grid sum against qgcm_tpu's, on seeded fields with a
    leading layer axis, and its export from the ops package as
    qgcm_tpu's ops/__init__.py exports it."""
    import qgcm_torch.ops
    f = np.random.default_rng(11).standard_normal((3, NY - 1, NX - 1))
    want = J_int.xintt(jnp.asarray(f))
    got = qgcm_torch.ops.xintt(torch.from_numpy(f))
    assert got.shape == want.shape == (3,)
    assert rel_err(got, want) <= TOL
    assert qgcm_torch.ops.xintt is T_int.xintt


def test_qcomp_inversion_round_trip():
    """After port substeps, qcomp(po) reproduces the interior of qo:
    the box inversion is exact up to float64 roundoff (the bar of
    tools/verify_drive.py)."""
    _, cfg = cfg_pair("pallas", nlo=3)
    model = build_model(cfg, "cpu")
    st = init_ocean_state(model, po=eddy_pressure(cfg))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    st = make_ocean_only_runner(model)(st, f, 30)
    q = T_vor.qcomp(st.po, model.amat, model.yporel,
                    1.0 / model.grids.dxo**2, cfg.fnot, cfg.beta,
                    model.ddyn, cfg.nlo - 1, cyclic=False)
    err = ((st.qo - q)[:, 1:-1, 1:-1].abs().max()
           / st.qo.abs().max()).item()
    assert err < 1e-12, err
