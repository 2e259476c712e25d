"""The ported air-sea coupling (xforc) against qgcm_tpu on the CPU:
the host-side coupling arrays, the bicubic refinement, and every output
of xforc with tau_udiff off and on over the box and the cyclic ocean,
all in float64 from the same seeded states; then the float32 coupled
step's dtype purity (tests/test_coupling.py:146) in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgcm_tpu.coupling import bicubic_refine_uv as jax_refine
from qgcm_tpu.coupling import make_xforc as jax_make_xforc
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.atmos import init_atmos_state as jax_init_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_torch.convert import atmos_state_to_torch, state_to_torch
from qgcm_torch.coupling import bicubic_refine_uv, make_xforc
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state, make_atmos_step
from qgcm_torch.models.ocean import init_ocean_state, make_ocean_step

from test_torch_cases import (coupled_pair, numpy_of, one_torch_thread,
                              rel_err)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

TOL = 1e-12


def test_build_coupling_matches_jax():
    """Weights, bilinear indices and profiles as qgcm_tpu builds them
    (separable bicubic factors up to the SVD's sign per rank term:
    compared through the weight tensor they rebuild)."""
    cfg_j, cfg_t = coupled_pair("box")
    cj = jax_build_model(cfg_j).coupling
    ct = build_model(cfg_t, "cpu").coupling
    for name in ("bil_ix_m", "bil_ix_p", "bil_jy_m", "bil_jy_p"):
        assert np.array_equal(getattr(ct, name).numpy(),
                              np.asarray(getattr(cj, name))), name
    for name in ("bil_wx_p", "bil_wy_p", "fsp_oc", "fsp_at"):
        assert rel_err(getattr(ct, name), getattr(cj, name)) <= TOL, name
    for name in ("w_bbb", "w_us", "w_un", "w_vs", "w_vn"):
        (wy_t, wx_t), (wy_j, wx_j) = getattr(ct, name), getattr(cj, name)
        full_t = torch.einsum("djr,rai->daij", wy_t, wx_t)
        full_j = np.einsum("djr,rai->daij", wy_j, wx_j)
        assert rel_err(full_t, full_j) <= TOL, name


@pytest.fixture(scope="module")
def box_models():
    cfg_j, cfg_t = coupled_pair("box")
    return jax_build_model(cfg_j), build_model(cfg_t, "cpu")


def test_bicubic_refine_matches_jax_and_interpolates(box_models):
    """On seeded cyclic coarse velocities: the fine fields match
    qgcm_tpu, pass through the coarse data at every shared point, and
    keep the cyclic duplicate column."""
    jm, tm = box_models
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    u, v = (rng.standard_normal((cfg.nypa, cfg.nxpa)) for _ in range(2))
    u[:, -1], v[:, -1] = u[:, 0], v[:, 0]
    want = jax_refine(jm.coupling, jnp.asarray(u), jnp.asarray(v), cfg.ndxr)
    got = bicubic_refine_uv(tm.coupling, torch.from_numpy(u),
                            torch.from_numpy(v), cfg.ndxr)
    nd = cfg.ndxr
    for g, w, coarse in zip(got, want, (u, v)):
        assert g.shape == (cfg.nypaor, cfg.nxpaor)
        assert rel_err(g, w) <= TOL
        assert np.allclose(g.numpy()[::nd, ::nd], coarse, atol=1e-12)
        assert torch.equal(g[:, 0], g[:, -1])


def _seeded_states(kind, **over):
    """Both packages' models of `kind` and one seeded coupled state
    (JAX's, and the same arrays in the port's tensors): a noisy
    atmosphere over an eddying ocean, so that every term of xforc is
    exercised, tau_udiff's ocean velocities included."""
    cfg_j, cfg_t = coupled_pair(kind, **over)
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t, "cpu")
    rng = np.random.default_rng(1)
    pam = 500.0 * rng.standard_normal((cfg_t.nla, cfg_t.nypa, cfg_t.nxta))
    pam = np.concatenate([pam, pam[:, :, :1]], axis=2)
    at = jax_init_atmos(jm, pa=pam)
    at = at._replace(astm=at.astm + rng.standard_normal(at.astm.shape),
                     hmixam=at.hmixam
                     + 20.0 * rng.standard_normal(at.hmixam.shape))
    oc = jax_init_ocean(jm, init="rbal",
                        po=eddy_pressure(cfg_t, ssh_amp=0.3))
    oc = oc._replace(sstm=oc.sstm + rng.standard_normal(oc.sstm.shape))
    return (jm, tm, oc, at, state_to_torch(numpy_of(oc), "cpu"),
            atmos_state_to_torch(numpy_of(at), "cpu"))


@pytest.mark.parametrize("kind,over", [("box", {}), ("channel", {}),
                                       ("box", dict(ndxr=3))],
                         ids=["box", "channel", "box-odd-ndxr"])
@pytest.mark.parametrize("tau_udiff", [False, True],
                         ids=["tau", "tau_udiff"])
def test_xforc_matches_jax(kind, over, tau_udiff):
    """Every field of both forcings and the diagnostics, at 1e-12 of
    each field's max (an odd refinement ratio takes the half-weighted
    wekpa boxes)."""
    jm, tm, oc, at, oc_t, at_t = _seeded_states(kind, tau_udiff=tau_udiff,
                                                **over)
    want = jax.jit(jax_make_xforc(jm))(at.pam, oc.pom, oc.sstm, at.astm,
                                       at.hmixam)
    got = make_xforc(tm)(at_t.pam, oc_t.pom, oc_t.sstm, at_t.astm,
                         at_t.hmixam)
    for g_nt, w_nt in zip(got, want):
        w = numpy_of(w_nt)
        for name, arr in numpy_of(g_nt).items():
            assert arr.shape == w[name].shape, name
            assert rel_err(arr, w[name]) <= TOL, name
    ofor = got[0]
    if kind == "channel":
        for f in (ofor.tauxo, ofor.tauyo, ofor.wekpo):
            assert torch.equal(f[:, 0], f[:, -1])


def test_float32_dtype_purity():
    """A float32 coupled step promotes no field to float64 (a 1-D
    float64 tensor in the forcing pipeline would)."""
    _, cfg = coupled_pair("box", dtype="float32")
    m = build_model(cfg, "cpu")
    oc = init_ocean_state(m, init="rbal")
    at = init_atmos_state(m, init="rbal")
    ofor, afor, xd = make_xforc(m)(at.pam, oc.pom, oc.sstm, at.astm,
                                   at.hmixam)
    for tree, label in ((ofor, "ofor"), (afor, "afor"), (xd, "xdiags")):
        for name, v in zip(tree._fields, tree):
            assert v.dtype == torch.float32, f"{label}.{name} {v.dtype}"
    oc2, _ = make_ocean_step(m)(oc, ofor)
    at2, _ = make_atmos_step(m)(at, afor)
    for tree, label in ((oc2, "ocean"), (at2, "atmos")):
        for name, v in zip(tree._fields, tree):
            assert v.dtype == torch.float32, f"{label}.{name} {v.dtype}"


def test_xforc_stress_integrals_consistent(box_models):
    """tests/test_coupling.py's Stokes cross-check in the port:
    Integ(wekpa) dA == (txisat - txinat)/fnot over the interior p
    cells."""
    _, tm = box_models
    cfg, g = tm.cfg, tm.grids
    oc = init_ocean_state(tm, init="rbal")
    rng = np.random.default_rng(1)
    pam = 500.0 * rng.standard_normal((cfg.nla, cfg.nypa, cfg.nxta))
    pam = np.concatenate([pam, pam[:, :, :1]], axis=2)
    at = init_atmos_state(tm, init="rbal", pa=pam)
    _, afor, _ = make_xforc(tm)(at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)
    wekpa = afor.wekpa.numpy()
    inner = wekpa[1:-1, 1:-1].sum() + 0.5 * (
        wekpa[1:-1, 0].sum() + wekpa[1:-1, -1].sum())
    rhs = (float(afor.txisat) - float(afor.txinat)) / cfg.fnot
    assert np.isclose(g.dxa * g.dya * inner, rhs, rtol=2e-2)
