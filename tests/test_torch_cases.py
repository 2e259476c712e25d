"""Shared cases of the qgcm_torch-vs-qgcm_tpu tests (no tests here).

Each case is built twice from the same arguments, once with each
package's config module, so that both packages see identical
configurations; states made by the JAX package are handed to the port
as NumPy arrays through qgcm_torch.convert.
"""

import jax
import numpy as np
import pytest
import torch

import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_tpu.generators import eddy_pressure, double_gyre_windstress
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.ocean import (init_ocean_state, make_ocean_step,
                                   ocean_forcing_from_mean, _oml)
from qgcm_torch.convert import forcing_to_torch, state_to_torch


def make_cfg(cfgmod, kind, nlo=3, cyclic=False, sponge=False,
             dtype="float64"):
    """A ModelConfig of `cfgmod` (qgcm_tpu.config or qgcm_torch.config):
    'pallas' is the kernel-test setup of tests/test_pallas_qg.py:17-27,
    'tall' its multi-tile grid (nypo = 145, :110-116), 'golden' the
    ocean box of tests/test_golden.py:27-36."""
    if kind == "golden":
        oc = cfgmod.OceanConfig(nlo=3, dxo=25.0e3, delek=2.0,
                                hoc=(350.0, 750.0, 2900.0),
                                gpoc=(0.015, 0.0075),
                                tabsoc=(287.0, 282.0, 276.0),
                                ah2oc=(0.0, 0.0, 0.0),
                                ah4oc=(2e12, 2e12, 2e12))
        return cfgmod.ModelConfig(
            nxta=24, nyta=24, nxaooc=16, nyaooc=8, ndxr=2,
            fnot=9.37456e-5, beta=1.7536e-11, dta=200.0, nstr=3, ocean=oc,
            ocean_only=True, dtype=dtype).validate()
    if kind == "tall":
        oc = cfgmod.OceanConfig(nlo=2, dxo=10e3, delek=2.0,
                                hoc=(350.0, 2900.0), gpoc=(0.015,),
                                tabsoc=(287.0, 276.0), ah2oc=(1e2, 1e2),
                                ah4oc=(1e10, 2e10))
        return cfgmod.ModelConfig(
            nxta=24, nyta=24, nxaooc=24, nyaooc=24, ndxr=6,
            fnot=5.92e-5, beta=2.08e-11, ocean=oc, ocean_only=True,
            cyclic_ocean=cyclic, dtype=dtype).validate()
    assert kind == "pallas", kind
    oc = cfgmod.OceanConfig(nlo=nlo, dxo=20e3, delek=2.0,
                            hoc=(350.0, 750.0, 2900.0)[:nlo],
                            gpoc=(0.015, 0.0075)[:nlo - 1],
                            tabsoc=(287.0, 282.0, 276.0)[:nlo],
                            ah2oc=(1e2, 1e2, 1e2)[:nlo],
                            ah4oc=(1e10, 2e10, 3e10)[:nlo])
    return cfgmod.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=6,
        fnot=5.92e-5, beta=2.08e-11, ocean=oc, ocean_only=True,
        cyclic_ocean=cyclic, sponge=cfgmod.SpongeConfig(enabled=sponge),
        dtype=dtype).validate()


def cfg_pair(*args, **kw):
    """(qgcm_tpu config, qgcm_torch config) of one case."""
    return (make_cfg(jax_config, *args, **kw),
            make_cfg(torch_config, *args, **kw))


def jax_case(cfg, steps=1):
    """JAX model, a state `steps` substeps after the eddy start under the
    double-gyre wind (so that qo != qcomp(po) trivially), the forcing,
    and the mixed layer's entrainment at that state."""
    model = jax_build_model(cfg.replace(solver_transform="fft"))
    # jitted: one compile per configuration costs less than JAX's
    # op-by-op dispatch of the same code
    st = jax.jit(lambda po: init_ocean_state(model, po=po))(
        eddy_pressure(cfg))
    f = jax.jit(lambda *tau: ocean_forcing_from_mean(model, *tau))(
        *double_gyre_windstress(cfg, model.grids))
    step = jax.jit(make_ocean_step(model))
    for _ in range(steps):
        st, _ = step(st, f)
    return model, st, f, jax.jit(lambda s: _oml(model, s, f)[2])(st)


def to_port(st, f, dtype=torch.float64):
    """The JAX state and forcing as the port's tensors on the CPU."""
    numpy = (lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()})
    return (state_to_torch(numpy(st), "cpu", dtype),
            forcing_to_torch(numpy(f), "cpu", dtype))


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch work on one intra-op thread: its grids hold a
    few thousand points, where threads only add overhead, and beside
    other test workers they oversubscribe the cores (the baroclinic
    Rossby oracle took 127 s there against 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def coupled_cfg(cfgmod, kind="box", dtype="float64", **over):
    """The small coupled configurations of the JAX tests, in `cfgmod`:
    'box' is the double gyre of tests/test_golden.py:67 and
    tests/test_coupling.py:15, 'channel' the miniature southern-ocean
    channel of tests/test_southern_ocean.py:22."""
    if kind == "box":
        return cfgmod.double_gyre_coupled(
            nxta=24, nyta=12, nxaooc=8, nyaooc=8, ndxr=4, dta=180.0,
            ocean=cfgmod.OceanConfig(dxo=20.0e3),
            dtype=dtype).replace(**over).validate()
    assert kind == "channel", kind
    return cfgmod.ModelConfig(
        nxta=24, nyta=18, nxaooc=24, nyaooc=6, ndxr=4,
        fnot=-1.19467e-4, beta=1.31301e-11, dta=180.0,
        ocean=cfgmod.OceanConfig(dxo=20.0e3), cyclic_ocean=True,
        nb_hflux=True, dtype=dtype).replace(**over).validate()


def coupled_pair(*args, **kw):
    """(qgcm_tpu config, qgcm_torch config) of one coupled case."""
    return (coupled_cfg(jax_config, *args, **kw),
            coupled_cfg(torch_config, *args, **kw))


def numpy_of(nt) -> dict:
    """{field: NumPy array} of a JAX or port NamedTuple."""
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in nt._asdict().items()}


def to_jax(cls, nt):
    """A JAX NamedTuple `cls` holding the fields of a port NamedTuple."""
    import jax.numpy as jnp
    return cls(**{k: jnp.asarray(v) for k, v in numpy_of(nt).items()})


def rel_err(got, want):
    """max|got - want| / max|want| (NumPy or tensors), in float64."""
    got, want = (np.asarray(a.detach().cpu() if torch.is_tensor(a) else a,
                            dtype=np.float64) for a in (got, want))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))
