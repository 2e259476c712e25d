"""Shared cases of the qgcm_torch-vs-qgcm_tpu tests (no tests here).

Each case is built twice from the same arguments, once with each
package's config module, so that both packages see identical
configurations; states made by one package are handed to the other as
NumPy arrays (qgcm_torch.convert, to_jax).
"""

import functools
from collections import namedtuple

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
from qgcm_tpu.coupling import XforcDiags as JaxXforcDiags
from qgcm_tpu.state import AtmosForcing, AtmosState, OceanForcing, OceanState
from qgcm_torch.convert import forcing_to_torch, state_to_torch
from qgcm_torch.coupling import make_xforc
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state as t_init_atmos
from qgcm_torch.models.ocean import init_ocean_state as t_init_ocean
from qgcm_torch.models.ocean import ocean_forcing_from_mean as t_mf

from _torch_ranks import coupled_cfg  # noqa: F401 (re-exported)

TOL = 1e-12
StepDiags = namedtuple("StepDiags", "ermaso emfroc ermasa emfrat")


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


class SeededCase:
    """One configuration in both packages with the same seeded state:
    the port's NamedTuples (oc, at, ofor, afor, xd) and the same arrays
    as qgcm_tpu's (jax_*). The states, forcing and xforc means are made
    by the port and carried across: a diagnostic's inputs are then the
    same to the bit in both packages."""

    def __init__(self, kind, seed=0):
        if kind == "box":
            cfg_j, cfg_t = cfg_pair("pallas", nlo=3)
        else:
            cfg_j, cfg_t = coupled_pair(
                "channel" if kind.startswith("channel") else "box")
        self.kind, self.cfg = kind, cfg_t
        self.jm = jax_build_model(cfg_j)
        self.model = model = build_model(cfg_t, "cpu")
        rng = np.random.default_rng(seed)
        g = model.grids

        po = eddy_pressure(cfg_t)
        po = po + 0.02 * np.abs(po).max() * rng.standard_normal(po.shape)
        pom = po + 0.01 * np.abs(po).max() * rng.standard_normal(po.shape)
        sst = model.rad.sstbar[:, None] + rng.standard_normal(
            (cfg_t.nyto, cfg_t.nxto))
        sstm = sst + 0.1 * rng.standard_normal(sst.shape)
        if cfg_t.cyclic_ocean:          # keep the duplicate column
            po[..., -1], pom[..., -1] = po[..., 0], pom[..., 0]
        self.oc = t_init_ocean(model, po=po, pom=pom, sst=sst, sstm=sstm)
        self.at = self.afor = self.xd = None
        if cfg_t.ocean_only:
            self.ofor = t_mf(model, *double_gyre_windstress(cfg_t, g))
        else:
            at0 = t_init_atmos(model, init="rbal")
            bump = np.exp(-(((g.xpa[None] - g.xpa.mean()) / 4e5) ** 2
                            + ((g.ypa[:, None] - g.ypa.mean()) / 4e5) ** 2))
            pa = (at0.pa.numpy() + 500.0 * bump
                  + 5.0 * rng.standard_normal(at0.pa.shape))
            pa[..., -1] = pa[..., 0]
            pam = pa + 2.0 * rng.standard_normal(pa.shape)
            pam[..., -1] = pam[..., 0]
            ast = at0.ast.numpy() + rng.standard_normal(at0.ast.shape)
            hmixa = at0.hmixa.numpy() * (
                1.0 + 0.1 * rng.standard_normal(ast.shape))
            self.at = at = t_init_atmos(model, pa=pa, pam=pam, ast=ast,
                                        astm=ast - 0.05, hmixa=hmixa,
                                        hmixam=hmixa + 1.0)
            self.ofor, self.afor, self.xd = make_xforc(model)(
                at.pam, self.oc.pom, self.oc.sstm, at.astm, at.hmixam)
        self.jax_oc = to_jax(OceanState, self.oc)
        self.jax_ofor = to_jax(OceanForcing, self.ofor)
        self.jax_at = self.jax_afor = self.jax_xd = None
        if self.at is not None:
            self.jax_at = to_jax(AtmosState, self.at)
            self.jax_afor = to_jax(AtmosForcing, self.afor)
            self.jax_xd = to_jax(JaxXforcDiags, self.xd)
        nio, nia = cfg_t.nlo - 1, cfg_t.nla - 1
        self.np_diags = StepDiags(*(rng.standard_normal(n) * 1e-9
                                    for n in (nio, nio, nia, nia)))

    def jax_args(self):
        return self.jax_oc, self.jax_at, self.jax_ofor, self.jax_afor

    def args(self):
        return self.oc, self.at, self.ofor, self.afor


@functools.lru_cache(maxsize=None)
def get_case(kind):
    """The SeededCase of `kind` ('box', 'channel-nb_hflux', 'coupled'),
    built once per process."""
    return SeededCase(kind)


def writable(nt) -> dict:
    """{field: writable NumPy copy} of a JAX or port NamedTuple."""
    return {k: np.array(v) for k, v in numpy_of(nt).items()}


def leaves(x, prefix=""):
    """{path: NumPy array} of nested NamedTuples/dicts of tensors."""
    if x is None:
        return {}
    if isinstance(x, dict):
        items = x.items()
    elif hasattr(x, "_fields"):
        items = x._asdict().items()
    elif isinstance(x, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(x))
    else:
        return {prefix: (x.detach().cpu().numpy() if torch.is_tensor(x)
                         else np.asarray(x))}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else k))
    return out


def assert_match(got, want, tol=TOL, scale=None):
    """Every leaf of `got` within tol of the largest magnitude of the
    same leaf of `want` (or of scale[path]); booleans and integers
    equal."""
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), k
            continue
        s = (scale or {}).get(k, np.abs(w).max())
        assert np.abs(g - w).max() <= tol * s, (k, g, w)


def quick_jit(mp):
    """Make jax.jit compile as quick_compile does, while the
    MonkeyPatch `mp` lasts: for a reference run of qgcm_tpu whose
    programs are jitted inside it (its Driver)."""
    import jax
    jit = jax.jit

    def quick(fun=None, **kw):
        kw.setdefault("compiler_options",
                      {"xla_backend_optimization_level": 0})
        return jit(fun, **kw) if fun is not None else (
            lambda f: jit(f, **kw))

    mp.setattr(jax, "jit", quick)


def quick_compile(jitted, *args):
    """A jitted JAX function compiled for `args` without XLA's backend
    optimisation: the reference programs of these tests are small and
    run once, so LLVM's optimisation would cost more than it saves."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
