"""The port's experiment driver (qgcm_torch.run) against qgcm_tpu's on
the CPU: one small coupled run through each package's Driver from the
same restart, with every cadence on (snapshots, monitoring, running
means, covariance, area boxes, qocdiag, the k247 ocean-average stream,
restarts), writes the same file set with every variable within rel 1e-9
(the golden bar). The port's own Driver cases are
tests/test_torch_run.py."""

import os

import numpy as np
import pytest
from scipy.io import netcdf_file

import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_torch.generators import eddy_pressure
from qgcm_torch.io import save_restart
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.params import RunParams, params_to_config
from qgcm_torch.run import Driver

from _torch_ranks import float64_files as _float64_files
from test_torch_cases import one_torch_thread, quick_jit

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

AREAS = ("   2                 !!nareoc\n"
         "   0.0d3  100.0d3    !!xlooc\n"
         " 300.0d3  260.0d3    !!xhioc\n"
         "   0.0d3   50.0d3    !!ylooc\n"
         " 300.0d3  250.0d3    !!yhioc\n"
         "   oc1      oc2      !!areaoc\n"
         "   1                 !!nareat\n"
         "   0.0d3             !!xloat\n"
         " 1000.0d3            !!xhiat\n"
         "   0.0d3             !!yloat\n"
         "  900.0d3            !!yhiat\n"
         "   at1               !!areaat\n")
# every cadence on, 0.5 model days of the small coupled double gyre
CADENCES = dict(trun=0.5 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                valday=0.125, odiday=0.25, adiday=0.25, dgnday=0.125,
                prtday=0.25, resday=0.25, dtavoc=0.25, dtavat=0.25,
                dtcovoc=0.125, dtcovat=0.125)


def _coupled_base(cfgmod):
    return cfgmod.double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                                      ndxr=4, ocean=cfgmod.OceanConfig(
                                          dxo=20.0e3))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Output directories of qgcm_tpu's Driver and the port's on the
    same case, and the types each package's writers declared. The start
    is an ocean eddy under a radiative-balance atmosphere with a
    pressure bump in every layer: from the radiative balance alone the
    bottom layer has no wind, and the wind stress, Ekman velocities
    and wind work would be roundoff."""
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.params import RunParams as JaxRunParams
    from qgcm_tpu.params import params_to_config as jax_params_to_config
    from qgcm_tpu.run import Driver as JaxDriver

    d = tmp_path_factory.mktemp("pair")
    (d / "areas.limits").write_text(AREAS)
    p = RunParams(**CADENCES)
    model = build_model(params_to_config(p, _coupled_base(torch_config)),
                        "cpu")
    at = init_atmos_state(model, init="rbal")
    g = model.grids
    bump = np.exp(-(((g.xpa[None] - g.xpa.mean()) / 4e5) ** 2
                    + ((g.ypa[:, None] - g.ypa.mean()) / 4e5) ** 2))
    pa = at.pa.numpy() + 500.0 * bump * np.array(
        [1.0, 0.6, 0.3])[:, None, None]
    # the restart is the port's (its schema is qgcm_tpu's,
    # tests/test_torch_io.py): qgcm_tpu's own eager init would cost
    # seconds of op-by-op compiles here
    rst = str(d / "restart_in.nc")
    save_restart(rst, model, init_ocean_state(
        model, init="rbal", po=eddy_pressure(model.cfg)),
        init_atmos_state(model, init="rbal", pa=pa), 0.0)
    p.name = rst
    kw = dict(areas_limits=str(d / "areas.limits"), qoc_diag=True,
              ocavg_days=0.25, verbose=False)
    declared = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        _float64_files(mp, "qgcm_tpu", declared["jax"])
        _float64_files(mp, "qgcm_torch", declared["port"])
        quick_jit(mp)
        pj = JaxRunParams(**CADENCES, name=rst)
        JaxDriver(jax_build_model(jax_params_to_config(
            pj, _coupled_base(jax_config))), pj, str(d / "jax"), **kw).run()
        drv = Driver(model, p, str(d / "port"), **kw)
        drv.run()
    return d, declared, drv


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


NC_FILES = ["areas.nc", "atast.nc", "atpa.nc", "avg/ocavg_0000.nc",
            "avg/ocavg_0001.nc", "avges.nc", "covar.nc", "lastday.nc",
            "monit.nc", "ocpo.nc", "ocsst.nc", "qocdiag.nc", "restart.nc"]


def test_driver_writes_the_jax_file_set(pair):
    d, declared, drv = pair
    assert _files(d / "port") == _files(d / "jax") == sorted(
        NC_FILES + ["input_parameters.m"])
    assert declared["port"] == declared["jax"]
    assert ((d / "port" / "input_parameters.m").read_text()
            == (d / "jax" / "input_parameters.m").read_text())
    assert drv.nsteps == 240 and drv.chunk == 60


@pytest.mark.parametrize("name", NC_FILES)
def test_driver_output_matches_jax(pair, name):
    """Every variable of the file within rel 1e-9 of its largest
    magnitude, with the same dimensions and units. monit.nc's entmoc
    is the mean of an entrainment whose mean the mixed layer removes:
    roundoff, held at 1e-9 of the mean |entrainment| (enamoc)."""
    assert_same_file(pair[0], name)


def assert_same_file(d, name, rtol=1e-9, got="port", want="jax",
                     rtols=None):
    """d/want/name and d/got/name hold the same variables, dimensions
    and units, every variable within rtol (or rtols[variable]) of its
    largest magnitude in the `want` file (entmoc: of enamoc's)."""
    with netcdf_file(str(d / want / name), "r", mmap=False) as fj, \
            netcdf_file(str(d / got / name), "r", mmap=False) as ft:
        assert set(ft.variables) == set(fj.variables)
        assert dict(ft.dimensions) == dict(fj.dimensions)
        for v in fj.variables:
            a = np.asarray(ft.variables[v][:], np.float64)
            b = np.asarray(fj.variables[v][:], np.float64)
            assert ft.variables[v].dimensions == fj.variables[v].dimensions
            assert (getattr(ft.variables[v], "units", None)
                    == getattr(fj.variables[v], "units", None)), v
            assert a.shape == b.shape, v
            scale = np.abs(b).max(initial=0.0)
            if v == "entmoc":
                scale = np.abs(fj.variables["enamoc"][:]).max()
            tol = (rtols or {}).get(v, rtol)
            assert np.abs(a - b).max(initial=0.0) <= tol * scale, v
