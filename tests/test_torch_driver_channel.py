"""The port's experiment driver against qgcm_tpu's on an ocean-only
channel, on the CPU: the forced southern-ocean channel of
examples/southern_ocean_forced_1yr (its input.params, the channel wind
stress of `prepare --forcing channel`) cut to a 48x16 ocean and 40
substeps from an ocean eddy (from rest the meridional flow, and with
it every eddy flux, would be roundoff), through each package's Driver
in float64.
Both write the same file set with every variable within rel 1e-9 (the
golden bar). The coupled comparison is tests/test_torch_driver.py.

The eddy's east column does not repeat its west one on this grid; the
port makes it do so when it derives q (models/ocean.init_ocean_state),
so that a run resumed from its own restart.nc stays on the straight run
(qgcm_tpu keeps the offset in q, and its resumed runs leave the
straight one by 9.4e-3 of po here). qgcm_tpu's Driver gets the restart
the port's init_ocean_state wrote, which holds the periodic state."""

import os

import numpy as np
import pytest

import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_torch.generators import channel_windstress, eddy_pressure
from qgcm_torch.io import save_restart
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.params import parse_input_params, params_to_config
from qgcm_torch.run import Driver

from test_torch_cases import one_torch_thread, quick_jit
from test_torch_driver import _files, _float64_files, assert_same_file

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CASE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                    "southern_ocean_forced_1yr", "input.params")
# 40 substeps (0.25 days), every ocean cadence on; the ocean's time
# levels are averaged once in them (substep 25)
CADENCES = dict(trun=0.25 / 365.0, valday=0.0625, dgnday=0.0625,
                odiday=0.125, prtday=0.125, resday=0.125, dtavoc=0.125)
NC_FILES = ["avges.nc", "lastday.nc", "monit.nc", "ocpo.nc", "ocsst.nc",
            "restart.nc"]


def _base(cfgmod):
    return cfgmod.southern_ocean_ocean_only(nxta=12, nxaooc=12, nyta=6,
                                            nyaooc=4, ndxr=4)


def _params(parse, restart):
    p = parse(CASE)
    for k, v in CADENCES.items():
        setattr(p, k, v)
    p.name = restart
    return p


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Output directories of qgcm_tpu's Driver and the port's on the
    same case, the types each package's writers declared, and the
    port's Driver."""
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.params import params_to_config as jax_params_to_config
    from qgcm_tpu.params import parse_input_params as jax_parse

    d = tmp_path_factory.mktemp("channel_pair")
    rst = str(d / "restart_in.nc")
    p = _params(parse_input_params, rst)
    model = build_model(params_to_config(p, _base(torch_config)), "cpu")
    forcing = channel_windstress(model.cfg, model.grids, tau0=2e-5)
    save_restart(rst, model, init_ocean_state(
        model, po=eddy_pressure(model.cfg)),
        init_atmos_state(model, init="rbal"), 0.0)
    declared = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        _float64_files(mp, "qgcm_tpu", declared["jax"])
        _float64_files(mp, "qgcm_torch", declared["port"])
        quick_jit(mp)
        from qgcm_tpu.run import Driver as JaxDriver
        pj = _params(jax_parse, rst)
        JaxDriver(jax_build_model(jax_params_to_config(pj, _base(
            jax_config))), pj, str(d / "jax"), mean_forcing=forcing,
            verbose=False).run()
        drv = Driver(model, p, str(d / "port"), mean_forcing=forcing,
                     verbose=False)
        drv.run()
    return d, declared, drv


def test_channel_driver_writes_the_jax_file_set(pair):
    d, declared, drv = pair
    assert _files(d / "port") == _files(d / "jax") == sorted(
        NC_FILES + ["input_parameters.m"])
    assert declared["port"] == declared["jax"]
    assert ((d / "port" / "input_parameters.m").read_text()
            == (d / "jax" / "input_parameters.m").read_text())
    assert drv.nsteps == 120 and drv.model.cfg.dtype == "float64"


# a run resumed half-way from its own restart.nc against the straight
# run: float64 roundoff (8.6e-16 of po's maximum read on this case)
RESUME_TOL = 1e-14


def test_channel_resumed_from_its_restart_matches_straight_run(tmp_path):
    """The channel started from the raw eddy (its east column off its west
    one by more than 3% of the eddy's maximum), resumed half-way from the
    restart.nc of its own first half, against the straight run: the
    pressures, PV, SST and mass constraints of the final state within
    1e-14 of their maxima (float64 restart files). Without the repair of
    the initial duplicate column q keeps the offset, and the resume
    leaves the straight run by 9.4e-3 of po. The momentum-constraint
    vectors are not held: a resume rederives them from p (constr, as
    the reference does: the restart holds none), and the leapfrogged
    deep layer's has drifted from that by 1.7e-7 here."""
    import torch
    p = _params(parse_input_params, str(tmp_path / "start.nc"))
    model = build_model(params_to_config(p, _base(torch_config)), "cpu")
    po = eddy_pressure(model.cfg)
    assert np.abs(po[..., -1] - po[..., 0]).max() > 0.03 * np.abs(po).max()
    raw = torch.from_numpy(po)
    save_restart(p.name, model, init_ocean_state(model, po=po)._replace(
        po=raw, pom=raw), init_atmos_state(model, init="rbal"), 0.0)
    forcing = channel_windstress(model.cfg, model.grids, tau0=2e-5)
    half = _params(parse_input_params, p.name)
    half.trun = p.trun / 2
    resumed = _params(parse_input_params, str(tmp_path / "half" /
                                              "restart.nc"))
    resumed.trun = p.trun / 2
    with pytest.MonkeyPatch.context() as mp:
        _float64_files(mp, "qgcm_torch", {})
        out = {}
        for name, params in (("straight", p), ("half", half),
                             ("resumed", resumed)):
            out[name] = Driver(model, params, str(tmp_path / name),
                               mean_forcing=forcing, verbose=False).run()
    assert out["straight"].steps_done == 2 * out["resumed"].steps_done
    for k, want in out["straight"].ocean._asdict().items():
        if k.startswith("ocnc"):
            continue
        got = getattr(out["resumed"].ocean, k)
        scale = want.abs().max()
        assert (got - want).abs().max() <= RESUME_TOL * scale, k


@pytest.mark.parametrize("name", NC_FILES)
def test_channel_driver_output_matches_jax(pair, name):
    """Every variable of the file within rel 1e-9 of its largest
    magnitude, with the same dimensions and units."""
    assert_same_file(pair[0], name)
