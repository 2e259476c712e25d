"""The port's experiment driver on its own (qgcm_torch.run and
qgcm_torch.cli) on the CPU, the cases of tests/test_params_run.py: an
ocean-only channel run, the abort on a blow-up, a mid-cycle restart
resumed under exact cadences, exact-cadence chunks through every phase
of the cycle, the running means' sampling, an atmosphere-only run, the
cadence rounding, and prepare -> run -> run --resume through the CLI.
The comparison with qgcm_tpu's Driver is tests/test_torch_driver.py."""

import io
import re
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import qgcm_torch.config as torch_config
from qgcm_torch.cli import main
from qgcm_torch.generators import eddy_pressure, zero_forcing
from qgcm_torch.io import save_restart
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.params import RunParams, params_to_config
from qgcm_torch.run import Driver, _nint, run_case

from test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

DAY = 86400.0


def _coupled_base(cfgmod):
    return cfgmod.double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                                      ndxr=4, ocean=cfgmod.OceanConfig(
                                          dxo=20.0e3))


def _channel_case(tmp_path, ah4=0.0, days=1.0, **over):
    """The small ocean-only channel of tests/test_params_run.py with an
    eddy restart: (RunParams, base config, model config)."""
    base = torch_config.ModelConfig(
        nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=2, fnot=5.92e-5,
        beta=2.08e-11, ocean_only=True, cyclic_ocean=True)
    kw = dict(trun=days / 365.0, dta=150.0, nstr=3, dxo=20.0e3, delek=0.0,
              valday=0.125, odiday=0.5, adiday=0.0, dgnday=0.25,
              prtday=0.0, resday=0.5, dtavoc=0.5, dtavat=0.0,
              ah2oc=(0.0, 0.0), ah4oc=(ah4, ah4), tabsoc=(287.0, 282.0),
              hoc=(800.0, 3.2e20), gpoc=(0.01,), name="zero")
    kw.update(over)
    p = RunParams(**kw)
    cfg = params_to_config(p, base)
    model = build_model(cfg, "cpu")
    rst = str(tmp_path / "restart_in.nc")
    save_restart(rst, model, init_ocean_state(model, po=eddy_pressure(cfg)),
                 init_atmos_state(model, init="rbal"), 0.0)
    p.name = rst
    return p, base, cfg


def test_ocean_only_channel_run(tmp_path):
    """A day of the unforced, inviscid channel eddy: the reference file
    set, finite means, and layer-1 KE within 2% over the day."""
    p, base, cfg = _channel_case(tmp_path)
    res = run_case(p, base, str(tmp_path / "out"),
                   mean_forcing=zero_forcing(cfg), verbose=False,
                   device="cpu")
    assert not res.aborted and res.steps_done == 576
    for f in ("monit.nc", "ocpo.nc", "ocsst.nc", "avges.nc", "lastday.nc",
              "restart.nc", "input_parameters.m"):
        assert (tmp_path / "out" / f).exists(), f
    assert torch.equal(res.ocean.po[..., -1], res.ocean.po[..., 0])
    with netcdf_file(str(tmp_path / "out" / "monit.nc"), "r",
                     mmap=False) as f:
        ke = f.variables["kealoc"][:].copy()
        assert len(f.variables) == 51
    assert np.isfinite(ke).all() and ke.shape == (4, 2)
    assert abs(ke[-1, 0] - ke[0, 0]) < 0.02 * ke[0, 0]
    with netcdf_file(str(tmp_path / "out" / "avges.nc"), "r",
                     mmap=False) as f:
        assert np.isfinite(f.variables["uptpoc"][:]).all()


def test_abort_on_blowup(tmp_path):
    """An unstable del4 coefficient fails the validity scan: the run
    aborts, writes the post-mortem snapshot, logs the extremum's
    k, j, i with its neighbourhood, and leaves no lastday.nc."""
    p, base, cfg = _channel_case(tmp_path, ah4=1e17, days=2.0, dgnday=0.0,
                                 resday=0.0, dtavoc=0.0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = run_case(p, base, str(tmp_path / "out"),
                       mean_forcing=zero_forcing(cfg), device="cpu")
    assert res.aborted and res.steps_done < 1152
    assert (tmp_path / "out" / "ocpo.nc").exists()
    assert not (tmp_path / "out" / "lastday.nc").exists()
    log = buf.getvalue()
    assert "VALIDITY FAILURE" in log and "post-mortem" in log
    m = re.search(r"qo = (\S+) located at k, j, i = (\d+) (\d+) (\d+)", log)
    assert m, log[-2000:]
    k, j, i = (int(m.group(n)) for n in (2, 3, 4))
    qo = res.ocean.qo.abs().numpy()
    assert np.isnan(qo[k, j, i]) or qo[k, j, i] == np.nanmax(qo)
    assert re.search(rf"\b{max(0, i - 3)}\b.*\b{i}\b", log)


def test_midcycle_restart_resume_is_the_straight_run(tmp_path):
    """Under cadence_rounding='exact' a restart every 10 steps (nstr=3)
    lands mid coupling cycle and embeds the open cycle's forcing; the
    resumed run re-enters the cycle through its lead segment, fires its
    monitor on the relative step grid, and ends within 1e-8 of the
    straight 18-step run (PV is recomputed from pressure on load)."""
    model = build_model(_coupled_base(torch_config), "cpu")
    base = dict(dta=180.0, nstr=3, dxo=20.0e3, valday=0.0, odiday=0.0,
                adiday=0.0, dgnday=0.0, prtday=0.0, resday=0.0,
                dtavoc=0.0, dtavat=0.0, name="rbal")
    ctl = Driver(model, RunParams(**{**base, "trun": 18 * 180.0 / DAY / 365},
                                  ), str(tmp_path / "ctl"),
                 verbose=False).run()
    p = RunParams(**{**base, "trun": 10 * 180.0 / DAY / 365,
                     "resday": 10 * 180.0 / DAY})
    drv = Driver(model, p, str(tmp_path / "a"), verbose=False,
                 cadence_rounding="exact")
    assert drv.nrestart == 10 and drv.run().steps_done == 10
    rst = tmp_path / "a" / "restart.nc"
    with netcdf_file(str(rst), "r", mmap=False) as f:
        assert "tauxa" in f.variables and "tauxo" in f.variables
    p2 = RunParams(**{**base, "trun": 8 * 180.0 / DAY / 365,
                      "dgnday": 6 * 180.0 / DAY, "name": str(rst)})
    res = Driver(model, p2, str(tmp_path / "b"), verbose=False,
                 cadence_rounding="exact").run()
    assert res.steps_done == 8
    with netcdf_file(str(tmp_path / "b" / "monit.nc"), "r",
                     mmap=False) as f:
        t = f.variables["time"][:].copy()
    np.testing.assert_allclose(t * 365.0 * DAY / 180.0, [16.0], atol=1e-4)
    for a, b in ((res.ocean.po, ctl.ocean.po), (res.ocean.sst, ctl.ocean.sst),
                 (res.atmos.pa, ctl.atmos.pa), (res.atmos.ast, ctl.atmos.ast)):
        assert (a - b).abs().max() <= 1e-8 * b.abs().max()


def test_exact_cadence_chunks_rotate_through_the_cycle(tmp_path):
    """A 4-step validity cadence under 'exact' puts chunk boundaries at
    every phase of the 3-step cycle (lead and tail segments); the run
    equals the aligned one bit for bit."""
    model = build_model(_coupled_base(torch_config), "cpu")
    kw = dict(trun=12 * 180.0 / DAY / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
              odiday=0.0, adiday=0.0, dgnday=0.0, prtday=0.0, resday=0.0,
              dtavoc=0.0, dtavat=0.0, name="rbal")
    drv = Driver(model, RunParams(valday=720.0 / DAY, **kw),
                 str(tmp_path / "a"), verbose=False,
                 cadence_rounding="exact")
    assert drv.nvalid == 4 and drv.chunk == 4
    res = drv.run()
    ref = Driver(model, RunParams(valday=1080.0 / DAY, **kw),
                 str(tmp_path / "b"), verbose=False).run()
    assert res.steps_done == ref.steps_done == 12
    for a, b in zip((*res.ocean, *res.atmos), (*ref.ocean, *ref.atmos)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sampling", ["mean", "midpoint"])
def test_running_mean_sampling(sampling, tmp_path):
    """'mean' accumulates after every ocean substep and atmosphere step;
    'midpoint' once per averaging interval, at its midpoint on the
    relative step grid (q-gcm.F:1477-1482). Here 4 intervals of 6
    atmosphere steps (2 cycles) of the coupled box."""
    model = build_model(_coupled_base(torch_config), "cpu")
    six = 6 * 180.0 / DAY
    p = RunParams(trun=24 * 180.0 / DAY / 365.0, dta=180.0, nstr=3,
                  dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                  dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=six,
                  dtavat=six, name="rbal")
    drv = Driver(model, p, str(tmp_path), verbose=False,
                 avges_sampling=sampling)
    carry, _ = drv.initial_carry()
    carry = drv.advance(carry, 24)
    assert carry.n == 24
    want = (8, 24) if sampling == "mean" else (4, 4)
    assert (carry.oacc.n, carry.aacc.n) == want


def test_atmos_only_run(tmp_path):
    """The atmosphere over a prescribed mean SST through run_case."""
    base = _coupled_base(torch_config).replace(atmos_only=True)
    p = RunParams(trun=0.25 / 365.0, dta=180.0, nstr=3, dxo=20.0e3,
                  valday=0.125, odiday=0.0, adiday=0.25, dgnday=0.125,
                  prtday=0.0, resday=0.0, dtavoc=0.0, dtavat=0.25,
                  name="rbal")
    cfg = params_to_config(p, base)
    sst = np.zeros((cfg.nyto, cfg.nxto))
    res = run_case(p, base, str(tmp_path / "out"), sst_mean=sst,
                   verbose=False, device="cpu")
    assert not res.aborted and res.ocean is None
    for f in ("monit.nc", "atpa.nc", "atast.nc", "avges.nc", "lastday.nc"):
        assert (tmp_path / "out" / f).exists(), f
    assert torch.isfinite(res.atmos.pa).all()


def test_cadence_rounding(tmp_path):
    """Fortran NINT rounds half away from zero; a cadence that is not a
    whole number of coupling cycles warns with its rounded value, and an
    exact one stays silent; an odd midpoint interval is refused; a
    ckpt_format other than 'netcdf' and 'sharded' (qgcm_tpu's 'orbax', a
    JAX format) is refused with qgcm_tpu's check, and profile_dir (the
    CLI's --profile) and mesh (None: one device) are taken."""
    assert [_nint(x) for x in (0.5, 1.5, 2.5, 2.4999)] == [1, 2, 3, 2]
    model = build_model(_coupled_base(torch_config), "cpu")
    kw = dict(trun=0.01 / 365.0, dta=180.0, nstr=3, dxo=20.0e3, odiday=0.0,
              adiday=0.0, dgnday=0.0, prtday=0.0, resday=0.0, dtavoc=0.0,
              dtavat=0.0, name="rbal")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Driver(model, RunParams(valday=0.0125, **kw), str(tmp_path / "a"),
               verbose=False)
    with pytest.warns(UserWarning, match="valday"):
        drv = Driver(model, RunParams(valday=1350.0 / DAY, **kw),
                     str(tmp_path / "b"), verbose=False)
    assert drv.nvalid == 9          # nint(2.5)*3, not round(2.5)*3 == 6
    with pytest.raises(ValueError, match="midpoint"):
        Driver(model, RunParams(**{**kw, "dtavat": 540.0 / DAY}),
               str(tmp_path / "c"), verbose=False, avges_sampling="midpoint")
    with pytest.raises(ValueError, match="ckpt_format must be"):
        Driver(model, RunParams(**kw), str(tmp_path / "d"),
               ckpt_format="orbax")
    assert Driver(model, RunParams(**kw), str(tmp_path / "e"),
                  profile_dir=None).profile_dir is None
    assert Driver(model, RunParams(**kw), str(tmp_path / "f"),
                  mesh=None).mesh is None


def test_cli_prepare_run_resume(tmp_path, capsys):
    """prepare -> run -> run --resume through qgcm_torch.cli.main on the
    CPU: the second segment continues the clock in outdata_r2, and
    --resume into the segment it reads from is refused; a third segment
    with --ckpt-format sharded writes lastday_sharded/ and restart_sharded/
    only, and a fourth --resume continues from it. Refused: qgcm_tpu's
    --ckpt-format orbax (a JAX format, which the port neither reads nor
    writes) and, this case being a channel, --mesh 1x2 in one process (a
    channel's NYxNX is cut by rows over its NY*NX ranks; multi-rank
    runs: tests/test_torch_parallel_driver.py)."""
    case = tmp_path / "case"
    case.mkdir()
    params = (
        f" {12 * 150.0 / DAY / 365.0:.12e}  !! trun\n"
        " 150.0d0   !! dta\n 3   !! nstr\n 20.0d3  !! dxo\n"
        " 0.0d0  !! delek\n 1.3d-3 !! cdat\n 1.0d0 !! rhoat\n"
        " 1.0d3 !! rhooc\n 1.0d3 !! cpat\n 4.0d3 !! cpoc\n"
        " 1.0d0 !! bccoat\n 0.2d0 !! bccooc\n 1.0d0 !! xcexp\n"
        " 1.0d0 !! ycexp\n 0.0d0 !! valday\n 0.0d0 !! odiday\n"
        " 0.0d0 !! adiday\n"
        f" {3 * 150.0 / DAY:.12e} !! dgnday\n"
        " 0.0d0 !! prtday\n"
        f" {12 * 150.0 / DAY:.12e} !! resday\n"
        " 1 !! nsko\n 1 !! nska\n 0.0d0 !! dtavat\n 0.0d0 !! dtavoc\n"
        " 0.0d0 !! dtcovat\n 0.0d0 !! dtcovoc\n 35.0d0 !! xlamda\n"
        " 100.0d0 !! hmoc\n 100.0d0 !! st2d\n 2.0d9 !! st4d\n"
        " 1000.0d0 !! hmat\n 100.0d0 !! hmamin\n 2.0d5 !! ahmd\n"
        " 2.5d4 !! at2d\n 2.0d14 !! at4d\n 0.15d0 !! hmadmp\n"
        " -210.0d0 !! fsbar\n 80.0d0 !! fspamp\n 2.0d2 !! zm\n"
        " 2.0d4 2.0d4 3.0d4 !! zopt\n 1.0d-2 !! gamma\n"
        " 0.0d0 0.0d0 !! ah2oc\n 0.0d0 0.0d0 !! ah4oc\n"
        " 287.0d0 282.0d0 !! tabsoc\n 800.0d0 3.2d20 !! hoc\n"
        " 0.01d0 !! gpoc\n 1.5d14 1.5d14 1.5d14 !! ah4at\n"
        " 330.0d0 340.0d0 350.0d0 !! tabsat\n"
        " 2000.0d0 3000.0d0 4000.0d0 !! hat\n 1.2d0 0.4d0 !! gpat\n"
        " restart.nc !! name\n flat !! topocname\n flat !! topatname\n"
        " 1 1 1 1 1 1 1 !! outfloc\n 1 1 1 1 1 1 1 !! outflat\n")
    (case / "input.params").write_text(params)
    flags = ["--nxta", "24", "--nyta", "24", "--nxaooc", "24",
             "--nyaooc", "12", "--ndxr", "2", "--fnot", "5.92e-5",
             "--beta", "2.08e-11", "--ocean-only", "--cyclic-ocean",
             "--device", "cpu"]
    assert main(["prepare", str(case), "--eddy-amp", "0.15",
                 "--forcing", "zero"] + flags) == 0
    assert main(["run", str(case), "--quiet"] + flags) == 0
    assert (case / "outdata" / "restart.nc").exists()
    assert main(["run", str(case), "--quiet", "--resume"] + flags) == 0
    with netcdf_file(str(case / "outdata_r2" / "monit.nc"), "r",
                     mmap=False) as f:
        t2 = f.variables["time"][:].copy()
    np.testing.assert_allclose(t2 / (150.0 / DAY / 365.0),
                               [15.0, 18.0, 21.0, 24.0], rtol=1e-5)
    with pytest.raises(SystemExit):
        main(["run", str(case), "--quiet", "--resume", "--outdir",
              str(case / "outdata_r2")] + flags)
    assert main(["run", str(case), "--quiet", "--resume", "--ckpt-format",
                 "sharded"] + flags) == 0
    r3 = sorted(p.name for p in (case / "outdata_r3").iterdir())
    assert "lastday_sharded" in r3 and "restart_sharded" in r3
    assert "lastday.nc" not in r3 and "restart.nc" not in r3
    assert main(["run", str(case), "--quiet", "--resume"] + flags) == 0
    with netcdf_file(str(case / "outdata_r4" / "monit.nc"), "r",
                     mmap=False) as f:
        t4 = f.variables["time"][:].copy()
    np.testing.assert_allclose(t4 / (150.0 / DAY / 365.0),
                               [39.0, 42.0, 45.0, 48.0], rtol=1e-5)
    with pytest.raises(SystemExit):
        main(["run", str(case), "--ckpt-format", "orbax"] + flags)
    # a channel's NYxNX is cut by rows over its NY*NX ranks: one process
    # has too few
    with pytest.raises(ValueError, match="a 1x2 mesh needs 2 ranks"):
        main(["run", str(case), "--mesh", "1x2"] + flags)
    assert "done: 12 steps" in capsys.readouterr().out
