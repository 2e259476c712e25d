"""qgcm_torch's Driver and CLI on rows meshes and, for the box, on a 2x2
mesh, in float64 on the CPU in real gloo ranks (2 for the rows mesh, 4
for the 2x2 mesh and the member mesh's gcd rule): the small coupled
double gyre of tests/test_torch_driver.py and the forced channel of
tests/test_torch_driver_channel.py through Driver(mesh) with every
cadence on, against the port's single-device Driver at 1e-11 (every
file) and qgcm_tpu's Driver(mesh) on a mesh of the same shape at 1e-9
(monit.nc and the final restart), and a run resumed mid-way from the
restart.nc the primary rank wrote against the straight one; the
coupled double gyre's atmosphere alone (atmos_only) the same way; `run --mesh
rows --dist-backend gloo` and `ensemble --shard-members` through
cli.main in the ranks (the gcd messages are qgcm_tpu's), and `run --mesh
2x2` on a cut double-gyre box in 4 processes under torchrun; a validity
failure that one rank alone sees stops every rank, and a rank that
raises ends the spawn."""

import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from scipy.io import netcdf_file

import _torch_ranks as ranks
import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_torch.cli import main
from qgcm_torch.generators import channel_windstress, eddy_pressure
from qgcm_torch.io import save_restart
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.models.ocean import init_ocean_state
from qgcm_torch.params import (RunParams, parse_input_params,
                               params_to_config)
from qgcm_torch.parallel.launch import spawn_ranks
from qgcm_torch.run import Driver

import test_torch_driver as coupled
import test_torch_driver_channel as channel
from test_torch_cases import one_torch_thread, quick_jit

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

SINGLE_TOL = 1e-11      # against the port's single-device Driver
JAX_TOL = 1e-9          # against qgcm_tpu's Driver(mesh)
# The atmosphere's energy tendencies are differences of two time levels'
# energies (diags/monitor.py:8): the decomposed xforc's split sums
# (coupling.make_xforc) leave the fields 1e-15 apart, and kealat (3.9e7
# J/m^2 here) 2.3e-15, but its tendency (4 W/m^2) is that energy's change
# over a step, 1e-5 of it, and so 1.1e-10 apart at worst (the resumed
# run). They are held at qgcm_tpu's bar instead.
TENDENCY_TOL = {"ddtkeat": JAX_TOL, "ddtpeat": JAX_TOL}
# The same holds for the ocean's energy tendencies of the ocean-only box
# on a 2x2 mesh (its split sums differ from one device's by roundoff):
# ddtkeoc read 6.2e-15 apart at a largest magnitude of 1.35e-4. Its mean
# Ekman velocity wetmoc, the mean curl of the antisymmetric double-gyre
# wind, is zero but for roundoff (4.2e-22 m/s against Ekman velocities of
# order 1e-6 m/s), so two roundings of it differ by their own size.
OCEAN_TENDENCY_TOL = {"ddtkeoc": JAX_TOL, "ddtpeoc": JAX_TOL, "wetmoc": 1.0}
# The atmosphere-only case's mean Ekman velocities at T and p points,
# wetmat and wepmat (5.8e-12 m/s), are 4.4e-5 of the Ekman velocity's
# largest magnitude (1.32e-7 m/s at T points, 1.35e-7 at p points): they
# are held against qgcm_tpu at JAX_TOL of that field, 1e-9 x 1.32e-7 /
# 5.8e-12 = 2.3e-5 of their own value (the two read 4.6e-8 apart).
WETMAT_TOL = {"wetmat": 2.3e-5, "wepmat": 2.3e-5}
RANKS = 2
CLI_GRID = ["--preset", "southern_ocean_ocean_only", "--nxta", "12",
            "--nxaooc", "12", "--nyta", "6", "--nyaooc", "4", "--ndxr", "4",
            "--dtype", "float64", "--device", "cpu"]
GLOO = ["--dist-backend", "gloo", "--quiet"]
MESH_2D = (2, 2)
# the cut ocean-only double gyre of tests/test_torch_analysis.py (a 33 x
# 33 ocean) for half a day, for `run --mesh 2x2` under torchrun
BOX_GRID = ["--preset", "double_gyre_ocean_only", "--nxaooc", "8",
            "--nyaooc", "8", "--ndxr", "4", "--nxta", "16", "--nyta", "16",
            "--dtype", "float64", "--device", "cpu"]
BOX_PARAMS = dict(trun="0.001369863D0", dgnday="0.125d0", odiday="0.25d0",
                  prtday="0.25d0", resday="0.25d0", dtavoc="0.25d0",
                  name="restart.nc")
# the command each torchrun rank runs: the CLI with float64 files
TORCHRUN_CLI = """import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import pytest
import _torch_ranks
from qgcm_torch.cli import main
with pytest.MonkeyPatch.context() as mp:
    _torch_ranks.float64_files(mp, "qgcm_torch", {{}})
    sys.exit(main(sys.argv[1:]))
"""


def _coupled_case(d):
    """(config, RunParams of the whole run, Driver keywords) of the
    coupled double gyre (tests/test_torch_driver.py), its restart in d."""
    (d / "areas.limits").write_text(coupled.AREAS)
    p = RunParams(**coupled.CADENCES)
    model = build_model(params_to_config(p, coupled._coupled_base(
        torch_config)), "cpu")
    at = init_atmos_state(model, init="rbal")
    g = model.grids
    bump = np.exp(-(((g.xpa[None] - g.xpa.mean()) / 4e5) ** 2
                    + ((g.ypa[:, None] - g.ypa.mean()) / 4e5) ** 2))
    pa = at.pa.numpy() + 500.0 * bump * np.array(
        [1.0, 0.6, 0.3])[:, None, None]
    p.name = str(d / "restart_in.nc")
    save_restart(p.name, model, init_ocean_state(
        model, init="rbal", po=eddy_pressure(model.cfg)),
        init_atmos_state(model, init="rbal", pa=pa), 0.0)
    kw = dict(areas_limits=str(d / "areas.limits"), qoc_diag=True,
              ocavg_days=0.25)
    return model.cfg, p, kw


def _channel_case(d):
    """The same for the forced channel (tests/test_torch_driver_channel.py)
    and its mean forcing."""
    p = channel._params(parse_input_params, str(d / "restart_in.nc"))
    model = build_model(params_to_config(p, channel._base(torch_config)),
                        "cpu")
    save_restart(p.name, model, init_ocean_state(
        model, po=eddy_pressure(model.cfg)),
        init_atmos_state(model, init="rbal"), 0.0)
    forcing = channel_windstress(model.cfg, model.grids, tau0=2e-5)
    return model.cfg, p, dict(mean_forcing=forcing)


def _atmos_case(d):
    """(config, RunParams, Driver keywords) of the atmosphere of the
    coupled double gyre alone, from rest (rbal) over a prescribed SST
    with seeded noise, for a quarter day."""
    base = coupled._coupled_base(torch_config).replace(atmos_only=True)
    p = RunParams(**{**coupled.CADENCES, "trun": 0.25 / 365.0,
                     "name": "rbal"})
    cfg = params_to_config(p, base)
    rad = build_model(cfg, "cpu").rad
    rng = np.random.default_rng(3)
    sst = rad.sstbar[:, None] + 2.0 * rng.standard_normal(
        (cfg.nyto, cfg.nxto))
    return cfg, p, dict(sst_mean=sst)


def _halves(cfg, p, kw, d, prefix=""):
    """The runs of a case: straight (d/mesh), its first half (d/seg1)
    and the second half resumed from the first half's restart.nc
    (d/seg2); the directories' names take `prefix`."""
    half = RunParams(**{**vars(p), "trun": p.trun / 2})
    resumed = RunParams(**{**vars(half), "name": str(
        d / f"{prefix}seg1" / "restart.nc")})
    return [(cfg, run, str(d / f"{prefix}{seg}"), kw) for run, seg in
            ((p, "mesh"), (half, "seg1"), (resumed, "seg2"))]


def _cli_case(d):
    """A case directory for the CLI: the forced channel's input.params cut
    to 0.25 days with its cadences, prepared (restart.nc, avges.nc) in
    this process."""
    from qgcm_torch.params import _ORDER
    values = {**channel.CADENCES, "trun": repr(channel.CADENCES["trun"]),
              "name": "restart.nc"}
    names = [name for name, _ in _ORDER]
    lines, i = [], 0
    for line in Path(channel.CASE).read_text().splitlines(keepends=True):
        if line.strip() and not line.startswith("!"):
            if names[i] in values:
                line = f" {values[names[i]]}    !! {names[i]}\n"
            i += 1
        lines.append(line)
    case = d / "cli"
    case.mkdir()
    (case / "input.params").write_text("".join(lines))
    assert main(["prepare", str(case), "--eddy-amp", "0.15", "--forcing",
                 "channel"] + CLI_GRID) == 0
    return case


def _box_cli_case(d):
    """The cut double-gyre box of tests/test_torch_analysis.py, prepared
    in this process, for the CLI's 2x2 mesh."""
    from test_torch_analysis import write_params
    case = d / "box_cli"
    case.mkdir()
    write_params(case / "input.params", **BOX_PARAMS)
    assert main(["prepare", str(case), "--eddy-amp", "0.1", "--forcing",
                 "double-gyre"] + BOX_GRID) == 0
    return case


def _ensemble(case, outdir, members, *extra):
    return ["ensemble", str(case), "--members", str(members), "--days",
            "0.0625", "--sample-days", "0.03125", "--outdir", str(outdir),
            *extra] + CLI_GRID


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module: the port's single-device Driver and
    qgcm_tpu's Driver(mesh) in this process, the mesh runs and the
    commands in 2 gloo ranks (and the gcd warning's in 4), with float64
    files throughout."""
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.params import RunParams as JaxRunParams
    from qgcm_tpu.params import parse_input_params as jax_parse
    from qgcm_tpu.params import params_to_config as jax_params_to_config
    from qgcm_tpu.run import Driver as JaxDriver

    d = tmp_path_factory.mktemp("mesh_driver")
    import subprocess
    import sys
    # `run --mesh 2x2` in 4 processes under torchrun, while the rest runs
    with pytest.MonkeyPatch.context() as mp:
        ranks.float64_files(mp, "qgcm_torch", {})
        box = _box_cli_case(d)
    script = d / "torchrun_cli.py"
    here = Path(__file__).resolve().parent
    script.write_text(TORCHRUN_CLI.format(repo=str(here.parent),
                                          tests=str(here)))
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script), "run", str(box), "--mesh",
         "2x2", "--outdir", str(box / "mesh"), "--dist-backend", "gloo"]
        + BOX_GRID, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    dirs = {"coupled": d / "coupled", "channel": d / "channel",
            "atmos": d / "atmos"}
    for v in dirs.values():
        v.mkdir()
    cases = {"coupled": _coupled_case(dirs["coupled"]),
             "channel": _channel_case(dirs["channel"])}
    atmos = _atmos_case(dirs["atmos"])
    jax_meshes = {"jax_": JaxMesh(np.asarray(jax.devices()[:RANKS]).reshape(
        RANKS, 1), ("y", "x")), "jax2d_": JaxMesh(np.asarray(
            jax.devices()[:4]).reshape(MESH_2D), ("y", "x"))}
    with pytest.MonkeyPatch.context() as mp:
        ranks.float64_files(mp, "qgcm_tpu", {})
        ranks.float64_files(mp, "qgcm_torch", {})
        quick_jit(mp)
        for kind, case in cases.items():
            # the straight run and the halves, as the mesh runs take them
            for cfg, p, out, kw in _halves(*case, dirs[kind], "single_"):
                Driver(build_model(cfg, "cpu"), p, out, verbose=False,
                       **kw).run()
            for prefix, jax_mesh in jax_meshes.items():
                if prefix == "jax2d_" and kind != "coupled":
                    continue        # a channel's mesh has x = 1
                for cfg, p, out, kw in _halves(*case, dirs[kind],
                                               prefix)[1:]:
                    if kind == "coupled":
                        pj = JaxRunParams(**vars(p))
                        base = coupled._coupled_base(jax_config)
                    else:
                        pj = channel._params(jax_parse, p.name)
                        pj.trun = p.trun
                        base = channel._base(jax_config)
                    JaxDriver(jax_build_model(jax_params_to_config(pj, base)),
                              pj, out, mesh=jax_mesh, verbose=False,
                              **kw).run()
        # the atmosphere alone: the single-device Driver and qgcm_tpu's
        # Driver on a 2 x 1 mesh
        cfg, p, kw = atmos
        Driver(build_model(cfg, "cpu"), p, str(dirs["atmos"] / "single"),
               verbose=False, **kw).run()
        # qgcm_tpu's Driver samples the ocean's covariances in an
        # atmosphere-only run and fails there: it runs without them
        pj = JaxRunParams(**{**vars(p), "dtcovoc": 0.0})
        JaxDriver(jax_build_model(jax_params_to_config(
            pj, coupled._coupled_base(jax_config).replace(atmos_only=True))),
            pj, str(dirs["atmos"] / "jax"), mesh=jax_meshes["jax_"],
            verbose=False, **kw).run()
        cli = _cli_case(d)
        assert main(["run", str(cli), "--outdir", str(cli / "single"),
                     "--quiet"] + CLI_GRID) == 0
        assert main(["run", str(box), "--outdir", str(box / "single"),
                     "--quiet"] + BOX_GRID) == 0
        for m in (4, 6):
            assert main(_ensemble(cli, cli / f"ens{m}", m, "--quiet")) == 0
    mesh_runs = [r for kind in cases
                 for r in _halves(*cases[kind], dirs[kind])] + [
        (*atmos[:2], str(dirs["atmos"] / "mesh"), atmos[2])]
    argvs = [["run", str(cli), "--mesh", "rows", "--outdir",
              str(cli / "mesh")] + GLOO + CLI_GRID,
             _ensemble(cli, cli / "ens4_mesh", 4, "--shard-members", *GLOO),
             _ensemble(cli, cli / "ens3_mesh", 3, "--shard-members", *GLOO)]
    for w in ("ranks2", "ranks4"):
        (d / w).mkdir()
    two = spawn_ranks(ranks.driver_rank, RANKS, mesh_runs, argvs,
                      backend="gloo", workdir=d / "ranks2", timeout=120)
    four = spawn_ranks(ranks.driver_rank, 4, _halves(
        *cases["coupled"], dirs["coupled"], "mesh2d_"), [_ensemble(
            cli, cli / "ens6_mesh", 6, "--shard-members", *GLOO)], None,
        MESH_2D, backend="gloo", workdir=d / "ranks4", timeout=120)
    try:
        out, err = torchrun.communicate(timeout=300)
    finally:
        torchrun.kill()
    return dict(dirs=dirs, cli=cli, two=two, four=four, cases=cases,
                box=box, torchrun=(torchrun.returncode, out, err))


SEGMENTS = ["mesh", "seg1", "seg2"]


@pytest.mark.parametrize("seg", SEGMENTS,
                         ids=["straight", "first-half", "resumed"])
@pytest.mark.parametrize("kind", ["coupled", "channel"])
def test_mesh_driver_matches_single_device(runs, kind, seg):
    """Every file of the 2-rank Driver (written by the primary rank)
    within 1e-11 of its largest magnitude of the port's single-device
    Driver (the atmosphere's energy tendencies within 1e-9:
    TENDENCY_TOL); the same file set and input_parameters.m; no rank
    aborted. Over the whole run, its first half, and the second half
    resumed from the first half's restart.nc (which the primary rank
    wrote, and every rank read and cut into its blocks). The channel's
    resumed half ends where its straight run ends, at roundoff
    (tests/test_torch_driver_channel.py's RESUME_TOL): its initial
    duplicate column is repaired when q is derived."""
    d = runs["dirs"][kind]
    want = f"single_{seg}"
    if kind == "channel" and seg == "seg2":
        coupled.assert_same_file(d, "lastday.nc", channel.RESUME_TOL,
                                 got="seg2", want="mesh")
    assert coupled._files(d / seg) == coupled._files(d / want)
    for name in coupled._files(d / want):
        if name.endswith(".nc"):
            coupled.assert_same_file(d, name, SINGLE_TOL, got=seg,
                                     want=want, rtols=TENDENCY_TOL)
        else:
            # which restart each resumed from
            assert (d / seg / name).read_text() == \
                (d / want / name).read_text().replace("single_seg1", "seg1")
    assert all(not r["runs"][i]["aborted"] for r in runs["two"]
               for i in range(6))


@pytest.mark.parametrize("seg", SEGMENTS,
                         ids=["straight", "first-half", "resumed"])
def test_2d_mesh_driver_matches_single_device(runs, seg):
    """The coupled box's Driver on a 2x2 mesh of 4 ranks (blocks of rows
    and columns in the carry and the running means, the T fields gathered
    over columns at the cadence boundaries, the restart written by the
    primary rank and resumed on every rank): every file within 1e-11 of
    the port's single-device Driver (the tendencies: TENDENCY_TOL), the
    same file set and input_parameters.m, no rank aborted."""
    d = runs["dirs"]["coupled"]
    got, want = f"mesh2d_{seg}", f"single_{seg}"
    assert coupled._files(d / got) == coupled._files(d / want)
    for name in coupled._files(d / want):
        if name.endswith(".nc"):
            coupled.assert_same_file(d, name, SINGLE_TOL, got=got,
                                     want=want, rtols=TENDENCY_TOL)
        else:
            assert (d / got / name).read_text() == \
                (d / want / name).read_text().replace("single_seg1",
                                                      "mesh2d_seg1")
    assert all(not r["runs"][i]["aborted"] for r in runs["four"]
               for i in range(3))


@pytest.mark.parametrize("name", ["monit.nc", "restart.nc"])
@pytest.mark.parametrize("seg", SEGMENTS[1:], ids=["first-half", "resumed"])
def test_2d_mesh_driver_matches_qgcm_tpu_mesh_driver(runs, seg, name):
    """monit.nc and the restart of the coupled box's Driver on a 2x2 mesh
    within 1e-9 of qgcm_tpu's Driver on 2x2 devices, over the first half
    and the resumed second half (there also lastday.nc)."""
    d = runs["dirs"]["coupled"]
    coupled.assert_same_file(d, name, JAX_TOL, got=f"mesh2d_{seg}",
                             want=f"jax2d_{seg}")
    if seg == "seg2":
        coupled.assert_same_file(d, "lastday.nc", JAX_TOL,
                                 got=f"mesh2d_{seg}", want=f"jax2d_{seg}")


def test_cli_run_mesh_2x2_under_torchrun(runs):
    """`run --mesh 2x2 --dist-backend gloo` on the cut double-gyre box in
    4 processes under torchrun: exit 0, the mesh line (qgcm_tpu's)
    printed once, and monit.nc and lastday.nc within 1e-11 of the
    single-process run (the ocean's energy tendencies within 1e-9, and
    its roundoff-sized mean Ekman velocity: OCEAN_TENDENCY_TOL)."""
    code, out, err = runs["torchrun"]
    assert code == 0, err[-3000:]
    assert out.count("mesh: {'y': 2, 'x': 2} over 4 devices "
                     "(a2a spectral solvers)") == 1
    for name in ("monit.nc", "lastday.nc"):
        coupled.assert_same_file(runs["box"], name, SINGLE_TOL, got="mesh",
                                 want="single", rtols=OCEAN_TENDENCY_TOL)


@pytest.mark.parametrize("name", ["monit.nc", "restart.nc"])
@pytest.mark.parametrize("seg", SEGMENTS[1:], ids=["first-half", "resumed"])
@pytest.mark.parametrize("kind", ["coupled", "channel"])
def test_mesh_driver_matches_qgcm_tpu_mesh_driver(runs, kind, seg, name):
    """monit.nc and the restart of the 2-rank Driver within 1e-9 of
    qgcm_tpu's Driver on a 2 x 1 mesh, over the first half of the run and
    the second half resumed from the first half's restart.nc (the
    final restart: restart.nc, and lastday.nc as well)."""
    d = runs["dirs"][kind]
    coupled.assert_same_file(d, name, JAX_TOL, got=seg, want=f"jax_{seg}")
    if seg == "seg2":
        coupled.assert_same_file(d, "lastday.nc", JAX_TOL, got=seg,
                                 want=f"jax_{seg}")


def test_atmos_only_mesh_driver(runs):
    """The atmosphere alone (atmos_only over a prescribed SST) through
    Driver(mesh) on 2 ranks, the atmosphere cut by rows: every file within
    1e-11 of its largest magnitude of the port's single-device Driver
    (the energy tendencies: TENDENCY_TOL), the same file set, and
    monit.nc and lastday.nc within 1e-9 of qgcm_tpu's Driver on a 2 x 1
    mesh (the mean Ekman velocities: WETMAT_TOL); no rank
    aborted; the same collectives on both ranks, the
    decomposed xforc's gather and all_reduce once a cycle (and at the
    start)."""
    d = runs["dirs"]["atmos"]
    assert coupled._files(d / "mesh") == coupled._files(d / "single")
    for name in coupled._files(d / "single"):
        if name.endswith(".nc"):
            coupled.assert_same_file(d, name, SINGLE_TOL, got="mesh",
                                     want="single", rtols=TENDENCY_TOL)
    for name in ("monit.nc", "lastday.nc"):
        coupled.assert_same_file(d, name, JAX_TOL, got="mesh", want="jax",
                                 rtols=WETMAT_TOL)
    a, b = (r["runs"][6] for r in runs["two"])
    assert not a["aborted"] and not b["aborted"]
    assert a["counts"] == b["counts"]
    cycles = 120 // 3
    assert a["counts"]["coupling.gather"] == \
        a["counts"]["coupling.sums"] == cycles + 1
    assert a["counts"]["atmos.inversion.sums"] == 120


def test_mesh_driver_collectives(runs):
    """The coupled mesh Driver's collectives: the decomposed xforc's one
    all_reduce a cycle (and one more at each monitor record), the fail-
    fast verdicts, the gathers at cadence boundaries and the running
    means' face exchanges (the ocean's a substep, the atmosphere's a
    step); the same counts on both ranks."""
    a, b = (r["runs"][0]["counts"] for r in runs["two"])
    assert a == b
    cycles = 240 // 3
    assert a["coupling.sums"] == cycles + 1 + 4      # + initial + monit
    assert a["timavge.rows"] == 2 * cycles
    assert a["timavge.atmos.rows"] == 2 * 240
    assert a["run.verdict"] == 4 + 2                 # valday + resday
    assert a["gather"] > 0


def test_cli_run_mesh_rows(runs):
    """`run --mesh rows --dist-backend gloo` in 2 ranks: exit 0 on every
    rank, the mesh line (qgcm_tpu's) printed once, by the primary rank,
    and monit.nc and lastday.nc within 1e-11 of the single-process run."""
    out = [r["cli"][0] for r in runs["two"]]
    assert [code for code, _ in out] == [0, 0]
    assert "mesh: {'y': 2, 'x': 1} over 2 devices (a2a spectral solvers)" \
        in out[0][1]
    assert out[1][1] == ""
    for name in ("monit.nc", "lastday.nc"):
        coupled.assert_same_file(runs["cli"], name, SINGLE_TOL, got="mesh",
                                 want="single")


def _ens(path):
    with netcdf_file(str(path / "ensemble.nc"), "r", mmap=False) as f:
        return {v: f.variables[v][:].copy() for v in f.variables}


def _jax_shard_messages(case, members, n, capsys):
    """What qgcm_tpu's `ensemble --shard-members` says with `members`
    members over n devices, up to building its runner."""
    import qgcm_tpu.models.ensemble as jens
    from qgcm_tpu.cli import main as jax_main

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    devices = jax.devices()[:n]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a: devices)
        mp.setattr(jens, "perturbed_ocean_members", lambda *a, **k: None)
        mp.setattr(jens, "make_ensemble_runner", stop)
        capsys.readouterr()
        try:
            jax_main(["ensemble", str(case), "--members", str(members),
                      "--shard-members", "--outdir", str(case / "jax_ens"),
                      "--quiet", *CLI_GRID[:-2]])
        except SystemExit as e:
            return str(e.code)
        except Stop:
            return capsys.readouterr().out
    raise AssertionError("qgcm_tpu's ensemble did not stop")


def test_cli_ensemble_shard_members(runs, capsys):
    """`ensemble --shard-members`: 4 members over 2 ranks and 6 over 4
    (qgcm_tpu's gcd rule: 2 of the 4 ranks step them, the others stop)
    write ensemble.nc bit for bit the single-process command's; 3 over 2
    refuse on every rank. Every message is qgcm_tpu's, word for word."""
    cli = runs["cli"]
    for m, outs in ((4, [r["cli"][1] for r in runs["two"]]),
                    (6, [r["cli"][0] for r in runs["four"]])):
        assert all(code == 0 for code, _ in outs)
        want, got = _ens(cli / f"ens{m}"), _ens(cli / f"ens{m}_mesh")
        assert set(got) == set(want)
        for v in want:
            assert np.array_equal(got[v], want[v]), (m, v)
        n = len(outs)
        said = _jax_shard_messages(cli, m, n, capsys)
        assert outs[0][1].startswith(said)
        assert all(text == "" for _, text in outs[1:])
    refused = [r["cli"][2] for r in runs["two"]]
    want = _jax_shard_messages(cli, 3, RANKS, capsys)
    assert want.startswith("--shard-members: 3 members share no factor")
    assert all(code == want for code, _ in refused)


def test_failure_on_one_rank_stops_every_rank(runs, tmp_path):
    """A validity failure that only rank 1 sees: the verdict goes
    through an all_reduce, so both ranks abort (exit 1) at the same
    cadence boundary instead of one waiting in a collective; and a rank
    that raises makes the spawn raise, the other rank ended, well
    inside the spawn's timeout."""
    cli = runs["cli"]
    argv = (["run", str(cli), "--mesh", "rows", "--outdir",
             str(tmp_path / "failed")] + GLOO + CLI_GRID)
    for w in ("fail", "raise"):
        (tmp_path / w).mkdir()
    res = spawn_ranks(ranks.driver_rank, RANKS, [], [argv], 1,
                      backend="gloo", workdir=tmp_path / "fail", timeout=120)
    assert [r["cli"][0][0] for r in res] == [1, 1]
    assert not (tmp_path / "failed" / "lastday.nc").exists()
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="terminated with the following"):
        spawn_ranks(ranks.raising_rank, RANKS, 10, backend="gloo",
                    workdir=tmp_path / "raise", timeout=120)
    assert time.perf_counter() - t0 < 60
