"""The port's I/O, parameters, reports and topography against
qgcm_tpu's, on the CPU in float64: restart files written by either
package are read by the other (stored fields bit for bit, PV recomputed
from pressure within 1e-12); every output writer gives qgcm_tpu's
names, dimensions, units and types; input.params parses the same; the
'define' topographies step as in qgcm_tpu within 1e-12."""

import glob
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import qgcm_tpu.config as jax_config
import qgcm_tpu.diags.areas as j_areas
import qgcm_tpu.diags.covaria as j_cov
import qgcm_tpu.diags.timavge as j_tav
import qgcm_tpu.io as j_io
import qgcm_tpu.params as j_params
import qgcm_tpu.report as j_report
import qgcm_tpu.topo as j_topo
import qgcm_torch.config as torch_config
import qgcm_torch.diags.areas as t_areas
import qgcm_torch.diags.covaria as t_cov
import qgcm_torch.diags.timavge as t_tav
import qgcm_torch.io as t_io
import qgcm_torch.params as t_params
import qgcm_torch.report as t_report
import qgcm_torch.topo as t_topo
from qgcm_tpu.diags.monitor import MonitorWriter as JaxMonitorWriter
from qgcm_tpu.diags.qocdiag import QocdiagWriter as JaxQocdiagWriter
from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.atmos import init_atmos_state as jax_init_atmos
from qgcm_tpu.models.ocean import init_ocean_state as jax_init_ocean
from qgcm_tpu.models.ocean import make_ocean_step as jax_make_ocean_step
from qgcm_tpu.models.ocean import ocean_forcing_from_mean as jax_mean_forcing
from qgcm_tpu.models.stepper import make_coupled_runner as jax_coupled
from qgcm_torch.convert import atmos_state_to_torch, state_to_torch
from qgcm_torch.diags.monitor import MonitorWriter, compute_monitor
from qgcm_torch.diags.qocdiag import QocdiagWriter, qocdiag_terms
from qgcm_torch.generators import double_gyre_windstress, eddy_pressure
from qgcm_torch.io import native
from qgcm_torch.io.ncdf import make_writer
from qgcm_torch.model import build_model
from qgcm_torch.models.ocean import _oml, make_ocean_step
from qgcm_torch.models.stepper import make_coupled_runner

from test_torch_cases import (assert_match, cfg_pair, get_case, numpy_of,
                              one_torch_thread, quick_compile, to_port)

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORED = {"oc": ("po", "pom", "sst", "sstm"),
          "at": ("pa", "pam", "ast", "astm", "hmixa", "hmixam")}
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


def schema(path):
    """{variable: (dimensions, type code, units)} and the dimension
    sizes of a netCDF file."""
    with netcdf_file(path, "r", mmap=False) as f:
        return ({n: (v.dimensions, v.typecode(),
                     getattr(v, "units", None))
                 for n, v in f.variables.items()}, dict(f.dimensions))


def contents(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return {n: np.array(v[:]) for n, v in f.variables.items()}


def assert_same_file(got, want, tol=0.0):
    """The same schema, and every variable within tol of its largest
    magnitude (0: bit for bit)."""
    assert schema(got) == schema(want)
    a, b = contents(got), contents(want)
    for n in b:
        scale = np.abs(b[n]).max() if b[n].size else 0.0
        assert np.abs(a[n] - b[n]).max(initial=0.0) <= tol * scale, n


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_crosses_between_packages(writer, tmp_path):
    """A restart written by either package (with the mid-cycle forcing
    embedded) is the other's file, bit for bit, and each package reads
    both: the stored fields and forcing back bit for bit, the fields a
    load rederives from pressure (PV, constraint integrals) within
    1e-12 of the writer's own reload."""
    c = get_case("coupled")
    pj, pt = str(tmp_path / "jax.nc"), str(tmp_path / "port.nc")
    j_io.save_restart(pj, c.jm, c.jax_oc, c.jax_at, 0.25,
                      ofor=c.jax_ofor, afor=c.jax_afor)
    t_io.save_restart(pt, c.model, c.oc, c.at, 0.25, ofor=c.ofor,
                      afor=c.afor)
    assert_same_file(pt, pj)
    path = pj if writer == "jax" else pt
    oc_t, at_t, tini_t = t_io.load_restart(path, c.model)
    oc_j, at_j, tini_j = j_io.load_restart(path, c.jm)
    assert tini_t == tini_j == 0.25
    for got, want, nt in ((oc_t, oc_j, "oc"), (at_t, at_j, "at")):
        g, w = numpy_of(got), numpy_of(want)
        src = numpy_of(getattr(c, f"jax_{nt}"))
        for name in STORED[nt]:
            assert np.array_equal(g[name], src[name]), name
            assert np.array_equal(w[name], src[name]), name
        # the constraint integrals are differences of nearly equal
        # layer integrals: held at 1e-12 of area x max|p|
        grids = c.model.grids
        if nt == "oc":
            s = grids.xlo * grids.ylo * np.abs(src["po"]).max()
            scale = {"dpioc": s, "dpiocp": s}
        else:
            s = grids.xla * grids.yla * np.abs(src["pa"]).max()
            scale = {"dpiat": s, "dpiatp": s}
        assert_match(got, want, scale=scale)
    for got, want in zip(t_io.load_restart_forcing(path, c.model),
                         j_io.load_restart_forcing(path, c.jm)):
        for name, arr in numpy_of(got).items():
            assert np.array_equal(arr, numpy_of(want)[name]), name


def test_writers_have_the_reference_schema(tmp_path):
    """Snapshots, avges.nc, covar.nc, areas.nc, qocdiag.nc, monit.nc,
    the mean-forcing file and topog.nc, written by each package from
    the same state: the same names, dimensions, units and types; the
    data within 1e-12. monit.nc's values are held in
    tests/test_torch_diags.py: qgcm_tpu's native writer fills the
    interfaces of the ermaso/emfroc placeholder with whatever follows
    its one value in memory (ROADMAP.md section 3)."""
    c = get_case("coupled")
    m, jm = c.model, c.jm
    os.makedirs(tmp_path / "j"), os.makedirs(tmp_path / "t")
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")

    for snap, st, fo in ((j_io.OceanSnapshots(dj, jm, stride=2), c.jax_oc,
                          c.jax_ofor),
                         (j_io.AtmosSnapshots(dj, jm), c.jax_at, c.jax_afor),
                         (t_io.OceanSnapshots(dt, m, stride=2), c.oc, c.ofor),
                         (t_io.AtmosSnapshots(dt, m), c.at, c.afor)):
        for r in range(2):
            snap.append(st, fo, 0.1 * r)
        snap.close()

    # the running means, covariances, box averages, dq/dt terms and the
    # monitor record (held against qgcm_tpu's in
    # tests/test_torch_diags.py) go through both packages' writers
    acc = [t_tav.accumulate_ocean(t_tav.zero_ocean_averages(m), c.oc,
                                  c.ofor, m),
           t_tav.accumulate_atmos(t_tav.zero_atmos_averages(m), c.at,
                                  c.afor, m)]
    t_tav.write_avges(f"{dt}/avges.nc", m, *acc)
    j_tav.write_avges(f"{dj}/avges.nc", jm,
                      *(cls(**numpy_of(a)) for cls, a in zip(
                          (j_tav.OceanAverages, j_tav.AtmosAverages), acc)))

    covs = {}
    for sfx, field, nsi, grid in (("po", c.oc.po[0], 2, "p"),
                                  ("to", c.oc.sst, 2, "t"),
                                  ("pa", c.at.pa[0], 1, "p"),
                                  ("ta", c.at.ast, 1, "t")):
        a = t_cov.zero_cov(t_cov.cov_size(*field.shape, nsi, grid=grid))
        for k in range(2):
            a = t_cov.accumulate_cov(a, field * (1 + k), nsi, grid)
        covs[sfx] = a
    t_cov.write_covar(f"{dt}/covar.nc", covs)
    j_cov.write_covar(f"{dj}/covar.nc", {
        k: j_cov.CovAccum(**numpy_of(a)) for k, a in covs.items()})

    limits = tmp_path / "areas.limits"
    limits.write_text(AREAS)
    boxes = t_areas.build_area_boxes(m, str(limits))
    tav = t_areas.area_averages(boxes, c.oc.sst, c.at.ast)
    for w in (j_areas.AreasWriter(f"{dj}/areas.nc",
                                  j_areas.build_area_boxes(jm, str(limits))),
              t_areas.AreasWriter(f"{dt}/areas.nc", boxes)):
        w.append(0.5, *tav)
        w.close()

    terms = qocdiag_terms(m, c.oc, c.ofor, _oml(m, c.oc, c.ofor)[2])
    record = compute_monitor(m, *c.args())
    for w, rec in ((JaxQocdiagWriter(f"{dj}/qocdiag.nc", jm, stride=2),
                    terms), (QocdiagWriter(f"{dt}/qocdiag.nc", m, stride=2),
                             terms),
                   (JaxMonitorWriter(f"{dj}/monit.nc", jm), record),
                   (MonitorWriter(f"{dt}/monit.nc", m), record)):
        w.append(rec, 0.5)
        w.close()

    f = double_gyre_windstress(c.cfg, m.grids)
    j_io.write_mean_forcing(f"{dj}/avges_in.nc", jm, *f, sst=f[2])
    t_io.write_mean_forcing(f"{dt}/avges_in.nc", m, *f, sst=f[2])
    j_topo.write_topog(f"{dj}/topog.nc", jm)
    t_topo.write_topog(f"{dt}/topog.nc", m)

    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and len(names) == 11
    for n in names:
        if n == "monit.nc":
            assert schema(f"{dt}/{n}") == schema(f"{dj}/{n}")
        else:
            assert_same_file(f"{dt}/{n}", f"{dj}/{n}", tol=1e-12)
    for a, b in zip(t_io.read_mean_forcing(f"{dt}/avges_in.nc"), f):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "examples", "*", "input.params"))),
    ids=lambda p: os.path.basename(os.path.dirname(p)))
def test_input_params_parse_as_in_jax(path, tmp_path):
    """Every example case's input.params gives the same RunParams and,
    merged into its preset, the same configuration and
    input_parameters.m as in qgcm_tpu."""
    import dataclasses
    pj, pt = j_params.parse_input_params(path), t_params.parse_input_params(
        path)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    case = os.path.basename(os.path.dirname(path))
    preset = next((n for n in torch_config.PRESETS if case.startswith(n)),
                  "double_gyre_ocean_only" if "natl" not in case
                  else "natl_1km")
    cj = j_params.params_to_config(pj, jax_config.PRESETS[preset]())
    ct = t_params.params_to_config(pt, torch_config.PRESETS[preset]())
    # qgcm_tpu's Pallas switch is the one field the port does not have
    assert dataclasses.asdict(ct) == {
        k: v for k, v in dataclasses.asdict(cj).items() if k != "use_pallas"}
    j_params.write_matlab_params(str(tmp_path / "j.m"), pj, cj)
    t_params.write_matlab_params(str(tmp_path / "t.m"), pt, ct)
    assert (tmp_path / "t.m").read_text() == (tmp_path / "j.m").read_text()


def test_reports_match_jax():
    """The startup, memory and sample reports are qgcm_tpu's, apart
    from the package's name in the heading and the workspace it does
    not count."""
    c = get_case("coupled")
    start = t_report.startup_report(c.model)
    assert start.splitlines()[0] == "qgcm_torch derived parameters"
    assert (start.splitlines()[1:]
            == j_report.startup_report(c.jm).splitlines()[1:])
    assert (t_report.memory_report(c.model).replace("PyTorch", "XLA")
            == j_report.memory_report(c.jm))
    assert (t_report.sample_report(c.model, c.oc, c.at)
            == j_report.sample_report(c.jm, c.jax_oc, c.jax_at))


def test_native_writer_builds_under_build(tmp_path):
    """The native writer's library is built from native/ncwriter.cc into
    build/qgcm_torch/, and writes a file scipy reads; an unknown
    backend is refused."""
    if not native.available():
        pytest.skip("g++ is not available")
    assert native._lib_path().parent == native._BUILD_DIR
    assert native._BUILD_DIR.parts[-2:] == ("build", "qgcm_torch")
    w = make_writer(str(tmp_path / "n.nc"), backend="native")
    assert isinstance(w, native.NativeNcWriter)
    w.dim("time", None)
    w.dim("x", 3)
    w.var("x", "d", ("x",), units="km", data=[1.0, 2.0, 3.0])
    w.var("v", "f", ("time", "x"))
    for r in range(2):
        w.append("v", r, np.arange(3.0) + r)
    w.close()
    got = contents(str(tmp_path / "n.nc"))
    assert np.array_equal(got["v"], [[0, 1, 2], [1, 2, 3]])
    with pytest.raises(ValueError):
        make_writer(str(tmp_path / "x.nc"), backend="netcdf4")


def _topo_coupled(cfgmod):
    """A small coupled box whose atmosphere is wide enough (48 x 200 km)
    for the 'define' Rockies and whose ocean (12 x 200 km, centred)
    reaches the 'define' mid-Atlantic ridge, with the ridge clear of
    the ocean's footprint."""
    return cfgmod.ModelConfig(
        nxta=48, nyta=12, nxaooc=12, nyaooc=4, ndxr=2, dta=600.0,
        ocean=cfgmod.OceanConfig(dxo=100.0e3)).validate()


@pytest.mark.parametrize("kind", ["box-substep", "coupled-cycle"])
def test_define_topography_matches_jax(kind, tmp_path):
    """build_model(topocname='define', topatname='define'): one ocean
    box substep and one coupling cycle against qgcm_tpu at 1e-12; the
    topography is nonzero, written to topog.nc and read back as
    'extant' to the same model."""
    topo = dict(topocname="define", topatname="define")
    if kind == "box-substep":
        cfg_j, cfg_t = cfg_pair("pallas", nlo=3)
    else:
        cfg_j, cfg_t = _topo_coupled(jax_config), _topo_coupled(torch_config)
    jm = jax_build_model(cfg_j, **topo)
    model = build_model(cfg_t, "cpu", **topo)
    assert np.array_equal(model.topo.dtopoc, jm.topo.dtopoc)
    assert model.topo.dtopoc.any()
    po = eddy_pressure(cfg_t)
    if kind == "box-substep":
        tau = double_gyre_windstress(cfg_t, model.grids)

        def substep(po, *tau):
            st, f = jax_init_ocean(jm, po=po), jax_mean_forcing(jm, *tau)
            return st, f, jax_make_ocean_step(jm)(st, f)[0]
        st_j, f_j, want = quick_compile(jax.jit(substep), po, *tau)(po, *tau)
        st_t, f_t = to_port(st_j, f_j)
        got, _ = make_ocean_step(model)(st_t, f_t)
        area_po = model.grids.xlo * model.grids.ylo * float(
            np.abs(want.po).max())
        assert_match(got, want, scale={"dpioc": area_po, "dpiocp": area_po})
    else:
        assert model.topo.dtopat.any()
        def cycle(po):
            oc = jax_init_ocean(jm, init="rbal", po=po)
            at = jax_init_atmos(jm, init="rbal")
            return oc, at, jax_coupled(jm)(oc, at, 3)
        oc_j, at_j, want = quick_compile(jax.jit(cycle), po)(po)
        got = make_coupled_runner(model)(
            state_to_torch(numpy_of(oc_j), "cpu"),
            atmos_state_to_torch(numpy_of(at_j), "cpu"), 3)
        # constraint integrals: differences of nearly equal layer
        # integrals, held at 1e-12 of area x max|p|
        g = model.grids
        area_po = g.xlo * g.ylo * float(np.abs(want[0].po).max())
        area_pa = g.xla * g.yla * float(np.abs(want[1].pa).max())
        assert_match(got, want, scale={
            "0.dpioc": area_po, "0.dpiocp": area_po,
            "1.dpiat": area_pa, "1.dpiatp": area_pa})
    path = str(tmp_path / "topog.nc")
    t_topo.write_topog(path, model)
    shape_o, shape_a = ((cfg_t.nypo, cfg_t.nxpo), (cfg_t.nypa, cfg_t.nxpa))
    ext = build_model(cfg_t, "cpu", topocname="extant", topatname="extant",
                      extant_oc=t_topo._load_netcdf(path, "dtopoc", shape_o),
                      extant_at=t_topo._load_netcdf(path, "dtopat", shape_a))
    assert torch.equal(ext.ddyn, model.ddyn)
    assert torch.equal(ext.ddyn_at, model.ddyn_at)
