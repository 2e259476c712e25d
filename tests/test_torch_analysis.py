"""The port's post-processing and its new commands, on the CPU.

`analyze` (qgcm_torch/analysis/, a copy of qgcm_tpu/analysis/, and
cli.cmd_analyze) against qgcm_tpu's on the same run directories: a
short ocean-only double gyre run through the port's CLI, the same with
a resumed second segment (--chain), and an ensemble.nc. Both write
byte-identical files (scipy's netCDF writer in both) and print the same
summary. Then the port's `ensemble`, `sense` and `run --profile` end to
end on the cut case with --device cpu: qgcm_tpu's ensemble.nc and
sensitivity.nc schemas, the segmented adjoint within 1e-12 of the one
program (the arithmetic of one program, recomputed), and a profile that
names the fused step."""

import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
from scipy.io import netcdf_file

from qgcm_tpu.cli import main as jax_cli
from qgcm_torch.cli import main as port_cli
from qgcm_torch.params import _ORDER

from test_torch_cases import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

EXAMPLE = (Path(__file__).resolve().parents[1] / "examples"
           / "double_gyre_ocean_only" / "input.params")
GRID = ["--preset", "double_gyre_ocean_only", "--nxaooc", "8", "--nyaooc",
        "8", "--ndxr", "4", "--nxta", "16", "--nyta", "16", "--device", "cpu"]
# one day of the cut double gyre, with every output the analysis reads
PARAMS = dict(trun="0.002739726D0", dgnday="0.25d0", odiday="0.5d0",
              prtday="0.5d0", resday="0.5d0", name="restart.nc")


def write_params(dst, **values):
    """examples/double_gyre_ocean_only/input.params with `values`
    replaced (the reference's order of lines, qgcm_torch.params)."""
    names = [name for name, _ in _ORDER]
    lines, i = [], 0
    for line in EXAMPLE.read_text().splitlines(keepends=True):
        if line.strip() and not line.startswith("!"):
            if names[i] in values:
                line = f" {values[names[i]]}    !! {names[i]}\n"
            i += 1
        lines.append(line)
    Path(dst).write_text("".join(lines))


def cli(main, argv):
    """(exit code, standard output) of a CLI's main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A prepared cut case run for a day (outdata) and resumed for half
    a day (outdata_r2), with scipy's netCDF writer."""
    mp = pytest.MonkeyPatch()
    mp.setenv("QGCM_IO_BACKEND", "scipy")
    c = tmp_path_factory.mktemp("cli") / "case"
    c.mkdir()
    write_params(c / "input.params", **PARAMS)
    assert cli(port_cli, ["prepare", c, "--eddy-amp", "0.1", "--forcing",
                          "double-gyre"] + GRID)[0] == 0
    assert cli(port_cli, ["run", c, "--quiet"] + GRID)[0] == 0
    assert cli(port_cli, ["run", c, "--quiet", "--resume", "--trun",
                          "0.00137"] + GRID)[0] == 0
    yield c
    mp.undo()


def twins(case, tmp_path):
    """Two copies of the case: one for each package's analyze."""
    return [Path(shutil.copytree(case, tmp_path / name))
            for name in ("jax", "port")]


def assert_same_analysis(dirs, argv, written):
    """Both packages' analyze on their copy: the same exit code and
    output (the copies' paths aside), byte-identical written files."""
    out = []
    for d, main in zip(dirs, (jax_cli, port_cli)):
        rc, text = cli(main, [a.format(d=d) for a in argv])
        assert rc == 0
        out.append(text.replace(str(d), "CASE"))
    assert out[0] == out[1]
    for name in written:
        a, b = ((d / name).read_bytes() for d in dirs)
        assert a == b, name
    return out[1]


def test_analyze_matches_jax(case, tmp_path):
    text = assert_same_analysis(
        twins(case, tmp_path), ["analyze", "{d}/outdata"],
        ["outdata/monit_energy.nc", "outdata/sshmax_etc.nc"])
    assert "monit.nc: 4 records" in text and "te_fin_over_ini" in text


def test_analyze_chain_matches_jax(case, tmp_path):
    text = assert_same_analysis(
        twins(case, tmp_path), ["analyze", "{d}/outdata", "--chain"],
        ["outdata_unified/monit.nc", "outdata_unified/monit_energy.nc"])
    assert "unified 2 segments" in text and "monit.nc: 6 records" in text


@pytest.fixture(scope="module")
def ensemble(case):
    """The port's ensemble command on the case: 3 members, half a day,
    sampled every eighth of a day."""
    rc, text = cli(port_cli, ["ensemble", case, "--members", "3", "--days",
                              "0.5", "--sample-days", "0.125", "--quiet"]
                   + GRID)
    assert rc == 0
    return case / "outdata_ens" / "ensemble.nc", text


def test_ensemble_writes_the_jax_schema(ensemble):
    path, text = ensemble
    assert "(5 records, 3 members)" in text
    with netcdf_file(path, "r", mmap=False) as f:
        assert f.dimensions == {"time": None, "member": 3}
        want = {"tyrs": ("time",), "spread_po": ("time",),
                "spread_sst": ("time",), "po_rms": ("time", "member")}
        assert {k: v.dimensions for k, v in f.variables.items()} == want
        assert f.variables["spread_po"].units == b"m^2/s^2"
        sp = f.variables["spread_po"][:].copy()
        t = f.variables["tyrs"][:].copy()
    assert np.all(sp > 0) and np.all(np.isfinite(sp))
    assert np.allclose(np.diff(t) * 365.0, 0.125)


def test_analyze_ensemble_matches_jax(ensemble, tmp_path):
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name / "outdata_ens"
        d.mkdir(parents=True)
        shutil.copy(ensemble[0], d)
        dirs.append(tmp_path / name)
    text = assert_same_analysis(dirs, ["analyze", "{d}/outdata_ens"], [])
    assert "ensemble.nc: 3 members, 5 records, 0.50 days" in text


def test_sense_segments_equal_one_program(case, tmp_path):
    """`sense` for half a day with quarter-day host segments against one
    program: the same sensitivity.nc within 1e-12 of each field's max,
    in qgcm_tpu's schema."""
    got = []
    for seg in ("0", "0.25"):
        out = tmp_path / f"seg{seg}"
        rc, text = cli(port_cli, ["sense", case, "--days", "0.5",
                                  "--segment-days", seg, "--outdir",
                                  out] + GRID)
        assert rc == 0 and "objective value" in text
        with netcdf_file(out / "sensitivity.nc", "r", mmap=False) as f:
            got.append({k: (v.dimensions, np.array(v.data))
                        for k, v in f.variables.items()})
    assert sorted(got[0]) == ["dJ_dfnetoc", "dJ_dpo", "dJ_dsst",
                              "dJ_dtauxo", "dJ_dtauyo", "objective"]
    assert got[0]["dJ_dpo"][0] == ("zo", "ypo", "xpo")
    for name, (dims, a) in got[0].items():
        b = got[1][name][1]
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), name
    assert np.abs(got[0]["dJ_dtauxo"][1]).max() > 0


def test_run_profile_writes_a_trace(case, tmp_path):
    prof = tmp_path / "prof"
    rc, text = cli(port_cli, ["run", case, "--outdir", tmp_path / "out",
                              "--profile", prof] + GRID)
    assert rc == 0
    assert (prof / "trace.json").stat().st_size > 0
    report = text[text.index("profile of"):]
    assert "host self time by op" in report and "qgcm_torch::qgstep" in report
