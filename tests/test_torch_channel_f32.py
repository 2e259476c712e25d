"""The forced channel's float32 scatter, qgcm_tpu against the port.

The one-substep energy tendencies of monit.nc (ddtkeoc, ddtpeoc) are
differences of nearly equal energies: in float32 they scatter about
their float64 values. On the card the port's float32 forced channel sat
8.28e-2 from float64 where the committed TPU record sat 2.55e-3. Here
both packages run the same cut case (examples/southern_ocean_forced_1yr
under the channel wind of `prepare --forcing channel`, from rest)
through their CLIs on the CPU, in float32 and float64, and each
package's float32 run is measured against its own float64 run: if the
port scattered where qgcm_tpu does not, the port would be at fault.

    PYTHONPATH=. python tests/test_torch_channel_f32.py [--tall]

prints every monit series' scatter for both packages over 10 days,
on the 48x16 ocean of tests/test_torch_driver_channel.py or (--tall)
on 577x193, whose 577 rows are the production channel's and take its
matrix-product y-transforms."""

import contextlib
import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import netcdf_file

from qgcm_tpu.cli import main as jax_cli
from qgcm_torch.cli import main as port_cli

from test_torch_cases import one_torch_thread, quick_jit

CASE = (Path(__file__).resolve().parents[1] / "examples"
        / "southern_ocean_forced_1yr" / "input.params")
SMALL = ["--nxta", "12", "--nyta", "6", "--nxaooc", "12", "--nyaooc", "4",
         "--ndxr", "4"]
TALL = ["--nxta", "4", "--nyta", "12", "--nxaooc", "4", "--nyaooc", "12",
        "--ndxr", "48"]
PACKAGES = {"qgcm_tpu": (jax_cli, []),
            "qgcm_torch": (port_cli, ["--device", "cpu"])}


def monit(root, grid, days):
    """{(package, dtype): {series: array}} of the cut case run `days`
    days through each package's CLI in float32 and float64."""
    runs = {}
    for pkg, (main, extra) in PACKAGES.items():
        for dtype in ("float64", "float32"):
            case = Path(root) / f"{pkg}_{dtype}"
            case.mkdir(parents=True)
            shutil.copy(CASE, case)
            base = ["--preset", "southern_ocean_ocean_only", "--dtype",
                    dtype] + grid + extra
            with contextlib.redirect_stdout(io.StringIO()):
                for argv in (["prepare", case, "--forcing", "channel"],
                             ["run", case, "--quiet", "--trun",
                              repr(days / 365.0)]):
                    if main([str(a) for a in argv + base]):
                        raise RuntimeError(f"{pkg} {argv[0]} failed")
            with netcdf_file(case / "outdata" / "monit.nc", "r",
                             mmap=False) as f:
                runs[pkg, dtype] = {k: np.array(v[:], np.float64)
                                    for k, v in f.variables.items()}
    return runs


def scatter(runs, name):
    """{package: max|float32 - float64| / max|float64|} of one series."""
    out = {}
    for pkg in PACKAGES:
        a, b = runs[pkg, "float32"][name], runs[pkg, "float64"][name]
        out[pkg] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


@pytest.mark.usefixtures(one_torch_thread.__name__)
def test_port_float32_scatters_as_qgcm_tpu(tmp_path, monkeypatch):
    """Two days of the 48x16 cut: the port's float32 tendencies and
    layer energies stand no farther from its float64 run than 4x
    qgcm_tpu's float32 run from its own (over 10 days the two read
    3.4e-3 and 3.5e-3 in ddtkeoc), and the float64 runs agree."""
    quick_jit(monkeypatch)
    runs = monit(tmp_path, SMALL, 2.0)
    for name in ("ddtkeoc", "ddtpeoc", "kealoc"):
        s = scatter(runs, name)
        assert 0 < s["qgcm_torch"] <= 4 * s["qgcm_tpu"], (name, s)
        a, b = (runs[pkg, "float64"][name] for pkg in PACKAGES)
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), name


if __name__ == "__main__":
    import tempfile
    grid = TALL if "--tall" in sys.argv else SMALL
    with tempfile.TemporaryDirectory() as root:
        runs = monit(root, grid, 10.0)
    print(f"10 days, grid {' '.join(grid)}: max|float32 - float64| / "
          "max|float64| of each package's own runs")
    for name in sorted(runs["qgcm_tpu", "float64"]):
        if runs["qgcm_tpu", "float64"][name].any():
            s = scatter(runs, name)
            print(f"  {name:8s} qgcm_tpu {s['qgcm_tpu']:.3e}  "
                  f"qgcm_torch {s['qgcm_torch']:.3e}")
