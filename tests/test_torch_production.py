"""The bars that chip_smoke.py holds qgcm_tpu's production cases to
(phase 24 and --production k247, ens, flagship), on qgcm_tpu's committed
records: each passes on the record itself and fails on a copy doctored
in one value. And the port's analysis.QgcmData against qgcm_tpu's on the
k247 record. NumPy and scipy on the committed files; nothing is run."""

import shutil

import numpy as np
import pytest
from scipy.io import netcdf_file

import chip_smoke as cs
from qgcm_torch.analysis import QgcmData

ROOT = cs.repo_file()
K247 = ROOT / cs.K247_CASE / "outdata"


@pytest.fixture(scope="module")
def k247():
    """The k247 record: (energy series, monit.nc, sshmax_etc.nc)."""
    return (QgcmData(str(K247)).energy_series(),
            cs.nc_vars(K247 / "monit.nc"), cs.nc_vars(K247 / "sshmax_etc.nc"))


def held(rows) -> bool:
    return all(ok for _, ok in rows)


def copy(series, name, index, value):
    """A copy of a dict of series with series[name][index] = value."""
    out = {k: np.array(v) for k, v in series.items()}
    out[name][index] = value
    return out


def test_k247_year_bars_hold_on_the_record(k247):
    """The record meets every bar of --production k247, its westward
    speed is the record's 0.0393 m/s, and each doctored copy misses: a
    non-zero utauoc, a track point moved east (hmax_i no longer falls),
    a KE1 that does not return, and a CFL above its bar."""
    energy, monit, track = k247
    assert held(cs.k247_year_bars(energy, monit, track, track))
    assert abs(cs.track_speed(track) - 0.0393) < 5e-5
    doctored = [
        (energy, copy(monit, "utauoc", 100, 1e-9), track),
        (energy, monit, copy(track, "hmax_i", 2, 94.0)),
        (copy(energy, "keocavg", (-1, 0), 0.4 * energy["keocavg"][0, 0]),
         monit, track),
        (energy, copy(monit, "cnqgoc", 7, 0.25), track)]
    for e, m, t in doctored:
        assert not held(cs.k247_year_bars(e, m, t, track))


def test_k247_speed_bar_is_tighter_than_the_records(k247):
    """A track 40% faster than the record's is inside qgcm_tpu's bars
    (0.02-0.08 m/s) but misses the 25% bar of the record's speed."""
    energy, monit, track = k247
    fast = copy(track, "hmax_i", -1, 108.0 - 1.4 * (108.0 - 46.0))
    rows = cs.k247_year_bars(energy, monit, fast, track)
    assert [ok for bar, ok in rows if "westward speed" in bar] == [True,
                                                                   False]


def test_k247_days_bars_hold_on_the_record(k247):
    """Phase 24's bars on the record's first 10 days, with the record as
    its own float64 witness, and on doctored copies: a non-zero btdgoc,
    an emfroc of 1e-9, and a kealoc 1% off that a float64 run as far off
    does not excuse."""
    _, monit, _ = k247
    first = {k: v[:cs.K247_DAYS] if v.shape[:1] == (365,) else v
             for k, v in monit.items()}
    assert held(cs.k247_days_bars(first, monit, monit))
    for bad in (copy(first, "btdgoc", 3, 1e-12),
                copy(first, "emfroc", (4, 0), 1e-9),
                copy(first, "kealoc", (5, 0), 1.01 * first["kealoc"][5, 0])):
        assert not held(cs.k247_days_bars(bad, monit, monit))
    # the witness: a run 2e-3 off the record passes where float64 is as
    # far off the record, and not where float64 is on it
    off = copy(first, "kealoc", (5, 0), 1.002 * first["kealoc"][5, 0])
    f64 = copy(monit, "kealoc", (5, 0), 1.0015 * monit["kealoc"][5, 0])
    assert held(cs.k247_days_bars(off, monit, f64))
    assert not held(cs.k247_days_bars(off, monit, monit))


def test_ensemble_bars_hold_on_the_record():
    """k247_eddy_ens's ensemble.nc meets --production ens's bars against
    itself; a spread_po record 3x off (day 0, or one from day 10 on), a
    day-2.5 peak cut to 3x day 0, and a lost record each miss."""
    rec = cs.nc_vars(ROOT / cs.ENS_CASE / "outdata_ens" / "ensemble.nc")
    assert held(cs.ensemble_bars(rec, rec))
    sp = rec["spread_po"]
    low_peak = copy(rec, "spread_po", slice(1, 3), 3.0 * sp[0])
    for bad in (copy(rec, "spread_po", 0, 3.0 * sp[0]),
                copy(rec, "spread_po", 8, 3.0 * sp[8]), low_peak,
                {k: v[:-1] for k, v in rec.items()}):
        assert not held(cs.ensemble_bars(bad, rec))


def flagship_record():
    """The flagship record's monit.nc cut to its first 15 records."""
    vals, dims = cs.monit_series(ROOT / cs.FLAGSHIP_CASE / "outdata"
                                 / "monit.nc")
    return {k: np.asarray(v[:cs.FLAGSHIP_RECORDS] if dims[k][:1] == (
        "time",) else v, np.float64) for k, v in vals.items()}


def test_flagship_bars_hold_on_the_record():
    """The flagship's first 15 records meet --production flagship's bars;
    a copy with a non-finite value, an emfrat of 1e-5, a cnqgat of 0.9 or
    a record short misses."""
    first = flagship_record()
    assert held(cs.flagship_bars(first))
    for bad in (copy(first, "kealat", (3, 1), np.nan),
                copy(first, "emfrat", (2, 1), 1e-5),
                copy(first, "cnqgat", 9, 0.9),
                {k: v[:-1] if v.shape[:1] == (15,) else v
                 for k, v in first.items()}):
        assert not held(cs.flagship_bars(bad))


def test_held_or_raise_names_the_missed_bar(capsys):
    with pytest.raises(AssertionError, match="1 of its bars: b"):
        cs.held_or_raise("case", [("a", True), ("b", False)])
    assert "MISSED: b" in capsys.readouterr().out


def test_k247_analysis_matches_qgcm_tpu(tmp_path):
    """QgcmData's energy_series() on the committed k247 record, and its
    sshmax() on that record with an ocpo.nc of seeded snapshots (the
    record commits none), equal qgcm_tpu.analysis's within 1e-12."""
    from qgcm_tpu.analysis import QgcmData as JaxQgcmData
    for name in ("monit.nc", "input_parameters.m"):
        shutil.copy(K247 / name, tmp_path / name)
    rng = np.random.default_rng(7)
    p = rng.standard_normal((5, 2, 31, 29)).astype(np.float32)
    with netcdf_file(str(tmp_path / "ocpo.nc"), "w") as f:
        for dim, n in zip(("time", "z", "yp", "xp"), p.shape):
            f.createDimension(dim, n)
        f.createVariable("time", "d", ("time",))[:] = 0.2 * np.arange(1, 6)
        f.createVariable("p", "f", ("time", "z", "yp", "xp"))[:] = p
    got, want = QgcmData(str(tmp_path)), JaxQgcmData(str(tmp_path))
    e, w = got.energy_series(), want.energy_series()
    assert sorted(e) == sorted(w)
    for k in w:
        np.testing.assert_allclose(e[k], w[k], rtol=1e-12, atol=0)
    for a, b in zip(got.sshmax(), want.sshmax()):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    assert e["keocavg"].shape == (365, 2)
