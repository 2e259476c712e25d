"""The port's sharded checkpoints (qgcm_torch/io/sharded_ckpt.py, the
counterpart of qgcm_tpu's Orbax checkpoints) on one device, in float64 on
the CPU: a round trip bit for bit, a restore against qgcm_tpu's
save_checkpoint/load_checkpoint of the same state, in its own dtype and
restored into a model of the other dtype, the Driver's
ckpt_format="sharded" run and resume against qgcm_tpu's
ckpt_format="orbax" on its 4-device CPU mesh, and the directories a
restore refuses. The cases that need ranks (restores into 2x2 and rows
meshes, a resume on another mesh) are in the spawns of
tests/test_torch_parallel_driver.py."""

import json

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import qgcm_tpu.config as jax_config
import qgcm_torch.config as torch_config
from qgcm_torch.io.sharded_ckpt import (MANIFEST, load_checkpoint,
                                        save_checkpoint)
from qgcm_torch.model import build_model
from qgcm_torch.models.atmos import init_atmos_state
from qgcm_torch.params import RunParams
from qgcm_torch.run import Driver

from test_torch_cases import numpy_of, one_torch_thread, quick_jit

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

RESTORE_TOL = 1e-13     # a restore against qgcm_tpu's of the same state
# a restore into a model of the other dtype against qgcm_tpu's: the
# stored fields cast bit for bit; q, derived point by point, within a few
# roundoffs of the model's dtype of max|q| (a float32 ulp is 1.2e-7 of
# it); the constraint integrals, sums over the 33^2 grid in the model's
# dtype taken in another order, within sqrt(1089) x 100 ulps or so (they
# read 1.4e-6 apart in float32)
CAST_TOL = {"float32": 1e-6, "float64": 1e-12}
SUM_TOL = {"float32": 1e-5, "float64": 1e-12}
JAX_TOL = 1e-9          # a Driver run against qgcm_tpu's
DAY = 86400.0


def _max_rel(got: dict, want: dict) -> dict:
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(w)).max()
                     / max(np.abs(np.asarray(w)).max(), 1e-300))
            for k, w in want.items()}


@pytest.mark.parametrize("kind", ["box", "channel"])
def test_round_trip_on_one_device_is_bit_for_bit(tmp_path, kind):
    """save_checkpoint then load_checkpoint without a mesh gives the state
    init_ocean_state and init_atmos_state derive from the same fields,
    every tensor bit for bit, and tyrs as written; one file per field,
    holding the model's dtype. An inactive fluid passed as None comes
    back as its init="zero" state (qgcm_tpu's rule)."""
    model, oc, at = ranks.seeded_coupled(kind)
    written = save_checkpoint(str(tmp_path / "ck"), oc, at, 0.3125, model)
    o, a, tyrs = load_checkpoint(str(tmp_path / "ck"), model)
    assert tyrs == 0.3125
    for got, want in ((o, oc), (a, at)):
        for k in want._fields:
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    files = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert files == sorted([MANIFEST] + [f"{k}.0.npy" for k in (
        "po", "pom", "sst", "sstm", "pa", "pam", "ast", "astm", "hmixa",
        "hmixam")])
    assert written == sum(getattr(s, k).numel() * 8 for s, ks in (
        (oc, ("po", "pom", "sst", "sstm")),
        (at, ("pa", "pam", "ast", "astm", "hmixa", "hmixam"))) for k in ks)
    save_checkpoint(str(tmp_path / "ocean"), oc, None, 0.0, model)
    a = load_checkpoint(str(tmp_path / "ocean"), model)[1]
    zero = init_atmos_state(model, init="zero")
    assert all(torch.equal(x, y) for x, y in zip(a, zero))


def test_restore_matches_qgcm_tpu_orbax(tmp_path):
    """The same state through the port's checkpoint and through
    qgcm_tpu's Orbax save_checkpoint/load_checkpoint: every field within
    1e-13 of its largest magnitude (the derived q and the constraint
    values included), and tyrs the same."""
    from qgcm_tpu.io.orbax_ckpt import load_checkpoint as jax_load
    from qgcm_tpu.io.orbax_ckpt import save_checkpoint as jax_save
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.state import AtmosState, OceanState
    model, oc, at = ranks.seeded_coupled("box")
    jmodel = jax_build_model(ranks.coupled_cfg(jax_config, "box"))
    jax_save(str(tmp_path / "jax"), OceanState(**numpy_of(oc)),
             AtmosState(**numpy_of(at)), 0.75)
    save_checkpoint(str(tmp_path / "port"), oc, at, 0.75, model)
    jo, ja, jt = jax_load(str(tmp_path / "jax"), jmodel)
    po, pa, pt = load_checkpoint(str(tmp_path / "port"), model)
    assert pt == jt == 0.75
    errs = {**_max_rel(numpy_of(po), numpy_of(jo)),
            **_max_rel(numpy_of(pa), numpy_of(ja))}
    assert max(errs.values()) <= RESTORE_TOL, errs


@pytest.mark.parametrize("saved,restored", [("float64", "float32"),
                                            ("float32", "float64")])
def test_restore_across_dtypes_matches_qgcm_tpu_orbax(tmp_path, saved,
                                                      restored):
    """A checkpoint of one dtype restored into a model of the other,
    through the port's checkpoint and through qgcm_tpu's Orbax one (whose
    init_ocean_state and init_atmos_state cast the stored fields): every
    field comes back in the model's dtype, the stored ones (po, pom, sst,
    pa, ...) bit for bit qgcm_tpu's, q within CAST_TOL[restored] and the
    constraint integrals within SUM_TOL[restored] of their largest
    magnitude, and tyrs the same."""
    from qgcm_tpu.io.orbax_ckpt import load_checkpoint as jax_load
    from qgcm_tpu.io.orbax_ckpt import save_checkpoint as jax_save
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.state import AtmosState, OceanState
    model64, oc, at = ranks.seeded_coupled("box")
    source = build_model(ranks.coupled_cfg(torch_config, "box", saved), "cpu")
    target = build_model(ranks.coupled_cfg(torch_config, "box", restored),
                         "cpu")
    jmodel = jax_build_model(ranks.coupled_cfg(jax_config, "box", restored))
    oc, at = (type(s)(*(t.to(source.dtype) for t in s)) for s in (oc, at))
    jax_save(str(tmp_path / "jax"), OceanState(**numpy_of(oc)),
             AtmosState(**numpy_of(at)), 0.75)
    save_checkpoint(str(tmp_path / "port"), oc, at, 0.75, source)
    assert json.loads((tmp_path / "port" / MANIFEST).read_text())[
        "dtype"] == saved
    jo, ja, jt = jax_load(str(tmp_path / "jax"), jmodel)
    po, pa, pt = load_checkpoint(str(tmp_path / "port"), target)
    assert pt == jt == 0.75
    got = {**numpy_of(po), **numpy_of(pa)}
    want = {**numpy_of(jo), **numpy_of(ja)}
    assert {str(v.dtype) for v in got.values()} == {restored}
    stored = ("po", "pom", "sst", "sstm", "pa", "pam", "ast", "astm",
              "hmixa", "hmixam")
    for k in stored:
        assert np.array_equal(got[k], want[k]), k
    errs = _max_rel({k: got[k].astype(np.float64) for k in want},
                    {k: v.astype(np.float64) for k, v in want.items()})
    q = ("qo", "qom", "qa", "qam")
    assert max(errs[k] for k in q) <= CAST_TOL[restored], errs
    assert max(v for k, v in errs.items()
               if k not in q + stored) <= SUM_TOL[restored], errs


def test_driver_sharded_resume_matches_qgcm_tpu_orbax(tmp_path):
    """The coupled box of tests/test_params_run.py's Orbax case: 12
    atmosphere steps through the port's Driver(ckpt_format="sharded")
    (restart_sharded/ every 2 cycles, lastday_sharded/ at the end, no
    restart.nc), then 6 more resumed from lastday_sharded/, against the
    same two runs of qgcm_tpu's Driver(ckpt_format="orbax") on a rows
    mesh of 4 CPU devices: every field of the final states within 1e-9
    of its largest magnitude, and the port's resumed run within 1e-9 of
    its straight 18 steps. (The mass-constraint integrals dpioc are
    roundoff here, 3e-8 beside the 1e-2 pressures of an ocean spun up
    from rest, and are not compared.)"""
    import jax
    from qgcm_tpu.model import build_model as jax_build_model
    from qgcm_tpu.params import RunParams as JaxRunParams
    from qgcm_tpu.parallel.mesh import make_mesh
    from qgcm_tpu.run import Driver as JaxDriver

    def params(steps, name, resday=0.0):
        return dict(trun=steps * 180.0 / DAY / 365.0, dta=180.0, nstr=3,
                    dxo=20.0e3, valday=0.0, odiday=0.0, adiday=0.0,
                    dgnday=0.0, prtday=0.0, resday=resday, dtavoc=0.0,
                    dtavat=0.0, name=name)

    model = build_model(ranks.coupled_cfg(torch_config, "box"), "cpu")
    jmodel = jax_build_model(ranks.coupled_cfg(jax_config, "box"))
    jmesh = make_mesh(jax.devices()[:4], rows_only=True)
    first = params(12, "rbal", resday=6 * 180.0 / DAY)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        quick_jit(mp)
        for who, drv, rp, kw in (
                ("torch", Driver, RunParams, dict(ckpt_format="sharded")),
                ("jax", JaxDriver, JaxRunParams,
                 dict(ckpt_format="orbax", mesh=jmesh))):
            m = model if who == "torch" else jmodel
            out = tmp_path / who
            drv(m, rp(**first), str(out / "a"), verbose=False, **kw).run()
            ext = "sharded" if who == "torch" else "orbax"
            assert (out / "a" / f"restart_{ext}").is_dir()
            assert not (out / "a" / "restart.nc").exists()
            runs[who] = drv(m, rp(**params(6, str(out / "a" /
                                                 f"lastday_{ext}"))),
                            str(out / "b"), verbose=False, **kw).run()
    straight = Driver(model, RunParams(**params(18, "rbal")),
                      str(tmp_path / "straight"), verbose=False).run()
    got, want = runs["torch"], runs["jax"]
    assert got.steps_done == want.steps_done == 6
    assert abs(got.tyrs - want.tyrs) < 1e-15
    for fluid in ("ocean", "atmos"):
        g = {k: v for k, v in numpy_of(getattr(got, fluid)).items()
             if v.ndim >= 2}
        for ref in (want, straight):
            r = numpy_of(getattr(ref, fluid))
            errs = _max_rel(g, {k: r[k] for k in g})
            assert max(errs.values()) <= JAX_TOL, (fluid, errs)


def test_refuses_incomplete_or_foreign_checkpoints(tmp_path):
    """A directory without its manifest (a writer that did not finish) is
    refused, and so is a manifest written for another grid, before any
    block is read (the blocks are removed first). Another dtype is no
    refusal: test_restore_across_dtypes_matches_qgcm_tpu_orbax."""
    model, oc, at = ranks.seeded_coupled("box")
    path = tmp_path / "ck"
    save_checkpoint(str(path), oc, at, 0.0, model)
    manifest = json.loads((path / MANIFEST).read_text())
    (path / MANIFEST).unlink()
    with pytest.raises(ValueError, match="incomplete checkpoint"):
        load_checkpoint(str(path), model)
    for npy in path.glob("*.npy"):
        npy.unlink()
    for change in ({"grid": {**manifest["grid"], "nxpo": 7}},
                   {"grid": {**manifest["grid"], "nxpo": 7},
                    "dtype": "float32"}):
        (path / MANIFEST).write_text(json.dumps({**manifest, **change}))
        with pytest.raises(ValueError, match="was written for the grid"):
            load_checkpoint(str(path), model)
