"""The ported ocean-only box slice as a whole: one substep against
qgcm_tpu (float64, and float32 with the float64 mixed layer), the
golden run through the port's runner, the averaging cadence, and the
port's independence from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu.models.ocean import make_ocean_step as jax_make_ocean_step
from qgcm_torch.convert import forcing_to_torch, state_to_torch, to_numpy
from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
from qgcm_torch.model import build_model
from qgcm_torch.models.ocean import (init_ocean_state, make_ocean_step,
                                     ocean_forcing_from_mean)
from qgcm_torch.models.stepper import make_ocean_only_runner
from qgcm_torch.ops.qgstep import qgstep
from qgcm_torch.solver.helmholtz import make_box_helmholtz
from qgcm_torch.state import OceanForcing, OceanState

from test_torch_cases import cfg_pair, jax_case, rel_err, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_both(cfg_j, cfg_t, dtype):
    """One substep of each package from the same JAX-made state, cast to
    `dtype` ('float64' or 'float32'). Returns (jax state, port state)."""
    _, st, f, _ = jax_case(cfg_j.replace(dtype="float64"))
    cast = (lambda nt: jax.tree.map(lambda x: x.astype(dtype), nt))
    jm = jax_build_model(cfg_j.replace(dtype=dtype))
    st_j, _ = jax.jit(jax_make_ocean_step(jm))(cast(st), cast(f))
    st_t, f_t = to_port(st, f, dtype=getattr(torch, dtype))
    st_t, _ = make_ocean_step(build_model(cfg_t.replace(dtype=dtype),
                                        "cpu"))(st_t, f_t)
    return st_j, st_t


@pytest.mark.parametrize("kw,over", [
    (dict(nlo=3), {}), (dict(nlo=2, sponge=True), {}),
    (dict(nlo=3), dict(sb_hflux=True)),
    (dict(nlo=2), dict(fnot=-5.92e-5, nb_hflux=True))],
    ids=["nlo3", "nlo2-sponge", "sb_hflux", "nb_hflux-south"])
def test_one_substep_matches_jax(kw, over):
    cfg_j, cfg_t = cfg_pair("pallas", **kw)
    st_j, st_t = _step_both(cfg_j.replace(**over).validate(),
                            cfg_t.replace(**over).validate(), "float64")
    for name, got in to_numpy(st_t).items():
        want = np.asarray(getattr(st_j, name))
        assert got.dtype == want.dtype == np.float64, name
        assert rel_err(got, want) <= 1e-12, name


def test_one_float32_substep_matches_jax():
    """float32 with the float64 mixed layer (ml_f64, on by default for
    float32) in both packages. Bound 1e-5 relative to each field's max:
    the two float32 FFTs (pocketfft and XLA's) and sums round
    differently, a few ulp (1.2e-7 each) through the inversion."""
    cfg_j, cfg_t = cfg_pair("pallas", nlo=3)
    st_j, st_t = _step_both(cfg_j, cfg_t, "float32")
    for name, got in to_numpy(st_t).items():
        want = np.asarray(getattr(st_j, name))
        assert got.dtype == want.dtype == np.float32, name
        assert rel_err(got, want) <= 1e-5, name


def test_golden_ocean_only_box():
    """tests/test_golden.py::test_golden_ocean_only_box through the
    port's runner (its 50 substeps include two averagings)."""
    _, cfg = cfg_pair("golden")
    model = build_model(cfg, "cpu")
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids, tau0=2e-5))
    n0 = qgstep.launches
    st = make_ocean_only_runner(model)(st, f, 50)
    assert qgstep.launches == n0
    po, qo, sst = st.po.numpy(), st.qo.numpy(), st.sst.numpy()
    got = dict(po_sum=float(po.sum()), po_l1=float(np.abs(po).sum()),
               po_max=float(po.max()), qo_l1=float(np.abs(qo).sum()),
               sst_l1=float(np.abs(sst).sum()),
               dpioc0=float(st.dpioc[0]))
    expected = dict(po_sum=31.416626761421, po_l1=32.5480213744938,
                    po_max=0.962083301276373,
                    qo_l1=0.0038091058169070335,
                    sst_l1=2.135746401204379, dpioc0=-19680485411.11134)
    for k, v in expected.items():
        assert got[k] == pytest.approx(v, rel=1e-9), (k, got)


def test_runner_step0_keeps_the_averaging_cadence():
    _, cfg = cfg_pair("golden")
    model = build_model(cfg, "cpu")
    st0 = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    run = make_ocean_only_runner(model)
    whole = run(st0, f, 30)
    chunked = run(run(st0, f, 10), f, 20, step0=10)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    misaligned = run(run(st0, f, 10), f, 20)
    assert not torch.equal(whole.po, misaligned.po)


def _small_box(**kw):
    """The small box of tests/test_ocean_step.py:19-23, in the port."""
    import qgcm_torch.config as qc
    return qc.ModelConfig(nxta=16, nyta=16, nxaooc=8, nyaooc=8, ndxr=3,
                          ocean_only=True, dta=200.0,
                          nstr=3).replace(**kw).validate()


def test_unforced_eddy_conserves_energy():
    """tests/test_ocean_step.py::test_unforced_eddy_stability_and_energy
    in the port: an inviscid unforced eddy keeps its total energy to
    1e-6 over 200 substeps, averagings included."""
    import qgcm_torch.config as qc
    from qgcm_torch.generators import zero_forcing
    cfg = _small_box(ocean=qc.OceanConfig(ah2oc=(0.0,) * 3,
                                          ah4oc=(0.0,) * 3, delek=0.0),
                     no_oml=True)
    model = build_model(cfg, "cpu")
    st = init_ocean_state(model, po=eddy_pressure(
        cfg, ssh_amp=0.05, l_efold=3 * cfg.ocean.dxo))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))

    def energy(s):
        po = s.po.numpy()
        ke = sum(cfg.ocean.hoc[k] * ((np.diff(po[k], axis=1)
                                      / model.grids.dxo) ** 2).sum()
                 + cfg.ocean.hoc[k] * ((np.diff(po[k], axis=0)
                                        / model.grids.dyo) ** 2).sum()
                 for k in range(cfg.nlo))
        pe = sum(cfg.ocean.gpoc[k]
                 * (((po[k + 1] - po[k]) / cfg.ocean.gpoc[k]) ** 2).sum()
                 for k in range(cfg.nlo - 1))
        return 0.5 * (ke / cfg.fnot**2 + pe)

    e0 = energy(st)
    st = make_ocean_only_runner(model)(st, f, 200)
    assert all(bool(torch.isfinite(t).all()) for t in st)
    assert abs(energy(st) - e0) < 1e-6 * e0


def test_mass_constraint_and_forced_spin_up():
    """tests/test_ocean_step.py::test_mass_constraint (box) and
    ::test_forced_run_spins_up in the port: the area integral of each
    interface displacement tracks dpioc, and the double-gyre wind spins
    the ocean up from the radiative-balance rest state."""
    from qgcm_torch.ops.integrals import xintp
    cfg = _small_box()
    model = build_model(cfg, "cpu")
    st = init_ocean_state(model, init="rbal")
    assert not st.po.any() and st.sst.any()
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids, tau0=2e-5))
    st = make_ocean_only_runner(model)(st, f, 100)
    assert bool(torch.isfinite(st.po).all()) and st.po.abs().max() > 0.0
    area = model.grids.dxo * model.grids.dyo
    np.testing.assert_allclose(
        (xintp(st.po[1:] - st.po[:-1]) * area).numpy(), st.dpioc.numpy(),
        rtol=1e-8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ml_f64_mixed_layer(dtype):
    """tests/test_ml_f64.py for the ocean-only box: on float32 models the
    float64 prediction core really runs (values differ from ml_f64=False)
    and the storage stays float32; on float64 models the flag is
    bit-identical either way."""
    _, cfg = cfg_pair("golden", dtype=dtype)
    runs = []
    for flag in (True, False):
        model = build_model(cfg.replace(ml_f64=flag), "cpu")
        st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1),
                              init="rbal")
        f = ocean_forcing_from_mean(
            model, *double_gyre_windstress(cfg, model.grids))
        runs.append(make_ocean_only_runner(model)(st, f, 24))
    on, off = runs
    assert on.sst.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(on.sst).all())
    if dtype == "float32":
        assert not torch.equal(on.sst, off.sst)
    else:
        for a, b in zip(on, off):
            assert torch.equal(a, b)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import qgcm_torch, qgcm_torch.convert, qgcm_torch.model\n"
            "import qgcm_torch.models.stepper, qgcm_torch.ops.qgstep\n"
            "import qgcm_torch.ops._cuda, qgcm_torch.solver.helmholtz\n"
            "import qgcm_torch.generators, qgcm_torch.topo\n"
            "import qgcm_torch.coupling, qgcm_torch.models.atmos\n"
            "import qgcm_torch.models.ocean, qgcm_torch.state\n"
            "import qgcm_torch.params, qgcm_torch.report\n"
            "import qgcm_torch.io, qgcm_torch.io.ncdf, qgcm_torch.io.native\n"
            "import qgcm_torch.io.restart, qgcm_torch.io.snapshots\n"
            "import qgcm_torch.io.forcing, qgcm_torch.diags\n"
            "import qgcm_torch.diags.valids, qgcm_torch.diags.cfl\n"
            "import qgcm_torch.diags.monitor, qgcm_torch.diags.timavge\n"
            "import qgcm_torch.diags.covaria, qgcm_torch.diags.areas\n"
            "import qgcm_torch.diags.qocdiag, qgcm_torch.run\n"
            "import qgcm_torch.cli, qgcm_torch.models.ensemble\n"
            "import qgcm_torch.adjoint, qgcm_torch.analysis\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'qgcm_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_device_without_cuda_raises(tmp_path):
    """The entry points default to the card: without CUDA, a call that
    asks for it, or asks for no device, raises and runs nothing on the
    CPU. That holds for the Driver, run_case and the CLI's prepare and
    run without --device too, and for ensemble and sense."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = cfg_pair("golden")
    st_np = {name: np.zeros((2, 3)) for name in OceanState._fields}
    f_np = {name: np.zeros((3,)) for name in OceanForcing._fields}
    from qgcm_torch.convert import (atmos_forcing_to_torch,
                                    atmos_state_to_torch)
    from qgcm_torch.solver.helmholtz import make_cyclic_helmholtz
    from qgcm_torch.state import AtmosForcing, AtmosState
    coupled = cfg.replace(ocean_only=False)
    at_np = {name: np.zeros((2, 3)) for name in AtmosState._fields}
    af_np = {name: np.zeros((3,)) for name in AtmosForcing._fields}
    calls = [lambda *d: build_model(cfg, *d),
             lambda *d: build_model(coupled, *d),
             lambda *d: state_to_torch(st_np, *d),
             lambda *d: forcing_to_torch(f_np, *d),
             lambda *d: atmos_state_to_torch(at_np, *d),
             lambda *d: atmos_forcing_to_torch(af_np, *d),
             lambda *d: make_box_helmholtz(33, 17, 20e3, 20e3, np.zeros(3),
                                           torch.float64, *d),
             lambda *d: make_cyclic_helmholtz(33, 17, 20e3, 20e3,
                                              np.zeros(3), torch.float64,
                                              *d)]
    from qgcm_torch.cli import main
    from qgcm_torch.params import RunParams
    from qgcm_torch.run import Driver, run_case
    p = RunParams(trun=1e-5, dta=200.0, nstr=3, dxo=25.0e3, name="rbal",
                  hoc=(350.0, 750.0, 2900.0))
    out = str(tmp_path / "out")
    calls += [lambda *d: Driver(build_model(cfg, *d), p, out),
              lambda *d: run_case(p, cfg, out, *d)]
    for call in calls:
        for dev in [("cuda",), ()]:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call(*dev)
    (tmp_path / "case").mkdir()
    for argv in (["prepare", str(tmp_path / "case"), "--ocean-only"],
                 ["run", str(tmp_path / "case"), "--ocean-only"],
                 ["ensemble", str(tmp_path / "case"), "--ocean-only"],
                 ["sense", str(tmp_path / "case"), "--ocean-only"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not os.listdir(tmp_path / "case")


def test_jax_and_port_state_round_trip():
    """convert.py: JAX state -> port tensors -> NumPy is the identity."""
    _, st, f, _ = jax_case(cfg_pair("pallas", nlo=2)[0], steps=0)
    st_t, f_t = to_port(st, f)
    for nt_j, nt_t in ((st, st_t), (f, f_t)):
        for name, arr in to_numpy(nt_t).items():
            assert np.array_equal(arr, np.asarray(getattr(nt_j, name)))
    assert isinstance(jnp.asarray(to_numpy(st_t)["po"]), jax.Array)
