"""qgcm_torch.model.build_model against qgcm_tpu.model.build_model: the
host-side initialisation is the same NumPy code, so every build-time
array must agree BIT FOR BIT, after the one rounding to the model dtype
on the port's side."""

import numpy as np
import pytest
import torch

from qgcm_tpu.model import build_model as jax_build_model
from qgcm_tpu import generators as jax_gen
from qgcm_torch import generators as torch_gen
from qgcm_torch.model import build_model

from test_torch_cases import cfg_pair

CASES = [("golden", {}), ("golden", {"dtype": "float32"}),
         ("pallas", {"nlo": 3}), ("pallas", {"nlo": 2}),
         ("pallas", {"nlo": 3, "sponge": True}),
         ("pallas", {"nlo": 2, "sponge": True, "dtype": "float32"}),
         ("tall", {})]


def _same(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{v}" for k, v in CASES])
def test_build_model_bit_for_bit(kind, kw):
    cfg_j, cfg_t = cfg_pair(kind, **kw)
    jm = jax_build_model(cfg_j.replace(solver_transform="fft"))
    tm = build_model(cfg_t, "cpu")
    for name in ("amat", "cl2m", "cm2l", "rdm2", "cphs", "rdef"):
        _same(getattr(tm.modes_oc, name), getattr(jm.modes_oc, name), name)
    _same(tm.amat, jm.modes_oc.amat.astype(cfg_j.dtype), "amat tensor")
    _same(tm.cl2m, jm.modes_oc.cl2m.astype(cfg_j.dtype), "cl2m tensor")
    _same(tm.cm2l, jm.modes_oc.cm2l.astype(cfg_j.dtype), "cm2l tensor")

    jh, th = jm.inv_oc.helm, tm.inv_oc.helm
    assert jh.transform == "fft"
    for name in ("lamx", "lamy", "gx", "gy", "rdm2"):
        _same(getattr(th, name), getattr(jh, name), f"helm.{name}")
    assert th.norm == jh.norm
    _same(tm.inv_oc.cdiffo, jm.inv_oc.cdiffo, "cdiffo")
    _same(tm.inv_oc.cdhinv, jm.inv_oc.cdhinv, "cdhinv")

    _same(tm.rad.toc, jm.rad.toc, "rad.toc")
    _same(tm.rad.sstbar, jm.rad.sstbar, "rad.sstbar")
    assert (tm.rad.tsbdy, tm.rad.tnbdy) == (jm.rad.tsbdy, jm.rad.tnbdy)
    _same(tm.grids.yporel, jm.grids.yporel, "grids.yporel")
    _same(tm.yporel, np.asarray(jm.grids.yporel, cfg_j.dtype), "yporel")
    _same(tm.gpoc, np.asarray(cfg_j.ocean.gpoc, cfg_j.dtype), "gpoc")
    _same(tm.ddyn, jm.topo.ddynoc_or_scalar(cfg_j.dtype), "ddyn")
    if cfg_j.sponge.enabled:
        _same(tm.r_spl, jm.r_spl, "r_spl")
    else:
        assert tm.r_spl is None and jm.r_spl is None


@pytest.mark.parametrize("kind", ["golden", "pallas", "tall"])
def test_generators_bit_for_bit(kind):
    cfg_j, cfg_t = cfg_pair(kind)
    jm, tm = jax_build_model(cfg_j), build_model(cfg_t, "cpu")
    _same(torch_gen.eddy_pressure(cfg_t, ssh_amp=0.15),
          jax_gen.eddy_pressure(cfg_j, ssh_amp=0.15), "eddy_pressure")
    for got, want in zip(torch_gen.double_gyre_windstress(cfg_t, tm.grids),
                         jax_gen.double_gyre_windstress(cfg_j, jm.grids)):
        _same(got, want, "double_gyre_windstress")


MATMUL = {"box": {}, "cyclic": {"cyclic_ocean": True},
          "coupled": {"ocean_only": False},
          "atmos_only": {"ocean_only": False, "atmos_only": True}}


@pytest.mark.parametrize("override,err", [
    *(({"solver_transform": "matmul", **o}, None) for o in MATMUL.values()),
    ({"dtype": "float16"}, ValueError),
    ({"solver_transform": "dct"}, ValueError),
    ({"solver_precision": "low"}, ValueError)],
    ids=[*(f"matmul-{k}" for k in MATMUL), "float16", "transform",
         "precision"])
def test_build_model_refuses_unported(override, err, monkeypatch):
    """build_model refuses a dtype the model has no kernel for and an
    unknown solver_transform or solver_precision, and nothing else: the
    GEMM DST builds in every geometry (box, cyclic ocean, coupled,
    atmosphere-only), with the split forced active (qgcm_tpu's and the
    port's _MM_SPLIT_MIN at 4), and its solvers' permuted vectors are
    qgcm_tpu's bit for bit."""
    import qgcm_tpu.solver.helmholtz as J_h
    import qgcm_torch.solver.helmholtz as T_h
    monkeypatch.setattr(J_h, "_MM_SPLIT_MIN", 4)
    monkeypatch.setattr(T_h, "_MM_SPLIT_MIN", 4)
    cfg_j, cfg_t = cfg_pair("pallas")
    if err is not None:
        with pytest.raises(err):
            build_model(cfg_t.replace(**override), "cpu")
        return
    tm = build_model(cfg_t.replace(**override), "cpu")
    jm = jax_build_model(cfg_j.replace(**override))
    pairs = [(tm.inv_at, jm.inv_at), (tm.inv_oc, jm.inv_oc)]
    built = 0
    for t, j in pairs:
        if t is None:
            assert j is None
            continue
        th, jh = t.helm, j.helm
        cyclic = hasattr(jh, "ytransform")
        assert (jh.ytransform if cyclic else jh.transform) == "matmul"
        assert (th.ty if cyclic else th.tx) is not None
        for name in ("lamx", "lamy", "rdm2") + (() if cyclic else
                                                ("gx", "gy")):
            _same(getattr(th, name), getattr(jh, name), f"helm.{name}")
        built += 1
    assert built == (1 if override.get("ocean_only", True)
                     or override.get("atmos_only") else 2)
