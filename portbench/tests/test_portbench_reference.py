"""The plain reference against the port, float64 on the CPU, on a small
box: one trajectory and three members, through two averagings."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import ROOT, small_numbers, with_members
from portbench import traffic
from portbench.cell import load_cell, model_config
from portbench.reference.box import FIELDS, BoxOcean, tf32_round

STEPS = 30      # substeps 0 and 25 are followed by the averaging


def port_run(cell, m, members, steps):
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ensemble import make_ensemble_runner, stack_members
    from qgcm_torch.models.ocean import init_ocean_state, ocean_forcing_from_mean
    from qgcm_torch.models.stepper import make_ocean_only_runner
    model = build_model(model_config(cell.config, m), "cpu")
    t = with_members(cell, members).traffic
    inputs = traffic.make_inputs(m, t, 7, "cpu", torch.float64)
    states = [init_ocean_state(model, po=inputs["po"][i]) for i in range(members)]
    f = ocean_forcing_from_mean(model, inputs["tauxo"], inputs["tauyo"],
                                inputs["fnetoc"])
    if members > 1:
        st = make_ensemble_runner(model)(stack_members(states), f, steps)
    else:
        st = make_ocean_only_runner(model)(states[0], f, steps)
        st = type(st)(*(x[None] for x in st))
    return model, inputs, states, f, st


@pytest.mark.parametrize("cell_name,members", [
    ("natl_1km.single", 1), ("natl_1km.single", 3)])
def test_reference_follows_the_port_in_float64(cell_name, members):
    cell = load_cell(cell_name)
    m = small_numbers(cell, dtype="float64")
    model, inputs, states, f, st = port_run(cell, m, members, STEPS)
    ref = BoxOcean(m, "cpu")
    rf = ref.forcing(inputs["tauxo"], inputs["tauyo"], inputs["fnetoc"])
    s0 = ref.initial_state(inputs["po"])
    # what set-up derives: q from p, the Ekman velocities, the modes
    for i, one in enumerate(states):
        assert torch.allclose(s0["qo"][i], one.qo, rtol=0, atol=1e-18)
        assert torch.allclose(s0["dpioc"][i], one.dpioc, rtol=1e-13,
                              atol=1e-9)
    assert torch.allclose(rf["wekpo"], f.wekpo, rtol=0, atol=1e-20)
    assert torch.allclose(ref.cl2m, model.cl2m, rtol=1e-14)
    s = ref.run(s0, rf, STEPS)
    for k in FIELDS:
        want, got = s[k], getattr(st, k)
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) < 1e-11, k


def test_reference_imports_nothing_of_the_program():
    src = Path(ROOT, "portbench", "reference")
    for path in src.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("qgcm_torch", "qgcm_tpu",
                                               "jax", "jaxlib"), (path, n)
    code = ("import sys; import portbench.reference.box; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'qgcm_torch', 'qgcm_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-20,
                      1.0 + 2.0**-12, -3.0], dtype=torch.float32)
    got = tf32_round(x)
    want = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -3.0])
    assert torch.equal(got, want)
