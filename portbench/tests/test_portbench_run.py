"""A whole run of the harness on the CPU at a small size: the result
line's schema, the readers found by name, the import check, the refusal
without a card, and the faults the output check has to catch."""

import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, small_numbers, with_members
from portbench import run as run_mod
from portbench.cell import load_cell, run_cell

SINGLE = "natl_1km.single"
SEED = 2**31 + 17
# The members path is held to limits at the scale of a float32 ensemble
# of the 961^2 box (its program read 4.1e-5, its control 1.5e-2): a
# member swapped or replaced by the others' mean moves a state by about
# the perturbation, some 2e-3 of its largest pressure, under a single
# trajectory's limits.
MEMBERS_LIMITS = dict(start=1e-3, final=1e-3, launches=0.0)


def small_run(name, traced=False, wrap_runner=None, cell=None, seconds=0.3,
              members=None):
    cell = cell or load_cell(name)
    if members:
        with_members(cell, members, MEMBERS_LIMITS)
    return run_cell(cell, SEED, seconds, traced, time.perf_counter(),
                    device="cpu", model_numbers=small_numbers(cell),
                    wrap_runner=wrap_runner, log=lambda s: None)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(traced):
    out = small_run(SINGLE, traced=traced, members=3)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == keys
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % (3 * 25) == 0 and out["attempted"] > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run writes no number under a device metric's name
    assert out["metrics"] == {}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_new_cell_configuration_and_metric_are_found_as_files(tmp_path):
    pkg = tmp_path / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, pkg / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((pkg / "configs" / "natl_1km.json").read_text())
    conf["name"] = "dg_copy"
    (pkg / "configs" / "dg_copy.json").write_text(json.dumps(conf))
    own = json.loads((pkg / "workloads" / f"{SINGLE}.json").read_text())
    own["mix"] = with_members(SimpleNamespace(traffic=own["mix"]), 2).traffic
    own["limits"] = MEMBERS_LIMITS
    (pkg / "workloads" / "dg_copy.ens2.json").write_text(json.dumps(own))
    (pkg / "metrics" / "members_seen.py").write_text(
        "def read(record):\n    return float(record['members'])\n")
    bench["workloads"].append(dict(name="dg_copy.ens2", config="dg_copy",
                                   traffic="ens2", chips=1, why="a copy"))
    bench["per_layer"].append(dict(
        name="members_seen", unit="members", better="higher",
        source="program_counter", layer="Runner", moves="sypd",
        workloads=["dg_copy.ens2"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("dg_copy.ens2", root=tmp_path, pkg=pkg)
    assert cell.traffic["members"] == 2
    assert [m["name"] for m in cell.per_layer][-1] == "members_seen"
    out = small_run(None, traced=True, cell=cell)
    assert out["metrics"] == {"members_seen": {"value": 2.0,
                                               "unit": "members"}}
    assert out["correct"] is True
    # the metric is read only in the cells it lists
    assert "members_seen" not in [m["name"] for m in load_cell(
        SINGLE, root=tmp_path, pkg=pkg).per_layer]


def test_a_run_loads_no_jax_and_refuses_without_a_card():
    code = (
        "import sys, time, torch\n"
        "from portbench.cell import load_cell, run_cell\n"
        "from portbench.run import forbidden_modules, main\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import small_numbers\n"
        "c = load_cell('natl_1km.single')\n"
        "run_cell(c, 5, 0.2, True, time.perf_counter(), device='cpu',\n"
        "         model_numbers=small_numbers(c), log=lambda s: None)\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", SINGLE,
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True)
        assert res.returncode != 0 and res.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qgcm_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like.sub", object())
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qgcm_tpu.models", object())
    assert run_mod.forbidden_modules() == ["qgcm_tpu.models"]


# ---- faults planted in the timed path: each must read as not correct ---

def _unchanged(run):
    """Steps, then returns the state it was given."""
    def bad(state, forcing, n, step0=0):
        run(state, forcing, n, step0)
        return state
    return bad


def _half_members(run):
    """Steps the first half of the members; the rest get their mean."""
    def bad(state, forcing, n, step0=0):
        h = state.po.shape[0] // 2
        first = run(type(state)(*(x[:h] for x in state)), forcing, n, step0)
        mean = [x.mean(0, keepdim=True).expand_as(y[h:])
                for x, y in zip(first, state)]
        return type(state)(*(torch.cat([a, b]) for a, b in zip(first, mean)))
    return bad


def _swapped(run):
    """Members come back rolled by one place."""
    def bad(state, forcing, n, step0=0):
        return type(state)(*(x.roll(1, 0) for x in run(state, forcing, n,
                                                         step0)))
    return bad


def _altered(run):
    """The last member's largest pressure comes back half as large again:
    one answer altered where the runner produces it."""
    def bad(state, forcing, n, step0=0):
        out = run(state, forcing, n, step0)
        po = out.po.clone()
        last = po[-1] if po.dim() == 4 else po
        flat = last.view(-1)
        flat[flat.abs().argmax()] *= 1.5
        return out._replace(po=po)
    return bad


@pytest.mark.parametrize("members,fault", [
    (4, _unchanged), (4, _half_members), (4, _swapped), (4, _altered),
    (None, _unchanged), (None, _altered)])
def test_planted_fault_reads_not_correct(members, fault):
    out = small_run(SINGLE, wrap_runner=fault, members=members)
    assert out["correct"] is False
    assert out["failed"] > 0
