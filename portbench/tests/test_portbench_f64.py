"""The float64 cell natl_1km.single_f64 and the metrics beside it: its
configuration reproduced by its preset, the float64 port correct under
its limits on a small box, the same box in float32 not correct under
them (the control one precision below the configuration's), and the
readers of modes_ms and dst_roofline."""

import json
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, small_numbers
from portbench.cell import load_cell, metric_module, model_config, run_cell

CELL = "natl_1km.single_f64"
SEED = 2**32 + 2**31 + 3


def small_run(dtype):
    cell = load_cell(CELL)
    return run_cell(cell, SEED, 0.3, False, time.perf_counter(),
                    device="cpu", model_numbers=small_numbers(cell,
                                                              dtype=dtype),
                    log=lambda s: None)


def test_configuration_is_its_preset_and_overrides_in_float64():
    cell = load_cell(CELL)
    assert model_config(cell.config).dtype == "float64"
    f32 = load_cell("natl_1km.single")
    want = dict(f32.config["overrides"], dtype="float64")
    assert cell.config["overrides"] == want
    assert cell.config["preset"] == "natl_1km"
    assert cell.config["reference"] == "box"
    assert cell.config["reduced"] == ["ocean_only"]
    assert "dtype" not in cell.config["assumed"]
    assert cell.traffic == f32.traffic
    assert cell.chips == 1


def test_float64_port_reads_correct():
    from qgcm_torch.ops import modes
    modes.reset_launches()
    out = small_run("float64")
    assert out["correct"] is True and out["failed"] == 0
    # what modes_ms counts a substep: set-up's build and states make no
    # call, each substep (its first chunk and the window's) makes two
    assert modes.modes.launches == 2 * (25 + out["attempted"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_float32_port_reads_not_correct():
    """The control: the same box in float32, one precision below the
    configuration's, fails both readings."""
    out = small_run("float32")
    assert out["correct"] is False and out["failed"] > 0
    for k in ("start", "final"):
        assert out["checks"][k]["value"] > out["checks"][k]["limit"]


@pytest.mark.parametrize("dtype,item", [("float32", 4), ("float64", 8)])
def test_dst_launch_bytes_by_hand(dtype, item):
    """3 layers of a 7 x 9 p-grid: the interior is 5 x 7, the x-extension
    5 x 16, its spectrum 5 x 9 complex, the y-extension 7 x 12, its
    spectrum 7 x 7 complex, the padded output 7 x 9."""
    mod = metric_module("dst_roofline")
    b = 3 * item
    assert mod.launch_bytes(3, 7, 9, dtype) == dict(
        extend=b * (35 + 80), turn=b * (90 + 84), extract=b * (98 + 35),
        extract_pad=b * (98 + 63))
    assert mod.launch_bytes(3, 7, 9, dtype, members=2) == {
        k: 2 * v for k, v in mod.launch_bytes(3, 7, 9, dtype).items()}


def card_record(trace=None, **kw):
    return dict(dict(on_card=True, grid=(3, 7, 9, 6, 8), dtype="float32",
                     members=1, trace=trace), **kw)


def test_dst_roofline_of_a_traced_solve():
    # a substep's forward and inverse as a trace names them
    counts = {"void (anonymous namespace)::extend_rows<float, false>(...)": 1,
              "void (anonymous namespace)::extend_tile<float, false>(...)": 2,
              "void (anonymous namespace)::extend_tile<float, true>(...)": 1,
              "void (anonymous namespace)::extract_rows<float>(...)": 1,
              "void (anonymous namespace)::extract_pad<float>(...)": 1,
              "void vector_fft<...>": 4}
    seconds = {k: 1e-9 * n for k, n in counts.items()}
    tr = dict(counts=counts, seconds=seconds)
    mod = metric_module("dst_roofline")
    b = mod.launch_bytes(3, 7, 9, "float32")
    nbytes = 2 * (b["extend"] + b["turn"]) + b["extract"] + b["extract_pad"]
    want = 100.0 * nbytes / 3.35e12 / 6e-9
    assert mod.read(card_record(tr)) == pytest.approx(want, rel=1e-12)


def test_new_readers_find_nothing_off_the_card_or_without_the_function(
        monkeypatch):
    dst, modes = metric_module("dst_roofline"), metric_module("modes_ms")
    no_dst = dict(counts={"void vector_fft<...>": 4},
                  seconds={"void vector_fft<...>": 1e-6})
    # a 1-D DST's launches: an extension and an extract, no turn
    one_d = dict(counts={"extend_rows<float, false>": 1, "extract_rows": 1},
                 seconds={"extend_rows<float, false>": 1e-6,
                          "extract_rows": 1e-6})
    for rec in (dict(on_card=False), card_record(), card_record(no_dst),
                card_record(one_d)):
        assert dst.read(rec) is None
    assert modes.read(dict(on_card=False, modes_ms=1.0)) is None
    assert modes.read(card_record()) is None
    assert modes.read(card_record(modes_ms=0.5)) == 0.5
    ctx = SimpleNamespace(device=torch.device("cpu"), model=None, members=1,
                          seed=1)
    assert modes.collect(ctx) == {}
    # a program without ops/modes.py, on a card
    monkeypatch.setitem(sys.modules, "qgcm_torch.ops.modes", None)
    ctx.device = torch.device("cuda")
    assert modes.collect(ctx) == {}


def test_benchmark_entries_of_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert names[-2:] == ["modes_ms", "dst_roofline"] and len(names) == 7
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in bench["end_to_end"]]
