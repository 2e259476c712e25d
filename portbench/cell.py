"""One run of one cell of BENCHMARK.json: set-up, the measured window,
the traced stretch, the per-layer readers and the check of the outputs.

Everything that belongs to one configuration, cell or per-layer metric
is a file found by its name:
  portbench/configs/<config>.json    the preset, its overrides, and the
                                     resolved numbers the reference reads
  portbench/workloads/<cell>.json    the cell's traffic mix (`mix`, read
                                     by portbench/traffic.py, named by
                                     the cell's `traffic` in
                                     BENCHMARK.json), its limits and the
                                     readings they were set from
  portbench/metrics/<metric>.py      read(record) -> value or None, and
                                     optionally collect(ctx) -> dict
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import checks, trace, traffic

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT, pkg: Path = PKG) -> SimpleNamespace:
    """The cell `name` of root/BENCHMARK.json with its files under `pkg`
    (the benchmark's folder)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    own = load_json(pkg / "workloads" / f"{name}.json")
    return SimpleNamespace(
        name=name, chips=w["chips"], pkg=pkg,
        config=load_json(pkg / "configs" / f"{w['config']}.json"),
        traffic=own["mix"], limits=own["limits"],
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name))


def metric_module(name: str, pkg: Path = PKG):
    """<pkg>/metrics/<name>.py, loaded from its path."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonable(x):
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def _tuples(values: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in values.items()}


def model_config(conf: dict, model_numbers: dict = None):
    """The program's ModelConfig: the preset with the file's overrides (a
    nested group's keys replace that group's), refused unless it gives the
    file's `model` numbers. With `model_numbers` (a smaller box for
    tests), the preset's config with every field set from them."""
    from qgcm_torch.config import PRESETS
    base = PRESETS[conf["preset"]]()
    if model_numbers is not None:
        return type(base)(**{
            f.name: (type(getattr(base, f.name))(**_tuples(v))
                     if isinstance(v, dict) else
                     tuple(v) if isinstance(v, list) else v)
            for f in dataclasses.fields(base)
            for v in [model_numbers[f.name]]}).validate()
    cfg = base.replace(**{
        k: dataclasses.replace(getattr(base, k), **_tuples(v))
        if isinstance(v, dict) else v
        for k, v in conf["overrides"].items()}).validate()
    have = _jsonable(dataclasses.asdict(cfg))
    if have != conf["model"]:
        diff = sorted(k for k in {*have, *conf["model"]}
                      if have.get(k) != conf["model"].get(k))
        raise ValueError(f"configuration {conf['name']}: the preset and its "
                         f"overrides differ from the file's numbers in {diff}")
    return cfg


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference(conf: dict):
    """The module portbench/reference/<conf["reference"]>.py, with its
    `Reference(model_numbers, device, dtype=float64, tf32=False)`."""
    return importlib.import_module(f"portbench.reference.{conf['reference']}")


def reference_gaps(conf: dict, m_numbers: dict, inputs: dict, chunk: int,
                   start_state, final_state, substeps: int, device) -> tuple:
    """The per-member readings of checks.py (start, final): the float64
    reference run from the inputs, compared after the first chunk with
    `start_state` and after `substeps` in all with `final_state`."""
    ref = reference(conf).Reference(m_numbers, device)
    f = ref.forcing(inputs["tauxo"], inputs["tauyo"], inputs["fnetoc"])
    want = ref.run(ref.initial_state(inputs["po"]), f, chunk, 0)
    start = checks.state_gaps(ref, start_state, want)
    want = ref.run(want, f, substeps - chunk, chunk)
    final = checks.state_gaps(ref, final_state, want)
    sync(ref.device)
    return start.cpu(), final.cpu()


class Program:
    """The port as a run drives it: its members built from the inputs
    (init_ocean_state each, stacked), their forcing, the runner (the
    ensemble runner for members, else the single-trajectory one) and the
    substep the next chunk starts at. The state lives here and nowhere
    else, so that between chunks the device holds one state, as a user's
    loop does."""

    def __init__(self, model, t: dict, inputs: dict, wrap_runner=None):
        from qgcm_torch.models.ensemble import (make_ensemble_runner,
                                                stack_members)
        from qgcm_torch.models.ocean import (init_ocean_state,
                                             ocean_forcing_from_mean)
        from qgcm_torch.models.stepper import make_ocean_only_runner
        self.members, self.chunk, self.step0 = t["members"], t["chunk"], 0
        states = [init_ocean_state(model, po=inputs["po"][i])
                  for i in range(self.members)]
        self.state = stack_members(states) if self.members > 1 else states[0]
        del states
        self.forcing = ocean_forcing_from_mean(
            model, inputs["tauxo"], inputs["tauyo"], inputs["fnetoc"])
        run = (make_ensemble_runner(model) if self.members > 1
               else make_ocean_only_runner(model))
        self.run = run if wrap_runner is None else wrap_runner(run)

    def step(self):
        """One chunk of the runner."""
        self.state = self.run(self.state, self.forcing, self.chunk,
                              self.step0)
        self.step0 += self.chunk

    def window(self, seconds: float, device) -> list:
        """Chunks, each synchronised, until the first chunk boundary after
        `seconds`. Returns the clock at the start and at each chunk's end."""
        ends = [time.perf_counter()]
        while ends[-1] - ends[0] < seconds or len(ends) == 1:
            self.step()
            sync(device)
            ends.append(time.perf_counter())
        return ends

    def host(self, fields) -> dict:
        """The checked fields of the state on the host, with a member
        axis."""
        out = {k: getattr(self.state, k).detach().cpu() for k in fields}
        return out if self.members > 1 else {k: v[None]
                                             for k, v in out.items()}


def run_cell(cell, seed: int, seconds: float, traced: bool, t0: float,
             device="cuda", model_numbers: dict = None, wrap_runner=None,
             log=print) -> dict:
    """One run of `cell` (load_cell). Returns the result line's dict
    (its `checks` last). `t0`: the process's start on perf_counter's
    clock. `model_numbers` replaces the configuration's numbers (a small
    box for tests); `wrap_runner(run)` may replace the runner the window
    drives (tests plant faults through it)."""
    from qgcm_torch.model import build_model
    from qgcm_torch.ops import qgstep as qgstep_mod

    device = torch.device(device)
    cuda = device.type == "cuda"
    t = cell.traffic
    m_numbers = model_numbers or cell.config["model"]
    members, chunk = t["members"], t["chunk"]
    nl, nyp, nxp, nyt, nxt = traffic.grid(m_numbers)
    fields = checks.COMPARED
    clock = time.perf_counter
    parts = {}

    # ---- set-up -------------------------------------------------------
    parts["imports_s"] = clock() - t0
    if cuda:
        tp = clock()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        parts["cuda_init_s"] = clock() - tp
        tp = clock()
        parts["nvcc_s"] = qgstep_mod.build_kernel().build_s
        parts["kernel_load_s"] = clock() - tp - parts["nvcc_s"]
    tp = clock()
    cfg = model_config(cell.config, model_numbers)
    model = build_model(cfg, device)
    sync(device)
    parts["build_model_s"] = clock() - tp
    tp = clock()
    inputs = traffic.make_inputs(m_numbers, t, seed, device, model.dtype)
    prog = Program(model, t, inputs, wrap_runner)
    sync(device)
    parts["inputs_s"] = clock() - tp
    qgstep_mod.reset_launches()
    tp = clock()
    prog.step()
    sync(device)
    parts["warmup_s"] = clock() - tp
    # kept for the check, on the host: not set-up
    tp = clock()
    host_inputs = {k: v.cpu() for k, v in inputs.items()}
    del inputs
    start_state = prog.host(fields)
    check_copy_s = clock() - tp

    # ---- the window ---------------------------------------------------
    ends = prog.window(seconds, device)
    setup_s = ends[0] - t0 - check_copy_s
    window_s = ends[-1] - ends[0]
    substeps = prog.step0 - chunk
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    for k, v in parts.items():
        log(f"setup {k} {v:.3f}")
    log(f"setup_s {setup_s:.3f} (checks' copies {check_copy_s:.3f} s left "
        f"out); window {window_s:.3f} s, {substeps} substeps")
    log("window ms a substep, chunk by chunk: " + " ".join(
        f"{(b - a) * 1e3 / chunk:.2f}" for a, b in zip(ends, ends[1:])))

    record = dict(cell=cell.name, on_card=cuda, members=members,
                  dtype=cfg.dtype, grid=(nl, nyp, nxp, nyt, nxt), dto=cfg.dto,
                  substeps=substeps, window_s=window_s)
    result_device = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=1, memory_peak_bytes=peak)

    # ---- the traced stretch and the per-layer readers -------------------
    if traced:
        n_tr = t["trace_chunks"]

        def stretch():
            for _ in range(n_tr):
                prog.step()

        record["trace"] = trace.profile(stretch, device)
        record["trace"]["substeps"] = n_tr * chunk
        ctx = SimpleNamespace(model=model, members=members,
                                  device=device, seed=seed)
        for met in cell.per_layer:
            mod = metric_module(met["name"], cell.pkg)
            if hasattr(mod, "collect"):
                record.update(mod.collect(ctx))
        result_device["busy_s"] = record["trace"]["busy_s"]
        result_device["window_s"] = record["trace"]["window_s"]

    # ---- the program's last state, then the program is freed -----------
    final_state, step0 = prog.host(fields), prog.step0
    launches = (qgstep_mod.qgstep.launches, qgstep_mod.qgstep.members)
    del prog, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference ------------------------------------------------
    tp = clock()
    start, final = reference_gaps(cell.config, m_numbers, host_inputs, chunk,
                                  start_state, final_state, step0, device)
    log(f"reference {clock() - tp:.3f} s, {step0} substeps")
    readings = dict(start=float(start.max()), final=float(final.max()))
    if cuda:
        readings["launches"] = float(abs(launches[0] - step0)
                                     + abs(launches[1] - step0 * members))
    limits = {k: v for k, v in cell.limits.items()
              if cuda or k != "launches"}
    verdict, correct = checks.judge(readings, limits)
    failing = (start > limits["start"]) | (final > limits["final"])
    bad = int(failing.sum()) or (0 if correct else members)

    # ---- the result ---------------------------------------------------
    record.update(setup_s=setup_s, peak_bytes=peak)
    metrics = {}
    for met in (cell.per_layer if traced else cell.end_to_end):
        v = metric_module(met["name"], cell.pkg).read(record)
        if v is not None:
            metrics[met["name"]] = {"value": v, "unit": met["unit"]}
    out = dict(correct=correct, attempted=substeps * members,
               failed=substeps * bad, metrics=metrics, device=result_device)
    if traced:
        out["breakdown"] = dict(device_ops=trace.top(record["trace"]["seconds"]),
                                idle_gaps=trace.top(record["trace"]["gaps"]))
    out["checks"] = verdict
    return out
