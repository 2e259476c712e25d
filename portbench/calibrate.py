"""Readings of the output check over many seeds, for setting a cell's
limits (portbench/workloads/<cell>.json); the benchmark's runs never
call it.

    python -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds 11 12 ... --control-seeds 21 22 23

In one process and at the cell's own sizes: for each of --seeds, the
program as a run drives it (set-up's first chunk, then chunks for
--seconds), and for each of --control-seeds the control in the program's
place for as many substeps as the program's first seed took: the
reference computed in float32 with its layer/mode products in TF32, the
precision just below the configuration's float32 with TF32 off. Prints
one JSON line per run: who, seed, substeps in all and the largest start
and final readings over the members.
"""

import argparse
import json
import sys
import time

import torch

from portbench import checks, traffic
from portbench.cell import (Program, load_cell, model_config, reference,
                            reference_gaps)


def program_states(model, t, inputs, seconds, device, fields):
    """(start, final, substeps) of the program driven as a run drives
    it."""
    prog = Program(model, t, inputs)
    prog.step()
    start = prog.host(fields)
    prog.window(seconds, device)
    return start, prog.host(fields), prog.step0


def control_states(conf, m, t, inputs, substeps, device):
    """The same for the control: the reference in float32 with TF32
    products in the program's place."""
    chunk = t["chunk"]
    ctl = reference(conf).Reference(m, device, torch.float32, tf32=True)
    f = ctl.forcing(inputs["tauxo"], inputs["tauyo"], inputs["fnetoc"])
    s = ctl.run(ctl.initial_state(inputs["po"]), f, chunk, 0)
    start = {k: s[k].cpu() for k in checks.COMPARED}
    s = ctl.run(s, f, substeps - chunk, chunk)
    return start, {k: s[k].cpu() for k in checks.COMPARED}, substeps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from qgcm_torch.model import build_model
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    m, t = cell.config["model"], cell.traffic
    model = build_model(model_config(cell.config), device)
    substeps = None
    jobs = [("program", s) for s in args.seeds] + [
        ("control", s) for s in args.control_seeds]
    for who, seed in jobs:
        t0 = time.perf_counter()
        inputs = traffic.make_inputs(m, t, seed, device, model.dtype)
        if who == "program":
            got = program_states(model, t, inputs, args.seconds, device,
                                 checks.COMPARED)
            substeps = substeps or got[-1]
        else:
            got = control_states(cell.config, m, t, inputs,
                                 substeps or 26 * t["chunk"], device)
        host = {k: v.cpu() for k, v in inputs.items()}
        del inputs
        gaps = reference_gaps(cell.config, m, host, t["chunk"], *got,
                              device)
        print(json.dumps(dict(
            who=who, seed=seed, substeps=got[-1],
            start=float(gaps[0].max()), final=float(gaps[1].max()),
            seconds=time.perf_counter() - t0)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
