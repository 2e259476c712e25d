"""Command-line interface (port of qgcm_tpu/cli.py, `run` and
`prepare`).

  qgcm-torch run <case-dir>      -- run an experiment; the case dir
                                    holds input.params (+ optional
                                    avges.nc / restart.nc); results land
                                    in <case-dir>/outdata
                                    (exec_qgcm.rb:22-97)
  qgcm-torch prepare <case-dir>  -- generate IC/forcing files
                                    (k247_make_{restart,forcing}_q-gcm.F90)

Also `python -m qgcm_torch.cli ...`. Grid dimensions come from --preset
(config.PRESETS) or explicit flags, mirroring the reference's
compile-time parameters_data.F presets. Both commands run on the card
(--device cuda, the default) and raise without CUDA; pass
--device cpu for the CPU. The configuration's dtype is kept as given on
every device: the H100 runs complex128 FFTs, so unlike qgcm_tpu nothing
turns float64 into float32. qgcm_tpu's --mesh, --ckpt-format and
--profile and its ensemble, sense and analyze commands are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys


def _base_config(args):
    from .config import PRESETS, ModelConfig
    if args.preset:
        cfg = PRESETS[args.preset]()
    else:
        cfg = ModelConfig(ocean_only=args.ocean_only,
                          atmos_only=args.atmos_only,
                          cyclic_ocean=args.cyclic_ocean)
    over = {}
    for k in ("nxta", "nyta", "nxaooc", "nyaooc", "ndxr"):
        v = getattr(args, k, None)
        if v is not None:
            over[k] = v
    if args.fnot is not None:
        over["fnot"] = args.fnot
    if args.beta is not None:
        over["beta"] = args.beta
    if args.dtype is not None:
        over["dtype"] = args.dtype
    if over:
        cfg = cfg.replace(**over)
    if args.ocean_only:
        cfg = cfg.replace(ocean_only=True)
    if args.atmos_only:
        cfg = cfg.replace(atmos_only=True)
    return cfg.validate()


def _segnum(d):
    try:
        return int(os.path.basename(d).split("outdata_r")[1])
    except (IndexError, ValueError):
        return 1


def cmd_run(args):
    from .params import parse_input_params, RunParams
    from .run import run_case
    from .io import read_mean_forcing, read_mean_sst

    case = args.case
    ppath = os.path.join(case, "input.params")
    params = parse_input_params(ppath) if os.path.exists(ppath) \
        else RunParams()
    if args.trun is not None:
        params.trun = args.trun
    # restart file path is relative to the case dir
    if params.name not in ("zero", "rbal"):
        params.name = os.path.normpath(os.path.join(case, params.name))
    cfg = _base_config(args)
    outdir = args.outdir or os.path.join(case, "outdata")
    if args.resume:
        # continue the chain from the newest checkpoint of the newest
        # existing segment (the reference workflow: exec_qgcm.rb:82-87
        # links the previous run's restart.nc into the next run, one
        # outdata dir per segment); tini comes from the file and trun
        # is the ADDITIONAL years to run
        segs = [outdir] + sorted(
            (d for d in (os.path.join(case, n)
                         for n in os.listdir(case)
                         if n.startswith("outdata_r"))
             if os.path.isdir(d)), key=_segnum)
        prev = segs[-1]
        cands = [os.path.join(prev, n)
                 for n in ("lastday.nc", "restart.nc")]
        cands = [c for c in cands if os.path.exists(c)]
        if not cands:
            raise SystemExit(f"--resume: no lastday.nc/restart.nc "
                             f"in {prev}")
        params.name = max(cands, key=os.path.getmtime)
        if args.outdir is None:
            # fresh segment dir so the previous outputs survive
            k = 2
            while os.path.exists(os.path.join(case, f"outdata_r{k}")):
                k += 1
            outdir = os.path.join(case, f"outdata_r{k}")
        elif os.path.realpath(outdir) == os.path.realpath(prev):
            # the Driver's writers would truncate the very monit/
            # avges files of the segment being resumed from
            raise SystemExit(
                f"--resume: --outdir {outdir} is the segment being "
                f"resumed from; pick a fresh directory (or omit "
                f"--outdir for automatic outdata_rK segments)")
        print(f"resuming from {params.name} -> {outdir}")

    mean_forcing = None
    sst_mean = None
    avpath = os.path.join(case, "avges.nc")
    if cfg.ocean_only:
        if os.path.exists(avpath):
            mean_forcing = read_mean_forcing(avpath)
        else:
            from .generators import zero_forcing
            print("no avges.nc in case dir; using zero mean forcing")
            mean_forcing = zero_forcing(cfg)
    if cfg.atmos_only:
        sst_mean = read_mean_sst(avpath)

    res = run_case(params, cfg, outdir, sst_mean=sst_mean,
                   mean_forcing=mean_forcing, verbose=not args.quiet,
                   device=args.device, qoc_diag=args.qoc_diag,
                   ocavg_days=args.ocavg_days,
                   cadence_rounding="exact" if args.exact_cadences
                   else "cycles", avges_sampling=args.avges_sampling)
    print(f"done: {res.steps_done} steps, t={res.tyrs:.4f} years; "
          f"{res.seconds['steps']:.4f} s stepping, "
          f"{res.seconds['events']:.4f} s in cadence events"
          + (" [ABORTED ON VALIDITY FAILURE]" if res.aborted else ""))
    return 1 if res.aborted else 0


def cmd_prepare(args):
    """Generate restart.nc (analytic eddy IC) and avges.nc (mean
    forcing) into the case dir. The initial state is built on --device
    and written in float64."""
    from .model import build_model
    from .generators import (eddy_pressure, zero_forcing,
                             double_gyre_windstress)
    from .models.ocean import init_ocean_state
    from .models.atmos import init_atmos_state
    from .io import save_restart
    from .io.forcing import write_mean_forcing
    from .params import parse_input_params, params_to_config

    cfg = _base_config(args)
    # layer counts/physics must match the case's input.params
    ppath = os.path.join(args.case, "input.params")
    if os.path.exists(ppath):
        cfg = params_to_config(parse_input_params(ppath), cfg)
    model = build_model(cfg, args.device)
    os.makedirs(args.case, exist_ok=True)

    if args.modon:
        from .generators import modon_pressure
        rdef = float(model.modes_oc.rdef[1])
        oc = init_ocean_state(model, po=modon_pressure(cfg, rdef))
    elif args.eddy_amp is not None:
        po = eddy_pressure(cfg, ssh_amp=args.eddy_amp,
                           l_efold=args.eddy_scale)
        oc = init_ocean_state(model, po=po)
    else:
        oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    save_restart(os.path.join(args.case, "restart.nc"), model, oc, at,
                 0.0)
    print(f"wrote {args.case}/restart.nc")

    if args.forcing == "zero":
        f = zero_forcing(cfg)
    elif args.forcing == "channel":
        from .generators import channel_windstress
        f = channel_windstress(cfg, model.grids, tau0=args.tau0)
    else:
        f = double_gyre_windstress(cfg, model.grids, tau0=args.tau0)
    write_mean_forcing(os.path.join(args.case, "avges.nc"), model, *f)
    print(f"wrote {args.case}/avges.nc")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qgcm-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_grid(p):
        p.add_argument("--preset", choices=[
            "double_gyre_ocean_only", "double_gyre_coupled",
            "southern_ocean_ocean_only", "southern_ocean_coupled",
            "k247_default", "natl_1km"])
        for k in ("nxta", "nyta", "nxaooc", "nyaooc", "ndxr"):
            p.add_argument(f"--{k}", type=int)
        p.add_argument("--fnot", type=float)
        p.add_argument("--beta", type=float)
        p.add_argument("--dtype", choices=["float32", "float64"],
                       help="the model's dtype, kept as given on every "
                       "device (default: the preset's)")
        p.add_argument("--ocean-only", action="store_true",
                       dest="ocean_only")
        p.add_argument("--atmos-only", action="store_true",
                       dest="atmos_only")
        p.add_argument("--cyclic-ocean", action="store_true",
                       dest="cyclic_ocean")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on: 'cuda' (default; "
                       "raises without CUDA), 'cuda:N' or 'cpu'")

    pr = sub.add_parser("run", help="run an experiment case")
    pr.add_argument("case")
    pr.add_argument("--outdir")
    pr.add_argument("--trun", type=float,
                    help="override run length (years)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in the "
                    "case's outdata (lastday.nc/restart.nc) instead "
                    "of the input.params initial state -- the "
                    "reference's restart-chaining workflow "
                    "(exec_qgcm.rb:82-87)")
    pr.add_argument("--quiet", action="store_true")
    pr.add_argument("--qoc-diag", action="store_true", dest="qoc_diag",
                    help="write the dq/dt decomposition (qocdiag.nc)")
    pr.add_argument("--ocavg-days", type=float, default=0.0,
                    dest="ocavg_days",
                    help="k247 ocean-average stream interval (days)")
    pr.add_argument("--avges-sampling", choices=["mean", "midpoint"],
                    default="mean", dest="avges_sampling",
                    help="avges.nc accumulation: 'mean' (default) = "
                    "true time means over every step; 'midpoint' = "
                    "the reference's one-sample-per-interval midpoint "
                    "subsampling (q-gcm.F:1477-1482)")
    pr.add_argument("--exact-cadences", action="store_true",
                    dest="exact_cadences",
                    help="honour cadences at any whole atmospheric "
                    "step instead of the reference's rounding to "
                    "whole coupling cycles (q-gcm.F:656-698)")
    add_grid(pr)
    pr.set_defaults(fn=cmd_run)

    pp = sub.add_parser("prepare", help="generate IC/forcing files")
    pp.add_argument("case")
    icgrp = pp.add_mutually_exclusive_group()
    icgrp.add_argument("--eddy-amp", type=float, default=None,
                       help="Gaussian eddy SSH amplitude (m)")
    icgrp.add_argument("--modon", action="store_true",
                       help="Larichev-Reznik modon initial condition")
    pp.add_argument("--eddy-scale", type=float, default=80.0e3)
    pp.add_argument("--forcing",
                    choices=["zero", "double-gyre", "channel"],
                    default="zero")
    pp.add_argument("--tau0", type=float, default=2.0e-5)
    add_grid(pp)
    pp.set_defaults(fn=cmd_prepare)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
