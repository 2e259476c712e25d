"""Command-line interface (port of qgcm_tpu/cli.py).

  qgcm-torch run <case-dir>      -- run an experiment; the case dir
                                    holds input.params (+ optional
                                    avges.nc / restart.nc); results land
                                    in <case-dir>/outdata
                                    (exec_qgcm.rb:22-97); --profile DIR
                                    traces a chunk with torch.profiler
  qgcm-torch prepare <case-dir>  -- generate IC/forcing files
                                    (k247_make_{restart,forcing}_q-gcm.F90)
  qgcm-torch ensemble <case-dir> -- perturbed-IC ensemble; the spread
                                    series goes to outdata_ens/ensemble.nc
  qgcm-torch sense <case-dir>    -- adjoint sensitivity of an objective
                                    (ocean-only); outdata/sensitivity.nc
  qgcm-torch analyze <outdata>   -- summarise monit.nc (or ensemble.nc)

Also `python -m qgcm_torch.cli ...`. Grid dimensions come from --preset
(config.PRESETS) or explicit flags, mirroring the reference's
compile-time parameters_data.F presets. The commands that build a
model run on the card (--device cuda, the default) and raise without
CUDA; pass --device cpu for the CPU. The configuration's dtype is kept
as given on every device: the H100 runs complex128 FFTs, so unlike
qgcm_tpu nothing turns float64 into float32.

`run --mesh auto|rows|hybrid|NYxNX` and `ensemble --shard-members` run
in the ranks of a torch.distributed group, one process each, started by
torchrun:

    torchrun --nproc-per-node 4 -m qgcm_torch.cli run CASE --mesh rows
    torchrun --nproc-per-node 4 -m qgcm_torch.cli run CASE --mesh 2x2
    torchrun --nproc-per-node 2 -m qgcm_torch.cli run CASE --mesh rows \
        --dist-backend gloo --device cpu

--dist-backend names the group's backend: nccl (the default; each rank
takes the card of its local rank) or gloo (the CPU, or ranks that share
a card; the ranks run on --device). A box takes any NYxNX and 'hybrid'
(the hosts on y, a host's ranks on x); a channel, and an
atmosphere-only case, are cut by rows over all the ranks of any NYxNX
(with a warning where NX > 1, as qgcm_tpu warns where it falls back to
GSPMD), and 'hybrid' puts their ranks on y.

`run --ckpt-format sharded` writes restart_sharded/ and lastday_sharded/
(io/sharded_ckpt.py: each rank its own blocks) instead of restart.nc and
lastday.nc; --resume takes the newest of the four, and a resume restores
a directory into the blocks of whatever mesh it runs on. qgcm_tpu's
'orbax' is a JAX format: the port neither reads nor writes it, and
'sharded' is its counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


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


@contextlib.contextmanager
def _ranks(args, wanted: bool):
    """The process group of a torchrun launch, when `wanted` (--mesh,
    --shard-members): parallel/launch.distributed_session under the
    named --dist-backend, never another. Under NCCL each rank runs on
    its own card, cuda:LOCAL_RANK; under gloo on --device. Outside
    torchrun there is one rank and no group."""
    if not wanted:
        yield
        return
    import torch
    import torch.distributed as dist
    from .parallel.launch import distributed_session
    with distributed_session(args.dist_backend):
        if dist.is_initialized() and args.dist_backend == "nccl":
            args.device = f"cuda:{torch.cuda.current_device()}"
        yield


def _say(*a, **kw):
    """print, on the primary rank only."""
    from .parallel.launch import is_primary
    if is_primary():
        print(*a, **kw)


def _segnum(d):
    try:
        return int(os.path.basename(d).split("outdata_r")[1])
    except (IndexError, ValueError):
        return 1


def _written(path):
    """When a checkpoint was finished: a file's mtime, or that of a
    sharded checkpoint's manifest (written last; 0 when it is missing,
    so that an incomplete directory loses to any other)."""
    if not os.path.isdir(path):
        return os.path.getmtime(path)
    from .io.sharded_ckpt import MANIFEST
    m = os.path.join(path, MANIFEST)
    return os.path.getmtime(m) if os.path.exists(m) else 0.0


def cmd_run(args):
    with _ranks(args, args.mesh is not None):
        return _run(args)


def _run(args):
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
                 for n in ("lastday.nc", "restart.nc",
                           "lastday_sharded", "restart_sharded")]
        cands = [c for c in cands if os.path.exists(c)]
        if not cands:
            raise SystemExit(f"--resume: no lastday.nc/restart.nc "
                             f"in {prev}")
        params.name = max(cands, key=_written)
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
        _say(f"resuming from {params.name} -> {outdir}")

    mean_forcing = None
    sst_mean = None
    avpath = os.path.join(case, "avges.nc")
    if cfg.ocean_only:
        if os.path.exists(avpath):
            mean_forcing = read_mean_forcing(avpath)
        else:
            from .generators import zero_forcing
            _say("no avges.nc in case dir; using zero mean forcing")
            mean_forcing = zero_forcing(cfg)
    if cfg.atmos_only:
        sst_mean = read_mean_sst(avpath)

    mesh = None
    if args.mesh:
        from .params import params_to_config
        from .parallel.mesh import mesh_from_spec
        grid = params_to_config(params, cfg)
        # an atmosphere-only case is cut by rows, as a channel is
        mesh = mesh_from_spec(args.mesh,
                              grid.cyclic_ocean or grid.atmos_only,
                              (grid.nypo, grid.nxpo))
        _say(f"mesh: {{'y': {mesh.my}, 'x': {mesh.mx}}} over {mesh.size} "
             "devices (a2a spectral solvers)")

    res = run_case(params, cfg, outdir, sst_mean=sst_mean,
                   mean_forcing=mean_forcing, verbose=not args.quiet,
                   device=args.device, qoc_diag=args.qoc_diag,
                   ocavg_days=args.ocavg_days,
                   cadence_rounding="exact" if args.exact_cadences
                   else "cycles", avges_sampling=args.avges_sampling,
                   profile_dir=args.profile, mesh=mesh,
                   ckpt_format=args.ckpt_format)
    _say(f"done: {res.steps_done} steps, t={res.tyrs:.4f} years; "
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


def _case_model(args):
    """(params, config, model) of the case directory args.case, as
    qgcm_tpu's ensemble and sense commands read it; the initial-state
    file of input.params is relative to the case."""
    from .model import build_model
    from .params import parse_input_params, params_to_config, RunParams
    ppath = os.path.join(args.case, "input.params")
    params = parse_input_params(ppath) if os.path.exists(ppath) \
        else RunParams()
    if params.name not in ("zero", "rbal"):
        params.name = os.path.normpath(os.path.join(args.case, params.name))
    cfg = params_to_config(params, _base_config(args))
    return params, cfg, build_model(cfg, args.device)


def _case_forcing(case, cfg):
    """The mean forcing of an ocean-only case: avges.nc, else zero."""
    from .io import read_mean_forcing
    avpath = os.path.join(case, "avges.nc")
    if os.path.exists(avpath):
        return read_mean_forcing(avpath)
    from .generators import zero_forcing
    print("no avges.nc in case dir; using zero mean forcing")
    return zero_forcing(cfg)


def cmd_ensemble(args):
    with _ranks(args, args.shard_members):
        return _ensemble(args)


def _ensemble(args):
    """Perturbed-IC ensemble run (models/ensemble.py, beyond the
    reference, which runs one trajectory per job): the members ride a
    leading axis of one run, each substep's vorticity kernel one launch
    for all of them; the spread series goes to ensemble.nc in the case's
    outdata_ens directory (qgcm_tpu's schema). --shard-members deals the
    members out over the ranks (qgcm_tpu's gcd rule, cli.py:300-315),
    each stepping its block; the primary rank writes."""
    import math
    import torch
    import torch.distributed as dist
    from .io.restart import load_restart
    from .models.atmos import init_atmos_state
    from .models.ensemble import (ensemble_mesh, make_ensemble_runner,
                                  perturbed_atmos_members,
                                  perturbed_ocean_members)
    from .models.ocean import init_ocean_state, ocean_forcing_from_mean

    params, cfg, model = _case_model(args)
    if cfg.atmos_only:
        raise SystemExit("qgcm-torch ensemble supports ocean-only and "
                         "coupled configurations")
    outdir = args.outdir or os.path.join(args.case, "outdata_ens")
    tini = 0.0
    at0 = None
    if params.name in ("zero", "rbal"):
        oc0 = init_ocean_state(model, init=params.name)
        if not cfg.ocean_only:
            at0 = init_atmos_state(model, init=params.name)
    elif os.path.isdir(params.name):
        # a sharded checkpoint directory (the Driver's dispatch)
        from .io.sharded_ckpt import load_checkpoint
        oc0, at0, tini = load_checkpoint(params.name, model)
    else:
        oc0, at0, tini = load_restart(params.name, model)

    m = args.members
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    ocm = perturbed_ocean_members(model, oc0, gen, m, amp=args.amp)
    kind = "ocean" if cfg.ocean_only else "coupled"
    atm = None
    if kind == "coupled":
        atm = perturbed_atmos_members(model, at0, gen, m,
                                      amp=10.0 * args.amp)
    mesh = None
    if args.shard_members:
        ndev = dist.get_world_size() if dist.is_initialized() else 1
        nd = math.gcd(m, ndev)
        if nd == 1 and ndev > 1:
            raise SystemExit(
                f"--shard-members: {m} members share no factor with "
                f"{ndev} devices -- pick a member count that is a "
                f"multiple of the device count")
        if nd < ndev:
            _say(f"warning: {m} members is not a multiple of {ndev} "
                 f"devices; sharding over only {nd} device(s)")
        mesh = ensemble_mesh(nd)
        _say(f"sharding {m} members over {nd} device(s)")
        if mesh is None:
            return 0            # a rank outside the member mesh
    run = make_ensemble_runner(model, kind=kind, mesh=mesh)
    forcing = None
    if cfg.ocean_only:
        forcing = ocean_forcing_from_mean(model,
                                          *_case_forcing(args.case, cfg))

    day = 86400.0
    # the runner's own step unit: ocean substeps (dto) ocean-only,
    # atmosphere steps (dta) coupled, in whole coupling cycles
    dt = cfg.nstr * cfg.dta if cfg.ocean_only else cfg.dta
    quantum = 1 if cfg.ocean_only else cfg.nstr
    sample = max(quantum,
                 round(args.sample_days * day / dt / quantum) * quantum)
    # whole sampling intervals, as qgcm_tpu (whose jitted program would
    # otherwise compile again for a short last chunk)
    total = max(sample, round(args.days * day / dt / sample) * sample)

    record, close = _spread_writer(args, kind, m, outdir, tini, dt, day)
    record(ocm, atm, 0, 0)
    n_done, rec = 0, 1
    while n_done < total:
        n = min(sample, total - n_done)
        if kind == "ocean":
            ocm = run(ocm, forcing, n, n_done)
        else:
            ocm, atm = run(ocm, atm, n, n_done)
        n_done += n
        record(ocm, atm, rec, n_done)
        rec += 1
    close()
    _say(f"wrote {outdir}/ensemble.nc ({rec} records, {m} members)")
    return 0


def _spread_writer(args, kind, m, outdir, tini, dt, day):
    """(record, close): record(ocm, atm, rec, n_done) writes one record
    of the spread series of the whole ensemble to ensemble.nc (qgcm_tpu's
    schema) on the primary rank, and does nothing on the others."""
    import torch
    from .io.ncdf import NcWriter
    from .models.ensemble import spread_rms
    from .parallel.launch import is_primary
    if not is_primary():
        return (lambda *a: None), (lambda: None)
    os.makedirs(outdir, exist_ok=True)
    w = NcWriter(os.path.join(outdir, "ensemble.nc"))
    w.dim("time", None)
    w.dim("member", m)
    w.var("tyrs", "d", ("time",), units="years")
    w.var("spread_po", "d", ("time",), units="m^2/s^2",
          long_name="RMS ensemble spread of ocean pressure")
    w.var("spread_sst", "d", ("time",), units="K",
          long_name="RMS ensemble spread of SST")
    w.var("po_rms", "d", ("time", "member"), units="m^2/s^2",
          long_name="per-member RMS ocean pressure")
    if kind == "coupled":
        w.var("spread_pa", "d", ("time",), units="m^2/s^2",
              long_name="RMS ensemble spread of atmos pressure")

    def record(ocm, atm, rec, n_done):
        t = tini + n_done * dt / (day * 365.0)
        sp = spread_rms(ocm, "po")
        sst_sp = spread_rms(ocm, "sst")
        w.append("tyrs", rec, t)
        w.append("spread_po", rec, sp)
        w.append("spread_sst", rec, sst_sp)
        # per-member RMS reduced on the device; one (m,) vector fetched
        w.append("po_rms", rec, torch.sqrt(torch.mean(
            torch.square(ocm.po), dim=(1, 2, 3))).cpu().numpy())
        if atm is not None:
            w.append("spread_pa", rec, spread_rms(atm, "pa"))
        if not args.quiet:
            print(f"t={t:9.5f}y  spread_po={sp:.3e}  "
                  f"spread_sst={sst_sp:.3e}")
        w.flush()

    return record, w.close


def _remat_arg(text: str):
    """--remat: true | dots | false | an int (the nested fan-out)."""
    remat = {"true": True, "dots": "dots", "false": False}.get(text)
    return int(text) if remat is None else remat


def cmd_sense(args):
    """Adjoint sensitivity of a scalar objective to the mean forcing and
    the initial condition (adjoint.py; no reference analogue), for
    ocean-only cases: loads the case's initial state and avges.nc
    forcing, runs --days of physics, differentiates the objective
    through the whole run and writes the gradient fields to
    sensitivity.nc in the case's outdata directory (qgcm_tpu's
    schema)."""
    from .adjoint import (layer1_energy_proxy, ocean_sensitivity,
                          transport_proxy)
    from .io.ncdf import make_writer
    from .io.restart import load_restart
    from .models.ocean import init_ocean_state
    from .params import SECDAY

    params, cfg, model = _case_model(args)
    if not cfg.ocean_only:
        raise SystemExit("qgcm-torch sense supports ocean-only cases "
                         "(coupled adjoints: models/stepper "
                         "make_coupled_runner(remat=True) + "
                         "torch.autograd)")
    if params.name in ("zero", "rbal"):
        oc0 = init_ocean_state(model, init=params.name)
    else:
        oc0, _, _ = load_restart(params.name, model)
    mf = _case_forcing(args.case, cfg)

    n_steps = max(1, round(args.days * SECDAY / cfg.dto))
    obj = (transport_proxy(model) if args.objective == "transport"
           else layer1_energy_proxy(model))
    print(f"objective={args.objective}, horizon {args.days} d = "
          f"{n_steps} ocean steps, remat={args.remat}")
    seg = 0
    if args.segment_days:
        seg = max(1, round(args.segment_days * SECDAY / cfg.dto))
        if n_steps % seg:
            raise SystemExit(
                f"--segment-days: {args.days} days is not a multiple "
                f"of {args.segment_days}-day segments")
        print(f"host-level segments of {seg} steps "
              f"({n_steps // seg} segments)")
    sens = ocean_sensitivity(model, obj, remat=_remat_arg(args.remat),
                             segment_steps=seg)
    val, g = sens(oc0, mf, n_steps)

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    outdir = args.outdir or os.path.join(args.case, "outdata")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "sensitivity.nc")
    w = make_writer(path)
    w.dim("xpo", cfg.nxpo); w.dim("ypo", cfg.nypo)
    w.dim("xto", cfg.nxto); w.dim("yto", cfg.nyto)
    w.dim("zo", cfg.nlo)
    w.var("objective", "d", (), data=float(val))
    w.var("dJ_dtauxo", "d", ("ypo", "xpo"), data=host(g.forcing[0]))
    w.var("dJ_dtauyo", "d", ("ypo", "xpo"), data=host(g.forcing[1]))
    w.var("dJ_dfnetoc", "d", ("yto", "xto"), data=host(g.forcing[2]))
    w.var("dJ_dpo", "d", ("zo", "ypo", "xpo"), data=host(g.state0.po))
    w.var("dJ_dsst", "d", ("yto", "xto"), data=host(g.state0.sst))
    w.close()
    gx = host(g.forcing[0])
    print(f"objective value: {float(val):.6e}")
    print(f"dJ/dtauxo: rms {float(np.sqrt(np.mean(gx**2))):.3e}, "
          f"|max| {float(np.abs(gx).max()):.3e}")
    print(f"wrote {path}")
    return 0


def _ensemble_summary(enspath):
    """The spread series of an ensemble.nc: its growth rate from a
    log-linear fit over the growing part of the curve, as e-folding and
    doubling times."""
    from scipy.io import netcdf_file
    f = netcdf_file(enspath, mmap=False)
    tyrs = np.asarray(f.variables["tyrs"][:], dtype=float)
    sp = np.asarray(f.variables["spread_po"][:], dtype=float)
    nm = f.dimensions["member"]
    f.close()
    print(f"ensemble.nc: {nm} members, {len(tyrs)} records, "
          f"{(tyrs[-1] - tyrs[0]) * 365.0:.2f} days")
    print(f"spread_po: {sp[0]:.3e} -> {sp[-1]:.3e} m^2/s^2")
    # fit over the pre-saturation records only: those past ~70% of the
    # peak spread sit on the plateau and bias the e-folding time long
    onset = np.nonzero(sp >= 0.7 * sp.max())[0]
    end = max(int(onset[0]) if len(onset) else len(sp), 3)
    seg = (sp[:end] > 0)
    if seg.sum() >= 3 and sp[-1] > sp[0] > 0:
        days = (tyrs[:end][seg] - tyrs[0]) * 365.0
        rate = np.polyfit(days, np.log(sp[:end][seg]), 1)[0]
        if rate > 0:
            print(f"e-folding time {1.0 / rate:.2f} days "
                  f"(doubling {np.log(2.0) / rate:.2f} days, "
                  f"fit over the first {end} records)")
    return 0


def _unify_chain(outdata):
    """--chain: unify the monit series of a --resume segment chain
    (outdata, outdata_r2, ...) into <case>/outdata_unified/; returns
    that directory."""
    import shutil
    from .analysis import unify_monit
    first = os.path.abspath(outdata)
    case = os.path.dirname(first)
    segs = [first] + sorted(
        (os.path.join(case, n) for n in os.listdir(case)
         if n.startswith("outdata_r")
         and os.path.isdir(os.path.join(case, n))), key=_segnum)
    skipped = [s for s in segs
               if not os.path.exists(os.path.join(s, "monit.nc"))]
    segs = [s for s in segs if s not in skipped]
    for s in skipped:
        print(f"(skipping {s}: no monit.nc -- monitoring was "
              f"off for that segment)")
    if not segs:
        raise SystemExit("--chain: no segment has a monit.nc")
    uni = os.path.join(case, "outdata_unified")
    os.makedirs(uni, exist_ok=True)
    unify_monit(segs, os.path.join(uni, "monit.nc"))
    pm = os.path.join(segs[-1], "input_parameters.m")
    if os.path.exists(pm):
        shutil.copy(pm, uni)
    print(f"unified {len(segs)} segments -> {uni}/monit.nc")
    return uni


def cmd_analyze(args):
    """Energy/diagnostics summary from monit.nc (the checks the Ruby
    layer runs: KE/PE series, constraint errors, CFL), plus the
    derived-product files monit_energy.nc and sshmax_etc.nc; or the
    spread series of an ensemble output directory. --chain first
    unifies the monit series of a --resume segment chain
    (qgcm_prep_k247.rb:5-12). Host code only: no model is built."""
    from scipy.io import netcdf_file
    enspath = os.path.join(args.outdata, "ensemble.nc")
    if os.path.exists(enspath) and not os.path.exists(
            os.path.join(args.outdata, "monit.nc")):
        return _ensemble_summary(enspath)
    if args.chain:
        args.outdata = _unify_chain(args.outdata)
    try:
        from .analysis import QgcmData
        qd = QgcmData(args.outdata)
        print("wrote", qd.write_energy())
        if os.path.exists(os.path.join(args.outdata, "ocpo.nc")):
            print("wrote", qd.write_sshmax())
        qd.energy_check(verbose=True)
    except (OSError, KeyError, ValueError) as e:
        print(f"(derived products skipped: {e})")

    path = os.path.join(args.outdata, "monit.nc")
    with netcdf_file(path, "r", mmap=False) as f:
        t = f.variables["time"][:].copy()
        print(f"monit.nc: {len(t)} records, t = {t[0]:.4f}.."
              f"{t[-1]:.4f} years")

        def series(name):
            return (f.variables[name][:].copy()
                    if name in f.variables else None)

        for fluid, kname in (("ocean", "kealoc"), ("atmos", "kealat")):
            ke = series(kname)
            if ke is None:
                continue
            print(f"\n{fluid}: KE per layer (J/m^2)")
            print("  first:", np.array2string(ke[0], precision=4))
            print("  last: ", np.array2string(ke[-1], precision=4))
        for name in ("utauoc", "btdgoc", "pkenoc", "utauat", "olrtop",
                     "cnqgoc", "cnqgat", "cnmlat"):
            s = series(name)
            if s is not None:
                print(f"{name}: mean={s.mean():.4e} last={s[-1]:.4e}")
        for name in ("emfroc", "emfrat"):
            s = series(name)
            if s is not None:
                worst = np.abs(s).max()
                print(f"{name}: worst fractional error = {worst:.2e}")
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

    def add_dist(p):
        p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                       default="nccl", dest="dist_backend",
                       help="the process group's backend under torchrun: "
                       "nccl (default; each rank on the card of its local "
                       "rank) or gloo (the CPU, or ranks sharing a card, "
                       "on --device)")

    pr = sub.add_parser("run", help="run an experiment case")
    pr.add_argument("case")
    pr.add_argument("--outdir")
    pr.add_argument("--trun", type=float,
                    help="override run length (years)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in the "
                    "case's outdata (lastday.nc/restart.nc or their "
                    "_sharded directories) instead "
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
    pr.add_argument("--profile", metavar="DIR", default=None,
                    help="trace the third chunk with torch.profiler into "
                    "DIR (trace.json) and print the time by kernel (card) "
                    "or operator (CPU) per coupling cycle")
    pr.add_argument("--mesh", default=None, metavar="auto|rows|hybrid|NYxNX",
                    help="run decomposed over the ranks of a torchrun "
                    "launch: 'auto'/'rows' (row blocks), 'hybrid' (hosts "
                    "on y, a host's ranks on x: rows in a channel), or "
                    "NYxNX (a channel is cut by rows over its NY*NX ranks)")
    pr.add_argument("--ckpt-format", choices=["netcdf", "sharded"],
                    default="netcdf", dest="ckpt_format",
                    help="checkpoint format: 'netcdf' = the reference's "
                    "restart.nc schema (gathered to one rank); 'sharded' "
                    "= checkpoint directories restart_sharded/ and "
                    "lastday_sharded/ where each rank writes its own blocks "
                    "(the counterpart of qgcm_tpu's 'orbax')")
    add_dist(pr)
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

    pe = sub.add_parser("ensemble",
                        help="perturbed-IC ensemble (predictability) "
                             "run; writes a spread series to "
                             "ensemble.nc")
    pe.add_argument("case")
    pe.add_argument("--members", type=int, default=8)
    pe.add_argument("--amp", type=float, default=1e-3,
                    help="RMS ocean pressure perturbation (m^2 s^-2; "
                         "~0.1 per cm of SSH at mid-latitude f0)")
    pe.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator of the "
                    "perturbations (torch draws other numbers than "
                    "jax.random from the same seed)")
    pe.add_argument("--days", type=float, default=10.0,
                    help="run length (days)")
    pe.add_argument("--sample-days", type=float, default=1.0,
                    dest="sample_days",
                    help="spread-series sampling interval (days)")
    pe.add_argument("--shard-members", action="store_true",
                    dest="shard_members",
                    help="deal the members out over the ranks of a "
                    "torchrun launch, each stepping its block with no "
                    "collective (members a multiple of the ranks)")
    pe.add_argument("--outdir")
    pe.add_argument("--quiet", action="store_true")
    add_dist(pe)
    add_grid(pe)
    pe.set_defaults(fn=cmd_ensemble)

    ps = sub.add_parser("sense",
                        help="adjoint sensitivity of an objective to "
                        "forcing/IC (writes sensitivity.nc)")
    ps.add_argument("case")
    ps.add_argument("--objective", choices=["energy", "transport"],
                    default="energy",
                    help="scalar objective of the final state: "
                    "'energy' = layer-1 KE density; 'transport' = "
                    "zonal-mean layer-1 zonal transport (channels)")
    ps.add_argument("--days", type=float, default=10.0,
                    help="sensitivity horizon in model days")
    ps.add_argument("--remat", default="true",
                    help="backward-pass memory policy: true | dots | "
                    "false | an integer nested-checkpoint fan-out")
    ps.add_argument("--segment-days", type=float, default=0.0,
                    dest="segment_days",
                    help="host-level checkpointing: chain per-segment "
                    "backward passes of this many days each, for "
                    "horizons whose one-program backward exceeds the "
                    "card's memory (must divide --days)")
    ps.add_argument("--outdir")
    add_grid(ps)
    ps.set_defaults(fn=cmd_sense)

    pa = sub.add_parser("analyze", help="summarise a run's monit.nc")
    pa.add_argument("outdata")
    pa.add_argument("--chain", action="store_true",
                    help="unify a --resume segment chain (outdata, "
                    "outdata_r2, ...) into <case>/outdata_unified "
                    "first, then analyze the unified series")
    pa.set_defaults(fn=cmd_analyze)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
