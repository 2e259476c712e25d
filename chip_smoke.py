#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qgcm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --main-path CHECKOUT [CHECKOUT ...]
    python3 chip_smoke.py --windows CHECKOUT [CHECKOUT ...]

Builds the port's CUDA kernel from qgcm_torch/csrc with nvcc, holds it
against its plain PyTorch version on the card (model states, and seeded
random fields at the ragged edges of the kernel's strips), reproduces
the ocean golden run in float64 on the card, then drives the main path
-- the ocean-only double-gyre box, 961x961 p-points x 3 layers in
float32 -- through the public entry points, times it and profiles a few
substeps of it, and times the kernel alone against its bound at 3x961^2
(float32 and float64) and 3x4801^2 (NAtl 1 km, float32), with a hot and
with a cold L2, at the wrapper's strip height and at the heights around
it. Then the coupled model: the golden coupled run in float64, and the
two coupled paths at full width in float32 -- the double gyre (box
ocean 3x961^2 under a 3x97x385 atmosphere) and the southern-ocean
channel (cyclic ocean 3x577x4609 under 3x109x289) -- each timed per
coupling cycle, profiled whole and by part (xforc, ocean substep,
atmosphere step), with the kernel checked in its box and cyclic modes
at the coupled state; and last the two ocean-only channel presets
(southern_ocean_ocean_only, 3x577x4609, and k247_default, 2x961x961
with the sponge) for a few substeps each. Then the experiment driver
through the CLI (qgcm_torch.cli, in this process, under
build/qgcm_torch/cases): the coupled double gyre for two days with
every cadence firing (file set, monit.nc, resume equivalence, the
Driver's ms/cycle and a profile of its cycles between cadence events),
and the forced southern-ocean channel for ten days against the first
ten days of its committed production record. Last, the multi-process
path: the kernel's row-window and x_ext modes (the blocks of a
decomposed run) against its full-field mode, bit for bit, and timed
alone at a rank's window, a band, NAtl's rank window and a 2x2 block,
with their design (the window tile, or the march where it fills the
card); and the ocean-only runner decomposed into row blocks over 4
ranks (qgcm_torch.parallel) against the single-device runner, the
ranks sharing the one card over gloo (or, where the host has a card for
each, over NCCL). Then ensembles and adjoints: the kernel's member mode
(one launch for M members, bit for bit M single launches, timed alone),
8 members of the main path through the ensemble runner at full width
(and the golden box in float64, and 4 coupled members), each against
its single-trajectory run; the float64 adjoint of the double gyre and
the channel at full width, with the kernel in its forward, against
finite differences and across remat policies; and the ensemble,
analyze, sense and run --profile commands in this process. Then the
decomposed coupled model, the Driver and the commands on rows meshes
(phase 18); and last the 2-D runner (phase 19): the box ocean on 2x2
and 1x4 meshes of 4 ranks (the golden box in float64, the main path's
box and the coupled double gyre at full width in float32) against the
single-device runner, one rank's five x_ext launches of a substep
against their plain version, and `run --mesh 2x2` under torchrun with
a resume; then the distributed adjoint (phase 20): the float64 adjoint
of the main path's box on 4x1 and 2x2 meshes of 4 ranks with remat,
against the single-device adjoint on the card and a finite
difference, and every rank's window launches' gradients through the
kernel's autograd rule against autograd through their plain version.
Every phase raises on a failure; nothing runs on the CPU. The last line of
standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel
with its launch count on the main path and on each other path, its
error against the plain version, its times and its bound.

With --main-path it runs only phase 4, once for each checkout named
(a directory holding chip_smoke.py and qgcm_torch, such as a parent
commit unpacked under build/), each in a process of its own and in the
order given, and prints their ms/substep side by side. With --windows
it times, the same way, phase 12's window launches (among them the 2-D
runner's bands; and the full-field and member launches at 961^2) of
each checkout, side by side.

Needs one CUDA device. Imports neither JAX nor qgcm_tpu.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# f64 kernel vs plain chain: the TPU kernel's bar
# (tests/test_pallas_qg.py:49-52).
F64_TOL = 1e-12
# f32 kernel vs plain chain: both round every operation to float32 but
# sum in different orders and the kernel may fuse multiply-adds; qnew is
# qom plus a small increment, so the difference stays within a few ulp
# of max|q| (one ulp is 1.2e-7 relative).
F32_TOL = 1e-6
# float32 inversion round trip: max|qcomp(po) - qo| over the interior,
# relative to max|qo|. The error is the float32 FFT-DST solve's
# roundoff in po, raised by the 1/dx^2 of the Laplacian; the same run
# cut to 241^2 and 481^2 gives 1.4e-5 and 1.3e-5 in float32 on a CPU,
# not growing with the grid, so 1e-4 leaves a margin of about 7.
ROUND_TRIP_TOL = 1e-4
GOLDEN_RTOL = 1e-9
MAIN_STEPS = 250
WARMUP_STEPS = 25
PROFILE_STEPS = 10
# the coupled paths, in coupling cycles (one ocean substep and nstr = 3
# atmosphere steps each)
COUPLED_WARMUP_CYCLES = 10
COUPLED_CYCLES = 30
PROFILE_CYCLES = 3
# the ocean-only channel presets: substeps timed
CHANNEL_STEPS = 20
# where the main path's profiler trace is written (the kernel's build
# directory, listed in .gitignore)
TRACE = "build/qgcm_torch/main_path_trace.json"
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet,
# at the full 700 W): HBM3 bandwidth, and the non-tensor-core float
# rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# Floating-point operations of the fused step, counted from the
# arithmetic of csrc/qgstep.cu at an interior point: three 5-point
# Laplacians (6 each), the Jacobian (31), dq/dt (5) and the update (2)
# in every layer; the forcing of layers 0, 1 and nl-1 (7 a column in
# all); the sponge adds 4 a point. Their time is about an eighth of the
# bytes' time, so the bound is set by the bytes.
FLOP_PER_POINT = 56
FLOP_PER_COLUMN = 7
SPONGE_FLOP_PER_POINT = 4
# the L2 flush between cold launches: more than twice the 50 MB L2
FLUSH_BYTES = 128 * 2**20
# strip heights timed beside the wrapper's own in phase 5
SWEEP_HEIGHTS = (16, 24, 32, 48, 64, 96)


@contextlib.contextmanager
def phase(title):
    """Print a phase's title, then its seconds when it ends."""
    print(title)
    t0 = time.perf_counter()
    yield
    print(f"    ({time.perf_counter() - t0:.1f} s)")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sass_census(path) -> list[str]:
    """Per kernel function of the built library (each type: the march for
    one member or several, and the window tile), its machine instructions
    as cuobjdump -sass lists them: the total, the floating-point ones
    (FADD/FMUL/FFMA and the D forms), shared-memory loads (LDS, of which
    ptxas adds never-executed @!PT ones beside each cp.async) and the
    cp.async copies (LDGSTS). Empty if cuobjdump is absent."""
    from pathlib import Path
    from qgcm_torch.ops._cuda import _nvcc
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return []
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True).stdout
    lines = []
    for func in sass.split("Function : ")[1:]:
        ops = [m.split()[-1].split(".")[0] for m in re.findall(
            r"/\*[0-9a-f]{4}\*/\s+((?:@!?U?P\w+\s+)?[A-Z0-9]+)", func)]
        # the mangled name carries the instance: qgstep_kernelI<d|f>Lb<0|1>E
        # (the march, one member or several), qgstep_tile_kernelI<d|f>E
        name = func.split()[0]
        inst = re.search(r"qgstep_kernelI([df])Lb([01])E", name)
        tile = re.search(r"qgstep_tile_kernelI([df])E", name)
        found = inst or tile
        kind = ("double" if found and found.group(1) == "d" else "float") + (
            ", members" if inst and inst.group(2) == "1" else
            ", window tile" if tile else "")
        fp = sum(op in ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA")
                 for op in ops)
        lines.append(f"{kind}: {len(ops)} instructions, {fp} floating-point, "
                     f"{ops.count('LDS')} LDS, {ops.count('LDGSTS')} LDGSTS")
    return lines


def kernel_bound(nl, ny, nx, dtype, sponge, members=1, shared_planes=0):
    """(bound_ms, bound_by) of one fused step of `members` members: each
    of pom, po, qo, qom read once, wek and ent (and r_spl) read once,
    qnew written once, over the card's memory rate; or the step's
    operations over its peak float rate, whichever takes longer. Of the
    planes, `shared_planes` are one copy that all members share (member
    stride 0), read once for all of them."""
    item = torch.empty((), dtype=dtype).element_size()
    planes = 3 if sponge else 2
    nbytes = item * ny * nx * (members * (5 * nl + planes - shared_planes)
                               + shared_planes)
    flop = members * (nl * ny * nx * (FLOP_PER_POINT + (
        SPONGE_FLOP_PER_POINT if sponge else 0)) + FLOP_PER_COLUMN * ny * nx)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, CUDA
    events, after two warm-up calls; for the plain chain, whose host-side
    tensor set-up cannot be captured in a graph."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Milliseconds of one replay of a CUDA graph that holds `reps` calls
    of fn() (captured after an eager warm-up call), by CUDA events around
    the replay: the device's time, without the host's cost per launch
    (which at 961^2 is as long as the kernel)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def kernel_ms(fn, reps: int) -> tuple[float, float]:
    """(hot, cold): mean milliseconds of fn(), one kernel launch, from
    graph replays (graph_ms). Hot: back-to-back launches. Cold: each
    launch preceded by writing a FLUSH_BYTES buffer, less the time of the
    writes alone."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    hot = graph_ms(fn, reps) / reps
    writes = graph_ms(lambda: flush.fill_(1.0), reps)
    both = graph_ms(lambda: (flush.fill_(1.0), fn()), reps)
    return hot, (both - writes) / reps


def profile_units(fn, n, unit, card, top=8):
    """Profile fn(), which runs n units of work (substeps, cycles,
    calls), with torch.profiler and print, all from that one run: the
    host-clock ms/unit with the profiler on, the device-busy ms/unit
    (the union of the card's kernel, memcpy and memset intervals in the
    trace), the idle share 1 - busy/host, and the device time by kernel
    name. Only the card's activity is traced: host-side op records would
    slow the host, which sets the pace, and so inflate the idle share."""
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / n
    trace = Path(__file__).resolve().parent / TRACE
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    print(f"  profile of {n} {unit}s: host clock {host_ms:.4f} ms/{unit} "
          f"with the profiler on [{card}]")
    if not events:
        print("  device busy: not measured (no device activity in the "
              "profiler's trace)")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / n
    print(f"  device busy {busy_ms:.4f} ms/{unit} in {len(events)} device "
          f"activities ({len(events) / n:.0f}/{unit}); idle share "
          f"1 - busy/host = {1 - busy_ms / host_ms:.4f}")
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3 / n:8.4f} ms/{unit} "
              f"{100 * us / 1e3 / n / busy_ms:5.1f}%  {name[:90]}")


def small_cfg(nlo, sponge=False, tall=False):
    """The kernel-test configurations of tests/test_pallas_qg.py:17-36
    (box; the cyclic geometry is exercised through the kernel's flag)
    and the multi-tile one of :110-118 (nypo = 145)."""
    from qgcm_torch.config import ModelConfig, OceanConfig, SpongeConfig
    if tall:
        oc = OceanConfig(nlo=2, dxo=10e3, delek=2.0, hoc=(350.0, 2900.0),
                         gpoc=(0.015,), tabsoc=(287.0, 276.0),
                         ah2oc=(1e2, 1e2), ah4oc=(1e10, 2e10))
        return ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=24, ndxr=6,
                           fnot=5.92e-5, beta=2.08e-11, ocean=oc,
                           ocean_only=True)
    oc = OceanConfig(nlo=nlo, dxo=20e3, delek=2.0,
                     hoc=(350.0, 750.0, 2900.0)[:nlo],
                     gpoc=(0.015, 0.0075)[:nlo - 1],
                     tabsoc=(287.0, 282.0, 276.0)[:nlo],
                     ah2oc=(1e2, 1e2, 1e2)[:nlo],
                     ah4oc=(1e10, 2e10, 3e10)[:nlo])
    return ModelConfig(nxta=24, nyta=24, nxaooc=24, nyaooc=12, ndxr=6,
                       fnot=5.92e-5, beta=2.08e-11, ocean=oc,
                       ocean_only=True, sponge=SpongeConfig(enabled=sponge))


def kernel_inputs(model, state, forcing, cyclic):
    """The fused step's arguments at a model state. For the cyclic
    geometry the east column is made the duplicate of the west one, the
    convention the kernel's nested stencils rely on."""
    from qgcm_torch.models.ocean import _oml, qgstep_consts
    entoc = _oml(model, state, forcing)[2]
    fields = [state.pom, state.po, state.qo, state.qom]
    if cyclic:
        fields = [torch.cat([f[..., :-1], f[..., :1]], dim=-1)
                  for f in fields]
    cfg = model.cfg
    return (*fields, forcing.wekpo, entoc, model.r_spl,
            qgstep_consts(cfg, model.grids), cfg.ocean.ah2oc, cfg.ocean.ah4oc)


def compare(args, cyclic, sponge):
    """(max |kernel - plain|, max |plain|) of one call of each."""
    from qgcm_torch.ops.qgstep import qgstep, qgstep_reference
    got = qgstep(*args, cyclic=cyclic, sponge=sponge)
    ref = qgstep_reference(*args, cyclic=cyclic, sponge=sponge)
    torch.cuda.synchronize()
    return ((got - ref).abs().max().item(), ref.abs().max().item())


def phase_kernel_small(device):
    from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state, make_ocean_step,
                                         ocean_forcing_from_mean, _oml,
                                         _qgostep)
    cases = [("box nlo=3", dict(nlo=3), False, False),
             ("box nlo=2", dict(nlo=2), False, False),
             ("box+sponge nlo=3", dict(nlo=3, sponge=True), False, True),
             ("cyclic nlo=3", dict(nlo=3), True, False),
             ("cyclic nlo=2", dict(nlo=2), True, False),
             ("cyclic+sponge nlo=3", dict(nlo=3, sponge=True), True, True),
             ("cyclic+sponge nlo=2", dict(nlo=2, sponge=True), True, True),
             ("box 145x145 nlo=2", dict(nlo=2, tall=True), False, False),
             ("cyclic 145x145 nlo=2", dict(nlo=2, tall=True), True, False)]
    for dtype, tol in (("float64", F64_TOL), ("float32", F32_TOL)):
        for name, kw, cyclic, sponge in cases:
            cfg = small_cfg(**kw).replace(dtype=dtype)
            model = build_model(cfg, device)
            st = init_ocean_state(model, po=eddy_pressure(cfg))
            f = ocean_forcing_from_mean(
                model, *double_gyre_windstress(cfg, model.grids))
            step = make_ocean_step(model)
            for _ in range(2):      # so that qo != qcomp(po) trivially
                st, _ = step(st, f)
            err, scale = compare(kernel_inputs(model, st, f, cyclic),
                                 cyclic, sponge)
            qom_new = _qgostep(model, st, f, _oml(model, st, f)[2])[1]
            qom_exact = torch.equal(qom_new, st.qo)
            print(f"  {dtype} {name:22s} shape {tuple(st.po.shape)}: "
                  f"max|dq| = {err:.3e} = {err / scale:.3e} max|q| "
                  f"(bar {tol:g}); qom bit-exact: {qom_exact}")
            if not err <= tol * scale:
                raise AssertionError(f"kernel disagrees with the plain "
                                     f"chain: {dtype} {name}")
            if not qom_exact:
                raise AssertionError(f"qom_new is not the old qo: {name}")


def random_args(nl, ny, nx, dtype, cyclic, sponge, seed, consts=None,
                ah=None):
    """The fused step's arguments from seeded random fields on the card.
    With the cyclic geometry the east column duplicates the west one.
    `consts` and `ah` = (ah2, ah4) default to random values of order
    one."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dt)

    fields = [rnd(nl, ny, nx) for _ in range(4)]
    if cyclic:
        for f in fields:
            f[..., -1] = f[..., 0]
    wek, ent, r_spl = (rnd(ny, nx) for _ in range(3))

    def order_one(n):
        u = torch.rand(n, generator=g, device="cuda", dtype=torch.float64)
        return tuple((0.2 + 0.8 * u).tolist())

    if consts is None:
        consts = order_one(11)
    ah2, ah4 = ah if ah is not None else (order_one(nl), order_one(nl))
    return (*fields, wek, ent, r_spl if sponge else None, consts, ah2, ah4)


@contextlib.contextmanager
def strip_height(h):
    """Launch qgstep with strips of h rows inside the block."""
    from qgcm_torch.ops import qgstep as mod
    picker = mod.launch_geometry
    mod.launch_geometry = lambda nl, ny, nx, resident: mod.Geometry(
        mod.STRIP_W, h, -(-nx // mod.STRIP_W), -(-ny // h))
    try:
        yield
    finally:
        mod.launch_geometry = picker


def phase_kernel_ragged():
    """The kernel against its plain chain on seeded random fields at the
    ragged edges of its strips: strip heights MIN_STRIP_H and MAX_STRIP_H
    forced on grids of H-1, H and H+1 rows (H+1 leaves a last strip of
    one row), STRIP_W-1 and STRIP_W+1 columns, box and cyclic, with and
    without the sponge, nl 2 and 3."""
    from qgcm_torch.ops.qgstep import MAX_STRIP_H, MIN_STRIP_H, STRIP_W
    n = 0
    for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
        for h in (MIN_STRIP_H, MAX_STRIP_H):
            for ny in (h - 1, h, h + 1):
                for nx in (STRIP_W - 1, STRIP_W + 1):
                    worst = 0.0
                    for nl in (2, 3):
                        for cyclic in (False, True):
                            for sponge in (False, True):
                                n += 1
                                args = random_args(nl, ny, nx, dtype,
                                                   cyclic, sponge, n)
                                with strip_height(h):
                                    err, scale = compare(args, cyclic,
                                                         sponge)
                                worst = max(worst, err / scale)
                                if not err <= tol * scale:
                                    raise AssertionError(
                                        f"kernel disagrees with the plain "
                                        f"chain: {dtype} strip {h} "
                                        f"nl={nl} {ny}x{nx} cyclic={cyclic} "
                                        f"sponge={sponge}")
                    print(f"  {str(dtype)[6:]} strip height {h:2d}, "
                          f"{ny}x{nx}: worst max|dq| = {worst:.3e} max|q| "
                          f"over nl 2-3, box/cyclic, sponge off/on "
                          f"(bar {tol:g})")
    print(f"  {n} ragged cases passed")


def phase_golden(device):
    """tests/test_golden.py::test_golden_ocean_only_box on the card."""
    from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep
    cfg = golden_cfg()
    model = build_model(cfg, device)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids, tau0=2e-5))
    n0 = qgstep.launches
    st = make_ocean_only_runner(model)(st, f, 50)
    if qgstep.launches - n0 != 50:
        raise AssertionError("the golden run did not go through the kernel")
    po, qo, sst = (st.po.cpu().numpy(), st.qo.cpu().numpy(),
                   st.sst.cpu().numpy())
    got = dict(po_sum=float(po.sum()), po_l1=float(np.abs(po).sum()),
               po_max=float(po.max()), qo_l1=float(np.abs(qo).sum()),
               sst_l1=float(np.abs(sst).sum()),
               dpioc0=float(st.dpioc[0].item()))
    expected = dict(po_sum=31.416626761421, po_l1=32.5480213744938,
                    po_max=0.962083301276373,
                    qo_l1=0.0038091058169070335,
                    sst_l1=2.135746401204379, dpioc0=-19680485411.11134)
    for k, v in expected.items():
        rel = abs(got[k] - v) / abs(v)
        print(f"  {k:7s} {got[k]!r:>24} expected {v!r:>24} rel {rel:.2e}")
        if not rel <= GOLDEN_RTOL:
            raise AssertionError(f"golden {k} off by {rel:.3e} relative")


def phase_main(device, card):
    """The main path at full width: build_model -> init_ocean_state ->
    ocean_forcing_from_mean -> make_ocean_only_runner, float32. Returns
    its kernels-line entry and (for phase 15) its model, final state,
    forcing, substeps taken and ms/substep."""
    from qgcm_torch.config import double_gyre_ocean_only, ml_f64_enabled
    from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep, qgstep_reference

    cfg = double_gyre_ocean_only(dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, device)
    st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.15))
    f = ocean_forcing_from_mean(
        model, *double_gyre_windstress(cfg, model.grids))
    run = make_ocean_only_runner(model)
    torch.cuda.synchronize()
    print(f"  {cfg.nlo}x{cfg.nypo}x{cfg.nxpo} float32, ml_f64 "
          f"{ml_f64_enabled(cfg)}; set-up {time.perf_counter() - t0:.2f} s")

    st = run(st, f, WARMUP_STEPS)
    torch.cuda.synchronize()

    qgstep.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    st = run(st, f, MAIN_STEPS, step0=WARMUP_STEPS)
    ev1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0
    launches = qgstep.launches
    dev_ms = ev0.elapsed_time(ev1) / MAIN_STEPS
    if launches != MAIN_STEPS:
        raise AssertionError(f"qgstep launched {launches} times in "
                             f"{MAIN_STEPS} substeps")
    for name, t in st._asdict().items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")
    pts = cfg.nxpo * cfg.nypo * cfg.nlo
    print(f"  {MAIN_STEPS} substeps: {dev_ms:.4f} ms/substep (CUDA events), "
          f"{host_s / MAIN_STEPS * 1e3:.4f} ms/substep (host clock), "
          f"{pts * MAIN_STEPS / host_s:.4e} grid-point-layer updates/s "
          f"[{card}]")
    print(f"  qgstep launches on the main path: {launches}")

    rt = round_trip(st.qo, st.po, model.amat, model.yporel,
                    1.0 / model.grids.dxo**2, cfg, model.ddyn, cfg.nlo - 1,
                    cyclic=False)
    print(f"  inversion round trip max|qcomp(po) - qo| / max|qo| = {rt:.3e} "
          f"(bar {ROUND_TRIP_TOL:g})")
    if not rt <= ROUND_TRIP_TOL:
        raise AssertionError("qcomp(po) does not reproduce qo")
    profile_units(lambda: run(st, f, PROFILE_STEPS,
                              step0=WARMUP_STEPS + MAIN_STEPS),
                  PROFILE_STEPS, "substep", card)

    args = kernel_inputs(model, st, f, cyclic=False)
    err, scale = compare(args, cyclic=False, sponge=False)
    print(f"  kernel vs plain at {tuple(st.po.shape)} float32: max|dq| = "
          f"{err:.3e} = {err / scale:.3e} max|q| (bar {F32_TOL:g})")
    if not err <= F32_TOL * scale:
        raise AssertionError("kernel disagrees with the plain chain at the "
                             "main path's shape")
    k_ms = graph_ms(lambda: qgstep(*args, cyclic=False, sponge=False),
                    100) / 100
    eager_ms = cuda_ms(lambda: qgstep(*args, cyclic=False, sponge=False),
                       100)
    p_ms = cuda_ms(lambda: qgstep_reference(*args, cyclic=False,
                                            sponge=False), 20)
    print(f"  qgstep kernel {k_ms:.4f} ms (CUDA-graph replay), "
          f"{eager_ms:.4f} ms (events around eager wrapper calls); plain "
          f"chain {p_ms:.4f} ms [{card}]")
    nl, ny, nx = st.po.shape
    bound, by = kernel_bound(nl, ny, nx, torch.float32, sponge=False)
    print(f"  bound {bound:.4f} ms ({by}), share of bound "
          f"{bound / k_ms:.3f} [{card}]")
    main = dict(model=model, state=st, forcing=f,
                step0=WARMUP_STEPS + MAIN_STEPS,
                substep_ms=dev_ms, host_ms=host_s / MAIN_STEPS * 1e3)
    return dict(name="qgstep", route="cuda",
                source="qgcm_torch/csrc/qgstep.cu",
                replaces="qgcm_tpu/ops/pallas_qg.py:277",
                launches=launches, max_abs_err=err, ms=k_ms,
                ms_method="cuda_graph_replay", eager_ms=eager_ms,
                plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=None,
                share_of_bound=bound / k_ms), main


def phase_golden_coupled(device):
    """tests/test_golden.py::test_golden_coupled on the card: 30
    atmosphere steps (10 coupling cycles) of the small coupled box in
    float64 from the radiative balance."""
    from qgcm_torch.config import OceanConfig, double_gyre_coupled
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state
    from qgcm_torch.models.ocean import init_ocean_state
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep
    cfg = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8, ndxr=4,
                              dta=180.0, ocean=OceanConfig(dxo=20.0e3))
    model = build_model(cfg, device)
    oc = init_ocean_state(model, init="rbal")
    at = init_atmos_state(model, init="rbal")
    qgstep.launches = 0
    oc, at = make_coupled_runner(model)(oc, at, 30)
    torch.cuda.synchronize()
    if qgstep.launches != 10:
        raise AssertionError(f"the golden coupled run launched qgstep "
                             f"{qgstep.launches} times in 10 cycles")
    got = dict(pa_l1=at.pa.abs().sum().item(), pa_max=at.pa.max().item(),
               ast_l1=at.ast.abs().sum().item(),
               hmixa_sum=at.hmixa.sum().item(),
               po_l1=oc.po.abs().sum().item(),
               sst_l1=oc.sst.abs().sum().item())
    expected = dict(pa_l1=4494126.575996573, pa_max=10034.029753613597,
                    ast_l1=3013.375749852249, hmixa_sum=287999.9999953847,
                    po_l1=8.576337767308004, sst_l1=7884.8790379866205)
    for k, v in expected.items():
        rel = abs(got[k] - v) / abs(v)
        print(f"  {k:9s} {got[k]!r:>24} expected {v!r:>24} rel {rel:.2e}")
        if not rel <= GOLDEN_RTOL:
            raise AssertionError(f"golden coupled {k} off by {rel:.3e}")


def round_trip(q, p, amat, yprel, dxm2, cfg, ddyn, kbot, cyclic):
    """max|qcomp(p) - q| / max|q| at the interior points (the rows
    inside the zonal walls, and in the box the columns inside the
    meridional ones)."""
    from qgcm_torch.ops.vorticity import qcomp
    q_re = qcomp(p, amat, yprel, dxm2, cfg.fnot, cfg.beta, ddyn, kbot,
                 cyclic=cyclic)
    inner = (slice(None), slice(1, -1),
             slice(None) if cyclic else slice(1, -1))
    return ((q - q_re)[inner].abs().max() / q.abs().max()).item()


def phase_coupled(device, card, preset, keep=None):
    """A coupled path at full width in float32 through the public entry
    points: build_model -> init_ocean_state / init_atmos_state ('rbal',
    and a Gaussian eddy in the ocean's pressure) -> make_coupled_runner;
    warm-up, a timed run (CUDA events), a
    profiled run, each part of a cycle profiled alone, and the checks:
    launches, finite fields, the kernel against its plain version at
    the coupled state, both inversions' round trips, the continuity
    monitors, and in the channel the duplicate column. Returns the
    path's entry of the kernels line; `keep` (a dict) gets the final
    states on the host and their atmosphere step (phase 18 starts
    there)."""
    from qgcm_torch.coupling import make_xforc
    from qgcm_torch.generators import eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state, make_atmos_step
    from qgcm_torch.models.ocean import init_ocean_state, make_ocean_step
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep, qgstep_reference

    cfg = preset(dtype="float32")
    cyclic = cfg.cyclic_ocean
    nstr = cfg.nstr
    t0 = time.perf_counter()
    model = build_model(cfg, device)
    # The balanced atmosphere has no wind in its bottom layer, so an
    # ocean at rest would stay at rest in float32 over these cycles (the
    # channel's does) and the kernel would be checked on zero increments.
    oc = init_ocean_state(model, init="rbal",
                          po=eddy_pressure(cfg, ssh_amp=0.15))
    at = init_atmos_state(model, init="rbal")
    run = make_coupled_runner(model)
    torch.cuda.synchronize()
    print(f"  ocean {cfg.nlo}x{cfg.nypo}x{cfg.nxpo} "
          f"({'cyclic' if cyclic else 'box'}), atmosphere "
          f"{cfg.nla}x{cfg.nypa}x{cfg.nxpa}, fine grid "
          f"{cfg.nypaor}x{cfg.nxpaor}, float32; set-up "
          f"{time.perf_counter() - t0:.2f} s")

    step0 = COUPLED_WARMUP_CYCLES * nstr
    oc, at = run(oc, at, step0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qgstep.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    oc, at = run(oc, at, COUPLED_CYCLES * nstr, step0=step0)
    ev1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - h0
    launches = qgstep.launches
    step0 += COUPLED_CYCLES * nstr
    if launches != COUPLED_CYCLES:
        raise AssertionError(f"qgstep launched {launches} times in "
                             f"{COUPLED_CYCLES} coupling cycles")
    for name, t in (*oc._asdict().items(), *at._asdict().items()):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")
    print(f"  {COUPLED_CYCLES} cycles ({COUPLED_CYCLES * nstr} atmosphere "
          f"steps): {ev0.elapsed_time(ev1) / COUPLED_CYCLES:.4f} ms/cycle "
          f"(CUDA events), {host_s / COUPLED_CYCLES * 1e3:.4f} ms/cycle "
          f"(host clock); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    print(f"  qgstep launches on this path: {launches} in {COUPLED_CYCLES} "
          f"cycles")
    profile_units(lambda: run(oc, at, PROFILE_CYCLES * nstr, step0=step0),
                  PROFILE_CYCLES, "cycle", card)
    if keep is not None:
        keep[preset.__name__] = (to_host(oc), to_host(at), step0)

    # each part of a cycle alone, from the run's last state
    xforc = make_xforc(model)
    ostep, astep = make_ocean_step(model), make_atmos_step(model)
    ofor, afor, _ = xforc(at.pam, oc.pom, oc.sstm, at.astm, at.hmixam)
    for part, fn in (("xforc call", lambda: xforc(at.pam, oc.pom, oc.sstm,
                                                  at.astm, at.hmixam)),
                     ("ocean substep", lambda: ostep(oc, ofor)),
                     ("atmosphere step", lambda: astep(at, afor))):
        print(f"  -- {part}s alone:")
        profile_units(lambda: [fn() for _ in range(PROFILE_CYCLES)],
                      PROFILE_CYCLES, part.split()[-1], card, top=4)
    _, od = ostep(oc, ofor)
    _, ad = astep(at, afor)
    print(f"  last emfroc {od.emfroc.tolist()}, emfrat {ad.emfrat.tolist()}")

    g = model.grids
    rt_o = round_trip(oc.qo, oc.po, model.amat, model.yporel, 1 / g.dxo**2,
                      cfg, model.ddyn, cfg.nlo - 1, cyclic)
    rt_a = round_trip(at.qa, at.pa, model.amat_at, model.yparel,
                      1 / g.dxa**2, cfg, model.ddyn_at, 0, True)
    print(f"  inversion round trips max|qcomp(p) - q| / max|q|: ocean "
          f"{rt_o:.3e} (bar {ROUND_TRIP_TOL:g}), atmosphere {rt_a:.3e}")
    if not rt_o <= ROUND_TRIP_TOL:
        raise AssertionError("qcomp(po) does not reproduce qo")
    if cyclic:
        dup = torch.equal(oc.po[..., -1], oc.po[..., 0])
        print(f"  po[..., -1] == po[..., 0] bit for bit: {dup}")
        if not dup:
            raise AssertionError("the channel lost its duplicate column")

    args = kernel_inputs(model, oc, ofor, cyclic)
    err, scale = compare(args, cyclic=cyclic, sponge=False)
    nl, ny, nx = oc.po.shape
    print(f"  kernel vs plain at {(nl, ny, nx)} float32, "
          f"{'cyclic' if cyclic else 'box'} mode: max|dq| = {err:.3e} = "
          f"{err / scale:.3e} max|q| (bar {F32_TOL:g})")
    if not err <= F32_TOL * scale:
        raise AssertionError("kernel disagrees with the plain chain on the "
                             "coupled path")
    hot, cold = kernel_ms(lambda: qgstep(*args, cyclic=cyclic, sponge=False),
                          50)
    plain = cuda_ms(lambda: qgstep_reference(*args, cyclic=cyclic,
                                             sponge=False), 5)
    bound, by = kernel_bound(nl, ny, nx, torch.float32, sponge=False)
    print(f"  qgstep kernel {hot:.4f} ms hot L2, {cold:.4f} ms cold L2 "
          f"(CUDA-graph replays); plain chain {plain:.4f} ms; bound "
          f"{bound:.4f} ms ({by}); share of bound {bound / hot:.3f} hot "
          f"[{card}]")
    return dict(path=preset.__name__, shape=[nl, ny, nx], cyclic=cyclic,
                launches=launches, max_abs_err=err, ms=hot, cold_ms=cold,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                cycle_ms=ev0.elapsed_time(ev1) / COUPLED_CYCLES)


def phase_channel(device, card, preset):
    """An ocean-only channel preset at full width in float32 through the
    public entry points (an unforced Gaussian eddy over the
    radiative-balance SST): timed substeps, launches, finite fields, the
    duplicate column, and the kernel against its plain version in cyclic
    mode (with the k247 sponge where the preset has it). Returns the
    path's entry of the kernels line."""
    from qgcm_torch.generators import eddy_pressure, zero_forcing
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep

    cfg = preset(dtype="float32")
    sponge = cfg.sponge.enabled
    t0 = time.perf_counter()
    model = build_model(cfg, device)
    st = init_ocean_state(model, init="rbal",
                          po=eddy_pressure(cfg, ssh_amp=0.15))
    f = ocean_forcing_from_mean(model, *zero_forcing(cfg))
    run = make_ocean_only_runner(model)
    st = run(st, f, 5)
    torch.cuda.synchronize()
    print(f"  {preset.__name__}: ocean {cfg.nlo}x{cfg.nypo}x{cfg.nxpo} "
          f"(cyclic{', sponge' if sponge else ''}), float32; set-up and 5 "
          f"substeps {time.perf_counter() - t0:.2f} s")
    qgstep.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    st = run(st, f, CHANNEL_STEPS, step0=5)
    ev1.record()
    torch.cuda.synchronize()
    launches = qgstep.launches
    if launches != CHANNEL_STEPS:
        raise AssertionError(f"qgstep launched {launches} times in "
                             f"{CHANNEL_STEPS} substeps")
    for name, t in st._asdict().items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {name}")
    if not torch.equal(st.po[..., -1], st.po[..., 0]):
        raise AssertionError("the channel lost its duplicate column")
    args = kernel_inputs(model, st, f, cyclic=True)
    err, scale = compare(args, cyclic=True, sponge=sponge)
    nl, ny, nx = st.po.shape
    hot, cold = kernel_ms(lambda: qgstep(*args, cyclic=True, sponge=sponge),
                          20)
    from qgcm_torch.ops.qgstep import qgstep_reference
    plain = cuda_ms(lambda: qgstep_reference(*args, cyclic=True,
                                             sponge=sponge), 3)
    bound, by = kernel_bound(nl, ny, nx, torch.float32, sponge=sponge)
    from qgcm_torch.ops.qgstep import launch_geometry, resident_blocks
    resident = resident_blocks(st.po.device, st.po.dtype, sponge)
    geo = launch_geometry(nl, ny, nx, resident)
    print(f"    {ev0.elapsed_time(ev1) / CHANNEL_STEPS:.4f} ms/substep (CUDA "
          f"events); {launches} launches in {CHANNEL_STEPS} substeps; "
          f"duplicate column bit for bit; kernel vs plain "
          f"{err / scale:.3e} max|q| (bar {F32_TOL:g}); kernel {hot:.4f} / "
          f"{cold:.4f} ms hot/cold, plain chain {plain:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); strips "
          f"{geo.strip_w}x{geo.strip_h}, {geo.strips_x * geo.strips_y * nl} "
          f"blocks, {resident} resident at once [{card}]")
    if not err <= F32_TOL * scale:
        raise AssertionError(f"kernel disagrees with the plain chain on "
                             f"{preset.__name__}")
    return dict(path=preset.__name__, shape=[nl, ny, nx], cyclic=True,
                sponge=sponge, launches=launches, max_abs_err=err, ms=hot,
                cold_ms=cold, plain_ms=plain, bound_ms=bound, bound_by=by,
                strip_h=geo.strip_h,
                blocks=geo.strips_x * geo.strips_y * nl,
                substep_ms=ev0.elapsed_time(ev1) / CHANNEL_STEPS)


def phase_kernel_timing(card):
    """The kernel alone at the main path's shape in float32 and float64
    and at NAtl 1 km (3x4801^2, float32), on seeded random fields with
    each configuration's constants: checked against the plain chain,
    timed with a hot L2 (back-to-back launches) and a cold one beside its
    bound, at the wrapper's strip height and at each of SWEEP_HEIGHTS.
    No PyTorch call computes the same function, so there is no library
    time."""
    from qgcm_torch.config import double_gyre_ocean_only, natl_1km
    from qgcm_torch.grids import build_grids
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.ops.qgstep import (launch_geometry, qgstep,
                                       qgstep_reference, resident_blocks)
    for seed, (cfg, dtype, reps) in enumerate((
            (double_gyre_ocean_only(), torch.float64, 50),
            (double_gyre_ocean_only(), torch.float32, 50),
            (natl_1km(), torch.float32, 20))):
        nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
        args = random_args(nl, ny, nx, dtype, False, False, 1000 + seed,
                           consts=qgstep_consts(cfg, build_grids(cfg)),
                           ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        err, scale = compare(args, cyclic=False, sponge=False)
        name = f"{nl}x{ny}x{nx} {str(dtype)[6:]}"
        if not err <= tol * scale:
            raise AssertionError(f"kernel disagrees with the plain chain at "
                                 f"{name}")
        resident = resident_blocks(args[0].device, dtype, False)
        g = launch_geometry(nl, ny, nx, resident)

        def run():
            qgstep(*args, cyclic=False, sponge=False)

        hot, cold = kernel_ms(run, reps)
        plain = cuda_ms(lambda: qgstep_reference(*args, cyclic=False,
                                                 sponge=False), 3)
        bound, by = kernel_bound(nl, ny, nx, dtype, sponge=False)
        print(f"  {name}: strips {g.strip_w}x{g.strip_h}, "
              f"{g.strips_x * g.strips_y * nl} blocks, {resident} resident "
              f"at once; max|dq| = "
              f"{err / scale:.3e} max|q| (bar {tol:g})")
        print(f"    kernel {hot:.4f} ms hot L2, {cold:.4f} ms cold L2; "
              f"plain chain {plain:.4f} ms; bound {bound:.4f} ms ({by}); "
              f"share of bound {bound / hot:.3f} hot, {bound / cold:.3f} "
              f"cold [{card}]")
        sweep = []
        for h in SWEEP_HEIGHTS:
            with strip_height(h):
                sweep.append("{}: {:.4f}/{:.4f}".format(h, *kernel_ms(run,
                                                                       reps)))
        print(f"    by strip height, ms hot/cold L2: {', '.join(sweep)}")
        del args
        torch.cuda.empty_cache()


def profile_counts(fn, n, unit, card) -> dict:
    """Profile fn(), n units of work, with torch.profiler tracing both
    the host's CUDA runtime calls and the card, and print per unit: the
    kernel launches, the device busy time (union of kernel, memcpy and
    memset intervals), the device-to-host copies and the host syncs
    (cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize
    and blocking cudaMemcpy) that fn() makes: those inside its
    record_function window, each named with the innermost operator
    around it."""
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("profiled_window"):
            fn()
        torch.cuda.synchronize()
    trace = Path(__file__).resolve().parent / TRACE
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    win = next(e for e in events if e.get("name") == "profiled_window"
               and e.get("ph") == "X"
               and e.get("cat") != "gpu_user_annotation")
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    d2h = sum(e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]
              for e in events)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    sync_ops = []
    for e in events:
        if (e.get("cat") == "cuda_runtime" and t0 <= e["ts"] <= t1
                and e["name"] in ("cudaStreamSynchronize",
                                  "cudaDeviceSynchronize",
                                  "cudaEventSynchronize", "cudaMemcpy")):
            around = [o for o in ops
                      if o["ts"] <= e["ts"] <= o["ts"] + o["dur"]]
            inner = (min(around, key=lambda o: o["dur"])["name"]
                     if around else "no operator")
            sync_ops.append(f"{e['name']} in {inner}")
    syncs = len(sync_ops)
    if sync_ops:
        print(f"    host syncs in the window: {sorted(set(sync_ops))}")
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    # launches by kernel name, and by the operator that launched them
    # (the trace links a kernel to its operator by "External id")
    op_of = {e["args"]["External id"]: e["name"] for e in ops
             if "External id" in e.get("args", {})}
    by_kernel, by_op = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0) + 1 / n
            op = op_of.get(e.get("args", {}).get("External id"), "no operator")
            by_op[op] = by_op.get(op, 0) + 1 / n
    out = dict(launches=kernels / n, busy_ms=busy_us / 1e3 / n,
               d2h=d2h / n, syncs=syncs / n, by_kernel=by_kernel,
               by_op=by_op)
    print(f"    per {unit}: {out['launches']:.1f} kernel launches, device "
          f"busy {out['busy_ms']:.4f} ms, {out['d2h']:.2f} device-to-host "
          f"copies, {out['syncs']:.2f} host syncs [{card}]")
    return out


CASES = "build/qgcm_torch/cases"
# phase 10: days of the double gyre through the Driver, and its cadences
# (every one fires at least twice); the initial state is the restart.nc
# that `prepare` writes
DRIVER_DAYS = 2
DRIVER_CADENCES = dict(valday=0.25, dgnday=0.25, odiday=1.0, adiday=1.0,
                       prtday=1.0, resday=1.0, dtavoc=1.0, dtavat=0.25,
                       name="restart.nc")
# Resume equivalence, float32: max|resumed - straight| / max|straight| of
# po, sst, pa and ast after DRIVER_DAYS days, one of them resumed from
# the day-1 restart. The restart recomputes PV from pressure, so the two
# runs part at float32 roundoff and the difference grows for a day. The
# same case cut to a 241^2 ocean under a 96x24 atmosphere gives po
# 4.9e-7, sst 6.3e-6, pa 8.7e-7 and ast 1.35e-5 in float32 on a CPU; 1e-4
# leaves a margin of about 7 over the largest. Those readings come from
# phase 10's commands with the flags `--nxaooc 15 --nyaooc 15 --nxta 96
# --nyta 24 --device cpu` added: prepare and run the 2-day case, prepare
# and run its 1-day copy, `run --resume` that for a day, and compare the
# two lastday.nc files as resume_errors does.
RESUME_TOL = 1e-4
# phase 11: the forced channel's committed production record
CHANNEL_CASE = "examples/southern_ocean_forced_1yr"
CHANNEL_TRUN = 0.0273972602739726      # 10 of 365 days: 1600 substeps
CHANNEL_RECORDS = 10
MONITOR_TOL = 1e-3
# monit.nc series that two float32 runs need not share: printed beside
# the record and the float64 run, not held (PERF.md, section 6)
NOT_HELD = {
    "ocjpos": "an argmax over rows of the zonal-mean flow; the record "
              "jumps between rows 283 and 284 in layers 2-3, a near tie "
              "(the maximum itself, ocjval, is held)",
    "entmoc": "the mean of an entrainment whose mean the mixed layer "
              "removes: float32 roundoff, 1e-14 beside a mean |e| of 4e-8",
    "etamoc": "the mean interface displacement, which the mass "
              "constraint holds at zero: float32 roundoff, 1e-6 m beside "
              "an RMS displacement of 36 m",
    "vgminoc": "a meridional speed of a zonal channel flow: float32 "
               "roundoff, 1e-6 beside zonal speeds of 0.018 m/s",
    "vgmaxoc": "as vgminoc",
}
# The second witness: phase 11's days run again in float64 on the card.
# A held series passes if the card's float32 run is within MONITOR_TOL of
# the record, or else no farther from the float64 run than WITNESS_FACTOR
# times the record is (both float32 runs then stand apart by rounding,
# not physics). With the channel solver as it is, that ratio read
# 0.6-3.8 on the card in every held series but the tendencies; with the
# float32 constraint algebra and FFT y-DST it had, ugminoc and umminoc
# missed both bars (PERF.md, section 6).
WITNESS_FACTOR = 4.0
# The one-substep tendencies, held against the float64 run alone: their
# daily values alternate by 2x with where the sample falls in the
# 25-substep averaging of the leapfrog's levels, which a 20% bar holds;
# the card's float32 run parts from float64 by 5.6e-2 to 1.1e-1 in them
# (the record by 2.6e-3 and 1.7e-2), a gap still open (PERF.md, 7).
TENDENCIES = ("ddtkeoc", "ddtpeoc")
TENDENCY_TOL = 0.2


def case_params(src, dst, **values):
    """Copy an input.params file, replacing the values of the named
    parameters (the reference's order of lines, qgcm_torch.params)."""
    from pathlib import Path
    from qgcm_torch.params import _ORDER
    names = [name for name, _ in _ORDER]
    lines, i = [], 0
    for line in Path(src).read_text().splitlines(keepends=True):
        if line.strip() and not line.startswith("!"):
            if names[i] in values:
                line = f" {values[names[i]]}    !! {names[i]}\n"
            i += 1
        lines.append(line)
    Path(dst).write_text("".join(lines))


def run_cli(argv):
    """qgcm_torch.cli.main(argv) in this process (so that the kernel's
    launch counter sees its launches): (its log, the Driver's seconds
    stepping and in cadence events). Raises if it fails."""
    import io
    from qgcm_torch.cli import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    log = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"qgcm-torch {argv[0]} exited {rc}:\n{log}")
    m = re.search(r"([\d.]+) s stepping, ([\d.]+) s in cadence events", log)
    return log, (float(m.group(1)), float(m.group(2))) if m else None


def new_case(label, params_src, **values):
    """An empty case directory build/qgcm_torch/cases/<label> holding a
    copy of params_src with `values` replaced."""
    import shutil
    from pathlib import Path
    root = Path(__file__).resolve().parent
    case = root / CASES / label
    shutil.rmtree(case, ignore_errors=True)
    case.mkdir(parents=True)
    case_params(root / params_src, case / "input.params", **values)
    return case


def lastday(case, seg="outdata"):
    from qgcm_torch.io.ncdf import read_vars
    return read_vars(str(case / seg / "lastday.nc"),
                     ["po", "sst", "pa", "ast"])


def resume_errors(grid, straight):
    """Run the phase-10 case for a day, then `run --resume` for a day,
    and return max|resumed - straight| / max|straight| of po, sst, pa
    and ast against the `straight` lastday.nc fields."""
    case = new_case("double_gyre_coupled_resume",
                    "examples/double_gyre_coupled/input.params",
                    trun=1.0 / 365.0, **DRIVER_CADENCES)
    run_cli(["prepare", str(case), "--eddy-amp", "0.15"] + grid)
    run_cli(["run", str(case), "--quiet"] + grid)
    run_cli(["run", str(case), "--quiet", "--resume"] + grid)
    got = lastday(case, "outdata_r2")
    return {k: float(np.abs(got[k] - v).max() / np.abs(v).max())
            for k, v in straight.items()}


def monit_series(path):
    from scipy.io import netcdf_file
    with netcdf_file(str(path), "r", mmap=False) as f:
        return {n: np.array(v[:]) for n, v in f.variables.items()}, {
            n: v.dimensions for n, v in f.variables.items()}


def phase_driver_coupled(card, bare):
    """The double gyre, coupled, float32 at full width through the CLI:
    prepare (an ocean eddy), run DRIVER_DAYS days with every cadence
    firing, check the file set, monit.nc (8 records of the coupled
    schema's 96 variables, finite) and the kernel's launches; the resume
    equivalence; the Driver's ms/cycle beside phase 7's bare runner; and
    a profile of 3 cycles of the Driver between cadence events beside the
    bare runner's from the same state. Returns the path's entry."""
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.diags import monitor
    from qgcm_torch.model import build_model
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep
    from qgcm_torch.params import parse_input_params, params_to_config
    from qgcm_torch.run import Driver

    grid = ["--preset", "double_gyre_coupled", "--dtype", "float32"]
    case = new_case("double_gyre_coupled",
                    "examples/double_gyre_coupled/input.params",
                    trun=DRIVER_DAYS / 365.0, **DRIVER_CADENCES)
    run_cli(["prepare", str(case), "--eddy-amp", "0.15"] + grid)
    cycles = DRIVER_DAYS * 86400 // 540
    qgstep.launches = 0
    log, (steps_s, events_s) = run_cli(["run", str(case), "--quiet"] + grid)
    launches = qgstep.launches
    print(f"  {log.strip().splitlines()[-1]}")
    if launches != cycles:
        raise AssertionError(f"qgstep launched {launches} times in {cycles} "
                             "cycles of the Driver")
    out = case / "outdata"
    files = sorted(p.name for p in out.iterdir())
    want = ["atast.nc", "atpa.nc", "avges.nc", "input_parameters.m",
            "lastday.nc", "monit.nc", "ocpo.nc", "ocsst.nc", "restart.nc"]
    print(f"  files: {' '.join(files)}")
    if files != want:
        raise AssertionError(f"the run wrote {files}, not {want}")
    vals, dims = monit_series(out / "monit.nc")
    names = (["time", "zo", "zom", "ocjpos", "za", "zam", "atstpos"]
             + monitor._OC_VECNL + monitor._OC_VECNI + monitor._OC_SCAL
             + monitor._AT_VECNL + monitor._AT_VECNI + monitor._AT_SCAL)
    records = DRIVER_DAYS * 4
    bad = [n for n, v in vals.items() if not np.isfinite(v).all()]
    short = [n for n, d in dims.items()
             if d and d[0] == "time" and len(vals[n]) != records]
    print(f"  monit.nc: {len(vals)} variables, {records} records each, "
          f"non-finite {bad or 'none'}")
    if sorted(vals) != sorted(names) or len(names) != 96 or bad or short:
        raise AssertionError(f"monit.nc: names {sorted(set(vals) ^ set(names))}"
                             f", non-finite {bad}, records {short}")
    print(f"  qgstep launches on this path: {launches} in {cycles} cycles")
    ms_cycle = steps_s * 1e3 / cycles
    print(f"  Driver {ms_cycle:.4f} ms/cycle (host clock, the card drained "
          f"at each chunk end) beside the bare runner's "
          f"{bare['cycle_ms']:.4f} ms/cycle in phase 7 (CUDA events); "
          f"{events_s:.4f} s in cadence events over {DRIVER_DAYS} days "
          f"[{card}]")

    straight = lastday(case)
    errs = resume_errors(grid, straight)
    worst = max(errs.values())
    print("  resume equivalence, 1 day + 1 day against 2 days: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bar {RESUME_TOL:g})")
    if not worst <= RESUME_TOL:
        raise AssertionError("the resumed run parts from the straight one")

    p = parse_input_params(str(case / "input.params"))
    p.name = str(case / "restart.nc")
    model = build_model(params_to_config(p, double_gyre_coupled(
        dtype="float32")))
    drv = Driver(model, p, str(case / "profile_out"), verbose=False)
    carry, _ = drv.initial_carry()
    nstr = model.cfg.nstr
    carry = drv.advance(carry, PROFILE_CYCLES * nstr)
    print(f"  -- profile of {PROFILE_CYCLES} cycles of the Driver between "
          f"cadence events:")
    counts = profile_counts(lambda: drv.advance(carry, PROFILE_CYCLES * nstr),
                            PROFILE_CYCLES, "cycle", card)
    print(f"  -- the bare runner from the same state (phase 7's loop):")
    run = make_coupled_runner(model)
    profile_counts(lambda: run(carry.oc, carry.at, PROFILE_CYCLES * nstr,
                               step0=carry.n), PROFILE_CYCLES, "cycle", card)
    if counts["d2h"] or counts["syncs"]:
        raise AssertionError("the Driver copies to the host or waits for the "
                             "card between cadence events")
    return dict(path="driver:double_gyre_coupled", launches=launches,
                cycles=cycles, ms_per_cycle=ms_cycle, events_s=events_s,
                resume_err=worst)


def profile_driver_channel(case, preset_cfg, card):
    """3 substeps of the Driver between cadence events and of the bare
    ocean-only runner from the same state, profiled (profile_counts)."""
    from qgcm_torch.io import read_mean_forcing
    from qgcm_torch.model import build_model
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.params import parse_input_params, params_to_config
    from qgcm_torch.run import Driver
    p = parse_input_params(str(case / "input.params"))
    model = build_model(params_to_config(p, preset_cfg.replace(
        dtype="float32")))
    drv = Driver(model, p, str(case / "profile_out"), verbose=False,
                 mean_forcing=read_mean_forcing(str(case / "avges.nc")))
    carry, _ = drv.initial_carry()
    nstr = model.cfg.nstr
    carry = drv.advance(carry, PROFILE_CYCLES * nstr)
    print(f"  -- profile of {PROFILE_CYCLES} substeps of the Driver between "
          f"cadence events:")
    counts = profile_counts(lambda: drv.advance(carry, PROFILE_CYCLES * nstr),
                            PROFILE_CYCLES, "substep", card)
    print("  -- the bare ocean-only runner from the same state:")
    run = make_ocean_only_runner(model)
    profile_counts(lambda: run(carry.oc, carry.ofor, PROFILE_CYCLES,
                               step0=carry.n // nstr),
                   PROFILE_CYCLES, "substep", card)
    if counts["d2h"] or counts["syncs"]:
        raise AssertionError("the Driver copies to the host or waits for the "
                             "card between cadence events")


def phase_driver_channel(card, bare):
    """The forced southern-ocean channel against its committed
    production record: prepare and run CHANNEL_TRUN years through the
    CLI in float32, check the launches and the duplicate column of
    lastday.nc, profile the Driver, run the same days in float64, and
    hold the float32 monit.nc against the record's first records with
    the float64 run as the second witness (check_monit_record)."""
    from qgcm_torch.config import southern_ocean_ocean_only
    from qgcm_torch.io.ncdf import read_var
    from qgcm_torch.ops.qgstep import qgstep
    cfg = southern_ocean_ocean_only()
    grid = ["--preset", "southern_ocean_ocean_only", "--dtype", "float32"]
    case = new_case("southern_ocean_forced",
                    f"{CHANNEL_CASE}/input.params")
    run_cli(["prepare", str(case), "--forcing", "channel"] + grid)
    substeps = CHANNEL_RECORDS * 160
    qgstep.launches = 0
    log, (steps_s, events_s) = run_cli(
        ["run", str(case), "--quiet", "--trun", repr(CHANNEL_TRUN)] + grid)
    launches = qgstep.launches
    print(f"  {log.strip().splitlines()[-1]}")
    print(f"  qgstep launches on this path: {launches} in {substeps} "
          f"substeps")
    if launches != substeps:
        raise AssertionError(f"qgstep launched {launches} times in "
                             f"{substeps} substeps of the Driver")
    ms_sub = steps_s * 1e3 / substeps
    print(f"  Driver {ms_sub:.4f} ms/substep (host clock) beside phase 9's "
          f"{bare['substep_ms']:.4f} ms/substep (CUDA events, bare runner); "
          f"{events_s:.4f} s in cadence events [{card}]")
    po = read_var(str(case / "outdata" / "lastday.nc"), "po")
    if not np.array_equal(po[..., -1], po[..., 0]):
        raise AssertionError("lastday.nc lost the channel's duplicate column")
    print("  lastday.nc po[..., -1] == po[..., 0] bit for bit")
    profile_driver_channel(case, cfg, card)

    # the second witness: the same days in float64 on the card
    case64 = new_case("southern_ocean_forced_f64",
                      f"{CHANNEL_CASE}/input.params")
    grid64 = ["--preset", "southern_ocean_ocean_only", "--dtype", "float64"]
    run_cli(["prepare", str(case64), "--forcing", "channel"] + grid64)
    log64, _ = run_cli(["run", str(case64), "--quiet", "--trun",
                        repr(CHANNEL_TRUN)] + grid64)
    print(f"  float64: {log64.strip().splitlines()[-1]}")
    check_monit_record(case / "outdata" / "monit.nc",
                       case64 / "outdata" / "monit.nc")
    return dict(path="driver:southern_ocean_forced_1yr", launches=launches,
                substeps=substeps, ms_per_substep=ms_sub, events_s=events_s)


def check_monit_record(path32, path64):
    """Hold the float32 run's monit.nc (path32) against the first
    CHANNEL_RECORDS records of the committed production record, with the
    float64 run's (path64) as the second witness (WITNESS_FACTOR,
    TENDENCIES); every error is over the record's largest magnitude of
    the series. Prints all three distances of every series and raises
    on a miss."""
    from pathlib import Path
    got, _ = monit_series(path32)
    f64, _ = monit_series(path64)
    ref, dims = monit_series(Path(__file__).resolve().parent / CHANNEL_CASE
                             / "outdata" / "monit.nc")
    n = CHANNEL_RECORDS
    for run in (got, f64):
        if sorted(run) != sorted(ref) or len(run["time"]) != n:
            raise AssertionError(f"monit.nc: {sorted(set(run) ^ set(ref))}, "
                                 f"{len(run['time'])} records")
    fails, rows = [], []
    for name in sorted(ref):
        a, b, c = (np.asarray(v[name][:n] if dims[name][:1] == ("time",)
                              else v[name], np.float64)
                   for v in (got, ref, f64))
        scale = float(np.abs(b).max())

        def dist(x, y):
            return float(np.abs(x - y).max() / scale) if scale else float(
                np.abs(x - y).max())
        err, e64, r64 = dist(a, b), dist(a, c), dist(b, c)
        if name in ("emfroc", "ermaso"):
            # the document's own bar: the constraints close below 1e-3
            err = float(np.abs(a).max())
            held = err <= MONITOR_TOL
        elif name in TENDENCIES:
            held = e64 <= TENDENCY_TOL
        else:
            held = (name in NOT_HELD or err <= MONITOR_TOL
                    or e64 <= WITNESS_FACTOR * r64)
        rows.append(f"{name} {err:.2e} {e64:.2e} {r64:.2e}"
                    + ("" if held else " MISSED"))
        if name in NOT_HELD:
            print(f"  {name} (not held: {NOT_HELD[name]}), day by day:")
            for label, x in (("card f32", a), ("record", b), ("card f64", c)):
                print(f"    {label:8s} " + " ".join(
                    f"{v:.4g}" for v in x.ravel()))
        if not held:
            fails.append(name)
    print(f"  monit.nc, first {n} days, / max|record|: card f32 - record, "
          f"card f32 - card f64, record - card f64 (held: the first "
          f"within {MONITOR_TOL:g} or the second within "
          f"{WITNESS_FACTOR:g}x the third; {', '.join(TENDENCIES)}: the "
          f"second within {TENDENCY_TOL:g}):")
    for i in range(0, len(rows), 3):
        print("    " + "; ".join(rows[i:i + 3]))
    if fails:
        raise AssertionError(f"monit.nc misses the committed record in "
                             f"{fails}")


# ----------------------------------------------------------------------
# Phases 12-13: the kernel's shard modes, and the decomposed ocean-only
# runner in ranks that share the one card
# ----------------------------------------------------------------------

# ranks of the phase-13 runs: processes on this host; with fewer cards
# than ranks they share card 0 over gloo (NCCL refuses two ranks on one
# card), each collective's CUDA tensors staged through host memory, and
# with a card each they take NCCL (mesh_backend)
MESH_RANKS = 4
MESH_STEPS = 20         # substeps of the overlap runs, 2 of them warm-up
MESH_WARMUP = 2
MESH_SHORT_STEPS = 2    # substeps of the deep and staged runs
# where the ranks meet and leave their results (listed in .gitignore)
MESH_WORKDIR = "build/qgcm_torch/mesh"
# the float32 mesh runs against the single-device runner from the same
# state, each field's max|difference| over its max: the sums of the
# mixed layer and the inversion are taken in another order, and float32
# roundoff of ~1e-7 relative grows over 20 leapfrog substeps
MESH_F32_TOL = 1e-4
# the float64 golden box on 4 ranks against its single-device run
# (tests/test_sharding.py:41-58)
MESH_F64_TOL = 1e-11
GOLDEN_STEPS = 50


def window_bound(nl, rows, cols, win_rows, win_cols, dtype, sponge):
    """(bound_ms, bound_by) of one window launch: pom, po and qo read
    over the window once, qom, wek, ent (and r_spl) over the core once,
    the core written once; the operations are the full-field step's at
    the core's points."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * (3 * nl * win_rows * win_cols + 2 * nl * rows * cols
                     + (3 if sponge else 2) * rows * cols)
    flop = (nl * rows * cols * (FLOP_PER_POINT
                                + (SPONGE_FLOP_PER_POINT if sponge else 0))
            + FLOP_PER_COLUMN * rows * cols)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_args(args, r0, rows, c0=None, cols=None):
    """The window-mode arguments of one block of the full-field `args`:
    pom, po, qo over global rows [r0-3, r0+rows+3) (and, with c0, the x_ext
    window's columns [c0-3, c0+cols+3)), the rest over the block; zero
    outside the grid. Returns (args, keywords)."""
    import torch.nn.functional as F
    from qgcm_torch.ops.qgstep import HALO
    pom, po, qo, qom, wek, ent, rspl, consts, ah2, ah4 = args
    ny, nx = pom.shape[-2:]
    xext = c0 is not None
    if not xext:
        c0, cols = 0, nx
    h, w = HALO, (HALO if xext else 0)

    def window(f):      # global (r, c) sits at [r + h, c + w] of `big`
        big = F.pad(f, (w, w + cols, h, h + rows))
        return big[..., r0:r0 + rows + 2 * h, c0:c0 + cols + 2 * w]

    def core(f):
        big = F.pad(f, (0, cols, 0, rows))
        return big[..., r0:r0 + rows, c0:c0 + cols]

    wargs = ([window(f).contiguous() for f in (pom, po, qo)]
             + [None if f is None else core(f).contiguous()
                for f in (qom, wek, ent, rspl)])
    kw = dict(row0=r0 - HALO, ny_total=ny)
    if xext:
        kw.update(col0=c0, nx_total=nx, x_ext=True)
    return (*wargs, consts, ah2, ah4), kw


def check_windows(label, args, full, cyclic, sponge, blocks, tol):
    """Each block's window launch against the full-field kernel's rows
    (bit for bit, padding zero) and against the window's plain version
    on the card. Returns (windows, worst error against the plain version
    over the full field's max|q|, worst max|kernel - plain|, worst
    max|window - full field|)."""
    from qgcm_torch.ops.qgstep import qgstep, window_reference
    ny, nx = full.shape[-2:]
    scale = full.abs().max().item()
    worst = worst_abs = worst_full = 0.0
    for r0, rows, c0, cols in blocks:
        wargs, kw = window_args(args, r0, rows, c0, cols)
        got = qgstep(*wargs, cyclic=cyclic, sponge=sponge, **kw)
        cc0, cn = (0, nx) if c0 is None else (c0, cols)
        tr, tc = min(rows, ny - r0), min(cn, nx - cc0)
        want = full[:, r0:r0 + tr, cc0:cc0 + tc]
        d = (got[:, :tr, :tc] - want).abs().amax().item() if want.numel() \
            else 0.0
        worst_full = max(worst_full, d)
        if not torch.equal(got[:, :tr, :tc], want):
            raise AssertionError(f"{label}: window rows {r0}+{rows} cols "
                                 f"{c0}+{cols} differ from the full-field "
                                 f"kernel by {d:.3e}")
        if got[:, tr:].count_nonzero() or got[..., tc:].count_nonzero():
            raise AssertionError(f"{label}: padding is not zero")
        ref = window_reference(*wargs, cyclic=cyclic, sponge=sponge, **kw)
        err = (got - ref).abs().max().item()
        worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
        if not err <= tol * scale:
            raise AssertionError(f"{label}: window kernel vs plain "
                                 f"{err / scale:.3e} max|q| (bar {tol:g})")
    return len(blocks), worst, worst_abs, worst_full


def row_blocks(ny, my):
    """Ceil blocks of ny rows over my ranks, and the 9-row bands at each
    block's edges: (r0, rows, None, None)."""
    by = -(-ny // my)
    out = [(i * by, by, None, None) for i in range(my)]
    out += [(i * by, 3, None, None) for i in range(my)]
    out += [(i * by + by - 3, 3, None, None) for i in range(my)]
    return out, by


def phase_shard_modes(card):
    """The kernel's row-window and x_ext modes at full width on the card,
    against its full-field mode (bit for bit) and its plain version, and
    timed alone beside their bounds. Returns the two modes' entries of
    the kernels line."""
    from qgcm_torch.config import (double_gyre_ocean_only, k247_default,
                                   southern_ocean_ocean_only)
    from qgcm_torch.grids import build_grids
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.ops.qgstep import qgstep
    entries = {}
    # worst (relative, absolute) error against the plain version by mode
    # and type
    err = {(m, t): (0.0, 0.0, 0.0) for m in ("rows", "x_ext")
           for t in (torch.float32, torch.float64)}

    def note(mode, dtype, *errs):
        err[(mode, dtype)] = tuple(map(max, err[(mode, dtype)], errs))

    for seed, (preset, dtype, cyclic, my, splits2d) in enumerate((
            (double_gyre_ocean_only, torch.float32, False, 4, ((2, 2), (3, 2))),
            (southern_ocean_ocean_only, torch.float32, True, 4, ()),
            (k247_default, torch.float32, True, 4, ()),
            (double_gyre_ocean_only, torch.float64, False, 3, ((2, 2),)))):
        cfg = preset()
        sponge = cfg.sponge.enabled
        nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
        args = random_args(nl, ny, nx, dtype, cyclic, sponge, 2000 + seed,
                           consts=qgstep_consts(cfg, build_grids(cfg)),
                           ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
        full = qgstep(*args, cyclic=cyclic, sponge=sponge)
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        label = (f"{preset.__name__} {nl}x{ny}x{nx} {str(dtype)[6:]}"
                 f"{' cyclic' if cyclic else ''}{' sponge' if sponge else ''}")
        blocks, by = row_blocks(ny, my)
        # and the whole grid as one rank's window, where the march fills
        # the card and keeps the window
        blocks.append((0, ny, None, None))
        n, worst, worst_abs, worst_full = check_windows(
            label, args, full, cyclic, sponge, blocks, tol)
        note("rows", dtype, worst, worst_abs, worst_full)
        designs = {b[1]: window_design(nl, b[1], nx, dtype) for b in blocks}
        print(f"  rows {label}: {n} windows over {my} blocks of {by} rows "
              f"(the last {ny - (my - 1) * by} true), their 9-row bands "
              f"and the whole grid bit-equal to the full-field kernel; vs "
              f"plain {worst:.3e} max|q| (bar {tol:g}); designs by rows: "
              + "; ".join(f"{r}: {d}" for r, d in sorted(designs.items())))
        for py, px in splits2d:
            by2, bx2 = -(-ny // py), -(-nx // px)
            blocks2 = [(iy * by2, by2, ix * bx2, bx2)
                       for iy in range(py) for ix in range(px)]
            n, worst, worst_abs, worst_full = check_windows(
                f"{label} x_ext {py}x{px}", args, full, False, sponge,
                blocks2, tol)
            note("x_ext", dtype, worst, worst_abs, worst_full)
            print(f"  x_ext {label}, {py}x{px} split: {n} windows of "
                  f"{by2}x{bx2} bit-equal to the full-field kernel; vs "
                  f"plain {worst:.3e} max|q| (bar {tol:g}); "
                  f"{window_design(nl, by2, bx2, dtype)}")
        del args, full
        torch.cuda.empty_cache()

    # each mode alone at the shapes the decomposed paths give it
    times = window_timings(card)
    for key in ("rows", "x_ext"):
        t = times[key]
        entries[key] = dict(
            name=f"qgstep[{key}]", route="cuda",
            source="qgcm_torch/csrc/qgstep.cu",
            replaces="qgcm_tpu/ops/pallas_qg.py:277",
            mode=("row window (row0/ny_total)" if key == "rows"
                  else "x_ext/col0/nx_total"),
            design=t["design"], shape=t["shape"], ms=t["hot"],
            cold_ms=t["cold"], ms_method="cuda_graph_replay",
            plain_ms=t["plain"], bound_ms=t["bound"], bound_by=t["by"],
            library_ms=None, share_of_bound=t["bound"] / t["hot"],
            max_abs_err=err[(key, torch.float32)][1],
            rel_err_f32=err[(key, torch.float32)][0],
            rel_err_f64=err[(key, torch.float64)][0],
            max_abs_err_vs_full_field=max(err[(key, torch.float32)][2],
                                          err[(key, torch.float64)][2]),
            others={k: {f: v[f] for f in ("design", "shape", "hot", "cold",
                                          "bound")}
                    for k, v in times.items() if k.startswith(key + " ")})
    torch.cuda.empty_cache()
    return entries


# the window launches timed alone (phase 12, and --windows): label, the
# configuration whose constants they take, output rows and columns,
# x_ext, type, and optionally the window's first global output row and
# column (else 241 and 481). A rank's row window of the 961^2 box on 4
# ranks, the 9-row bands of the overlap schedule (3 output rows), a
# rank's row window of NAtl 1 km, a 2x2 split's x_ext block, the row
# window in float64; and the 2-D runner's x_ext bands of the 961^2 box:
# on 2x2 rank (1, 1)'s south row band (9 x 487 -> 3 x 481) and west
# column band (487 x 9 -> 481 x 3), on 1x4 rank 1's interior block
# (967 x 247 -> 961 x 241).
WINDOW_SHAPES = (
    ("rows", "double_gyre_ocean_only", 241, 961, False, torch.float32),
    ("rows band", "double_gyre_ocean_only", 3, 961, False, torch.float32),
    ("rows NAtl", "natl_1km", 1201, 4801, False, torch.float32),
    ("x_ext", "double_gyre_ocean_only", 481, 481, True, torch.float32),
    ("rows float64", "double_gyre_ocean_only", 241, 961, False,
     torch.float64),
    ("x_ext row band 2x2", "double_gyre_ocean_only", 3, 481, True,
     torch.float32, 481, 481),
    ("x_ext column band 2x2", "double_gyre_ocean_only", 481, 3, True,
     torch.float32, 481, 481),
    ("x_ext 1x4", "double_gyre_ocean_only", 961, 241, True, torch.float32,
     0, 241))


def window_design(nl, rows, cols, dtype) -> str:
    """The design and geometry the wrapper gives a window launch. Reads a
    checkout whose wrapper predates the window tile (no window_geometry)
    as the march."""
    from qgcm_torch.ops import qgstep as mod
    dev = torch.device("cuda")
    resident = mod.resident_blocks(dev, dtype, False)
    if hasattr(mod, "window_geometry"):
        g = mod.window_geometry(nl, rows, cols, resident,
                                mod.resident_blocks(dev, dtype, False,
                                                    tiled=True))
        tile_resident = mod.resident_blocks(dev, dtype, False, tiled=True)
    else:
        g, tile_resident = mod.launch_geometry(nl, rows, cols, resident), 0
    tiled = getattr(g, "tiled", False)
    return (f"{'tile' if tiled else 'march'} {g.strip_h}x{g.strip_w}, "
            f"{nl * g.strips_x * g.strips_y} blocks "
            f"({tile_resident if tiled else resident} resident)")


def window_timings(card, compare=False) -> dict:
    """Each of WINDOW_SHAPES alone on seeded random fields: hot and cold
    L2 (CUDA-graph replays), the bound, the design, and the plain version
    (CUDA events). With `compare` (compare_windows), not the plain
    version but the full-field launch at 3x961^2 float32 and the member
    mode's at 8x3x961^2 (the wind shared), to hold them against another
    checkout's. Uses only qgcm_torch's public API, so that it runs
    against any checkout of the port. Returns {label: numbers}."""
    from qgcm_torch import config
    from qgcm_torch.grids import build_grids
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.ops.qgstep import qgstep, window_reference
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for label, preset, rows, cols, xext, dtype, *at in WINDOW_SHAPES:
        r0, c0 = at or (241, 481)
        cfg = getattr(config, preset)()
        nl = cfg.nlo
        wc = cols + 6 if xext else cols

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device="cuda",
                               dtype=dtype)

        wins = [rnd(nl, rows + 6, wc) for _ in range(3)]
        wargs = (*wins, rnd(nl, rows, cols), rnd(rows, cols),
                 rnd(rows, cols), None,
                 qgstep_consts(cfg, build_grids(cfg)), cfg.ocean.ah2oc,
                 cfg.ocean.ah4oc)
        kw = dict(row0=r0 - 3, ny_total=cfg.nypo)
        if xext:
            kw.update(col0=c0, nx_total=cfg.nxpo, x_ext=True)

        def run():
            qgstep(*wargs, cyclic=False, sponge=False, **kw)

        hot, cold = kernel_ms(run, 50)
        plain_ms = None if compare else cuda_ms(lambda: window_reference(
            *wargs, cyclic=False, sponge=False, **kw), 5)
        bound, by = window_bound(nl, rows, cols, rows + 6, wc, dtype, False)
        design = window_design(nl, rows, cols, dtype)
        out[label] = dict(hot=hot, cold=cold, plain=plain_ms, bound=bound,
                          by=by, design=design, shape=[nl, rows + 6, wc])
        print(f"  {label} window ({nl}, {rows + 6}, {wc}) -> ({nl}, {rows}, "
              f"{cols}) {str(dtype)[6:]}, {design}: kernel {hot:.4f} ms "
              f"hot L2, {cold:.4f} ms cold L2; "
              + ("" if compare else f"plain {plain_ms:.4f} ms; ")
              + f"bound {bound:.4f} ms ({by}); share of bound "
              f"{bound / hot:.3f} hot, {bound / cold:.3f} cold [{card}]")
        del wins, wargs
    if compare:
        cfg = config.double_gyre_ocean_only()
        nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
        rest = (qgstep_consts(cfg, build_grids(cfg)), cfg.ocean.ah2oc,
                cfg.ocean.ah4oc)
        for label, m in (("full", 1), ("members", ENSEMBLE_MEMBERS)):
            lead = () if m == 1 else (m,)
            fields = [torch.randn(*lead, nl, ny, nx, generator=g,
                                  device="cuda") for _ in range(4)]
            wek = torch.randn(ny, nx, generator=g, device="cuda")
            ent = torch.randn(*lead, ny, nx, generator=g, device="cuda")
            hot, cold = kernel_ms(lambda: qgstep(
                *fields, wek, ent, None, *rest, cyclic=False,
                sponge=False), 50 if m == 1 else 20)
            bound, by = kernel_bound(nl, ny, nx, torch.float32, False,
                                     members=m, shared_planes=int(m > 1))
            out[label] = dict(hot=hot, cold=cold, plain=None, bound=bound,
                              by=by, design="march",
                              shape=[*lead, nl, ny, nx])
            print(f"  {label} {m}x{nl}x{ny}x{nx} float32: kernel {hot:.4f} "
                  f"ms hot L2, {cold:.4f} ms cold L2; bound {bound:.4f} ms "
                  f"[{card}]")
            del fields
    torch.cuda.empty_cache()
    return out


def run_in_checkouts(checkouts, child, pattern, what):
    """Run the Python code `child` in a process of its own in each
    checkout in turn (its qgcm_torch imported from there) and match
    `pattern` in its output. Returns [(checkout, match)], or None after
    printing the output of the first run that failed."""
    runs = []
    for where in checkouts:
        run = subprocess.run([sys.executable, "-c", child], cwd=where,
                             capture_output=True, text=True, timeout=900)
        got = re.search(pattern, run.stdout, re.S | re.M)
        if run.returncode or not got:
            print(run.stdout + run.stderr, file=sys.stderr)
            print(f"chip_smoke: {what} of {where} failed", file=sys.stderr)
            return None
        runs.append((where, got))
    return runs


def compare_windows(checkouts) -> int:
    """window_timings(compare=True) of each checkout in turn, this file's
    timing code against that checkout's qgcm_torch (for instance a
    parent commit unpacked under build/, and this one, in the order
    parent, this, this, parent). Prints each launch's hot and cold ms by
    checkout, side by side."""
    from pathlib import Path
    child = ("import importlib.util, json, sys; "
             "spec = importlib.util.spec_from_file_location('smoke', "
             f"{str(Path(__file__).resolve())!r}); "
             "m = importlib.util.module_from_spec(spec); "
             "spec.loader.exec_module(m); "
             "t = m.window_timings(m.card_line(), compare=True); "
             "print('WINDOW_TIMES ' + json.dumps(t))")
    card = card_line()
    got = run_in_checkouts(checkouts, child, r"^WINDOW_TIMES ([^\n]*)$",
                           "the window timings")
    if got is None:
        return 1
    runs = [(where, json.loads(m.group(1))) for where, m in got]
    print(f"window and full-field launches by checkout, in the order run, "
          f"ms hot / cold L2 (CUDA-graph replays) [{card}]:")
    for label in runs[0][1]:
        print(f"  {label}, bound {runs[0][1][label]['bound']:.4f} ms:")
        for where, t in runs:
            print(f"    {where}: {t[label]['hot']:.4f} / {t[label]['cold']:.4f}"
                  f" ms, share {t[label]['bound'] / t[label]['hot']:.3f}; "
                  f"{t[label]['design']}")
    return 0


def golden_cfg(dtype="float64"):
    """The ocean box of tests/test_golden.py:27-36 (phases 3 and 13)."""
    from qgcm_torch.config import ModelConfig, OceanConfig
    return ModelConfig(nxta=24, nyta=24, nxaooc=16, nyaooc=8, ndxr=2,
                       fnot=9.37456e-5, beta=1.7536e-11, dta=200.0, nstr=3,
                       ocean=OceanConfig(nlo=3, dxo=25.0e3, delek=2.0,
                                         hoc=(350.0, 750.0, 2900.0),
                                         gpoc=(0.015, 0.0075),
                                         tabsoc=(287.0, 282.0, 276.0),
                                         ah2oc=(0.0, 0.0, 0.0),
                                         ah4oc=(2e12, 2e12, 2e12)),
                       ocean_only=True, dtype=dtype)


def mesh_case(task, dtype):
    """(cfg, model, state, forcing) of a phase-13 runner task in `dtype`
    on the card: an eddy under the double-gyre wind in the box; in the
    channel an eddy on the radiative balance, under the channel wind
    ('wind', which drives the entrainment, its wall line integrals and
    the momentum constraints) or at rest ('rest')."""
    from qgcm_torch.generators import (channel_windstress,
                                       double_gyre_windstress,
                                       eddy_pressure, zero_forcing)
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    cfg = task["preset"](dtype=dtype)
    model = build_model(cfg, "cuda")
    if task["state"] == "box":
        st = init_ocean_state(model, po=eddy_pressure(
            cfg, ssh_amp=task.get("ssh_amp", 0.15)))
        mean = double_gyre_windstress(cfg, model.grids, **task.get("wind",
                                                                   {}))
    else:
        st = init_ocean_state(model, init="rbal",
                              po=eddy_pressure(cfg, ssh_amp=0.15))
        mean = (channel_windstress(cfg, model.grids)
                if task["state"] == "wind" else zero_forcing(cfg))
    return cfg, model, st, ocean_forcing_from_mean(model, *mean)


def field_errors(ref, got, fields):
    """max|got - ref| / max|ref| of each named field of two states."""
    return {name: ((getattr(ref, name) - getattr(got, name).to(
        getattr(ref, name).dtype)).abs().max()
        / getattr(ref, name).abs().max().clamp_min(1e-300)).item()
        for name in fields}


def _mesh_rank(tasks):
    """What each rank of phase 13 runs: the tasks in order, each over the
    world group. Rank 0 also runs each task's single-device reference and
    compares. Returns per task: the rank's launches by mode, collectives
    and staged bytes per substep and host ms per substep; rank 0 adds
    the errors."""
    import torch.distributed as dist
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from qgcm_torch.parallel.halo import qgstep_halo
    from qgcm_torch.parallel.mesh import (Mesh, gather, gather_tree,
                                          make_mesh, shard, shard_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()          # NCCL sets up its communicator here
    out = []
    for task in tasks:
        kind = task["kind"]
        res = dict(task=task["label"])
        if kind == "halo2d":
            from qgcm_torch.config import double_gyre_ocean_only
            from qgcm_torch.grids import build_grids
            cfg = double_gyre_ocean_only()
            nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
            args = random_args(nl, ny, nx, torch.float32, False, False, 3000,
                               consts=qgstep_consts(cfg, build_grids(cfg)),
                               ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
            mesh = Mesh((2, 2), grid=(ny, nx))
            blocks = [None if a is None else shard(a, mesh)
                      for a in args[:7]]
            full = qgstep(*args, cyclic=False, sponge=False) if rank == 0 \
                else None
            for v in task["variants"]:
                reset_launches()
                mesh.counts.clear()
                q = qgstep_halo(*blocks, *args[7:], cyclic=False,
                                sponge=False, mesh=mesh, variant=v)
                launches = dict(qgstep.mode_launches)
                q = gather(q, mesh, site="check")
                res[v] = dict(launches=launches, counts=dict(mesh.counts))
                if rank == 0:
                    res[v]["bit_equal"] = torch.equal(q, full)
                    res[v]["max_diff"] = (q - full).abs().max().item()
            out.append(res)
            continue
        cfg, model, st, f = mesh_case(task, task["dtype"])
        mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
        fb = shard_tree(f, mesh)
        for variant, steps, warm in task["runs"]:
            run = make_ocean_only_runner(model, mesh=mesh,
                                         halo_variant=variant,
                                         spectral_variant="a2a")
            stb = run(shard_tree(st, mesh), fb, warm)
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            mesh.counts.clear()
            mesh.staged_bytes = 0
            t0 = time.perf_counter()
            stb = run(stb, fb, steps - warm, step0=warm)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / (steps - warm)
            n = steps - warm
            r = dict(launches=dict(qgstep.mode_launches),
                     launches_per_substep={k: v / n for k, v in
                                           qgstep.mode_launches.items()},
                     counts={k: v / n for k, v in mesh.counts.items()},
                     staged_mb=mesh.staged_bytes / n / 1e6, host_ms=host_ms)
            full = gather_tree(stb, mesh)
            if rank == 0:
                # every schedule against the single-device runner, whose
                # vorticity step is the kernel ('staged' runs the plain
                # stages and launches none)
                ref = make_ocean_only_runner(model)(st, f, steps)
                r["errors"] = field_errors(ref, full, task["fields"])
                r["max_abs"] = {name: getattr(ref, name).abs().max().item()
                                for name in task["fields"]}
                r["finite"] = all(bool(torch.isfinite(t).all())
                                  for t in full)
                if cfg.cyclic_ocean:
                    r["duplicate_column"] = torch.equal(full.po[..., -1],
                                                        full.po[..., 0])
                if task.get("witness32"):
                    # the float32 single-device runner from the same
                    # state, against this float64 one
                    _, m32, st32, f32 = mesh_case(task, "float32")
                    r["errors_f32_runner"] = field_errors(
                        ref, make_ocean_only_runner(m32)(st32, f32, steps),
                        task["fields"])
                    del m32, st32, f32
                del ref
            res[variant] = r
            del full
        out.append(res)
        del model, st, f, fb
        torch.cuda.empty_cache()
    return out


def mesh_backend():
    """(backend, label) of phase 13's ranks: NCCL with a card per rank
    where this host has MESH_RANKS cards, else gloo with every rank on
    card 0."""
    if torch.cuda.device_count() >= MESH_RANKS:
        return "nccl", f"{MESH_RANKS} ranks on {MESH_RANKS} cards over NCCL"
    return "gloo", (f"{MESH_RANKS} ranks sharing one card through the host "
                    "over gloo, not NVLink")


def phase_oml_fork(card):
    """What the main path would pay if the single-device substep were the
    row-block substep on one block (a one-rank mesh, no process group):
    the kernel launches (profile_counts) and the host's ms (CUDA events
    around eager calls: the host sets this step's pace) of the mixed
    layer alone and of the whole substep, at the main path's double gyre
    in float32. Raises if the one-block mixed layer's SST and entrainment
    are not the single-device ones within MESH_F32_TOL."""
    from qgcm_torch.config import double_gyre_ocean_only
    from qgcm_torch.models import ocean
    from qgcm_torch.parallel.mesh import Mesh, shard_tree
    task = dict(preset=double_gyre_ocean_only, state="box")
    cfg, model, st, f = mesh_case(task, "float32")
    mesh = Mesh((1, 1), grid=(cfg.nypo, cfg.nxpo))
    sb, fb = shard_tree(st, mesh), shard_tree(f, mesh)
    bm = ocean.block_model(model, mesh)
    rows = ocean._Rows(mesh, cfg, model.device)
    one = ocean._oml(model, st, f)
    blk = ocean._oml_rows(bm, rows, sb, fb)
    for i, name in ((0, "sst"), (2, "entoc")):
        a, b = one[i], blk[i][:one[i].shape[0]]
        err = ((a - b).abs().max() / a.abs().max()).item()
        print(f"  one-block mixed layer vs the single-device one: {name} "
              f"{err:.3e} of its max (bar {MESH_F32_TOL:g})")
        if not err <= MESH_F32_TOL:
            raise AssertionError("the one-block mixed layer is not the "
                                 "single-device one")
    step, step_rows = (ocean.make_ocean_step(model),
                       ocean.make_ocean_step(model, halo=(mesh, "deep")))
    for label, fn in (
            ("mixed layer, single-device _oml", lambda: ocean._oml(
                model, st, f)),
            ("mixed layer, _oml_rows on one block", lambda: ocean._oml_rows(
                bm, rows, sb, fb)),
            ("substep, single-device", lambda: step(st, f)),
            ("substep, row-block on one block ('deep')",
             lambda: step_rows(sb, fb))):
        print(f"  {label}: host {cuda_ms(fn, 20):.4f} ms a call [{card}]")
        profile_counts(lambda: [fn() for _ in range(5)], 5, "call", card)
    del model, st, f, sb, fb, bm
    torch.cuda.empty_cache()


def phase_mesh(card, workdir):
    """The decomposed ocean-only path in MESH_RANKS ranks (mesh_backend):
    qgstep_halo on a 2x2 box mesh; the float64 golden box on 4 rows; the
    double gyre and the wind-driven southern-ocean channel at full width
    in float32, 'overlap' for MESH_STEPS substeps and 'deep' and 'staged'
    for MESH_SHORT_STEPS, each held against the single-device runner
    from the same state; and, printed and not held, the channel at rest
    in float32 and float64 with the float32 single-device runner against
    the float64 one (the float64 witness of the roundoff-sized momentum
    constraints there). Returns (the kernels line's launch counts by
    mode on this path, the paths' entries)."""
    import shutil
    from pathlib import Path
    from qgcm_torch.config import (double_gyre_ocean_only,
                                   southern_ocean_ocean_only)
    from qgcm_torch.parallel.launch import spawn_ranks

    box_fields = ("po", "qo", "sst", "dpioc")
    ch_fields = box_fields + ("ocncs", "ocncn")
    short = [("deep", MESH_SHORT_STEPS, 1), ("staged", MESH_SHORT_STEPS, 1)]
    witness = dict(kind="runner", preset=southern_ocean_ocean_only,
                   state="rest", runs=[("staged", MESH_SHORT_STEPS, 1)],
                   fields=ch_fields, tol=None)
    tasks = [
        dict(kind="halo2d", label="qgstep_halo 2x2 box 3x961^2 float32",
             variants=("deep", "overlap")),
        # its 5-row blocks are too thin for 'overlap' (6 rows), which
        # qgstep_halo would take as 'deep'
        dict(kind="runner", label="golden box float64", preset=golden_cfg,
             dtype="float64", state="box", ssh_amp=0.1,
             wind=dict(tau0=2e-5),
             runs=[("deep", GOLDEN_STEPS, MESH_WARMUP)],
             fields=box_fields, tol=MESH_F64_TOL),
        dict(kind="runner", label="double_gyre_ocean_only float32",
             preset=double_gyre_ocean_only, dtype="float32", state="box",
             runs=[("overlap", MESH_STEPS, MESH_WARMUP)] + short,
             fields=box_fields, tol=MESH_F32_TOL),
        dict(kind="runner", label="southern_ocean_ocean_only wind float32",
             preset=southern_ocean_ocean_only, dtype="float32",
             state="wind",
             runs=[("overlap", MESH_STEPS, MESH_WARMUP)] + short,
             fields=ch_fields, tol=MESH_F32_TOL),
        dict(witness, label="southern_ocean_ocean_only at rest float32",
             dtype="float32"),
        dict(witness, label="southern_ocean_ocean_only at rest float64",
             dtype="float64", witness32=True)]
    work = Path(__file__).resolve().parent / workdir
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    backend, label = mesh_backend()
    results = spawn_ranks(_mesh_rank, MESH_RANKS, tasks, backend=backend,
                          workdir=work, timeout=600)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s with start-up "
          f"[{card}]")
    totals = {"rows": 0, "x_ext": 0, "full": 0}
    paths = []

    def fmt(errors):
        return ", ".join(f"{k} {v:.3e}" for k, v in errors.items())

    for i, task in enumerate(tasks):
        r0 = results[0][i]
        for variant in [k for k in r0 if k != "task"]:
            per_rank = [res[i][variant] for res in results]
            launches = {m: sum(pr["launches"][m] for pr in per_rank)
                        for m in totals}
            for m in totals:
                totals[m] += launches[m]
            if task["kind"] == "halo2d":
                ok = r0[variant]["bit_equal"]
                print(f"  {task['label']}, {variant}: bit-equal to the "
                      f"full-field kernel: {ok} (max diff "
                      f"{r0[variant]['max_diff']:.3e}); launches by mode "
                      f"(all ranks) {launches}; collectives of rank 0 "
                      f"{r0[variant]['counts']}")
                if not ok:
                    raise AssertionError(f"{task['label']} {variant} is not "
                                         "the single-device kernel step")
                paths.append(dict(path=f"{task['label']} {variant}",
                                  launches=launches,
                                  max_abs_err=r0[variant]["max_diff"]))
                continue
            rv = r0[variant]
            worst = max(rv["errors"].values())
            held = task["tol"] is not None
            bar = (f"bar {task['tol']:g}" if held
                   else "a witness, not held")
            print(f"  {task['label']}, {variant}, {MESH_RANKS} ranks: "
                  f"errors vs the single-device runner (max|diff|/max) "
                  f"{fmt(rv['errors'])} ({bar}); finite {rv['finite']}"
                  + (f"; duplicate column {rv['duplicate_column']}"
                     if "duplicate_column" in rv else ""))
            if "errors_f32_runner" in rv:
                print("    the float32 single-device runner vs this float64 "
                      f"one: {fmt(rv['errors_f32_runner'])}")
            print("    max|field| of the reference: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in
                              rv["max_abs"].items()))
            print(f"    per rank per substep: qgstep launches "
                  f"{rv['launches_per_substep']}; collectives "
                  f"{rv['counts']}; {rv['staged_mb']:.3f} MB staged through "
                  f"the host; host {rv['host_ms']:.2f} ms/substep (rank 0; "
                  f"max over ranks {max(p['host_ms'] for p in per_rank):.2f}) "
                  f"-- {label} [{card}]")
            if not (rv["finite"] and rv.get("duplicate_column", True)
                    and (not held or worst <= task["tol"])):
                raise AssertionError(f"{task['label']} {variant} misses the "
                                     "single-device runner")
            # 'overlap' is one interior and two band launches, 'deep'
            # one, 'staged' none
            want = {"overlap": 3, "deep": 1, "staged": 0}[variant]
            if any(p["launches_per_substep"]["rows"] != want
                   for p in per_rank):
                raise AssertionError(f"{task['label']} {variant}: expected "
                                     f"{want} row-window launches per rank "
                                     "per substep")
            paths.append(dict(path=f"{task['label']} {variant}",
                              launches=launches, rel_err=worst))
    if totals["full"]:
        raise AssertionError("a decomposed run launched the full-field mode")
    return totals, paths


# ----------------------------------------------------------------------
# Phases 14-17: the kernel's member mode, ensembles, adjoints and the
# commands that run them
# ----------------------------------------------------------------------

# members of the timed member-mode launch and of the full-width ensemble
ENSEMBLE_MEMBERS = 8
ENSEMBLE_STEPS = 50
ENSEMBLE_AMP = 1e-3
# the float32 ensemble's members against their single-trajectory runs,
# each field's max|difference| over its max: the batched operators of
# the mixed layer and the inversion sum in another order, and float32
# roundoff of ~1e-7 relative grows over the leapfrog substeps (phase
# 13's bar for the same reason)
ENSEMBLE_F32_TOL = 1e-4
# the float64 golden box's members against their own single runs: the
# same arithmetic in another order, at float64 roundoff
ENSEMBLE_F64_TOL = 1e-12
GOLDEN_MEMBERS = 3
COUPLED_MEMBERS = 4
COUPLED_ENSEMBLE_CYCLES = 5
# device launches per substep of the ensemble over the single runner's
# above which PERF.md names the operators that add them
LAUNCH_RATIO_FINDING = 1.25
# the adjoint: substeps of the float64 double gyre and channel, the
# finite difference's step along the wind and its bar (qgcm_tpu's,
# tests/test_adjoint.py), and the bar of gradients that recompute the
# same arithmetic (remat, segments, the plain forward)
ADJOINT_STEPS = 20
ADJOINT_SEGMENT = 10
ADJOINT_CHANNEL_STEPS = 10
FD_EPS = 1e-3
FD_RTOL = 1e-6
ADJOINT_TOL = 1e-12
# the gradient with the plain chain in the forward: a field also passes
# within this factor of a one-ulp witness (the kernel's gradient from an
# initial state moved by one ulp). Read on the H100: d/dpom 6.69e-11
# against a witness of 8.48e-11, d/dpo 1.90e-12 against 2.90e-12; the
# lagged fields' gradients sit 1e-7 to 1e-10 below d/dqo's.
ADJOINT_WITNESS_FACTOR = 4.0
REMATS = (False, True, 4, "dots")


def member_args(m, nl, ny, nx, dtype, cyclic, sponge, seed, consts=None,
                ah=None):
    """random_args for m members: fields (m, nl, ny, nx) and the
    entrainment (m, ny, nx) per member, the wind's Ekman pumping and
    r_spl (ny, nx) shared, the constants those of the first member."""
    first = random_args(nl, ny, nx, dtype, cyclic, sponge, seed, consts, ah)
    per = [first] + [random_args(nl, ny, nx, dtype, cyclic, sponge,
                                 seed + i, first[7], first[8:10])
                     for i in range(1, m)]
    fields = [torch.stack([a[k] for a in per]) for k in range(4)]
    ent = torch.stack([a[5] for a in per])
    return (*fields, first[4], ent, first[6], *first[7:])


def check_members(label, args, cyclic, sponge, tol):
    """One member-batched launch against m single launches (bit for bit)
    and each member against the plain chain (max|dq| <= tol max|q|);
    the launch counts one launch and m members. Returns (max abs error,
    max|q|)."""
    from qgcm_torch.ops.qgstep import qgstep, qgstep_reference, reset_launches
    fields, (wek, ent, rspl), rest = args[:4], args[4:7], args[7:]
    m = fields[0].shape[0]
    kw = dict(cyclic=cyclic, sponge=sponge)
    reset_launches()
    batched = qgstep(*fields, wek, ent, rspl, *rest, **kw)
    torch.cuda.synchronize()
    if (qgstep.launches, qgstep.members) != (1, m):
        raise AssertionError(f"{label}: {qgstep.launches} launches for "
                             f"{qgstep.members} members, not 1 for {m}")
    err = scale = 0.0
    bit = True
    for i in range(m):
        one = [f[i] for f in fields]
        single = qgstep(*one, wek, ent[i], rspl, *rest, **kw)
        ref = qgstep_reference(*one, wek, ent[i], rspl, *rest, **kw)
        bit &= torch.equal(batched[i], single)
        err = max(err, (single - ref).abs().max().item())
        scale = max(scale, ref.abs().max().item())
    torch.cuda.synchronize()
    if not bit:
        raise AssertionError(f"{label}: the batched launch is not the "
                             "single launches bit for bit")
    if not err <= tol * scale:
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"chain ({err / scale:.3e} max|q|)")
    return err, scale


def phase_member_mode(card):
    """The kernel's member axis: at M = 1, 3, 8 on the box (3x961^2), the
    channel (3x577x4609) and k247 (2x961^2, cyclic + sponge), float32
    and float64, and on ragged small grids, one launch bit for bit M
    single launches and within phase 2's bars of the plain chain; under
    torch.func.vmap one launch too; then 8 x 3x961^2 float32 timed alone
    (CUDA-graph replays, hot and cold L2) against 8 single launches and
    8x the single-member bound. Returns the member mode's entry of the
    kernels line."""
    from qgcm_torch.config import (double_gyre_ocean_only, k247_default,
                                   southern_ocean_ocean_only)
    from qgcm_torch.grids import build_grids
    from qgcm_torch.models.ensemble import strict_vmap
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.ops.qgstep import (plain_members, qgstep,
                                       reset_launches)
    seed = 14000
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        for preset in (double_gyre_ocean_only, southern_ocean_ocean_only,
                       k247_default):
            cfg = preset()
            cyclic, sponge = cfg.cyclic_ocean, cfg.sponge.enabled
            shape = (cfg.nlo, cfg.nypo, cfg.nxpo)
            line = []
            for m in (1, 3, ENSEMBLE_MEMBERS):
                seed += 10
                args = member_args(m, *shape, dtype, cyclic, sponge, seed,
                                   consts=qgstep_consts(cfg, build_grids(cfg)),
                                   ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
                err, scale = check_members(
                    f"{preset.__name__} {str(dtype)[6:]} M={m}", args,
                    cyclic, sponge, tol)
                line.append(f"M={m} {err / scale:.3e}")
                del args
            print(f"  {preset.__name__} {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]}: batched == singles bit for bit; vs "
                  f"plain, max|dq|/max|q| {', '.join(line)} (bar {tol:g})")
            torch.cuda.empty_cache()
        n = 0
        for nl, ny, nx in ((2, 17, 123), (3, 65, 121), (2, 3, 5)):
            for cyclic in (False, True):
                for sponge in (False, True):
                    seed += 10
                    n += 1
                    check_members(f"ragged {nl}x{ny}x{nx}",
                                  member_args(3, nl, ny, nx, dtype, cyclic,
                                              sponge, seed), cyclic,
                                  sponge, tol)
        print(f"  {n} ragged {str(dtype)[6:]} cases of 3 members: bit for "
              "bit the single launches, within the bar of the plain chain")

    cfg = double_gyre_ocean_only()
    nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
    m = ENSEMBLE_MEMBERS
    args = member_args(m, nl, ny, nx, torch.float32, False, False, 15000,
                       consts=qgstep_consts(cfg, build_grids(cfg)),
                       ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
    err, scale = check_members("timed shape", args, False, False, F32_TOL)
    fields, (wek, ent, _), rest = args[:4], args[4:7], args[7:]
    kw = dict(cyclic=False, sponge=False)
    reset_launches()
    with strict_vmap():
        mapped = torch.func.vmap(lambda a, b, c, d, e: qgstep(
            a, b, c, d, wek, e, None, *rest, **kw))(*fields, ent)
    torch.cuda.synchronize()
    if qgstep.launches != 1 or not torch.equal(
            mapped, qgstep(*fields, wek, ent, None, *rest, **kw)):
        raise AssertionError("torch.func.vmap over members is not one "
                             "launch of the batched kernel")
    print(f"  torch.func.vmap over {m} members: 1 launch, bit for bit the "
          "batched call")

    def batched():
        qgstep(*fields, wek, ent, None, *rest, **kw)

    def singles():
        for i in range(m):
            qgstep(*(f[i] for f in fields), wek, ent[i], None, *rest, **kw)

    hot, cold = kernel_ms(batched, 20)
    s_hot, s_cold = kernel_ms(singles, 10)
    # the host's cost of a call of the wrapper, beside a bare launch (CUDA events around eager calls of one
    # member: the host sets their pace)
    from qgcm_torch.ops.qgstep import _launch
    one = [f[:1] for f in fields] + [wek.expand(1, ny, nx), ent[:1], None]
    eager_op = cuda_ms(lambda: qgstep(*(f[0] for f in fields), wek, ent[0],
                                      None, *rest, **kw), 100)
    eager_bare = cuda_ms(lambda: _launch(one, *rest, False, False, "full"),
                         100)
    print(f"  one member, eager: {eager_op:.4f} ms a call of qgstep "
          f"(its checks; no transform or autograd sees it, so not its "
          f"rules), {eager_bare:.4f} ms a bare launch [{card}]")
    plain = cuda_ms(lambda: plain_members(
        *fields, wek.expand(m, ny, nx), ent, None, *rest, False, False), 2)
    # wek is shared (member stride 0): the launch reads it once
    bound, by = kernel_bound(nl, ny, nx, torch.float32, sponge=False,
                             members=m, shared_planes=1)
    print(f"  {m}x{nl}x{ny}x{nx} float32: one launch {hot:.4f} ms hot, "
          f"{cold:.4f} ms cold L2; {m} single launches {s_hot:.4f} / "
          f"{s_cold:.4f} ms; plain chain {plain:.4f} ms; bound {bound:.4f} "
          f"ms ({by}, wek shared); share of bound {bound / hot:.3f} "
          f"hot, {bound / cold:.3f} cold [{card}]")
    del args, fields, mapped
    torch.cuda.empty_cache()
    return dict(name="qgstep (member mode)", route="cuda",
                source="qgcm_torch/csrc/qgstep.cu",
                replaces="qgcm_tpu/ops/pallas_qg.py:277", launches=0,
                max_abs_err=err, ms=hot, cold_ms=cold,
                ms_method="cuda_graph_replay", singles_ms=s_hot,
                eager_ms=eager_op, eager_bare_ms=eager_bare,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, share_of_bound=bound / hot,
                shape=[m, nl, ny, nx])


def worst_member_error(m, single, ensemble, fields):
    """max over members i < m, over the states j of a run and the named
    fields of each, of max|ensemble(i)[j] - single(i)[j]| / max
    (field_errors): single(i) is member i's single-trajectory run and
    ensemble(i) its part of the ensemble run, tuples of states."""
    return max(max(field_errors(ref, got, names).values())
               for i in range(m)
               for ref, got, names in zip(single(i), ensemble(i), fields))


def phase_ensemble(card, main, device, keep=None):
    """The ensemble path at full width: 8 members of the main path's
    double gyre perturbed from phase 4's final state (amp 1e-3) for 50
    float32 substeps through make_ensemble_runner, each member held
    against its single-trajectory run; one qgstep launch a substep;
    launches, ms and the device's busy share beside phase 4's; 3 members
    of the golden box in float64 against their own runs; and the coupled
    double gyre, 4 members for 5 cycles. Returns the paths' entries.
    `keep` (a dict) gets the 8 members' fingerprints (fingerprint) and
    where their inputs went (phase 18 runs them again on a member
    mesh)."""
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.generators import double_gyre_windstress, eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state
    from qgcm_torch.models.ensemble import (make_ensemble_runner, member,
                                            perturbed_atmos_members,
                                            perturbed_ocean_members,
                                            spread_rms)
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import (make_coupled_runner,
                                           make_ocean_only_runner)
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    oc_fields = ("po", "pom", "qo", "qom", "sst", "dpioc")
    paths = []
    model, f, step0 = main["model"], main["forcing"], main["step0"]
    m, n = ENSEMBLE_MEMBERS, ENSEMBLE_STEPS
    gen = torch.Generator(device=device).manual_seed(15)
    members = perturbed_ocean_members(model, main["state"], gen, m,
                                      amp=ENSEMBLE_AMP)
    run_e = make_ensemble_runner(model)
    torch.cuda.synchronize()
    reset_launches()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    out = run_e(members, f, n, step0)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / n
    dev_ms = ev0.elapsed_time(ev1) / n
    launches, stepped = qgstep.launches, qgstep.members
    if (launches, stepped) != (n, n * m):
        raise AssertionError(f"the ensemble launched qgstep {launches} times "
                             f"for {stepped} member-substeps in {n} "
                             f"substeps of {m} members")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise AssertionError("non-finite values in the ensemble")
    if keep is not None:
        # the same members in MESH_RANKS launches of a block each, as a
        # member mesh of MESH_RANKS ranks steps them (phase 18): torch's
        # sums over two or more dimensions order their adds by the
        # number of outputs of the launch, so a member's bits depend on
        # how many members share it
        from pathlib import Path
        path = Path(__file__).resolve().parent / MESH18_WORKDIR
        path.mkdir(parents=True, exist_ok=True)
        torch.save(dict(state=to_host(main["state"]), forcing=to_host(f),
                        cfg=model.cfg, step0=step0, steps=n),
                   path / "members.pt")
        b = m // MESH_RANKS
        blocks = [run_e(type(members)(*(t[i:i + b] for t in members)), f,
                        n, step0) for i in range(0, m, b)]
        keep["members"] = dict(file=str(path / "members.pt"), fp=[
            [fingerprint(getattr(blk, k)[i]) for k in oc_fields]
            for blk in blocks for i in range(b)])
        by_block = worst_member_error(
            m, lambda i: (member(out, i),),
            lambda i: (member(blocks[i // b], i % b),), (oc_fields,))
        print(f"  the same {m} members in {m // b} launches of {b}: worst "
              f"member vs the {m}-member launch {by_block:.3e} of a field's "
              f"max (bar {ENSEMBLE_F32_TOL:g})")
        if not by_block <= ENSEMBLE_F32_TOL:
            raise AssertionError("members stepped in blocks leave the "
                                 "ensemble run")
        del blocks
    run1 = make_ocean_only_runner(model)
    worst = worst_member_error(
        m, lambda i: (run1(member(members, i), f, n, step0),),
        lambda i: (member(out, i),), (oc_fields,))
    print(f"  {m} members x {model.cfg.nlo}x{model.cfg.nypo}x"
          f"{model.cfg.nxpo} float32, {n} substeps from phase 4's state "
          f"(averaging crossed): {launches} qgstep launches for {stepped} "
          f"member-substeps; spread_po {spread_rms(out, 'po'):.4e}; worst "
          f"member vs its single run {worst:.3e} of a field's max (bar "
          f"{ENSEMBLE_F32_TOL:g})")
    print(f"  {dev_ms:.4f} ms/substep (CUDA events), {host_ms:.4f} host; "
          f"{dev_ms / m:.4f} ms/member-substep; phase 4's single member in "
          f"this call: {main['substep_ms']:.4f} ms/substep (events), "
          f"{main['host_ms']:.4f} host [{card}]")
    if not worst <= ENSEMBLE_F32_TOL:
        raise AssertionError("an ensemble member left its single run")
    k = 5
    step1 = step0 + n
    print(f"  ensemble, {k} substeps:")
    ens = profile_counts(lambda: run_e(out, f, k, step1), k, "substep", card)
    profile_units(lambda: run_e(out, f, k, step1), k, "substep", card)
    print(f"  single runner, {k} substeps:")
    single = profile_counts(
        lambda: make_ocean_only_runner(model)(main["state"], f, k, step1),
        k, "substep", card)
    ratio = ens["launches"] / single["launches"]
    q_launch = sum(v for name, v in ens["by_kernel"].items()
                   if "qgstep" in name)
    print(f"  qgstep launches per ensemble substep in the profile: "
          f"{q_launch:g}; device launches per substep {ens['launches']:.1f} "
          f"(ensemble) vs {single['launches']:.1f} (single), ratio "
          f"{ratio:.3f}")
    if q_launch != 1:
        raise AssertionError("the profile shows other than one qgstep launch "
                             "per ensemble substep")
    if ratio > LAUNCH_RATIO_FINDING:
        extra = sorted(((v - single["by_op"].get(op, 0), op)
                        for op, v in ens["by_op"].items()), reverse=True)
        print("  operators adding launches per substep (ensemble - single): "
              + ", ".join(f"{op} +{d:.1f}" for d, op in extra[:8] if d > 0))
    paths.append(dict(path=f"ensemble double_gyre_ocean_only {m} members",
                      launches=launches, members=stepped, rel_err=worst,
                      ms_per_substep=dev_ms, ms_per_member_substep=dev_ms / m,
                      launch_ratio=ratio))
    del members, out
    torch.cuda.empty_cache()

    # the float64 golden box
    cfg = golden_cfg()
    gm = build_model(cfg, device)
    st = init_ocean_state(gm, po=eddy_pressure(cfg, ssh_amp=0.1))
    gf = ocean_forcing_from_mean(
        gm, *double_gyre_windstress(cfg, gm.grids, tau0=2e-5))
    gmem = perturbed_ocean_members(gm, st, gen, GOLDEN_MEMBERS,
                                   amp=ENSEMBLE_AMP)
    reset_launches()
    gout = make_ensemble_runner(gm)(gmem, gf, GOLDEN_STEPS)
    gl = qgstep.launches
    grun1 = make_ocean_only_runner(gm)
    gworst = worst_member_error(
        GOLDEN_MEMBERS, lambda i: (grun1(member(gmem, i), gf, GOLDEN_STEPS),),
        lambda i: (member(gout, i),), (oc_fields,))
    print(f"  golden box float64, {GOLDEN_MEMBERS} members, {GOLDEN_STEPS} "
          f"substeps: {gl} launches; worst member vs its single run "
          f"{gworst:.3e} (bar {ENSEMBLE_F64_TOL:g})")
    if gl != GOLDEN_STEPS or not gworst <= ENSEMBLE_F64_TOL:
        raise AssertionError("the float64 golden ensemble left its single "
                             "runs")
    paths.append(dict(path=f"ensemble golden box float64 {GOLDEN_MEMBERS} "
                      "members", launches=gl, rel_err=gworst))

    # the coupled double gyre
    cfg = double_gyre_coupled(dtype="float32")
    cm = build_model(cfg, device)
    oc = init_ocean_state(cm, init="rbal", po=eddy_pressure(cfg,
                                                            ssh_amp=0.15))
    at = init_atmos_state(cm, init="rbal")
    mc = COUPLED_MEMBERS
    ocm = perturbed_ocean_members(cm, oc, gen, mc, amp=ENSEMBLE_AMP)
    atm = perturbed_atmos_members(cm, at, gen, mc, amp=10 * ENSEMBLE_AMP)
    run_c = make_ensemble_runner(cm)
    cyc = COUPLED_ENSEMBLE_CYCLES
    steps = cyc * cfg.nstr
    torch.cuda.synchronize()
    reset_launches()
    ev0.record()
    h0 = time.perf_counter()
    oco, ato = run_c(ocm, atm, steps)
    ev1.record()
    torch.cuda.synchronize()
    c_host = (time.perf_counter() - h0) * 1e3 / cyc
    c_dev = ev0.elapsed_time(ev1) / cyc
    cl, cmem = qgstep.launches, qgstep.members
    crun1 = make_coupled_runner(cm)
    cworst = worst_member_error(
        mc, lambda i: crun1(member(ocm, i), member(atm, i), steps),
        lambda i: (member(oco, i), member(ato, i)),
        (oc_fields, ("pa", "qa", "ast", "hmixa")))
    print(f"  coupled double gyre float32, {mc} members, {cyc} cycles: {cl} "
          f"launches for {cmem} member-substeps; worst member vs its single "
          f"run {cworst:.3e} (bar {ENSEMBLE_F32_TOL:g}); {c_dev:.4f} "
          f"ms/cycle (events), {c_host:.4f} host, {c_dev / mc:.4f} "
          f"ms/member-cycle [{card}]")
    if (cl, cmem) != (cyc, cyc * mc) or not cworst <= ENSEMBLE_F32_TOL:
        raise AssertionError("the coupled ensemble missed its single runs or "
                             "its launches")
    profile_units(lambda: run_c(oco, ato, 2 * cfg.nstr, steps), 2, "cycle",
                  card)
    paths.append(dict(path=f"ensemble double_gyre_coupled {mc} members",
                      launches=cl, members=cmem, rel_err=cworst,
                      ms_per_cycle=c_dev, ms_per_member_cycle=c_dev / mc))
    del cm, ocm, atm, oco, ato
    torch.cuda.empty_cache()
    return paths


def grad_errors(got, want) -> dict:
    """max|got - want| / max|want| of each gradient field (a field that
    is zero in `want` must be zero in `got`)."""
    out = {}
    names = [f"d/d{n}" for n in got.state0._fields] + [
        f"d/d{n}" for n in ("tauxo", "tauyo", "fnetoc")]
    for name, a, b in zip(names, [*got.state0, *got.forcing],
                          [*want.state0, *want.forcing]):
        d = (a - b).abs().max().item()
        s = b.abs().max().item()
        out[name] = d / s if s else (0.0 if d == 0 else float("inf"))
    return out


def grad_error(got, want) -> float:
    """The worst of grad_errors."""
    return max(grad_errors(got, want).values())


def adjoint_case(preset, device):
    """A float64 preset from an eddy under its wind (double gyre in the
    box, the channel stress in the channel): model, state, mean forcing
    on the card."""
    from qgcm_torch.generators import (channel_windstress,
                                       double_gyre_windstress, eddy_pressure)
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import init_ocean_state
    cfg = preset(dtype="float64")
    model = build_model(cfg, device)
    st = init_ocean_state(model, init="rbal",
                          po=eddy_pressure(cfg, ssh_amp=0.15))
    wind = channel_windstress if cfg.cyclic_ocean else double_gyre_windstress
    mf = tuple(torch.as_tensor(a, device=device)
               for a in wind(cfg, model.grids))
    return model, st, mf


def directional_fd(model, obj, st, mf, g, n):
    """(adjoint, central finite difference) of d/da L(a tauxo) at a = 1."""
    from qgcm_torch.models.ocean import ocean_forcing_from_mean
    from qgcm_torch.models.stepper import make_ocean_only_runner
    run = make_ocean_only_runner(model)
    tauxo, tauyo, fnetoc = mf

    def primal(a):
        f = ocean_forcing_from_mean(model, a * tauxo, tauyo, fnetoc)
        return float(obj(run(st, f, n)))

    fd = (primal(1 + FD_EPS) - primal(1 - FD_EPS)) / (2 * FD_EPS)
    return float((g.forcing[0] * tauxo).sum()), fd


def timed_sensitivity(model, obj, st, mf, n, **kw):
    """ocean_sensitivity(model, obj, **kw)(st, mf, n) with the forward
    and backward passes timed apart (the loss sees the forward's end),
    the forward's qgstep launches and the peak memory. Returns (value,
    gradients, stats)."""
    from qgcm_torch.adjoint import ocean_sensitivity
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    rec = {}

    def loss(final):
        torch.cuda.synchronize()
        rec["t"], rec["launches"] = time.perf_counter(), qgstep.launches
        return obj(final)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    val, g = ocean_sensitivity(model, loss, **kw)(st, mf, n)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return val, g, dict(fwd_ms=(rec["t"] - t0) * 1e3 / n,
                        bwd_ms=(t1 - rec["t"]) * 1e3 / n,
                        fwd_launches=rec["launches"],
                        all_launches=qgstep.launches,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def fused_step_backward(model, card):
    """The fused step's two halves in the adjoint at the model's shape:
    the kernel's forward (CUDA-graph replays) beside the backward, the
    plain chain's VJP recomputed from the inputs (CUDA events), on
    seeded fields with the model's constants."""
    from qgcm_torch.models.ocean import qgstep_consts
    from qgcm_torch.ops.qgstep import plain_members, qgstep
    cfg = model.cfg
    nl, ny, nx = cfg.nlo, cfg.nypo, cfg.nxpo
    args = random_args(nl, ny, nx, model.dtype, False, False, 16000,
                       consts=qgstep_consts(cfg, model.grids),
                       ah=(cfg.ocean.ah2oc, cfg.ocean.ah4oc))
    tensors = [a.unsqueeze(0) for a in args[:6]]
    rest = ([float(c) for c in args[7]], [float(a) for a in args[8]],
            [float(a) for a in args[9]], False, False)
    grad = torch.ones_like(tensors[3])
    fwd, _ = kernel_ms(lambda: qgstep(*args, cyclic=False, sponge=False), 20)
    bwd = cuda_ms(lambda: torch.func.vjp(
        lambda *xs: plain_members(*xs, None, *rest), *tensors)[1](grad), 3)
    print(f"  the fused step at {nl}x{ny}x{nx} {str(model.dtype)[6:]}: "
          f"forward (kernel) {fwd:.4f} ms, backward (the plain chain's "
          f"VJP, recomputed) {bwd:.4f} ms [{card}]")


def phase_adjoint(card, device):
    """The adjoint at full width in float64 with the kernel in its
    forward: the double gyre (961^2 x 3) for 20 substeps under
    layer1_energy_proxy with remat False, True, 4 and "dots" (equal
    within 1e-12 of each field's max; ms forward and backward a substep,
    peak memory; the forward's qgstep launches), host segments of 10,
    the gradient with the all-plain forward (with a one-ulp witness),
    and the directional
    derivative along the wind against a central finite difference; then
    the southern-ocean channel (577x4609 x 3) for 10 substeps under
    transport_proxy with remat=True against its finite difference.
    Returns the paths' entries."""
    from qgcm_torch.adjoint import layer1_energy_proxy, transport_proxy
    from qgcm_torch.config import (double_gyre_ocean_only,
                                   southern_ocean_ocean_only)
    from qgcm_torch.ops import qgstep as qmod
    paths = []
    model, st, mf = adjoint_case(double_gyre_ocean_only, device)
    obj = layer1_energy_proxy(model)
    n = ADJOINT_STEPS
    timed_sensitivity(model, obj, st, mf, 2, remat=False)     # warm-up
    runs = {}
    for remat in REMATS:
        val, g, stats = timed_sensitivity(model, obj, st, mf, n, remat=remat)
        runs[remat] = (val, g)
        err = grad_error(g, runs[False][1])
        print(f"  remat={remat!r:6}: value {float(val):.10e}; gradients vs "
              f"remat=False {err:.3e} (bar {ADJOINT_TOL:g}); forward "
              f"{stats['fwd_ms']:.2f} ms/substep, backward "
              f"{stats['bwd_ms']:.2f} ms/substep (host clock, synced); peak "
              f"{stats['peak_gb']:.3f} GB; qgstep launches: forward "
              f"{stats['fwd_launches']}, with the backward's recomputation "
              f"{stats['all_launches']} [{card}]")
        if stats["fwd_launches"] != n or not err <= ADJOINT_TOL:
            raise AssertionError(f"the adjoint with remat={remat!r} missed")
        paths.append(dict(path=f"adjoint double_gyre float64 remat={remat}",
                          launches=stats["fwd_launches"], rel_err=err,
                          **stats))
    val, g_seg, stats = timed_sensitivity(model, obj, st, mf, n,
                                          segment_steps=ADJOINT_SEGMENT)
    seg_err = grad_error(g_seg, runs[True][1])
    print(f"  segments of {ADJOINT_SEGMENT}: gradients vs one program "
          f"{seg_err:.3e} (bar {ADJOINT_TOL:g}); peak {stats['peak_gb']:.3f} "
          f"GB; {stats['all_launches']} launches")
    with contextlib.ExitStack() as plain:
        # the forward's fused step as its plain chain on the card
        plain.callback(setattr, qmod, "step_members", qmod.step_members)
        qmod.step_members = qmod.plain_members
        _, g_plain, pstats = timed_sensitivity(model, obj, st, mf, n,
                                               remat=False)
    # The two forwards part at float64 roundoff, and the gradients of
    # the lagged fields (pom, dpiocp) are residues of the viscous
    # stencils' transposes, orders of magnitude below the others, which
    # such a difference moves by far more than 1e-12 of their max. The
    # second witness: the kernel's own gradient from an initial state
    # whose prognostic fields are moved by one ulp. A field passes within
    # ADJOINT_TOL, or no farther from the kernel's gradient than
    # ADJOINT_WITNESS_FACTOR times the witness is.
    plain_errs = grad_errors(g_plain, runs[False][1])
    st_w = st._replace(**{k: getattr(st, k) * (1 + 2.0**-52)
                          for k in ("po", "pom", "qo", "qom")})
    _, g_w, _ = timed_sensitivity(model, obj, st_w, mf, n, remat=False)
    witness = grad_errors(g_w, runs[False][1])
    missed = [k for k, e in plain_errs.items()
              if not (e <= ADJOINT_TOL
                      or e <= ADJOINT_WITNESS_FACTOR * witness[k])]
    print(f"  the forward's fused step as the plain chain: "
          f"{pstats['all_launches']} qgstep launches; forward "
          f"{pstats['fwd_ms']:.2f} ms/substep; gradients vs the kernel's, by "
          f"field, plain / one-ulp witness (held: the first within "
          f"{ADJOINT_TOL:g} or within {ADJOINT_WITNESS_FACTOR:g}x the "
          f"second):")
    print("    " + "; ".join(f"{k} {e:.2e}/{witness[k]:.2e}"
                           for k, e in plain_errs.items() if e or witness[k]))
    if pstats["all_launches"] or missed or not seg_err <= ADJOINT_TOL:
        raise AssertionError(f"segments or the plain forward changed the "
                             f"gradient: {missed}")
    adj, fd = directional_fd(model, obj, st, mf, runs[True][1], n)
    rel = abs(adj - fd) / abs(fd)
    print(f"  d/da L(a tauxo): adjoint {adj:.12e}, central difference "
          f"{fd:.12e}, rel {rel:.3e} (bar {FD_RTOL:g})")
    if not (fd != 0 and rel <= FD_RTOL):
        raise AssertionError("the adjoint misses its finite difference")
    paths[1]["fd_rel"] = rel
    fused_step_backward(model, card)
    del model, st, mf, runs, g_seg, g_plain
    torch.cuda.empty_cache()

    model, st, mf = adjoint_case(southern_ocean_ocean_only, device)
    obj = transport_proxy(model)
    n = ADJOINT_CHANNEL_STEPS
    val, g, stats = timed_sensitivity(model, obj, st, mf, n, remat=True)
    adj, fd = directional_fd(model, obj, st, mf, g, n)
    rel = abs(adj - fd) / abs(fd)
    print(f"  southern_ocean_ocean_only {model.cfg.nlo}x{model.cfg.nypo}x"
          f"{model.cfg.nxpo} float64, {n} substeps, transport_proxy, "
          f"remat=True: adjoint {adj:.12e}, central difference {fd:.12e}, "
          f"rel {rel:.3e} (bar {FD_RTOL:g}); forward {stats['fwd_ms']:.2f}, "
          f"backward {stats['bwd_ms']:.2f} ms/substep; peak "
          f"{stats['peak_gb']:.3f} GB; {stats['fwd_launches']} forward "
          f"launches [{card}]")
    if stats["fwd_launches"] != n or not (fd != 0 and rel <= FD_RTOL):
        raise AssertionError("the channel's adjoint misses its finite "
                             "difference")
    paths.append(dict(path="adjoint southern_ocean_ocean_only float64",
                      launches=stats["fwd_launches"], fd_rel=rel, **stats))
    del model, st, mf, g
    torch.cuda.empty_cache()
    return paths


def phase_commands(card):
    """The new commands in this process under build/qgcm_torch/cases:
    `ensemble` on phase 10's coupled case (4 members, 1 day, samples
    every 0.25 day), `analyze` on its output, `sense` on a cut
    ocean-only double gyre in float64 for 0.5 day with 0.25-day segments
    and without (the same sensitivity.nc within 1e-12), and `run
    --profile` on phase 10's case, whose report must name the kernel."""
    from qgcm_torch.io.ncdf import read_vars
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from pathlib import Path
    root = Path(__file__).resolve().parent
    case = root / CASES / "double_gyre_coupled"
    grid = ["--preset", "double_gyre_coupled", "--dtype", "float32"]
    reset_launches()
    log, _ = run_cli(["ensemble", str(case), "--members", "4", "--days", "1",
                      "--sample-days", "0.25", "--quiet"] + grid)
    cycles = 86400 // 540
    print(f"  ensemble: {log.strip().splitlines()[-1]}; {qgstep.launches} "
          f"qgstep launches for {qgstep.members} member-substeps")
    if (qgstep.launches, qgstep.members) != (cycles, 4 * cycles):
        raise AssertionError("the ensemble command missed its launches")
    log, _ = run_cli(["analyze", str(case / "outdata_ens")])
    for line in log.strip().splitlines():
        print(f"    {line}")
    sp = read_vars(str(case / "outdata_ens" / "ensemble.nc"),
                   ["tyrs", "spread_po"])
    rate = np.polyfit(sp["tyrs"] * 365.0, np.log(sp["spread_po"]), 1)[0]
    print(f"    spread_po growth rate over all records (log-linear fit): "
          f"{rate:.4e} per day")

    sense = new_case("sense_double_gyre",
                     "examples/double_gyre_ocean_only/input.params",
                     name="restart.nc")
    cut = ["--preset", "double_gyre_ocean_only", "--dtype", "float64",
           "--nxaooc", "15", "--nyaooc", "15", "--nxta", "96", "--nyta", "24"]
    run_cli(["prepare", str(sense), "--eddy-amp", "0.15", "--forcing",
             "double-gyre"] + cut)
    out = {}
    for seg in ("0", "0.25"):
        log, _ = run_cli(["sense", str(sense), "--days", "0.5",
                          "--segment-days", seg, "--outdir",
                          str(sense / f"seg{seg}")] + cut)
        out[seg] = read_vars(str(sense / f"seg{seg}" / "sensitivity.nc"),
                             ["objective", "dJ_dtauxo", "dJ_dtauyo",
                              "dJ_dfnetoc", "dJ_dpo", "dJ_dsst"])
        print(f"  sense, segments {seg} d: "
              + "; ".join(log.strip().splitlines()[-3:-1]))
    worst = max(float(np.abs(out["0"][k] - out["0.25"][k]).max()
                      / np.abs(out["0"][k]).max()) for k in out["0"])
    print(f"  sensitivity.nc, 0.25-day segments vs one program: worst "
          f"{worst:.3e} of a field's max (bar {ADJOINT_TOL:g})")
    if not worst <= ADJOINT_TOL:
        raise AssertionError("the segmented sense command left the one "
                             "program")

    prof = root / CASES / "profile"
    log, _ = run_cli(["run", str(case), "--trun", repr(0.75 / 365.0),
                      "--outdir", str(root / CASES / "profiled"),
                      "--profile", str(prof)] + grid)
    report = log[log.index("profile of"):].splitlines()
    for line in report:
        print(f"    {line}")
    if not any("qgstep" in line for line in report):
        raise AssertionError("run --profile's report does not name the "
                             "qgstep kernel")


# ----------------------------------------------------------------------
# Phase 18: the decomposed coupled model, the Driver and the commands on
# rows meshes, in MESH_RANKS ranks (mesh_backend)
# ----------------------------------------------------------------------

# where phase 15 leaves the ensemble's inputs and phase 18's ranks meet
# (listed in .gitignore)
MESH18_WORKDIR = "build/qgcm_torch/mesh_coupled"
# cycles of the full-width coupled mesh runs from phases 7 and 8's final
# states, and their warm-up cycles (not timed)
COUPLED_MESH_CYCLES = {"double_gyre_coupled": (20, 2),
                       "southern_ocean_coupled": (5, 1)}
# the golden coupled box in float64 (phase 6's configuration) from the
# radiative balance under an ocean eddy, with tau_udiff
GOLDEN_MESH_CYCLES = 10
# each segment of the CLI's mesh run: half of phase 10's resumed day
MESH_DRIVER_SEGMENT_DAYS = 0.5
MESH_DRIVER_CADENCES = dict(valday=0.25, dgnday=0.25, odiday=0.25,
                            adiday=0.25, prtday=0.25, resday=0.5,
                            dtavoc=0.25, dtavat=0.25, name="restart.nc")
# the monit.nc series held against phase 10's single-device day at
# RESUME_TOL (the others are printed): the energies of both fluids
MESH_MONIT_HELD = ("kealoc", "kealat")
# the atmosphere-only Driver(mesh): double_gyre_coupled's atmosphere at
# full width in float64 over a prescribed SST (the radiative balance's
# with seeded noise of ATMOS_SST_NOISE kelvin) from rest, for
# ATMOS_DRIVER_DAYS with every atmosphere cadence on, on a rows mesh of
# the ranks, against the single-device Driver on the card: the final
# atmosphere within MESH_F64_TOL of each field's maximum
ATMOS_DRIVER_DAYS = 0.05
ATMOS_DRIVER_CADENCES = dict(valday=0.025, dgnday=0.025, adiday=0.025,
                             prtday=0.05, resday=0.05, dtavat=0.025,
                             name="rbal")
ATMOS_SST_NOISE = 2.0
# `ensemble --shard-members` on phase 10's case, float64, against the
# command unsharded: every series of ensemble.nc within SHARD_TOL of its
# maximum. A spread is the members' small difference (3.7e-4 m^2/s^2 in
# phase 17 beside pressures of order 10), so the launches' other orders
# of adds (phase 15) reach it magnified some 1e5 times: 1e-16 of the
# fields becomes 1e-11 of the spread, and the bar leaves a margin of 100
SHARD_MEMBERS = 8
SHARD_DAYS = 0.125
SHARD_SAMPLE_DAYS = 0.0625
SHARD_TOL = 1e-9


def to_host(tree):
    """A NamedTuple of tensors copied to the host."""
    return type(tree)(*(t.detach().cpu() if torch.is_tensor(t) else t
                        for t in tree))


def fingerprint(t: torch.Tensor) -> tuple:
    """Two integer sums of a tensor's bits (its float words read as
    integers, plain and weighted by position): equal for equal bits, and
    all but never equal for tensors that differ anywhere."""
    b = t.detach().contiguous().reshape(-1)
    b = b.view(torch.int32 if b.element_size() == 4 else torch.int64)
    b = b.to(torch.int64)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 65521
    return int(b.sum()), int((b * (w + 1)).sum())


def _coupled_mesh_rank(tasks):
    """What each rank of phase 18 runs, in order over the world group:
    'runner' tasks step a coupled state on a rows mesh through the
    decomposed coupled runner (rank 0 also runs the single-device runner
    from the same state and compares); the 'members' task steps phase
    15's members on a member mesh. Returns per task the rank's launches
    by mode, collectives, staged MB and host ms per cycle, and its
    atmosphere's fingerprints; rank 0 adds the errors (or the members'
    fingerprints)."""
    import torch.distributed as dist
    from qgcm_torch.generators import eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state
    from qgcm_torch.models.ensemble import (ensemble_mesh,
                                            make_ensemble_runner,
                                            perturbed_ocean_members)
    from qgcm_torch.models.ocean import init_ocean_state
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from qgcm_torch.parallel.mesh import (atmos_mesh, gather_tree, make_mesh,
                                          shard_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()          # NCCL sets up its communicator here
    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for task in tasks:
        res = dict(task=task["label"])
        if task["kind"] == "driver":
            out.append({**res, **_atmos_driver_rank(task, dev)})
            torch.cuda.empty_cache()
            continue
        if task["kind"] == "members":
            saved = torch.load(task["file"], weights_only=False)
            model = build_model(saved["cfg"], dev)
            gen = torch.Generator(device=dev).manual_seed(15)
            members = perturbed_ocean_members(
                model, type(saved["state"])(*(t.to(dev) for t in
                                              saved["state"])),
                gen, task["members"], amp=ENSEMBLE_AMP)
            forcing = type(saved["forcing"])(*(t.to(dev) for t in
                                               saved["forcing"]))
            mesh = ensemble_mesh()
            reset_launches()
            got = make_ensemble_runner(model, mesh=mesh)(
                members, forcing, saved["steps"], saved["step0"])
            res.update(launches=dict(qgstep.mode_launches),
                       members_stepped=qgstep.members,
                       counts=dict(mesh.counts))
            if rank == 0:
                res["fp"] = [[fingerprint(getattr(got, k)[i])
                              for k in task["fields"]]
                             for i in range(task["members"])]
            out.append(res)
            del model, members, got
            torch.cuda.empty_cache()
            continue
        cfg = task["cfg"]
        model = build_model(cfg, dev)
        if task.get("state"):
            oc, at, step0 = task["state"]
            oc = type(oc)(*(t.to(dev) for t in oc))
            at = type(at)(*(t.to(dev) for t in at))
        else:
            oc = init_ocean_state(model, init="rbal",
                                  po=eddy_pressure(cfg, ssh_amp=0.1))
            at, step0 = init_atmos_state(model, init="rbal"), 0
        nstr = cfg.nstr
        cycles, warm = task["cycles"], task["warm"]
        mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
        amesh = atmos_mesh(mesh, cfg)
        run = make_coupled_runner(model, mesh=mesh, halo_variant="overlap",
                                  spectral_variant="a2a")
        ob, atb = run(shard_tree(oc, mesh), shard_tree(at, amesh),
                      warm * nstr, step0=step0)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        mesh.counts.clear()
        mesh.staged_bytes = 0
        n = cycles - warm
        t0 = time.perf_counter()
        ob, atb = run(ob, atb, n * nstr, step0=step0 + warm * nstr)
        torch.cuda.synchronize()
        res.update(
            launches=dict(qgstep.mode_launches),
            launches_per_cycle={k: v / n for k, v in
                                qgstep.mode_launches.items()},
            counts={k: v / n for k, v in mesh.counts.items()},
            staged_mb=mesh.staged_bytes / n / 1e6,
            host_ms=(time.perf_counter() - t0) * 1e3 / n)
        # the kernel launches of one more cycle, profiled (its result is
        # not kept)
        dist.barrier()
        res["cycle_launches"] = kernel_launches(
            lambda: run(ob, atb, nstr, step0=step0 + cycles * nstr))
        # the atmosphere's row blocks put together on every rank, and its
        # replicated leaves
        atb = gather_tree(atb, amesh)
        res["atmos_fp"] = {k: fingerprint(v) for k, v in
                           atb._asdict().items()}
        full = gather_tree(ob, mesh)
        if rank == 0:
            ref_o, ref_a = make_coupled_runner(model)(oc, at, cycles * nstr,
                                                      step0=step0)
            res["errors"] = {**field_errors(ref_o, full, task["ocean"]),
                             **field_errors(ref_a, atb, task["atmos"])}
            res["finite"] = all(bool(torch.isfinite(t).all())
                                for t in (*full, *atb))
            if cfg.cyclic_ocean:
                res["duplicate_column"] = torch.equal(full.po[..., -1],
                                                      full.po[..., 0])
            del ref_o, ref_a
        out.append(res)
        del model, oc, at, ob, atb, full
        torch.cuda.empty_cache()
    return out


def atmos_driver_case(dev):
    """(model, RunParams, sst_mean) of phase 18's atmosphere-only
    Driver run."""
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.model import build_model
    from qgcm_torch.params import RunParams
    model = build_model(double_gyre_coupled(dtype="float64",
                                            atmos_only=True), dev)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(18)
    sst = (torch.as_tensor(model.rad.sstbar, device=dev)[:, None]
           + ATMOS_SST_NOISE * torch.randn((cfg.nyto, cfg.nxto),
                                           generator=gen, device=dev,
                                           dtype=torch.float64))
    params = RunParams(trun=ATMOS_DRIVER_DAYS / 365.0, dta=cfg.dta,
                       nstr=cfg.nstr, **ATMOS_DRIVER_CADENCES)
    return model, params, sst


def _atmos_driver_rank(task, dev):
    """Phase 18's atmosphere-only Driver(mesh) in one rank: the rank's
    seconds, collectives and staged MB, whether it aborted; rank 0 adds
    the final atmosphere (gathered by the Driver) on the host."""
    import torch.distributed as dist
    from qgcm_torch.parallel.mesh import make_mesh
    from qgcm_torch.run import Driver
    model, params, sst = atmos_driver_case(dev)
    cfg = model.cfg
    mesh = make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
    dist.barrier()
    t0 = time.perf_counter()
    res = Driver(model, params, task["outdir"], sst_mean=sst, mesh=mesh,
                 verbose=False).run()
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, steps=res.steps_done,
               aborted=res.aborted, counts=dict(mesh.counts),
               staged_mb=mesh.staged_bytes / 1e6,
               atmos_fp={k: fingerprint(v)
                         for k, v in res.atmos._asdict().items()})
    if dist.get_rank() == 0:
        out["atmos"] = to_host(res.atmos)
    return out


def kernel_launches(fn) -> int:
    """The card's kernel launches of fn() (memcpy and memset not
    counted), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith(("Memcpy", "Memset")))


# --rank-cycle: the coupled double gyre's rank-cycle in MESH_RANKS ranks,
# cycles timed after one of warm-up, then one profiled
RANK_CYCLES = 5


def _rank_cycle_rank(cycles):
    """One rank of rank_cycle: double_gyre_coupled in float32 from the
    radiative balance under an ocean eddy on a rows mesh of the ranks,
    the atmosphere on its row blocks where the checkout has them
    (parallel/mesh.atmos_mesh), else whole on every rank. Returns the
    rank's host ms and staged MB per cycle and the kernel launches of
    one profiled cycle."""
    import torch.distributed as dist
    import qgcm_torch.parallel.mesh as pm
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.generators import eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state
    from qgcm_torch.models.ocean import init_ocean_state
    from qgcm_torch.models.stepper import make_coupled_runner
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.barrier()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = build_model(double_gyre_coupled(dtype="float32"), dev)
    cfg = model.cfg
    mesh = pm.make_mesh(rows_only=True, grid=(cfg.nypo, cfg.nxpo))
    ob = pm.shard_tree(init_ocean_state(model, init="rbal", po=eddy_pressure(
        cfg, ssh_amp=0.1)), mesh)
    ab = init_atmos_state(model, init="rbal")
    blocks = hasattr(pm, "atmos_mesh")
    if blocks:
        ab = pm.shard_tree(ab, pm.atmos_mesh(mesh, cfg))
    run = make_coupled_runner(model, mesh=mesh, halo_variant="overlap",
                              spectral_variant="a2a")
    nstr = cfg.nstr
    ob, ab = run(ob, ab, nstr)
    torch.cuda.synchronize()
    dist.barrier()
    mesh.staged_bytes = 0
    t0 = time.perf_counter()
    ob, ab = run(ob, ab, cycles * nstr, step0=nstr)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / cycles
    staged = mesh.staged_bytes / cycles / 1e6
    dist.barrier()
    launches = kernel_launches(
        lambda: run(ob, ab, nstr, step0=(cycles + 1) * nstr))
    return dict(blocks=blocks, host_ms=host_ms, staged_mb=staged,
                launches=launches)


def rank_cycle(card) -> dict:
    """The coupled double gyre's rank-cycle (_rank_cycle_rank) in
    MESH_RANKS ranks (mesh_backend) of this process's qgcm_torch: per
    rank, host ms and MB staged a cycle over RANK_CYCLES cycles and the
    kernel launches of a profiled cycle."""
    from pathlib import Path
    from qgcm_torch.parallel.launch import spawn_ranks
    work = Path.cwd() / "build" / "qgcm_torch" / "rank_cycle"
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    backend, label = mesh_backend()
    res = spawn_ranks(_rank_cycle_rank, MESH_RANKS, RANK_CYCLES,
                      backend=backend, workdir=work, timeout=600)
    return dict(blocks=res[0]["blocks"], label=label, card=card,
                host_ms=[r["host_ms"] for r in res],
                staged_mb=[r["staged_mb"] for r in res],
                launches=[r["launches"] for r in res])


def compare_rank_cycles(checkouts) -> int:
    """rank_cycle of each checkout in turn, each in a process of its own
    with that checkout's qgcm_torch and this file's code (copied under
    the checkout's build/ as chip_smoke_probe, so that the spawned ranks
    import it by that name): for instance a parent commit unpacked under
    build/, and this one, in the order parent, this, this, parent."""
    from pathlib import Path
    here = str(Path(__file__).resolve())
    child = ("import json, shutil, sys, pathlib; "
             "d = pathlib.Path('build/qgcm_torch/probe').resolve(); "
             "d.mkdir(parents=True, exist_ok=True); "
             f"shutil.copy({here!r}, d / 'chip_smoke_probe.py'); "
             "sys.path.append(str(d)); "
             "import chip_smoke_probe as m; "
             "print('RANK_CYCLE ' + json.dumps(m.rank_cycle("
             "m.card_line())))")
    got = run_in_checkouts(checkouts, child, r"^RANK_CYCLE ([^\n]*)$",
                           "the rank-cycle")
    if got is None:
        return 1
    print(f"double_gyre_coupled float32 rank-cycle by checkout, in the "
          f"order run [{card_line()}]:")
    for where, m in got:
        r = json.loads(m.group(1))
        print(f"  {where} (atmosphere "
              f"{'on row blocks' if r['blocks'] else 'whole on every rank'}"
              f", {r['label']}): kernel launches a rank-cycle "
              f"{r['launches']}; host ms a rank-cycle over {RANK_CYCLES} "
              + ", ".join(f"{v:.2f}" for v in r["host_ms"])
              + "; MB staged a rank-cycle "
              + ", ".join(f"{v:.3f}" for v in r["staged_mb"]))
    return 0


def torchrun_cli(argv, backend, ranks=MESH_RANKS):
    """`torchrun --standalone --nproc-per-node ranks -m qgcm_torch.cli
    ARGV --dist-backend backend` from the repository's root, as a user
    starts a decomposed run (torchrun gives the ranks their process
    group's address, size and ranks on this host). Returns its standard
    output; raises if any rank fails."""
    import os
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), "-m", "qgcm_torch.cli", *argv,
           "--dist-backend", backend]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    if run.returncode:
        print(run.stdout[-4000:] + run.stderr[-8000:], file=sys.stderr)
        raise AssertionError(f"torchrun qgcm_torch.cli {argv[0]} exited "
                             f"{run.returncode}")
    return run.stdout


def mesh_cli_resume(spec, mesh_line, backend, card):
    """Through torchrun, `run --mesh SPEC` on phase 10's case for
    MESH_DRIVER_SEGMENT_DAYS and `run --resume` for as long again, from
    phase 10's restart, against phase 10's single-device day: lastday.nc
    and the MESH_MONIT_HELD series of monit.nc within RESUME_TOL. Raises
    on a miss, or if a run does not print `mesh: MESH_LINE`."""
    import shutil
    from pathlib import Path
    root = Path(__file__).resolve().parent
    grid = ["--preset", "double_gyre_coupled", "--dtype", "float32"]
    single = root / CASES / "double_gyre_coupled_resume"
    case = new_case(f"double_gyre_coupled_mesh_{spec}",
                    "examples/double_gyre_coupled/input.params",
                    trun=MESH_DRIVER_SEGMENT_DAYS / 365.0,
                    **MESH_DRIVER_CADENCES)
    shutil.copy(single / "restart.nc", case / "restart.nc")
    t0 = time.perf_counter()
    logs = [torchrun_cli(["run", str(case), "--mesh", spec] + grid,
                         backend)]
    logs.append(torchrun_cli(["run", str(case), "--mesh", spec,
                              "--resume"] + grid, backend))
    cli_s = time.perf_counter() - t0
    for log in logs:
        lines = [ln for ln in log.splitlines()
                 if ln.startswith(("mesh:", "done:"))]
        print("    " + "\n    ".join(lines))
        if not any(ln.startswith(f"mesh: {mesh_line}") for ln in lines):
            raise AssertionError(f"run --mesh {spec} printed no mesh line")
    want = lastday(single)
    got = lastday(case, "outdata_r2")
    errs = {k: float(np.abs(got[k] - v).max() / np.abs(v).max())
            for k, v in want.items()}
    m_want, dims = monit_series(single / "outdata" / "monit.nc")
    m_got = [monit_series(case / seg / "monit.nc")[0]
             for seg in ("outdata", "outdata_r2")]
    monit = {}
    for name, w in m_want.items():
        if name == "time" or not dims[name] or dims[name][0] != "time":
            continue
        g = np.concatenate([m[name] for m in m_got])
        monit[name] = float(np.abs(g - w).max()
                            / max(np.abs(w).max(), 1e-30))
    held = {k: monit[k] for k in MESH_MONIT_HELD}
    rest = sorted(((v, k) for k, v in monit.items()
                   if k not in MESH_MONIT_HELD), reverse=True)
    print(f"  run --mesh {spec}, {MESH_DRIVER_SEGMENT_DAYS} + "
          f"{MESH_DRIVER_SEGMENT_DAYS} days resumed, against phase 10's "
          f"single-device day: lastday "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; monit.nc " + ", ".join(f"{k} {v:.3e}" for k, v in held.items())
          + f" (bar {RESUME_TOL:g}); {cli_s:.1f} s of torchrun [{card}]")
    print("    largest monit.nc differences not held: "
          + ", ".join(f"{k} {v:.3e}" for v, k in rest[:6]))
    if not max(*errs.values(), *held.values()) <= RESUME_TOL:
        raise AssertionError(f"the CLI's run on --mesh {spec} parts from "
                             "the single-device day")
    files = sorted(p.name for p in (case / "outdata_r2").iterdir())
    print(f"    files of the resumed segment (primary rank): "
          f"{' '.join(files)}")


def phase_coupled_mesh(card, states, members):
    """The decomposed coupled model, the Driver and the commands on rows
    meshes in MESH_RANKS ranks (mesh_backend): the golden coupled box in
    float64 on 4 rows and double_gyre_coupled (20 cycles) and
    southern_ocean_coupled (5 cycles) in float32 at full width from
    phases 7 and 8's final states, the atmosphere on row blocks, each
    against the single-device coupled runner from the same state, every
    rank's atmosphere (gathered) the same bits; phase 15's 8 members
    again on a member mesh of the ranks, bit for bit phase 15's run of
    the same blocks of members; double_gyre_coupled's atmosphere alone
    through Driver(mesh) in float64 against the single-device Driver on
    the card (ATMOS_DRIVER_DAYS); then through torchrun,
    `run --mesh rows` on phase 10's case for half a day and `run
    --resume` for another, against phase 10's single-device day, and
    `ensemble --shard-members` in float64 against the same command
    without it. Returns (the kernels line's launch counts by mode, the
    row-window paths' entries, the member mode's)."""
    import shutil
    from pathlib import Path
    from qgcm_torch.config import (OceanConfig, double_gyre_coupled,
                                   southern_ocean_coupled)
    from qgcm_torch.io.ncdf import read_vars
    from qgcm_torch.parallel.launch import spawn_ranks

    root = Path(__file__).resolve().parent
    work = root / MESH18_WORKDIR / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ocean = ("po", "qo", "sst", "dpioc")
    atmos = ("pa", "qa", "ast", "hmixa")
    golden = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                                 ndxr=4, dta=180.0, tau_udiff=True,
                                 ocean=OceanConfig(dxo=20.0e3))
    tasks = [dict(kind="runner", label="golden coupled box float64",
                  cfg=golden, cycles=GOLDEN_MESH_CYCLES, warm=1,
                  ocean=ocean, atmos=atmos, tol=MESH_F64_TOL)]
    for preset in (double_gyre_coupled, southern_ocean_coupled):
        cycles, warm = COUPLED_MESH_CYCLES[preset.__name__]
        tasks.append(dict(kind="runner", label=f"{preset.__name__} float32",
                          cfg=preset(dtype="float32"),
                          state=states[preset.__name__], cycles=cycles,
                          warm=warm, ocean=ocean, atmos=atmos,
                          tol=MESH_F32_TOL))
    tasks.append(dict(kind="members", label=f"{ENSEMBLE_MEMBERS} members of "
                      "double_gyre_ocean_only on a member mesh",
                      file=members["file"], members=ENSEMBLE_MEMBERS,
                      fields=("po", "pom", "qo", "qom", "sst", "dpioc")))
    # the atmosphere alone: the single-device Driver on the card first
    from qgcm_torch.run import Driver
    atmos_dir = root / MESH18_WORKDIR / "atmos_only"
    shutil.rmtree(atmos_dir, ignore_errors=True)
    model, params, sst = atmos_driver_case(torch.device("cuda"))
    t0 = time.perf_counter()
    single = Driver(model, params, str(atmos_dir / "single"), sst_mean=sst,
                    verbose=False).run()
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_atmos = to_host(single.atmos)
    del model, sst, single
    torch.cuda.empty_cache()
    tasks.append(dict(kind="driver", label="atmosphere-only Driver(mesh), "
                      "double_gyre_coupled float64",
                      outdir=str(atmos_dir / "mesh")))
    backend, label = mesh_backend()
    t0 = time.perf_counter()
    results = spawn_ranks(_coupled_mesh_rank, MESH_RANKS, tasks,
                          backend=backend, workdir=work, timeout=600)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s with start-up "
          f"[{card}]")
    totals = {"rows": 0, "x_ext": 0, "full": 0}
    paths, member_paths = [], []
    for i, task in enumerate(tasks):
        per_rank = [r[i] for r in results]
        r0 = per_rank[0]
        if task["kind"] == "driver":
            errs = field_errors(single_atmos, r0["atmos"],
                                ("pa", "qa", "ast", "hmixa", "dpiat"))
            same = all(pr["atmos_fp"] == r0["atmos_fp"]
                       for pr in per_rank[1:])
            steps = r0["steps"]
            print(f"  {task['label']}, {MESH_RANKS}x1 rows, {steps} steps "
                  f"({ATMOS_DRIVER_DAYS} days, every atmosphere cadence on): "
                  f"final atmosphere vs the single-device Driver on the "
                  f"card (max|diff|/max) "
                  + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                  + f" (bar {MESH_F64_TOL:g}); every rank's atmosphere the "
                  f"same bits: {same}")
            print(f"    host {1e3 * r0['seconds'] / steps:.2f} ms/step "
                  f"(rank 0; single device "
                  f"{1e3 * single_s / steps:.2f}); {r0['staged_mb'] / steps:.3f}"
                  f" MB staged a step; collectives of rank 0 {r0['counts']} "
                  f"-- {label} [{card}]")
            if not (all(v <= MESH_F64_TOL for v in errs.values()) and same
                    and not any(pr["aborted"] for pr in per_rank)):
                raise AssertionError("the atmosphere-only Driver(mesh) "
                                     "misses the single-device Driver")
            continue
        launches = {m: sum(pr["launches"].get(m, 0) for pr in per_rank)
                    for m in totals}
        if task["kind"] == "members":
            same = r0["fp"] == members["fp"]
            stepped = [pr["members_stepped"] for pr in per_rank]
            print(f"  {task['label']}: {MESH_RANKS} ranks of "
                  f"{ENSEMBLE_MEMBERS // MESH_RANKS} members, member-substeps "
                  f"stepped per rank {stepped}, collectives of rank 0 "
                  f"{r0['counts']}; every member bit for bit phase 15's "
                  f"unsharded run of the same blocks: {same}")
            if not same:
                bad = [j for j, (a, b) in enumerate(zip(r0["fp"],
                                                        members["fp"]))
                       if a != b]
                raise AssertionError(f"members {bad} on the member mesh are "
                                     "not phase 15's bits")
            # the member mode's path, not the row window's
            member_paths.append(dict(path=task["label"],
                                     launches=launches["full"],
                                     members=sum(stepped), rel_err=0.0))
            continue
        for m in totals:
            totals[m] += launches[m]
        worst = max(r0["errors"].values())
        same_atmos = all(pr["atmos_fp"] == r0["atmos_fp"]
                         for pr in per_rank[1:])
        print(f"  {task['label']}, overlap + a2a, {MESH_RANKS} ranks, "
              f"{task['cycles']} cycles: errors vs the single-device coupled "
              f"runner (max|diff|/max) "
              + ", ".join(f"{k} {v:.3e}" for k, v in r0["errors"].items())
              + f" (bar {task['tol']:g}); finite {r0['finite']}"
              + (f"; duplicate column {r0['duplicate_column']}"
                 if "duplicate_column" in r0 else "")
              + f"; every rank's atmosphere the same bits: {same_atmos}")
        print(f"    per rank per cycle: qgstep launches "
              f"{r0['launches_per_cycle']}; collectives {r0['counts']}; "
              f"{r0['staged_mb']:.3f} MB staged through the host; host "
              f"{r0['host_ms']:.2f} ms/cycle (rank 0; max over ranks "
              f"{max(p['host_ms'] for p in per_rank):.2f}); kernel launches "
              f"of a profiled cycle by rank "
              f"{[p['cycle_launches'] for p in per_rank]} -- {label} "
              f"[{card}]")
        if not (r0["finite"] and r0.get("duplicate_column", True)
                and same_atmos and worst <= task["tol"]):
            raise AssertionError(f"{task['label']} misses the single-device "
                                 "coupled runner")
        if any(p["launches_per_cycle"].get("rows") != 3 for p in per_rank):
            raise AssertionError(f"{task['label']}: expected 3 row-window "
                                 "launches per rank per cycle")
        paths.append(dict(path=f"coupled mesh {task['label']}",
                          launches=launches, rel_err=worst,
                          host_ms_per_rank_cycle=r0["host_ms"],
                          staged_mb_per_cycle=r0["staged_mb"]))

    # the CLI through torchrun: half a day, then --resume for another
    mesh_cli_resume("rows", "{'y': 4, 'x': 1}", backend, card)

    # ensemble --shard-members against the same command unsharded, in
    # float64: the sharded members take other launches' sums than the
    # unsharded ones (phase 15), and a spread is a small difference of
    # large fields
    case10 = root / CASES / "double_gyre_coupled"
    ens = ["ensemble", str(case10), "--members", str(SHARD_MEMBERS),
           "--days", str(SHARD_DAYS), "--sample-days",
           str(SHARD_SAMPLE_DAYS), "--quiet", "--preset",
           "double_gyre_coupled", "--dtype", "float64"]
    t0 = time.perf_counter()
    run_cli(ens + ["--outdir", str(case10 / "ens_single")])
    log = torchrun_cli(ens + ["--outdir", str(case10 / "ens_sharded"),
                              "--shard-members"], backend)
    names = ["tyrs", "spread_po", "spread_sst", "po_rms", "spread_pa"]
    a = read_vars(str(case10 / "ens_single" / "ensemble.nc"), names)
    b = read_vars(str(case10 / "ens_sharded" / "ensemble.nc"), names)
    errs = {k: float(np.abs(a[k] - b[k]).max() / np.abs(a[k]).max())
            for k in names}
    print(f"  ensemble --shard-members, {SHARD_MEMBERS} members of the "
          f"coupled double gyre in float64 over {MESH_RANKS} ranks: "
          f"'{log.strip().splitlines()[0]}'; ensemble.nc against the "
          f"unsharded command, max|diff|/max: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bar {SHARD_TOL:g}); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    if not max(errs.values()) <= SHARD_TOL:
        raise AssertionError("ensemble --shard-members leaves the unsharded "
                             "ensemble")
    return totals, paths, member_paths


# ----------------------------------------------------------------------
# Phase 19: the 2-D runner: the box ocean on (y, x) meshes, in MESH_RANKS
# ranks (mesh_backend)
# ----------------------------------------------------------------------

# where the ranks meet and phase 4's final state waits for them (listed in
# .gitignore)
MESH19_WORKDIR = "build/qgcm_torch/mesh2d"
# the 2-D meshes of the full-width ocean-only runs
MESH2D_SHAPES = ((2, 2), (1, 4))
# cycles of the coupled 2x2 run from phase 7's final state, and warm-up
MESH2D_COUPLED_CYCLES = (20, 2)


def _window_recorder(calls):
    """A stand-in for parallel/halo.py's qgstep that launches the kernel
    and keeps each launch's arguments and result (the x_ext launches a
    2-D substep makes on the runner's own fields)."""
    from qgcm_torch.ops.qgstep import qgstep

    def record(*args, **kw):
        out = qgstep(*args, **kw)
        calls.append((args, kw, out))
        return out

    return record


def _mesh2d_rank(tasks):
    """What each rank of phase 19 runs, in order over the world group:
    'ocean' tasks step an ocean-only box on each of their (my, mx)
    meshes, 'coupled' tasks a coupled box (rank 0 also runs the
    single-device runner from the same state and compares); a task with
    `windows` then takes one more 'overlap' substep with parallel/halo.py's
    kernel calls recorded, and holds each of the rank's x_ext launches
    against window_reference on the card (launches that are not counted:
    the counts are read before). Returns per run the rank's launches by
    mode, collectives, staged MB and host ms per substep or cycle; rank 0
    adds the errors."""
    import torch.distributed as dist
    import qgcm_torch.parallel.halo as halo
    from qgcm_torch.generators import double_gyre_windstress, eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import (make_coupled_runner,
                                           make_ocean_only_runner)
    from qgcm_torch.ops.qgstep import qgstep, reset_launches, \
        window_reference
    from qgcm_torch.parallel.mesh import (Mesh, atmos_mesh, gather_tree,
                                          shard_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()          # NCCL sets up its communicator here
    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for task in tasks:
        cfg = task["cfg"]
        model = build_model(cfg, dev)
        coupled = task["kind"] == "coupled"
        if "file" in task:
            saved = torch.load(task["file"], weights_only=False)
            st = type(saved["state"])(*(t.to(dev) for t in saved["state"]))
            f = type(saved["forcing"])(*(t.to(dev) for t in
                                         saved["forcing"]))
            step0 = saved["step0"]
        elif coupled:
            oc, at, step0 = task["state"]
            st = type(oc)(*(t.to(dev) for t in oc))
            at = type(at)(*(t.to(dev) for t in at))
        else:
            st = init_ocean_state(model, po=eddy_pressure(cfg, ssh_amp=0.1))
            f = ocean_forcing_from_mean(model, *double_gyre_windstress(
                cfg, model.grids, tau0=2e-5))
            step0 = 0
        unit = cfg.nstr if coupled else 1
        for shape in task["meshes"]:
            res = dict(task=task["label"], mesh=list(shape))
            mesh = Mesh(shape, grid=(cfg.nypo, cfg.nxpo))
            kw = dict(mesh=mesh, halo_variant="overlap",
                      spectral_variant="a2a")
            sb = shard_tree(st, mesh)
            if coupled:
                run = make_coupled_runner(model, **kw)

                def go(state, atmos, n, k0):
                    return run(state, atmos, n * unit, step0=k0 * unit)
            else:
                run = make_ocean_only_runner(model, **kw)
                fb = shard_tree(f, mesh)

                def go(state, atmos, n, k0):
                    return run(state, fb, n, step0=k0), None
            k0 = step0 // unit
            steps, warm = task["steps"], task["warm"]
            ab = (shard_tree(at, atmos_mesh(mesh, cfg)) if coupled
                  else None)
            sb, ab = go(sb, ab, warm, k0)
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            mesh.counts.clear()
            mesh.staged_bytes = 0
            n = steps - warm
            t0 = time.perf_counter()
            sb, ab = go(sb, ab, n, k0 + warm)
            torch.cuda.synchronize()
            res.update(launches=dict(qgstep.mode_launches),
                       launches_per_unit={k: v / n for k, v in
                                          qgstep.mode_launches.items()},
                       counts={k: v / n for k, v in mesh.counts.items()},
                       staged_mb=mesh.staged_bytes / n / 1e6,
                       host_ms=(time.perf_counter() - t0) * 1e3 / n)
            full = gather_tree(sb, mesh)
            # the atmosphere's row blocks put together on every rank
            ab_full = (gather_tree(ab, atmos_mesh(mesh, cfg)) if coupled
                       else None)
            res["pad_zero"] = all(
                bool((v[..., max(0, cfg.nypo - mesh.iy * mesh.by):, :] == 0
                      ).all()) and bool((v[..., max(0, cfg.nxpo - mesh.ix
                                                     * mesh.bx):] == 0).all())
                for v in (sb.po, sb.pom, sb.qo, sb.qom))
            if rank == 0:
                if coupled:
                    ref_o, ref_a = make_coupled_runner(model)(
                        st, at, steps * unit, step0=step0)
                    res["errors"] = {
                        **field_errors(ref_o, full, task["ocean"]),
                        **field_errors(ref_a, ab_full, task["atmos"])}
                    res["finite"] = all(bool(torch.isfinite(t).all())
                                        for t in (*full, *ab_full))
                    del ref_a
                else:
                    ref_o = make_ocean_only_runner(model)(st, f, steps,
                                                          step0=step0)
                    res["errors"] = field_errors(ref_o, full, task["ocean"])
                    res["finite"] = all(bool(torch.isfinite(t).all())
                                        for t in full)
                del ref_o
            if coupled:
                res["atmos_fp"] = {k: fingerprint(v)
                                   for k, v in ab_full._asdict().items()}
            if task.get("windows") and shape == task["windows"]:
                # one more substep, its x_ext launches recorded
                calls = []
                real = halo.qgstep
                halo.qgstep = _window_recorder(calls)
                try:
                    go(sb, ab, 1, k0 + steps)
                finally:
                    halo.qgstep = real
                torch.cuda.synchronize()
                checks = []
                for args, kwargs, got in calls:
                    ref = window_reference(*args, **kwargs)
                    err = (got - ref).abs().max().item()
                    checks.append(dict(
                        shape=list(args[0].shape), out=list(got.shape),
                        row0=kwargs["row0"], col0=kwargs["col0"],
                        x_ext=kwargs.get("x_ext", False), err=err,
                        scale=ref.abs().max().item()))
                res["windows"] = checks
            out.append(res)
            del sb, full
        del model, st
        torch.cuda.empty_cache()
    return out


def save_main_state(main):
    """Phase 4's final state and forcing, on the host, in a file under
    MESH19_WORKDIR; returns its path."""
    from pathlib import Path
    path = Path(__file__).resolve().parent / MESH19_WORKDIR / "main.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(state=to_host(main["state"]),
                    forcing=to_host(main["forcing"]),
                    step0=main["step0"]), path)
    return str(path)


def phase_mesh_2d(card, states, main_file):
    """The 2-D runner in MESH_RANKS ranks (mesh_backend): the float64
    golden box on 2x2 against the single-device runner (MESH_F64_TOL);
    double_gyre_ocean_only at full width in float32 from phase 4's state,
    'overlap' for MESH_STEPS substeps on 2x2 and 1x4, against the
    single-device runner (MESH_F32_TOL), with one rank's five x_ext
    launches of a further substep on 2x2 held against window_reference
    on the card (F32_TOL of the window's max|q|); double_gyre_coupled on
    2x2 from phase 7's final state, 20 cycles, at phase 18's bar; then
    through torchrun `run --mesh 2x2` on phase 10's case, half a day and
    half a day resumed, against phase 10's single-device day. Returns
    (the kernels line's launch counts by mode, the paths' entries)."""
    import shutil
    from pathlib import Path
    from qgcm_torch.config import double_gyre_coupled, double_gyre_ocean_only
    from qgcm_torch.parallel.launch import spawn_ranks

    root = Path(__file__).resolve().parent
    work = root / MESH19_WORKDIR / "ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ocean = ("po", "qo", "sst", "dpioc")
    atmos = ("pa", "qa", "ast", "hmixa")
    cycles, warm = MESH2D_COUPLED_CYCLES
    tasks = [
        dict(kind="ocean", label="golden box float64", cfg=golden_cfg(),
             meshes=[(2, 2)], steps=GOLDEN_STEPS, warm=MESH_WARMUP,
             ocean=ocean, tol=MESH_F64_TOL),
        dict(kind="ocean", label="double_gyre_ocean_only float32",
             cfg=double_gyre_ocean_only(dtype="float32"), file=main_file,
             meshes=list(MESH2D_SHAPES), steps=MESH_STEPS,
             warm=MESH_WARMUP, ocean=ocean, tol=MESH_F32_TOL,
             windows=(2, 2)),
        dict(kind="coupled", label="double_gyre_coupled float32",
             cfg=double_gyre_coupled(dtype="float32"),
             state=states["double_gyre_coupled"], meshes=[(2, 2)],
             steps=cycles, warm=warm, ocean=ocean, atmos=atmos,
             tol=MESH_F32_TOL)]
    backend, label = mesh_backend()
    t0 = time.perf_counter()
    results = spawn_ranks(_mesh2d_rank, MESH_RANKS, tasks, backend=backend,
                          workdir=work, timeout=600)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s with start-up "
          f"[{card}]")
    totals = {"rows": 0, "x_ext": 0, "full": 0}
    paths = []
    runs = [(t, sh) for t in tasks for sh in t["meshes"]]
    for i, (task, shape) in enumerate(runs):
        per_rank = [r[i] for r in results]
        r0 = per_rank[0]
        launches = {m: sum(pr["launches"].get(m, 0) for pr in per_rank)
                    for m in totals}
        for m in totals:
            totals[m] += launches[m]
        coupled = task["kind"] == "coupled"
        unit = "cycle" if coupled else "substep"
        mesh_s = f"{shape[0]}x{shape[1]}"
        worst = max(r0["errors"].values())
        same_atmos = (not coupled or all(pr["atmos_fp"] == r0["atmos_fp"]
                                         for pr in per_rank[1:]))
        pad = all(pr["pad_zero"] for pr in per_rank)
        print(f"  {task['label']}, overlap + a2a, {mesh_s} mesh, "
              f"{task['steps']} {unit}s: errors vs the single-device runner "
              f"(max|diff|/max) "
              + ", ".join(f"{k} {v:.3e}" for k, v in r0["errors"].items())
              + f" (bar {task['tol']:g}); finite {r0['finite']}; padding "
              f"rows and columns zero {pad}"
              + (f"; every rank's atmosphere the same bits: {same_atmos}"
                 if coupled else ""))
        print(f"    per rank per {unit}: qgstep launches "
              f"{r0['launches_per_unit']}; collectives {r0['counts']}; "
              f"{r0['staged_mb']:.3f} MB staged through the host; host "
              f"{r0['host_ms']:.2f} ms/rank-{unit} (rank 0; max over ranks "
              f"{max(p['host_ms'] for p in per_rank):.2f}) -- {label} "
              f"[{card}]")
        if not (r0["finite"] and pad and same_atmos
                and worst <= task["tol"]):
            raise AssertionError(f"{task['label']} on {mesh_s} misses the "
                                 "single-device runner")
        # 'overlap' on a 2-D block: the interior, two row bands and two
        # column bands
        if any(p["launches_per_unit"].get("x_ext") != 5
               or p["launches_per_unit"].get("rows")
               or p["launches_per_unit"].get("full") for p in per_rank):
            raise AssertionError(f"{task['label']} on {mesh_s}: expected 5 "
                                 f"x_ext launches per rank per {unit}, and "
                                 "no other")
        for w in r0.get("windows", []):
            rel = w["err"] / max(w["scale"], 1e-300)
            print(f"    rank 0's x_ext launch {w['shape']} -> {w['out']} at "
                  f"row0 {w['row0']}, col0 {w['col0']}: kernel vs "
                  f"window_reference {w['err']:.3e} = {rel:.3e} of the "
                  f"window's max|q| (bar {F32_TOL:g})")
            if not rel <= F32_TOL:
                raise AssertionError("an x_ext launch of the 2-D runner "
                                     "disagrees with window_reference")
        if "windows" in r0 and len(r0["windows"]) != 5:
            raise AssertionError("a 2-D overlap substep made "
                                 f"{len(r0['windows'])} x_ext launches, not 5")
        entry = dict(path=f"2-D mesh {mesh_s} {task['label']}",
                     launches=launches, rel_err=worst,
                     **{f"host_ms_per_rank_{unit}": r0["host_ms"],
                        f"staged_mb_per_{unit}": r0["staged_mb"]})
        if "windows" in r0:
            entry["windows_max_abs_err"] = max(w["err"]
                                               for w in r0["windows"])
        paths.append(entry)

    mesh_cli_resume("2x2", "{'y': 2, 'x': 2}", backend, card)
    if totals["full"] or totals["rows"]:
        raise AssertionError("a 2-D run launched another mode than x_ext")
    return totals, paths


# ----------------------------------------------------------------------
# Phase 20: the distributed adjoint, in MESH_RANKS ranks (mesh_backend)
# ----------------------------------------------------------------------

# where the ranks meet and the initial state and wind wait for them
# (listed in .gitignore)
MESH20_WORKDIR = "build/qgcm_torch/mesh_adjoint"
# the meshes of the distributed adjoint, each against the single-device
# adjoint on the card from the same state
ADJOINT_MESHES = ((MESH_RANKS, 1), (2, 2))
ADJOINT_MESH_STEPS = 10
# ranks against the single-device gradient (value, forcing, state0.po),
# of each field's maximum: the float64 bar of a decomposed run
ADJOINT_MESH_TOL = MESH_F64_TOL


def _adjoint_mesh_rank(file, meshes, steps):
    """What each rank of phase 20 runs: on each (my, mx) mesh, a warm-up
    adjoint of 2 substeps, then ocean_sensitivity(mesh, 'overlap',
    remat=True) over `steps` substeps from the state in `file`, the
    forward and backward timed apart (the loss marks the forward's end),
    qgstep's launches by mode in each, the bytes staged through the host
    in each and the peak memory; rank 0 adds the gradients (state0.po's
    gathered, the forcing's). On the rows mesh the primal at (1 +- eps)
    tauxo by the mesh runner (the finite difference). Last, one more
    substep with parallel/halo.py's window launches recorded, each held
    against window_reference on the card (launches after the counts were
    read): the recorded launch's output and that of the same launch
    through the kernel's rule against window_reference's forward, and
    the gradient of a seeded weighting of the rule's output against
    autograd through the plain version (an identity: the rule's backward
    is window_reference's VJP; it shows the gradient goes through the
    rule)."""
    import torch.distributed as dist
    import qgcm_torch.parallel.halo as halo
    from qgcm_torch.adjoint import layer1_energy_proxy, ocean_sensitivity
    from qgcm_torch.config import double_gyre_ocean_only
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import ocean_forcing_from_mean
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches, \
        window_reference
    from qgcm_torch.parallel.mesh import Mesh, gather, gather_tree, \
        shard_tree
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()          # NCCL sets up its communicator here
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(file, weights_only=False)
    model = build_model(double_gyre_ocean_only(dtype="float64"), dev)
    cfg = model.cfg
    st = type(saved["state"])(*(t.to(dev) for t in saved["state"]))
    mf = tuple(t.to(dev) for t in saved["mean_forcing"])
    obj = layer1_energy_proxy(model)
    out = []
    for shape in meshes:
        mesh = Mesh(shape, grid=(cfg.nypo, cfg.nxpo))
        sb = shard_tree(st, mesh)
        sens = ocean_sensitivity(model, obj, remat=True, mesh=mesh,
                                 halo_variant="overlap")
        sens(sb, mf, 2)                                   # warm-up
        rec = {}

        def loss(final):
            torch.cuda.synchronize()
            rec.update(t=time.perf_counter(),
                       launches=dict(qgstep.mode_launches),
                       staged=mesh.staged_bytes)
            return obj(final)

        sens = ocean_sensitivity(model, loss, remat=True, mesh=mesh,
                                 halo_variant="overlap")
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        mesh.counts.clear()
        mesh.staged_bytes = 0
        t0 = time.perf_counter()
        val, g = sens(sb, mf, steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = dict(qgstep.mode_launches)
        res = dict(mesh=list(shape), value=float(val),
                   fwd_launches=rec["launches"], all_launches=launches,
                   fwd_ms=(rec["t"] - t0) * 1e3 / steps,
                   bwd_ms=(t1 - rec["t"]) * 1e3 / steps,
                   fwd_mb=rec["staged"] / steps / 1e6,
                   bwd_mb=(mesh.staged_bytes - rec["staged"]) / steps / 1e6,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   counts=dict(mesh.counts))
        # this rank's block of d/dpo on its true points: nonzero where the
        # gradient reaches the block
        nr = max(0, min(mesh.by, cfg.nypo - mesh.iy * mesh.by))
        nc = max(0, min(mesh.bx, cfg.nxpo - mesh.ix * mesh.bx))
        res["block_max"] = g.state0.po[..., :nr, :nc].abs().max().item()
        res["forcing_fp"] = [fingerprint(a) for a in g.forcing]
        po = gather(g.state0.po, mesh, site="test")
        if rank == 0:
            res["po"] = po.cpu()
            res["forcing"] = [a.cpu() for a in g.forcing]
        del g, po
        if shape[1] == 1:
            # the central difference along tauxo, by the mesh runner
            run = make_ocean_only_runner(model, mesh=mesh,
                                         halo_variant="overlap",
                                         spectral_variant="a2a")
            with torch.no_grad():
                def primal(a):
                    f = shard_tree(ocean_forcing_from_mean(
                        model, a * mf[0], mf[1], mf[2]), mesh)
                    return float(obj(gather_tree(run(sb, f, steps), mesh)))
                res["fd"] = ((primal(1 + FD_EPS) - primal(1 - FD_EPS))
                             / (2 * FD_EPS))
        # one more substep with its window launches recorded, then each
        # launch's gradient through the rule against the plain version's
        calls = []
        real = halo.qgstep
        halo.qgstep = _window_recorder(calls)
        try:
            with torch.no_grad():
                make_ocean_only_runner(model, mesh=mesh,
                                       halo_variant="overlap",
                                       spectral_variant="a2a")(
                    sb, shard_tree(ocean_forcing_from_mean(model, *mf),
                                   mesh), 1)
        finally:
            halo.qgstep = real
        gen = torch.Generator(device=dev).manual_seed(20 + rank)
        checks = []
        for args, kw, launched in calls:
            leaves = [a.detach().clone().requires_grad_()
                      if torch.is_tensor(a) else a for a in args]
            xs = [a for a in leaves if torch.is_tensor(a)]
            got = qgstep(*leaves, **kw)
            plain = window_reference(*leaves, **kw)
            scale = plain.detach().abs().max().clamp_min(1e-300)
            fwd_err = max(((o.detach() - plain.detach()).abs().max()
                           / scale).item() for o in (launched, got))
            w = torch.randn(got.shape, generator=gen, device=dev,
                            dtype=got.dtype)
            rule = type(got.grad_fn).__name__
            g_rule = torch.autograd.grad((got * w).sum(), xs)
            g_plain = torch.autograd.grad((plain * w).sum(), xs)
            err = max(((a - b).abs().max() / b.abs().max().clamp_min(
                1e-300)).item() for a, b in zip(g_rule, g_plain))
            checks.append(dict(shape=list(args[0].shape), out=list(got.shape),
                               x_ext=kw.get("x_ext", False), rule=rule,
                               fwd_err=fwd_err, err=err))
        res["windows"] = checks
        out.append(res)
        del sb
        torch.cuda.empty_cache()
    return out


def phase_adjoint_mesh(card, device):
    """The distributed adjoint in MESH_RANKS ranks (mesh_backend):
    double_gyre_ocean_only at full width in float64 from an eddy under
    the double-gyre wind, layer1_energy_proxy, 10 substeps, remat=True,
    'overlap' on 4x1 rows and on 2x2, each against the single-device
    adjoint on the card from the same state (the value, the three
    forcing gradients and state0.po's, gathered, within
    ADJOINT_MESH_TOL of each field's maximum); every rank's block of
    d/dpo nonzero and within the bar of the single-device block; the
    rows run's directional derivative along tauxo against a central
    finite difference (FD_RTOL); each rank's window launches of a
    further substep, their outputs, direct and through the kernel's
    rule, against window_reference's (F64_TOL, phase 2's bar) and their
    gradients through the rule against autograd through window_reference
    (ADJOINT_TOL; an identity that shows the rule is taken). Returns (the
    kernels line's launch counts by mode, the paths' entries)."""
    import shutil
    from pathlib import Path
    from qgcm_torch.adjoint import layer1_energy_proxy, ocean_sensitivity
    from qgcm_torch.config import double_gyre_ocean_only
    from qgcm_torch.parallel.launch import spawn_ranks

    root = Path(__file__).resolve().parent
    work = root / MESH20_WORKDIR
    shutil.rmtree(work, ignore_errors=True)
    (work / "ranks").mkdir(parents=True)
    model, st, mf = adjoint_case(double_gyre_ocean_only, device)
    obj = layer1_energy_proxy(model)
    n = ADJOINT_MESH_STEPS
    timed_sensitivity(model, obj, st, mf, 2, remat=True)      # warm-up
    val, g, stats = timed_sensitivity(model, obj, st, mf, n, remat=True)
    print(f"  single device: value {float(val):.12e}; forward "
          f"{stats['fwd_ms']:.2f}, backward {stats['bwd_ms']:.2f} ms/substep; "
          f"peak {stats['peak_gb']:.3f} GB [{card}]")
    want_po = g.state0.po.cpu()
    want_f = [a.cpu() for a in g.forcing]
    file = work / "state.pt"
    torch.save(dict(state=to_host(st), mean_forcing=[a.cpu() for a in mf]),
               file)
    cfg = model.cfg
    del model, st, g
    torch.cuda.empty_cache()
    backend, label = mesh_backend()
    t0 = time.perf_counter()
    results = spawn_ranks(_adjoint_mesh_rank, MESH_RANKS, str(file),
                          list(ADJOINT_MESHES), n, backend=backend,
                          workdir=work / "ranks", timeout=600)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s with start-up "
          f"[{card}]")
    totals = {"rows": 0, "x_ext": 0, "full": 0}
    paths = []
    tauxo = mf[0].cpu()
    for i, shape in enumerate(ADJOINT_MESHES):
        per_rank = [r[i] for r in results]
        r0 = per_rank[0]
        mesh_s = f"{shape[0]}x{shape[1]}"
        mode = "rows" if shape[1] == 1 else "x_ext"
        errs = {"value": abs(r0["value"] - float(val)) / abs(float(val)),
                "d/dpo": grad_ratio(r0["po"], want_po)}
        for name, a, b in zip(("tauxo", "tauyo", "fnetoc"), r0["forcing"],
                              want_f):
            errs[f"d/d{name}"] = grad_ratio(a, b)
        same = all(p["value"] == r0["value"]
                   and p["forcing_fp"] == r0["forcing_fp"]
                   for p in per_rank[1:])
        # each rank's block of the single-device d/dpo
        by, bx = -(-cfg.nypo // shape[0]), -(-cfg.nxpo // shape[1])
        blocks = []
        for k, p in enumerate(per_rank):
            iy, ix = divmod(k, shape[1])
            sl = (..., slice(iy * by, (iy + 1) * by),
                  slice(ix * bx, (ix + 1) * bx))
            blocks.append((p["block_max"],
                           grad_ratio(r0["po"][sl], want_po[sl],
                                      want_po.abs().max().item())))
        fwd = {m: sum(p["fwd_launches"][m] for p in per_rank)
               for m in totals}
        alls = {m: sum(p["all_launches"][m] for p in per_rank)
                for m in totals}
        for m in totals:
            totals[m] += alls[m]
        print(f"  {mesh_s} overlap, remat=True, {n} substeps: vs the "
              f"single device (max|diff|/max) "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bar {ADJOINT_MESH_TOL:g}); value and forcing gradients "
              f"the same bits on every rank: {same}")
        print("    each rank's block of d/dpo: max "
              + ", ".join(f"{m:.3e}" for m, _ in blocks)
              + "; vs the single-device block (of its max) "
              + ", ".join(f"{e:.3e}" for _, e in blocks))
        print(f"    {mode} launches (all ranks): forward {fwd[mode]}, with "
              f"the backward's recomputation {alls[mode]}; per rank: forward "
              + ", ".join(f"{p['fwd_ms']:.2f}" for p in per_rank)
              + " ms/substep, backward "
              + ", ".join(f"{p['bwd_ms']:.2f}" for p in per_rank)
              + f" ms/substep; staged {r0['fwd_mb']:.3f} MB forward, "
              f"{r0['bwd_mb']:.3f} MB backward a rank-substep (rank 0); peak "
              + ", ".join(f"{p['peak_gb']:.3f}" for p in per_rank)
              + f" GB -- {label} [{card}]")
        print(f"    rank 0's collectives: {r0['counts']}")
        windows = [w for p in per_rank for w in p["windows"]]
        worst_w = max(w["err"] for w in windows)
        worst_f = max(w["fwd_err"] for w in windows)
        rules = sorted({w["rule"] for w in windows})
        print(f"    {len(windows)} window launches of a substep (all ranks) "
              f"through {rules}: output (direct and through the rule) vs "
              f"window_reference, worst {worst_f:.3e} of max|q| (bar "
              f"{F64_TOL:g}); gradient vs autograd through "
              f"window_reference (the rule's backward is its VJP), worst "
              f"{worst_w:.3e} of max|grad| (bar {ADJOINT_TOL:g}); shapes of "
              f"rank 0's "
              + ", ".join(f"{w['shape']}->{w['out']}"
                          for w in per_rank[0]["windows"]))
        entry = dict(path=f"distributed adjoint {mesh_s} overlap float64 "
                     f"remat=True", launches=alls, forward_launches=fwd,
                     rel_err=max(errs.values()),
                     fwd_ms_per_rank_substep=r0["fwd_ms"],
                     bwd_ms_per_rank_substep=r0["bwd_ms"],
                     staged_mb_fwd=r0["fwd_mb"], staged_mb_bwd=r0["bwd_mb"],
                     peak_gb=[p["peak_gb"] for p in per_rank],
                     rule_fwd_err=worst_f, rule_max_err=worst_w)
        if "fd" in r0:
            adj = float((r0["forcing"][0] * tauxo).sum())
            fd_rel = abs(adj - r0["fd"]) / abs(r0["fd"])
            print(f"    d/da L(a tauxo): adjoint {adj:.12e}, central "
                  f"difference {r0['fd']:.12e}, rel {fd_rel:.3e} (bar "
                  f"{FD_RTOL:g})")
            entry["fd_rel"] = fd_rel
            if not (r0["fd"] != 0 and fd_rel <= FD_RTOL):
                raise AssertionError(f"the distributed adjoint on {mesh_s} "
                                     "misses its finite difference")
        paths.append(entry)
        per_step = 3 if mode == "rows" else 5
        if not (max(errs.values()) <= ADJOINT_MESH_TOL and same
                and all(m > 0 and e <= ADJOINT_MESH_TOL for m, e in blocks)):
            raise AssertionError(f"the distributed adjoint on {mesh_s} misses "
                                 "the single-device adjoint")
        if (fwd[mode] != per_step * n * MESH_RANKS
                or alls[mode] != 2 * fwd[mode]
                or any(v for m, v in alls.items() if m != mode)):
            raise AssertionError(f"the distributed adjoint on {mesh_s}: "
                                 f"launches {fwd} forward, {alls} in all")
        if not (worst_f <= F64_TOL and worst_w <= ADJOINT_TOL
                and rules == ["_WindowBackward"]
                and len(per_rank[0]["windows"]) == per_step):
            raise AssertionError("a window launch through the kernel's rule "
                                 "misses window_reference")
    return totals, paths


# ----------------------------------------------------------------------
# Phase 21: the coupled model's distributed adjoint, in MESH_RANKS ranks
# (mesh_backend)
# ----------------------------------------------------------------------

# where the ranks meet and the initial state waits for them (listed in
# .gitignore)
MESH21_WORKDIR = "build/qgcm_torch/mesh_coupled_adjoint"
# the meshes of the coupled distributed adjoint, each against the
# single-device coupled gradient on the card from the same state
COUPLED_ADJOINT_MESHES = ((MESH_RANKS, 1), (2, 2))
COUPLED_ADJOINT_CYCLES = 2
# the directional derivative along a seeded direction of the initial SST
# (a unit normal a point) against central differences of the steps
# COUPLED_FD_EPS kelvin, the best of them within COUPLED_FD_RTOL,
# qgcm_tpu's bar (tests/test_adjoint.py:157-190; its step is 1e-4 K a
# point). A difference's truncation and the mixed layers' switches that
# its points cross grow with the step, its roundoff shrinks: on the CPU
# at 241^2 x 3 (25 x 97 atmosphere) 1e-3, 1e-2, 1e-1 and 1 K read
# 5.4e-8, 2.3e-9, 5.4e-12 and 4.1e-4; on the card at full width 1e-2 K
# read 9.4e-6
COUPLED_FD_EPS = (1e-2, 1e-3, 1e-4)
COUPLED_FD_RTOL = 1e-5


def coupled_objective(model):
    """Phase 21's objective of a final (ocean, atmosphere): qgcm_tpu's
    coupled adjoint's, mean(ast^2) of the atmosphere
    (tests/test_adjoint.py:157-190), plus layer1_energy_proxy of the
    ocean."""
    from qgcm_torch.adjoint import layer1_energy_proxy
    proxy = layer1_energy_proxy(model)

    def loss(ocean, atmos):
        return torch.mean(torch.square(atmos.ast)) + proxy(ocean)

    return loss


def coupled_adjoint_case(dev):
    """(model, ocean, atmosphere) of phase 21: double_gyre_coupled at full
    width in float64, the ocean an eddy over the radiative balance's
    SST, the atmosphere the radiative balance (qgcm_tpu's test's
    start)."""
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.generators import eddy_pressure
    from qgcm_torch.model import build_model
    from qgcm_torch.models.atmos import init_atmos_state
    from qgcm_torch.models.ocean import init_ocean_state
    model = build_model(double_gyre_coupled(dtype="float64"), dev)
    oc = init_ocean_state(model, init="rbal",
                          po=eddy_pressure(model.cfg, ssh_amp=0.1))
    return model, oc, init_atmos_state(model, init="rbal")


def coupled_value_and_grad(model, run, ocean, atmos, n, mesh=None,
                           marks=None):
    """(value, d/d ocean0, d/d atmos0) of coupled_objective after n
    atmosphere steps of the coupled runner `run`, every field of both
    initial states a leaf. With `mesh` the states are this rank's blocks
    (the atmosphere's on atmos_mesh) and `run` a mesh runner: the final
    states are gathered, the loss seeded on rank 0 alone and the
    replicated leaves' gradients summed over the ranks by one
    all_reduce, as adjoint.ocean_sensitivity does. `marks` gets the
    time, qgstep's launches and the staged bytes at the forward's
    end."""
    from qgcm_torch.ops.qgstep import qgstep
    from qgcm_torch.parallel.mesh import (atmos_mesh, gather_tree,
                                          replicated)
    lo = type(ocean)(*(t.detach().clone().requires_grad_()
                       for t in ocean))
    la = type(atmos)(*(t.detach().clone().requires_grad_()
                       for t in atmos))
    with torch.enable_grad():
        o, a = run(lo, la, n)
        if marks is not None:
            torch.cuda.synchronize()
            marks.update(t=time.perf_counter(),
                         launches=dict(qgstep.mode_launches),
                         staged=0 if mesh is None else mesh.staged_bytes)
        if mesh is not None:
            o, a = gather_tree(o, mesh), gather_tree(
                a, atmos_mesh(mesh, model.cfg))
        val = coupled_objective(model)(o, a)
        seed = (torch.ones_like(val) if mesh is None or mesh.rank == 0
                else torch.zeros_like(val))
        g = torch.autograd.grad(val, [*lo, *la], seed, allow_unused=True)
    g = [torch.zeros_like(x) if d is None else d for d, x in zip(g, [*lo,
                                                                     *la])]
    go, ga = type(ocean)(*g[:len(lo)]), type(atmos)(*g[len(lo):])
    if mesh is not None:
        rep = [(t, k) for t in (go, ga) for k, v in t._asdict().items()
               if replicated(v)]
        parts = [getattr(t, k) for t, k in rep]
        tot = mesh.all_reduce(torch.cat([v.reshape(-1) for v in parts]),
                              "chip_smoke.sums")
        sums = iter(v.view_as(x) for v, x in zip(
            tot.split([x.numel() for x in parts]), parts))
        go = go._replace(**{k: next(sums) for t, k in rep if t is go})
        ga = ga._replace(**{k: next(sums) for t, k in rep if t is ga})
    return val.detach(), go, ga


def sst_direction(cfg, dev):
    """Phase 21's seeded direction of the initial SST (a unit normal a
    point), the same on every rank."""
    gen = torch.Generator(device=dev).manual_seed(21)
    return torch.randn((cfg.nyto, cfg.nxto), generator=gen, device=dev,
                       dtype=torch.float64)


def _coupled_adjoint_rank(file, meshes, cycles):
    """What each rank of phase 21 runs: on each (my, mx) mesh, a warm-up
    gradient of one cycle, then coupled_value_and_grad through
    make_coupled_runner(mesh, remat=True, 'overlap', 'a2a') over
    `cycles` cycles from the state in `file`, the forward and backward
    timed apart, qgstep's launches by mode in each, the bytes staged
    through the host in each and the peak memory; the largest magnitude
    of d/d(initial SST) (sst and sstm) on the rank's own points, the
    fingerprints of the replicated gradients; rank 0 adds d/dsst and
    d/dpo gathered whole. (The gradient by the initial atmosphere is NaN
    at this width, on the single device alike: the drag's square root
    (coupling.make_xforc's quad_drag) has an infinite derivative where
    the wind is zero or so weak that its argument rounds to zero, as
    from rest, and qgcm_tpu's is the same formula.) On the rows mesh the primal at the initial
    SST +- each of COUPLED_FD_EPS along sst_direction, by the mesh
    runner."""
    import torch.distributed as dist
    from qgcm_torch.config import double_gyre_coupled
    from qgcm_torch.model import build_model
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from qgcm_torch.parallel.mesh import (Mesh, atmos_mesh, gather,
                                          gather_tree, replicated, shard,
                                          shard_tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    dist.barrier()          # NCCL sets up its communicator here
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(file, weights_only=False)
    model = build_model(double_gyre_coupled(dtype="float64"), dev)
    cfg = model.cfg
    oc = type(saved["ocean"])(*(t.to(dev) for t in saved["ocean"]))
    at = type(saved["atmos"])(*(t.to(dev) for t in saved["atmos"]))
    n = cycles * cfg.nstr
    out = []
    for shape in meshes:
        mesh = Mesh(shape, grid=(cfg.nypo, cfg.nxpo))
        amesh = atmos_mesh(mesh, cfg)
        kw = dict(mesh=mesh, halo_variant="overlap", spectral_variant="a2a")
        run = make_coupled_runner(model, remat=True, **kw)
        ob, ab = shard_tree(oc, mesh), shard_tree(at, amesh)
        coupled_value_and_grad(model, run, ob, ab, cfg.nstr, mesh)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        mesh.counts.clear()
        mesh.staged_bytes = 0
        marks = {}
        t0 = time.perf_counter()
        val, go, ga = coupled_value_and_grad(model, run, ob, ab, n, mesh,
                                             marks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = dict(mesh=list(shape), value=float(val),
                   fwd_launches=marks["launches"],
                   all_launches=dict(qgstep.mode_launches),
                   fwd_ms=(marks["t"] - t0) * 1e3 / cycles,
                   bwd_ms=(t1 - marks["t"]) * 1e3 / cycles,
                   fwd_mb=marks["staged"] / cycles / 1e6,
                   bwd_mb=(mesh.staged_bytes - marks["staged"]) / cycles
                   / 1e6,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   counts=dict(mesh.counts),
                   replicated_fp=[fingerprint(v) for t in (go, ga)
                                  for v in t if replicated(v)])
        dsst = go.sst + go.sstm
        nr = max(0, min(mesh.by, cfg.nyto - mesh.iy * mesh.by))
        nc = (dsst.shape[-1] if mesh.mx == 1 else
              max(0, min(mesh.bx, cfg.nxto - mesh.ix * mesh.bx)))
        res["sst_block_max"] = dsst[:nr, :nc].abs().max().item()
        whole = dict(sst=gather(dsst, mesh, True, True, site="test"),
                     po=gather(go.po, mesh, site="test"))
        if rank == 0:
            res["grads"] = {k: v.cpu() for k, v in whole.items()}
        del go, ga, whole
        if shape[1] == 1:
            plain = make_coupled_runner(model, **kw)
            db = shard(sst_direction(cfg, dev), mesh)
            obj = coupled_objective(model)

            def primal(a):
                with torch.no_grad():
                    o, a_ = plain(ob._replace(sst=ob.sst + a * db,
                                              sstm=ob.sstm + a * db), ab, n)
                    return float(obj(gather_tree(o, mesh),
                                     gather_tree(a_, amesh)))

            res["fd"] = [(primal(eps) - primal(-eps)) / (2 * eps)
                         for eps in COUPLED_FD_EPS]
        out.append(res)
        del ob, ab
        torch.cuda.empty_cache()
    return out


def phase_coupled_adjoint_mesh(card, device):
    """The coupled model's distributed adjoint in MESH_RANKS ranks
    (mesh_backend): double_gyre_coupled at full width in float64 (961^2
    x 3 ocean, 385 x 97 x 3 atmosphere), COUPLED_ADJOINT_CYCLES cycles,
    remat=True, 'overlap', on 4x1 and 2x2, the atmosphere on row blocks:
    coupled_objective's gradient by every field of both initial states,
    against the single-device gradient on the card from the same state:
    the value the same bits on every rank and within MESH_F64_TOL of the
    single device's, d/d(initial SST) and d/dpo gathered within
    MESH_F64_TOL of each field's maximum, the replicated gradients the
    same bits on every rank, every rank's block of d/dsst nonzero; on
    the rows mesh the directional derivative along a seeded SST
    direction against a central difference (COUPLED_FD_RTOL). Prints per
    mesh the window launches forward and with the recomputation, the
    host ms per rank-cycle forward and backward, the MB staged and the
    peak GB per rank. Returns (the kernels line's launch counts by mode,
    the paths' entries)."""
    import shutil
    from pathlib import Path
    from qgcm_torch.models.stepper import make_coupled_runner
    from qgcm_torch.ops.qgstep import qgstep, reset_launches
    from qgcm_torch.parallel.launch import spawn_ranks

    root = Path(__file__).resolve().parent
    work = root / MESH21_WORKDIR
    shutil.rmtree(work, ignore_errors=True)
    (work / "ranks").mkdir(parents=True)
    model, oc, at = coupled_adjoint_case(device)
    cfg = model.cfg
    cycles = COUPLED_ADJOINT_CYCLES
    run = make_coupled_runner(model, remat=True)
    coupled_value_and_grad(model, run, oc, at, cfg.nstr)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    marks = {}
    t0 = time.perf_counter()
    val, go, ga = coupled_value_and_grad(model, run, oc, at,
                                         cycles * cfg.nstr, marks=marks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    print(f"  single device: value {float(val):.12e}; forward "
          f"{(marks['t'] - t0) * 1e3 / cycles:.2f}, backward "
          f"{(t1 - marks['t']) * 1e3 / cycles:.2f} ms/cycle; full-field "
          f"launches forward {marks['launches']['full']}, with the "
          f"recomputation {qgstep.mode_launches['full']}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
    want = dict(sst=(go.sst + go.sstm).cpu(), po=go.po.cpu())
    direction = sst_direction(cfg, device).cpu()
    file = work / "state.pt"
    torch.save(dict(ocean=to_host(oc), atmos=to_host(at)), file)
    del model, oc, at, go, ga, run
    torch.cuda.empty_cache()
    backend, label = mesh_backend()
    t0 = time.perf_counter()
    results = spawn_ranks(_coupled_adjoint_rank, MESH_RANKS, str(file),
                          list(COUPLED_ADJOINT_MESHES), cycles,
                          backend=backend, workdir=work / "ranks",
                          timeout=600)
    print(f"  {label}: {time.perf_counter() - t0:.1f} s with start-up "
          f"[{card}]")
    totals = {"rows": 0, "x_ext": 0, "full": 0}
    paths = []
    for i, shape in enumerate(COUPLED_ADJOINT_MESHES):
        per_rank = [r[i] for r in results]
        r0 = per_rank[0]
        mesh_s = f"{shape[0]}x{shape[1]}"
        mode = "rows" if shape[1] == 1 else "x_ext"
        errs = {"value": abs(r0["value"] - float(val)) / abs(float(val))}
        errs.update({f"d/d{k}": grad_ratio(r0["grads"][k], w)
                     for k, w in want.items()})
        same = all(p["value"] == r0["value"]
                   and p["replicated_fp"] == r0["replicated_fp"]
                   for p in per_rank[1:])
        fwd = {m: sum(p["fwd_launches"][m] for p in per_rank)
               for m in totals}
        alls = {m: sum(p["all_launches"][m] for p in per_rank)
                for m in totals}
        for m in totals:
            totals[m] += alls[m]
        print(f"  {mesh_s} overlap, remat=True, {cycles} cycles: vs the "
              f"single device (max|diff|/max) "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (bar {MESH_F64_TOL:g}); value and replicated gradients "
              f"the same bits on every rank: {same}")
        print("    each rank's block of d/dsst: max "
              + ", ".join(f"{p['sst_block_max']:.3e}" for p in per_rank))
        print(f"    {mode} launches (all ranks): forward {fwd[mode]}, with "
              f"the backward's recomputation {alls[mode]}; per rank: forward "
              + ", ".join(f"{p['fwd_ms']:.2f}" for p in per_rank)
              + " ms/cycle, backward "
              + ", ".join(f"{p['bwd_ms']:.2f}" for p in per_rank)
              + f" ms/cycle; staged {r0['fwd_mb']:.3f} MB forward, "
              f"{r0['bwd_mb']:.3f} MB backward a rank-cycle (rank 0); peak "
              + ", ".join(f"{p['peak_gb']:.3f}" for p in per_rank)
              + f" GB -- {label} [{card}]")
        print(f"    rank 0's collectives: {r0['counts']}")
        entry = dict(path=f"coupled distributed adjoint {mesh_s} overlap "
                     f"float64 remat=True", launches=alls,
                     forward_launches=fwd, rel_err=max(errs.values()),
                     fwd_ms_per_rank_cycle=r0["fwd_ms"],
                     bwd_ms_per_rank_cycle=r0["bwd_ms"],
                     staged_mb_fwd=r0["fwd_mb"], staged_mb_bwd=r0["bwd_mb"],
                     peak_gb=[p["peak_gb"] for p in per_rank])
        if "fd" in r0:
            adj = float((r0["grads"]["sst"] * direction).sum())
            rels = [abs(adj - fd) / abs(fd) if fd else float("inf")
                    for fd in r0["fd"]]
            print(f"    d/da L(sst + a d): adjoint {adj:.12e}; central "
                  f"differences "
                  + ", ".join(f"{fd:.12e} (step {eps:g} K, rel {r:.3e})"
                              for eps, fd, r in zip(COUPLED_FD_EPS,
                                                    r0["fd"], rels))
                  + f" (bar {COUPLED_FD_RTOL:g} for the best)")
            entry["fd_rel"] = min(rels)
            if not min(rels) <= COUPLED_FD_RTOL:
                raise AssertionError(f"the coupled distributed adjoint on "
                                     f"{mesh_s} misses its finite "
                                     "difference")
        paths.append(entry)
        per_step = 3 if mode == "rows" else 5
        if not (all(v <= MESH_F64_TOL for v in errs.values()) and same
                and all(p["sst_block_max"] > 0 for p in per_rank)):
            raise AssertionError(f"the coupled distributed adjoint on "
                                 f"{mesh_s} misses the single-device "
                                 "gradient")
        if (fwd[mode] != per_step * cycles * MESH_RANKS
                or alls[mode] != 2 * fwd[mode]
                or any(v for m, v in alls.items() if m != mode)):
            raise AssertionError(f"the coupled distributed adjoint on "
                                 f"{mesh_s}: launches {fwd} forward, {alls} "
                                 "in all")
    return totals, paths


def grad_ratio(a, b, scale=None) -> float:
    """max|a - b| over max|b| (or `scale`) of two host tensors."""
    s = b.abs().max().item() if scale is None else scale
    return (a - b).abs().max().item() / s if s else (a - b).abs().max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port is not run on "
              "the CPU", file=sys.stderr)
        return 1
    from qgcm_torch.config import (double_gyre_coupled, k247_default,
                                   southern_ocean_coupled,
                                   southern_ocean_ocean_only)
    from qgcm_torch.ops.qgstep import build_kernel

    device = torch.device("cuda")
    # Full float32 in every matmul: TF32 keeps about three decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    lib = build_kernel()
    print(f"    qgstep kernel: {lib.path.name}, built in {lib.build_s:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"      {line.strip()}")
    for line in sass_census(lib.path):
        print(f"      sass {line}")
    with phase("[2] kernel vs plain chain on the card (small "
               "configurations)"):
        phase_kernel_small(device)
        phase_kernel_ragged()
    with phase("[3] golden ocean box, float64, 50 substeps on the card"):
        phase_golden(device)
    with phase("[4] main path: double_gyre_ocean_only, float32"):
        kernel, main_path = phase_main(device, card)
        # its final state, for phase 19's ranks
        main_file = save_main_state(main_path)
    with phase("[5] the kernel alone against its bound"):
        phase_kernel_timing(card)
    with phase("[6] golden coupled box, float64, 30 steps on the card"):
        phase_golden_coupled(device)
    states = {}       # phases 7 and 8's final states, for phase 18
    with phase("[7] coupled double gyre: double_gyre_coupled, float32"):
        paths = [phase_coupled(device, card, double_gyre_coupled, states)]
    with phase("[8] coupled southern-ocean channel: "
               "southern_ocean_coupled, float32"):
        paths.append(phase_coupled(device, card, southern_ocean_coupled,
                                   states))
    with phase("[9] ocean-only channels: southern_ocean_ocean_only, "
               "k247_default, float32"):
        # paths: [7] double gyre, [8] channel, [9] the two presets
        paths += [phase_channel(device, card, preset)
                  for preset in (southern_ocean_ocean_only, k247_default)]
    with phase("[10] the Driver through the CLI: double_gyre_coupled, "
               "float32, every cadence on"):
        paths.append(phase_driver_coupled(card, paths[0]))
    with phase("[11] the Driver through the CLI: the forced southern-ocean "
               "channel against its committed record"):
        paths.append(phase_driver_channel(card, paths[2]))
    with phase("[12] the kernel's shard modes (row window, x_ext) on the "
               "card"):
        modes = phase_shard_modes(card)
    with phase(f"[13] the rows-mesh ocean-only runner: "
               f"{mesh_backend()[1]}"):
        phase_oml_fork(card)
        totals, mesh_paths = phase_mesh(card, MESH_WORKDIR)
    with phase("[14] the kernel's member mode: one launch for M members"):
        members = phase_member_mode(card)
    with phase(f"[15] ensembles at full width: {ENSEMBLE_MEMBERS} members "
               "of double_gyre_ocean_only, the golden box in float64, "
               f"{COUPLED_MEMBERS} of double_gyre_coupled"):
        kept = {}
        ens_paths = phase_ensemble(card, main_path, device, kept)
    del main_path
    torch.cuda.empty_cache()
    with phase("[16] the adjoint at full width, float64, the kernel in its "
               "forward"):
        adj_paths = phase_adjoint(card, device)
    with phase("[17] the commands: ensemble, analyze, sense, run --profile"):
        phase_commands(card)
    with phase(f"[18] the decomposed coupled model, the Driver and the "
               f"commands on rows meshes: {mesh_backend()[1]}"):
        totals18, mesh_paths18, member_paths = phase_coupled_mesh(
            card, states, kept["members"])
    for mode in totals:
        totals[mode] += totals18[mode]
    mesh_paths += mesh_paths18
    with phase(f"[19] the 2-D runner: the box on (y, x) meshes, "
               f"{mesh_backend()[1]}"):
        totals19, mesh_paths19 = phase_mesh_2d(card, states, main_file)
    for mode in totals:
        totals[mode] += totals19[mode]
    mesh_paths += mesh_paths19
    with phase(f"[20] the distributed adjoint: double_gyre_ocean_only "
               f"float64 on 4x1 and 2x2, {mesh_backend()[1]}"):
        totals20, mesh_paths20 = phase_adjoint_mesh(card, device)
    for mode in totals:
        totals[mode] += totals20[mode]
    mesh_paths += mesh_paths20
    with phase(f"[21] the coupled model's distributed adjoint: "
               f"double_gyre_coupled float64 on 4x1 and 2x2, "
               f"{mesh_backend()[1]}"):
        totals21, mesh_paths21 = phase_coupled_adjoint_mesh(card, device)
    for mode in totals:
        totals[mode] += totals21[mode]
    mesh_paths += mesh_paths21
    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    kernel["paths"] = [dict(path="double_gyre_ocean_only",
                            launches=kernel["launches"],
                            max_abs_err=kernel["max_abs_err"]), *paths,
                       *adj_paths]
    # the member mode's launches: the ensemble path's (phase 15)
    members["launches"] = ens_paths[0]["launches"]
    members["paths"] = ens_paths + member_paths
    for mode in ("rows", "x_ext"):
        modes[mode]["launches"] = totals[mode]
        modes[mode]["paths"] = [
            {**p, "launches": p["launches"][mode]}
            for p in mesh_paths if p["launches"][mode]]
    print(card_line())
    print(json.dumps({"kernels": [kernel, members, modes["rows"],
                                  modes["x_ext"]]}))
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


def compare_main_path(checkouts) -> int:
    """Phase 4 of each checkout in turn, each in a process of its own
    running that checkout's chip_smoke.py and qgcm_torch: for instance a
    parent commit unpacked under build/ and this one, in the order
    parent, this, this, parent. Prints each run's ms/substep (CUDA
    events and host clock) and its wrapper's eager and graph-replayed
    kernel times, read from the phase's own lines."""
    child = ("import sys, torch; import chip_smoke as c; "
             "torch.backends.cuda.matmul.allow_tf32 = False; "
             "torch.backends.cudnn.allow_tf32 = False; "
             "c.phase_main(torch.device('cuda'), c.card_line())")
    pattern = (r"substeps: ([\d.]+) ms/substep \(CUDA events\), ([\d.]+) "
               r"ms/substep \(host clock\).*qgstep kernel ([\d.]+) ms "
               r"\(CUDA-graph replay\), ([\d.]+) ms \(events around eager")
    card = card_line()
    got = run_in_checkouts(checkouts, child, pattern, "phase 4")
    if got is None:
        return 1
    rows = [(where, *map(float, m.groups())) for where, m in got]
    print(f"phase 4 by checkout, in the order run [{card}]:")
    for where, dev, host, kernel, eager in rows:
        print(f"  {where}: {dev:.4f} ms/substep (CUDA events), {host:.4f} "
              f"(host clock); qgstep eager {eager:.4f} ms, graph-replayed "
              f"{kernel:.4f} ms")
    return 0


def device_info() -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] in ("--main-path", "--windows",
                                             "--rank-cycle"):
        # python3 chip_smoke.py --main-path|--windows|--rank-cycle
        # CHECKOUT [...]
        compare = {"--main-path": compare_main_path,
                   "--windows": compare_windows,
                   "--rank-cycle": compare_rank_cycles}[sys.argv[1]]
        sys.exit(compare(sys.argv[2:]) if torch.cuda.is_available() else 1)
    sys.exit(main())
