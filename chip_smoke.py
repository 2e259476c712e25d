#!/usr/bin/env python3
"""Smoke run of the PyTorch port (qgcm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from qgcm_torch/csrc with nvcc, holds it
against its plain PyTorch version on the card, reproduces the ocean
golden run in float64 on the card, then drives the main path -- the
ocean-only double-gyre box, 961x961 p-points x 3 layers in float32 --
through the public entry points, times it and profiles a few substeps
of it. Every phase raises on a failure; nothing runs on the CPU. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists each kernel
with its launch count on the main path, its error against the plain
version and both times.

Needs one CUDA device. Imports neither JAX nor qgcm_tpu.
"""

from __future__ import annotations

import json
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
# where the main path's profiler trace is written (the kernel's build
# directory, listed in .gitignore)
TRACE = "build/qgcm_torch/main_path_trace.json"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, CUDA
    events, after two warm-up calls."""
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


def profile_substeps(run, st, f, step0, card):
    """Profile PROFILE_STEPS substeps of the main path with torch.profiler
    and print, all from that one run: the host-clock ms/substep with the
    profiler on, the device-busy ms/substep (the union of the card's
    kernel, memcpy and memset intervals in the trace), the idle share
    1 - busy/host, and the device time by kernel name. Only the card's
    activity is traced: host-side op records would slow the host, which
    sets the pace of the substep, and so inflate the idle share."""
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        run(st, f, PROFILE_STEPS, step0=step0)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / PROFILE_STEPS
    trace = Path(__file__).resolve().parent / TRACE
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    print(f"  profile of {PROFILE_STEPS} substeps: host clock "
          f"{host_ms:.4f} ms/substep with the profiler on [{card}]")
    if not events:
        print("  device busy: not measured (no device activity in the "
              "profiler's trace)")
        return
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3 / PROFILE_STEPS
    print(f"  device busy {busy_ms:.4f} ms/substep in {len(events)} device "
          f"activities; idle share 1 - busy/host = "
          f"{1 - busy_ms / host_ms:.4f}")
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3 / PROFILE_STEPS:8.4f} ms/substep "
              f"{100 * us / 1e3 / PROFILE_STEPS / busy_ms:5.1f}%  "
              f"{name[:90]}")


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


def phase_golden(device):
    """tests/test_golden.py::test_golden_ocean_only_box on the card."""
    from qgcm_torch.config import ModelConfig, OceanConfig
    from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep
    cfg = ModelConfig(nxta=24, nyta=24, nxaooc=16, nyaooc=8, ndxr=2,
                      fnot=9.37456e-5, beta=1.7536e-11, dta=200.0, nstr=3,
                      ocean=OceanConfig(nlo=3, dxo=25.0e3, delek=2.0,
                                        hoc=(350.0, 750.0, 2900.0),
                                        gpoc=(0.015, 0.0075),
                                        tabsoc=(287.0, 282.0, 276.0),
                                        ah2oc=(0.0, 0.0, 0.0),
                                        ah4oc=(2e12, 2e12, 2e12)),
                      ocean_only=True)
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
    ocean_forcing_from_mean -> make_ocean_only_runner, float32."""
    from qgcm_torch.config import double_gyre_ocean_only, ml_f64_enabled
    from qgcm_torch.generators import eddy_pressure, double_gyre_windstress
    from qgcm_torch.model import build_model
    from qgcm_torch.models.ocean import (init_ocean_state,
                                         ocean_forcing_from_mean)
    from qgcm_torch.models.stepper import make_ocean_only_runner
    from qgcm_torch.ops.qgstep import qgstep, qgstep_reference
    from qgcm_torch.ops.vorticity import qcomp

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

    dxom2 = 1.0 / model.grids.dxo**2
    q_re = qcomp(st.po, model.amat, model.yporel, dxom2, cfg.fnot, cfg.beta,
                 model.ddyn, cfg.nlo - 1, cyclic=False)
    rt = ((st.qo - q_re)[:, 1:-1, 1:-1].abs().max()
          / st.qo.abs().max()).item()
    print(f"  inversion round trip max|qcomp(po) - qo| / max|qo| = {rt:.3e} "
          f"(bar {ROUND_TRIP_TOL:g})")
    if not rt <= ROUND_TRIP_TOL:
        raise AssertionError("qcomp(po) does not reproduce qo")
    profile_substeps(run, st, f, WARMUP_STEPS + MAIN_STEPS, card)

    args = kernel_inputs(model, st, f, cyclic=False)
    err, scale = compare(args, cyclic=False, sponge=False)
    print(f"  kernel vs plain at {tuple(st.po.shape)} float32: max|dq| = "
          f"{err:.3e} = {err / scale:.3e} max|q| (bar {F32_TOL:g})")
    if not err <= F32_TOL * scale:
        raise AssertionError("kernel disagrees with the plain chain at the "
                             "main path's shape")
    k_ms = cuda_ms(lambda: qgstep(*args, cyclic=False, sponge=False), 100)
    p_ms = cuda_ms(lambda: qgstep_reference(*args, cyclic=False,
                                            sponge=False), 20)
    print(f"  qgstep kernel {k_ms:.4f} ms, plain chain {p_ms:.4f} ms "
          f"[{card}]")
    return dict(name="qgstep", route="cuda",
                source="qgcm_torch/csrc/qgstep.cu",
                replaces="qgcm_tpu/ops/pallas_qg.py:277",
                launches=launches, max_abs_err=err, ms=k_ms, plain_ms=p_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port is not run on "
              "the CPU", file=sys.stderr)
        return 1
    from qgcm_torch.ops.qgstep import build_kernel

    device = torch.device("cuda")
    # Full float32 in every matmul: TF32 keeps about three decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    lib = build_kernel()
    print(f"    qgstep kernel: {lib.path.name}, built in {lib.build_s:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"      {line.strip()}")

    print("[2] kernel vs plain chain on the card (small configurations)")
    phase_kernel_small(device)
    print("[3] golden ocean box, float64, 50 substeps on the card")
    phase_golden(device)
    print("[4] main path: double_gyre_ocean_only, float32")
    kernel = phase_main(device, card)

    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
