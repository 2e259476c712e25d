"""Run one cell of BENCHMARK.json once:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up, then `--seconds` of measured window, then (with --trace 1) a
traced stretch, then the check of the outputs against the plain
reference. The last line of standard output is the result's JSON; the
numbers the check compared, each beside its limit, are the last lines of
standard error. A run needs as many CUDA cards as the cell asks for and
exits with 2, printing no result, without them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "qgcm_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.cell import load_cell, run_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"modules that no run may load: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
