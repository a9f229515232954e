"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Needs as many CUDA cards as the cell asks for and fails without them; it
never falls back to the CPU.  The result line is one JSON object; the
numbers the check compared, each with its limit, are the last lines on
standard error and the line's last key.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds (the program keeps its own kernel build in
# kubeadmiral_tpu_torch/_build/, also inside the checkout).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(CHECKOUT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Modules that must not be loaded in the process that prints the result,
# by whole top-level name (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeadmiral_tpu")
PROGRAM = "kubeadmiral_tpu_torch"


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    loaded ones)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The program under test is the checkout's own, never an installed copy.
    found = importlib.util.find_spec(PROGRAM)
    here = os.path.realpath(os.path.join(CHECKOUT, PROGRAM, "__init__.py"))
    if found is None or os.path.realpath(found.origin or "") != here:
        where = "nowhere" if found is None else found.origin
        print(f"{PROGRAM} is not this checkout's (found {where})", file=sys.stderr)
        return 1

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    loaded = forbidden_loaded()
    if loaded:
        print(f"loaded in the result's process: {', '.join(loaded)}", file=sys.stderr)
        return 1
    checks = out["checks"]
    for name, c in checks.items():
        bound = f"limit {c['limit']}" if "limit" in c else f"min {c['min']}"
        print(f"{name} {c['value']} {bound}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The port's dispatch ledger keeps a daemon thread that waits on CUDA
    # events; ending here skips the interpreter's teardown, which a
    # daemon thread inside a CUDA call can abort.
    os._exit(code)
