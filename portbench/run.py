"""Run one cell of the benchmark once and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the card it is started on and nowhere else: without a CUDA device, or with fewer than
the cell asks for, it exits non-zero and prints no result.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced run.  Every build and
kernel cache stays inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "clip_fsar_tpu")


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout, set before anything initializes CUDA."""
    build = os.path.join(CHECKOUT, "build", "portbench")
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench import harness

    bench = harness.benchmark()
    cell = harness.cell_spec(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: cell {args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START, bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
