"""Readings of the correctness check over many seeds in one process: the program's (the lower
readings of each limit), the control's (the reference in the program's place in fp8), a
witness's (the reference in bf16, or the program in float32) and those of the program with a
fault of ``portbench/faults.py`` planted in its timed path.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --runs fp32,fp8,fp32:half_batch --seconds 3

``--runs`` lists the runs made for each seed, each ``<precision>[:<fault>]``; a train cell's
runs of one seed share its float32 reference.  Prints one JSON line of readings a run.  Not part of a benchmark run: the limits in each
cell's ``portbench/workloads/<cell>.json`` are set from what this prints on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--runs", default="fp8", help="comma-separated <precision>[:<fault>]; precision fp32 (the program), fp8 (the control) or bf16 (the reference in bf16)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compute-dtype", default=None, help="run the program at this TPU.COMPUTE_DTYPE (a witness run)")
    ap.add_argument("--dump", default=None, help="write each seed's raw readings (norms by leaf, logits) under this directory")
    args = ap.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    from portbench import faults, harness, inputs

    bench = harness.benchmark()
    cell = harness.cell_spec(bench, args.workload)
    config_file = inputs.load_json("configs", cell["config"])
    kinds = faults.TRAIN if cell["kind"] == "train" else faults.TEST
    runs = [(r.split(":") + [None])[:2] for r in args.runs.split(",")]
    if args.compute_dtype:
        config_file["config"]["TPU"]["COMPUTE_DTYPE"] = args.compute_dtype

    for seed in (int(s) for s in args.seeds.split(",")):
        ref_cache: dict = {}
        for precision, fault in runs:
            readings: dict = {}
            t0 = time.perf_counter()
            result = harness.run_cell(args.workload, seed, args.seconds, False, args.device, bench=bench, config_file=config_file,
                                      precision=precision, fault=kinds[fault] if fault else None, readings_out=readings,
                                      ref_cache=ref_cache)
            raw = readings.pop("raw")
            tag = ".".join([args.workload, precision] + [x for x in (args.compute_dtype, fault) if x] + [str(seed)])
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                with open(os.path.join(args.dump, tag + ".json"), "w") as f:
                    json.dump(raw, f)
            print(json.dumps({"workload": args.workload, "seed": seed, "precision": precision, "compute_dtype": args.compute_dtype,
                              "fault": fault, "correct": result["correct"],
                              "samples_per_s": [m["value"] for k, m in result["metrics"].items() if k.endswith("samples_per_s")],
                              "seconds": time.perf_counter() - t0, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
