"""The readings that a cell's limits of ``correct`` are set from (PERF.md
gives them): in one process, the program's sound runs over many seeds (the
lower reading of each number) and the control, the reference in bfloat16 put
in the program's place (the upper reading), at the cell's own size.

    python3 -m rtbench.readings --workload <name> --seeds 1 2 3 ... \
        --control-seeds 101 102 103 [--seconds 3] [--out readings.jsonl]

Each program reading is a short run of the cell (``harness.run_cell``: its
window at the cell's load, then the reference on the sample of items the
seed draws); each control reading judges the reference's bfloat16 outputs of
as many items as a run checks.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import check, generator, harness


def control_numbers(workload: str, seed: int, device) -> dict:
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], workload, "workload")
    config = harness.load_config(cell["config"])
    traffic = generator.load_traffic(cell["traffic"])
    loop = traffic["loop"]
    mode = config[loop]
    inputs = generator.Inputs(seed, traffic, check.camera_basis(config, mode))
    items = list(range(int(traffic["check_items"])))
    outs = list(check.reference_outputs(items, loop, config, mode, inputs, device, torch.bfloat16))
    return check.judge(outs, loop, config, mode, inputs, device, check.load_limits(workload))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rtbench.readings: no CUDA device")
    dev = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        nums = {}
        r = harness.run_cell(args.workload, seed, args.seconds, False, dev, time.perf_counter(), numbers=nums)
        lines.append({"workload": args.workload, "side": "program", "seed": seed, "correct": r["correct"],
                      "attempted": r["attempted"], "failed": r["failed"], "numbers": nums, "metrics": r["metrics"]})
        print(json.dumps(lines[-1]), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, seed, dev)
        lines.append({"workload": args.workload, "side": "control-bfloat16", "seed": seed, "numbers": nums,
                      "seconds": time.perf_counter() - t0})
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
