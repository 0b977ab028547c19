"""The benchmark's command: one run of one cell of BENCHMARK.json on the card.

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line, the last on stdout: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``check`` (each number compared, with its limit), which stderr's last lines
repeat.  It exits non-zero and prints no result without a CUDA device (or
with fewer than the cell asks for), and when JAX or the JAX package was
loaded.  Kernel builds stay where the program keeps them, inside the
checkout (``chess2rt_tpu_torch/build/``).
"""

import time

T_START = time.perf_counter()  # before torch is imported: set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import harness

    cell = harness.find(harness.load_benchmark()["workloads"], args.workload, "workload")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: {args.workload} needs {cell['chips']} CUDA device(s), found {have}; no result",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                              T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"rtbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
