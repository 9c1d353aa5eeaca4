"""The readings that a cell's limits are set from: the program's on
many seeds, and its control's, in one process on the card.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, the cell's window of ``--seconds`` runs as a benchmark
run makes it, and its outputs are judged by the plain reference: the
largest reading of each number compared.  The control is the
configuration's ``control``, ``{"round": <dtype>}``: the same outputs
rounded to that lower precision, judged alike.  Prints one JSON line
per seed; the benchmark's own runs never run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None, device=None, overrides=None):
    import argparse
    import json

    import torch

    from portbench import harness, program

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    wl, cfg, mix, limits = harness.cell(bench, args.workload, overrides)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    kind = mix["kind"]
    lower = getattr(torch, cfg["control"]["round"])
    prog = program.Program(cfg, device)
    harness.warm_up(prog, mix, args.seeds[0])
    for seed in args.seeds:
        spans = program.Spans(device)
        raw, t0, t1 = harness.window(prog, mix, seed, args.seconds, spans)
        run = harness.Run()
        records, attempted, failed = harness.collect(kind, raw, run)
        del raw
        row = {"workload": args.workload, "seed": seed,
               "program": harness.readings(cfg, kind, records),
               "control": harness.readings(cfg, kind, records, lower),
               "attempted": attempted, "failed": failed,
               "window_s": (t1 - t0) / 1e9}
        row["limits"] = limits
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
