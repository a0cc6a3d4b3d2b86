"""The control of `correct`: the reference put in the program's place with
a compositor that carries each pixel's transmittance and colour front to
back in bfloat16, with its Gaussian in bfloat16 too: the precision below
the float32 that the configurations state for the composite. It has to
come out not correct.

    python3 gswt_bench/control.py --workload <cell> --seeds 11 22 33 [--seconds 3]

Each seed runs the cell's own set-up and a short window at its own load,
then judges the window's frames against the float32 reference. Prints one
JSON line per seed: the compared numbers with their limits and `correct`.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from gswt_bench import harness

    for seed in args.seeds:
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device=args.device, control=True)
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=out["correct"],
                              compared=out["compared"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
