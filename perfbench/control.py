#!/usr/bin/env python3
"""The control of a cell: its run with the judged hits rescored by the
plain reference in 8-bit saturating arithmetic and written in the
program's place (``judge.judge(control=True)``); it has to come out not
correct.  On the card, at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seconds <s> SEED...

Prints one line per seed: the seed, ``correct`` and the compared numbers.
Exits 1 if any seed's control reads correct.
"""
import argparse
import json
import sys

import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", default="5")
    ap.add_argument("seeds", nargs="+")
    args = ap.parse_args(argv)
    bad = 0
    for seed in args.seeds:
        result, checks = run.run(["--workload", args.workload, "--seed", seed,
                                  "--seconds", args.seconds], control=True)
        print(json.dumps(dict(seed=int(seed), correct=result["correct"],
                              checks=checks)))
        bad += bool(result["correct"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
