"""Time the left-most filter's seed-partition table against its inline key
recompute, over one seeded self-search's stage 1/2 pass.

The table is forced on (search/pipeline.PAIRS_PER_LETTER = 0), and every
call of the fused native pass (native.stage12_pipeline_native) runs twice
on the same slice of the join, with the shape's table and without it, the
order turning each call; the rows must be equal.  The table's build is
timed; extension is skipped.  The search runs ``--repeats`` times, each
repeat starting with the other order.  Prints one JSON line a repeat: the
candidate pairs, the target letters swept, the pass's seconds with and
without the table, the builds' seconds, and the pairs a letter at which the
table pays (``break_even``, null where it saves nothing); then one line of
the repeats' break-evens.

    python3 tools/part_table_ab.py --db bench --seed 7 --repeats 3
    python3 tools/part_table_ab.py --db families --families 150 --seed 7

``bench`` is the benchmark's database (perfbench/configs/blastp-default.json)
searched against itself at default sensitivity; ``families`` the same number
of proteins in ``--families`` families, a block more repetitive the fewer
the families.  On a host without a card, set DIAMOND_TPU_TORCH_DEVICE=cpu.
"""
import argparse
import inspect
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "perfbench")]

import gen  # noqa: E402  (perfbench/gen.py)

from diamond_tpu_torch import cli, native  # noqa: E402
from diamond_tpu_torch.search import pipeline  # noqa: E402
from diamond_tpu_torch.utils import log  # noqa: E402

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", choices=("bench", "families"), default="bench")
    ap.add_argument("--families", type=int, default=150)
    ap.add_argument("--sequences", type=int, default=None,
                    help="fewer proteins than the benchmark's, for a small run")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--repeats", type=int, default=3)
    a = ap.parse_args(argv)

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "blastp-default.json")) as f:
        conf = json.load(f)
    spec = dict(conf["db"])
    if a.sequences:
        spec["sequences"] = a.sequences
    if a.db == "families":
        spec["families"] = a.families
    prots = gen.make_db(spec, a.seed)

    took, calls, swept = {}, [0], [0]
    real_pass = native.stage12_pipeline_native
    real_table = native.seed_part_table_native
    sig = inspect.signature(real_pass)

    def table(letters, *rest):
        t0 = time.perf_counter()
        out = real_table(letters, *rest)
        took["table"] += time.perf_counter() - t0
        swept[0] += len(letters)
        return out

    def run(bound, tbl, stats):
        bound.arguments.update(part_tbl=tbl, stats_out=stats)
        t0 = time.perf_counter()
        m = real_pass(*bound.args, **bound.kwargs)
        dt = time.perf_counter() - t0
        return m, bound.arguments["out_rows"][:m].copy(), dt

    def ab(*args, **kw):
        bound = sig.bind(*args, **kw)
        tbl = bound.arguments.get("part_tbl")
        stats = bound.arguments.get("stats_out")
        order = (tbl, None) if calls[0] % 2 == 0 else (None, tbl)
        calls[0] += 1
        res = [run(bound, t, stats if i == 0 else None)
               for i, t in enumerate(order)]
        assert res[0][0] == res[1][0] and (res[0][1] == res[1][1]).all(), \
            "rows differ with and without the table"
        for t, r in zip(order, res):
            took["with" if t is not None else "without"] += r[2]
        # the caller reads the rows from its buffer: leave the last run's
        # (equal) rows there
        return res[-1][0]

    native.stage12_pipeline_native = ab
    native.seed_part_table_native = table
    pipeline.PAIRS_PER_LETTER = 0
    pipeline.Pipeline._extend_all = lambda self, hits: {}
    log.enable(True)

    evens = []
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "db.faa")
        gen.write_fasta(fa, prots)
        for rep in range(a.repeats):
            took.update({"with": 0.0, "without": 0.0, "table": 0.0})
            calls[0], swept[0] = rep % 2, 0
            before = int(log.prof_calls["seed.s12_pairs"])
            t0 = time.perf_counter()
            cli.main(["blastp", "-q", fa, "-d", fa, "-o",
                      os.path.join(d, "out.tsv")] + conf["args"])
            wall = time.perf_counter() - t0
            pairs = int(log.prof_calls["seed.s12_pairs"]) - before
            saved = took["without"] - took["with"]
            per_letter = took["table"] / max(swept[0], 1)
            per_pair = saved / max(pairs, 1)
            even = per_letter / per_pair if per_pair > 0 else None
            evens.append(even)
            print(json.dumps({
                "db": a.db, "sequences": len(prots),
                "families": int(spec["families"]), "seed": a.seed,
                "repeat": rep, "first": "with" if rep % 2 == 0 else "without",
                "letters": int(sum(len(s) for _, s in prots)),
                "pairs": pairs, "pass_calls": calls[0] - rep % 2,
                "letters_swept": swept[0],
                "pairs_per_letter": pairs / max(swept[0], 1),
                "pass_s_with": took["with"],
                "pass_s_without": took["without"],
                "table_s": took["table"], "saved_s": saved,
                "break_even": even, "wall_s": wall}), flush=True)
    print(json.dumps({"db": a.db, "families": int(spec["families"]),
                      "seed": a.seed, "break_evens": evens}))


if __name__ == "__main__":
    main()
