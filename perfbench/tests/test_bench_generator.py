"""The frozen generator: fixed hashes, the smoke run's generator, and a
pool whose sizes do not depend on the seed."""
import hashlib
import json
import os

import numpy as np

import gen

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sha(recs) -> str:
    h = hashlib.sha256()
    for name, s, *rest in recs:
        h.update(f"{name}\t{s}\t{rest}\n".encode())
    return h.hexdigest()[:16]


def test_make_proteins_is_frozen():
    assert _sha(gen.make_proteins(60, 15, seed=0)) == "55e2c88eeaf3fed4"
    assert _sha(gen.make_proteins(60, 15, seed=2**40 + 7)) == "85cbdfed056d93a1"
    assert _sha(gen.make_db(dict(sequences=60, families=15, size_seed=2500),
                            2**40 + 7)) == "e86edab85ecabe01"


def test_make_proteins_is_the_smoke_runs_generator():
    import chip_smoke

    for seed in (0, 3):
        assert gen.make_proteins(80, 20, seed) == chip_smoke.make_proteins(
            80, 20, seed)


def test_pool_is_frozen_and_its_sizes_do_not_follow_the_seed():
    with open(os.path.join(BENCH, "traffic", "q8.json")) as f:
        traffic = json.load(f)
    traffic["pool_requests"] = 5
    db = gen.make_proteins(200, 50, seed=1)
    pool = gen.make_pool(db, traffic, seed=11)
    assert _sha([q for req in pool for q in req]) == "baedab7fcfc46e87"
    other = gen.make_pool(gen.make_proteins(200, 50, seed=2), traffic, seed=12)
    lens = [[len(q[1]) for q in req] for req in pool]
    lens2 = [[len(q[1]) for q in req] for req in other]
    related = [[q[2] >= 0 for q in req] for req in pool]
    assert related == [[q[2] >= 0 for q in req] for req in other]
    # a related query is cut to its drawn length unless no root reaches it
    want, rel = gen.query_sizes(traffic)
    assert np.mean(np.array(lens) == want) > 0.9
    assert np.mean(np.array(lens2) == want) > 0.9
    assert np.array_equal(np.array(related), rel)
    assert len(pool) == traffic["pool_requests"] + 1


def test_split_seed_takes_large_seeds():
    a = gen.split_seed(2**40 + 3, 3)
    assert a == gen.split_seed(2**40 + 3, 3)
    assert a != gen.split_seed(2**40 + 4, 3)
    assert len(set(a)) == 3


def test_make_reads_is_the_smoke_runs_generator():
    import chip_smoke

    prots = gen.make_proteins(40, 10, seed=5)
    for seed in (0, 2**40 + 1):
        assert gen.make_reads(prots, 12, 200, 900, 4.0, 0.02, seed) == \
            chip_smoke.make_reads(prots, 12, 200, 900, 4.0, 0.02, seed)


def test_make_db_fixes_every_size_by_its_size_seed():
    spec = dict(sequences=120, families=30, size_seed=9)
    a, b = gen.make_db(spec, 1), gen.make_db(spec, 2**40 + 2)
    assert [n for n, _ in a] == [n for n, _ in b]
    assert [len(s) for _, s in a] == [len(s) for _, s in b]
    assert [s for _, s in a] != [s for _, s in b]
    c = gen.make_db(dict(spec, size_seed=10), 1)
    assert [len(s) for _, s in a] != [len(s) for _, s in c]


def test_pool_structure_follows_the_size_seed_only():
    with open(os.path.join(BENCH, "traffic", "q8.json")) as f:
        traffic = json.load(f)
    traffic["pool_requests"] = 6
    spec = dict(sequences=200, families=50, size_seed=4)
    p1 = gen.make_pool(gen.make_db(spec, 1), traffic, seed=11)
    p2 = gen.make_pool(gen.make_db(spec, 2), traffic, seed=2**40 + 12)
    assert [[(q[0], len(q[1]), q[2]) for q in r] for r in p1] == \
        [[(q[0], len(q[1]), q[2]) for q in r] for r in p2]
    assert [q[1] for r in p1 for q in r] != [q[1] for r in p2 for q in r]


def test_pool_of_reads():
    with open(os.path.join(BENCH, "traffic", "q8.json")) as f:
        traffic = json.load(f)
    traffic.update(pool_requests=3, queries="reads", read_length=[300, 600],
                   indels_per_kb=2.0, subst=0.01)
    db = gen.make_db(dict(sequences=200, families=50, size_seed=4), 1)
    pool = gen.make_pool(db, traffic, seed=3)
    reads = [q for r in pool for q in r]
    assert len(reads) == 4 * traffic["queries_per_request"]
    assert all(set(s) <= set("ACGT") for _, s, _ in reads)
    # a read is its length give or take its indels
    assert all(280 <= len(s) <= 620 for _, s, _ in reads)
    for name, _, fam in reads:
        assert (gen.family_of(name) == fam) if fam >= 0 else \
            name.endswith("_none")
