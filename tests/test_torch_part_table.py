"""When stage 1/2 builds the left-most filter's seed-partition table
(``search/pipeline.Pipeline._part_table``): only where a chunk's candidate
pairs x index_chunks reach ``PAIRS_PER_LETTER`` a target letter; else the
left-most filter recomputes each key it checks.  Either way every
``_stage12`` call returns diamond_tpu's rows (its ``Pipeline._stage12`` on
the same records and config, the fused native pass with the table built
whenever the index is chunked), row for row: the table by the rule, forced
on (``PAIRS_PER_LETTER`` 0) and forced off (infinite), on the fused native
pass and on D1's fused pass in its plain version
(``DIAMOND_TPU_TORCH_STAGE12=1`` on the CPU).  The counters
``seed.part_table_letters`` and ``seed.part_inline`` say which the rule took.
"""
import os
import sys

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


# name -> (sequences, families, queries (None: the block against itself),
#          stage 1/2 on the device, whether the rule builds the table)
CASES = {
    # a few queries against a larger block: the query-indexed route, its
    # joins far below the table's break-even
    "query_indexed": (400, 100, 5, False, False),
    # a block of a few large families against itself
    "repetitive": (240, 4, None, False, True),
    # the query-indexed search on D1's route, plain version on the CPU
    "card_route": (400, 100, 5, True, False),
}


def _search(pkg, recs, n_queries, ppl=None):
    """Every _stage12 call's rows of one default-sensitivity search by the
    package ``pkg`` (diamond_tpu_torch, or diamond_tpu, imported here), the
    extension skipped; for the port, PAIRS_PER_LETTER set to ``ppl``.  With
    the search's part-table counters (the port's) and its Pipeline."""
    import importlib

    Block = importlib.import_module(pkg + ".data.block").Block
    pp = importlib.import_module(pkg + ".search.pipeline")
    SearchConfig = importlib.import_module(pkg + ".search.config").SearchConfig
    ScoreMatrix = importlib.import_module(
        pkg + ".stats.score_matrix").ScoreMatrix
    log = importlib.import_module(pkg + ".utils.log")

    calls = []
    real = pp.Pipeline._stage12

    def spy(self, *a, **kw):
        rows = real(self, *a, **kw)
        calls.append(np.asarray(rows).copy())
        return rows

    seqs, ids = [s for _, s in recs], [i for i, _ in recs]
    target = Block.from_sequences(seqs, ids)
    query = (target if n_queries is None else
             Block.from_sequences(seqs[:n_queries], ids[:n_queries]))
    pipe = pp.Pipeline(SearchConfig(matrix=ScoreMatrix("BLOSUM62")), query,
                       target)
    names = ("seed.part_table_letters", "seed.part_inline")
    with pytest.MonkeyPatch.context() as mp:
        if ppl is not None:
            mp.setattr(pp, "PAIRS_PER_LETTER", ppl)
            mp.setattr(log, "_on", True)
        mp.setattr(pp.Pipeline, "_stage12", spy)
        mp.setattr(pp.Pipeline, "_extend_all", lambda self, h: {})
        before = [log.prof_calls[n] for n in names]
        pipe.search()
        counts = {n: log.prof_calls[n] - b for n, b in zip(names, before)}
    return calls, counts, pipe


@pytest.mark.parametrize("case", list(CASES))
def test_part_table_rule_keeps_the_rows(case, monkeypatch):
    from diamond_tpu_torch.search.pipeline import PAIRS_PER_LETTER

    n_seqs, n_fam, n_queries, on_device, builds = CASES[case]
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("DIAMOND_TPU_STAGE12", raising=False)
    if on_device:
        monkeypatch.setenv("DIAMOND_TPU_TORCH_STAGE12", "1")
    else:
        monkeypatch.delenv("DIAMOND_TPU_TORCH_STAGE12", raising=False)
    recs = _smoke().make_proteins(n_seqs=n_seqs, n_families=n_fam, seed=5)
    want, _, ref = _search("diamond_tpu", recs, n_queries)
    assert ref.cfg.index_chunks > 1 and len(want) == \
        len(ref.cfg.shapes) * ref.cfg.index_chunks
    assert sum(len(r) for r in want) > 0
    for ppl in (PAIRS_PER_LETTER, 0, float("inf")):
        got, counts, pipe = _search("diamond_tpu_torch", recs, n_queries, ppl)
        assert pipe._query_indexed == (n_queries is not None)
        n_tbl = len(pipe.t.letters) * len(pipe.cfg.shapes)
        if ppl == 0 or (ppl == PAIRS_PER_LETTER and builds):
            assert counts == {"seed.part_table_letters": n_tbl,
                              "seed.part_inline": 0}, ppl
        else:
            assert counts == {"seed.part_table_letters": 0,
                              "seed.part_inline": len(want)}, ppl
        assert len(got) == len(want), ppl
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(ppl))
