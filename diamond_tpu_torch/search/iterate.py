"""Iterated search (--iterate): rounds of increasing sensitivity; queries
aligned in an earlier round are skipped in later ones.

Reference: src/search/setup.cpp:56-68 (iterated_sens round table),
src/run/config.cpp:62-106 (round list construction from --iterate),
src/run/double_indexed.cpp:453-500 (round loop, query_aligned tracking,
query_skip), setup.cpp:377-382 (linearized rounds force extension mode
FULL via lin_stage1_target).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from diamond_tpu_torch.search.config import SENS_RANK, SearchConfig

# reference setup.cpp:56-68; (sensitivity, linearize) per round, excluding
# the always-prepended (FASTER, lin) and the final target round
ITERATED_SENS = {
    "faster": [],
    "fast": [("fast", True)],
    "default": [("fast", True), ("linclust-40", True)],
    "linclust-40": [("fast", True), ("linclust-40", True)],
    "linclust-20": [("fast", True), ("linclust-20", True)],
    "shapes-30x10": [("fast", True), ("shapes-30x10", True)],
    "mid-sensitive": [("fast", True), ("linclust-40", True),
                      ("default", False)],
    "sensitive": [("fast", True), ("linclust-20", True), ("default", False)],
    "more-sensitive": [("fast", True), ("linclust-20", True),
                       ("default", False)],
    "very-sensitive": [("fast", True), ("linclust-20", True),
                       ("default", False), ("more-sensitive", False)],
    "ultra-sensitive": [("fast", True), ("linclust-20", True),
                        ("default", False), ("more-sensitive", False)],
}


def rounds_for(sensitivity: str, iterate: list | None):
    """Round list (sensitivity, linearize) (reference run/config.cpp:62-92).

    iterate: None = no iteration; [] = --iterate with no args (default
    cascade); else explicit round names, '_lin' suffix = linearized."""
    if iterate is None:
        return [(sensitivity, False)]
    if not iterate:
        rounds = [("faster", True)] + list(ITERATED_SENS[sensitivity])
    else:
        rounds = []
        target_rank = SENS_RANK[sensitivity]
        for s in iterate:
            lin = s.endswith("_lin")
            name = s[:-4] if lin else s
            if name not in SENS_RANK:
                raise ValueError(f"Invalid sensitivity for --iterate: {s}")
            if SENS_RANK[name] >= target_rank:
                raise ValueError("Sensitivity levels set for --iterate must "
                                 "be below target sensitivity.")
            rounds.append((name, lin))
    if not rounds or rounds[-1] != (sensitivity, False):
        rounds.append((sensitivity, False))
    # linearized rounds first, then by sensitivity rank (reference
    # run/config.h:71-73 Round::operator<, config.cpp:91 std::sort)
    rounds.sort(key=lambda r: (not r[1], SENS_RANK[r[0]]))
    if len(set(rounds)) != len(rounds):
        raise ValueError("The same sensitivity level was specified multiple "
                         "times for --iterate.")
    return rounds


def round_config(base: SearchConfig, sens: str, linearize: bool) -> SearchConfig:
    """Immutable per-round config (avoids the reference's global-config
    mutation wart; SURVEY §5.6)."""
    return dataclasses.replace(
        base, sensitivity=sens, lin_stage1_target=linearize, ext=base.ext,
        index_chunks=base._user_index_chunks,
        motif_masking=base._user_motif_masking,
        traits=None, shapes=None, reduction=None)


def iterated_search(base_cfg: SearchConfig, qb, tb, rounds, queries=None):
    """Run the sensitivity cascade; returns merged {query_id: [Match]}.

    A query that aligns (>= 1 match) in a round is skipped afterwards
    (reference double_indexed.cpp:476-496, extend.cpp track_aligned_queries).
    """
    from diamond_tpu_torch.search.pipeline import Pipeline

    contexts = 6 if base_cfg.translated else 1
    n_src = len(queries) if queries is not None else len(qb)
    aligned = np.zeros(n_src, dtype=bool)
    results: dict[int, list] = {}
    for i, (sens, lin) in enumerate(rounds):
        cfg = round_config(base_cfg, sens, lin)
        skip = None
        if i > 0:
            skip = np.repeat(aligned, contexts) if contexts > 1 else aligned.copy()
        # linearized rounds length-sort the target block so the kept seed
        # occurrence is the longest sequence's (reference
        # double_indexed.cpp:112-114)
        if lin:
            tb_round, sorted2orig = tb.length_sorted()
        else:
            tb_round, sorted2orig = tb, None
        pipe = Pipeline(cfg, qb, tb_round, queries=queries, query_skip=skip)
        res = pipe.search()
        for qid, matches in res.items():
            if matches and not aligned[qid]:
                aligned[qid] = True
                if sorted2orig is not None:
                    for m in matches:
                        m.target_block_id = sorted2orig[m.target_block_id]
                results[qid] = matches
        if aligned.all():
            break
    return results
