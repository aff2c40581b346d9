"""blastx: translated DNA query search.

Queries translate into 6 reading frames (reference src/basic/basic.cpp:44-58
AlignMode blastx: query_contexts=6); each frame is a query context in the
block; alignments report DNA source coordinates through the frame mapping
(reference basic/translated_position.h).
"""
from __future__ import annotations

import numpy as np

from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.data.translate import Translator, find_orfs, min_orf_len
from diamond_tpu_torch.stats.cbs import hauser_bias_i8


class TranslatedQueries:
    """Translated query set: 6 contexts per source sequence."""

    def __init__(self, dna_records, gencode: int = 1, frameshift: int = 0,
                 min_orf: int = 0, strand: str = "both"):
        tr = Translator(gencode)
        self.source_ids = []
        self.dna_lens = []
        ctx_seqs = []
        ctx_ids = []
        for rid, dna in dna_records:
            from diamond_tpu_torch.constants.alphabet import encode

            d = encode(dna.upper() if isinstance(dna, str) else dna.decode().upper(),
                       nucleotide=True)
            frames = tr.translate6(d)
            min_len = min_orf_len(len(frames[0]), run_len=min_orf,
                                  frame_shift=frameshift)
            self.source_ids.append(rid)
            self.dna_lens.append(len(d))
            for fi, f in enumerate(frames):
                # --strand plus/minus restricts to forward (0-2) / reverse
                # (3-5) frames (reference config 'strand', translate.cpp)
                if (strand == "plus" and fi >= 3) or \
                        (strand == "minus" and fi < 3):
                    ctx_seqs.append(np.zeros(0, dtype=np.int8))
                else:
                    ctx_seqs.append(find_orfs(np.array(f, copy=True), min_len))
                ctx_ids.append(rid)
        self.block = Block.from_sequences(ctx_seqs, ctx_ids)

    def __len__(self):
        return len(self.source_ids)

    def contexts(self, source_idx: int):
        """[(frame, letters), ...] for one source query."""
        out = []
        for f in range(6):
            cid = source_idx * 6 + f
            out.append((f, self.block.seq(cid)))
        return out


def blastx_search(queries: TranslatedQueries, tblock, cfg):
    """Seeded blastx: the default double-indexed pipeline over 6 translated
    query contexts (reference run/double_indexed.cpp with
    align_mode.query_contexts = 6)."""
    from diamond_tpu_torch.search.pipeline import Pipeline

    cfg.translated = True
    pipe = Pipeline(cfg, queries.block, tblock, queries=queries)
    return pipe.search()


def blastx_swipe_all(queries: TranslatedQueries, tblock, cfg):
    """--swipe full-matrix blastx (reference align/full_db.cpp path)."""
    from diamond_tpu_torch.align.swipe_all import swipe_all_query
    from diamond_tpu_torch.search.pipeline import mask_block
    from diamond_tpu_torch.masking.tantan import Tantan

    cfg.matrix.set_db_letters(tblock.n_letters)
    if cfg.masking == "tantan":
        masker = Tantan(cfg.matrix.matrix32)
        mask_block(tblock, masker)
        mask_block(queries.block, masker)

    results = {}
    m = cfg.matrix
    for qi in range(len(queries)):
        ctxs = queries.contexts(qi)
        biases = {}
        for f, q in ctxs:
            i8 = hauser_bias_i8(q, m.matrix32, m.background_scores)
            biases[f] = i8
        matches = swipe_all_query(ctxs, queries.dna_lens[qi], biases, tblock, cfg)
        if matches:
            results[qi] = matches
    return results
