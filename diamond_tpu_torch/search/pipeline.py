"""blastp search pipeline driver.

Orchestrates: block masking -> per-shape/per-index-chunk seeding -> join ->
complexity masking -> stage 1/2 filters -> left-most dedup -> per-query
extension -> tabular output rows.

Mirrors the reference control flow (reference src/run/double_indexed.cpp:
run_query_chunk/run_ref_chunk, src/search/stage0.cpp:101-217,
stage2.h:74-154) with vectorized stages instead of thread pools: every stage
consumes flat candidate arrays, the layout that maps to TPU kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.align.extend import extend_query
from diamond_tpu_torch.constants.alphabet import MASK_LETTER
from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.masking.motifs import find_motif_ranges
from diamond_tpu_torch.masking.tantan import Tantan
from diamond_tpu_torch.search import stages
from diamond_tpu_torch.search.config import SearchConfig
from diamond_tpu_torch.search.left_most import PatternMatcher, left_most_filter
from diamond_tpu_torch.search.left_most_batch import BatchPatternMatcher, left_most_filter_batch
from diamond_tpu_torch.stats import cbs as cbs_mod
from diamond_tpu_torch.stats.cbs import hauser_bias_i8
from diamond_tpu_torch.utils.log import ptimer


@dataclass
class PipelineContext:
    cfg: SearchConfig
    query_block: Block
    target_block: Block
    _bias_cache: dict = field(default_factory=dict)

    def query_bias(self, query_id: int):
        ba = getattr(self, "_bias_all", None)
        if ba is not None:
            qs = int(self.query_block.starts[query_id])
            L = int(self.query_block.lengths[query_id])
            return ba[qs : qs + L]
        if query_id not in self._bias_cache:
            seq = self.query_block.seq(query_id)
            i8 = hauser_bias_i8(seq, self.cfg.matrix.matrix32,
                                self.cfg.matrix.background_scores)
            self._bias_cache[query_id] = i8
        return self._bias_cache[query_id]


def _mask_block(block: Block, masker: Tantan, save_original: bool = True,
                device: str | None = None):
    """Hard tantan masking in place (reference double_indexed.cpp:122-127,737-741).

    Idempotent across iterated-search rounds: the reference masks fresh
    letters once per block load; re-masking already-masked letters would
    diverge.  save_original=False skips the unmasked copy (only query
    blocks are ever read back unmasked — DAA output, data/daa.py).
    On a CUDA device the scan runs there (ops/tantan_device), the same bits
    as the native scan; counted in mask.card_letters / mask.host_letters."""
    if getattr(block, "_tantan_masked", False):
        return
    block._tantan_masked = True
    save = (block.save_unmasked if save_original and block.unmasked is None
            else None)
    from diamond_tpu_torch import native
    from diamond_tpu_torch.utils.device import resolve_device
    from diamond_tpu_torch.utils.log import pcount

    dev = resolve_device(device)
    n_letters = int(block.lengths.sum())
    if dev != "cpu":
        from diamond_tpu_torch.ops.tantan_device import mask_letters

        # the unmasked copy is taken while the card masks
        mask_letters(block.letters, block.starts, block.lengths, masker, dev,
                     overlap=save)
        pcount("mask.card_letters", n_letters)
        return
    if save is not None:
        save()
    pcount("mask.host_letters", n_letters)

    probs = native.tantan_repeat_prob_many(
        block.letters, block.starts, block.lengths, masker.ratios,
        float(masker.p_repeat), float(masker.p_repeat_end),
        float(masker.repeat_growth))
    if probs is not None:
        # padding positions carry prob 0 < p_mask, so one vector op masks
        # exactly the in-sequence repeat letters
        np.copyto(block.letters, MASK_LETTER,
                  where=probs >= masker.p_mask)
        return
    for i in range(len(block)):
        s = int(block.starts[i])
        L = int(block.lengths[i])
        seq = block.letters[s : s + L]
        prob = masker.repeat_prob(seq)
        block.letters[s : s + L] = np.where(prob >= masker.p_mask, MASK_LETTER, seq)


def _mask_block_seg(block: Block):
    """Hard NCBI-SEG masking in place (--masking seg; reference
    masking.cpp:172-193, lib/blast/blast_seg.cpp)."""
    if getattr(block, "_seg_masked", False):
        return
    block._seg_masked = True
    if block.unmasked is None:
        block.save_unmasked()
    from diamond_tpu_torch.masking.seg import seg_mask_ranges

    for i in range(len(block)):
        s = int(block.starts[i])
        L = int(block.lengths[i])
        for b, e in seg_mask_ranges(block.letters[s : s + L]):
            block.letters[s + b : s + e] = MASK_LETTER


def mask_block(block: Block, masker: Tantan, save_original: bool = True,
               device: str | None = None):
    """_mask_block under the span mask.block."""
    with ptimer("mask.block"):
        _mask_block(block, masker, save_original, device)


def mask_block_seg(block: Block):
    """_mask_block_seg under the span mask.seg."""
    with ptimer("mask.seg"):
        _mask_block_seg(block)


def motif_mask_ranges(block: Block):
    """Global-position motif mask ranges per sequence.

    The 8-mer table scan runs once over the whole concatenated block
    (masking/motifs.find_motif_starts_block); only the per-sequence range
    merge walks the (few) hit positions in Python.  find_motif_ranges is
    the per-sequence oracle."""
    from diamond_tpu_torch.masking.motifs import (find_motif_starts_block,
                                            merge_motif_ranges)

    starts = find_motif_starts_block(block)
    out = []
    if len(starts) == 0:
        return out
    sidx, local = block.global_to_local(starts)
    bounds = np.searchsorted(sidx, np.arange(len(block) + 1))
    for i in range(len(block)):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if lo == hi:
            continue
        s = int(block.starts[i])
        for b, e in merge_motif_ranges(local[lo:hi],
                                       int(block.lengths[i])):
            out.append((s + b, s + e))
    return out


def apply_ranges(letters: np.ndarray, ranges, value=MASK_LETTER):
    saved = []
    for b, e in ranges:
        saved.append((b, letters[b:e].copy()))
        letters[b:e] = value
    return saved


def restore_ranges(letters: np.ndarray, saved):
    for b, orig in saved:
        letters[b : b + len(orig)] = orig


class Pipeline:
    def __init__(self, cfg: SearchConfig, query_block: Block, target_block: Block,
                 queries=None, ranking_table=None, q_base: int = 0,
                 t_base: int = 0, query_skip=None, target_seed_index=None,
                 device: str | None = None):
        self.cfg = cfg
        # torch device of the extension DP (None: utils.device's default)
        self.device = device
        self.q = query_block
        self.t = target_block
        self.queries = queries  # TranslatedQueries when cfg.translated
        self.ctx = PipelineContext(cfg, query_block, target_block)
        cfg.matrix.set_db_letters(cfg.db_letters or target_block.n_letters)
        self.same_block = query_block is target_block
        # global ranking (-g): per-shape table updates replace extension
        # (reference double_indexed.cpp:185-193)
        self.ranking_table = ranking_table
        self.q_base = q_base
        self.t_base = t_base
        # iterated search: per-context bool array; aligned queries are
        # excluded from enumeration (reference double_indexed.cpp:264-265,
        # EnumCfg::skip)
        self.query_skip = query_skip
        # --target-indexed: persisted per-shape (keys, pos) target seeds
        # (reference double_indexed.cpp:181-185 HashedSeedSet load)
        self.target_seed_index = target_seed_index
        # --algo selection (reference setup.cpp:311-320 use_single_indexed,
        # double_indexed.cpp:267-294): query-indexed when the query set is
        # tiny relative to the DB (skips the DB-side seed sort); forced
        # with --algo 1, disabled with --algo 0 / sketch / minimizer /
        # linearized / target-indexed / self-search
        self._query_indexed = self._pick_query_indexed()
        # the target block's letters on the card for the shapes of one
        # search (_enumerate_t_card)
        self._t_card = None

    def _pick_query_indexed(self) -> bool:
        cfg = self.cfg
        algo = str(getattr(cfg, "algo", None) or "auto")
        if algo in ("0", "double-indexed"):
            return False
        if self.same_block or cfg.traits.sketch or cfg.minimizer_window \
                or cfg.lin_stage1_target or self.target_seed_index \
                is not None:
            return False
        if algo in ("1", "query-indexed"):
            return True
        from diamond_tpu_torch.search.config import SENS_RANK

        ql = int(self.q.n_letters)
        tl = int(self.t.n_letters)
        if SENS_RANK[cfg.sensitivity] >= SENS_RANK["sensitive"]:
            return ql < 300_000 and ql * 20_000 < tl
        # with the native hash filter (stages.cc filter_keys) the
        # query-indexed route wins as soon as the DB side is several
        # times the query side: it replaces the full DB seed sort with
        # one probe per DB seed + a sort of the (much smaller) survivor
        # set.  Output-identical either way (pinned by
        # test_query_indexed_algo_output_identical); this picks the
        # faster route at block-swap shapes like 1k queries x 50M-letter
        # blocks.
        from diamond_tpu_torch import native

        if native.lib() is not None:
            return ql < 16_000_000 and ql * 8 < tl
        return ql < 3_000_000 and ql * 2_000 < tl

    def search(self):
        """Run the full search; returns {query_id: [Match, ...]}."""
        from diamond_tpu_torch.utils.log import TaskTimer, statistics

        cfg = self.cfg
        timer = TaskTimer()
        if cfg.masking == "tantan":
            timer.go("Masking sequences")
            masker = Tantan(cfg.matrix.matrix32)
            mask_block(self.t, masker, save_original=self.same_block,
                       device=self.device)
            if not self.same_block:
                mask_block(self.q, masker, device=self.device)
            timer.finish()
        elif cfg.masking == "seg":
            # --masking seg: SEG on the TARGET only, queries unmasked
            # (reference run/config.cpp:128-129)
            timer.go("Masking sequences (SEG)")
            mask_block_seg(self.t)
            timer.finish()

        # motif soft-mask ranges computed once on the masked block
        with ptimer("search.motif"):
            q_motif = motif_mask_ranges(self.q) if cfg.motif_masking else []
            t_motif = (q_motif if self.same_block else
                       (motif_mask_ranges(self.t) if cfg.motif_masking else []))

        # persistent per-position query seed mask (SEED_MASK semantics)
        self.query_seed_mask = np.zeros(len(self.q.letters), dtype=bool)

        from diamond_tpu_torch.search.hit_buffer import HitBuffer

        # seed hits spill to disk-binned temp files over the memory cap
        # (reference search/hit_buffer.cpp:34-235)
        hits = HitBuffer(len(self.q),
                         contexts=6 if cfg.translated else 1)
        n_parts = cfg.seedp_count
        chunk_bounds = _partition(n_parts, cfg.index_chunks)

        self._t_card = None
        for sid in range(len(cfg.shapes)):
            shape = cfg.shapes[sid]
            timer.go(f"Processing shape {sid + 1}/{len(cfg.shapes)}")
            # soft-mask motif regions for enumeration
            saved_q = apply_ranges(self.q.letters, q_motif)
            saved_t = None if self.same_block else apply_ranges(self.t.letters, t_motif)
            with ptimer("seed.enumerate_q"):
                q_keys, q_pos = self._enumerate(self.q, shape)
            if cfg.freq_masking:
                # the enumeration-level UNREDUCED complexity cut stays active
                # under --freq-masking (reference enum_seeds ->
                # seed_is_complex_unreduced; only the post-join reduced
                # mask_seeds is replaced); dropped query positions get
                # seed-masked
                keep_q = stages.unreduced_complexity_filter(
                    self.q.letters, q_pos, shape, cfg.seed_complexity_cut)
                self.query_seed_mask[q_pos[~keep_q]] = True
                q_keys, q_pos = q_keys[keep_q], q_pos[keep_q]
            if self.query_skip is not None and len(q_pos):
                qidx, _ = self.q.global_to_local(q_pos)
                keep = ~self.query_skip[qidx]
                q_keys, q_pos = q_keys[keep], q_pos[keep]
            t_prefiltered = False
            if self.same_block:
                t_keys, t_pos = q_keys, q_pos
            elif self.target_seed_index is not None:
                t_keys, t_pos = self.target_seed_index[sid]
            elif (self._query_indexed and not cfg.traits.sketch
                  and not cfg.minimizer_window):
                # query-indexed route, streamed: the DB side enumerates
                # in sequence slices, each probing the query key set
                # immediately — peak seed memory is one slice instead
                # of the whole block (the reference's HashedSeedSet
                # probing has the same out-of-core shape, stage0.cpp)
                with ptimer("seed.enumerate_t"):
                    t_keys, t_pos = self._enumerate_t_qindex(shape, q_keys)
                t_prefiltered = True
            else:
                with ptimer("seed.enumerate_t"):
                    t_keys, t_pos = self._enumerate(self.t, shape)
                if cfg.freq_masking:
                    keep_t = stages.unreduced_complexity_filter(
                        self.t.letters, t_pos, shape,
                        cfg.seed_complexity_cut)
                    t_keys, t_pos = t_keys[keep_t], t_pos[keep_t]
            restore_ranges(self.q.letters, saved_q)
            if saved_t is not None:
                restore_ranges(self.t.letters, saved_t)

            # SEED_MASK bits never affect enumeration: the reference's
            # Sequence::operator[] strips mask bits before reduction
            # (reference basic/sequence.h:79-86 under SEQ_MASK), so seeds at
            # masked positions are still found by later shapes.  The bits
            # only exclude positions from the left-most filter's
            # "an earlier shape would have found this" claims
            # (reference search/sse_dist.h:157-190 seed_mask,
            # left_most.h:90-103).
            q_keys_f, q_pos_f = q_keys, q_pos

            # extend query seed mask by motif windows (reference
            # MaskingTable::remove add_bit_mask, masking.cpp:86-97)
            for b, e in q_motif:
                self.query_seed_mask[max(b - shape.length + 1, 0) : e] = True

            # one stable key sort per shape (not per chunk/side): boolean
            # chunk selection preserves order, so the per-chunk join is
            # sort-free; on a self-search the target side aliases the
            # query sort
            aliased = t_keys is q_keys_f
            with ptimer("seed.sort"):
                # the arrays are freshly built by enumeration/filters and
                # owned by this loop: sort in place, no defensive copy
                q_keys_f, q_pos_f = stages._sorted_kv(q_keys_f, q_pos_f,
                                                      inplace=True)
                if aliased:
                    t_keys, t_pos = q_keys_f, q_pos_f
                elif t_prefiltered:
                    t_keys, t_pos = stages._sorted_kv(t_keys, t_pos,
                                                      inplace=True)
                elif self._query_indexed:
                    # --algo query-indexed (reference
                    # double_indexed.cpp:267-294, setup.cpp:311-320): a
                    # tiny query set vs a huge DB skips the DB-side seed
                    # sort — every DB seed probes the sorted query keys
                    # (the reference's HashedSeedSet) and only matches
                    # are kept and sorted.  Output-identical: the join
                    # only ever produces groups present on both sides.
                    with ptimer("seed.qindex"):
                        nq = len(q_keys_f)
                        if not nq:
                            keep = np.zeros(len(t_keys), dtype=bool)
                        else:
                            from diamond_tpu_torch import native

                            keep = native.filter_keys_native(t_keys,
                                                             q_keys_f)
                            if keep is None:
                                ins = np.searchsorted(q_keys_f, t_keys)
                                ins[ins == nq] = nq - 1
                                keep = q_keys_f[ins] == t_keys
                        t_keys, t_pos = t_keys[keep], t_pos[keep]
                    t_keys, t_pos = stages._sorted_kv(t_keys, t_pos,
                                                      inplace=True)
                else:
                    t_keys, t_pos = stages._sorted_kv(t_keys, t_pos,
                                                      inplace=True)

            # keys < 2^63, so the uint64 masks reinterpret as int64
            # without a 30MB astype copy per round
            parts = (q_keys_f & np.uint64(cfg.seedp_mask)).view(np.int64)
            t_parts = parts if aliased else \
                (t_keys & np.uint64(cfg.seedp_mask)).view(np.int64)

            shape_hits = []
            for chunk in range(cfg.index_chunks):
                lo, hi = chunk_bounds[chunk]
                with ptimer("seed.chunk_mask"):
                    qi = (parts >= lo) & (parts < hi)
                    ti = qi if aliased else \
                        (t_parts >= lo) & (t_parts < hi)
                with ptimer("seed.join"):
                    join = stages.seed_join_sorted(q_keys_f[qi], q_pos_f[qi],
                                                   t_keys[ti], t_pos[ti])
                group_keep = None
                with ptimer("seed.complexity"):
                    if cfg.freq_masking and not cfg.lin_stage1_target:
                        join, masked_pos = self._frequent_seed_mask(join)
                    else:
                        join, masked_pos, group_keep = \
                            self._complexity_keep(join, shape)
                if len(masked_pos):
                    self.query_seed_mask[masked_pos] = True
                with ptimer("seed.stage12"):
                    if (cfg.threads > 1 and _can_fork()
                            and len(join.keys) >= 4 * cfg.threads):
                        shape_hits.append(self._stage12_parallel(
                            join, shape, sid, chunk, lo, hi, group_keep))
                    else:
                        shape_hits.append(self._stage12(
                            join, shape, sid, chunk, lo, hi, group_keep))
            # the subject-side partition table (int16 per target letter)
            # only serves THIS shape's chunks — drop it before the next
            # shape allocates its own (~100 MB per shape on a 50M block)
            if getattr(self, "_part_tbls", None):
                self._part_tbls.clear()
            shape_arr = (np.concatenate(shape_hits) if shape_hits
                         else np.empty((0, 4), dtype=np.int64))
            if self.ranking_table is not None:
                from diamond_tpu_torch.align.global_ranking import update_table

                update_table(self.ranking_table,
                             [tuple(r) for r in shape_arr.tolist()],
                             self.q, self.t, cfg, self.q_base, self.t_base)
            else:
                hits.append(shape_arr)
            statistics.inc("SEED_HITS", len(shape_arr))
        self._t_card = None  # frees the letters on the card

        timer.finish()
        if self.ranking_table is not None:
            return None
        timer.go("Computing alignments")
        hits.finish()
        if hits.spilled:
            res = {}
            for rows in hits.bins():
                res.update(self._extend_all([rows]))
        else:
            res = self._extend_all(hits.mem)
        timer.finish()
        statistics.inc("ALIGNED", len(res) if res else 0)
        return res

    # ------------------------------------------------------------------
    def _enumerate_t_qindex(self, shape, q_keys, slice_letters=4 << 20):
        """DB-side enumeration for the query-indexed route, in sequence
        slices: each slice's seeds probe the sorted query key set and
        only matches survive.  Survivor set and order are identical to
        the one-shot enumerate + filter (slices concatenate in position
        order), but peak seed memory is one slice, not the block.
        On a CUDA device, for blocks of MIN_LETTERS letters or more, the
        fused path runs there (_enumerate_t_card) with the same output;
        DB positions count in seed.card_positions / seed.host_positions."""
        cfg = self.cfg
        block = self.t
        from diamond_tpu_torch.utils.device import resolve_device
        from diamond_tpu_torch.utils.log import pcount

        dev = resolve_device(self.device)
        if not cfg.freq_masking and len(q_keys) and dev != "cpu":
            from diamond_tpu_torch.ops import seed_enum_device as sed

            table = sed.reduce_table(cfg.reduction)
            if table.dtype == np.int8 and len(block.letters) >= sed.MIN_LETTERS:
                return self._enumerate_t_card(shape, q_keys, table, dev)
        pcount("seed.host_positions", int(np.maximum(
            block.lengths.astype(np.int64) - (shape.length - 1), 0).sum()))
        qs = np.sort(q_keys)
        reduced_all = cfg.reduction(block.letters)
        n = len(block)
        out_k, out_p = [], []
        cum = np.cumsum(block.lengths.astype(np.int64))
        s_lo = 0
        base = 0
        from diamond_tpu_torch import native

        # fully fused native path (enumerate + probe in one pass, no
        # full-slice key arrays); the sliced fallback below is the
        # oracle and the freq-masking route (its unreduced filter sits
        # between enumerate and probe)
        if (not cfg.freq_masking and len(qs)
                and reduced_all.dtype == np.int8
                and reduced_all.flags.c_contiguous
                and native.lib() is not None):
            pos64 = getattr(shape, "_pos64", None)
            if pos64 is None:
                pos64 = np.ascontiguousarray(shape.positions,
                                             dtype=np.int64)
                shape._pos64 = pos64
            while s_lo < n:
                s_hi = int(np.searchsorted(cum, base + slice_letters,
                                           "left"))
                s_hi = min(max(s_hi, s_lo + 1), n)
                base = int(cum[s_hi - 1])
                r = native.enumerate_seeds_filtered_native(
                    reduced_all, block.starts[s_lo:s_hi],
                    block.lengths[s_lo:s_hi], pos64, shape.weight,
                    shape.length, cfg.reduction.size, 0, qs)
                s_lo = s_hi
                if r is not None and len(r[0]):
                    out_k.append(r[0])
                    out_p.append(r[1])
            if not out_k:
                return (np.zeros(0, dtype=np.uint64),
                        np.zeros(0, dtype=np.int64))
            return np.concatenate(out_k), np.concatenate(out_p)

        while s_lo < n:
            s_hi = int(np.searchsorted(cum, base + slice_letters, "left"))
            s_hi = min(max(s_hi, s_lo + 1), n)
            base = int(cum[s_hi - 1])
            k, p = stages.enumerate_seeds_range(block, shape, cfg.reduction,
                                                reduced_all, s_lo, s_hi)
            s_lo = s_hi
            if cfg.freq_masking and len(p):
                keep_t = stages.unreduced_complexity_filter(
                    block.letters, p, shape, cfg.seed_complexity_cut)
                k, p = k[keep_t], p[keep_t]
            if len(qs) == 0 or len(k) == 0:
                continue
            keep = native.filter_keys_native(k, qs)
            if keep is None:
                ins = np.searchsorted(qs, k)
                ins[ins == len(qs)] = len(qs) - 1
                keep = qs[ins] == k
            out_k.append(k[keep])
            out_p.append(p[keep])
        if not out_k:
            return (np.zeros(0, dtype=np.uint64),
                    np.zeros(0, dtype=np.int64))
        return np.concatenate(out_k), np.concatenate(out_p)

    def _enumerate_t_card(self, shape, q_keys, table, dev):
        """The fused path of _enumerate_t_qindex on the CUDA ``dev``
        (ops/seed_enum_device), ``table`` the reduction of every byte: the
        target letters, as the enumeration sees them (motif ranges
        applied), go up on the first shape of a search and serve every
        shape; each shape uploads its query keys and launches once."""
        from diamond_tpu_torch.ops import seed_enum_device as sed
        from diamond_tpu_torch.utils.log import pcount

        if self._t_card is None:
            self._t_card = sed.upload_block(
                self.t.letters, self.t.starts, self.t.lengths, table,
                self.cfg.reduction.size, dev)
        pcount("seed.card_positions", self._t_card.windows(shape.length))
        return sed.enumerate_block(self._t_card, shape.positions,
                                   shape.length, q_keys)

    def _enumerate(self, block, shape):
        """Seed enumeration; with a sketch size set (FASTER), per-sequence
        min-hash sketch selection (reference seed_iterator.h:161-200
        SketchIterator).  Sketch selection hashes the reference's exact
        even/odd key packing; the returned join keys stay in the pipeline's
        plain packing."""
        cfg = self.cfg
        if not cfg.traits.sketch and not cfg.minimizer_window:
            return stages.enumerate_seeds(block, shape, cfg.reduction)
        from diamond_tpu_torch.cluster.linclust import exact_seed_keys, sketch_select

        keys_out, pos_out = [], []
        reduced_all = cfg.reduction(block.letters)
        for i in range(len(block)):
            L = int(block.lengths[i])
            if L < shape.length:
                continue
            start = int(block.starts[i])
            red = reduced_all[start : start + L]
            ekeys, valid = exact_seed_keys(red, shape, cfg.reduction.size)
            if cfg.minimizer_window:
                sel = stages.minimizer_select(ekeys, valid,
                                              cfg.minimizer_window)
            else:
                sel = sketch_select(ekeys, valid, cfg.traits.sketch)
            if len(sel) == 0:
                continue
            pkeys, _ = shape.extract_seeds(red, cfg.reduction.size)
            keys_out.append(pkeys[sel])
            pos_out.append(start + sel.astype(np.int64))
        if not keys_out:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.int64)
        return np.concatenate(keys_out), np.concatenate(pos_out)

    def _frequent_seed_mask(self, join):
        """--freq-masking: drop seed groups whose query/ref occurrence
        counts exceed mean + freq_sd * sd, seed-masking the query positions
        (reference data/frequent_seeds.cpp:39-115, stage0.cpp:168-171;
        replaces the complexity-based mask_seeds)."""
        from diamond_tpu_torch.search.stages import SeedJoin, _csr_gather

        n_groups = len(join.keys)
        if n_groups == 0:
            return join, np.zeros(0, dtype=np.int64)
        q_counts = np.diff(join.q_start)
        s_counts = np.diff(join.s_start)
        # Sd (reference util.h:43-68): population sd over group sizes
        q_cap = int(q_counts.mean() + self.cfg.traits.freq_sd * q_counts.std())
        s_cap = int(s_counts.mean() + self.cfg.traits.freq_sd * s_counts.std())
        drop = (s_counts > s_cap) | (q_counts > q_cap)
        if not drop.any():
            return join, np.zeros(0, dtype=np.int64)
        didx = np.nonzero(drop)[0]
        _, masked = _csr_gather(join.q_start[didx], q_counts[didx], join.q_pos)
        keep = ~drop
        kidx = np.nonzero(keep)[0]
        qs, qv = _csr_gather(join.q_start[kidx], q_counts[kidx], join.q_pos)
        ss, sv = _csr_gather(join.s_start[kidx], s_counts[kidx], join.s_pos)
        return SeedJoin(keys=join.keys[kidx], q_start=qs, q_pos=qv,
                        s_start=ss, s_pos=sv), masked

    def _complexity_mask(self, join, shape):
        cfg = self.cfg
        kept = stages.complexity_mask(join, shape, cfg.reduction,
                                      cfg.seed_complexity_cut)
        if len(kept.keys) == len(join.keys):
            return kept, np.zeros(0, dtype=np.int64)
        # positions of erased groups (query side) get seed-masked
        from diamond_tpu_torch.search.stages import _csr_gather

        erased = np.setdiff1d(join.keys, kept.keys, assume_unique=True)
        idx = np.searchsorted(join.keys, erased)
        counts = np.diff(join.q_start)[idx]
        _, masked = _csr_gather(join.q_start[idx], counts, join.q_pos)
        return kept, masked

    def _per_query_cutoffs(self):
        """Per-query stage-2 cutoff and window arrays (the short-query
        rules of reference stage2.h:41-61, precomputed once per block)."""
        if hasattr(self, "_pq_cut"):
            return self._pq_cut, self._pq_win
        cfg = self.cfg
        qlens = np.asarray(self.q.lengths, dtype=np.int64)
        cut = self._cutoff_table(qlens).astype(np.int32)
        cut = np.where(qlens <= 60,
                       np.int32(cfg.matrix.rawscore(25.0)), cut)
        win = np.full(len(qlens), 48, dtype=np.int64)
        if cfg.translated:
            short85 = (qlens > 60) & (qlens <= 85)
            if short85.any():
                cut = np.where(short85,
                               self._cutoff_table_short(qlens).astype(np.int32),
                               cut)
            win = np.where(qlens <= 85, qlens, win)
        self._pq_cut = np.ascontiguousarray(cut)
        self._pq_win = np.ascontiguousarray(win)
        return self._pq_cut, self._pq_win

    def _stage12_native(self, join, shape, sid, part_lo, part_hi,
                        skip_lm: bool, group_keep=None):
        """Fused native stage1+2+left-most over the join (one pass per
        candidate pair, no intermediate arrays; native/src/leftmost.cc
        stage12_pipeline).  Returns [N,4] hit rows or None."""
        from diamond_tpu_torch import native

        if native.lib() is None:
            return None
        cfg = self.cfg
        n_groups = len(join.keys)
        if n_groups == 0:
            return np.empty((0, 4), dtype=np.int64)
        cut, win = self._per_query_cutoffs()
        chunked = cfg.index_chunks > 1
        current = self._matcher(sid + 1)
        previous = self._matcher(sid) if sid > 0 else self._matcher(0)
        part_tbl = None
        if chunked and not skip_lm:
            # subject-side seed partitions, precomputed once per shape
            # (replaces left-most verify's per-candidate key recompute)
            tbls = getattr(self, "_part_tbls", None)
            if tbls is None:
                tbls = self._part_tbls = {}
            part_tbl = tbls.get(sid)
            if part_tbl is None:
                part_tbl = tbls[sid] = native.seed_part_table_native(
                    self.t.letters, shape, cfg.reduction, cfg.seedp_mask)
        q_counts = np.diff(join.q_start)
        s_counts = np.diff(join.s_start)
        cum = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(q_counts * s_counts, out=cum[1:])
        from diamond_tpu_torch.utils.log import pcount
        if group_keep is None:
            pcount("seed.s12_pairs", int(cum[-1]))
            pcount("seed.s12_qinst", int(q_counts.sum()))
        else:
            pcount("seed.s12_pairs",
                   int((q_counts * s_counts)[group_keep].sum()))
            pcount("seed.s12_qinst", int(q_counts[group_keep].sum()))
        CAP = 1 << 21
        buf = getattr(self, "_s12_buf", None)
        if buf is None:
            buf = self._s12_buf = np.empty((CAP, 4), dtype=np.int64)
        outs = []
        from diamond_tpu_torch.utils.log import enabled
        s12_stats = np.zeros(2, dtype=np.int64) if enabled() else None
        g0 = 0
        while g0 < n_groups:
            g1 = int(np.searchsorted(cum, cum[g0] + CAP, side="right")) - 1
            if g1 <= g0:
                g1 = g0 + 1
            pairs = int(cum[g1] - cum[g0])
            b = buf if pairs <= CAP else np.empty((pairs, 4), dtype=np.int64)
            from diamond_tpu_torch.utils.log import ptimer as _pt
            with _pt("seed.s12_native"):
              m = native.stage12_pipeline_native(
                self.q.letters, self.t.letters, self.query_seed_mask, join,
                group_keep, g0, g1, self.q.starts, cut, win, True,
                cfg.hamming_filter_id, cfg.matrix.matrix32,
                cfg.self_search, self.t.starts, not skip_lm,
                cfg.reduction, shape, sid == 0, chunked, current, previous,
                part_lo, part_hi, cfg.seedp_mask, b, part_tbl,
                q_idx_tbl=self._pos_index(self.q),
                s_idx_tbl=(self._pos_index(self.t) if cfg.self_search
                           else None), stats_out=s12_stats)
            if m:
                outs.append(b[:m].copy())
            if s12_stats is not None:
                pcount("seed.s12_s1pass", int(s12_stats[0]))
                pcount("seed.s12_lmpass", int(s12_stats[1]))
            g0 = g1
        if not outs:
            return np.empty((0, 4), dtype=np.int64)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def _pos_index(self, block):
        """int32 letter-position -> sequence-index table (O(1) lookups in
        the native stage-1/2 pass instead of per-instance binary search;
        padding after sequence i maps to i, matching the search)."""
        key = "_pos_idx_tbl"
        tbl = getattr(block, key, None)
        if tbl is None or len(tbl) != len(block.letters):
            mark = np.zeros(len(block.letters), dtype=np.int32)
            st = block.starts[1:]
            st = st[st < len(mark)]
            np.add.at(mark, st, 1)  # duplicate starts (empty seqs) stack
            tbl = np.cumsum(mark, dtype=np.int32)
            setattr(block, key, tbl)
        return tbl

    def _complexity_keep(self, join, shape):
        """Seed-complexity filter as a per-group keep mask (native fast
        path avoids rebuilding the join CSR; the fused stage-1/2 pass
        skips dropped groups).  Returns (join, masked_positions, keep)."""
        from diamond_tpu_torch import native
        from diamond_tpu_torch.search.stages import _LNFACT, _csr_gather

        cfg = self.cfg
        if not len(join.keys):
            return join, np.zeros(0, dtype=np.int64), None
        keep = native.seed_complexity_keep_native(
            join.keys, shape.weight, cfg.reduction.size, _LNFACT,
            cfg.seed_complexity_cut)
        if keep is None:
            join2, masked = self._complexity_mask(join, shape)
            return join2, masked, None
        if keep.all():
            return join, np.zeros(0, dtype=np.int64), None
        didx = np.nonzero(~keep)[0]
        counts = np.diff(join.q_start)[didx]
        _, masked = _csr_gather(join.q_start[didx], counts, join.q_pos)
        return join, masked, keep

    def _stage12_device(self, join, shape, sid, part_lo, part_hi,
                        skip_lm: bool, group_keep=None):
        """Stage 1+2, the self-hit test and the left-most filter on the card
        (ops/stage12_device.Stage12Device.join_rows: the fused join kernel,
        csrc/stage12_join.cu), in chunks of seed groups with a pair cap; no
        pair is expanded on the host.  The rows and their order are the
        fused native pass's (exact integer ops)."""
        from diamond_tpu_torch import native
        from diamond_tpu_torch.ops.stage12_device import Stage12Device
        from diamond_tpu_torch.utils.log import pcount

        cfg = self.cfg
        pairs = np.diff(join.q_start) * np.diff(join.s_start)
        if group_keep is not None:
            pairs = pairs[group_keep.astype(bool)]
        pcount("seed.s12_pairs", int(pairs.sum()))
        dev = getattr(self, "_s12_dev", None)
        if dev is None:
            dev = self._s12_dev = Stage12Device(cfg.matrix.matrix32,
                                                device=self.device)
        cut, win = self._per_query_cutoffs()
        chunked = cfg.index_chunks > 1
        part_tbl = None
        if chunked and not skip_lm:  # shared with the native pass's cache
            tbls = getattr(self, "_part_tbls", None)
            if tbls is None:
                tbls = self._part_tbls = {}
            part_tbl = tbls.get(sid)
            if part_tbl is None:
                part_tbl = tbls[sid] = native.seed_part_table_native(
                    self.t.letters, shape, cfg.reduction, cfg.seedp_mask)
        return dev.join_rows(
            self.q.letters, self.t.letters, self.query_seed_mask, join,
            group_keep, self.q.starts, cut, win, self._pos_index(self.q),
            self._pos_index(self.t) if cfg.self_search else None,
            cfg.reduction, shape, sid == 0, chunked, not skip_lm,
            self._matcher(sid + 1),
            self._matcher(sid) if sid > 0 else self._matcher(0),
            part_lo, part_hi, cfg.seedp_mask, part_tbl,
            cfg.hamming_filter_id, cfg.self_search)

    def _stage12_parallel(self, join, shape, sid, chunk, part_lo, part_hi,
                          group_keep=None):
        """Fork-parallel stage 1+2: the chunk's seed groups split into
        cfg.threads contiguous slices (groups are key-sorted, so slices
        are seed-partition ranges like the reference's fetch-add
        partition workers, stage0.cpp:158-197); every child runs the full
        fused pass with the CHUNK's partition bounds (left-most semantics
        unchanged) and the parent concatenates hit rows in slice order —
        byte-identical to the serial pass."""
        import multiprocessing

        n_groups = len(join.keys)
        threads = self.cfg.threads
        edges = [n_groups * k // threads for k in range(threads + 1)]
        global _MP_CTX
        _MP_CTX = (self, join, shape, sid, chunk, part_lo, part_hi,
                   group_keep)
        try:
            with multiprocessing.get_context("fork").Pool(threads) as pool:
                parts = pool.map(_mp_stage12_slice,
                                 list(zip(edges[:-1], edges[1:])))
        finally:
            _MP_CTX = None
        parts = [p for p in parts if len(p)]
        return (np.concatenate(parts) if parts
                else np.empty((0, 4), dtype=np.int64))

    def _stage12_slice(self, g0, g1, join, shape, sid, chunk, part_lo,
                       part_hi, group_keep):
        from diamond_tpu_torch.search.stages import SeedJoin

        qa, qb = int(join.q_start[g0]), int(join.q_start[g1])
        sa, sb = int(join.s_start[g0]), int(join.s_start[g1])
        sub = SeedJoin(
            keys=join.keys[g0:g1],
            q_start=join.q_start[g0 : g1 + 1] - join.q_start[g0],
            q_pos=join.q_pos[qa:qb],
            s_start=join.s_start[g0 : g1 + 1] - join.s_start[g0],
            s_pos=join.s_pos[sa:sb])
        gk = None if group_keep is None else group_keep[g0:g1]
        return self._stage12(sub, shape, sid, chunk, part_lo, part_hi, gk)

    def _stage12(self, join, shape, sid, chunk, part_lo, part_hi,
                 group_keep=None):
        cfg = self.cfg
        if cfg.lin_stage1_target and len(join.keys):
            # linearized stage 1: one target occurrence per seed — the first
            # (lowest-position) entry of the group (reference
            # kernel_lin.h:131-152 stage1_target_lin uses s[0])
            from diamond_tpu_torch.search.stages import SeedJoin

            join = SeedJoin(
                keys=join.keys, q_start=join.q_start, q_pos=join.q_pos,
                s_start=np.arange(len(join.keys) + 1, dtype=np.int64),
                s_pos=join.s_pos[join.s_start[:-1]])
        skip_lm = bool(cfg.traits.sketch or cfg.lin_stage1_target
                       or cfg.minimizer_window)
        from diamond_tpu_torch.utils.device import stage12_device_enabled

        if stage12_device_enabled():
            return self._stage12_device(join, shape, sid, part_lo, part_hi,
                                        skip_lm, group_keep)
        r = self._stage12_native(join, shape, sid, part_lo, part_hi, skip_lm,
                                 group_keep)
        if r is not None:
            return r
        if group_keep is not None:
            from diamond_tpu_torch.search.stages import _filter_groups

            join = _filter_groups(join, group_keep)
        qp, sp = stages.expand_pairs(join)
        if len(qp) == 0:
            return np.empty((0, 4), dtype=np.int64)
        keep1 = stages.stage1_filter(self.q.letters, self.t.letters, qp, sp,
                                     cfg.hamming_filter_id)
        qp, sp = qp[keep1], sp[keep1]
        if len(qp) == 0:
            return np.empty((0, 4), dtype=np.int64)

        qidx, qoff = self.q.global_to_local(qp)
        qlens = self.q.lengths[qidx]
        cutoffs = self._cutoff_table(qlens)
        scores = stages.stage2_scores(self.q.letters, self.t.letters, qp, sp,
                                      cfg.matrix.matrix32)
        # short-query rules (reference stage2.h:41-61): qlen <= 60 uses a
        # fixed bitscore cutoff; translated qlens <= 85 use the short-query
        # e-value table and window = qlen
        short60 = qlens <= 60
        if short60.any():
            cutoffs = np.where(short60, cfg.matrix.rawscore(25.0), cutoffs)
        if cfg.translated:
            short85 = (qlens > 60) & (qlens <= 85)
            if short85.any():
                cutoffs = np.where(
                    short85, self._cutoff_table_short(qlens), cutoffs)
            shortw = qlens <= 85
            for k in np.nonzero(shortw)[0]:
                w = int(qlens[k])
                scores[k] = stages.stage2_scores(
                    self.q.letters, self.t.letters, qp[k : k + 1],
                    sp[k : k + 1], cfg.matrix.matrix32, window=w)[0]
        keep2 = scores > cutoffs
        if cfg.self_search:
            sidx, _ = self.t.global_to_local(sp)
            keep2 &= ~(sidx == qidx)
        qp, sp, scores = qp[keep2], sp[keep2], scores[keep2]
        qidx, qoff = qidx[keep2], qoff[keep2]

        # left-most dedup filter (vectorized); skipped for sketch/minimizer
        # seeding and all linearized modes (reference stage2.h:101
        # skip_left_most)
        if cfg.traits.sketch or cfg.lin_stage1_target or cfg.minimizer_window:
            return _hit_rows(qidx, sp, qoff, scores,
                             np.arange(len(qp), dtype=np.int64))
        chunked = cfg.index_chunks > 1
        current = self._matcher(sid + 1)
        previous = self._matcher(sid) if sid > 0 else self._matcher(0)
        wl, wr = stages.clip_window(self.q.letters, qp, 48)
        keep3 = left_most_filter_batch(
            self.q.letters, self.t.letters, self.query_seed_mask,
            cfg.reduction, qp, sp, qoff.astype(np.int64), wl, wr,
            shape, sid, chunked, current, previous,
            part_lo, part_hi, cfg.seedp_mask, cfg.hamming_filter_id)
        return _hit_rows(qidx, sp, qoff, scores, np.nonzero(keep3)[0])

    def _matcher(self, end_shape: int):
        key = ("pm", end_shape)
        if not hasattr(self, "_pm_cache"):
            self._pm_cache = {}
        if key not in self._pm_cache:
            self._pm_cache[key] = BatchPatternMatcher(
                self.cfg.shapes.patterns(0, end_shape))
        return self._pm_cache[key]

    def _left_most(self, qp, sp, seed_offset, qlen, cutoff, shape, sid, chunked,
                   current, previous, part_lo, part_hi):
        cfg = self.cfg
        window = 48
        left, right = stages.clip_window(self.q.letters, np.array([qp]), window)
        window_left = int(left[0])
        interval_mod = seed_offset % 32  # config.left_most_interval
        overhang = max(window_left - interval_mod, 0)
        q_win_start = qp - window_left + overhang
        s_win_start = sp - window_left + overhang
        q_win_len = window_left + int(right[0]) - overhang
        seed_off_in_window = window_left - overhang
        keep = left_most_filter(
            self.q.letters, self.t.letters, self.query_seed_mask,
            int(q_win_start), int(s_win_start), int(q_win_len),
            seed_off_in_window, shape.length,
            current, previous, sid == 0, shape, cfg.reduction,
            chunked, part_lo, part_hi, cfg.seedp_mask,
            cfg.hamming_filter_id,
        )
        return keep

    def _cutoff_table(self, qlens):
        cfg = self.cfg
        if not hasattr(self, "_cutoffs"):
            self._cutoffs = stages.CutoffTable(cfg.matrix, cfg.traits.ungapped_evalue) \
                if cfg.traits.ungapped_evalue > 0 else None
        if self._cutoffs is None:
            return np.zeros(len(qlens), dtype=np.int32)
        return self._cutoffs(qlens)

    def _cutoff_table_short(self, qlens):
        """Short-query table (ungapped_evalue_short, reference
        stage2.h:50-51)."""
        cfg = self.cfg
        if not hasattr(self, "_cutoffs_short"):
            ev = cfg.traits.ungapped_evalue_short
            self._cutoffs_short = stages.CutoffTable(cfg.matrix, ev) \
                if ev > 0 else None
        if self._cutoffs_short is None:
            return np.zeros(len(qlens), dtype=np.int32)
        return self._cutoffs_short(qlens)

    # ------------------------------------------------------------------
    def _precompute_round1(self, qid_all, arr5):
        """Whole-wave first-round stage: ONE native call runs the ungapped
        x-drop + chaining stage for every eligible (single-ranking-chunk,
        no gapped filter, no matrix adjust) query — the per-query native
        calls and CSR builds of extend_query_gen collapse into flat
        global group arrays (the reference's per-thread align_queries
        partition, src/align/align.cpp:203-269, as one batch).  Results
        land in ctx._pre_round1; extend_query_gen consumes them when
        present.  Byte-identical: same group order, same hit order, same
        per-target native body."""
        cfg = self.cfg
        self.ctx._pre_round1 = None
        if (cfg.ext_mode in ("full", "none") or cfg.gapped_filter_evalue > 0
                or cbs_mod.matrix_adjust(cfg.comp_based_stats)
                or cfg.translated or len(arr5) == 0):
            return
        from diamond_tpu_torch import native

        if native.lib() is None:
            return
        from diamond_tpu_torch.align.extend import ranking_chunk_size

        chunk_size = ranking_chunk_size(0, self.t.n_letters,
                                        cfg.max_target_seqs,
                                        toppercent=cfg.toppercent)
        tid_col = arr5[:, 3]
        change = np.empty(len(arr5), dtype=bool)
        change[0] = True
        np.logical_or(qid_all[1:] != qid_all[:-1],
                      tid_col[1:] != tid_col[:-1], out=change[1:])
        gidx = np.nonzero(change)[0]
        g_hit_start = np.append(gidx, len(arr5)).astype(np.int64)
        g_tid = tid_col[gidx]
        g_qid = np.ascontiguousarray(qid_all[gidx])
        g_score = np.maximum.reduceat(arr5[:, 2], gidx)
        # per-query group bounds (g_qid ascending)
        uq = np.unique(g_qid)
        qb = np.searchsorted(g_qid, np.append(uq, np.iinfo(np.int64).max))
        counts = np.diff(qb)
        elig = counts <= chunk_size
        if not elig.any():
            return
        qids_e = np.ascontiguousarray(uq[elig])
        lo_e = np.ascontiguousarray(qb[:-1][elig])
        hi_e = np.ascontiguousarray(qb[1:][elig])
        # native call inputs: eligible queries' group runs, concatenated
        sel = np.concatenate([np.arange(a, b) for a, b in
                              zip(lo_e, hi_e)]) if len(qids_e) else None
        # group runs per query are contiguous; eligible set keeps global
        # order, so sel is sorted — slices of the global arrays suffice
        g_sel = np.ascontiguousarray(sel)
        counts_e = (hi_e - lo_e).astype(np.int64)
        q_grp_lo = np.zeros(len(qids_e) + 1, dtype=np.int64)
        np.cumsum(counts_e, out=q_grp_lo[1:])
        lens64 = getattr(self.t, "_lengths64", None)
        if lens64 is None or len(lens64) != len(self.t.lengths):
            lens64 = self.t._lengths64 = self.t.lengths.astype(np.int64)
        starts64 = np.ascontiguousarray(self.t.starts, dtype=np.int64)
        g_tid_sel = np.ascontiguousarray(g_tid[g_sel])
        g_tstart = np.ascontiguousarray(starts64[g_tid_sel])
        g_tlen = np.ascontiguousarray(lens64[g_tid_sel])
        # hit CSR stays global (absolute offsets); groups selected by run
        gh = np.empty(len(g_sel) + 1, dtype=np.int64)
        gh[:-1] = g_hit_start[g_sel]
        gh[-1] = g_hit_start[g_sel[-1] + 1] if len(g_sel) else 0
        # eligible group runs are contiguous per query but the overall
        # selection may skip ineligible queries' groups: the native pass
        # indexes hits by absolute CSR, so gaps are fine — but the
        # per-group CSR array must carry each group's own [start, end).
        # Rebuild as explicit 2-column bounds folded into gh via ends:
        g_hit_end = g_hit_start[g_sel + 1]
        ok = np.all(gh[1 : len(g_sel)] == g_hit_end[: len(g_sel) - 1]) \
            if len(g_sel) > 1 else True
        if not ok:
            # non-contiguous hit runs (skipped queries in between): fall
            # back to per-group explicit CSR by compacting hits
            gh = np.zeros(len(g_sel) + 1, dtype=np.int64)
            np.cumsum((g_hit_end - g_hit_start[g_sel]).astype(np.int64),
                      out=gh[1:])
            take = np.concatenate([np.arange(a, b) for a, b in zip(
                g_hit_start[g_sel], g_hit_end)])
            hit_i = np.ascontiguousarray(arr5[take, 1])
            hit_j = np.ascontiguousarray(arr5[take, 4])
            hit_s = np.ascontiguousarray(arr5[take, 2])
        else:
            hit_i = np.ascontiguousarray(arr5[:, 1])
            hit_j = np.ascontiguousarray(arr5[:, 4])
            hit_s = np.ascontiguousarray(arr5[:, 2])
        bias_all = None
        if cbs_mod.hauser(cfg.comp_based_stats):
            bias_all = self._block_bias_i8()
            if bias_all is None:
                return
        q_starts = np.ascontiguousarray(self.q.starts, dtype=np.int64)
        q_lens_e = np.ascontiguousarray(
            self.q.lengths.astype(np.int64)[qids_e])
        total_hits = int(gh[-1] - gh[0]) if ok else int(gh[-1])
        r = native.ungapped_stage_queries_native(
            self.q.letters, bias_all, self.t.letters, q_starts, qids_e,
            q_grp_lo, q_lens_e, g_tstart, g_tlen, gh, hit_i, hit_j, hit_s,
            cfg.matrix.matrix32, cfg.xdrop_raw, cfg.matrix.gap_open,
            cfg.matrix.gap_extend, max(total_hits, 1))
        if r is None:
            return
        usc, out_start, rows = r
        self.ctx._pre_round1 = {
            "bounds": {int(q): (int(a), int(b)) for q, a, b in
                       zip(qids_e.tolist(), q_grp_lo[:-1].tolist(),
                           q_grp_lo[1:].tolist())},
            "g_tid": g_tid_sel, "g_score": g_score[g_sel],
            "usc": usc, "out_start": out_start, "rows": rows}

    def _block_bias_i8(self):
        """Block-aligned int8 Hauser bias for every query (one native
        call); also seeds the per-query bias cache slices."""
        from diamond_tpu_torch import native

        cached = getattr(self, "_bias_all", None)
        if cached is not None:
            return cached
        mat = self.cfg.matrix
        b = native.hauser_bias_block_native(
            self.q.letters, self.q.starts, self.q.lengths, mat.matrix32,
            mat.background_scores)
        if b is not None:
            self._bias_all = b
            self.ctx._bias_all = b
        return b

    def _extend_all(self, hits):
        arr = (np.concatenate(hits) if hits
               else np.empty((0, 4), dtype=np.int64))
        if self.cfg.translated:
            from diamond_tpu_torch.align.extend import extend_query_translated

            # stable sort by SOURCE id so within-source hit order stays the
            # production order (byte-identical to the tuple-list driver)
            src_all = arr[:, 0] // 6
            order = np.argsort(src_all, kind="stable")
            arr = arr[order]
            src_all = src_all[order]
            srcs_u = np.unique(src_all)
            bounds = np.searchsorted(src_all,
                                     np.append(srcs_u, np.iinfo(np.int64).max))
            by_source: dict[int, np.ndarray] = {}
            for k, src in enumerate(srcs_u.tolist()):
                rows = arr[bounds[k] : bounds[k + 1]]
                ctx_rows = np.empty((len(rows), 4), dtype=np.int64)
                ctx_rows[:, 0] = rows[:, 1]
                ctx_rows[:, 1] = rows[:, 2]
                ctx_rows[:, 2] = rows[:, 3]
                ctx_rows[:, 3] = rows[:, 0] % 6
                by_source[src] = ctx_rows
            results = {}
            if self.cfg.frame_shift > 0:
                # frameshift mode runs the legacy 3-frame pipeline
                # (reference align.cpp:168-171); the block's reads share
                # the card's score-only launches, window by window
                from diamond_tpu_torch.align.frameshift import extend_block_frameshift

                return extend_block_frameshift(
                    [(s, by_source[s]) for s in sorted(by_source)],
                    self.queries, self.t, self.cfg)
            for sidx in sorted(by_source):
                m = extend_query_translated(sidx, by_source[sidx],
                                            self.queries, self.t, self.cfg)
                if m:
                    results[sidx] = m
            return results
        # one global (query, subject, seed_offset) sort: per-query slices
        # arrive in load_hits order, so extension skips its per-query
        # lexsort (ties keep emission order — lexsort is stable); the
        # target-id/local-offset resolution also runs once here instead
        # of per query (columns 3/4)
        order = np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))
        arr = arr[order]
        self.ctx.hits_presorted = True
        tid_all, j_all = self.t.global_to_local(arr[:, 1])
        arr5 = np.empty((len(arr), 5), dtype=np.int64)
        arr5[:, 0:3] = arr[:, 1:4]
        arr5[:, 3] = tid_all
        arr5[:, 4] = j_all
        qids_u = np.unique(arr[:, 0])
        bounds = np.searchsorted(arr[:, 0],
                                 np.append(qids_u, np.iinfo(np.int64).max))
        by_query = {int(qid): arr5[bounds[k] : bounds[k + 1]]
                    for k, qid in enumerate(qids_u.tolist())}
        qids = sorted(by_query)
        from diamond_tpu_torch.utils.log import ptimer

        with ptimer("ext.pre_round1"):
            self._precompute_round1(arr[:, 0], arr5)
        from diamond_tpu_torch.utils.device import device_dp_enabled

        if qids and device_dp_enabled():
            # cross-query batched DP: the score-only jobs of every round go
            # to DeviceDP (the kernel on cuda, its plain version on a CPU)
            from diamond_tpu_torch.align.wave import extend_wave
            from diamond_tpu_torch.ops.swipe_device import DeviceDP

            mat = self.cfg.matrix
            mesh = None
            if getattr(self.cfg, "mesh_devices", 0):
                # --mesh N: shard each device mega-batch's tiles over the
                # 'db' mesh axis (the reference's multi-process DB split,
                # double_indexed.cpp:346-396, as ICI-parallel shards)
                from diamond_tpu_torch.parallel.sharded import make_mesh

                mesh = make_mesh(self.cfg.mesh_devices, self.device)
            device = DeviceDP(mat.matrix32, mat.gap_open, mat.gap_extend,
                              device=self.device, mesh=mesh)
            return extend_wave(self.ctx, by_query, qids, device)
        if self.cfg.threads > 1 and len(qids) > 1 and _can_fork():
            return _extend_parallel(self.ctx, by_query, qids,
                                    self.cfg.threads)
        if qids:
            # host-only wave: cross-query native DP batches (one call per
            # round instead of one per query)
            from diamond_tpu_torch.align.wave import extend_wave

            return extend_wave(self.ctx, by_query, qids, None)
        results = {}
        for qid in qids:
            results[qid] = extend_query(qid, by_query[qid], self.ctx)
        return results


def _hit_rows(qidx, sp, qoff, scores, idx) -> np.ndarray:
    """[N,4] int64 hit rows (query_id, subject_gpos, seed_offset, score).

    Scores saturate at 255 like the reference's uint8 SIMD window scores
    (reference stage2.h:113 DP::window_ungapped_best, hit.h score_)."""
    out = np.empty((len(idx), 4), dtype=np.int64)
    out[:, 0] = qidx[idx]
    out[:, 1] = sp[idx]
    out[:, 2] = qoff[idx]
    out[:, 3] = np.minimum(scores[idx], 255)
    return out


def _partition(total: int, parts: int):
    """reference util Partition: ceil-divided chunks."""
    size = (total + parts - 1) // parts
    out = []
    for i in range(parts):
        lo = min(i * size, total)
        hi = min(lo + size, total)
        out.append((lo, hi))
    return out


# ---------------------------------------------------------------------------
# process-parallel extension (-p): queries are independent; output stays in
# query order so multithreaded output is byte-identical to single-threaded
# (the reference's ReorderQueue determinism contract, SURVEY §4)
# ---------------------------------------------------------------------------

_MP_CTX = None


def _can_fork() -> bool:
    import multiprocessing
    import sys

    from diamond_tpu_torch.utils.device import stage12_device_enabled

    # forked children run host code only: the DeviceDP route never forks
    if stage12_device_enabled():
        return False  # forked children must not touch the CUDA context
    return sys.platform.startswith("linux") and \
        "fork" in multiprocessing.get_all_start_methods()


def _mp_extend(arg):
    qid, query_hits = arg
    return qid, extend_query(qid, query_hits, _MP_CTX)


def _mp_stage12_slice(arg):
    g0, g1 = arg
    pipe, join, shape, sid, chunk, part_lo, part_hi, group_keep = _MP_CTX
    return pipe._stage12_slice(g0, g1, join, shape, sid, chunk, part_lo,
                               part_hi, group_keep)


def _extend_parallel(ctx, by_query, qids, threads: int):
    import multiprocessing

    global _MP_CTX
    _MP_CTX = ctx  # inherited by forked children (blocks shared, not pickled)
    try:
        with multiprocessing.get_context("fork").Pool(threads) as pool:
            results = {}
            for qid, matches in pool.imap(
                    _mp_extend, ((q, by_query[q]) for q in qids),
                    chunksize=max(1, len(qids) // (threads * 8))):
                results[qid] = matches
            return results
    finally:
        _MP_CTX = None
