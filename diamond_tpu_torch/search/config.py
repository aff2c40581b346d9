"""Search configuration and sensitivity traits.

Reference: src/search/setup.cpp:40-68 (traits table), src/basic/config.cpp
(option defaults), align/extend.cpp:62-75 (extension modes).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from diamond_tpu_torch.seed import reduction as red
from diamond_tpu_torch.seed.shapes import SHAPE_CODES, ShapeConfig
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix


@dataclass
class SensitivityTraits:
    sensitivity: str
    motif_masking: bool
    freq_sd: float
    min_identities: int
    ungapped_evalue: float
    ungapped_evalue_short: float
    gapped_filter_evalue: float
    index_chunks: int
    query_bins: int
    seed_cut: float
    reduction: object
    ext_mode: str  # banded-fast / banded-slow
    sketch: int = 0  # min-hash sketch size (reference traits, FASTER=21)


# ordered sensitivity ranks (reference basic/config.h:29)
SENS_RANK = {
    "faster": -1, "fast": 0, "default": 1, "linclust-40": 2, "shapes-6x10": 3,
    "shapes-30x10": 4, "linclust-20": 5, "mid-sensitive": 6, "shape-mask": 7,
    "sensitive": 8, "more-sensitive": 9, "very-sensitive": 10, "ultra-sensitive": 11,
}

TRAITS = {
    "faster": SensitivityTraits("faster", True, 50.0, 11, 0, 0, 0, 4, 16, 0.9, red.MURPHY10, "banded-fast", sketch=21),
    "fast": SensitivityTraits("fast", True, 50.0, 11, 0, 0, 0, 4, 16, 0.9, red.MURPHY10, "banded-fast"),
    "linclust-20": SensitivityTraits("linclust-20", True, 50.0, 11, 0, 0, 0, 4, 16, 0.9, red.MURPHY10, "banded-fast"),
    "linclust-40": SensitivityTraits("linclust-40", True, 50.0, 11, 0, 0, 0, 4, 16, 0.9, red.MURPHY10, "banded-fast"),
    "default": SensitivityTraits("default", True, 50.0, 11, 10000, 10000, 0, 4, 16, 0.8, red.MURPHY10, "banded-fast"),
    "mid-sensitive": SensitivityTraits("mid-sensitive", True, 20.0, 11, 10000, 10000, 0, 4, 16, 1.0, red.MURPHY10, "banded-fast"),
    "sensitive": SensitivityTraits("sensitive", True, 20.0, 11, 10000, 10000, 1, 4, 16, 1.0, red.MURPHY10, "banded-fast"),
    "more-sensitive": SensitivityTraits("more-sensitive", False, 200.0, 11, 10000, 10000, 1, 4, 16, 1.0, red.MURPHY10, "banded-slow"),
    "very-sensitive": SensitivityTraits("very-sensitive", False, 15.0, 9, 100000, 30000, 1, 1, 16, 1.0, red.MURPHY10, "banded-slow"),
    "ultra-sensitive": SensitivityTraits("ultra-sensitive", False, 20.0, 9, 300000, 30000, 1, 1, 64, 1.0, red.MURPHY10, "banded-slow"),
}


def seedp_bits(reduction_size: int, weight: int, threads: int, index_chunks: int) -> int:
    """reference search/setup.cpp:306-309."""
    space = reduction_size ** weight - 1
    return max(space.bit_length() - 32, (threads * 4 * index_chunks - 1).bit_length(), 8)


def block_size(memory_limit: int, db_letters: int, sensitivity: str,
               lin: bool, thread_count: int):
    """Memory-limit (-M) -> (block size in Gletters, index chunks)
    (reference basic/config.cpp:97-130)."""
    from diamond_tpu_torch.seed.shapes import SHAPE_CODES, Shape

    AVG_SEQ_LENGTH_EST = 200.0
    m = memory_limit / 1e9
    traits = TRAITS[sensitivity]
    sketch = traits.sketch
    minimizer = 0  # per-sensitivity minimizer windows are not used
    max_c = 1 if (minimizer > 0 or sketch > 0) else (16 if lin else 4)
    weight = Shape(SHAPE_CODES[sensitivity][0]).weight
    rank = SENS_RANK[sensitivity]
    max_b = 32768.0 if lin else (
        12.0 if rank <= SENS_RANK["default"]
        else (6.0 if rank <= SENS_RANK["more-sensitive"] else 1.6))
    c = 0
    while True:
        c += 1
        seeds_per_letter = (sketch / AVG_SEQ_LENGTH_EST
                            if sketch > 0 else 1.0) / c
        if minimizer > 0:
            seeds_per_letter /= minimizer / 2.0
        bits = seedp_bits(traits.reduction.size, weight, thread_count, c)
        hash_join_factor = 1.0 + thread_count / ((1 << bits) / c)
        seed_array_entry_size = 18.0 * hash_join_factor
        b = m / (seed_array_entry_size * seeds_per_letter + 2.0)
        if not (round(b * 1e9) < db_letters and b < max_b and c < max_c):
            break
    b = min(b, max_b)
    return max(b, 0.001), c


@dataclass
class SearchConfig:
    matrix: ScoreMatrix
    sensitivity: str = "default"
    comp_based_stats: int = 1
    max_evalue: float = 0.001
    max_target_seqs: int = 25
    max_hsps: int = 1
    min_bit_score: float = 0.0
    toppercent: float | None = None
    threads: int = 1
    index_chunks: int | None = None
    freq_masking: bool = False
    kmer_ranking: bool = False  # --kmer-ranking: linclust pivot by kmer
                                # counts (reference kmer_ranking.cpp)
    algo: str | None = None  # --algo: 0/double-indexed, 1/query-indexed,
                             # None=auto (reference setup.cpp:311-320)
    masking: str = "tantan"
    motif_masking: bool | None = None
    ungapped_xdrop_bits: float = 12.3
    inner_culling_overlap: float = 50.0
    ranking_score_drop_factor: float = 0.95
    ranking_cutoff_bitscore: float = 25.0
    min_id: float = 0.0
    approx_min_id: float = 0.0
    query_cover: float = 0.0
    subject_cover: float = 0.0
    no_self_hits: bool = False
    self_search: bool = False
    translated: bool = False
    global_ranking: int = 0  # -g N (reference config.cpp:304)
    n_shapes: int = 0        # -s N: use first N seed shapes (config.cpp:285)
    shape_mask: list | None = None  # --shape-mask custom shapes
                             # (reference setup.cpp:362)
    minimizer_window: int = 0  # --minimizer-window (reference EnumCfg)
    ext: str | None = None   # --ext override; linearized rounds force "full"
                             # (reference setup.cpp:377-382)
    frame_shift: int = 0     # -F penalty; >0 selects the 3-frame pipeline
    db_letters: int = 0      # override for e-value stats (taxon filters set
                             # the reference's quirky len+1-per-seq count)
    mesh_devices: int = 0    # --mesh N: shard full-matrix scoring over an
                             # N-device jax mesh (framework extension)
    query_range_culling: bool = False  # --range-culling (requires -F)
    query_range_cover: float = 50.0    # --range-cover default (config.cpp:441)
    lin_stage1_target: bool = False  # linearized stage 1: one target
                             # occurrence per seed (reference kernel_lin.h:132)
    # derived
    traits: SensitivityTraits = None
    shapes: ShapeConfig = None
    reduction: object = None
    seed_complexity_cut: float = 0.0
    hamming_filter_id: int = 11
    seedp_bits_: int = 8
    xdrop_raw: int = 0

    def __post_init__(self):
        # remember CLI-given (pre-resolution) values so per-round configs in
        # iterated search can re-resolve against their own traits
        self._user_index_chunks = self.index_chunks
        self._user_motif_masking = self.motif_masking
        if self.max_target_seqs == 0:  # -k0 = unlimited (reference config.cpp)
            self.max_target_seqs = 1 << 62
        self.traits = TRAITS[self.sensitivity]
        self.shapes = ShapeConfig(
            self.shape_mask if self.shape_mask else
            SHAPE_CODES[self.sensitivity], self.n_shapes)
        if self.shape_mask and len({s.weight for s in self.shapes.shapes}) > 1:
            raise ValueError("Seed shape weight has to be uniform.")
        self.reduction = self.traits.reduction
        self.seed_complexity_cut = (self.traits.seed_cut * np.log(2.0)
                                    * self.shapes[0].weight)
        # --approx-id raises the stage-1 Hamming identity cutoff (reference
        # setup.cpp:70-78,343 approx_id_to_hamming_id: >=50 -> 20, >=90 -> 30)
        aid_hamming = (30 if self.approx_min_id >= 90.0
                       else 20 if self.approx_min_id >= 50.0 else 0)
        self.hamming_filter_id = max(self.traits.min_identities, aid_hamming)
        if self.index_chunks is None:
            self.index_chunks = self.traits.index_chunks
        self.seedp_bits_ = seedp_bits(self.reduction.size, self.shapes[0].weight,
                                      self.threads, self.index_chunks)
        self.xdrop_raw = self.matrix.rawscore(self.ungapped_xdrop_bits)
        if self.motif_masking is None:
            # motif soft-masking is disabled under --freq-masking
            # (reference setup.cpp:323-324 soft_masking_algo)
            self.motif_masking = self.traits.motif_masking \
                and not self.freq_masking

    @property
    def ext_mode(self) -> str:
        if self.ext == "global":
            # the reference's semi-global mode is broken upstream
            # ("Traceback error" on plain inputs); on the inputs where the
            # reference works its output equals the banded default, which
            # is what we run
            return self.traits.ext_mode
        if self.ext is not None:
            return self.ext
        if self.global_ranking or self.lin_stage1_target:
            return "full"
        return self.traits.ext_mode

    @property
    def seedp_count(self) -> int:
        return 1 << self.seedp_bits_

    @property
    def seedp_mask(self) -> int:
        return self.seedp_count - 1

    @property
    def gapped_filter_evalue(self) -> float:
        return self.traits.gapped_filter_evalue
