"""The port's copies of diamond_tpu's host modules stay copies.

Every file of diamond_tpu_torch that has a counterpart at the same relative
path in diamond_tpu equals it once the package name is normalised, except
the modules the port changes on purpose (ALLOWED, each with its reason and
the most diff lines its edit may take).  The CLI keeps diamond_tpu's
argparse surface, so every flag parses the same way.
"""
import difflib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "diamond_tpu_torch")
REF = os.path.join(REPO, "diamond_tpu")

# relative path -> (reason, most changed lines in an ndiff against the source)
ALLOWED = {
    "__init__.py": ("docstring names the port", 2),
    "stats/evalue.py": ("evalue_jax, the jax twin, removed", 31),
    "align/extend.py": ("the direct DP route (the uniform-band kernel "
                        "on score-only batches) and its batch threshold "
                        "removed: _run_dp_jobs runs every job on the host "
                        "DP", 43),
    "align/wave.py": ("comment on the lazy torch import; on the card "
                      "route the traceback round refills the jobs within "
                      "DeviceDP's band cap with the port's D4 "
                      "(ops/traceback_device.tb_multi_device) on the "
                      "DeviceDP's device, the rest with the native call, "
                      "results merged in job order; each round under the "
                      "span wave.round; the unfused score-only round 1 "
                      "and the environment switch that chose it removed: "
                      "round 1 always takes _score_multi_fused", 107),
    "search/pipeline.py": ("device route builds the port's DeviceDP on "
                           "the resolved device, with --mesh over the "
                           "port's make_mesh; stage 1/2 on the card hands "
                           "the seed join to the port's Stage12Device on "
                           "the resolved device (join_rows: the whole fused "
                           "pass, left-most included, on the card, no pair "
                           "expanded on the host) where the reference "
                           "expands pairs and runs self-hit, clip and "
                           "left-most on the host; _can_fork reads the "
                           "port's stage 1/2 knob; -F extends the block's "
                           "reads in one call; the spans mask.block and "
                           "mask.seg around the block masking (mask_block, "
                           "mask_block_seg wrap the copies' bodies) and "
                           "search.motif around the motif ranges; the "
                           "stage-1/2 counters read the span state at each "
                           "call; every route resolves its device, "
                           "Pipeline and mask_block take none; on a CUDA "
                           "device _mask_block masks through the port's "
                           "tantan kernel (ops/tantan_device.mask_letters, "
                           "the same bits as the native scan), the "
                           "unmasked copy taken while "
                           "the card masks, its letters counted in "
                           "mask.card_letters / mask.host_letters; on a "
                           "CUDA device the query-indexed route's fused "
                           "DB-side enumeration runs through the port's "
                           "seed kernel (_enumerate_t_card: "
                           "ops/seed_enum_device, the same keys and "
                           "positions in the same order as the native "
                           "pass), the target letters uploaded once a "
                           "search, its DB positions counted in "
                           "seed.card_positions / seed.host_positions; "
                           "the left-most filter's seed-partition table "
                           "(_part_table, shared by the native and the "
                           "card pass) is built only where a chunk's "
                           "pairs x index_chunks reach the measured "
                           "PAIRS_PER_LETTER a target letter, under the "
                           "span seed.part_table, counted in "
                           "seed.part_table_letters / seed.part_inline",
                           232),
    "align/frameshift.py": ("reads are prepared (steps 1-2), their score-"
                            "only jobs scored by the port's 3-frame kernel "
                            "on the resolved device in windows of reads "
                            "with its own band cap and no cells threshold, "
                            "then finished (steps 3-6) in order", 175),
    "align/swipe_all.py": ("_device_swipe_dispatch builds the port's "
                           "FullSweep on the resolved device; _mesh_for "
                           "caches the port's torch-device mesh; the "
                           "blocks of swipe_all_protein under the spans "
                           "swipe.mask, swipe.dispatch, swipe.host_tail and "
                           "swipe.finish (indented into with-blocks)", 111),
    "utils/log.py": ("the spans: one primitive (Span, ptimer, kspan) that "
                     "keeps label, start, end, id, parent and request ids "
                     "in a bounded buffer (spans()), a profiler range "
                     "while torch.profiler records, a kernel call's work "
                     "and CUDA events; on and off at any time (enable), "
                     "no allocation while off", 158),
    "cluster/mcl.py": ("MCL's dense step (D3) runs as fp32 torch ops with "
                       "TF32 off on the resolved device (mcl_dense_torch, "
                       "its calls on a card counted) where the reference "
                       "ran jax", 85),
    "tools_cmds.py": ("cmd_info reports torch, CUDA and the cards instead "
                      "of jax's devices", 15),
    "stats/alp_exact.py": ("the docstring names the ALP library by its "
                           "place in the reference tree, not by a path on "
                           "one machine", 2),
}
# written for the port (no verbatim counterpart kept)
REWRITTEN = {"benchmark.py", "cli.py", "ops/__init__.py",
             "ops/swipe_device.py", "utils/device.py",
             "parallel/sharded.py", "parallel/dist_search.py",
             "parallel/dist_worker.py"}


def _port_files():
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), PORT)
            if os.path.exists(os.path.join(REF, rel)) and not f.endswith(".pyc"):
                out.append(rel)
    return sorted(out)


def _read(base, rel):
    with open(os.path.join(base, rel), "rb") as f:
        return f.read().decode().replace("diamond_tpu_torch", "diamond_tpu")


def test_copy_set_is_complete():
    files = _port_files()
    assert len(files) >= 45
    for rel in ALLOWED:
        assert rel in files, rel
    for must in ("native/__init__.py", "native/src/swipe_lanes.cc",
                 "align/global_ranking.py", "search/iterate.py",
                 "search/blocked.py", "parallel/mp.py",
                 "parallel/match_codec.py", "utils/external_sort.py",
                 "cluster/workflow.py", "cluster/multinode.py",
                 "cluster/gvc.py", "cluster/realign.py",
                 "native/src/swipe3.cc", "data/translate.py",
                 "search/blastx.py", "ops/swipe3.py",
                 "ops/banded_swipe.py", "output/sam.py", "output/xml.py",
                 "stats/matrix_adjust.py", "align/gapped_filter.py",
                 "masking/motifs_data.txt", "masking/seg.py",
                 "masking/_seg_lnfact.py", "stats/alp.py",
                 "stats/alp_exact.py", "data/seed_index.py",
                 "search/blastn.py", "parallel/sharded.py",
                 "parallel/dist_search.py", "parallel/dist_worker.py"):
        assert must in files, must


@pytest.mark.parametrize("rel", [r for r in _port_files() if r not in REWRITTEN])
def test_copy_matches_source(rel):
    port, ref = _read(PORT, rel), _read(REF, rel)
    if rel not in ALLOWED:
        assert port == ref, f"{rel} drifted from diamond_tpu/{rel}"
        return
    reason, limit = ALLOWED[rel]
    changed = [ln for ln in difflib.ndiff(ref.splitlines(), port.splitlines())
               if ln[:1] in "+-"]
    assert 0 < len(changed) <= limit, (rel, reason, changed)


def test_evalue_copy_is_source_without_jax_twin():
    port, ref = _read(PORT, "stats/evalue.py"), _read(REF, "stats/evalue.py")
    want = ref[:ref.index("\n\ndef evalue_jax")] + "\n"
    want = want.replace(
        "A jax twin (`evalue_jax`) is provided for on-device filtering.\n", "")
    assert port == want


def _surface(parser):
    import argparse

    out = {}
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            for name, sp in act.choices.items():
                out[name] = _surface(sp)
        else:
            out[tuple(act.option_strings) or act.dest] = (
                act.dest, act.default, act.nargs, act.const, act.type,
                tuple(act.choices or ()), act.required)
    return out


def test_cli_parser_surface_matches():
    from diamond_tpu.cli import build_parser as ref_parser
    from diamond_tpu_torch.cli import build_parser as port_parser

    assert _surface(port_parser()) == _surface(ref_parser())
    args = ["blastp", "-q", "a.faa", "-d", "b.faa", "-f", "6", "qseqid",
            "--sensitive", "-k", "5", "-e", "1e-5", "--id", "40"]
    assert vars(port_parser().parse_args(args)) == \
        vars(ref_parser().parse_args(args))
