"""Command-line interface of the PyTorch/CUDA port.

The argparse surface is diamond_tpu's (reference src/run/main.cpp:73-234), so
flags parse identically, and every command and option diamond_tpu's CLI
accepts runs here: ``blastp`` and ``blastx`` with all their options (among
them ``--swipe``, ``-g``, ``--iterate``, ``-b``/``-M``,
``--multiprocessing``, ``--masking seg``, ``--custom-matrix``,
``--target-indexed``, ``--mesh N`` and ``--coordinator/--num-procs/
--proc-id``), ``blastn``, ``makedb``, ``makeidx``, ``dbinfo``, ``view``,
``merge-daa``, ``version``, the clustering commands, ``benchmark``,
``test``, and the tool commands (``getseq``, ``random-seqs``, ``mask``,
``fastq2fasta``, ``info``, ``reverse``, ``hashseqs``, ``split``,
``listseeds``, ``smith-waterman``, ``greedy-vertex-cover``; ``roc``,
``rocid``, ``prepdb``, ``reassign`` and ``recluster`` answer as the
reference does).

The device DP (the extension rounds of ``blastp`` and of every search
the drivers and the cluster rounds run, the 3-frame DP of ``blastx -F``,
the ``blastp --swipe`` sweep, MCL's dense step) runs on the CUDA card unless
DIAMOND_TPU_TORCH_DEVICE=cpu asks for the CPU; without a card and without
that request, the search exits with an error (see utils/device.py for the
DP routing knobs).  ``--mesh N`` shards it over the first N cards (or N CPU
shards, or the ranks of a ``--coordinator`` process group); with fewer
cards than N it takes the cards there are, and the output never depends on
the mesh's size (parallel/sharded.py).  ``blastn`` runs its DP on the host,
as in the reference.
"""
from __future__ import annotations

import argparse
import sys

from diamond_tpu_torch.utils.log import ptimer


def build_parser():
    p = argparse.ArgumentParser(prog="diamond-tpu-torch",
                                description="protein aligner (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command")

    def common_io(sp, query=True):
        sp.add_argument("--db", "-d", required=True, help="database file")
        if query:
            sp.add_argument("--query", "-q", help="query input file")
        sp.add_argument("--out", "-o", default="-", help="output file")
        sp.add_argument("--outfmt", "-f", nargs="*", default=["6"],
                        help="output format")
        sp.add_argument("--threads", "-p", type=int, default=1)
        sp.add_argument("--verbose", "-v", action="store_true")
        sp.add_argument("--quiet", action="store_true")
        sp.add_argument("--log", dest="log_path", default=None)

    def search_opts(sp):
        sp.add_argument("--evalue", "-e", type=float, default=0.001)
        sp.add_argument("--max-target-seqs", "-k", type=int, default=25)
        sp.add_argument("--top", type=float, default=None)
        sp.add_argument("--max-hsps", type=int, default=1)
        sp.add_argument("--matrix", default="BLOSUM62")
        sp.add_argument("--custom-matrix", default=None,
                        help="file containing custom scoring matrix")
        sp.add_argument("--gapopen", type=int, default=-1)
        sp.add_argument("--gapextend", type=int, default=-1)
        sp.add_argument("--comp-based-stats", type=int, default=1)
        sp.add_argument("--masking", default="tantan")
        sp.add_argument("--motif-masking", type=int, default=None)
        sp.add_argument("--index-chunks", "-c", type=int, default=None)
        sp.add_argument("--block-size", "-b", type=float, default=None)
        sp.add_argument("--memory-limit", "-M", default=None,
                        help="memory limit (e.g. 16G) -> derives -b/-c")
        sp.add_argument("--daa-build-version", type=int, default=0)
        sp.add_argument("--no-auto-append", action="store_true")
        sp.add_argument("--global-ranking", "-g", type=int, default=0)
        sp.add_argument("--shapes", "-s", type=int, default=0)
        sp.add_argument("--iterate", nargs="*", default=None)
        sp.add_argument("--shape-mask", nargs="+", default=None)
        sp.add_argument("--minimizer-window", type=int, default=0)
        sp.add_argument("--taxonlist", default=None)
        sp.add_argument("--taxon-exclude", default=None)
        sp.add_argument("--taxon-k", type=int, default=0)
        sp.add_argument("--target-indexed", action="store_true")
        sp.add_argument("--multiprocessing", action="store_true")
        sp.add_argument("--mp-init", action="store_true")
        sp.add_argument("--mp-recover", action="store_true")
        sp.add_argument("--parallel-tmpdir", default=None)
        sp.add_argument("--id", dest="min_id", type=float, default=0.0)
        sp.add_argument("--no-self-hits", action="store_true")
        sp.add_argument("--freq-masking", action="store_true")
        sp.add_argument("--dbsize", type=int, default=0)
        sp.add_argument("--compress", default="0")  # 0, 1 (gzip), zstd
        sp.add_argument("--algo", default=None,
                        help="0/double-indexed, 1/query-indexed (auto)")
        # accepted for drop-in compatibility; behavior already canonical
        sp.add_argument("--header", nargs="*", default=None)
        sp.add_argument("--file-buffer-size", type=int, default=None)
        sp.add_argument("--query-parallel-limit", type=int, default=None)
        sp.add_argument("--tmpdir", default=None)
        sp.add_argument("--soft-masking", default=None)
        sp.add_argument("--approx-id", type=float, default=0.0)
        sp.add_argument("--ext", dest="ext", default=None,
                        choices=["banded-fast", "banded-slow", "full",
                                 "none", "global"])
        sp.add_argument("--query-cover", type=float, default=0.0)
        sp.add_argument("--subject-cover", type=float, default=0.0)
        # --swipe: exhaustive full-matrix SW, no seeding (reference
        # align/full_db.cpp); --mesh N runs its scoring round sharded over
        # N devices (parallel/sharded.py; 0 = single device)
        sp.add_argument("--swipe", action="store_true")
        # --mesh N also shards the standard blastp/blastx device DP
        # mega-batches (search/pipeline._extend_all -> DeviceDP(mesh=...))
        sp.add_argument("--mesh", dest="mesh", type=int, default=0)
        # multi-process bring-up (torch.distributed): all three, or the
        # DIAMOND_TPU_TORCH_COORDINATOR_ADDRESS / _NUM_PROCESSES /
        # _PROCESS_ID env vars (utils/device.init_distributed)
        sp.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (torch.distributed)")
        sp.add_argument("--num-procs", type=int, default=None)
        sp.add_argument("--proc-id", type=int, default=None)
        sens = sp.add_mutually_exclusive_group()
        for flag, name in [("--faster", "faster"), ("--fast", "fast"),
                           ("--mid-sensitive", "mid-sensitive"),
                           ("--sensitive", "sensitive"),
                           ("--more-sensitive", "more-sensitive"),
                           ("--very-sensitive", "very-sensitive"),
                           ("--ultra-sensitive", "ultra-sensitive")]:
            sens.add_argument(flag, dest="sensitivity", action="store_const",
                              const=name)
        sp.set_defaults(sensitivity="default")

    sp = sub.add_parser("makedb", help="Build DIAMOND database from FASTA")
    sp.add_argument("--in", dest="infile", required=True)
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--masking", default="tantan")
    sp.add_argument("--taxonmap", default=None)
    sp.add_argument("--taxonnodes", default=None)
    sp.add_argument("--taxonnames", default=None)

    for cmd in ("blastp", "blastx"):
        sp = sub.add_parser(cmd, help=f"{cmd} alignment search")
        common_io(sp)
        search_opts(sp)
        if cmd == "blastx":
            sp.add_argument("--query-gencode", type=int, default=1)
            sp.add_argument("--frameshift", "-F", type=int, default=0)
            sp.add_argument("--min-orf", dest="min_orf", type=int, default=0)
            sp.add_argument("--strand", default="both",
                            choices=["both", "plus", "minus"])
            sp.add_argument("--range-culling", action="store_true")
            sp.add_argument("--range-cover", type=float, default=50.0)
            sp.add_argument("--long-reads", action="store_true")

    sp = sub.add_parser("view", help="View DIAMOND alignment archive (DAA)")
    sp.add_argument("--daa", "-a", required=True)
    sp.add_argument("--out", "-o", default="-")
    sp.add_argument("--outfmt", "-f", nargs="*", default=["6"])
    sp.add_argument("--threads", "-p", type=int, default=1)
    sp.add_argument("--max-target-seqs", "-k", type=int, default=25)

    sp = sub.add_parser("dbinfo", help="Print database info")
    sp.add_argument("--db", "-d", required=True)

    sp = sub.add_parser("version", help="Print version")

    for cmd in ("cluster", "linclust", "deepclust"):
        sp = sub.add_parser(cmd, help=f"{cmd} clustering")
        sp.add_argument("--db", "-d", required=True)
        sp.add_argument("--out", "-o", default="-")
        sp.add_argument("--approx-id", type=float, default=None)
        sp.add_argument("--member-cover", type=float, default=80.0)
        sp.add_argument("--mutual-cover", type=float, default=None)
        sp.add_argument("--threads", "-p", type=int, default=1)
        sp.add_argument("--reps", default=None,
                        help="representative sequences FASTA output")
        sp.add_argument("--cluster-steps", nargs="+", default=None)
        sp.add_argument("--cluster-algo", default=None, choices=["mcl"])
        sp.add_argument("--cluster-threshold", type=float, default=None)
        sp.add_argument("--mcl-expansion", type=int, default=2)
        sp.add_argument("--mcl-inflation", type=float, default=2.0)
        sp.add_argument("--mcl-max-iterations", type=int, default=100)
        sp.add_argument("--multiprocessing", action="store_true")
        sp.add_argument("--parallel-tmpdir", default=None)
        sp.add_argument("--mp-recover", action="store_true")
        sp.add_argument("--kmer-ranking", action="store_true",
                        help="rank sequences by kmer frequency in the "
                             "linear stage (reference kmer_ranking.cpp)")
        sp.add_argument("--block-size", "-b", type=float, default=None)
        sp.add_argument("--mcl-nonsymmetric", action="store_true")

    sp = sub.add_parser("getseq", help="Extract sequences from database")
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--seq", nargs="*", default=[])
    sp.add_argument("--out", "-o", default="-")

    sp = sub.add_parser("realign", help="Align cluster members to centroids")
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--clusters", required=True)
    sp.add_argument("--out", "-o", default="-")
    sp.add_argument("--threads", "-p", type=int, default=1)

    sp = sub.add_parser("merge-daa", help="Merge DAA archives")
    sp.add_argument("--in", dest="infiles", nargs="+", required=True)
    sp.add_argument("--out", "-o", required=True)

    # tool commands (reference run/main.cpp:145-234)
    sp = sub.add_parser("random-seqs", help="Sample random sequences from db")
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--seqs", "-n", type=int, required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = sub.add_parser("mask", help="tantan-mask a FASTA file")
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = sub.add_parser("fastq2fasta", help="Convert FASTQ to FASTA")
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = sub.add_parser("info", help="Print platform/backend info")

    sp = sub.add_parser("reverse", help="Reverse sequences")
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--out", "-o", default="-")

    sp = sub.add_parser("hashseqs", help="Print murmur3 hashes of sequences")
    sp.add_argument("--query", "-q", required=True)

    sp = sub.add_parser("split", help="Split input into FASTA volumes")
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--chunk-size", type=float, default=1.0)
    sp.add_argument("--prefix", default="")

    sp = sub.add_parser("listseeds", help="Most frequent seeds in db")
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--count", "-n", type=int, default=20)

    sp = sub.add_parser("blastn", help="nucleotide search (contrib/dna)")
    sp.add_argument("--db", "-d", required=True)
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--out", "-o", default="-")
    sp.add_argument("--outfmt", "-f", nargs="*", default=["6"])
    sp.add_argument("--threads", "-p", type=int, default=1)
    sp.add_argument("--evalue", "-e", type=float, default=10.0)
    sp.add_argument("--reward", type=int, default=2)
    sp.add_argument("--penalty", type=int, default=-3)
    sp.add_argument("--gapopen", type=int, default=5)
    sp.add_argument("--gapextend", type=int, default=2)

    sp = sub.add_parser("greedy-vertex-cover",
                        help="Cluster an alignment edge list")
    sp.add_argument("--db", "-d", required=True,
                    help="seqid mapping file (one id per line)")
    sp.add_argument("--edges", required=True)
    sp.add_argument("--edge-format", default="default",
                    choices=["default", "triplet"])
    sp.add_argument("--symmetric", action="store_true")
    sp.add_argument("--member-cover", type=float, default=80.0)
    sp.add_argument("--out", "-o", default="-")
    sp.add_argument("--centroid-out", default=None)

    for cmd in ("reassign", "recluster"):
        sub.add_parser(cmd, help=f"{cmd} (disabled, matching the reference)")

    for cmd in ("roc", "rocid"):
        sub.add_parser(cmd, help=f"{cmd} (deprecated, matching the reference)")
    sp = sub.add_parser("prepdb", help="prepdb (deprecated no-op)")
    sp.add_argument("--db", "-d", required=False)

    sp = sub.add_parser("makeidx", help="Build seed index for --target-indexed")
    sp.add_argument("--db", "-d", required=True)
    sens = sp.add_mutually_exclusive_group()
    for flag, name in [("--faster", "faster"), ("--fast", "fast"),
                       ("--mid-sensitive", "mid-sensitive"),
                       ("--sensitive", "sensitive"),
                       ("--more-sensitive", "more-sensitive"),
                       ("--very-sensitive", "very-sensitive"),
                       ("--ultra-sensitive", "ultra-sensitive")]:
        sens.add_argument(flag, dest="sensitivity", action="store_const",
                          const=name)
    sp.set_defaults(sensitivity="default")

    sp = sub.add_parser("test", help="Run built-in self tests")

    sp = sub.add_parser("benchmark", help="Kernel microbenchmarks (ps/cell)")

    sp = sub.add_parser("smith-waterman", help="Pairwise DNA Smith-Waterman")
    sp.add_argument("--query", "-q", required=True)
    sp.add_argument("--reward", type=int, default=2)
    sp.add_argument("--penalty", type=int, default=-3)
    sp.add_argument("--gapopen", type=int, default=5)
    sp.add_argument("--gapextend", type=int, default=2)

    return p


def load_block(path, with_taxonomy: bool = False):
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.data.blastdb import BlastDB, is_blastdb
    from diamond_tpu_torch.data.dmnd import is_dmnd, read_dmnd
    from diamond_tpu_torch.data.fasta import read_seqs

    if not path.endswith((".faa", ".fa", ".fasta", ".dmnd")) \
            and is_blastdb(path):
        ids, seqs = BlastDB(path).load()
        b = Block.from_sequences(seqs, ids)
        return (b, None) if with_taxonomy else b
    if is_dmnd(path):
        if with_taxonomy:
            ids, seqs, tax = read_dmnd(path, with_taxonomy=True,
                                       strip_mask=True)
            return Block.from_sequences(seqs, ids), tax
        ids, seqs = read_dmnd(path, strip_mask=True)
        return Block.from_sequences(seqs, ids)
    recs = list(read_seqs(path))
    b = Block.from_sequences([r[1].upper() for r in recs],
                             [r[0] for r in recs])
    return (b, None) if with_taxonomy else b


def _device(command: str) -> str:
    from diamond_tpu_torch.utils.device import NoDeviceError, resolve_device

    try:
        return resolve_device()
    except (NoDeviceError, ValueError) as e:
        raise SystemExit(f"{command}: {e}")


def cmd_blastp(args):
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.pipeline import Pipeline

    validate_filters(args)
    validate_global_ranking(args)
    device = _device("blastp")
    _init_distributed(args)
    _apply_memory_limit(args)
    if args.block_size is not None:
        return cmd_blastp_blocked(args)
    with ptimer("cli.load"):
        qb = load_block(args.query)
        tb, taxonomy = load_block(args.db, with_taxonomy=True)
    with ptimer("cli.config"):
        tb, taxonomy, db_letters = apply_taxon_filter(tb, taxonomy,
                                                       args.taxonlist,
                                                       args.taxon_exclude)
        if args.dbsize:
            db_letters = args.dbsize  # --dbsize overrides e-value stats
        cfg = SearchConfig(
            matrix=_make_matrix(args),
            sensitivity=args.sensitivity,
            comp_based_stats=args.comp_based_stats,
            max_evalue=args.evalue,
            max_target_seqs=args.max_target_seqs,
            max_hsps=args.max_hsps,
            toppercent=args.top,
            index_chunks=args.index_chunks,
            masking=args.masking,
            motif_masking=(None if args.motif_masking is None
                           else bool(args.motif_masking)),
            min_id=args.min_id,
            approx_min_id=args.approx_id,
            query_cover=args.query_cover,
            subject_cover=args.subject_cover,
            no_self_hits=args.no_self_hits,
            freq_masking=args.freq_masking,
            ext=args.ext,
            global_ranking=args.global_ranking,
            n_shapes=args.shapes,
            shape_mask=args.shape_mask,
            minimizer_window=args.minimizer_window,
            db_letters=db_letters,
            mesh_devices=args.mesh,
            algo=args.algo,
        )
    seed_index = None
    if args.target_indexed:
        from diamond_tpu_torch.data.seed_index import load_seed_index

        seed_index = load_seed_index(args.db + ".seed_idx", cfg)
    if args.swipe:
        from diamond_tpu_torch.align.swipe_all import swipe_all_protein

        results = swipe_all_protein(qb, tb, cfg)
    elif cfg.global_ranking:
        results = _global_ranking_search(cfg, qb, tb)
    elif args.iterate is not None:
        from diamond_tpu_torch.search.iterate import (iterated_search,
                                                      rounds_for)

        rounds = rounds_for(cfg.sensitivity, args.iterate)
        results = iterated_search(cfg, qb, tb, rounds)
    else:
        with ptimer("search.setup"):
            pipe = Pipeline(cfg, qb, tb, target_seed_index=seed_index,
                            device=device)
        results = pipe.search()
    if args.outfmt and args.outfmt[0] in ("100", "daa"):
        from diamond_tpu_torch.data.daa import write_daa

        if args.out == "-":
            raise SystemExit("DAA output requires an output file (-o)")

        write_daa(args.out, results, qb, tb, cfg.matrix, cfg.max_evalue,
                  build_version=getattr(args, "daa_build_version", 0))
        return
    with ptimer("cli.write"):
        out = _open_out(args)
        write_results(out, args.outfmt, results, qb, tb, cfg.matrix,
                      taxonomy=taxonomy, db_path=args.db,
                      max_evalue=cfg.max_evalue,
                      hauser=_cbs_hauser(cfg.comp_based_stats),
                      invocation=" ".join(sys.argv))
        if out is not sys.stdout:
            out.close()


def cmd_blastx(args):
    from diamond_tpu_torch.data.fasta import (read_fastq_full, read_seqs,
                                              sniff_format)
    from diamond_tpu_torch.search.blastx import (TranslatedQueries,
                                                 blastx_search)
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    # --long-reads = --range-culling --top 10 -F 15 (reference config.cpp:680)
    if args.long_reads:
        args.range_culling = True
        if args.top is None:
            args.top = 10.0
        if args.frameshift == 0:
            args.frameshift = 15
    if args.range_culling and args.frameshift == 0:
        raise SystemExit("Query range culling is only supported in frameshift "
                         "alignment mode (option -F).")
    validate_filters(args)
    validate_global_ranking(args)
    _init_distributed(args)
    if args.comp_based_stats >= 2:
        # reference run/config.cpp: matrix adjust needs untranslated queries
        raise SystemExit("This mode of composition based stats is not "
                         "supported for translated searches.")
    _device("blastx")
    quals = None
    if sniff_format(args.query) == "fastq":
        full = list(read_fastq_full(args.query))
        qrecs = [(i, s) for i, s, _ in full]
        quals = [q for _, _, q in full]
    else:
        qrecs = list(read_seqs(args.query))
    tb, taxonomy = load_block(args.db, with_taxonomy=True)
    tb, taxonomy, db_letters = apply_taxon_filter(tb, taxonomy,
                                                   args.taxonlist,
                                                   args.taxon_exclude)
    queries = TranslatedQueries(qrecs, gencode=args.query_gencode,
                                frameshift=args.frameshift,
                                min_orf=args.min_orf or 0,
                                strand=args.strand)
    cfg = SearchConfig(
        matrix=ScoreMatrix(args.matrix, args.gapopen, args.gapextend,
                           frame_shift=args.frameshift),
        sensitivity=args.sensitivity,
        comp_based_stats=args.comp_based_stats,
        max_evalue=args.evalue,
        max_target_seqs=args.max_target_seqs,
        max_hsps=args.max_hsps,
        toppercent=args.top,
        index_chunks=args.index_chunks,
        masking=args.masking,
        min_id=args.min_id,
        query_cover=args.query_cover,
        subject_cover=args.subject_cover,
        translated=True,
        global_ranking=args.global_ranking,
        n_shapes=args.shapes,
        frame_shift=args.frameshift,
        query_range_culling=args.range_culling,
        query_range_cover=args.range_cover,
        db_letters=db_letters,
        mesh_devices=args.mesh,
        algo=args.algo,
    )
    if args.swipe:
        from diamond_tpu_torch.search.blastx import blastx_swipe_all

        results = blastx_swipe_all(queries, tb, cfg)
    elif cfg.global_ranking:
        cfg.translated = True
        results = _global_ranking_search(cfg, queries.block, tb,
                                         queries=queries)
    elif args.iterate is not None:
        from diamond_tpu_torch.search.iterate import (iterated_search,
                                                      rounds_for)

        rounds = rounds_for(cfg.sensitivity, args.iterate)
        results = iterated_search(cfg, queries.block, tb, rounds,
                                  queries=queries)
    else:
        results = blastx_search(queries, tb, cfg)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    write_results(out, args.outfmt, results, queries.block, tb, cfg.matrix,
                  taxonomy=taxonomy, db_path=args.db,
                  max_evalue=cfg.max_evalue, invocation=" ".join(sys.argv),
                  program="blastx", dna_lens=queries.dna_lens,
                  quals=quals,
                  hauser=_cbs_hauser(cfg.comp_based_stats),
                  query_names=[i.split()[0] for i in queries.source_ids])
    if out is not sys.stdout:
        out.close()


def cmd_blastn(args):
    """blastn over minimizer chaining + banded extension (reference
    contrib/dna; the reference ships WITH_DNA off so there is no golden
    contract — functional output in BLASTN's -outfmt 6 conventions:
    query always plus strand, subject coordinates reversed on minus).
    Its DP (with traceback) runs on the host, as in diamond_tpu."""
    from diamond_tpu_torch.data.fasta import read_seqs
    from diamond_tpu_torch.data.taxonomy import seqid
    from diamond_tpu_torch.output.format import format_double, print_e
    from diamond_tpu_torch.search.blastn import blastn_search

    qrecs = [(i, s) for i, s in read_seqs(args.query)]
    trecs = [(i, s) for i, s in read_seqs(args.db)]
    results, (qnames, qseqs), (tnames, tseqs) = blastn_search(
        qrecs, trecs, reward=args.reward, penalty=args.penalty,
        gap_open=args.gapopen, gap_extend=args.gapextend,
        max_evalue=args.evalue)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    for qi in range(len(qnames)):
        for m in results.get(qi, []):
            for h in m.hsp:
                qs, qe = h.query_source_range[0] + 1, h.query_source_range[1]
                if h.frame:  # minus strand: subject printed reversed
                    ss, se = h.subject_range[1], h.subject_range[0] + 1
                else:
                    ss, se = h.subject_range[0] + 1, h.subject_range[1]
                out.write("\t".join([
                    seqid(qnames[qi]), seqid(tnames[m.target_block_id]),
                    format_double(h.identities * 100.0 / h.length),
                    str(h.length), str(h.mismatches), str(h.gap_openings),
                    str(qs), str(qe), str(ss), str(se),
                    print_e(h.evalue), format_double(h.bit_score)]) + "\n")
    if out is not sys.stdout:
        out.close()


def _self_test(device: str):
    """Built-in checks (reference `diamond test`, src/test/test.cpp:54-64;
    diamond_tpu's ``_self_test``): DeviceDP's banded DP (K1 on a card, its
    plain version on a CPU the caller asked for) against the host DP's
    batch and single-job oracles on seeded jobs, plus a bitscore and an
    e-value spot check; exits non-zero on a failure."""
    import numpy as np

    from diamond_tpu_torch.ops.banded_swipe import (banded_swipe_batch_np,
                                                    banded_swipe_np)
    from diamond_tpu_torch.ops.swipe_device import DeviceDP
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    def check(ok, what):
        if not ok:
            raise SystemExit(f"Self test failed: {what}")

    rng = np.random.default_rng(0)
    m = ScoreMatrix("BLOSUM62")
    q = rng.integers(0, 20, 120).astype(np.int8)
    jobs = [(rng.integers(0, 20, 150).astype(np.int8), -32, 32)
            for _ in range(8)]
    batch = banded_swipe_batch_np(q, None, jobs, m.matrix32, m.gap_open,
                                  m.gap_extend)
    dp = DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device=device)
    got = dp.run_many([(q, None, jobs)])[0]
    for (tgt, d0, d1), ref, dev in zip(jobs, batch, got):
        single = banded_swipe_np(q, tgt, d0, d1, m.matrix32, None,
                                 m.gap_open, m.gap_extend)
        check(single.score == ref[0], "batch/single DP mismatch")
        check(tuple(int(x) for x in ref) == dev, "device/host DP mismatch")
    check(abs(float(m.bitscore(100)) - 43.1) < 0.2, "bitscore check")
    m.set_db_letters(1_000_000)
    ev = float(m.evalue(100, 120, 150))
    check(0 < ev < 1e-3, "evalue check")
    print("Self test OK.")


def _open_out(args):
    """--compress output stream: 0=none, 1=gzip, zstd (reference
    config.cpp:151-158,298)."""
    if args.out == "-":
        return sys.stdout
    comp = str(getattr(args, "compress", 0) or 0)
    if comp == "1":
        import gzip

        return gzip.open(args.out + ("" if args.out.endswith(".gz")
                                     else ".gz"), "wt")
    if comp == "zstd":
        from diamond_tpu_torch.utils.zstdio import zstd_open

        return zstd_open(args.out + ("" if args.out.endswith(".zst")
                                     else ".zst"), "wt")
    if comp not in ("0", "none", ""):
        raise SystemExit(f"Invalid compression algorithm: {comp}")
    return open(args.out, "w")


def validate_filters(args):
    """reference run/config.cpp:168-169."""
    if getattr(args, "approx_id", 0) and args.min_id != 0.0:
        raise SystemExit("Incompatible options: --approx-id, --id.")


def validate_global_ranking(args):
    """reference basic/config.cpp:688, run/config.cpp:114-119."""
    if args.global_ranking <= 0:
        return
    if args.comp_based_stats >= 2:
        raise SystemExit("Global ranking is not supported with "
                         "--comp-based-stats >= 2.")
    if getattr(args, "frameshift", 0):
        raise SystemExit("Global ranking mode is not compatible with "
                         "frameshift alignments.")


def apply_taxon_filter(tb, taxonomy, taxonlist: str | None,
                       taxon_exclude: str | None):
    """Database taxonomy subtree filter (reference
    double_indexed.cpp:863-870, sequence_file.cpp:772-792
    filter_by_taxonomy, :996-1034 contained).  Returns (filtered block,
    filtered taxonomy, oid map) or the inputs unchanged."""
    if not taxonlist and not taxon_exclude:
        return tb, taxonomy, 0
    if taxonlist and taxon_exclude:
        raise SystemExit("Options --taxonlist and --taxon-exclude are "
                         "mutually exclusive.")
    if taxonomy is None or taxonomy.nodes is None:
        raise SystemExit("Option requires taxonomy mapping built into the "
                         "database (--taxonmap option of makedb)")
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.data.taxonomy import Taxonomy

    exclude = bool(taxon_exclude)
    fset = {int(t) for t in (taxon_exclude or taxonlist).split(",") if t}
    if not fset:
        raise SystemExit("Option --taxonlist/--taxon-exclude used with "
                         "empty list.")
    if 0 in fset or 1 in fset:
        raise SystemExit("Option --taxonlist/--taxon-exclude used with "
                         "invalid argument (0 or 1).")
    nodes = taxonomy.nodes

    def contained_vec(tids):
        if not tids:
            return exclude  # all() over empty = True; any() = False
        for t in tids:
            c = nodes.contained(t, fset, include_invalid=exclude)
            if c and not exclude:
                return True
            if not c and exclude:
                return False
        return exclude

    keep = [oid for oid in range(len(tb))
            if contained_vec(taxonomy.taxids(oid)) ^ exclude]
    fb = Block.from_sequences([tb.seq(i).copy() for i in keep],
                              [tb.ids[i] for i in keep])
    ft = Taxonomy(taxon_lists=[taxonomy.taxids(i) for i in keep],
                  nodes=taxonomy.nodes, names=taxonomy.names)
    # the reference's filtered letter count sums read_seq sizes, which
    # include one separator per sequence (dmnd.cpp:641, DbFilter
    # letter_count at sequence_file.cpp:788) — mirror for e-value parity
    letters = fb.n_letters + len(fb)
    return fb, ft, letters


def _global_ranking_search(cfg, qb, tb, queries=None):
    """Single-block global ranking (-g): ranking-table search + final
    full-matrix extension (reference double_indexed.cpp:439-446)."""
    from diamond_tpu_torch.align.global_ranking import (RankingTable,
                                                        extend_ranked)
    from diamond_tpu_torch.search.pipeline import Pipeline
    from diamond_tpu_torch.stats.cbs import hauser_correction

    translated = queries is not None
    n_src = len(queries) if translated else len(qb)
    table = RankingTable(n_src, cfg.global_ranking)
    Pipeline(cfg, qb, tb, queries=queries, ranking_table=table).search()
    oid2block = {o: o for o in table.ranked_oids()}

    if translated:
        contexts_fn = queries.contexts
    else:
        def contexts_fn(src):
            return [(0, qb.seq(src))]

    def biases_fn(src):
        out = {}
        for f, q in contexts_fn(src):
            if len(q) == 0:
                continue
            _, i8 = hauser_correction(q, cfg.matrix.matrix32,
                                      cfg.matrix.background_scores)
            out[f] = i8
        return out

    return extend_ranked(table, contexts_fn, biases_fn, tb, oid2block, cfg)


def _parse_memory(v: str) -> int:
    v = str(v).strip()
    mult = 1
    if v and v[-1] in "GgMmKk":
        mult = {"g": 1 << 30, "m": 1 << 20, "k": 1 << 10}[v[-1].lower()]
        v = v[:-1]
    return int(float(v) * mult)


def _apply_memory_limit(args):
    """-M/--memory-limit derives block size and index chunks when not
    explicitly given (reference basic/config.cpp:97-130 block_size)."""
    ml = getattr(args, "memory_limit", None)
    if not ml:
        return
    import os

    from diamond_tpu_torch.search.config import block_size as _bs

    db_letters = 0
    try:
        db_letters = os.path.getsize(args.db)
    except OSError:
        pass
    b, c = _bs(_parse_memory(ml), db_letters, args.sensitivity, False,
               args.threads)
    if args.block_size is None:
        args.block_size = b
    if args.index_chunks is None:
        args.index_chunks = c


def _init_distributed(args):
    """Join a torch.distributed process group when --coordinator (or the
    DIAMOND_TPU_TORCH_COORDINATOR_ADDRESS env) is given; no-op otherwise."""
    from diamond_tpu_torch.utils.device import init_distributed

    init_distributed(getattr(args, "coordinator", None),
                     getattr(args, "num_procs", None),
                     getattr(args, "proc_id", None))


def _make_matrix(args):
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix, custom_matrix

    if getattr(args, "custom_matrix", None):
        if args.gapopen < 0 or args.gapextend < 0:
            raise SystemExit("Custom scoring matrices require setting the "
                             "--gapopen and --gapextend options.")
        if args.comp_based_stats >= 2:
            raise SystemExit("This mode of composition based stats is not "
                             "supported with a custom matrix.")
        return custom_matrix(args.custom_matrix, args.gapopen, args.gapextend)
    return ScoreMatrix(args.matrix, args.gapopen, args.gapextend)


def _cbs_hauser(mode) -> bool:
    from diamond_tpu_torch.stats import cbs

    return cbs.hauser(mode)


def write_results(out, outfmt, results, qb, tb, matrix, taxonomy=None,
                  db_path="", max_evalue=0.001, invocation="",
                  program="blastp", quals=None, hauser=True, **fmt_kw):
    """Dispatch on -f format code (reference output/output_format.cpp:148)."""
    from diamond_tpu_torch.output.tabular import (format_results, render_paf,
                                                  render_pairwise)

    code = outfmt[0] if outfmt else "6"
    if code in ("100", "daa"):
        raise SystemExit("DAA output requires -o FILE (binary); "
                         "handled by the caller")
    if code in ("104", "json-flat"):
        from diamond_tpu_torch.output.tabular import render_json

        out.write(render_json(results, qb, tb, _parse_fields(["6"] + outfmt[1:]),
                              matrix=matrix, taxonomy=taxonomy, **fmt_kw))
    elif code in ("6", "tab"):
        fields = _parse_fields(outfmt)
        for line in format_results(results, qb, tb, fields, matrix=matrix,
                                   taxonomy=taxonomy, quals=quals,
                                   hauser=hauser, **fmt_kw):
            out.write(line + "\n")
    elif code in ("0", "pairwise"):
        out.write(render_pairwise(results, qb, tb, matrix))
    elif code in ("103", "paf"):
        out.write(render_paf(results, qb, tb, matrix))
    elif code in ("5", "xml"):
        from diamond_tpu_torch.output.xml import render_xml

        out.write(render_xml(results, qb, tb, matrix, db_path, max_evalue,
                             program=program, **fmt_kw))
    elif code in ("101", "sam"):
        from diamond_tpu_torch.output.sam import render_sam

        out.write(render_sam(results, qb, tb, matrix, invocation,
                             program=program, **fmt_kw))
    elif code in ("102",):
        from diamond_tpu_torch.output.taxon import render_taxon

        for line in render_taxon(results, qb, tb, taxonomy, **fmt_kw):
            out.write(line + "\n")
    else:
        raise SystemExit(f"Unsupported output format: {code}")


def _parse_fields(outfmt):
    from diamond_tpu_torch.output.tabular import DEFAULT_FIELDS

    if not outfmt or outfmt[0] in ("6", "tab"):
        return outfmt[1:] if len(outfmt) > 1 else DEFAULT_FIELDS
    raise SystemExit(f"Unsupported output format: {outfmt[0]}")


def cmd_blastp_blocked(args):
    """Multi-block search (-b): block swap + merged join."""
    from diamond_tpu_torch.data.dmnd import is_dmnd, read_dmnd
    from diamond_tpu_torch.data.fasta import read_seqs
    from diamond_tpu_torch.output.tabular import format_match_line
    from diamond_tpu_torch.search.blocked import blocked_search
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    def load_seqs_ids(path):
        if is_dmnd(path):
            ids, seqs = read_dmnd(path, strip_mask=True)
            return seqs, ids
        recs = list(read_seqs(path))
        return [r[1].upper() for r in recs], [r[0] for r in recs]

    qseqs, qids = load_seqs_ids(args.query)
    provider = None
    tseqs = tids = None
    taxonomy = None
    if (is_dmnd(args.db) and not args.global_ranking
            and not (args.multiprocessing or args.mp_init
                     or args.mp_recover)):
        # out-of-core path: target blocks stream from the .dmnd per
        # block; only the pos array stays resident
        from diamond_tpu_torch.data.dmnd import DmndProvider

        provider = DmndProvider(args.db)
        if args.taxon_k:
            taxonomy = provider.taxonomy()
    elif args.taxon_k:
        tb_tax, taxonomy = load_block(args.db, with_taxonomy=True)
        tseqs = [tb_tax.seq(i).copy() for i in range(len(tb_tax))]
        tids = tb_tax.ids
    else:
        tseqs, tids = load_seqs_ids(args.db)
    cfg = SearchConfig(
        matrix=ScoreMatrix(args.matrix, args.gapopen, args.gapextend),
        sensitivity=args.sensitivity, comp_based_stats=args.comp_based_stats,
        max_evalue=args.evalue, max_target_seqs=args.max_target_seqs,
        toppercent=args.top, index_chunks=args.index_chunks,
        masking=args.masking, global_ranking=args.global_ranking,
        n_shapes=args.shapes)
    if args.multiprocessing or args.mp_init or args.mp_recover:
        from diamond_tpu_torch.search.blocked import blocked_search_mp

        if not args.parallel_tmpdir:
            raise SystemExit("--multiprocessing requires --parallel-tmpdir.")
        res = blocked_search_mp(cfg, qseqs, qids, tseqs, tids,
                                args.block_size, args.parallel_tmpdir,
                                init_only=args.mp_init,
                                recover=args.mp_recover)
        if res is None:
            return
    else:
        res = blocked_search(cfg, qseqs, qids, tseqs, tids, args.block_size,
                             taxonomy=taxonomy, taxon_k=args.taxon_k,
                             target_provider=provider)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    from diamond_tpu_torch.data.taxonomy import seqid

    qnames = [seqid(i) for i in qids]
    if provider is not None:
        # names only for reported targets (ranged id reads)
        reported = {gt for gq in res for gt, _m in res[gq]}
        id_map = provider.ids_for(reported)
        tnames = {k: seqid(v) for k, v in id_map.items()}
    else:
        tnames = [seqid(i) for i in tids]
    fields = _parse_fields(args.outfmt)
    for gq in sorted(res):
        for gt, m in res[gq]:
            for h in m.hsp:
                out.write(format_match_line(qnames[gq], tnames[gt], h,
                                            fields) + "\n")
    if out is not sys.stdout:
        out.close()


def cmd_makedb(args):
    from diamond_tpu_torch.data.dmnd import write_dmnd
    from diamond_tpu_torch.data.fasta import read_seqs

    write_dmnd(args.db if args.db.endswith(".dmnd") else args.db + ".dmnd",
               ((i, s.decode() if isinstance(s, bytes) else s)
                for i, s in read_seqs(args.infile)),
               mask_bit=args.masking != "0",
               taxonmap=args.taxonmap, taxonnodes=args.taxonnodes,
               taxonnames=args.taxonnames)


def cmd_dbinfo(args):
    from diamond_tpu_torch.data.dmnd import read_dmnd

    ids, seqs = read_dmnd(args.db)
    print("Database format version = 3")
    print(f"Sequences = {len(ids)}")
    print(f"Letters = {sum(len(s) for s in seqs)}")


def main(argv=None):
    """One command; with DIAMOND_TPU_PROF, the span ``cli.request`` around
    it is the root of every span it opens (one request id)."""
    with ptimer("cli.request"):
        return _main(argv)


def _main(argv):
    with ptimer("cli.args"):
        args = build_parser().parse_args(argv)
        if hasattr(args, "verbose"):
            from diamond_tpu_torch.utils.log import set_level

            set_level(verbose=args.verbose, quiet=args.quiet,
                      log_path=args.log_path)
    import time as _time

    _start = _time.time()
    try:
        return _dispatch(args)
    finally:
        if hasattr(args, "verbose"):
            from diamond_tpu_torch.utils.log import message, statistics

            statistics.print()
            message(f"Total time = {_time.time() - _start:.1f}s")


def _dispatch(args):
    if args.command == "blastp":
        cmd_blastp(args)
    elif args.command == "blastx":
        cmd_blastx(args)
    elif args.command == "makedb":
        cmd_makedb(args)
    elif args.command == "view":
        from diamond_tpu_torch.data.daa import view_daa

        out = sys.stdout if args.out == "-" else open(args.out, "w")
        for line in view_daa(args.daa):
            out.write(line + "\n")
        if out is not sys.stdout:
            out.close()
    elif args.command == "dbinfo":
        cmd_dbinfo(args)
    elif args.command == "version":
        print("diamond-tpu version 0.1.0 (reference compatibility: 2.2.2)")
    elif args.command == "realign":
        from diamond_tpu_torch.cluster.realign import realign
        from diamond_tpu_torch.data.fasta import read_seqs

        recs = list(read_seqs(args.db))
        lines = realign([r[1].upper() for r in recs], [r[0] for r in recs],
                        open(args.clusters).read().splitlines())
        out = sys.stdout if args.out == "-" else open(args.out, "w")
        for line in lines:
            out.write(line + "\n")
        if out is not sys.stdout:
            out.close()
    elif args.command == "merge-daa":
        from diamond_tpu_torch.data.daa import merge_daa

        merge_daa(args.infiles, args.out)
    elif args.command in ("cluster", "linclust", "deepclust"):
        from diamond_tpu_torch.cluster.workflow import run_cluster

        _device(args.command)
        run_cluster(args)
    elif args.command == "makeidx":
        from diamond_tpu_torch.data.seed_index import build_seed_index
        from diamond_tpu_torch.search.config import SearchConfig
        from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

        block = load_block(args.db)
        cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"),
                           sensitivity=args.sensitivity)
        build_seed_index(args.db + ".seed_idx", block, cfg)
        print(f"Wrote {args.db}.seed_idx")
    elif args.command == "test":
        _self_test(_device("test"))
    elif args.command == "benchmark":
        from diamond_tpu_torch.benchmark import run_benchmark

        run_benchmark(device=_device("benchmark"))
    elif args.command == "blastn":
        cmd_blastn(args)
    elif args.command == "greedy-vertex-cover":
        from diamond_tpu_torch.tools_cmds import cmd_greedy_vertex_cover

        cmd_greedy_vertex_cover(args)
    elif args.command in ("roc", "rocid"):
        # reference run/main.cpp:156-161
        raise SystemExit(f"Deprecated command: {args.command}")
    elif args.command == "prepdb":
        # reference run/main.cpp:168-172
        print("Warning: prepdb is deprecated since v2.1.14 and no longer "
              "needed to use BLAST databases. No action was taken.",
              file=sys.stderr)
    elif args.command in ("reassign", "recluster"):
        # reference main.cpp:182-193: temporarily removed upstream
        ver = "v2.2.1" if args.command == "reassign" else "v2.1.25"
        print(f"{args.command.capitalize()} has been temporarily removed "
              f"for {ver}. No action was taken.", file=sys.stderr)
    elif args.command in ("getseq", "random-seqs", "mask", "fastq2fasta",
                          "info", "reverse", "hashseqs", "split", "listseeds",
                          "smith-waterman"):
        from diamond_tpu_torch import tools_cmds

        fn = getattr(tools_cmds, "cmd_" + args.command.replace("-", "_"))
        fn(args)
    else:
        build_parser().print_help()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
