"""Command-line interface of the PyTorch/CUDA port.

The argparse surface is diamond_tpu's (reference src/run/main.cpp:73-234), so
flags parse identically.  The port runs ``blastp`` (FASTA, ``.dmnd`` and
BLAST database inputs) and ``blastx`` (FASTA or FASTQ reads; ``-F``,
``--long-reads``, ``--range-culling``, ``--strand``, ``--min-orf``,
``--query-gencode``), both with ``--swipe``, in ``-f 6/0/5/100/101/102/103/
104``, ``benchmark`` and the database commands ``makedb``, ``dbinfo``,
``view``, ``merge-daa`` and ``version`` (host code, as in diamond_tpu);
every other command, and every option whose modules are not ported yet,
exits with a message naming its ROADMAP.md item.

The device DP (the extension rounds of ``blastp``, the 3-frame DP of
``blastx -F``, the ``blastp --swipe`` sweep) runs on the CUDA card unless
DIAMOND_TPU_TORCH_DEVICE=cpu asks for the CPU; without a card and without
that request, the search exits with an error (see utils/device.py for the
DP routing knobs).
"""
from __future__ import annotations

import argparse
import sys


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
        # an N-device jax mesh (framework extension; 0 = single device)
        sp.add_argument("--swipe", action="store_true")
        # --mesh N also shards the standard blastp/blastx device DP
        # mega-batches (search/pipeline._extend_all -> DeviceDP(mesh=...))
        sp.add_argument("--mesh", dest="mesh", type=int, default=0)
        # multi-host bring-up (jax.distributed): all three, or the
        # JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
        # env vars
        sp.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (jax.distributed)")
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


def _not_ported(what: str, item: str):
    raise SystemExit(f"{what} is not ported to diamond_tpu_torch yet "
                     f"(ROADMAP.md {item})")


def check_ported(args):
    """Exit on a search option whose modules the port does not have yet."""
    if (args.block_size is not None or args.memory_limit
            or args.multiprocessing or args.mp_init or args.mp_recover):
        _not_ported("Blocked search (-b, -M, --multiprocessing)",
                    "section 1, item 12")
    if args.iterate is not None:
        _not_ported("--iterate", "section 1, item 15")
    if args.global_ranking:
        _not_ported("-g/--global-ranking", "section 1, item 15")
    if args.mesh or any(v is not None for v in (
            args.coordinator, args.num_procs, args.proc_id)):
        _not_ported("--mesh and multi-process search", "section 1, item 11")
    if "approx_pident" in args.outfmt[1:]:
        _not_ported("The approx_pident field", "section 1, item 13")
    if args.masking == "seg":
        _not_ported("--masking seg", "section 1, item 17")
    if args.custom_matrix:
        _not_ported("--custom-matrix", "section 1, item 17")
    if args.approx_id:
        _not_ported("--approx-id", "section 1, item 13")
    if args.target_indexed:
        _not_ported("--target-indexed", "section 1, item 17")


def _device(command: str) -> str:
    from diamond_tpu_torch.utils.device import NoDeviceError, resolve_device

    try:
        return resolve_device()
    except (NoDeviceError, ValueError) as e:
        raise SystemExit(f"{command}: {e}")


def cmd_blastp(args):
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.pipeline import Pipeline
    from diamond_tpu_torch.utils.log import ptimer

    check_ported(args)
    device = _device("blastp")
    with ptimer("cli.load"):
        qb = load_block(args.query)
        tb, taxonomy = load_block(args.db, with_taxonomy=True)
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
        motif_masking=None if args.motif_masking is None else bool(args.motif_masking),
        min_id=args.min_id,
        query_cover=args.query_cover,
        subject_cover=args.subject_cover,
        no_self_hits=args.no_self_hits,
        freq_masking=args.freq_masking,
        ext=args.ext,
        n_shapes=args.shapes,
        shape_mask=args.shape_mask,
        minimizer_window=args.minimizer_window,
        db_letters=db_letters,
        algo=args.algo,
    )
    if args.swipe:
        from diamond_tpu_torch.align.swipe_all import swipe_all_protein

        results = swipe_all_protein(qb, tb, cfg)
    else:
        results = Pipeline(cfg, qb, tb, device=device).search()
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
    check_ported(args)
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
        n_shapes=args.shapes,
        frame_shift=args.frameshift,
        query_range_culling=args.range_culling,
        query_range_cover=args.range_cover,
        db_letters=db_letters,
        algo=args.algo,
    )
    if args.swipe:
        from diamond_tpu_torch.search.blastx import blastx_swipe_all

        results = blastx_swipe_all(queries, tb, cfg)
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


def _make_matrix(args):
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

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
    elif args.command == "merge-daa":
        from diamond_tpu_torch.data.daa import merge_daa

        merge_daa(args.infiles, args.out)
    elif args.command == "benchmark":
        from diamond_tpu_torch.benchmark import run_benchmark

        run_benchmark(device=_device("benchmark"))
    elif args.command is None:
        build_parser().print_help()
        return 1
    else:
        item = {"blastn": 16, "cluster": 13, "linclust": 13, "deepclust": 13,
                "realign": 13}.get(args.command, 17)
        _not_ported(f"The {args.command} command", f"section 1, item {item}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
