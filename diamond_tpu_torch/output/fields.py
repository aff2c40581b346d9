"""Extended tabular field rendering.

Field set from the reference registry (reference
src/output/blast_tab_format.cpp:46-106).  Taxonomy fields resolve through an
optional taxonomy provider.
"""
from __future__ import annotations

from dataclasses import dataclass

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_ALPHABET
from diamond_tpu_torch.output.format import format_double, print_e


@dataclass
class FieldContext:
    query_name: str
    target_name: str
    query_title: str
    target_title: str
    qlen: int               # translated query length for % coverage
    qlen_source: int        # source (DNA) length for blastx
    slen: int
    qnum: int
    snum: int
    hsp_num: int
    query: object = None    # letters (context frame)
    target: object = None
    matrix: object = None   # ScoreMatrix
    taxonomy: object = None
    dna_len: int = 0
    qual: str | None = None  # FASTQ quality string (full query)
    hauser: bool = True      # CBS mode uses Hauser bias (self-aln scores)


def _aligned_seqs(hsp, q, t, gapped: bool):
    qs, ss = [], []
    i, j = hsp.query_range[0], hsp.subject_range[0]
    for op, val in hsp.transcript or []:
        if op in ("M", "S"):
            qs.append(AMINO_ACID_ALPHABET[int(q[i]) & 31])
            ss.append(AMINO_ACID_ALPHABET[int(t[j]) & 31])
            i += 1
            j += 1
        elif op == "I":
            for _ in range(val):
                qs.append(AMINO_ACID_ALPHABET[int(q[i]) & 31])
                if gapped:
                    ss.append("-")
                i += 1
        else:
            if gapped:
                qs.append("-")
            ss.append(AMINO_ACID_ALPHABET[val & 31])
            j += 1
    return "".join(qs), "".join(ss)


def _btop(hsp, q, t) -> str:
    """BLAST traceback operations string."""
    out = []
    run = 0
    i, j = hsp.query_range[0], hsp.subject_range[0]
    for op, val in hsp.transcript or []:
        if op == "M":
            run += 1
            i += 1
            j += 1
            continue
        if run:
            out.append(str(run))
            run = 0
        if op == "S":
            out.append(AMINO_ACID_ALPHABET[int(q[i]) & 31]
                       + AMINO_ACID_ALPHABET[val & 31])
            i += 1
            j += 1
        elif op == "I":
            for _ in range(val):
                out.append(AMINO_ACID_ALPHABET[int(q[i]) & 31] + "-")
                i += 1
        else:
            out.append("-" + AMINO_ACID_ALPHABET[val & 31])
            j += 1
    if run:
        out.append(str(run))
    return "".join(out)


def _cigar(hsp) -> str:
    out = []
    cur_op, cur_n = None, 0
    for op, val in hsp.transcript or []:
        o = "M" if op in ("M", "S") else ("I" if op == "I" else "D")
        n = val if op == "I" else 1
        if o == cur_op:
            cur_n += n
        else:
            if cur_op:
                out.append(f"{cur_n}{cur_op}")
            cur_op, cur_n = o, n
    if cur_op:
        out.append(f"{cur_n}{cur_op}")
    return "".join(out)


def render_field(f: str, hsp, ctx: FieldContext) -> str:
    qr, sr = hsp.query_range, hsp.subject_range
    if f == "qseqid":
        return ctx.query_name
    if f == "sseqid":
        return ctx.target_name
    if f == "qtitle":
        return ctx.query_title
    if f == "stitle":
        return ctx.target_title
    if f == "qlen":
        return str(ctx.qlen_source or ctx.qlen)
    if f == "slen":
        return str(ctx.slen)
    if f == "qnum":
        return str(ctx.qnum)
    if f == "snum":
        return str(ctx.snum)
    if f == "hspnum":
        return str(ctx.hsp_num)
    if f == "pident":
        return format_double(hsp.identities * 100.0 / hsp.length)
    if f == "nident":
        return str(hsp.identities)
    if f == "normalized_nident":
        return format_double(hsp.identities * 100.0 / max(ctx.qlen, ctx.slen))
    if f == "length":
        return str(hsp.length)
    if f == "mismatch":
        return str(hsp.mismatches)
    if f == "positive":
        return str(hsp.positives)
    if f == "ppos":
        return format_double(hsp.positives * 100.0 / hsp.length)
    if f == "gapopen":
        return str(hsp.gap_openings)
    if f == "gaps":
        return str(hsp.gaps)
    if f == "qstart":
        return str(qr[0] + 1)
    if f == "qend":
        return str(qr[1])
    if f == "sstart":
        return str(sr[0] + 1)
    if f == "send":
        return str(sr[1])
    if f == "evalue":
        return print_e(hsp.evalue)
    if f == "bitscore":
        return format_double(hsp.bit_score)
    if f == "corrected_bitscore":
        return format_double(float(ctx.matrix.bitscore_corrected(
            hsp.score, ctx.qlen, ctx.slen)))
    if f == "score":
        return str(hsp.score)
    if f == "qcovhsp":
        return format_double((qr[1] - qr[0]) * 100.0 / ctx.qlen)
    if f == "scovhsp":
        return format_double((sr[1] - sr[0]) * 100.0 / ctx.slen)
    if f == "qframe":
        return str((hsp.frame + 1) if hsp.frame < 3 else (2 - hsp.frame)) \
            if ctx.dna_len else "0"
    if f == "qstrand":
        return "+" if hsp.frame < 3 else "-"
    if f == "qseq":
        return _aligned_seqs(hsp, ctx.query, ctx.target, False)[0]
    if f == "sseq":
        return _aligned_seqs(hsp, ctx.query, ctx.target, False)[1]
    if f == "qseq_gapped":
        return _aligned_seqs(hsp, ctx.query, ctx.target, True)[0]
    if f == "sseq_gapped":
        return _aligned_seqs(hsp, ctx.query, ctx.target, True)[1]
    if f == "full_qseq":
        from diamond_tpu_torch.constants.alphabet import decode

        return decode(ctx.query)
    if f == "full_sseq":
        from diamond_tpu_torch.constants.alphabet import decode

        return decode(ctx.target)
    if f == "btop":
        return _btop(hsp, ctx.query, ctx.target)
    if f == "cigar":
        return _cigar(hsp)
    if f == "sallseqid":
        return ";".join(_first_id(t) for t in _split_header(ctx.target_title))
    if f == "salltitles":
        return "<>".join(_split_header(ctx.target_title))
    if f == "qqual":
        # quality for the aligned part of the (source) query (reference
        # blast_tab_format.cpp QQual)
        if not ctx.qual:
            return "*"
        if ctx.dna_len:
            from diamond_tpu_torch.data.translate import absolute_interval

            a, b = absolute_interval(qr[0], qr[1], hsp.frame, ctx.dna_len)
        else:
            a, b = qr
        return ctx.qual[a:b]
    if f == "full_qqual":
        return ctx.qual or "*"
    if f == "full_qseq_mate":
        # paired query files are not loaded; the reference prints '*'
        # when config.query_file.size() != 2 (blast_tab_format.cpp:558)
        return "*"
    if f == "qseq_translated":
        return _aligned_seqs(hsp, ctx.query, ctx.target, False)[0]
    if f == "approx_pident":
        from diamond_tpu_torch.cluster.realign import approx_id

        import numpy as np

        ident = (qr[1] - qr[0] == sr[1] - sr[0]
                 and np.array_equal(
                     np.asarray(ctx.query)[qr[0]:qr[1]] & 31,
                     np.asarray(ctx.target)[sr[0]:sr[1]] & 31))
        aid = 100.0 if ident else approx_id(hsp.score, qr[1] - qr[0],
                                            sr[1] - sr[0])
        return format_double(aid)
    if f == "normalized_bitscore":
        # %lf like the reference TextBuffer::print_d (text_buffer.h:231)
        s = max(_self_aln_bitscore(ctx.query, ctx.matrix, ctx.hauser),
                _self_aln_bitscore(ctx.target, ctx.matrix, ctx.hauser))
        return f"{hsp.bit_score / s:.6f}"
    if f == "normalized_bitscore_query":
        return (f"{hsp.bit_score / _self_aln_bitscore(ctx.query, ctx.matrix, ctx.hauser):.6f}")
    if f in ("staxids", "sscinames", "skingdoms", "sskingdoms", "sphylums",
             "slineages"):
        return _taxon_field(f, ctx)
    raise ValueError(f"Unsupported output field: {f}")


def _split_header(title: str) -> list:
    """Split a FASTA header on the NCBI separators '\\x01' and ' >'
    (reference util/sequence/sequence.cpp:38 FASTA_HEADER_SEP)."""
    import re

    return re.split("\x01| >", title)


def _first_id(title: str) -> str:
    """Leading token up to the id delimiters (reference
    sequence.cpp:37)."""
    import re

    return re.split("[ \a\b\f\n\r\t\v\x01]", title, 1)[0]


def _self_aln_bitscore(seq, matrix, hauser: bool) -> float:
    """Self-alignment bit score (reference dp/ungapped_align.cpp:259-281
    self_score + Block::compute_self_aln, block.cpp:188-196): Kadane over
    the diagonal self scores, with the Hauser bias under CBS mode 1.
    Byte-verified against the reference for protein queries (the
    clustering use case); translated-query frames can differ from the
    reference, whose value reflects its soft-masked frame letters."""
    import numpy as np

    q = np.asarray(seq).astype(np.int64) & 31
    d = matrix.matrix32[q, q].astype(np.int64)
    if hauser:
        from diamond_tpu_torch.stats.cbs import hauser_bias_i8

        i8 = hauser_bias_i8(seq, matrix.matrix32,
                                  matrix.background_scores)
        d = d + np.asarray(i8, dtype=np.int64)
    best = 0
    run = 0
    for v in d.tolist():
        run = max(run + v, 0)
        best = max(best, run)
    return float(matrix.bitscore(best))


def _taxon_field(f: str, ctx: FieldContext) -> str:
    """Taxonomy fields (reference blast_tab_format.cpp:404-556,
    sequence_file.h:317-332)."""
    from diamond_tpu_torch.data.taxonomy import (RANK_KINGDOM, RANK_PHYLUM,
                                           RANK_SUPERKINGDOM)

    tax = ctx.taxonomy
    if tax is None:
        raise ValueError(f"Field {f} requires taxonomy in the database "
                         "(--taxonmap/--taxonnodes/--taxonnames at makedb)")
    taxids = tax.taxids(ctx.snum)
    if f == "staxids":
        return ";".join(str(t) for t in taxids)
    if f == "sscinames":
        return tax.print_names(taxids)
    rank = {"sskingdoms": RANK_SUPERKINGDOM, "skingdoms": RANK_KINGDOM,
            "sphylums": RANK_PHYLUM}.get(f)
    if rank is not None:
        if not taxids:
            return "N/A"
        return tax.print_names(tax.rank_taxids(taxids, rank))
    # slineages (reference blast_tab_format.cpp:149-186)
    if tax.nodes is None:
        raise RuntimeError(
            "Options require taxonomy nodes information built into the "
            "database (--taxonnodes option of makedb)")
    if not taxids:
        return "N/A"
    lineages = sorted({tuple(tax.nodes.lineage(t)) for t in taxids
                       if tax.nodes.lineage(t)})
    if not lineages:
        return "N/A"
    return "<>".join(";".join(tax.scientific_name(t) for t in lin)
                     for lin in lineages)
