"""BLAST tabular (-f 6) output.

Default fields: qseqid sseqid pident length mismatch gapopen qstart qend
sstart send evalue bitscore (reference src/output/blast_tab_format.cpp).
"""
from __future__ import annotations

from diamond_tpu_torch.output.format import format_double, print_e

DEFAULT_FIELDS = ["qseqid", "sseqid", "pident", "length", "mismatch", "gapopen",
                  "qstart", "qend", "sstart", "send", "evalue", "bitscore"]


def format_match_line(query_name: str, target_name: str, hsp, fields=None,
                      dna_len: int = 0) -> str:
    """dna_len > 0 marks a translated (blastx) query: qstart/qend map through
    the frame to oriented DNA source coordinates (reference
    translated_position.h:130-136, match.h:168-174)."""
    fields = fields or DEFAULT_FIELDS
    if dna_len > 0:
        src = getattr(hsp, "query_source_range", None)
        if src is None:
            from diamond_tpu_torch.data.translate import absolute_interval

            src = absolute_interval(hsp.query_range[0], hsp.query_range[1],
                                    hsp.frame, dna_len)
        if hsp.frame < 3:
            qstart, qend = src[0] + 1, src[1]
        else:
            qstart, qend = src[1], src[0] + 1
    else:
        qstart, qend = hsp.query_range[0] + 1, hsp.query_range[1]
    seed_only = getattr(hsp, "seed_only", False)
    out = []
    for f in fields:
        if seed_only and f in ("pident", "length", "mismatch", "gapopen",
                               "gaps", "ppos", "evalue", "bitscore", "score"):
            out.append("")  # stat fields blank for --ext none seed matches
            continue
        if f == "qseqid":
            out.append(query_name)
        elif f == "sseqid":
            out.append(target_name)
        elif f == "pident":
            out.append(format_double(hsp.identities * 100.0 / hsp.length))
        elif f == "length":
            out.append(str(hsp.length))
        elif f == "mismatch":
            # stats-pass counts (reference BackwardCell) when no transcript
            # was requested by the field set
            m = getattr(hsp, "mismatches_stats", None)
            out.append(str(hsp.mismatches if m is None else m))
        elif f == "gapopen":
            g = getattr(hsp, "gap_openings_stats", None)
            out.append(str(hsp.gap_openings if g is None else g))
        elif f == "gaps":
            out.append(str(hsp.gaps))
        elif f == "ppos":
            out.append(format_double(hsp.positives * 100.0 / hsp.length))
        elif f == "qstart":
            out.append(str(qstart))
        elif f == "qend":
            out.append(str(qend))
        elif f == "sstart":
            out.append(str(hsp.subject_range[0] + 1))
        elif f == "send":
            out.append(str(hsp.subject_range[1]))
        elif f == "evalue":
            out.append(print_e(hsp.evalue))
        elif f == "bitscore":
            out.append(format_double(hsp.bit_score))
        elif f == "score":
            out.append(str(hsp.score))
        else:
            raise ValueError(f"Unsupported output field: {f}")
    return "\t".join(out)


def format_results(results: dict, query_block, target_block, fields=None,
                   dna_lens=None, query_names=None, matrix=None, taxonomy=None,
                   quals=None, hauser=True):
    """Yield output lines in query order (ReorderQueue semantics)."""
    from diamond_tpu_torch.output.fields import FieldContext, render_field

    fields = fields or DEFAULT_FIELDS
    simple = set(DEFAULT_FIELDS)
    n = len(query_names) if query_names is not None else len(query_block)
    for qid in range(n):
        matches = results.get(qid)
        if not matches:
            continue
        qname = (query_names[qid] if query_names is not None
                 else query_block.seq_id(qid))
        dl = dna_lens[qid] if dna_lens is not None else 0
        if all(f in simple for f in fields):
            for m in matches:
                tname = target_block.seq_id(m.target_block_id)
                for hsp in m.hsp:
                    yield format_match_line(qname, tname, hsp, fields, dl)
            continue
        for snum, m in enumerate(matches):
            tname = target_block.seq_id(m.target_block_id)
            for hn, hsp in enumerate(m.hsp):
                cid = qid * 6 + hsp.frame if dl else qid
                ctx = FieldContext(
                    query_name=qname, target_name=tname,
                    query_title=(query_block.ids[cid] if not dl else qname),
                    target_title=target_block.ids[m.target_block_id],
                    qlen=int(query_block.lengths[cid]), qlen_source=dl,
                    slen=int(target_block.lengths[m.target_block_id]),
                    qnum=qid, snum=m.target_block_id, hsp_num=hn + 1,
                    query=query_block.seq(cid),
                    target=target_block.seq(m.target_block_id),
                    matrix=matrix, taxonomy=taxonomy, dna_len=dl,
                    qual=quals[qid] if quals else None, hauser=hauser)
                yield "\t".join(render_field(f, hsp, ctx) for f in fields)


def render_pairwise(results: dict, query_block, target_block, matrix):
    """Full -f0 output text (reference blast_pairwise_format.cpp)."""
    from diamond_tpu_torch.output import pairwise as pw

    pw.set_midline_matrix(matrix.matrix32)
    chunks = [pw.pairwise_header()]
    for qid in range(len(query_block)):
        matches = results.get(qid) or []
        chunks.append(pw.pairwise_query_intro(query_block.ids[qid],
                                              int(query_block.lengths[qid]),
                                              not matches))
        q = query_block.seq(qid)
        for m in matches:
            t = target_block.seq(m.target_block_id)
            for hsp in m.hsp:
                chunks.append(pw.pairwise_match(
                    hsp, q, t, target_block.ids[m.target_block_id], len(t)))
    return "".join(chunks)


def render_paf(results: dict, query_block, target_block, matrix):
    from diamond_tpu_torch.output import pairwise as pw

    lines = []
    for qid in range(len(query_block)):
        matches = results.get(qid)
        if not matches:
            continue
        qname = query_block.seq_id(qid)
        qlen = int(query_block.lengths[qid])
        for m in matches:
            tname = target_block.seq_id(m.target_block_id)
            tlen = int(target_block.lengths[m.target_block_id])
            for hsp in m.hsp:
                lines.append(pw.paf_match(qname, tname, hsp, qlen, tlen,
                                          matrix.bitscore))
    return "\n".join(lines) + ("\n" if lines else "")


# reference blast_tab_format.cpp json string-typed fields
_JSON_STRING_FIELDS = {
    "qseqid", "sseqid", "qtitle", "stitle", "salltitles", "full_sseq",
    "qseq", "sseq", "qseq_translated", "cigar", "btop", "qstrand",
    "sscinames", "sskingdoms", "skingdoms", "sphylums", "staxids",
    "sallseqid", "qqual",
}


def render_json(results: dict, query_block, target_block, fields=None,
                **kw) -> str:
    """JSON flat output (-f 104 / json-flat; reference
    output_format.cpp:211, blast_tab_format json mode).  Mirrors the
    reference's record framing exactly (tab-indented objects inside one
    array, no separators between records)."""
    fields = fields or DEFAULT_FIELDS
    # reference quirk: commas separate records WITHIN one query's block
    # (emitted as a prefix for the query's 2nd+ match); there is NO comma
    # between different queries' records
    groups = []
    for qid in sorted(results):
        recs = list(format_results({qid: results[qid]}, query_block,
                                   target_block, fields, **kw))
        if recs:
            groups.append(recs)
    out = ["["]
    for gi, recs in enumerate(groups):
        for ri, line in enumerate(recs):
            vals = line.split("\t")
            out.append("\t{")
            for k, (f, v) in enumerate(zip(fields, vals)):
                q = f in _JSON_STRING_FIELDS
                comma = "," if k + 1 < len(fields) else ""
                out.append(f'\t"{f}":{json_quote(v) if q else v}{comma}')
            out.append("\t}," if ri + 1 < len(recs) else "\t}")
    out.append("]")
    return "\n".join(out)  # no trailing newline (reference)


def json_quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
