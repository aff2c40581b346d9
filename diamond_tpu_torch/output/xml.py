"""BLAST XML (-f 5) output, byte-compatible with the reference
(reference src/output/xml_format.cpp)."""
from __future__ import annotations

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_ALPHABET
from diamond_tpu_torch.data.taxonomy import get_accession, seqid
from diamond_tpu_torch.output.format import format_double, print_e

_XML_ESC = {"\"": "&quot;", "'": "&apos;", "<": "&lt;", ">": "&gt;",
            "&": "&amp;"}


def _esc(s: str) -> str:
    return "".join(_XML_ESC.get(c, c) for c in s)


def _title_def(title: str):
    """reference util/sequence/sequence.cpp:154-163 get_title_def."""
    import re

    m = re.search(r"[ \a\b\f\n\r\t\v\x01]", title)
    if m is None:
        return title, ""
    return title[: m.start()], title[m.start() + 1:]


def _aligned_chars(hsp, q, t, matrix32):
    """(qseq, hseq, midline) gapped strings (reference HspContext::Iterator)."""
    qs, ss, mid = [], [], []
    i, j = hsp.query_range[0], hsp.subject_range[0]
    for op, val in hsp.transcript or []:
        if op in ("M", "S"):
            qc = AMINO_ACID_ALPHABET[int(q[i]) & 31]
            sc = AMINO_ACID_ALPHABET[int(t[j]) & 31]
            qs.append(qc)
            ss.append(sc)
            if op == "M":
                mid.append(qc)
            else:
                mid.append("+" if matrix32[int(q[i]) & 31, int(t[j]) & 31] > 0
                           else " ")
            i += 1
            j += 1
        elif op == "I":
            for _ in range(val):
                qs.append(AMINO_ACID_ALPHABET[int(q[i]) & 31])
                ss.append("-")
                mid.append(" ")
                i += 1
        else:
            qs.append("-")
            ss.append(AMINO_ACID_ALPHABET[val & 31])
            mid.append(" ")
            j += 1
    return "".join(qs), "".join(ss), "".join(mid)


def render_xml(results: dict, query_block, target_block, matrix,
               db_path: str, max_evalue: float, program: str = "blastp",
               dna_lens=None, query_names=None) -> str:
    out = []
    n = len(query_names) if query_names is not None else len(query_block)
    first_q = (query_names[0] if query_names is not None
               else query_block.ids[0]) if n else ""
    first_len = (dna_lens[0] if dna_lens is not None
                 else int(query_block.lengths[0])) if n else 0
    out.append(
        '<?xml version="1.0"?>\n'
        '<!DOCTYPE BlastOutput PUBLIC "-//NCBI//NCBI BlastOutput/EN" '
        '"http://www.ncbi.nlm.nih.gov/dtd/NCBI_BlastOutput.dtd">\n'
        "<BlastOutput>\n"
        f"  <BlastOutput_program>{program}</BlastOutput_program>\n"
        "  <BlastOutput_version>diamond 2.2.2</BlastOutput_version>\n"
        "  <BlastOutput_reference>Benjamin Buchfink, Xie Chao, and Daniel "
        "Huson (2015), &quot;Fast and sensitive protein alignment using "
        "DIAMOND&quot;, Nature Methods 12:59-60.</BlastOutput_reference>\n"
        f"  <BlastOutput_db>{db_path}</BlastOutput_db>\n"
        "  <BlastOutput_query-ID>Query_1</BlastOutput_query-ID>\n"
        f"  <BlastOutput_query-def>{_esc(first_q).split(chr(1))[0]}"
        "</BlastOutput_query-def>\n"
        f"  <BlastOutput_query-len>{first_len}</BlastOutput_query-len>\n"
        "  <BlastOutput_param>\n"
        "    <Parameters>\n"
        f"      <Parameters_matrix>{matrix.name.lower()}</Parameters_matrix>\n"
        f"      <Parameters_expect>{max_evalue:g}</Parameters_expect>\n"
        f"      <Parameters_gap-open>{matrix.gap_open}</Parameters_gap-open>\n"
        f"      <Parameters_gap-extend>{matrix.gap_extend}"
        "</Parameters_gap-extend>\n"
        "      <Parameters_filter>F</Parameters_filter>\n"
        "    </Parameters>\n"
        "  </BlastOutput_param>\n"
        "<BlastOutput_iterations>\n")

    for qid in range(n):
        matches = results.get(qid) or []
        qtitle = (query_names[qid] if query_names is not None
                  else query_block.ids[qid])
        qlen = (dna_lens[qid] if dna_lens is not None
                else int(query_block.lengths[qid]))
        out.append(
            "<Iteration>\n"
            f"  <Iteration_iter-num>{qid + 1}</Iteration_iter-num>\n"
            f"  <Iteration_query-ID>Query_{qid + 1}</Iteration_query-ID>\n"
            f"  <Iteration_query-def>{_esc(qtitle.split(chr(1))[0])}"
            "</Iteration_query-def>\n"
            f"  <Iteration_query-len>{qlen}</Iteration_query-len>\n"
            "<Iteration_hits>\n")
        for hit_num, m in enumerate(matches):
            title = target_block.ids[m.target_block_id]
            hid, hdef = _title_def(title)
            accession = get_accession(hid)
            slen = int(target_block.lengths[m.target_block_id])
            out.append(
                "<Hit>\n"
                f"  <Hit_num>{hit_num + 1}</Hit_num>\n"
                f"  <Hit_id>{_esc(hid)}</Hit_id>\n"
                f"  <Hit_def>{_esc(hdef)}</Hit_def>\n"
                f"  <Hit_accession>{_esc(accession)}</Hit_accession>\n"
                f"  <Hit_len>{slen}</Hit_len>\n"
                "  <Hit_hsps>\n")
            t = target_block.seq(m.target_block_id)
            for hsp_num, hsp in enumerate(m.hsp):
                cid = qid * 6 + hsp.frame if dna_lens is not None else qid
                q = query_block.seq(cid)
                if dna_lens is not None:
                    from diamond_tpu_torch.data.translate import absolute_interval

                    src = absolute_interval(hsp.query_range[0],
                                            hsp.query_range[1], hsp.frame,
                                            dna_lens[qid])
                    qfrom, qto = src[0] + 1, src[1]
                    bframe = (hsp.frame + 1 if hsp.frame < 3
                              else -(hsp.frame - 2))
                else:
                    qfrom, qto = hsp.query_range[0] + 1, hsp.query_range[1]
                    bframe = 0
                qseq, hseq, midline = _aligned_chars(hsp, q, t,
                                                     matrix.matrix32)
                out.append(
                    "    <Hsp>\n"
                    f"      <Hsp_num>{hsp_num + 1}</Hsp_num>\n"
                    f"      <Hsp_bit-score>{format_double(hsp.bit_score)}"
                    "</Hsp_bit-score>\n"
                    f"      <Hsp_score>{hsp.score}</Hsp_score>\n"
                    f"      <Hsp_evalue>{print_e(hsp.evalue)}</Hsp_evalue>\n"
                    f"      <Hsp_query-from>{qfrom}</Hsp_query-from>\n"
                    f"      <Hsp_query-to>{qto}</Hsp_query-to>\n"
                    f"      <Hsp_hit-from>{hsp.subject_range[0] + 1}"
                    "</Hsp_hit-from>\n"
                    f"      <Hsp_hit-to>{hsp.subject_range[1]}</Hsp_hit-to>\n"
                    f"      <Hsp_query-frame>{bframe}</Hsp_query-frame>\n"
                    "      <Hsp_hit-frame>0</Hsp_hit-frame>\n"
                    f"      <Hsp_identity>{hsp.identities}</Hsp_identity>\n"
                    f"      <Hsp_positive>{hsp.positives}</Hsp_positive>\n"
                    f"      <Hsp_gaps>{hsp.gaps}</Hsp_gaps>\n"
                    f"      <Hsp_align-len>{hsp.length}</Hsp_align-len>\n"
                    f"         <Hsp_qseq>{qseq}</Hsp_qseq>\n"
                    f"         <Hsp_hseq>{hseq}</Hsp_hseq>\n"
                    f"      <Hsp_midline>{midline}</Hsp_midline>\n"
                    "    </Hsp>\n")
            out.append("  </Hit_hsps>\n</Hit>\n")
        out.append(
            "</Iteration_hits>\n"
            "  <Iteration_stat>\n"
            "    <Statistics>\n"
            f"      <Statistics_db-num>{len(target_block)}"
            "</Statistics_db-num>\n"
            f"      <Statistics_db-len>{target_block.n_letters}"
            "</Statistics_db-len>\n"
            "      <Statistics_hsp-len>0</Statistics_hsp-len>\n"
            "      <Statistics_eff-space>0</Statistics_eff-space>\n"
            f"      <Statistics_kappa>{matrix.k:.6f}</Statistics_kappa>\n"
            f"      <Statistics_lambda>{matrix.lam:.6f}"
            "</Statistics_lambda>\n"
            "      <Statistics_entropy>0</Statistics_entropy>\n"
            "    </Statistics>\n"
            "  </Iteration_stat>\n"
            "</Iteration>\n")
    out.append("</BlastOutput_iterations>\n</BlastOutput>")
    return "".join(out)
