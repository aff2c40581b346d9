"""SAM (-f 101) output, byte-compatible with the reference
(reference src/output/sam_format.cpp)."""
from __future__ import annotations

from diamond_tpu_torch.constants.alphabet import AMINO_ACID_ALPHABET
from diamond_tpu_torch.output.format import print_e

VERSION = "2.2.2"


def _cigar(hsp) -> str:
    """reference sam_format.cpp:66-83: M covers match+substitution."""
    out = []
    op, n = "M", 0
    for o, val in hsp.transcript or []:
        c = "M" if o in ("M", "S") else ("I" if o == "I" else "D")
        k = val if o in ("M", "I") else 1
        if c == op:
            n += k
        else:
            if n > 0:
                out.append(f"{n}{op}")
            op, n = c, k
    if n > 0:
        out.append(f"{n}{op}")
    return "".join(out)


def _md(hsp) -> str:
    """reference sam_format.cpp:31-64 print_md."""
    out = []
    matches = 0
    dels = 0
    for o, val in hsp.transcript or []:
        if o == "M":
            dels = 0
            matches += val
        elif o == "S":
            if matches > 0:
                out.append(str(matches))
                matches = 0
            elif dels > 0:
                out.append("0")
                dels = 0
            out.append(AMINO_ACID_ALPHABET[val & 31])
        elif o == "D":
            if matches > 0:
                out.append(str(matches))
                matches = 0
            if dels == 0:
                out.append("^")
            out.append(AMINO_ACID_ALPHABET[val & 31])
            dels += 1
        # insertions don't appear in MD
    if matches > 0:
        out.append(str(matches))
    return "".join(out)


def sam_header(program: str, invocation: str) -> str:
    mode = {"blastp": "BlastP", "blastx": "BlastX"}[program]
    return ("@HD\tVN:1.5\tSO:query\n"
            f"@PG\tPN:DIAMOND\tVN:{VERSION}\tCL:{invocation}\n"
            f"@mm\t{mode}\n"
            f"@CO\t{mode}-like alignments\n"
            "@CO\tReporting AS: bitScore, ZR: rawScore, ZE: expected, "
            "ZI: percent identity, ZL: reference length, ZF: frame, "
            "ZS: query start DNA coordinate\n")


def render_sam(results: dict, query_block, target_block, matrix,
               invocation: str = "", program: str = "blastp",
               dna_lens=None, query_names=None) -> str:
    out = [sam_header(program, invocation)]
    n = len(query_names) if query_names is not None else len(query_block)
    for qid in range(n):
        matches = results.get(qid)
        qname = (query_names[qid] if query_names is not None
                 else query_block.seq_id(qid))
        if not matches:
            out.append(f"{qname}\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n")
            continue
        for m in matches:
            tname = target_block.seq_id(m.target_block_id)
            slen = int(target_block.lengths[m.target_block_id])
            for hsp in m.hsp:
                cid = qid * 6 + hsp.frame if dna_lens is not None else qid
                q = query_block.seq(cid)
                qaln = "".join(AMINO_ACID_ALPHABET[int(x) & 31] for x in
                               q[hsp.query_range[0]: hsp.query_range[1]])
                if dna_lens is not None:
                    from diamond_tpu_torch.data.translate import absolute_interval

                    src = absolute_interval(hsp.query_range[0],
                                            hsp.query_range[1], hsp.frame,
                                            dna_lens[qid])
                    zs = (src[0] + 1) if hsp.frame < 3 else src[1]
                    zf = hsp.frame + 1 if hsp.frame < 3 else -(hsp.frame - 2)
                else:
                    zs = hsp.query_range[0] + 1
                    zf = 1
                out.append(
                    f"{qname}\t0\t{tname}\t{hsp.subject_range[0] + 1}\t255\t"
                    f"{_cigar(hsp)}\t*\t0\t0\t{qaln}\t*\t"
                    f"AS:i:{int(hsp.bit_score)}\t"
                    f"NM:i:{hsp.length - hsp.identities}\t"
                    f"ZL:i:{slen}\t"
                    f"ZR:i:{hsp.score}\t"
                    f"ZE:f:{print_e(hsp.evalue)}\t"
                    f"ZI:i:{hsp.identities * 100 // hsp.length}\t"
                    f"ZF:i:{zf}\t"
                    f"ZS:i:{zs}\t"
                    f"MD:Z:{_md(hsp)}\n")
    return "".join(out)
