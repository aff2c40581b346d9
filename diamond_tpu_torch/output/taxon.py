"""Taxonomic classification format (-f 102), reference
src/output/taxon_format.cpp: one line per query with the LCA over all
reported subject taxids and the minimum e-value."""
from __future__ import annotations

from diamond_tpu_torch.output.format import print_e


def render_taxon(results: dict, query_block, target_block, taxonomy,
                 include_lineage: bool = False, query_names=None):
    if taxonomy is None or taxonomy.taxon_lists is None or taxonomy.nodes is None:
        raise RuntimeError(
            "Options require taxonomy information included in the database "
            "(--taxonmap/--taxonnodes options of makedb)")
    n = len(query_names) if query_names is not None else len(query_block)
    lines = []
    for qid in range(n):
        qname = (query_names[qid] if query_names is not None
                 else query_block.seq_id(qid))
        taxid = 0
        evalue = float("inf")
        for m in results.get(qid) or []:
            taxons = taxonomy.taxids(m.target_block_id)
            if not taxons:
                continue
            for h in m.hsp:
                evalue = min(evalue, h.evalue)
            for t in taxons:
                taxid = taxonomy.nodes.get_lca(taxid, t)
        line = f"{qname}\t{taxid}\t"
        line += print_e(evalue) if taxid > 0 else "0"
        if include_lineage:
            if taxid > 0:
                lin = taxonomy.nodes.lineage(taxid)
                line += "\t" + ("; ".join(taxonomy.scientific_name(t)
                                          for t in lin) if lin else "N/A")
            else:
                line += "\tN/A"
        lines.append(line)
    return lines
