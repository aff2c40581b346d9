"""``blastn`` of the port: the cases of tests/test_blastn.py (minimizers,
chaining, plus- and minus-strand coordinates, the exact Smith-Waterman
oracle) against diamond_tpu_torch, and both CLIs byte for byte on a seeded
nucleotide set.  blastn's DP (with traceback) is host code in both
packages, so the port makes no DeviceDP dispatch here.
"""
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import PORT, REPO, run_cli  # noqa: E402

REF = "diamond_tpu"


def test_minimizers_match_reference():
    from diamond_tpu.search import blastn as ref
    from diamond_tpu_torch.search import blastn as port

    rng = np.random.default_rng(4)
    s = "".join(rng.choice(list("ACGTN"), 3000, p=[.24, .24, .24, .24, .04]))
    for mod in (ref, port):
        assert len(mod.minimizers(mod.encode_dna(s))[0]) > 0
    a = ref.minimizers(ref.encode_dna(s))
    b = port.minimizers(port.encode_dna(s))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_chain_anchors():
    from diamond_tpu_torch.search.blastn import chain_anchors

    anchors = [(10, 110), (30, 130), (55, 155), (400, 90)]
    chains = chain_anchors(anchors, k=15)
    assert chains
    top = chains[0][0]
    assert (10, 110) in top and (55, 155) in top
    assert (400, 90) not in top


def test_blastn_strand_coordinates(tmp_path):
    rng = np.random.default_rng(3)
    bases = "ACGT"
    core = "".join(rng.choice(list(bases), 120))
    target = ("".join(rng.choice(list(bases), 40)) + core
              + "".join(rng.choice(list(bases), 40)))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(core))
    (tmp_path / "q.fa").write_text(f">plus\n{core}\n>minus\n{rc}\n")
    (tmp_path / "t.fa").write_text(f">t1\n{target}\n")
    _, out, _, n = run_cli(PORT, ["blastn", "-q", "q.fa", "-d", "t.fa"],
                           tmp_path)
    by_q = {ln.split("\t")[0]: ln.split("\t")
            for ln in out.decode().splitlines()}
    assert by_q["plus"][2] == "100"
    assert int(by_q["plus"][8]) == 41 and int(by_q["plus"][9]) == 160
    # minus strand: subject coordinates reversed
    assert by_q["minus"][2] == "100"
    assert int(by_q["minus"][8]) == 160 and int(by_q["minus"][9]) == 41
    assert n == 0


def test_blastn_matches_exact_sw_oracle():
    """As tests/test_blastn.py: for homologous pairs whose chain covers the
    alignment, the score equals the full-matrix SW optimum and the
    transcript's counts add up."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_blastn import _sw_full_score

    from diamond_tpu_torch.search.blastn import (blastn_search, dna_matrix,
                                                 encode_dna)

    rng = np.random.default_rng(11)
    bases = "ACGT"
    m = dna_matrix(2, -3)
    go, ge = 5 + 2, 2
    for trial in range(6):
        core = "".join(rng.choice(list(bases), 200))
        cl = list(core)
        for p in rng.integers(0, len(cl), 10):
            cl[int(p)] = bases[int(rng.integers(0, 4))]
        ins = int(rng.integers(50, 150))
        cl[ins:ins] = list("".join(rng.choice(list(bases), 2)))
        query = "".join(cl)
        target = ("".join(rng.choice(list(bases), 30)) + core
                  + "".join(rng.choice(list(bases), 30)))
        res, _qmeta, _tmeta = blastn_search([("q", query)], [("t", target)])
        assert res, f"trial {trial}: no hit"
        h = res[0][0].hsp[0]
        sw = _sw_full_score(encode_dna(query), encode_dna(target), m, go, ge)
        assert h.score == sw, (trial, h.score, sw)
        assert h.identities + h.mismatches + h.gaps == h.length
        assert h.length >= h.query_range[1] - h.query_range[0]


@pytest.mark.parametrize("extra", [[], ["--reward", "1", "--penalty", "-2",
                                        "--evalue", "1e-10"]])
def test_blastn_cli_matches_reference(tmp_path, extra):
    """20 reads of 300-1,500 nt from both strands of 5 random 20 kb
    sequences at 3 % substitutions."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import dna_source_hits, make_dna, write_fasta
    finally:
        sys.path.remove(REPO)
    refs, reads = make_dna(5, 20_000, 20, 300, 1500, seed=7)
    write_fasta(tmp_path / "refs.fna", refs)
    write_fasta(tmp_path / "reads.fna", reads)
    args = ["blastn", "-q", "reads.fna", "-d", "refs.fna", *extra]
    _, ref, _, _ = run_cli(REF, args, tmp_path)
    _, port, _, n = run_cli(PORT, args, tmp_path)
    assert port == ref
    assert n == 0
    assert len(dna_source_hits(port.decode().splitlines())) == len(reads)
