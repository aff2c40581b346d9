"""End to end: the search drivers of the port (blocked ``-b``/``-M``,
``-g``, ``--approx-id`` and the ``approx_pident`` field) byte for byte
against diamond_tpu's CLI, in subprocesses.

The port runs on the CPU with DeviceDP's plain version scoring the extension
rounds of every Pipeline the driver runs, and must make DeviceDP dispatches
(``-g`` makes none: see CASES).
Blocked inputs are cut so that at least two query and two target blocks
form, from FASTA and from a .dmnd (the DmndProvider streaming path).
"""
import os

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import GOLD, PORT, run_cli, synthetic_set  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic set (60 proteins, 20 queries), q2 + j2 in one file and
    the synthetic set as a .dmnd from the reference's makedb."""
    d = tmp_path_factory.mktemp("drivers")
    recs = synthetic_set(str(d))
    with open(d / "q2j2.faa", "w") as f:
        for name in ("q2.faa", "j2.faa"):
            with open(os.path.join(GOLD, name)) as g:
                f.write(g.read())
    run_cli("diamond_tpu", ["makedb", "--in", str(d / "db.faa"), "-d",
                            str(d / "db")], d)
    return {"q": str(d / "q.faa"), "db": str(d / "db.faa"),
            "dmnd": str(d / "db.dmnd"), "q2j2": str(d / "q2j2.faa"),
            "j2": os.path.join(GOLD, "j2.faa")}


# -b 0.0000004: 400 letters a block (j2 3 blocks, q2 + j2 5); -b 0.000005:
# 5,000 letters (the 20 queries 2 blocks, the 60 targets 5)
BLOCK_J2, BLOCK_SYN = "0.0000004", "0.000005"

# name -> (command, query, database, options, whether DeviceDP scores);
# -g ranks targets by ungapped scores and runs its one full-matrix extension
# on the host DP, so it makes no DeviceDP dispatch, as in the reference
CASES = {
    "b-fasta-j2": ("blastp", "j2", "q2j2", ["-b", BLOCK_J2], True),
    "b-fasta-synthetic": ("blastp", "q", "db", ["-b", BLOCK_SYN], True),
    "b-dmnd-synthetic": ("blastp", "q", "dmnd", ["-b", BLOCK_SYN], True),
    "b-fasta-synthetic-g5": ("blastp", "q", "db", ["-b", BLOCK_SYN,
                                                    "-g", "5"], False),
    "M-synthetic": ("blastp", "q", "db", ["-M", "4G"], True),
    "g5": ("blastp", "q", "db", ["-g", "5"], False),
    "g5-j2-pairwise": ("blastp", "j2", "q2j2", ["-g", "5", "-f", "0"],
                       False),
    "approx-id": ("blastp", "q", "db", ["--approx-id", "50", "-f", "6",
                                         "qseqid", "sseqid", "pident",
                                         "approx_pident", "evalue"], True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_port_matches_reference(case, data, tmp_path):
    cmd, q, db, extra, dp = CASES[case]
    args = [cmd, "-q", data[q], "-d", data[db], *extra]
    _, want, _, _ = run_cli("diamond_tpu", args, tmp_path)
    _, got, _, n = run_cli(PORT, args, tmp_path)
    assert want, case  # a non-empty comparison
    assert got == want
    assert (n > 0) == dp, f"DeviceDP dispatches {n}"


@pytest.mark.parametrize("inp,cap", [("j2", BLOCK_J2), ("q2j2", BLOCK_J2),
                                     ("q", BLOCK_SYN), ("db", BLOCK_SYN)])
def test_block_cut_gives_several_blocks(inp, cap, data):
    """The -b values above split every input of the blocked cases into at
    least two blocks (the split the port's blocked_search uses)."""
    from diamond_tpu_torch.data.fasta import read_seqs
    from diamond_tpu_torch.search.blocked import split_blocks

    recs = list(read_seqs(data[inp]))
    blocks, _ = split_blocks([r[1].upper() for r in recs],
                             [r[0] for r in recs], int(float(cap) * 1e9))
    assert len(blocks) >= 2


def test_memory_limit_sets_block_size(data):
    """-M derives -b and the index chunks as the reference does."""
    import argparse

    from diamond_tpu.cli import _apply_memory_limit as ref
    from diamond_tpu_torch.cli import _apply_memory_limit as port

    for ml in ("4G", "0.5G", "300M"):
        a = argparse.Namespace(memory_limit=ml, db=data["db"],
                               sensitivity="default", threads=1,
                               block_size=None, index_chunks=None)
        b = argparse.Namespace(**vars(a))
        ref(a), port(b)
        assert vars(a) == vars(b) and a.block_size is not None
