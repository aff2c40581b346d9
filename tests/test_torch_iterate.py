"""End to end: ``--iterate`` (blastp and blastx) and ``blastx -g`` of the
port byte for byte against diamond_tpu's CLI, in subprocesses, and the
round table against the reference's.

Each --iterate round is a Pipeline on the resolved device: on the CPU the
port scores blastp's extension rounds with DeviceDP's plain version and
must make DeviceDP dispatches.
"""
import sys

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import PORT, REPO, run_cli, synthetic_set  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic set (60 proteins, 20 queries) and 12 reads of
    300-900 nt made from it."""
    d = tmp_path_factory.mktemp("iterate")
    recs = synthetic_set(str(d))
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_reads, write_fasta
    finally:
        sys.path.remove(REPO)
    write_fasta(d / "reads.fna", make_reads(recs, 12, 300, 900, seed=3))
    return {"q": str(d / "q.faa"), "db": str(d / "db.faa"),
            "reads": str(d / "reads.fna")}


# name -> (command, query, options, whether DeviceDP scores); six-frame
# blastx extends on the host DP, with or without --iterate or -g, as in the
# reference
CASES = {
    "blastp-iterate": ("blastp", "q", ["--iterate"], True),
    "blastp-iterate-rounds": ("blastp", "q", ["--sensitive", "--iterate",
                                              "fast", "default"], True),
    "blastp-iterate-no-self-hits": ("blastp", "q", ["--iterate",
                                                    "--no-self-hits"], True),
    "blastx-iterate": ("blastx", "reads", ["--iterate"], False),
    "blastx-g5": ("blastx", "reads", ["-g", "5"], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iterate_port_matches_reference(case, data, tmp_path):
    cmd, q, extra, dp = CASES[case]
    args = [cmd, "-q", data[q], "-d", data["db"], *extra]
    _, want, _, _ = run_cli("diamond_tpu", args, tmp_path)
    _, got, _, n = run_cli(PORT, args, tmp_path)
    assert want, case
    assert got == want
    assert (n > 0) == dp, f"DeviceDP dispatches {n}"


@pytest.mark.parametrize("iterate,sens", [([], "default"), ([], "sensitive"),
                                          (["fast", "default_lin"],
                                           "sensitive"),
                                          (None, "fast")])
def test_rounds_for_matches_reference(iterate, sens):
    from diamond_tpu.search.iterate import rounds_for as ref
    from diamond_tpu_torch.search.iterate import rounds_for as port

    assert port(sens, iterate) == ref(sens, iterate)
