"""The database commands of the port (``makedb``, ``dbinfo``, ``version``,
``view``, ``merge-daa``) and the ``-f 100`` (DAA) and ``-f 102`` (taxonomic
classification) outputs, byte for byte against diamond_tpu's, in
subprocesses: the files each writes and its standard output.

They are host code in both packages; the searches that feed ``-f 100`` and
``-f 102`` run the port on the CPU (DIAMOND_TPU_TORCH_DEVICE=cpu).
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
PKGS = ("diamond_tpu", "diamond_tpu_torch")

_LAUNCH = """
import sys
from {pkg}.cli import main
sys.argv = ["diamond"] + sys.argv[1:]
sys.exit(main(sys.argv[1:]))
"""


def _run(pkg, args, cwd, ok=True):
    """(returncode, stdout, stderr) of one CLI run in cwd."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               DIAMOND_TPU_DEVICE_DP="0", DIAMOND_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    for k in ("DIAMOND_TPU_STAGE12", "DIAMOND_TPU_TORCH_STAGE12",
              "DIAMOND_TPU_TORCH_DEVICE_DP"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", _LAUNCH.format(pkg=pkg), *args],
                       capture_output=True, env=env, timeout=600,
                       cwd=str(cwd))
    if ok:
        assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"ROADMAP" not in r.stderr, r.stderr.decode()[-2000:]
    return r.returncode, r.stdout, r.stderr.decode()


def _both(args_of, tmp_path, ok=True):
    """Run each package in its own directory (args_of(pkg_dir) gives its
    argv); returns {pkg: (dir, returncode, stdout, stderr)}."""
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        out[pkg] = (d, *_run(pkg, args_of(d), d, ok))
    return out


def _same_files(res, *names):
    a, b = (res[p][0] for p in PKGS)
    for n in names:
        data = (a / n).read_bytes()
        assert data, n
        assert data == (b / n).read_bytes(), n


def _same_stdout(res):
    a, b = (res[p][2] for p in PKGS)
    assert a.strip()
    assert a == b


# A small taxonomy for q2.faa: its accessions mapped to four taxa under
# two genera of one family (names.dmp holds a synonym that must be skipped).
TAXONMAP = ("accession\taccession.version\ttaxid\tgi\n"
            "RJP93937\tRJP93937.1\t1001\t0\n"
            "WP_066841281\tWP_066841281.1\t1002\t0\n"
            "OBF96983\tOBF96983.1\t1003\t0\n"
            "MBR3944831\tMBR3944831.1\t1003\t0\n"
            "WP_041591748\tWP_041591748.1\t1004\t0\n")
NODES = "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in (
    (1, 1, "no rank"), (2, 1, "superkingdom"), (100, 2, "family"),
    (200, 100, "genus"), (300, 100, "genus"), (1001, 200, "species"),
    (1002, 200, "species"), (1003, 300, "species"), (1004, 300, "species")))
NAMES = "".join(f"{t}\t|\t{n}\t|\t\t|\t{c}\t|\n" for t, n, c in (
    (1, "root", "scientific name"), (2, "Bacteria", "scientific name"),
    (100, "Familiaceae", "scientific name"),
    (200, "Genus alpha", "scientific name"),
    (300, "Genus beta", "scientific name"),
    (1001, "Genus alpha one", "scientific name"),
    (1002, "Genus alpha two", "scientific name"),
    (1003, "Genus beta three", "scientific name"),
    (1003, "beta three", "synonym"),
    (1004, "Genus beta four", "scientific name")))


@pytest.fixture(scope="module")
def taxonomy(tmp_path_factory):
    d = tmp_path_factory.mktemp("tax")
    (d / "acc2taxid.tsv").write_text(TAXONMAP)
    (d / "nodes.dmp").write_text(NODES)
    (d / "names.dmp").write_text(NAMES)
    return ["--taxonmap", str(d / "acc2taxid.tsv"),
            "--taxonnodes", str(d / "nodes.dmp"),
            "--taxonnames", str(d / "names.dmp")]


@pytest.mark.parametrize("tax", [False, True], ids=["plain", "taxonomy"])
def test_makedb_and_dbinfo(tax, taxonomy, tmp_path):
    """makedb of q2.faa (with and without the taxonomy files): the .dmnd
    bytes; dbinfo on each package's own database: its standard output."""
    extra = taxonomy if tax else []
    res = _both(lambda d: ["makedb", "--in", f"{GOLD}/q2.faa", "-d",
                           str(d / "db"), *extra], tmp_path)
    _same_files(res, "db.dmnd")
    res = _both(lambda d: ["dbinfo", "-d", str(d / "db.dmnd")], tmp_path)
    _same_stdout(res)
    assert "Sequences = 4" in res["diamond_tpu_torch"][2].decode()


def test_version(tmp_path):
    _same_stdout(_both(lambda d: ["version"], tmp_path))


def test_blastp_daa_view_and_merge(tmp_path):
    """blastp -f 100 -o (q2.faa against itself, and j2.faa against q2 + j2):
    the DAA bytes; view -a of each: its output; merge-daa of the two: the
    merged file's bytes and its view."""
    j2 = tmp_path / "q2j2.faa"
    j2.write_bytes(open(f"{GOLD}/q2.faa", "rb").read()
                   + open(f"{GOLD}/j2.faa", "rb").read())
    for name, q, db in (("a", "q2.faa", f"{GOLD}/q2.faa"),
                        ("b", "j2.faa", str(j2))):
        res = _both(lambda d: ["blastp", "-q", f"{GOLD}/{q}", "-d", db,
                               "-f", "100", "-o", str(d / f"{name}.daa")],
                    tmp_path)
        _same_files(res, f"{name}.daa")
        res = _both(lambda d: ["view", "-a", str(d / f"{name}.daa")],
                    tmp_path)
        _same_stdout(res)
    res = _both(lambda d: ["merge-daa", "--in", str(d / "a.daa"),
                           str(d / "b.daa"), "-o", str(d / "m.daa")],
                tmp_path)
    _same_files(res, "m.daa")
    _same_stdout(_both(lambda d: ["view", "-a", str(d / "m.daa")], tmp_path))


def test_daa_needs_an_output_file(tmp_path):
    """blastp -f 100 without -o fails alike: the same exit and message."""
    res = _both(lambda d: ["blastp", "-q", f"{GOLD}/q2.faa", "-d",
                           f"{GOLD}/q2.faa", "-f", "100"], tmp_path, ok=False)
    (rc_a, err_a), (rc_b, err_b) = ((res[p][1], res[p][3]) for p in PKGS)
    assert rc_a == rc_b != 0
    assert "DAA output requires an output file" in err_b
    assert err_a.strip().splitlines()[-1] == err_b.strip().splitlines()[-1]


def test_blastp_taxonomic_classification(taxonomy, tmp_path):
    """-f 102 of q2.faa against the taxonomy .dmnd made by each package's
    makedb: one LCA line per query, byte for byte."""
    res = _both(lambda d: ["makedb", "--in", f"{GOLD}/q2.faa", "-d",
                           str(d / "tax"), *taxonomy], tmp_path)
    res = _both(lambda d: ["blastp", "-q", f"{GOLD}/q2.faa", "-d",
                           str(d / "tax.dmnd"), "-f", "102", "--evalue",
                           "10"], tmp_path)
    _same_stdout(res)
    lines = res["diamond_tpu_torch"][2].decode().splitlines()
    assert len(lines) == 4
    assert {ln.split("\t")[1] for ln in lines} - {"0"}


def test_blastx_daa_fails_as_reference(tmp_path):
    """blastx -f 100 -o: diamond_tpu's blastx hands DAA to its text writer,
    which refuses it after the search; the port does the same (exit code,
    last line of the message, and the empty file it leaves)."""
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import make_proteins, make_reads, write_fasta
    finally:
        sys.path.remove(REPO)
    prots = make_proteins(n_seqs=40, n_families=10, seed=3)
    reads = make_reads(prots, 6, 300, 600, seed=4)
    write_fasta(tmp_path / "db.faa", prots)
    write_fasta(tmp_path / "reads.fna", reads)
    res = _both(lambda d: ["blastx", "-q", str(tmp_path / "reads.fna"), "-d",
                           str(tmp_path / "db.faa"), "-f", "100", "-o",
                           str(d / "x.daa")], tmp_path, ok=False)
    (rc_a, err_a), (rc_b, err_b) = ((res[p][1], res[p][3]) for p in PKGS)
    assert rc_a == rc_b != 0
    assert err_a.strip().splitlines()[-1] == err_b.strip().splitlines()[-1]
    assert "DAA output requires -o FILE" in err_b
    for p in PKGS:
        assert (res[p][0] / "x.daa").read_bytes() == b""
