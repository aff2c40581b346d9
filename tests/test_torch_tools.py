"""The port's tool commands byte for byte against diamond_tpu's CLI, in
subprocesses: ``getseq``, ``random-seqs``, ``mask``, ``fastq2fasta``,
``reverse``, ``hashseqs``, ``split``, ``listseeds``, ``smith-waterman``,
the self ``test``, and the deprecated or disabled ``roc``, ``rocid``,
``prepdb``, ``reassign`` and ``recluster`` (same message, stream and exit
code).  ``info`` is rewritten on purpose (torch and its cards, not jax's
devices), so it is checked for what it must name, not byte-compared.
``split`` writes gzip volumes whose headers carry the time they were
written: their decompressed contents are compared.
"""
import gzip
import os

import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import GOLD, PORT, run_cli, synthetic_set  # noqa: E402

REF = "diamond_tpu"
Q2 = os.path.join(GOLD, "q2.faa")

DNA_PAIRS = (">ref1 first\nACGTACGTTAGCCGATAGGCTTACGATCGATCGGATCCGATTACA\n"
             ">qry1\nACGTACGATAGCCGATGGCTTACGATCGTTCGGATCCGATTAC\n"
             ">ref2\nTTGACCGATGCATGCAAGTCCGTAGGCTAGCTAGGATCCATGCA\n"
             ">qry2\nTTGACCGATGCAAGCAAGTCCGTAGGCTAGCTAGCCATGCA\n")


def _fastq(d):
    with open(os.path.join(d, "r.fq"), "w") as f:
        for k, seq in enumerate(("ACGTTGCA" * 9, "GGCATTACGA" * 7, "TTAG")):
            f.write(f"@read{k} sample\n{seq}\n+\n{'I' * len(seq)}\n")


# command -> (argv, output files written besides standard output)
TOOLS = {
    "getseq": (["getseq", "-d", "db.faa", "--seq", "3", "1", "7"], ()),
    "getseq-all": (["getseq", "-d", Q2, "-o", "all.faa"], ("all.faa",)),
    "random-seqs": (["random-seqs", "-d", "db.faa", "-n", "9", "-o",
                     "rand.faa"], ("rand.faa",)),
    "mask": (["mask", "-q", "db.faa", "-o", "masked.faa"], ("masked.faa",)),
    "fastq2fasta": (["fastq2fasta", "-q", "r.fq"], ()),
    "reverse": (["reverse", "-q", "db.faa"], ()),
    "hashseqs": (["hashseqs", "-q", "db.faa"], ()),
    "listseeds": (["listseeds", "-d", "db.faa", "-n", "30"], ()),
    "smith-waterman": (["smith-waterman", "-q", "pairs.fna"], ()),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_matches_reference(tmp_path, name):
    argv, files = TOOLS[name]
    out = {}
    for pkg in (REF, PORT):
        d = tmp_path / pkg
        d.mkdir()
        synthetic_set(str(d))
        _fastq(d)
        (d / "pairs.fna").write_text(DNA_PAIRS)
        _, stdout, _, _ = run_cli(pkg, argv, d)
        out[pkg] = (stdout, [(d / f).read_bytes() for f in files])
    assert out[PORT] == out[REF]
    assert out[PORT][0].strip() or all(out[PORT][1])


def test_split_volumes_match_reference(tmp_path):
    vols = {}
    for pkg in (REF, PORT):
        d = tmp_path / pkg
        d.mkdir()
        synthetic_set(str(d))
        run_cli(pkg, ["split", "-q", "db.faa", "--chunk-size", "0.000004",
                      "--prefix", "vol"], d)
        names = sorted(n for n in os.listdir(d) if n.startswith("vol"))
        vols[pkg] = [(n, gzip.open(d / n).read()) for n in names]
    assert len(vols[PORT]) > 2
    assert vols[PORT] == vols[REF]


def test_self_test_passes_in_both(tmp_path):
    for pkg in (REF, PORT):
        rc, out, _, n = run_cli(pkg, ["test"], tmp_path)
        assert out == b"Self test OK.\n"
    assert n and n > 0  # the port's check ran DeviceDP


@pytest.mark.parametrize("cmd", ["roc", "rocid", "prepdb", "reassign",
                                 "recluster"])
def test_deprecated_commands_answer_as_reference(tmp_path, cmd):
    got = {}
    for pkg in (REF, PORT):
        rc, out, err, _ = run_cli(pkg, [cmd], tmp_path, check=False)
        got[pkg] = (rc, out, [ln for ln in err.splitlines()
                              if not ln.startswith("DISPATCHES=")])
    assert got[PORT] == got[REF]
    assert got[PORT][2]


def test_info_names_torch_and_the_cards(tmp_path):
    import torch

    _, out, _, _ = run_cli(PORT, ["info"], tmp_path)
    text = out.decode()
    assert text.startswith("diamond-tpu version")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert f"Backend: torch {torch.__version__}" in text
    assert f"devices: {n}" in text


def test_threads_flag_reaches_no_config_as_reference(tmp_path, monkeypatch):
    """A gap of the reference the port keeps on purpose (ROADMAP.md section
    3): ``blastp -p N`` parses, but neither CLI hands N to
    SearchConfig.threads, so every Pipeline runs with threads = 1."""
    import importlib

    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("DIAMOND_TPU_DEVICE_DP", "0")
    for pkg in (REF, PORT):
        pipeline = importlib.import_module(f"{pkg}.search.pipeline")
        cli = importlib.import_module(f"{pkg}.cli")
        seen = []
        init = pipeline.Pipeline.__init__

        def spy(self, cfg, *a, **kw):
            seen.append(cfg.threads)
            init(self, cfg, *a, **kw)

        monkeypatch.setattr(pipeline.Pipeline, "__init__", spy)
        cli.main(["blastp", "-q", Q2, "-d", Q2, "-p", "4", "-o",
                  str(tmp_path / f"{pkg}.tsv"), "--quiet"])
        assert seen == [1], (pkg, seen)
    assert (tmp_path / f"{PORT}.tsv").read_bytes() == \
        (tmp_path / f"{REF}.tsv").read_bytes()
