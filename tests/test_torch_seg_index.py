"""``--masking seg``, ``makeidx`` and ``--target-indexed`` of the port, byte
for byte against diamond_tpu's CLI, in subprocesses.

The port runs on the CPU with every fitting DP job through DeviceDP's plain
version (``torch_cli``), so K1's function scores these paths; it must make
DeviceDP dispatches.  A seed index is an ``np.savez_compressed`` file whose
zip headers carry a timestamp, so the two packages' indexes are compared
array by array, and each package's search reads the other's index.
"""
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference CLI (absent on a card host)

from torch_cli import GOLD, PORT, run_cli, synthetic_set  # noqa: E402

REF = "diamond_tpu"
Q2, J2 = os.path.join(GOLD, "q2.faa"), os.path.join(GOLD, "j2.faa")


def _q2j2(d):
    db = os.path.join(d, "db.faa")
    with open(db, "w") as f:
        for p in (Q2, J2):
            f.write(open(p).read())
    return db


def _same(args, d):
    _, ref, _, _ = run_cli(REF, args, d)
    _, port, _, n = run_cli(PORT, args, d)
    assert ref.strip()
    assert port == ref
    assert n and n > 0  # K1's plain version scored the round
    return port


@pytest.mark.parametrize("fmt", ["6", "0"])
def test_seg_masking_matches_reference(tmp_path, fmt):
    db = _q2j2(tmp_path)
    _same(["blastp", "-q", J2, "-d", db, "--masking", "seg", "-f", fmt],
          tmp_path)


def test_seg_masking_synthetic_set(tmp_path):
    synthetic_set(str(tmp_path))
    out = _same(["blastp", "-q", "q.faa", "-d", "db.faa", "--masking",
                 "seg"], tmp_path)
    assert len(out.splitlines()) >= 20


def _index(pkg, d, sens=()):
    rc, out, err, _ = run_cli(pkg, ["makeidx", "-d", "db.faa", *sens], d)
    assert out.decode() == "Wrote db.faa.seed_idx\n"
    return os.path.join(d, "db.faa.seed_idx")


def test_makeidx_arrays_match_reference(tmp_path):
    idx = {}
    for pkg in (REF, PORT):
        d = tmp_path / pkg
        d.mkdir()
        synthetic_set(str(d))
        path = _index(pkg, d, ["--sensitive"])
        with np.load(path) as z:
            idx[pkg] = {k: z[k] for k in z.files}
    assert sorted(idx[REF]) == sorted(idx[PORT])
    assert int(idx[PORT]["n_shapes"]) > 1
    for k, a in idx[REF].items():
        assert a.dtype == idx[PORT][k].dtype, k
        assert np.array_equal(a, idx[PORT][k]), k


def test_target_indexed_matches_unindexed_and_reference(tmp_path):
    """An index made by either package gives both packages' searches the
    output of the search without an index."""
    synthetic_set(str(tmp_path))
    args = ["blastp", "-q", "q.faa", "-d", "db.faa"]
    _, plain, _, _ = run_cli(PORT, args, tmp_path)
    assert len(plain.splitlines()) >= 20
    for maker in (REF, PORT):
        _index(maker, tmp_path)
        for searcher in (REF, PORT):
            _, out, _, n = run_cli(searcher, args + ["--target-indexed"],
                                   tmp_path)
            assert out == plain, (maker, searcher)
            if searcher == PORT:
                assert n > 0


def test_target_indexed_sensitivity_mismatch_fails_as_reference(tmp_path):
    shutil.copy(J2, tmp_path / "db.faa")
    _index(PORT, tmp_path)
    args = ["blastp", "-q", J2, "-d", "db.faa", "--target-indexed",
            "--sensitive"]
    last = {}
    for pkg in (REF, PORT):
        rc, out, err, _ = run_cli(pkg, args, tmp_path, check=False)
        assert rc != 0 and out == b""
        last[pkg] = err.strip().splitlines()[-1]
    assert last[PORT] == last[REF]
    assert "Rebuild with makeidx" in last[PORT]
