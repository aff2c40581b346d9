"""The plain reference against hand-worked alignments and against the
program's own masking, bias and statistics on random sequences (the tests
may import the program; the reference may not)."""
import numpy as np
import pytest

import reference as R


def enc(s):
    return R.encode(s)


def _align(q, t, mode, bias=None):
    qa, ta = enc(q), enc(t)
    b = np.zeros(len(qa), np.int64) if bias is None else np.asarray(bias)
    s, hi, lo = R.align([(qa, b, ta, qa, ta)], mode)
    return int(s[0]), int(hi[0]), int(lo[0])


def test_box_hand_worked():
    # W/W 11, C/C 9, H/H 8
    assert _align("WCH", "WCH", "box") == (28, 3, 3)
    # one gap of one letter costs 11 + 1: WCH over W-H... the box holds
    # all of both: W/W + gap(C) + H/H = 11 - 12 + 8
    assert _align("WCH", "WH", "box") == (7, 2, 2)
    # a mismatch A/D -2 beats a gap pair (-24)
    assert _align("WAH", "WDH", "box") == (11 - 2 + 8, 2, 2)
    # two letters of gap: 11 + 2
    assert _align("WCCH", "WH", "box") == (11 - 13 + 8, 2, 2)


def test_box_bias_adds_per_query_row():
    assert _align("WCH", "WCH", "box", bias=[1, -2, 3]) == (30, 3, 3)


def test_local_hand_worked():
    # the best local piece of AAWWWAA against CCWWWCC is WWW: 33
    assert _align("AAWWWAA", "CCWWWCC", "local") == (33, 3, 3)
    assert _align("PPP", "WWW", "local")[0] == 0


def test_identity_range_over_tied_paths():
    # A against AA: the A pairs with either A, one identity either way
    assert _align("WAAW", "WAW", "box")[1:] == (3, 3)
    # R/K and K/K score 2 and 5; R/R 5 and K/R 2: WRKW vs WKRW has one
    # best path (both mismatches, 2 + 2) and no identity
    assert _align("WRKW", "WKRW", "box") == (11 + 2 + 2 + 11, 2, 2)


def test_int8_saturates():
    q = "W" * 20
    s, _, _ = R.align([(enc(q), np.zeros(20, np.int64), enc(q), enc(q),
                        enc(q))], "box", int8=True)
    assert int(s[0]) == 127


def _random_seqs(seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        L = int(rng.integers(30, 500))
        s = rng.integers(0, 20, L)
        if k % 3 == 0:  # a planted tandem repeat
            unit = rng.integers(0, 20, int(rng.integers(1, 12)))
            a = int(rng.integers(0, L // 2))
            n_rep = int(rng.integers(10, 80))
            s[a:a + n_rep] = np.resize(unit, min(n_rep, L - a))
        out.append(s.astype(np.int64))
    return out


def test_tantan_and_bias_match_the_program():
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.stats.cbs import hauser_correction
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62", 11, 1)
    tt = Tantan(m.matrix32)
    assert R.tantan_lambda() == pytest.approx(tt.lam, rel=1e-12)
    seqs = _random_seqs(1)
    mine = R.repeat_mask(seqs)
    assert sum(int((x == R.X).sum()) for x in mine) > 100
    for s, x in zip(seqs, mine):
        assert np.array_equal(tt.mask(s.astype(np.int8))[0], x)
        _, i8 = hauser_correction(x, m.matrix32, m.background_scores)
        assert np.array_equal(R.hauser_bias(x), i8)


def test_statistics_match_the_program():
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    m = ScoreMatrix("BLOSUM62", 11, 1)
    m.set_db_letters(3_786_414)
    for S_ in (25, 60, 100, 300, 1000, 2500):
        assert R.bitscore(S_) == pytest.approx(m.bitscore(S_), abs=1e-9)
        for ql, sl in ((40, 90), (300, 400), (3000, 2000)):
            want = m.evalue(np.array([float(S_)]), np.array([ql]),
                            np.array([sl]))[0]
            assert R.evalue(S_, ql, sl, 3_786_414) == pytest.approx(
                want, rel=1e-9, abs=1e-300)


def test_reference_imports_nothing_of_the_program():
    import ast
    import os

    here = os.path.dirname(R.__file__)
    judges = [os.path.join("judges", f)
              for f in os.listdir(os.path.join(here, "judges"))
              if f.endswith(".py")]
    for f in ["reference.py", "gen.py", "roofline.py", *judges]:
        tree = ast.parse(open(os.path.join(here, f)).read())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert not names & {"diamond_tpu", "diamond_tpu_torch", "jax",
                            "jaxlib", "flax"}, f
