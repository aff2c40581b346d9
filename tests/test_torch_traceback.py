"""The port's traceback refill (D4, ``ops/traceback_device``; plain PyTorch
version on the CPU) against diamond_tpu: its native ``tb_multi_results``
(``banded_swipe_tb_multi``: the fill with trace planes and the walk), its
numpy oracle ``banded_swipe_np(traceback=True)`` on jobs whose band starts
below diagonal -(t_len - 1) (where the native scorer may score outside the
band; D4 follows the oracle), and its native ``banded_swipe_many`` planes.
Tolerance: exact equality of every field (integers throughout).

Then the wave's card route on the CPU: blastp with
DIAMOND_TPU_TORCH_DEVICE=cpu refills its traceback jobs through D4's plain
version and gives diamond_tpu's bytes.  The CUDA kernel itself runs only
on the card: tests/test_torch_gpu.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference side (absent on a card host)

from diamond_tpu import native as ref_native  # noqa: E402
from diamond_tpu.ops.banded_swipe import (banded_swipe_np,  # noqa: E402
                                          tb_multi_results)
from diamond_tpu.stats.score_matrix import ScoreMatrix  # noqa: E402
from diamond_tpu_torch.ops import traceback_device as tbd  # noqa: E402
from torch_cli import cli_env, run_cli  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
# K1's band cap as the synthetic blastp's traceback rounds see it, low
# enough that some of their jobs go to the native call and the round is
# mixed.  Round 1 keeps 512: lowered there too, the jobs above the cap
# would be scored by the fused native fill, whose cached walks leave the
# traceback round only jobs within the cap.
CAP = 64


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.fixture(scope="module")
def blosum():
    m = ScoreMatrix("BLOSUM62")
    return m, m.gap_open + m.gap_extend, m.gap_extend


def _args(c):
    return [c[k] for k in _smoke().TB_KEYS]


def _check(c, got, m):
    """chip_smoke.tb_check of D4's (out, stats, results) against
    diamond_tpu's tb_multi_results and banded_swipe_np: (native
    mismatches, oracle mismatches, jobs held against the oracle)."""
    return _smoke().tb_check(c, got, m.matrix32, m.gap_open, m.gap_extend,
                             refs=(tb_multi_results, banded_swipe_np))[:3]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_reference_and_oracle(seed, blosum):
    """Seeded jobs of 6 queries (every band of chip_smoke.TB_BANDS, bias on
    every other query, mutated copies with indels, d0 < 0, targets cut
    short, score-0 jobs, seed-masked letters): D4's plain version equals
    diamond_tpu's tb_multi_results on every field of every job that starts
    at diagonal -(t_len - 1) or above, and the numpy oracle on the rest."""
    m, go, ge = blosum
    c = _smoke().tb_jobs(seed)
    got = tbd.tb_multi_device(*_args(c), m.matrix32, go, ge, "cpu")
    low = c["low"]
    assert low.any() and (~low).any()
    assert (got[0][:, 0] == 0).any() and (got[1][:, 7] > 0).any()
    assert _check(c, got, m) == (0, 0, int(low.sum()))


@pytest.mark.parametrize("band", [1, 31, 32, 33, 512])
def test_band_edges_match_reference_and_native_planes(band, blosum):
    """Every job of one band: D4's plain version against tb_multi_results
    (the numpy oracle on a job starting below diagonal -(t_len - 1)), and
    each of its four planes against the native banded_swipe_many masks
    on the live columns (the walk reads no other)."""
    m, go, ge = blosum
    c = _smoke().tb_jobs(10 + band, n_queries=3, bands=(band,),
                         max_len=160, low_start=False)
    c = _smoke().tb_select(c, c["bands"] == band)
    got = tbd.tb_multi_device(*_args(c), m.matrix32, go, ge, "cpu")
    assert _check(c, got, m)[:2] == (0, 0)
    J = tbd.job_table(*[c[k] for k in ("q_off", "q_len", "use_bias", "t_off",
                                       "t_len", "d_begins", "bands")])
    x = [torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("q_base", "bias_base", "t_cat")]
    best, col, row, code = tbd._fill_plain(
        *x, torch.from_numpy(J), torch.from_numpy(m.matrix32).long(), go, ge)
    live = 0
    for k, (qo, ql, ub, to, tl, d0, bd) in enumerate(J.tolist()):
        masks = tuple(np.zeros(tl * bd, np.uint8) for _ in range(4))
        bias = c["bias_base"][qo:qo + ql].copy() if ub else None
        o = ref_native.banded_swipe_many_native(
            np.ascontiguousarray(c["q_base"][qo:qo + ql]), bias, c["t_cat"],
            np.array([to]), np.array([tl]), np.array([d0]), np.array([bd]),
            m.matrix32, go, ge, np.zeros(1, np.int64), masks)
        assert o[0].tolist() == [best[k], col[k], row[k]]
        j0, j1 = max(0, -d0 - bd + 1), min(tl, ql - d0)
        for p in range(4):
            if j1 > j0:
                want_p = masks[p].reshape(tl, bd)[j0:j1].astype(bool)
                got_p = (code[k, j0:j1, :bd] >> p) & 1
                assert np.array_equal(got_p.bool().numpy(), want_p), (k, p)
                live += j1 - j0
    assert live > 0


def test_walk_failure_gives_no_stats(blosum):
    """A walk whose summed score cannot reach the best fails as walk_one
    fails: ok 0, every other stat 0, no ops.  (No seeded job makes the
    native walk fail: a search of 460,000 random jobs, gap costs 0-12,
    random matrices and biases up to 30, found none; so the best is raised
    out of reach here.)"""
    m, go, ge = blosum
    c = _smoke().tb_jobs(3, n_queries=2, low_start=False)
    J = torch.from_numpy(tbd.job_table(*[c[k] for k in (
        "q_off", "q_len", "use_bias", "t_off", "t_len", "d_begins",
        "bands")]))
    x = [torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("q_base", "bias_base", "t_cat")]
    M = torch.from_numpy(m.matrix32).long()
    out, stats, _, _, _ = tbd.banded_traceback_multi_plain(
        *x, J, torch.from_numpy(m.matrix32), go, ge)
    live = out[:, 0] > 0
    assert live.any() and bool((stats[live, 11] == 1).all())
    _, _, _, code = tbd._fill_plain(*x, J, M, go, ge)
    raised = out.clone()
    raised[:, 0] += live.long() * 10 ** 6
    sizes = J[:, 4] * J[:, 6]
    flat = torch.cat([code[k, :J[k, 4], :J[k, 6]].reshape(-1)
                      for k in range(len(J))])
    caps = J[:, 4] + J[:, 1] + 2
    st, codes, _ = tbd._walk_plain(*x, J, M, go, ge, flat,
                                   torch.cumsum(sizes, 0) - sizes, raised,
                                   torch.cumsum(caps, 0) - caps,
                                   int(caps.sum()))
    assert bool((st[live] == 0).all())
    assert torch.equal(st[~live], stats[~live])


def test_plan_slices_and_classes():
    """tb_plan: slices in job order within the plane budget (a larger job
    alone), every job once, each slice's launches by band class with the
    longest job first, plane offsets inside the slice's scratch, op slots
    of t_len + q_len + 2."""
    c = _smoke().tb_jobs(4, n_queries=4)
    J = tbd.job_table(*[c[k] for k in ("q_off", "q_len", "use_bias",
                                       "t_off", "t_len", "d_begins",
                                       "bands")])
    words = J[:, 4] * tbd.rows_per_lane(J[:, 6]) * 4
    budget = int(words.max()) * 4 * 3
    plan = tbd.tb_plan(J, budget)
    assert sorted(plan.order.tolist()) == list(range(len(J)))
    assert len(plan.slices) > 1
    prev = 0
    for lo, hi in plan.slices:
        jobs = plan.order[lo:hi]
        assert sorted(jobs.tolist()) == list(range(prev, prev + hi - lo))
        prev += hi - lo
        assert (plan.plane_off[jobs] + words[jobs]).max() <= budget // 4
    for R, start, count in plan.launches:
        sel = plan.order[start:start + count]
        assert (tbd.rows_per_lane(J[sel, 6]) == R).all()
        work = J[sel, 4] * J[sel, 6]
        assert (np.diff(work) <= 0).all()
    caps = J[:, 4] + J[:, 1] + 2
    assert plan.n_slots == caps.sum()
    assert (np.diff(plan.slot_off) == caps[:-1]).all()


def test_wrapper_and_routing_checks(monkeypatch):
    """Bands above 512 and letters outside their arrays are refused;
    jobs_fit_device is job_fits_device over arrays, under K1's band cap."""
    from diamond_tpu_torch.ops import swipe_device as sd

    assert tbd.MAX_DEVICE_BAND is sd.MAX_DEVICE_BAND
    J = tbd.job_table([0], [10], [0], [0], [5], [-2], [513])
    with pytest.raises(ValueError):
        tbd.check_jobs(J, 10, 5, 0)
    J[0, 6] = 512
    tbd.check_jobs(J, 10, 5, 0)
    with pytest.raises(ValueError):
        tbd.check_jobs(J, 9, 5, 0)
    J[0, 2] = 1
    with pytest.raises(ValueError):
        tbd.check_jobs(J, 10, 5, 4)
    x = torch.zeros(10, dtype=torch.int8)
    with pytest.raises(TypeError):
        tbd.banded_traceback_multi(x, x, x, torch.from_numpy(J),
                                   torch.zeros(32, 32, dtype=torch.int32),
                                   12, 1)
    t_len = np.array([5, 300, 40, 40, 1000])
    bands = np.array([512, 513, 1, 100, 40])
    for cap in (512, 64):  # K1's band cap, and a lowered one
        monkeypatch.setattr(sd, "MAX_DEVICE_BAND", cap)
        fits = tbd.jobs_fit_device(t_len, bands).tolist()
        assert fits == [sd.job_fits_device(int(t), 0, int(b))
                        for t, b in zip(t_len, bands)]
        assert fits == [cap == 512, False, True, cap == 512, True]


_PROF = """
import json, os, sys
os.environ["DIAMOND_TPU_PROF"] = "1"
from diamond_tpu_torch.cli import main
from diamond_tpu_torch.align import wave
from diamond_tpu_torch.ops import swipe_device
from diamond_tpu_torch.utils import log
cap = int(sys.argv.pop(1))
if cap:
    tb_multi, full = wave._tb_multi, swipe_device.MAX_DEVICE_BAND

    def capped(*a, **kw):
        swipe_device.MAX_DEVICE_BAND = cap
        try:
            return tb_multi(*a, **kw)
        finally:
            swipe_device.MAX_DEVICE_BAND = full
    wave._tb_multi = capped
sys.argv = ["diamond"] + sys.argv[1:]
rc = main(sys.argv[1:])
print("TB_COUNTS=" + json.dumps({k: v for k, v in log.prof_calls.items()
                                 if k.startswith("ext.tb")}), file=sys.stderr)
sys.exit(rc)
"""


def _port_prof(args, tmp_path, extra=None, cap=0):
    """The port's CLI with the span counters on; ``cap`` lowers K1's band
    cap (swipe_device.MAX_DEVICE_BAND) for the traceback rounds, 0 leaves
    it."""
    env = cli_env("diamond_tpu_torch", extra)
    r = subprocess.run([sys.executable, "-c", _PROF, str(cap), *args],
                       capture_output=True, env=env, timeout=600,
                       cwd=str(tmp_path))
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    line = [ln for ln in err.splitlines() if ln.startswith("TB_COUNTS=")]
    return r.stdout, json.loads(line[-1].split("=", 1)[1])


@pytest.mark.parametrize("inp,cap", [("q2", 0), ("synthetic", CAP)])
def test_blastp_card_route_refills_through_d4(inp, cap, tmp_path):
    """blastp on the card route (the CPU asked for): the traceback round
    sends its jobs to D4's plain version (ext.tb_card_jobs > 0; on the
    synthetic set with K1's band cap lowered to CAP a job above it goes to
    the native call, ext.tb_jobs > 0 too, and the results merge), and the
    output is diamond_tpu's, byte for byte, and the host route's."""
    if inp == "q2":
        q = d = f"{GOLD}/q2.faa"
    else:
        cs = _smoke()
        recs = cs.make_proteins(n_seqs=300, n_families=75, seed=5)
        q, d = str(tmp_path / "q.faa"), str(tmp_path / "db.faa")
        cs.write_fasta(d, recs)
        cs.write_fasta(q, recs[:60])
    args = ["blastp", "-q", q, "-d", d, "-f", "6"]
    port, prof = _port_prof(args, tmp_path, cap=cap)
    _, ref, _, _ = run_cli("diamond_tpu", args, tmp_path)
    assert port.strip() and port == ref
    assert prof.get("ext.tb_card_jobs", 0) > 0
    assert prof.get("ext.tb_card_cells", 0) > 0
    assert (prof.get("ext.tb_jobs", 0) > 0) == (cap != 0)
    host, hprof = _port_prof(args, tmp_path,
                             {"DIAMOND_TPU_TORCH_DEVICE_DP": "0"})
    assert host == ref and "ext.tb_card_jobs" not in hprof
