"""Kernel microbenchmarks (reference tools/benchmark.cpp:555-608
`diamond benchmark`): per-kernel cell-update timings in ps/cell plus
GCUPS, on the device the caller chose (the counterpart of
diamond_tpu/benchmark.py, with the same rows in the same order; a row that
named TPU machinery names the port's: (cuda) for a hand-written kernel,
(torch one-hot) and (matmul) for plain tensor code, (DeviceDP) for the
batcher).  Cells are counted from each row's jobs, not from padded arrays.
"""
from __future__ import annotations

import time

import numpy as np
import torch

# sizes of the full run; small=True (tests on the CPU only) shrinks them
FULL = dict(qlen=480, B=2048, T=512, band=128, onehot=256, T_full=256,
            n_full=64, T3=384, n3=256, L12=1 << 20, G12=512, n_multi=128,
            q_multi=420, t_multi=448, n_host=64, n_seqs=64, seq_len=300,
            pairs=20000, keys=1 << 20, T_host_full=300, N2=1 << 17,
            n_adjust=20, n_evalue=1 << 18, reps=3, n_iter=20, n_host_iter=3,
            n_avg=5)
SMALL = dict(qlen=60, B=8, T=48, band=16, onehot=8, T_full=32, n_full=4,
             T3=48, n3=8, L12=4096, G12=4, n_multi=4, q_multi=60, t_multi=64,
             n_host=4, n_seqs=8, seq_len=100, pairs=200, keys=1 << 12,
             T_host_full=50, N2=256, n_adjust=2, n_evalue=1 << 10, reps=1,
             n_iter=1, n_host_iter=1, n_avg=1)


def _timer(device, reps):
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def _time(fn, n_iter):
        """Best of several timed windows (a shared card otherwise reports
        contention as kernel slowness); each call waits for the device."""
        fn()
        sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n_iter):
                fn()
                sync()
            best = min(best, (time.perf_counter() - t0) / n_iter)
        return best

    return _time


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def run_benchmark(device=None, small: bool = False):
    """Print the kernel table; returns its rows [(name, cells, seconds)]."""
    from diamond_tpu_torch.ops import stage2_device as s2
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.ops import swipe_uniform as su
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.stage12 import TILE_Q, TILE_S, stage1_matmul
    from diamond_tpu_torch.ops.swipe_device import DeviceDP
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
    from diamond_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    z = SMALL if small else FULL
    _time = _timer(device, z["reps"])
    dev = torch.device(device)
    print(f"Device: {dev.type} ({_device_name(dev)})")
    rng = np.random.default_rng(0)
    m = ScoreMatrix("BLOSUM62")
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    m32 = torch.from_numpy(np.ascontiguousarray(m.matrix32, np.int32)).to(dev)

    def cells_of(jobs):
        return float(sum(len(t) * (d1 - d0) for t, d0, d1 in jobs))

    def on_dev(packed):
        return {k: torch.from_numpy(v).to(dev) for k, v in packed.items()}

    rows = []

    # banded SWIPE, the uniform-band kernel
    qlen, B, T, band = z["qlen"], z["B"], z["T"], z["band"]
    q = rng.integers(0, 20, qlen).astype(np.int8)
    jobs = [(rng.integers(0, 20, T).astype(np.int8), -band // 2, band // 2)
            for _ in range(B)]
    pk, meta = sud.pack_uniform_batch(q, None, m.matrix32, jobs)
    x = on_dev(pk)
    dt = _time(lambda: sud.banded_swipe_uniform_cuda(
        x["t_idx"], x["band_mask"], x["prof_t"], go, ge, rows=meta["rows"]),
        z["n_iter"])
    rows.append(("banded SWIPE (cuda)", cells_of(jobs), dt))

    # banded SWIPE, the one-hot tensor-op path
    jobs_u = jobs[: z["onehot"]]
    t1h, bm, pp, band_u, _ = su.prepare_uniform_batch(q, None, m.matrix32,
                                                      jobs_u, device)
    dt = _time(lambda: su.banded_swipe_uniform(t1h, bm, pp, go, ge, band_u),
               z["n_iter"])
    rows.append(("banded SWIPE (torch one-hot)", cells_of(jobs_u), dt))

    # full-matrix SWIPE via full-band
    T2 = z["T_full"]
    jobs_f = [(rng.integers(0, 20, T2).astype(np.int8), -(T2 - 1), qlen)
              for _ in range(z["n_full"])]
    pk3, meta3 = sud.pack_uniform_batch(q, None, m.matrix32, jobs_f)
    x3 = on_dev(pk3)
    dt = _time(lambda: sud.banded_swipe_uniform_cuda(
        x3["t_idx"], x3["band_mask"], x3["prof_t"], go, ge,
        rows=meta3["rows"]), z["n_iter"])
    rows.append(("full-matrix SWIPE (cuda)", cells_of(jobs_f), dt))

    # 3-frame (frameshift) banded SWIPE — the blastx -F kernel
    q3 = [rng.integers(0, 20, qlen).astype(np.int8) for _ in range(3)]
    jobs3 = [(0, rng.integers(0, 20, z["T3"]).astype(np.int8), -32, 32)
             for _ in range(z["n3"])]
    p3 = on_dev(s3.pack_swipe3([q3], jobs3))
    k3 = s3.offsets_per_lane(64)
    dt = _time(lambda: s3.banded_swipe3(p3["t_cat"], p3["q_cat"], p3["jobs"],
                                        p3["reqs"], m32, go, ge, 15, k3),
               z["n_iter"])
    rows.append(("3-frame banded SWIPE (cuda)",
                 3.0 * cells_of([j[1:] for j in jobs3]), dt))

    # stage-1 fingerprint identity as a one-hot batched product (seeding
    # hot loop 1; one "cell" = one fingerprint letter comparison)
    L12, G12 = z["L12"], z["G12"]
    l12 = torch.from_numpy(rng.integers(0, 20, L12 + 512).astype(np.int8)).to(dev)
    qp_d = torch.from_numpy(rng.integers(256, L12, (G12, TILE_Q)).astype(
        np.int32)).to(dev)
    sp_d = torch.from_numpy(rng.integers(256, L12, (G12, TILE_S)).astype(
        np.int32)).to(dev)
    dt = _time(lambda: stage1_matmul(l12, l12, qp_d, sp_d, TILE_Q, TILE_S),
               z["n_iter"])
    rows.append(("stage1 fingerprint (matmul)",
                 float(G12) * TILE_Q * TILE_S * 48, dt))

    # multi-query device DP (the production extension path: DeviceDP packs
    # every request's jobs into one launch per band class)
    ddp = DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device=device)
    reqs = []
    for _ in range(z["n_multi"]):
        qm = rng.integers(0, 20, z["q_multi"]).astype(np.int8)
        jm = [(rng.integers(0, 20, z["t_multi"]).astype(np.int8), -64, 65)
              for _ in range(3)]
        reqs.append((qm, None, jm))
    ddp.run_many(reqs)  # first call: builds the kernel
    best_multi = float("inf")
    for _ in range(z["reps"]):
        t0 = time.perf_counter()
        ddp.run_many(reqs)
        best_multi = min(best_multi, time.perf_counter() - t0)
    rows.append(("multi-query SWIPE (DeviceDP)",
                 sum(cells_of(j) for _, _, j in reqs), best_multi))

    rows += _host_rows(rng, m, q, z)

    # pregathered stage-2 filter (cells = window letters scanned per pair)
    N2, W2 = z["N2"], 96
    qw8 = torch.from_numpy(rng.integers(0, 20, (W2, N2)).astype(np.int8)).to(dev)
    sw8 = torch.from_numpy(rng.integers(0, 20, (W2, N2)).astype(np.int8)).to(dev)
    meta2 = np.zeros((3, N2), np.int32)
    meta2[0] = 40
    meta2[1] = 40
    meta2[2] = 20
    md2 = torch.from_numpy(meta2).to(dev)
    m2d = m32[:32, :32].contiguous()
    dt = _time(lambda: s2.stage2_filter(qw8, sw8, md2, m2d, 26, 48), 3)
    rows.append(("stage2 pregathered (cuda)", float(N2) * W2, dt))

    tail, (scores_e, tlens_e) = _host_tail(rng, m, q, z)
    rows += tail

    # the e-value pass's device twin on the same scores
    from diamond_tpu_torch.stats.evalue_device import evalue_torch

    gp = getattr(m, "gumbel", None)
    if gp is not None:
        s_d = torch.from_numpy(scores_e).to(dev)
        t_d = torch.from_numpy(tlens_e).to(dev)
        dt = _time(lambda: evalue_torch(gp, s_d, qlen, t_d), z["n_avg"])
        rows.append(("evalue batch (device)", float(len(scores_e)), dt))

    print(f"{'kernel':<30} {'ps/cell':>10} {'GCUPS':>10}")
    for name, cells, dt in rows:
        ps = dt / cells * 1e12
        gcups = cells / dt / 1e9
        print(f"{name:<30} {ps:>10.2f} {gcups:>10.1f}")
    return rows


def _host_rows(rng, m, q, z):
    """The host-native (C++) kernels, when the toolchain is available."""
    from diamond_tpu_torch import native

    if native.lib() is None:
        return []
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.ops.banded_swipe import (backward_stats_pass_np,
                                                    banded_swipe_batch_np)
    from diamond_tpu_torch.search import stages
    from diamond_tpu_torch.stats.cbs import hauser_bias_i8

    reps, n_iter = z["reps"], z["n_host_iter"]

    def _time_host(fn):
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n_iter):
                fn()
            best = min(best, (time.perf_counter() - t0) / n_iter)
        return best

    rows = []
    T, qlen = z["T"], z["qlen"]
    go_, ge_ = m.gap_open, m.gap_extend
    jobs_h = [(rng.integers(0, 20, T).astype(np.int8), -64, 64)
              for _ in range(z["n_host"])]
    cells_h = float(z["n_host"]) * T * 128
    dt = _time_host(lambda: banded_swipe_batch_np(q, None, jobs_h, m.matrix32,
                                                  go_, ge_))
    rows.append(("banded SWIPE (C++ host)", cells_h, dt))

    # CBS variant: Hauser per-position bias folded into the profile
    bias_h = hauser_bias_i8(q, m.matrix32, m.background_scores)
    dt = _time_host(lambda: banded_swipe_batch_np(q, bias_h, jobs_h,
                                                  m.matrix32, go_, ge_))
    rows.append(("banded SWIPE+CBS (C++ host)", cells_h, dt))

    # traceback variant: mask-emitting fill + walk (the fused round-1
    # engine; reference benchmark.cpp's swipe+traceback cases)
    dt = _time_host(lambda: banded_swipe_batch_np(
        q, None, jobs_h, m.matrix32, go_, ge_, traceback=True))
    rows.append(("banded SWIPE+TB (C++ host)", cells_h, dt))

    # reversed stats pass (BackwardCell twin)
    tgt_b = jobs_h[0][0]
    dt = _time_host(lambda: [backward_stats_pass_np(
        q, None, tgt_b, len(tgt_b), -64, 64, m.matrix32, go_, ge_)
        for _ in range(8)])
    rows.append(("reversed stats (C++ host)", 8.0 * T * 128, dt))

    n_seqs = z["n_seqs"]
    seqs = [rng.integers(0, 20, z["seq_len"]).astype(np.int8)
            for _ in range(n_seqs)]
    blk = Block.from_sequences(seqs, [str(i) for i in range(n_seqs)])
    N = z["pairs"]
    qp = (blk.starts[rng.integers(0, n_seqs, N)] + 50).astype(np.int64)
    sp = (blk.starts[rng.integers(0, n_seqs, N)] + 50).astype(np.int64)
    dt = _time_host(lambda: stages.stage2_scores(
        blk.letters, blk.letters, qp, sp, m.matrix32, 48, True))
    rows.append(("ungapped window (C++ host)", N * 96.0, dt))
    dt = _time_host(lambda: stages.stage1_filter(
        blk.letters, blk.letters, qp, sp, 26))
    rows.append(("fingerprint filter (C++ host)", N * 48.0, dt))

    # Hauser bias build (CBS profile prep; cells = letters)
    L_b = int(blk.lengths.sum())
    dt = _time_host(lambda: native.hauser_bias_block_native(
        blk.letters, blk.starts, blk.lengths, m.matrix32,
        m.background_scores))
    rows.append(("hauser bias (C++ host)", float(L_b), dt))

    # tantan repeat masking (cells = letters)
    tn = Tantan(m.matrix32)
    dt = _time_host(lambda: native.tantan_repeat_prob_many(
        blk.letters, blk.starts, blk.lengths, tn.ratios,
        float(tn.p_repeat), float(tn.p_repeat_end), float(tn.repeat_growth)))
    rows.append(("tantan masking (C++ host)", float(L_b), dt))

    # seed radix sort (cells = keys)
    n_keys = z["keys"]
    keys = rng.integers(0, 1 << 48, n_keys).astype(np.uint64)
    pos = np.arange(n_keys, dtype=np.int64)
    dt = _time_host(lambda: stages._sorted_kv(keys.copy(), pos.copy(),
                                              inplace=True))
    rows.append(("seed radix sort (C++ host)", float(n_keys), dt))

    # full-matrix SWIPE, host striped engine (the --swipe host scoring
    # path; reference benchmark.cpp swipe() full-matrix cases)
    T_f = z["T_host_full"]
    jobs_full = [(rng.integers(0, 20, T_f).astype(np.int8), -(T_f - 1), qlen)
                 for _ in range(z["n_host"])]
    dt = _time_host(lambda: banded_swipe_batch_np(q, None, jobs_full,
                                                  m.matrix32, go_, ge_))
    rows.append(("full-matrix SWIPE (C++ host)",
                 float(z["n_host"]) * T_f * qlen, dt))
    return rows


def _host_tail(rng, m, q, z):
    """The rows after the stage-2 filter: gapped filter, CBS matrix adjust
    and the host e-value pass; also returns the e-value pass's inputs."""
    from diamond_tpu_torch.align.gapped_filter import make_profile8, scan_diags
    from diamond_tpu_torch.stats import cbs as cbs_mod
    from diamond_tpu_torch.stats import matrix_adjust as ma

    rows = []
    T, qlen = z["T"], z["qlen"]
    n_rep = z["n_avg"]

    # diagonal-scan gapped filter (reference benchmark.cpp diag_scores,
    # dp/scan_diags.cpp): per-diagonal Kadane over a 128-diag band
    prof8 = make_profile8(q, None, np.clip(m.matrix32, -128, 127))
    tgt_d = rng.integers(0, 20, T).astype(np.int8)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        scan_diags(prof8, qlen, tgt_d, -64, 0, T, 128)
    rows.append(("diag scores / gapped filter", float(T) * 128,
                 (time.perf_counter() - t0) / n_rep))

    # CBS mode-4 matrix adjust (reference benchmark.cpp matrix_adjust: the
    # NCBI constrained-Newton solve; cells = target-frequency entries per
    # solve, 20x20)
    tl = rng.integers(0, 20, 400).astype(np.int8)
    qc = cbs_mod.composition(q)

    def _adjust():
        return cbs_mod.target_matrix(m, qc, qlen, 4, tl, ma.RULE_USER_RE)

    _adjust()
    t0 = time.perf_counter()
    for _ in range(z["n_adjust"]):
        _adjust()
    rows.append(("matrix adjust CBS4 (solve)", 400.0,
                 (time.perf_counter() - t0) / z["n_adjust"]))

    # e-value engine throughput (reference benchmark.cpp evalue()): the
    # vectorized host pass; its device twin follows
    n_e = z["n_evalue"]
    scores_e = rng.integers(30, 300, n_e).astype(np.int64)
    tlens_e = rng.integers(100, 2000, n_e).astype(np.int64)
    m.evalue(scores_e, qlen, tlens_e)
    t0 = time.perf_counter()
    for _ in range(n_rep):
        m.evalue(scores_e, qlen, tlens_e)
    rows.append(("evalue batch (host)", float(n_e),
                 (time.perf_counter() - t0) / n_rep))
    return rows, (scores_e, tlens_e)
