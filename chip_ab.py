#!/usr/bin/env python3
"""Time the shipped source of a kernel against an older one on one CUDA card.

    python3 chip_ab.py --kernel k1|k3|k4 --parent OLD.cu [--same-shape]
                       [--rounds N] [--queries N] [--reads N] [--seed S]

Builds the kernel's shipped source (``diamond_tpu_torch/csrc``) and the
given older source (``--parent``), one nvcc each, both at once.  Then it
times them in turns (A B B A, ``--rounds`` times) on the batches of the
kernel's path:

  k1  the largest DeviceDP batch of chip_smoke.py's blastp self-search;
  k3  the largest 3-frame batch of its blastx --long-reads run (a window of
      reads) and that window's largest one-read batch;
  k4  the benchmark's first row (band 128) and its full-matrix row (band
      1,024), benchmark.FULL's sizes.

The shipped source is launched with its band classes (``rows_per_lane``,
``offsets_per_lane``, ``uniform_shape``) and must accept them; so is the
older one, except that an older K1 refusing a class of no power of two
(cudaErrorInvalidValue) gets power-of-two classes, and an older K4 the
CTA-per-target shape (``cta_shape``); with ``--same-shape`` (a variant of
the shipped design) it gets the shipped shapes and must accept them.  The
older source must give the shipped outputs.  Prints the card's name and power limit, each variant's
time per round, its median and its ratio to the bound (the cells the batch
needs times the recurrence's int32 operations over 132 SMs x 64 lanes at
the card's maximum SM clock), and the mismatches against the shipped
source.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

SOURCES = {"k1": "banded_swipe", "k3": "swipe3", "k4": "uniform_swipe"}
SYMBOLS = {"k1": ("banded_swipe_multi_launch", "ippppppiiipppp"),
           "k3": ("banded_swipe3_launch", "ipppppiiiippp"),
           "k4": ("uniform_swipe_mask_launch", "iipppiiiiipppp")}


def cta_shape(band: int):
    """K4's CTA-per-target shape (rows per thread, threads): about 128
    threads of up to 16 consecutive band rows, a power of two, at most 512
    threads; the shape the uniform-band kernel took for every band before
    its warp path."""
    R = 1
    while R < -(-band // 128) and R < 16:
        R *= 2
    return R, -(-band // (32 * R)) * 32


def build_variants(kernel: str, parent: str, tmp: str):
    """{"shipped": ctypes function, "parent": ctypes function}."""
    from diamond_tpu_torch.ops import _cuda

    src = os.path.join(_cuda.CSRC_DIR, SOURCES[kernel] + ".cu")
    procs = {}
    for name, cu in (("shipped", src), ("parent", parent)):
        so = os.path.join(tmp, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", _cuda.CSRC_DIR,
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    sym, args = SYMBOLS[kernel]
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(so), sym)
        fn.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int
                       for a in args]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


CUDA_ERROR_INVALID_VALUE = 1


def check(err):
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def k1_case(args, cs, torch, m):
    """The largest DeviceDP batch of the blastp self-search: (label, cells,
    ops, make_call) with make_call(fn) -> (call, outputs)."""
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import swipe_device as sd

    batches = []
    run_many = sd.DeviceDP.run_many

    def spy(self, requests):
        batches.append(requests)
        return run_many(self, requests)

    recs = cs.make_proteins(seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        db, qf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "q.faa")
        cs.write_fasta(db, recs)
        cs.write_fasta(qf, recs[:args.queries])
        sd.DeviceDP.run_many = spy
        try:
            rc = cli_main(["blastp", "-q", qf, "-d", db, "-f", "6", "-o",
                           os.path.join(tmp, "out")])
        finally:
            sd.DeviceDP.run_many = run_many
    if rc or not batches:
        raise RuntimeError("the blastp run made no DeviceDP batch")
    reqs = max(batches, key=lambda b: sum(len(j) for _, _, j in b))
    p = sd.pack_requests(reqs, "cuda")
    jobs = p.jobs.cpu().numpy().astype(np.int64)
    q_len = p.reqs.cpu().numpy()[jobs[:, 4], 1].astype(np.int64)
    cells = int(cs.band_cells(jobs[:, 1], q_len, jobs[:, 2],
                              jobs[:, 3]).sum())
    dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    exact = np.array([sd.rows_per_lane(int(b)) for b in jobs[:, 3]])
    pow2 = np.array([1 << (int(R) - 1).bit_length() for R in exact])
    work = jobs[:, 1] * jobs[:, 3]
    n = p.n_jobs

    def make_call(fn, parent=False):
        outs = [torch.empty(n, dtype=torch.int32, device="cuda")
                for _ in range(3)]
        for rule in ((exact, pow2) if parent else (exact,)):
            launches = []
            for R in np.unique(rule):  # each class longest job first
                idx = np.flatnonzero(rule == R)
                idx = idx[np.argsort(-work[idx], kind="stable")]
                launches.append((int(R), torch.from_numpy(idx).cuda(),
                                 p.jobs[torch.from_numpy(idx).cuda()]
                                 .contiguous(),
                                 [torch.empty(len(idx), dtype=torch.int32,
                                              device="cuda")
                                  for _ in range(3)]))

            def call(launches=launches):
                errs = []
                for R, _idx, jb, o in launches:
                    errs.append(fn(R, p.t_cat.data_ptr(), p.q_cat.data_ptr(),
                                   p.bias_cat.data_ptr(), jb.data_ptr(),
                                   p.reqs.data_ptr(), dp._m32.data_ptr(),
                                   jb.shape[0], dp.go, dp.ge,
                                   *[x.data_ptr() for x in o],
                                   torch.cuda.current_stream().cuda_stream))
                return errs

            errs = call()
            if (parent and rule is exact and any(errs)
                    and set(errs) <= {0, CUDA_ERROR_INVALID_VALUE}):
                continue  # an older source refusing a class: power-of-two
            for e in errs:
                check(e)
            for _R, idx, _jb, o in launches:
                for k in range(3):
                    outs[k][idx] = o[k]
            hist = [(32 * R, len(i)) for R, i, _, _ in launches]
            return (lambda: [check(e) for e in call()]), outs, hist

    print(f"k1 batch: {n} jobs in {len(reqs)} requests, {cells} exact band "
          f"cells; exact classes walk {p.walk_cells} cells, power-of-two "
          f"classes {int((jobs[:, 1] * 32 * pow2).sum())}")
    return [("blastp main-path batch", cells, 12, make_call)]


def k3_case(args, cs, torch, m):
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import swipe3_device as s3

    batches = []
    scores = s3.swipe3_scores

    def spy(strands, jobs, *a, **kw):
        batches.append((strands, jobs))
        return scores(strands, jobs, *a, **kw)

    recs = cs.make_proteins(seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        db, rf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "r.fna")
        cs.write_fasta(db, recs)
        cs.write_fasta(rf, cs.make_reads(recs, args.reads, 2000, 8000,
                                         indels_per_kb=1.0,
                                         seed=args.seed + 10))
        s3.swipe3_scores = spy
        try:
            rc = cli_main(["blastx", "-q", rf, "-d", db, "--long-reads",
                           "-f", "6", "-o", os.path.join(tmp, "out")])
        finally:
            s3.swipe3_scores = scores
    if rc or not batches:
        raise RuntimeError("the long-reads run made no 3-frame batch")
    m32 = torch.from_numpy(m.matrix32.astype(np.int32)).cuda()
    go, ge, fs = m.gap_open + m.gap_extend, m.gap_extend, 15
    strands, jobs = max(batches, key=lambda b: len(b[1]))
    read_of = np.array([s // 2 for s, _, _, _ in jobs])
    work = np.array([len(t) * (d1 - d0) for _, t, d0, d1 in jobs])
    r1 = int(np.argmax(np.bincount(read_of, weights=work)))
    one = [(s - 2 * r1, t, d0, d1) for s, t, d0, d1 in jobs if s // 2 == r1]
    cases = []
    for label, st, jb in (("long-reads window", strands, jobs),
                          ("one read", strands[2 * r1: 2 * r1 + 2], one)):
        pk = s3.pack_swipe3(st, jb)
        K = np.array([s3.offsets_per_lane(int(b)) for b in pk["jobs"][:, 3]])
        order = np.lexsort((-pk["jobs"][:, 1].astype(np.int64), K))
        x = {k: torch.from_numpy(v).cuda() for k, v in pk.items()}
        sel = [(int(k), torch.from_numpy(np.ascontiguousarray(
            pk["jobs"][order][K[order] == k])).cuda()) for k in np.unique(K)]

        def make_call(fn, x=x, sel=sel, parent=False):  # same launches
            outs = {k: [torch.empty(j.shape[0], dtype=torch.int32,
                                    device="cuda") for _ in range(2)]
                    for k, j in sel}

            def call():
                for k, j in sel:
                    check(fn(k, x["t_cat"].data_ptr(), x["q_cat"].data_ptr(),
                             j.data_ptr(), x["reqs"].data_ptr(),
                             m32.data_ptr(), j.shape[0], go, ge, fs,
                             outs[k][0].data_ptr(), outs[k][1].data_ptr(),
                             torch.cuda.current_stream().cuda_stream))

            call()
            return call, [o for k, _ in sel for o in outs[k]], \
                [(32 * k, j.shape[0]) for k, j in sel]

        cells = int(cs.swipe3_cells(pk["jobs"], pk["reqs"]).sum())
        cases.append((f"{label} ({len(jb)} jobs)", cells, 15, make_call))
    return cases


def k4_case(args, cs, torch, m):
    from diamond_tpu_torch.benchmark import FULL
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.swipe_uniform import uniform_shape

    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, FULL["qlen"]).astype(np.int8)
    band = FULL["band"]
    first = [(rng.integers(0, 20, FULL["T"]).astype(np.int8), -band // 2,
              band // 2) for _ in range(FULL["B"])]
    t2 = FULL["T_full"]
    full = [(rng.integers(0, 20, t2).astype(np.int8), -(t2 - 1), len(q))
            for _ in range(FULL["n_full"])]
    cases = []
    for label, jobs in (("benchmark first row", first),
                        ("benchmark full-matrix row", full)):
        pk, meta = sud.pack_uniform_batch(q, None, m.matrix32, jobs)
        x = {k: torch.from_numpy(v).cuda() for k, v in pk.items()}
        B, T = pk["t_idx"].shape
        bd = meta["band"]
        cells = int(cs.band_cells(np.array([len(t) for t, _, _ in jobs]),
                                  np.full(len(jobs), len(q)),
                                  np.array([d0 for _, d0, _ in jobs]),
                                  np.array([d1 - d0 for _, d0, d1 in jobs]))
                    .sum())

        def make_call(fn, x=x, B=B, T=T, bd=bd, parent=False):
            outs = [torch.empty(B, dtype=torch.int32, device="cuda")
                    for _ in range(3)]
            R, th = (cta_shape if parent else uniform_shape)(bd)

            def call():
                check(fn(R, th, x["t_idx"].data_ptr(),
                         x["band_mask"].data_ptr(), x["prof_t"].data_ptr(),
                         B, T, bd, go, ge, *[o.data_ptr() for o in outs],
                         torch.cuda.current_stream().cuda_stream))

            call()
            return call, outs, [(bd, R, th)]

        cases.append((f"{label} ({B} targets of {T}, band {bd})", cells, 11,
                      make_call))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), required=True)
    ap.add_argument("--parent", required=True,
                    help="an older source of the kernel to time beside")
    ap.add_argument("--same-shape", action="store_true",
                    help="launch the older source with the shipped shapes")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--queries", type=int, default=10_000,
                    help="queries of the blastp run (k1)")
    ap.add_argument("--reads", type=int, default=300,
                    help="reads of the long-reads run (k3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    name_power = cs.smi("name,power.limit")
    clock_mhz = float(cs.smi("clocks.max.sm").split()[0])
    print(name_power)
    print(f"kernel {args.kernel}: csrc/{SOURCES[args.kernel]}.cu against "
          f"{args.parent}; max SM clock {clock_mhz:.0f} MHz")
    lanes_per_s = cs.H100_SMS * cs.INT32_LANES_PER_SM * clock_mhz * 1e6
    m = ScoreMatrix("BLOSUM62")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(args.kernel, args.parent, tmp)
        cases = {"k1": k1_case, "k3": k3_case, "k4": k4_case}[args.kernel](
            args, cs, torch, m)
        for label, cells, ops, make_call in cases:
            bound_ms = cells * ops / lanes_per_s * 1e3
            print(f"{label}: {cells} cells x {ops} int32 ops, bound "
                  f"{bound_ms:.5f} ms (operations)")
            calls = {}
            for name, fn in fns.items():
                kw = ({"parent": True} if name == "parent"
                      and not args.same_shape else {})
                call, outs, shape = make_call(fn, **kw)
                torch.cuda.synchronize()
                calls[name] = (call, [o.clone() for o in outs])
                print(f"  {name}: launches {shape}")
            want = calls["shipped"][1]
            times = {name: [] for name in calls}
            order = list(calls)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    times[name].append(cs.cuda_ms(calls[name][0], 10))
            for name, (call, outs) in calls.items():
                mis = sum(int((o != w).sum()) for o, w in zip(outs, want))
                med = float(np.median(times[name]))
                print(f"  {name}: {' '.join(f'{t:.4f}' for t in times[name])}"
                      f" ms; median {med:.4f} ms, {med / bound_ms:.2f}x the "
                      f"bound; mismatches vs shipped {mis}; {name_power}")
                if mis:
                    raise RuntimeError(f"{name} disagrees with the shipped "
                                       f"source")
    return 0


if __name__ == "__main__":
    sys.exit(main())
