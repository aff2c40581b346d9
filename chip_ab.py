#!/usr/bin/env python3
"""Time the shipped source of a kernel against an older one on one CUDA card.

    python3 chip_ab.py --kernel k1|k2|k3|k4|k6|d1j|d4|mask --parent OLD.cu
                       [--same-shape] [--rounds N] [--queries N] [--reads N]
                       [--swipe-queries N] [--seed S]
    python3 chip_ab.py --kernel seed [--rounds N] [--seed S]

Builds the kernel's shipped source (``diamond_tpu_torch/csrc``) and the
given older source (``--parent``), one nvcc each, both at once.  Then it times them in turns (A B B
A, ``--rounds`` times) on the batches of the kernel's path:

  k1  the largest DeviceDP batch of chip_smoke.py's blastp self-search;
  k2  the largest launch of its blastp --swipe run (32 queries against the
      10,000 proteins), and all of that run's launches;
  k3  the largest 3-frame batch of its blastx --long-reads run (a window of
      reads) and that window's largest one-read batch;
  k4  the benchmark's first row (band 128, the warp path) and its
      full-matrix row (band 1,024, the wide-band walk), benchmark.FULL's
      sizes, and the largest launch (by matrix cells) of chip_smoke.py's
      blastp --swipe --mesh 1 run (32 queries against the 10,000 proteins,
      the device DP off: K4 a shard);
  k6  the benchmark's stage-2 row, 131,072 pairs x 96 window letters;
  d1j the largest call of D1's fused pass (stage12_join: its two kernels
      and the scan between them, on its entries, no sync) in the blastp
      self-search with stage 1/2 on the card;
  d4  the largest traceback call of the blastp self-search (its fill
      launches, the scan and the ops' compaction on preallocated buffers,
      no sync);
  mask tantan's scan over the benchmark's block (15,000 proteins of
      perfbench/gen.py's frozen generator, ~5.8 M letters; each call
      masks a fresh device copy of the letters), its bound the larger of
      chip_smoke.MASK_OPS fp32 ops a letter and state over 132 SMs x 128
      lanes and the longest sequence's chain (MASK_CHAIN_OPS dependent
      ops a letter at FP32_LATENCY_CYCLES each).

``--kernel seed`` takes no older source: it times the card route of the
query-indexed DB-side seed enumeration as a search runs it (the block's
``upload_block``, then ``enumerate_block`` for both default shapes: the
keys' upload, the launches, the survivors back) in turns against the
native fused pass it replaces (``chip_smoke.seed_native``, both shapes),
host clock around each search, on ``chip_smoke.seed_block``'s blocks of
15,000 (the benchmark's), 3,000, 300, 120, 60 and 30 proteins with the
keys of their first 20 and first 1,000 proteins; the two must give the
same keys and positions.

Each round times each variant three ways: 10 calls launched from Python
between two events (the per-call time of chip_smoke.py's rows), 10 calls
replayed from one CUDA graph (the kernels' own time), and, for k6, one
call at a time after the L2 was flushed (cold) by writing 256 MB, and
by reading them.

The shipped source is launched with its band classes (``rows_per_lane``,
``offsets_per_lane``, ``uniform_shape``) and must accept them; so is the
older one, except that an older K1 refusing a class of no power of two
(cudaErrorInvalidValue) gets power-of-two classes, and an older K4 its
own entry point (``PARENT_SYMBOLS``: no scratch and no profile rows) and
shapes (``parent_k4_shape``: its warp path up to 512 rows, a CTA per
target above); with ``--same-shape`` (a variant of the shipped design) it
gets the shipped entry point and shapes and must accept them.  The
older source must give the shipped outputs.  Prints the card's name and
power limit, each variant's times per round, their medians and their
ratios to the bound (the larger of the cells the batch needs times the
recurrence's int32 operations over 132 SMs x 64 lanes at the card's
maximum SM clock, and the bytes it reads and writes once over 3.35 TB/s),
and the mismatches against the shipped source.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SOURCES = {"k1": "banded_swipe", "k2": "full_swipe", "k3": "swipe3",
           "k4": "uniform_swipe", "k6": "stage2", "d1j": "stage12_join",
           "d4": "banded_traceback", "mask": "tantan"}
# each kernel's C entry points and their argument types (launcher letters)
SYMBOLS = {"k1": [("banded_swipe_multi_launch", "ippppppiiipppp")],
           "k2": [("full_swipe_launch", "ipppppppiiiipipp")],
           "k3": [("banded_swipe3_launch", "ipppppiiiippp")],
           "k4": [("uniform_swipe_mask_launch", "iipppiiiiiiiiippppp")],
           "k6": [("stage2_launch", "ppppiiiipppp")],
           "d1j": [("stage12_join_eval",
                    "ppppppiippppppppipiiqpipiiiqpiiiiippp"),
                   ("stage12_join_rows", "pppiippppppp")],
           "d4": [("tb_fill_launch", "ipppppipiipppppppp"),
                  ("tb_compact_launch", "ipppppppp")],
           "mask": [("tantan_mask_launch", "ppppippppppffffip")]}
# an older source's entry points where they differ from the shipped ones:
# K4 before its wide-band walk (a CTA per target above 512 rows) took no
# scratch and no profile rows
PARENT_SYMBOLS = {"k4": [("uniform_swipe_mask_launch", "iipppiiiiipppp")]}
ARG_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_uint64,
             "f": ctypes.c_float}


def parent_k4_shape(band: int):
    """An older K4's shape (rows per thread, threads): up to 512 rows its
    warp path (ceil(band / 32) rows a lane), wider bands one CTA per target
    of about 128 threads of up to 16 consecutive band rows, a power of two,
    at most 512 threads."""
    if band <= 512:
        return -(-band // 32), 32
    R = 1
    while R < -(-band // 128) and R < 16:
        R *= 2
    return R, -(-band // (32 * R)) * 32


def build_variants(kernel: str, parent: str, tmp: str,
                   same_shape: bool = False):
    """{"shipped": ctypes function, "parent": ctypes function}; a tuple of
    functions for a kernel of several entry points (d1j, d4)."""
    from diamond_tpu_torch.ops import _cuda

    src = os.path.join(_cuda.CSRC_DIR, SOURCES[kernel] + ".cu")
    procs = {}
    for name, cu in (("shipped", src), ("parent", parent)):
        so = os.path.join(tmp, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
             _cuda.CSRC_DIR, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
        lib = ctypes.CDLL(so)
        got = []
        symbols = SYMBOLS[kernel]
        if name == "parent" and not same_shape:
            symbols = PARENT_SYMBOLS.get(kernel, symbols)
        for sym, args in symbols:
            fn = getattr(lib, sym)
            fn.argtypes = [ARG_TYPES[a] for a in args]
            fn.restype = ctypes.c_int
            got.append(fn)
        fns[name] = got[0] if len(got) == 1 else tuple(got)
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
    return [("blastp main-path batch", cells, cs.K1_OPS, 0, make_call)]


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
        cases.append((f"{label} ({len(jb)} jobs)", cells, cs.K3_OPS, 0,
                      make_call))
    return cases


def k4_case(args, cs, torch, m):
    """The benchmark's two K4 rows and the largest launch of the blastp
    --swipe --mesh 1 run."""
    from diamond_tpu_torch.benchmark import FULL
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import swipe_uniform_device as sud
    from diamond_tpu_torch.ops.swipe_uniform import (profile_rows,
                                                     uniform_shape)

    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, FULL["qlen"]).astype(np.int8)
    band = FULL["band"]
    first = [(rng.integers(0, 20, FULL["T"]).astype(np.int8), -band // 2,
              band // 2) for _ in range(FULL["B"])]
    t2 = FULL["T_full"]
    full = [(rng.integers(0, 20, t2).astype(np.int8), -(t2 - 1), len(q))
            for _ in range(FULL["n_full"])]
    batches = []
    for label, jobs in (("benchmark first row", first),
                        ("benchmark full-matrix row", full)):
        pk, _ = sud.pack_uniform_batch(q, None, m.matrix32, jobs)
        x = {k: torch.from_numpy(v).cuda() for k, v in pk.items()}
        cells = int(cs.band_cells(np.array([len(t) for t, _, _ in jobs]),
                                  np.full(len(jobs), len(q)),
                                  np.array([d0 for _, d0, _ in jobs]),
                                  np.array([d1 - d0 for _, d0, d1 in jobs]))
                    .sum())
        batches.append((label, x, cells))

    # the largest launch of --swipe --mesh 1: its matrix cells are the
    # query's live rows times each target's letters (pad letter 31 apart)
    biggest = [0, None]
    wrapper = sud.banded_swipe_uniform_cuda

    def spy(t_idx, band_mask, prof_t, go_, ge_, rows=None):
        p_lo, p_hi = (rows or profile_rows(prof_t))[:2]
        cells = (p_hi - p_lo) * int((t_idx != 31).sum())
        if cells > biggest[0]:
            biggest[:] = [cells, dict(t_idx=t_idx.clone(),
                                      band_mask=band_mask.clone(),
                                      prof_t=prof_t.clone())]
        return wrapper(t_idx, band_mask, prof_t, go_, ge_, rows=rows)

    spy.launches = 0  # the wrapper counts its launches on the name it finds
    recs = cs.make_proteins(seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        db, qf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "q.faa")
        cs.write_fasta(db, recs)
        cs.write_fasta(qf, recs[:args.swipe_queries])
        sud.banded_swipe_uniform_cuda = spy
        os.environ["DIAMOND_TPU_TORCH_DEVICE_DP"] = "0"
        try:
            rc = cli_main(["blastp", "-q", qf, "-d", db, "--swipe", "--mesh",
                           "1", "-f", "6", "-o", os.path.join(tmp, "out")])
        finally:
            sud.banded_swipe_uniform_cuda = wrapper
            os.environ.pop("DIAMOND_TPU_TORCH_DEVICE_DP")
    if rc or biggest[1] is None:
        raise RuntimeError("the --swipe --mesh 1 run launched no K4")
    batches.append(("--swipe --mesh 1's largest launch", biggest[1],
                    biggest[0]))

    cases = []
    for label, x, cells in batches:
        B, T = x["t_idx"].shape
        bd = x["prof_t"].shape[1] - T
        rows = profile_rows(x["prof_t"])

        def make_call(fn, x=x, B=B, T=T, bd=bd, rows=rows, parent=False):
            outs = [torch.empty(B, dtype=torch.int32, device="cuda")
                    for _ in range(3)]
            if parent:
                R, th = parent_k4_shape(bd)

                def call():
                    check(fn(R, th, x["t_idx"].data_ptr(),
                             x["band_mask"].data_ptr(), x["prof_t"].data_ptr(),
                             B, T, bd, go, ge, *[o.data_ptr() for o in outs],
                             torch.cuda.current_stream().cuda_stream))
                shape = (bd, R, th)
            else:
                def call():  # the shipped wrapper's launches, rows given
                    k4 = sud._k4
                    sud._k4 = lambda: fn
                    try:
                        sud.uniform_launch(x["t_idx"], x["band_mask"],
                                           x["prof_t"], go, ge, rows, outs)
                    finally:
                        sud._k4 = k4
                shape = (bd, *uniform_shape(bd, rows[1] - rows[0]), rows)
            call()
            return call, outs, [shape]

        n_bytes = sum(v.numel() * v.element_size() for v in x.values()) \
            + 3 * 4 * B
        # the wide walk issues DPX (cs.K4W_OPS); the count before DPX beside
        wide = bd > sud.MAX_WARP_BAND
        cases.append((f"{label} ({B} targets of {T}, band {bd})", cells,
                      cs.K4W_OPS if wide else cs.K45_OPS, n_bytes, make_call,
                      *([cs.K45_OPS] if wide else [])))
    return cases


def k2_case(args, cs, torch, m):
    """The largest launch of the blastp --swipe run, and all its launches."""
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import swipe_device as sd

    blocks = []
    dispatch = sd.FullSweep.dispatch_block

    def spy(self, queries, tblock, t_order, kernel=None):
        blocks.append((self, queries, tblock, t_order))
        return dispatch(self, queries, tblock, t_order, kernel=kernel)

    recs = cs.make_proteins(seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        db, qf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "q.faa")
        cs.write_fasta(db, recs)
        cs.write_fasta(qf, recs[:args.swipe_queries])
        sd.FullSweep.dispatch_block = spy
        try:
            rc = cli_main(["blastp", "-q", qf, "-d", db, "--swipe", "-f", "6",
                           "-o", os.path.join(tmp, "out")])
        finally:
            sd.FullSweep.dispatch_block = dispatch
    if rc or not blocks:
        raise RuntimeError("the --swipe run made no FullSweep block")
    sweep, queries, tblock, t_order = blocks[0]
    b = sweep.pack(queries, tblock, t_order)
    x = {k: torch.from_numpy(getattr(b, k)).cuda()
         for k in ("t_cat", "targets", "q_cat", "bias_cat")}
    per = [(L, torch.from_numpy(L.reqs).cuda(),
            torch.from_numpy(L.pairs).cuda(),
            torch.empty((L.slots, 2, len(b.t_cat), 2), dtype=torch.int32,
                        device="cuda")) for L in b.launches]

    def case(label, launches):
        def make_call(fn, parent=False):
            out = torch.zeros((b.n_queries, b.n_targets), dtype=torch.int32,
                              device="cuda")

            def call():
                for L, r, p, scratch in launches:
                    check(fn(L.R, x["t_cat"].data_ptr(),
                             x["targets"].data_ptr(), x["q_cat"].data_ptr(),
                             x["bias_cat"].data_ptr(), r.data_ptr(),
                             p.data_ptr(), sweep._m32.data_ptr(), p.shape[0],
                             b.n_targets, sweep.go, sweep.ge,
                             scratch.data_ptr(), len(b.t_cat), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream))

            call()
            return call, [out], [(L.R, len(L.pairs)) for L, _, _, _ in
                                 launches]

        cells = sum(L.cells for L, _, _, _ in launches)
        n_bytes = (len(b.t_cat) + 4 * b.targets.size + len(b.q_cat)
                   + len(b.bias_cat) + sum(4 * (L.reqs.size + L.pairs.size
                                                + 32 * 32 + len(L.pairs))
                                           for L, _, _, _ in launches))
        return (label, cells, cs.K2_OPS, n_bytes, make_call)

    big = max(per, key=lambda t: t[0].cells)
    print(f"k2 block: {b.n_queries} queries x {b.n_targets} targets in "
          f"{len(per)} launches; the largest has {len(big[0].pairs)} pairs "
          f"of R {big[0].R}")
    return [case("--swipe largest launch", [big]),
            case(f"--swipe path ({len(per)} launches)", per)]


def k6_case(args, cs, torch, m):
    """The benchmark's stage-2 row: 131,072 pairs x 96 window letters, with
    chip_smoke.py's timing inputs."""
    from diamond_tpu_torch.benchmark import FULL

    rng = np.random.default_rng(args.seed + 6)
    n, w = FULL["N2"], 96
    qw = rng.integers(0, 20, (w, n)).astype(np.int8)
    sw = rng.integers(0, 20, (w, n)).astype(np.int8)
    sw[:, ::5] = qw[:, ::5]
    meta = np.zeros((3, n), np.int32)
    meta[0], meta[1], meta[2] = 40, 40, 20
    x = [torch.from_numpy(a).cuda() for a in
         (qw, sw, meta, np.ascontiguousarray(m.matrix32[:32, :32],
                                              dtype=np.int32))]

    def make_call(fn, parent=False):
        outs = [torch.empty(n, dtype=dt, device="cuda")
                for dt in (torch.bool, torch.int32, torch.int32)]

        def call():
            check(fn(*[a.data_ptr() for a in x], w, n, w // 2, 26,
                     *[o.data_ptr() for o in outs],
                     torch.cuda.current_stream().cuda_stream))

        call()
        return call, outs, [(w, n)]

    n_bytes = 2 * w * n + 4 * meta.size + 4 * 32 * 32 + (1 + 4 + 4) * n
    return [(f"benchmark stage-2 row ({n} pairs x {w})", n * w, cs.K6_OPS,
             n_bytes, make_call)]


def d1j_case(args, cs, torch, m):
    """The largest call of D1's fused pass (stage12_join) in the blastp
    self-search with stage 1/2 on the card."""
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import stage12_device as d1m

    calls = []
    join = d1m.stage12_join

    def spy(*a, **kw):
        out = join(*a, **kw)
        calls.append((kw["counts"][1], a, kw["counts"], out))
        return out

    spy.launches = 0  # the wrapper counts on the name its module binds

    recs = cs.make_proteins(seed=args.seed)
    os.environ["DIAMOND_TPU_TORCH_STAGE12"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        db, qf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "q.faa")
        cs.write_fasta(db, recs)
        cs.write_fasta(qf, recs[:args.queries])
        d1m.stage12_join = spy
        try:
            rc = cli_main(["blastp", "-q", qf, "-d", db, "-f", "6", "-o",
                           os.path.join(tmp, "out")])
        finally:
            d1m.stage12_join = join
            os.environ.pop("DIAMOND_TPU_TORCH_STAGE12")
    if rc or not calls:
        raise RuntimeError("the blastp run made no stage12_join call")
    n, call, counts, rows = max(calls, key=lambda c: c[0])
    entries = d1m.join_entries(*call[3:6], call[7], call[8], call[9],
                               counts[0])
    work, _ = cs.d1j_work(call, len(rows))
    ops = cs.d1j_ops(work, cs.D1J_OPS)
    k_join = d1m._k_join

    def make_call(fns, parent=False):
        out = torch.empty_like(rows)

        def run():
            d1m._k_join = lambda: fns
            try:
                d1m._join_launch(*call, *counts, entries=entries,
                                 rows_out=out)
            finally:
                d1m._k_join = k_join

        run()
        return run, [out], [(n, "pairs"), (counts[0], "entries")]

    print(f"d1j call: {json.dumps(work)}")
    return [(f"blastp's largest stage12_join call ({n} pairs)", n, ops / n,
             cs.d1j_bytes(call, len(rows)), make_call)]


def d4_case(args, cs, torch, m):
    """The largest traceback call (D4) of the blastp self-search."""
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import traceback_device as tbd

    calls = []
    tb_multi_device = tbd.tb_multi_device

    def spy(*a):
        calls.append(a)
        return tb_multi_device(*a)

    recs = cs.make_proteins(seed=args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        db, qf = os.path.join(tmp, "db.faa"), os.path.join(tmp, "q.faa")
        cs.write_fasta(db, recs)
        cs.write_fasta(qf, recs[:args.queries])
        tbd.tb_multi_device = spy
        try:
            rc = cli_main(["blastp", "-q", qf, "-d", db, "-f", "6", "-o",
                           os.path.join(tmp, "out")])
        finally:
            tbd.tb_multi_device = tb_multi_device
    if rc or not calls:
        raise RuntimeError("the blastp run made no D4 call")
    a = max(calls, key=lambda c: len(c[7]))
    jobs = tbd.job_table(*(a[k] for k in (2, 3, 4, 6, 7, 8, 9)))
    if a[1] is None:
        jobs[:, 2] = 0
    bias = np.zeros(1, np.int32) if a[1] is None else a[1]
    x = [torch.from_numpy(np.ascontiguousarray(v, dtype=dt)).cuda()
         for v, dt in ((a[0], np.int8), (bias, np.int32), (a[5], np.int8),
                       (jobs, np.int64))]
    m32 = torch.from_numpy(m.matrix32.astype(np.int32)).cuda()
    go, ge = m.gap_open + m.gap_extend, m.gap_extend
    plan = tbd.tb_plan(jobs)
    ref = tbd.banded_traceback_multi(*x, m32, go, ge, plan=plan)
    n_ops = ref[1][:, 10].cpu().numpy()
    cells, steps = cs.tb_work(jobs[:, 4], jobs[:, 1], jobs[:, 5], jobs[:, 6],
                              n_ops)
    ops = cells * cs.D4_OPS + steps * cs.D4_WALK_OPS
    q_used = np.unique(jobs[:, :2], axis=0)
    n_bytes = (cells + 5 * steps + int(jobs[:, 4].sum())
               + 5 * int(q_used[:, 1].sum()) + 8 * jobs.size
               + 8 * 15 * len(jobs) + 4 * 32 * 32)
    bufs = tbd.tb_buffers(plan, "cuda")
    k_d4 = tbd._d4

    def make_call(fns, parent=False):
        outs = [torch.empty_like(t) for t in ref]

        def call():
            tbd._d4 = lambda: fns
            try:
                tbd.tb_launch(*x, m32, go, ge, plan, bufs, outs[0], outs[1])
                n = outs[1][:, 10]
                torch.sub(torch.cumsum(n, 0), n, out=outs[2])
                tbd.tb_compact(outs[1], bufs, outs[2], outs[3], outs[4])
            finally:
                tbd._d4 = k_d4

        call()
        return call, outs, [(32 * R, c) for R, _, c in plan.launches]

    print(f"d4 call: {len(jobs)} jobs of {len(calls)} calls, {cells} exact "
          f"band cells, {steps} walk ops, {len(plan.slices)} plane slices")
    return [(f"blastp's largest traceback call ({len(jobs)} jobs)", cells,
             ops / cells, n_bytes, make_call)]


def mask_case(args, cs, torch, m):
    """tantan's scan over the benchmark's block."""
    from diamond_tpu_torch.data.block import Block
    from diamond_tpu_torch.masking.tantan import Tantan
    from diamond_tpu_torch.ops import tantan_device as td

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "perfbench"))
    import gen

    recs = gen.make_proteins(15_000, 3_750, seed=args.seed, size_seed=2500)
    blk = Block.from_sequences([s for _, s in recs], [i for i, _ in recs])
    params = td.scan_params(Tantan(m.matrix32))
    lens = blk.lengths.astype(np.int64)
    orig = torch.from_numpy(blk.letters).cuda()
    st, ln = torch.from_numpy(blk.starts).cuda(), torch.from_numpy(lens).cuda()
    n_let, longest = int(lens.sum()), int(lens.max())
    n_bytes = 2 * len(blk.letters) + 16 * len(blk) + 4 * (32 * 32 + 50)
    k_mask = td._kernel
    o, so = td.launch_plan(lens)[:2]
    plan = (torch.from_numpy(o).cuda(), torch.from_numpy(so).cuda(), longest,
            n_let)

    def make_call(fn, parent=False):
        x = torch.empty_like(orig)

        def call():
            x.copy_(orig)
            td._kernel = lambda: fn
            try:
                td.tantan_mask(x, st, ln, params, plan=plan)
            finally:
                td._kernel = k_mask

        call()
        return call, [x], [(len(blk), n_let)]

    clock_hz = float(cs.smi("clocks.max.sm").split()[0]) * 1e6
    make_call.chain_ms = (longest * cs.MASK_CHAIN_OPS
                          * cs.FP32_LATENCY_CYCLES / clock_hz * 1e3)
    print(f"mask block: {len(blk)} sequences, {n_let} letters (longest "
          f"{longest}); chain bound {make_call.chain_ms:.5f} ms")
    return [(f"tantan over the benchmark's block ({len(blk)} sequences)",
             n_let * td.WINDOW, cs.MASK_OPS, n_bytes, make_call)]


def seed_ab(args, cs):
    """The card route of the DB-side seed enumeration in turns against the
    native pass (A B B A, ``--rounds`` times), host clock, a search at a
    time, at block sizes from the benchmark's down to a few dozen
    proteins."""
    import time

    import torch

    from diamond_tpu_torch.ops import seed_enum_device as sed
    from diamond_tpu_torch.seed.reduction import MURPHY10 as red

    torch.zeros(1, device="cuda")  # the context, as masking leaves it
    torch.cuda.synchronize()
    sed._kernel()  # built and loaded: the first search below is a warm run's
    for n_seqs in SEED_BLOCKS:
        blk, lens, _, up_ms, cases = cs.seed_block(args.seed, n_seqs)
        print(f"block of {n_seqs} proteins, {int(lens.sum())} letters in "
              f"{len(blk.letters)}: upload_block {up_ms:.3f} ms (a larger "
              f"pinned staging buffer allocated in it, if one was needed)")
        for n_q in sorted({c[0] for c in cases}):
            mine = [(shape, qs) for q, shape, qs in cases if q == n_q]

            def card():
                t = sed.upload_block(blk.letters, blk.starts, lens,
                                     sed.reduce_table(red), red.size, "cuda")
                return [sed.enumerate_block(t, shape.positions,
                                            shape.length, qs)
                        for shape, qs in mine]

            def host():
                return [cs.seed_native(blk, lens, shape, qs)
                        for shape, qs in mine]

            calls = {"card": card, "native": host}
            outs, first = {}, {}
            for name, fn in calls.items():
                t0 = time.perf_counter()
                outs[name] = fn()
                first[name] = (time.perf_counter() - t0) * 1e3
            times = {name: [] for name in calls}
            order = list(calls)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    t0 = time.perf_counter()
                    calls[name]()
                    times[name].append((time.perf_counter() - t0) * 1e3)
            same = all(np.array_equal(a, b)
                       for c, n in zip(outs["card"], outs["native"])
                       for a, b in zip(c, n))
            med = {name: float(np.median(ts)) for name, ts in times.items()}
            print(f"{n_seqs} proteins, {n_q} proteins' keys "
                  f"({' + '.join(str(len(qs)) for _, qs in mine)}), both "
                  f"default shapes a search: "
                  f"{' + '.join(str(len(o[0])) for o in outs['native'])} "
                  f"survivors; " + "; ".join(
                      f"{name} first {first[name]:.3f}, then "
                      f"{' '.join(f'{t:.3f}' for t in ts)} ms, "
                      f"median {med[name]:.3f}"
                      for name, ts in times.items())
                  + f"; native / card {med['native'] / med['card']:.2f}; "
                  f"equal {same}; {cs.smi('name,power.limit')}")
            if not same:
                raise RuntimeError("the card route disagrees with the "
                                   "native pass")
    return 0


# the blocks seed_ab times: the benchmark's, chip_smoke's blastp test DB,
# and small ones around the card route's least block
# (seed_enum_device.MIN_LETTERS)
SEED_BLOCKS = (15_000, 3_000, 300, 120, 60, 30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES) + ["seed"],
                    required=True)
    ap.add_argument("--parent",
                    help="an older source of the kernel to time beside "
                         "(every kernel but seed)")
    ap.add_argument("--same-shape", action="store_true",
                    help="launch the older source with the shipped shapes")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--queries", type=int, default=10_000,
                    help="queries of the blastp run (k1, d1j)")
    ap.add_argument("--reads", type=int, default=300,
                    help="reads of the long-reads run (k3)")
    ap.add_argument("--swipe-queries", type=int, default=32,
                    help="queries of the blastp --swipe runs (k2, k4)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    if args.kernel == "seed":
        print(cs.smi("name,power.limit"))
        return seed_ab(args, cs)
    if not args.parent:
        ap.error(f"--kernel {args.kernel} needs --parent")

    name_power = cs.smi("name,power.limit")
    clock_mhz = float(cs.smi("clocks.max.sm").split()[0])
    print(name_power)
    print(f"kernel {args.kernel}: csrc/{SOURCES[args.kernel]}.cu against "
          f"{args.parent}; max SM clock {clock_mhz:.0f} MHz")
    lanes_per_s = cs.H100_SMS * (
        cs.FP32_LANES_PER_SM if args.kernel == "mask"
        else cs.INT32_LANES_PER_SM) * clock_mhz * 1e6
    m = ScoreMatrix("BLOSUM62")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(args.kernel, args.parent, tmp, args.same_shape)
        cases = {"k1": k1_case, "k2": k2_case, "k3": k3_case, "k4": k4_case,
                 "k6": k6_case, "d1j": d1j_case,
                 "d4": d4_case, "mask": mask_case}[args.kernel](
                     args, cs, torch, m)
        for label, cells, ops, n_bytes, make_call, *pre in cases:
            bound_ms = max(cells * ops / lanes_per_s,
                           n_bytes / cs.HBM_BYTES_PER_S) * 1e3
            by = ("operations" if cells * ops / lanes_per_s
                  >= n_bytes / cs.HBM_BYTES_PER_S else "bytes")
            if getattr(make_call, "chain_ms", 0.0) > bound_ms:
                bound_ms, by = make_call.chain_ms, "the longest chain"
            kind_ops = "fp32" if args.kernel == "mask" else "int32"
            print(f"{label}: {cells} cells x {ops} {kind_ops} ops, {n_bytes} "
                  f"bytes, bound {bound_ms:.5f} ms ({by})" + "".join(
                      f"; at {p} ops before DPX "
                      f"{cells * p / lanes_per_s * 1e3:.5f} ms" for p in pre))
            calls = {}
            for name, fn in fns.items():
                kw = ({"parent": True} if name == "parent"
                      and not args.same_shape else {})
                call, outs, shape = make_call(fn, **kw)
                torch.cuda.synchronize()
                calls[name] = (call, [o.clone() for o in outs])
                print(f"  {name}: launches {shape}")
            first = next(iter(calls))  # the shipped source
            want = calls[first][1]
            ways = {"per call": lambda c: cs.cuda_ms(c, 10),
                    "kernel only": lambda c: cs.graph_ms(c, 10)}
            if args.kernel == "k6":
                ways["cold, L2 written"] = lambda c: cs.cold_ms(c, 10, True)
                ways["cold, L2 read"] = lambda c: cs.cold_ms(c, 10, False)
            times = {name: {w: [] for w in ways} for name in calls}
            order = list(calls)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    for w, timer in ways.items():
                        times[name][w].append(timer(calls[name][0]))
            for name, (call, outs) in calls.items():
                mis = sum(int((o != w).sum()) for o, w in zip(outs, want))
                for w in ways:
                    med = float(np.median(times[name][w]))
                    print(f"  {name} {w}: "
                          f"{' '.join(f'{t:.4f}' for t in times[name][w])} "
                          f"ms; median {med:.4f} ms, {med / bound_ms:.2f}x "
                          f"the bound")
                print(f"  {name}: mismatches vs {first} {mis}; "
                      f"{name_power}")
                if mis:
                    raise RuntimeError(f"{name} disagrees with {first}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
