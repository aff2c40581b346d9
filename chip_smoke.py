#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diamond_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--queries N] [--seed S]

Phases; each one fails the run on error:
  1. device: the card's name, count, power limit (needs CUDA);
  2. build: the port's CUDA kernels with nvcc for sm_90a (registers and
     spills from ptxas) and the port's native host library;
  3. parity: the banded-SWIPE kernel against its plain PyTorch version on
     the card and the native host DP, on seeded requests covering every
     band class (exact int32, 0 mismatches required);
  4. main path: a default ``blastp -f 6`` self-search of a seeded synthetic
     protein set the size of nr_10k (10,000 sequences, ~4 M letters)
     through diamond_tpu_torch.cli, once with the DP on the card and once
     with DIAMOND_TPU_TORCH_DEVICE_DP=0; the two outputs must be identical
     and every query must find itself;
  5. timing: the kernel, its plain version and the bound on the largest
     DP batch of phase 4 (CUDA events).
The last two lines of standard output are the kernel summary and
{"ok": true, "device": {...}}.  Imports nothing of JAX or diamond_tpu.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

AA = "ARNDCQEGHILKMFPSTWYV"  # order of the BLOSUM62 background frequencies
H100_SMS = 132
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# int32 ops one cell of the recurrence needs (the row-serial form; the
# kernel's lazy-F scan computes the same values with a few more)
OPS_PER_CELL = 12
CELL_OPS_NOTE = ("bias add, H+s, max E, max 0, H-go (shared by E and F), "
                 "F-ge, max for F, max F into H, valid select, best max, "
                 "E-ge, max for E")


def make_proteins(n_seqs: int = 10_000, n_families: int = 2_500,
                  seed: int = 0):
    """Seeded synthetic protein set with planted homologs: family roots of
    log-normal length (median ~300, clipped to 30-3000) drawn from the
    BLOSUM62 background frequencies; every other sequence is a member of a
    random family at 40-95 % identity with a few short indels.  Returns
    [(id, sequence)] in shuffled order."""
    from diamond_tpu_torch.constants._matrix_data import MATRICES

    rng = np.random.default_rng(seed)
    bg = np.asarray(MATRICES["BLOSUM62"]["background_freqs"], np.float64)
    bg /= bg.sum()
    letters = np.frombuffer(AA.encode(), np.uint8)

    def draw(n):
        return letters[rng.choice(20, size=n, p=bg)]

    lens = np.clip(np.rint(rng.lognormal(np.log(300), 0.7, n_families)),
                   30, 3000).astype(int)
    roots = [draw(n) for n in lens]
    seqs = []
    for k in range(n_seqs):
        fam = k if k < n_families else int(rng.integers(n_families))
        s = roots[fam]
        if k >= n_families:
            ident = rng.uniform(0.40, 0.95)
            s = s.copy()
            sub = rng.random(len(s)) > ident
            s[sub] = draw(int(sub.sum()))
            for _ in range(int(rng.poisson(2))):
                pos = int(rng.integers(len(s)))
                ln = int(rng.integers(1, 6))
                if rng.random() < 0.5:
                    s = np.concatenate([s[:pos], draw(ln), s[pos:]])
                elif len(s) - ln >= 30:
                    s = np.concatenate([s[:pos], s[pos + ln:]])
        seqs.append((f"syn{k:05d}_fam{fam:04d}", s.tobytes().decode()))
    perm = rng.permutation(n_seqs)
    return [seqs[i] for i in perm]


def write_fasta(path, recs):
    with open(path, "w") as f:
        for name, s in recs:
            f.write(f">{name}\n{s}\n")


def dp_requests(seed: int, n_queries: int):
    """Seeded DeviceDP requests in every band class up to 512, targets up to
    ~4000 letters: bias on every other query, d0 < 0, band 1, targets
    shorter than the band, and jobs with no cell in the query."""
    rng = np.random.default_rng(seed)
    reqs = []
    bands = (1, 17, 32, 33, 64, 100, 128, 200, 256, 300, 512)
    for r in range(n_queries):
        qlen = int(rng.integers(20, 4000))
        q = rng.integers(0, 20, qlen).astype(np.int8)
        bias = rng.integers(-4, 5, qlen).astype(np.int32) if r % 2 else None
        jobs = []
        for k in range(int(rng.integers(6, 30))):
            tl = int(rng.integers(5, 4000))
            t = rng.integers(0, 20, tl).astype(np.int8)
            n = max(min(qlen - 1, tl - 2, 40), 0)
            t[2:2 + n] = q[1:1 + n]
            band = bands[k % len(bands)]
            d0 = int(rng.integers(-tl, qlen))
            jobs.append((t, d0, d0 + band))
        jobs.append((t[:7], -3, 60))       # target shorter than the band
        jobs.append((t[:5], -50, -40))     # no cell in the query
        reqs.append((q, bias, jobs))
    return reqs


def band_cells(t_len, q_len, d0, band):
    """Exact in-query band cells per job (the work the DP needs)."""
    cells = np.zeros(len(t_len), np.int64)
    for r in range(int(band.max()) if len(band) else 0):
        d = d0 + r
        n = np.minimum(t_len, q_len - d) - np.maximum(0, -d)
        cells += np.where(r < band, np.maximum(n, 0), 0)
    return cells


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase(name):
    print(f"== {name}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=10_000,
                    help="queries of the self-search (the DB stays 10,000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    # -- 1. device ----------------------------------------------------------
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    name_power = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; max SM clock {sm_clock_mhz:.0f} MHz")
    print(name_power)

    # profiler counters (jobs and cells per DP route) must be on before
    # the port's log module is imported
    os.environ["DIAMOND_TPU_PROF"] = "1"
    from diamond_tpu_torch import native
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import _cuda
    from diamond_tpu_torch.ops import swipe_device as sd
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
    from diamond_tpu_torch.utils import log as plog

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    _cuda.build(["banded_swipe"])
    print(f"nvcc banded_swipe.cu: {time.perf_counter() - t0:.2f} s")
    for line in _cuda.build_log.get("banded_swipe", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    sd._k1()
    t0 = time.perf_counter()
    if native.lib() is None:
        raise RuntimeError("the port's native host library did not build/load")
    print(f"native host library: {time.perf_counter() - t0:.2f} s")

    # -- 3. parity ----------------------------------------------------------
    phase("kernel parity")
    m = ScoreMatrix("BLOSUM62")
    dp = sd.DeviceDP(m.matrix32, m.gap_open, m.gap_extend, device="cuda")
    reqs = dp_requests(args.seed + 1, 48)
    p = sd.pack_requests(reqs, "cuda")
    got = dp.launch(p)
    want = dp.launch(p, kernel=sd.banded_swipe_multi_plain)
    torch.cuda.synchronize()
    raw_mis = int(sum((g != w).sum().item() for g, w in zip(got, want)))
    max_abs_err = max(int((g.long() - w.long()).abs().max().item())
                      for g, w in zip(got, want))
    host_mis = 0
    for (q, bias, jobs), res in zip(reqs, dp.run_many(reqs)):
        ref = banded_swipe_batch_np(q, bias, jobs, m.matrix32, m.gap_open,
                                    m.gap_extend)
        host_mis += sum(a != b for a, b in zip(res, ref))
    classes = [R * 32 for R, _, _ in p.classes]
    print(f"parity: {p.n_jobs} jobs, band classes {classes}, "
          f"kernel vs plain mismatches {raw_mis}, kernel vs host DP "
          f"mismatches {host_mis}")
    if raw_mis or host_mis:
        raise RuntimeError("kernel disagrees with its references")

    # -- 4. main path -------------------------------------------------------
    phase("main path: blastp self-search")
    captured = {"n": -1, "reqs": None}
    run_many, launch = sd.DeviceDP.run_many, sd.DeviceDP.launch
    events = []  # CUDA events around every DeviceDP launch of the run

    def spy(self, requests):
        n = sum(len(j) for _, _, j in requests)
        if n > captured["n"]:
            captured.update(n=n, reqs=requests)
        return run_many(self, requests)

    def timed_launch(self, p, kernel=sd.banded_swipe_multi):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = launch(self, p, kernel)
        ev[1].record()
        events.append(ev)
        return out

    recs = make_proteins(seed=args.seed)
    n_letters = sum(len(s) for _, s in recs)
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "db.faa")
        qf = os.path.join(tmp, "q.faa")
        write_fasta(db, recs)
        n_q = min(args.queries, len(recs))
        write_fasta(qf, recs[:n_q])
        if n_q < len(recs):
            print(f"query count cut to {n_q} of {len(recs)} (DB kept whole)")
        print(f"synthetic set: {len(recs)} sequences, {n_letters} letters, "
              f"seed {args.seed}")
        runs = {}
        for route in ("card", "host"):
            if route == "card":  # the default route
                os.environ.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
            else:
                os.environ["DIAMOND_TPU_TORCH_DEVICE_DP"] = "0"
            out = os.path.join(tmp, f"out_{route}.tsv")
            sd.reset_dispatch_stats()
            sd.banded_swipe_multi.launches = 0
            plog.prof_calls.clear()
            plog.prof.clear()
            torch.cuda.reset_peak_memory_stats()
            events.clear()
            sd.DeviceDP.run_many, sd.DeviceDP.launch = spy, timed_launch
            try:
                t0 = time.perf_counter()
                rc = cli_main(["blastp", "-q", qf, "-d", db, "-f", "6",
                               "-o", out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                sd.DeviceDP.run_many, sd.DeviceDP.launch = run_many, launch
            if rc:
                raise RuntimeError(f"blastp exited {rc}")
            data = open(out, "rb").read()
            lines = data.decode().splitlines()
            runs[route] = dict(
                wall_s=wall, lines=len(lines),
                sha=hashlib.sha256(data).hexdigest()[:16],
                k1_launches=sd.banded_swipe_multi.launches,
                device_jobs=plog.prof_calls.get("ext.device_jobs", 0),
                device_cells=plog.prof_calls.get("ext.device_cells", 0),
                host_score_jobs=plog.prof_calls.get("ext.score_jobs", 0),
                host_score_cells=plog.prof_calls.get("ext.score_cells", 0),
                host_tb_jobs=plog.prof_calls.get("ext.tb_jobs", 0),
                host_tb_cells=plog.prof_calls.get("ext.tb_cells", 0),
                device_wait_s=sd.dispatch_wait_s,
                device_busy_s=sum(a.elapsed_time(b) for a, b in events) / 1e3,
                max_memory_allocated=torch.cuda.max_memory_allocated())
            phases = sorted(plog.prof.items(), key=lambda kv: -kv[1])[:12]
            selfs = {ln.split("\t")[0] for ln in lines
                     if ln.split("\t")[0] == ln.split("\t")[1]}
            print(f"{route}: " + json.dumps(runs[route]))
            print(f"{route} host phases (s): "
                  + json.dumps({k: round(v, 3) for k, v in phases}))
            print(f"{route}: {len(lines)} lines, sha {runs[route]['sha']}, "
                  f"{wall:.2f} s, {n_q / wall:.1f} queries/s on {kind} "
                  f"({name_power}); self hits {len(selfs)}/{n_q}; device "
                  f"busy {runs[route]['device_busy_s']:.4f} s, idle share "
                  f"{1 - runs[route]['device_busy_s'] / wall:.4f}")
            if len(selfs) != n_q:
                raise RuntimeError("a query did not find itself")
        os.environ.pop("DIAMOND_TPU_TORCH_DEVICE_DP", None)
    card, host = runs["card"], runs["host"]
    if card["sha"] != host["sha"] or card["lines"] != host["lines"]:
        raise RuntimeError("card-DP and host-DP outputs differ")
    if card["k1_launches"] == 0:
        raise RuntimeError("the main path never launched the kernel")
    print(f"outputs identical: {card['lines']} lines, sha {card['sha']}; "
          f"kernel launches {card['k1_launches']}")

    # -- 5. timing ----------------------------------------------------------
    phase("kernel timing at main-path shapes")
    big = captured["reqs"]
    p = sd.pack_requests(big, "cuda")

    def per_class(fn):  # one call per band class, as DeviceDP.launch makes
        return [fn(p.t_cat, p.q_cat, p.bias_cat, p.jobs[lo:hi], p.reqs,
                   dp._m32, dp.go, dp.ge, R) for R, lo, hi in p.classes]

    kern = lambda: per_class(sd.banded_swipe_multi)  # noqa: E731
    plain = lambda: per_class(sd.banded_swipe_multi_plain)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max().item())
              for gc, wc in zip(got, want) for g, w in zip(gc, wc))
    max_abs_err = max(max_abs_err, err)
    if err:
        raise RuntimeError("kernel disagrees with its plain version on the "
                           "main-path batch")
    kern()
    ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(plain, 2)
    jobs = p.jobs.cpu().numpy().astype(np.int64)
    reqs_np = p.reqs.cpu().numpy().astype(np.int64)
    cells = int(band_cells(jobs[:, 1], reqs_np[jobs[:, 4], 1], jobs[:, 2],
                           jobs[:, 3]).sum())
    n_bytes = (p.t_cat.numel() + p.q_cat.numel() + p.bias_cat.numel()
               + 4 * (p.jobs.numel() + p.reqs.numel() + 32 * 32)
               + 3 * 4 * p.n_jobs)
    ops_s = cells * OPS_PER_CELL / (H100_SMS * INT32_LANES_PER_SM
                                    * sm_clock_mhz * 1e6)
    bytes_s = n_bytes / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    print(f"batch: {p.n_jobs} jobs in {len(big)} requests, classes "
          f"{[(R * 32, hi - lo) for R, lo, hi in p.classes]}, {cells} band "
          f"cells, {n_bytes} bytes; {OPS_PER_CELL} int32 ops/cell "
          f"({CELL_OPS_NOTE})")
    print(f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {cells} cells x {OPS_PER_CELL} / "
          f"({H100_SMS} SMs x {INT32_LANES_PER_SM} lanes x "
          f"{sm_clock_mhz:.0f} MHz)), library_ms null; {kind}, "
          f"{name_power}")

    print(json.dumps({"kernels": [{
        "name": "banded_swipe_multi",
        "route": "cuda",
        "source": "diamond_tpu_torch/csrc/banded_swipe.cu",
        "replaces": "diamond_tpu/ops/swipe_device.py:229 "
                    "(banded_swipe_pallas_multi)",
        "launches": card["k1_launches"],
        "mismatches": raw_mis + host_mis,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
