#!/usr/bin/env python3
"""Time variants of the 3-frame kernel (csrc/swipe3.cu, K3) on one CUDA card.

    python3 chip_k3_lazy.py [--parent OLD_SWIPE3_CU] [--reads N] [--seed S]

Runs ``blastx --long-reads`` of chip_smoke.py's seeded reads against its
seeded protein set (the port on the card) and captures the 3-frame
batches the run sends to the kernel.  On the largest batch (a window of
reads) and on its largest one-read batch it then times, in turns (A B C D
D C B A), variants of the kernel built from the source with nvcc:

  shipped  the kernel as it is: one carry of the vertical gap from the
           previous lane, then a warp scan when any lane's gap rose;
  scan     the warp scan on every column;
  repeat   the one-lane carry repeated until no lane's gap rises;
  parent   a given older source (``--parent``), if any.

Every variant must give the shipped kernel's outputs.  Prints the card's
name and power limit, each time, its ratio to the bound (15 int32
operations per cell over 132 SMs x 64 lanes at the card's maximum SM
clock) and the time per column of the batch's longest job.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

SCAN_IF = "if (__any_sync(FULL, rise)) {  // inclusive max-plus scan over lanes"
REPEAT = """while (__any_sync(FULL, rise)) {  // carry again until no lane rises
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        f_in[f] = __shfl_up_sync(FULL, fo[f], 1);
        if (lane == 0) f_in[f] = 0;
      }
      rise = false;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int nf = __viaddmax_s32(f_in[f], -kge, fo[f]);
        rise |= nf != fo[f];
        fo[f] = nf;
      }
    }
    if (false) {"""


def variants(src: str, parent: str | None):
    if SCAN_IF not in src:
        raise RuntimeError("csrc/swipe3.cu no longer has the lazy-F vote")
    out = {"shipped": src,
           "scan": src.replace(SCAN_IF, "if (true) {"),
           "repeat": src.replace(SCAN_IF, REPEAT)}
    if parent:
        with open(parent) as f:
            out["parent"] = f.read()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older csrc/swipe3.cu to time beside")
    ap.add_argument("--reads", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_k3_lazy: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diamond_tpu_torch.cli import main as cli_main
    from diamond_tpu_torch.ops import _cuda
    from diamond_tpu_torch.ops import swipe3_device as s3
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    print(cs.smi("name,power.limit"))
    clock_mhz = float(cs.smi("clocks.max.sm").split()[0])
    with open(os.path.join(_cuda.CSRC_DIR, "swipe3.cu")) as f:
        srcs = variants(f.read(), args.parent)
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, src in srcs.items():  # one nvcc per variant, all at once
            cu = os.path.join(tmp, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(src)
            procs[name] = subprocess.Popen(
                [_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-o",
                 os.path.join(tmp, f"lib{name}.so"), cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            fn = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")) \
                .banded_swipe3_launch
            fn.argtypes = [ctypes.c_void_p if a == "p" else ctypes.c_int
                           for a in "ipppppiiiippp"]
            fn.restype = ctypes.c_int
            fns[name] = fn

        batches = []
        scores = s3.swipe3_scores

        def spy(strands, jobs, *a, **kw):
            batches.append((strands, jobs))
            return scores(strands, jobs, *a, **kw)

        recs = cs.make_proteins(seed=args.seed)
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

    m = ScoreMatrix("BLOSUM62")
    go, ge, fs = m.gap_open + m.gap_extend, m.gap_extend, 15
    m32 = torch.from_numpy(m.matrix32.astype(np.int32)).cuda()
    strands, jobs = max(batches, key=lambda b: len(b[1]))
    read_of = np.array([s // 2 for s, _, _, _ in jobs])
    work = np.array([len(t) * (d1 - d0) for _, t, d0, d1 in jobs])
    r1 = int(np.argmax(np.bincount(read_of, weights=work)))
    one = [(s - 2 * r1, t, d0, d1) for s, t, d0, d1 in jobs if s // 2 == r1]
    order = [n for n in ("parent", "shipped", "scan", "repeat")
             if n in fns]
    for label, st, jb in (("window", strands, jobs),
                          ("one read", strands[2 * r1: 2 * r1 + 2], one)):
        pk = s3.pack_swipe3(st, jb)
        K = np.array([s3.offsets_per_lane(int(b)) for b in pk["jobs"][:, 3]])
        perm = np.lexsort((-pk["jobs"][:, 1].astype(np.int64), K))
        x = {k: torch.from_numpy(v).cuda() for k, v in pk.items()}
        sel = [(int(k), torch.from_numpy(np.ascontiguousarray(
            pk["jobs"][perm][K[perm] == k])).cuda()) for k in np.unique(K)]
        outs = {k: [torch.empty(j.shape[0], dtype=torch.int32, device="cuda")
                    for _ in range(2)] for k, j in sel}

        def call(fn):
            for k, j in sel:
                err = fn(k, x["t_cat"].data_ptr(), x["q_cat"].data_ptr(),
                         j.data_ptr(), x["reqs"].data_ptr(), m32.data_ptr(),
                         j.shape[0], go, ge, fs, outs[k][0].data_ptr(),
                         outs[k][1].data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

        def result(fn):
            call(fn)
            return [o.clone() for k, _ in sel for o in outs[k]]

        want = result(fns["shipped"])
        cells = int(cs.swipe3_cells(pk["jobs"], pk["reqs"]).sum())
        bound_ms = cells * 15 / (cs.H100_SMS * cs.INT32_LANES_PER_SM
                                 * clock_mhz * 1e6) * 1e3
        cols = int(pk["jobs"][:, 1].max())
        print(f"{label}: {len(jb)} jobs, band classes "
              f"{[(32 * k, j.shape[0]) for k, j in sel]}, {cells} cells, "
              f"bound {bound_ms:.5f} ms, longest job {cols} columns")
        for name in order + order[::-1]:
            got = result(fns[name])
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} disagrees with the shipped kernel")
            ms = cs.cuda_ms(lambda: call(fns[name]), 20)
            print(f"  {name}: {ms:.4f} ms, {ms / bound_ms:.1f}x the bound, "
                  f"{ms * 1e3 / cols:.3f} us per column of the longest job")
    return 0


if __name__ == "__main__":
    sys.exit(main())
