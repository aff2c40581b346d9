"""Out-of-core, multi-worker cascaded clustering.

Re-design of the reference multinode clustering (reference
src/cluster/multinode/multinode.cpp:186-289, len_sort.cpp:45-65,
volume.h:30-154) on the framework's shared-filesystem primitives
(parallel/mp.py — the reference's Atomic/FileStack model):

- `len_sort` globally length-sorts the input into letter-capped FASTA
  volumes with a manifest, so no round ever needs the whole input in
  memory (the reference's VolumedFile).
- every round enumerates block combos (r, i<=r) as a crash-recoverable
  TODO/WIP stack; workers claim combos, search volume r (queries/members)
  against volume i (targets/representative candidates), and checkpoint
  the accepted edges per combo.
- one worker runs greedy vertex cover over the concatenated edges and
  composes the global assignment with a vectorized remap; everyone else
  awaits the round marker.  Re-running a crashed worker resumes the
  round (combo checkpoints + stacks are the state).

N=1 worker produces byte-identical clusters to N=k workers: edges are
consumed in combo order regardless of who computed them
(tests/test_multinode.py pins this, plus crash recovery and the
streaming-len_sort RSS bound).

Output contract: volume blocking makes borderline assignments differ
from the in-memory cascade (`linclust` without --multiprocessing) — the
same block-decomposition dependence the reference has.  The canonical
single-machine result is the in-memory cascade (byte-identical to the
reference binary, tests/test_linclust.py); this path's contract is
worker-count invariance + crash recovery + bounded memory.
"""
from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np

from diamond_tpu_torch.cluster.gvc import EdgeGraph, greedy_vertex_cover
from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.parallel.mp import AtomicCounter, mp_worker


class VolumedFile:
    """Length-sorted FASTA volumes with a manifest (reference
    volume.h:30-154)."""

    def __init__(self, manifest_path: str):
        self.manifest_path = manifest_path
        with open(manifest_path) as f:
            d = json.load(f)
        self.volumes = d["volumes"]  # [{path, oid_begin, oid_end, letters}]
        self.n_records = d["n_records"]
        self.ids = d["ids"]          # OID -> seqid (length-sorted order)

    @staticmethod
    def create_streaming(reader_fn, tmpdir: str, max_letters: int,
                         name: str = "volumes") -> "VolumedFile":
        """Streaming len_sort (reference len_sort.cpp:45-112): the input
        is never fully resident.  Pass 1 spools sequences to a flat temp
        store recording (seqid, offset, length); pass 2 writes the
        length-sorted volumes by seeking into the spool.  Memory is
        O(records) small tuples, not letters."""
        os.makedirs(tmpdir, exist_ok=True)
        spool = os.path.join(tmpdir, f"{name}_spool.tmp{os.getpid()}")
        meta = []  # (seqid, offset, length)
        with open(spool, "w") as f:
            for sid, seq in reader_fn():
                s = seq.decode() if isinstance(seq, bytes) else str(seq)
                meta.append((sid, f.tell(), len(s)))
                f.write(s)
        order = sorted(range(len(meta)), key=lambda i: (-meta[i][2], i))
        vols = []
        ids = []
        vi = 0
        out = None
        letters = 0
        begin = 0
        oid = 0
        with open(spool) as src:
            for k in order:
                sid, off, ln = meta[k]
                if out is None or (letters + ln > max_letters
                                   and letters > 0):
                    if out is not None:
                        out.close()
                        vols.append({"path": path, "oid_begin": begin,
                                     "oid_end": oid, "letters": letters})
                    path = os.path.join(tmpdir, f"{name}_{vi}.faa")
                    out = open(path, "w")
                    vi += 1
                    letters = 0
                    begin = oid
                src.seek(off)
                out.write(f">{sid}\n{src.read(ln)}\n")
                ids.append(sid)
                letters += ln
                oid += 1
        if out is not None:
            out.close()
            vols.append({"path": path, "oid_begin": begin, "oid_end": oid,
                         "letters": letters})
        os.unlink(spool)
        manifest = os.path.join(tmpdir, f"{name}.json")
        tmp = manifest + f".tmp{os.getpid()}"
        with open(tmp, "w") as fm:
            json.dump({"volumes": vols, "n_records": oid, "ids": ids}, fm)
        os.replace(tmp, manifest)
        return VolumedFile(manifest)

    def load_block(self, vi: int) -> Block:
        from diamond_tpu_torch.data.fasta import read_fasta

        v = self.volumes[vi]
        recs = list(read_fasta(v["path"]))
        return Block.from_sequences([r[1].upper() for r in recs],
                                    [r[0] for r in recs])

    def read_records(self, oids):
        """Yield (seqid, seq_str) for the given SORTED global oids by
        scanning volumes sequentially (no full-input materialization)."""
        from diamond_tpu_torch.data.fasta import read_fasta

        it = iter(oids)
        want = next(it, None)
        for v in self.volumes:
            if want is None:
                return
            if want >= v["oid_end"]:
                continue
            for k, (sid, seq) in enumerate(read_fasta(v["path"])):
                if want is None:
                    break
                if v["oid_begin"] + k == want:
                    yield sid, (seq.decode() if isinstance(seq, bytes)
                                else seq)
                    want = next(it, None)


def _await(path: str, poll: float = 0.3):
    while not os.path.exists(path):
        time.sleep(poll)


def _combo_edges(vols: VolumedFile, r: int, i: int, step: str,
                 matrix_name: str, member_cover: float, approx_id: float,
                 mutual_cover):
    """Search volume r (queries) vs volume i (targets); returns accepted
    edges [(rep_oid, member_oid, weight)] with the same cover/approx-id
    admission as the in-memory cascade (cluster/workflow._round_edges)."""
    from diamond_tpu_torch.search.config import SearchConfig
    from diamond_tpu_torch.search.pipeline import Pipeline
    from diamond_tpu_torch.stats.score_matrix import ScoreMatrix

    qb = vols.load_block(r)
    tb = qb if i == r else vols.load_block(i)
    lin = step.endswith("_lin")
    sens = step[:-4] if lin else step
    cfg = SearchConfig(matrix=ScoreMatrix(matrix_name), sensitivity=sens,
                       max_target_seqs=2 ** 31 - 1,
                       lin_stage1_target=lin,
                       self_search=(i == r))
    pipe = Pipeline(cfg, qb, tb)
    results = pipe.search()
    q_base = vols.volumes[r]["oid_begin"]
    t_base = vols.volumes[i]["oid_begin"]
    edges = []
    for qid in sorted(results):
        qlen = int(qb.lengths[qid])
        for m in results[qid]:
            t = m.target_block_id
            if i == r and t == qid:
                continue
            for h in m.hsp:
                qcov = (h.query_range[1] - h.query_range[0]) * 100.0 / qlen
                tlen = int(tb.lengths[t])
                scov = (h.subject_range[1] - h.subject_range[0]) \
                    * 100.0 / tlen
                if approx_id > 0 and h.length and \
                        h.identities * 100.0 / h.length < approx_id:
                    continue
                q_oid = q_base + qid
                t_oid = t_base + t
                if mutual_cover is not None:
                    if qcov >= mutual_cover and scov >= mutual_cover:
                        edges.append((t_oid, q_oid, h.bit_score))
                        edges.append((q_oid, t_oid, h.bit_score))
                    continue
                if qcov >= member_cover:
                    edges.append((t_oid, q_oid, h.bit_score))
                if scov >= member_cover:
                    edges.append((q_oid, t_oid, h.bit_score))
    return edges


def multinode_cluster(records, out_path: str, steps, tmpdir: str,
                      max_letters: int = 50_000_000,
                      matrix_name: str = "BLOSUM62",
                      member_cover: float = 80.0, approx_id: float = 0.0,
                      mutual_cover=None, reps_out=None, verbose=False,
                      recover: bool = False):
    """Run (or join) an out-of-core multi-worker clustering job.

    Every invocation is one worker; concurrent invocations with the same
    tmpdir share the work.  records: either a [(seqid, seq)] list, or a
    zero-arg callable returning a fresh (seqid, seq) iterator — with a
    callable the input is NEVER fully resident (streaming len_sort;
    later rounds re-read representative sequences from the volumes).
    recover=True requeues crashed workers' WIP combos (--mp-recover)."""
    reader = records if callable(records) else (lambda: iter(records))
    os.makedirs(tmpdir, exist_ok=True)
    worker_id = AtomicCounter(os.path.join(tmpdir, "workers")).fetch_add()
    root_manifest = os.path.join(tmpdir, "volumes.json")
    if worker_id == 0 and not os.path.exists(root_manifest):
        VolumedFile.create_streaming(reader, tmpdir, max_letters)
        with open(os.path.join(tmpdir, "volumes_ready"), "w"):
            pass
    _await(os.path.join(tmpdir, "volumes_ready"))
    vols = VolumedFile(root_manifest)
    n = vols.n_records

    cur_manifest = root_manifest
    root_oid = {sid.split()[0]: o for o, sid in enumerate(vols.ids)}
    last_done = None
    for rnd, step in enumerate(steps):
        cur = VolumedFile(cur_manifest)
        if cur.n_records <= 1:
            break
        rdir = os.path.join(tmpdir, f"round_{rnd}")
        os.makedirs(rdir, exist_ok=True)
        init_lock = AtomicCounter(os.path.join(rdir, "init_lock"))
        if init_lock.fetch_add() == 0 and \
                not os.path.exists(os.path.join(rdir, "init_done")):
            nv = len(cur.volumes)
            combos = [(r, i) for r in range(nv) for i in range(r + 1)]
            from diamond_tpu_torch.parallel.mp import FileStack

            todo = FileStack(os.path.join(rdir, "todo.stack"))
            for r, i in combos:
                todo.push(f"{r} {i}")
            with open(os.path.join(rdir, "shape.json"), "w") as f:
                json.dump(combos, f)
            with open(os.path.join(rdir, "init_done"), "w"):
                pass
        _await(os.path.join(rdir, "init_done"))

        def run_combo(r, i, _cur=cur, _step=step):
            return _combo_edges(_cur, r, i, _step, matrix_name,
                                member_cover, approx_id, mutual_cover)

        if recover:
            from diamond_tpu_torch.parallel.mp import mp_recover

            mp_recover(rdir)
        mp_worker(rdir, run_combo)
        with open(os.path.join(rdir, "shape.json")) as f:
            combos = [tuple(c) for c in json.load(f)]
        while not all(os.path.exists(os.path.join(rdir,
                                                  f"combo_{r}_{i}.pkl"))
                      for r, i in combos):
            time.sleep(0.3)
        gvc_lock = AtomicCounter(os.path.join(rdir, "gvc_lock"))
        if gvc_lock.fetch_add() == 0 and \
                not os.path.exists(os.path.join(rdir, "round_done")):
            # manifest-local node indices; map to global input OIDs for
            # the assignment composition
            to_global = np.asarray(
                [root_oid[s.split()[0]] for s in cur.ids], dtype=np.int64)
            # edge table above the memory cap spills sorted runs to disk
            # (reference external_sort.h; the merged order is identical
            # to sorted(list))
            from diamond_tpu_torch.utils.external_sort import (EDGE_DTYPE,
                                                         ExternalSorter)

            cap_mb = int(os.environ.get("DIAMOND_TPU_SORT_MEM_MB", "512"))
            edges = ExternalSorter(EDGE_DTYPE, cap_mb << 20, tmpdir=rdir)
            for r, i in combos:
                with open(os.path.join(rdir, f"combo_{r}_{i}.pkl"),
                          "rb") as f:
                    batch = pickle.load(f)
                if batch:
                    edges.push(np.array(batch, dtype=EDGE_DTYPE))
            g = EdgeGraph(cur.n_records, edges)
            local = greedy_vertex_cover(g)
            assign = _load_assignment(tmpdir, rnd, n)
            remap = np.arange(n, dtype=np.int64)
            new_reps = []
            for li, rep_li in enumerate(local):
                remap[to_global[li]] = to_global[rep_li]
                if rep_li == li:
                    new_reps.append(int(to_global[li]))
            assign = remap[assign]
            np.save(os.path.join(rdir, "assignment.npy"), assign)
            np.save(os.path.join(rdir, "reps.npy"),
                    np.asarray(sorted(new_reps), dtype=np.int64))
            if rnd + 1 < len(steps) and len(new_reps) > 1:
                # representative sequences come back out of the root
                # volumes (sequential scan) — the input list is not held
                rep_oids = sorted(new_reps)
                VolumedFile.create_streaming(
                    lambda: vols.read_records(rep_oids), rdir, max_letters,
                    name="reps")
            with open(os.path.join(rdir, "round_done"), "w"):
                pass
        _await(os.path.join(rdir, "round_done"))
        last_done = rdir
        nxt = os.path.join(rdir, "reps.json")
        if not os.path.exists(nxt):
            break
        cur_manifest = nxt
    # final output (one worker writes; content deterministic)
    final = last_done or _final_round_dir(tmpdir, len(steps))
    assign = np.load(os.path.join(final, "assignment.npy"))
    ids = vols.ids
    done_path = os.path.join(tmpdir, "output_done")
    out_lock = AtomicCounter(os.path.join(tmpdir, "out_lock"))
    if out_lock.fetch_add() == 0 and not os.path.exists(done_path):
        oid_of = {sid.split()[0]: o for o, sid in enumerate(ids)}
        with open(out_path + ".tmp", "w") as f:
            for sid, _seq in reader():
                o = oid_of[sid.split()[0]]
                rep = ids[int(assign[o])].split()[0]
                f.write(f"{rep}\t{sid.split()[0]}\n")
        os.replace(out_path + ".tmp", out_path)
        if reps_out:
            rep_ids = {ids[int(c)].split()[0]
                       for c in np.unique(assign)}
            with open(reps_out, "w") as f:
                for sid, seq in reader():
                    if sid.split()[0] in rep_ids:
                        s2 = seq.decode() if isinstance(seq, bytes) \
                            else str(seq)
                        f.write(f">{sid.split()[0]}\n{s2}\n")
        with open(done_path, "w"):
            pass
    _await(done_path)
    return assign, ids


def _load_assignment(tmpdir: str, rnd: int, n: int):
    if rnd == 0:
        return np.arange(n, dtype=np.int64)
    return np.load(os.path.join(tmpdir, f"round_{rnd - 1}",
                                "assignment.npy"))


def _final_round_dir(tmpdir: str, n_steps: int) -> str:
    last = None
    for rnd in range(n_steps):
        d = os.path.join(tmpdir, f"round_{rnd}")
        if os.path.exists(os.path.join(d, "round_done")):
            last = d
    return last
