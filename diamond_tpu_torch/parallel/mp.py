"""Multi-process / multi-node blocked search over a shared filesystem.

Reference: src/util/parallel/filestack.h:40-110 (fcntl-locked line stacks),
atomic.h:49-89 (file fetch-add counters), run/double_indexed.cpp:346-430,
577-682 (--multiprocessing: per-(query,ref) block combos claimed from a
TODO stack, intermediate outputs as the checkpoint, --mp-init/--mp-recover,
graceful drain via a stop sentinel).

Every (query block, ref block) combo is an idempotent work unit whose
result is a file; crashed workers leave their WIP entries to be requeued by
--mp-recover, so relaunching a worker resumes the search.  N=1 worker ==
N=k semantics (SURVEY §4).
"""
from __future__ import annotations

import fcntl
import os
import pickle


class FileStack:
    """Line stack on a shared file with POSIX lock protection (reference
    filestack.h)."""

    def __init__(self, path: str):
        self.path = path
        open(path, "a").close()

    def _locked(self, fn):
        with open(self.path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                return fn(f)
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def push(self, line: str):
        def fn(f):
            f.seek(0, 2)
            f.write(line + "\n")
        self._locked(fn)

    def pop(self) -> str | None:
        def fn(f):
            lines = f.read().splitlines()
            if not lines:
                return None
            top = lines[-1]
            f.seek(0)
            f.truncate()
            f.write("".join(l + "\n" for l in lines[:-1]))
            return top
        return self._locked(fn)

    def remove(self, line: str) -> bool:
        def fn(f):
            lines = f.read().splitlines()
            if line not in lines:
                return False
            lines.remove(line)
            f.seek(0)
            f.truncate()
            f.write("".join(l + "\n" for l in lines))
            return True
        return self._locked(fn)

    def lines(self):
        def fn(f):
            return f.read().splitlines()
        return self._locked(fn)


class AtomicCounter:
    """Distributed fetch-add counter on a shared file (reference
    atomic.h:49-89)."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write("0\n")

    def fetch_add(self, n: int = 1) -> int:
        with open(self.path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                v = int(f.read().strip() or 0)
                f.seek(0)
                f.truncate()
                f.write(f"{v + n}\n")
                return v
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def get(self) -> int:
        with open(self.path) as f:
            return int(f.read().strip() or 0)


def _combo_file(tmpdir: str, qi: int, ti: int) -> str:
    return os.path.join(tmpdir, f"combo_{qi}_{ti}.pkl")


def mp_init(tmpdir: str, n_query_blocks: int, n_target_blocks: int):
    """Create the TODO stack of all block combos (reference
    double_indexed.cpp:622-640 mp-init)."""
    os.makedirs(tmpdir, exist_ok=True)
    todo = FileStack(os.path.join(tmpdir, "todo.stack"))
    for qi in range(n_query_blocks):
        for ti in range(n_target_blocks):
            todo.push(f"{qi} {ti}")
    with open(os.path.join(tmpdir, "shape.txt"), "w") as f:
        f.write(f"{n_query_blocks} {n_target_blocks}\n")


def mp_recover(tmpdir: str):
    """Requeue crashed workers' WIP entries (reference
    double_indexed.cpp:581-620 mp-recover)."""
    todo = FileStack(os.path.join(tmpdir, "todo.stack"))
    wip = FileStack(os.path.join(tmpdir, "wip.stack"))
    n = 0
    for line in wip.lines():
        qi, ti = map(int, line.split())
        if not os.path.exists(_combo_file(tmpdir, qi, ti)):
            todo.push(line)
            n += 1
        wip.remove(line)
    return n


def mp_worker(tmpdir: str, run_combo):
    """Claim combos until the TODO stack drains (or a 'stop' sentinel file
    appears; reference :359,745-748).  run_combo(qi, ti) -> picklable
    result, written atomically as the combo's checkpoint."""
    todo = FileStack(os.path.join(tmpdir, "todo.stack"))
    wip = FileStack(os.path.join(tmpdir, "wip.stack"))
    done = 0
    # fault injection for the crash-recovery tests: die (hard) while
    # holding the Nth claimed combo, leaving it on the WIP stack for
    # mp_recover to requeue
    die_after = int(os.environ.get("DIAMOND_TPU_MP_DIE_ON_CLAIM", "0") or 0)
    claims = 0
    while not os.path.exists(os.path.join(tmpdir, "stop")):
        line = todo.pop()
        if line is None:
            break
        wip.push(line)
        claims += 1
        if die_after and claims >= die_after:
            os._exit(17)
        qi, ti = map(int, line.split())
        path = _combo_file(tmpdir, qi, ti)
        if not os.path.exists(path):
            result = run_combo(qi, ti)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(result, f)
            os.replace(tmp, path)
        wip.remove(line)
        done += 1
    return done


def mp_done(tmpdir: str) -> bool:
    """All combos checkpointed?"""
    with open(os.path.join(tmpdir, "shape.txt")) as f:
        nq, nt = map(int, f.read().split())
    return all(os.path.exists(_combo_file(tmpdir, qi, ti))
               for qi in range(nq) for ti in range(nt))


def mp_collect(tmpdir: str):
    """Load every combo's checkpointed result for the final join."""
    with open(os.path.join(tmpdir, "shape.txt")) as f:
        nq, nt = map(int, f.read().split())
    out = {}
    for qi in range(nq):
        for ti in range(nt):
            with open(_combo_file(tmpdir, qi, ti), "rb") as f:
                out[(qi, ti)] = pickle.load(f)
    return out
