"""diamond_tpu_torch: the PyTorch/CUDA port of the diamond_tpu search engine.

Package import applies two process-wide allocator tunings that the
pipeline's numpy phases depend on (measured on the dev host, where they
are worth >50x on seeding wall time):

- ``prctl(PR_SET_THP_DISABLE)``: with ``transparent_hugepage=madvise`` +
  ``defrag=madvise``, glibc madvises its large heap regions HUGEPAGE and
  every page fault then performs synchronous 2MB huge-page allocation
  with direct compaction (~3ms/fault under memory pressure; ~7s kernel
  time per 60MB seed array).  Disabling THP for this process makes the
  same faults ~2us.  Set ``DIAMOND_TPU_THP=1`` to keep THP.
- ``mallopt(M_MMAP_THRESHOLD, 1GB)`` + ``M_TRIM_THRESHOLD 64MB``: large
  numpy temporaries otherwise each get a fresh ``mmap`` and are
  ``munmap``-ed on free, so every multi-MB array re-faults its pages;
  serving them from the brk heap lets freed pages be reused warm.
"""
import ctypes
import os


def _tune_allocator() -> None:
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:  # non-glibc platform: nothing to tune
        return
    if os.environ.get("DIAMOND_TPU_THP") != "1":
        PR_SET_THP_DISABLE = 41
        try:
            libc.prctl(PR_SET_THP_DISABLE, 1, 0, 0, 0)
        except Exception:
            pass
    try:
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 64 << 20)
    except Exception:
        pass


_tune_allocator()
