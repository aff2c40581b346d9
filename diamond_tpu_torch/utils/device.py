"""Where the port's work runs: the whole routing policy.

Three switches decide it, and this module alone reads them:

  DIAMOND_TPU_TORCH_DEVICE       ``cuda`` (the default) or ``cpu``: the
                                 device of every route below
                                 (``resolve_device``).  On the CPU the
                                 kernels' plain PyTorch versions run.
                                 Nothing falls back quietly: without a card
                                 and without ``cpu``, ``resolve_device``
                                 raises ``NoDeviceError``.
  DIAMOND_TPU_TORCH_DEVICE_DP=0  the DP of K1, D4, K2 and K3 on host C++
                                 (``device_dp_enabled``): the route the
                                 tests hold the device against.  Unset or
                                 any other value: on the device.
  DIAMOND_TPU_TORCH_STAGE12=1    stage 1/2 seeding (D1) on the device
                                 (``stage12_device_enabled``); 0 or unset:
                                 the fused host C++ pass, the default, as
                                 in diamond_tpu.

Every route under a search asks ``resolve_device()`` for its device, so a
search stays on one device.  Only the kernel wrappers take an explicit
``device=`` (their tests pass the CPU through it).

Where each device route is taken, and what fits it (the rest runs on the
host, with the same output):

  D5  tantan masking of the query and target blocks
      (search/pipeline._mask_block, ops/tantan_device): every block.
  D6  the query-indexed route's DB-side seed enumeration
      (Pipeline._enumerate_t_qindex, ops/seed_enum_device): target blocks
      of ``seed_enum_device.MIN_LETTERS`` letters or more, an int8
      reduction table, no ``--freq-masking``.
  D1  the stage 1/2 seed join (Pipeline._stage12_device,
      ops/stage12_device): with DIAMOND_TPU_TORCH_STAGE12=1, every seed
      group.
  K1  the extension's score-only rounds (align/wave.py,
      ops/swipe_device.DeviceDP): standard-matrix jobs whose padded band
      is within ``swipe_device.MAX_DEVICE_BAND`` (512)
      (``swipe_device.job_fits_device``).
  D4  the extension's traceback round (align/wave._tb_multi,
      ops/traceback_device): the jobs K1 would take, without ``--mesh``.
  K2  ``blastp --swipe`` (align/swipe_all.py, swipe_device.FullSweep):
      queries within ``FullSweep.MAX_ROW_LEN`` against targets within
      ``FullSweep.MAX_LEN``.
  K3  ``blastx -F``'s score-only round (align/frameshift.py,
      ops/swipe3_device): reads whose every band is within
      ``swipe3_device.MAX_BAND``.
  D3  MCL's dense step (cluster/mcl.py): components of
      ``mcl.JAX_MIN_COMPONENT`` nodes or more.
  K4  ``--swipe --mesh``'s sharded scoring (parallel/sharded.py) and the
      ``benchmark`` command.

D5, D6, D1, D3 and K4 follow the device but not the DP switch.

Multi-process search (``init_distributed``) takes ``--coordinator/
--num-procs/--proc-id`` or, in their place, the counterparts of diamond_tpu's
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID:

  DIAMOND_TPU_TORCH_COORDINATOR_ADDRESS  host:port of rank 0's rendezvous
  DIAMOND_TPU_TORCH_NUM_PROCESSES        the world size
  DIAMOND_TPU_TORCH_PROCESS_ID           this process's rank
  DIAMOND_TPU_TORCH_DIST_TIMEOUT         seconds to wait for the world to
                                         form (default 300), then raise
"""
from __future__ import annotations

import os
import sys


class NoDeviceError(RuntimeError):
    """A CUDA device was required (the default) and none is available."""


def resolve_device(device: str | None = None) -> str:
    """The torch device an entry point runs on: ``device`` if given, else
    DIAMOND_TPU_TORCH_DEVICE, else ``cuda``.  ``cuda`` without a card
    raises."""
    d = device or os.environ.get("DIAMOND_TPU_TORCH_DEVICE") or "cuda"
    if d == "cpu":
        return d
    if not (d == "cuda" or d.startswith("cuda:")):
        raise ValueError(f"unknown device {d!r}: expected 'cuda' or 'cpu'")
    import torch

    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; set DIAMOND_TPU_TORCH_DEVICE=cpu "
            "(or pass device='cpu') to run on the CPU")
    return d


def device_dp_enabled() -> bool:
    return os.environ.get("DIAMOND_TPU_TORCH_DEVICE_DP") != "0"


def stage12_device_enabled() -> bool:
    """Stage 1/2 on the device only when DIAMOND_TPU_TORCH_STAGE12 asks for
    it (any value but "0"); the host pass stays the default."""
    v = os.environ.get("DIAMOND_TPU_TORCH_STAGE12")
    return bool(v) and v != "0"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a torch.distributed process group (the counterpart of
    diamond_tpu's jax.distributed bring-up): ``init_process_group`` over
    ``tcp://<coordinator>`` with the given world size and rank.  A no-op
    returning False without a coordinator (argument or environment);
    idempotent.  Raises if the world cannot form: it never carries on as
    one process.

    The backend is NCCL when every rank has a card of its own (rank r
    takes ``cuda:r`` of this host's cards), Gloo on a CPU the caller asked
    for, and Gloo for ranks that share a card (NCCL refuses two ranks on
    one device): the kernels still run on the card, only the gathered
    tensors cross Gloo through host memory.  Each rank prints its backend
    and device in one line on standard error."""
    import datetime

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator or env.get("DIAMOND_TPU_TORCH_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    if num_processes is None and env.get("DIAMOND_TPU_TORCH_NUM_PROCESSES"):
        num_processes = int(env["DIAMOND_TPU_TORCH_NUM_PROCESSES"])
    if process_id is None and env.get("DIAMOND_TPU_TORCH_PROCESS_ID"):
        process_id = int(env["DIAMOND_TPU_TORCH_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id (--num-procs, --proc-id)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    device = resolve_device()
    backend = "gloo"
    if device == "cuda":
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(process_id % n_cards)
        device = f"cuda:{process_id % n_cards}"
        if n_cards >= num_processes:
            backend = "nccl"
    timeout = float(env.get("DIAMOND_TPU_TORCH_DIST_TIMEOUT") or 300)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    print(f"diamond_tpu_torch: rank {process_id} of {num_processes} joined "
          f"over {backend} ({device})", file=sys.stderr, flush=True)
    return True
