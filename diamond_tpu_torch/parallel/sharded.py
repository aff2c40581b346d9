"""Database-sharded scoring over several devices or processes (``--mesh N``).

The counterpart of ``diamond_tpu/parallel/sharded.py``, where a jax mesh's
``db`` axis shards the targets and ``shard_map`` runs each shard's DP and
all-gathers the scores.  Here a mesh is an ordered list of torch devices
(``Mesh``): the targets (or DP jobs) are split into one contiguous range per
entry, each range is scored on its entry's device by the port's kernel (K4
for the full-matrix scores, K1 through ``DeviceDP(mesh=...)`` for the
extension DP; on a CPU entry their plain versions), and the per-shard
results are put back in order: a concatenation within one process, a
``torch.distributed.all_gather`` across the ranks of a process group.

``make_mesh(n)`` takes the devices there are, as the reference's
``jax.devices()[:n]`` does, so ``--mesh N`` above the card count runs on
fewer shards; the output never depends on the mesh's size.
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.utils.device import resolve_device
from diamond_tpu_torch.utils.log import padd, perf_counter


class Mesh(list):
    """The shards' torch devices, in shard order.  ``ranked``: entry i is
    rank i's device in the process group, each rank runs only its own shard
    and the results cross ranks by all_gather; otherwise this process runs
    every shard."""

    def __init__(self, devices, ranked: bool = False):
        super().__init__(torch.device(d) for d in devices)
        self.ranked = ranked

    def local(self) -> list[int]:
        """The shards this process runs."""
        if not self.ranked:
            return list(range(len(self)))
        import torch.distributed as dist

        rank = dist.get_rank()
        return [rank] if rank < len(self) else []


def make_mesh(n_devices: int | None = None, platform: str | None = None) -> Mesh:
    """The first ``n_devices`` (all when None) shard devices.

    Inside a process group: one entry per rank, rank r's own device (its
    card ``cuda:r % cards`` as ``utils.device.init_distributed`` chose it,
    or the CPU).  Otherwise this process's cards ``cuda:0..``, or with
    ``platform="cpu"`` (or DIAMOND_TPU_TORCH_DEVICE=cpu) ``n_devices`` CPU
    shards."""
    import torch.distributed as dist

    kind = torch.device(resolve_device(platform)).type
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if kind == "cpu":
            devs = ["cpu"] * world
        else:
            n_cards = torch.cuda.device_count()
            devs = [f"cuda:{r % n_cards}" for r in range(world)]
        return Mesh(devs[:n_devices], ranked=True)
    if kind == "cpu":
        return Mesh(["cpu"] * (n_devices or 1))
    devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh(devs[:n_devices])


def gather_shards(mesh: Mesh, local: dict, sizes, rows: int) -> list:
    """Every shard's int32 result in shard order: ``local`` maps the shards
    this process ran to numpy arrays [rows, sizes[s]]; across ranks each
    shard is padded to the largest and all-gathered (on the card under NCCL,
    in host memory under Gloo)."""
    if not mesh.ranked:
        return [local[s] for s in range(len(mesh))]
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = torch.zeros(rows, max(max(sizes), 1), dtype=torch.int32, device=dev)
    for s, a in local.items():
        buf[:, :sizes[s]] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return [parts[s][:, :sizes[s]].cpu().numpy() for s in range(len(mesh))]


def sharded_swipe_topk(mesh: Mesh, targets_1h, band_mask, profile_pad,
                       gap_open_total: int, gap_extend: int, band: int,
                       k: int = 25):
    """Score a replicated query against a target batch sharded over the mesh
    and return the global top-k (scores, global target indices), numpy.

    The inputs are ``ops/swipe_uniform.prepare_uniform_batch``'s:
    targets_1h [T, B, 32] one-hot shifted targets (B a multiple of the mesh
    size), band_mask [B, band], profile_pad [T + band, 32].  Each shard runs
    the uniform-band kernel (K4) over its B / n targets and keeps its top
    min(k, shard); the candidates are gathered in shard order and the global
    top-k taken, ties to the lower position, as jax.lax.top_k breaks them."""
    from diamond_tpu_torch.ops.swipe_uniform import profile_rows
    from diamond_tpu_torch.ops.swipe_uniform_device import \
        banded_swipe_uniform_cuda

    def host(x):
        return np.asarray(x.cpu() if torch.is_tensor(x) else x)

    n_dev = len(mesh)
    t1h = host(targets_1h)
    T, B, _ = t1h.shape
    if B % n_dev:
        raise ValueError(f"{B} targets do not split over {n_dev} shards")
    shard = B // n_dev
    kk = min(k, shard)
    t_idx = np.ascontiguousarray(t1h.argmax(axis=2).T).astype(np.int8)
    mask = host(band_mask).astype(np.int8)
    prof_t = np.ascontiguousarray(host(profile_pad).T).astype(np.int32)
    if prof_t.shape[1] != T + band or mask.shape[1] != band:
        raise ValueError("profile_pad must be [T + band, 32] and band_mask "
                         "[B, band]")
    rows = profile_rows(prof_t)  # on the host: no read-back a shard
    local = {}
    for s in mesh.local():
        dev = mesh[s]
        lo = s * shard
        best = banded_swipe_uniform_cuda(
            torch.from_numpy(t_idx[lo:lo + shard]).to(dev),
            torch.from_numpy(mask[lo:lo + shard]).to(dev),
            torch.from_numpy(prof_t).to(dev), gap_open_total,
            gap_extend, rows=rows)[0].cpu().numpy().astype(np.int64)
        top = _top_k(best, kk)
        local[s] = np.stack([best[top], top + lo]).astype(np.int32)
    cand = np.concatenate(gather_shards(mesh, local, [kk] * n_dev, 2),
                          axis=1)
    pos = _top_k(cand[0].astype(np.int64), min(k, cand.shape[1]))
    return cand[0][pos], cand[1][pos]


def _top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Positions of the k largest scores, largest first, ties to the lower
    position (jax.lax.top_k's order)."""
    return np.lexsort((np.arange(len(scores)), -scores))[:k]


def sharded_full_scores(mesh: Mesh, query, bias, tblock, matrix32,
                        gap_open: int, gap_extend: int) -> np.ndarray:
    """Full-matrix score of one query against every sequence of a target
    block, the block sharded over the mesh: int32 [len(tblock)], the same as
    the host DP's (the --swipe scoring round of align/swipe_all.py, whose
    host culling then runs unchanged on the gathered scores).

    The jobs (target t: band [-(len - 1), qlen)) are padded with empty jobs
    to a mesh multiple and split into one contiguous range per shard.  A
    shard scores its jobs with the uniform-band kernel (K4,
    ``ops/swipe_uniform_device.uniform_scores``) on its device, one launch
    per (padded band, padded target length) class so that a long target
    does not widen every short one's walk; jobs whose band exceeds
    MAX_UNIFORM_BAND take the host DP, as everywhere in the port (phase
    timer ``mesh.host_dp``)."""
    from diamond_tpu_torch.ops.banded_swipe import banded_swipe_batch_np
    from diamond_tpu_torch.ops.swipe_uniform import (MAX_UNIFORM_BAND,
                                                     pad_band, pad_pow2)
    from diamond_tpu_torch.ops.swipe_uniform_device import uniform_scores

    n_dev = len(mesh)
    qlen = len(query)
    jobs = []
    for t in range(len(tblock)):
        tgt = tblock.seq(t)
        jobs.append((tgt, -(max(len(tgt), 1) - 1), qlen))
    B0 = len(jobs)
    while len(jobs) % n_dev:
        jobs.append((np.zeros(1, dtype=np.int8), 0, 1))
    shard = len(jobs) // n_dev
    go, ge = gap_open + gap_extend, gap_extend
    local = {}
    for s in mesh.local():
        mine = jobs[s * shard:(s + 1) * shard]
        scores = np.zeros(shard, dtype=np.int32)
        classes: dict[tuple, list] = {}
        for k, (t, d0, d1) in enumerate(mine):
            classes.setdefault((pad_band(d1 - d0), pad_pow2(len(t), 16)),
                               []).append(k)
        for (band, _), idx in sorted(classes.items()):
            sub = [mine[k] for k in idx]
            if band > MAX_UNIFORM_BAND:
                t0 = perf_counter()
                res = banded_swipe_batch_np(query, bias, sub, matrix32,
                                            gap_open, gap_extend)
                best = [int(np.asarray(r).flat[0]) for r in res]
                padd("mesh.host_dp", t0)
            else:
                best = uniform_scores(query, bias, matrix32, sub, go, ge,
                                      mesh[s])[0]
            scores[idx] = best
        local[s] = scores[None, :]
    parts = gather_shards(mesh, local, [shard] * n_dev, 1)
    return np.concatenate(parts, axis=1)[0][:B0]
