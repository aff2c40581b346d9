"""The query-indexed route's DB-side seed enumeration and probe, on the card.

``enumerate_filtered`` returns the seeds of a letter block whose key is in
a query key set: for each sequence of at least ``span`` letters and each
window start in it, the letters at the shape's 1 positions reduced through
a 256-entry ``table``; a window whose reduced letters all lie in
``[0, base)`` is a seed, its key their base-``base`` number (the first
letter most significant), and it survives when the key is among
``q_keys``.  Keys and positions come out as the host pass
``native.enumerate_seeds_filtered_native`` writes them: in sequence order,
then position order within a sequence, bit for bit.  CUDA tensors launch
``seed_enum_launch`` (CUDA C++ in ``csrc/seed_enum.cu``, counted in
``enumerate_filtered.launches``, once a call), which takes the place of
that single-threaded host pass (``native/src/stages.cc``
``enumerate_seeds_filtered``) on ``search/pipeline._enumerate_t_qindex``'s
fused path; it has no Pallas counterpart.  CPU tensors run the plain
PyTorch version ``enumerate_filtered_torch``.

``upload_block`` puts a host block's letters on a card once (from a pinned
staging buffer, ``_cuda.staging``), and ``enumerate_block`` enumerates it
for one shape, uploading only that shape's query keys and window offsets,
and brings the survivors back as numpy arrays; both refuse the CPU.  Keys
are uint64 values; the tensors hold their bits as int64.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from diamond_tpu_torch.ops import _cuda
from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.utils.log import kspan

TILE = 512        # windows a warp takes in the kernel (csrc/seed_enum.cu)
MAX_WEIGHT = 32   # letters a shape samples, at most
# the least block (letters, padding included) that search/pipeline sends to
# the card: below it the host pass is faster than the route's fixed cost
# (uploads, two syncs a shape).  On an H100, a search of both default
# shapes (chip_ab.py --kernel seed): 11,472 letters 1.43 ms on the card
# against 1.24 on the host, 27,828 letters 2.02 against 2.87
MIN_LETTERS = 1 << 14


def reduce_table(reduction) -> np.ndarray:
    """The kernel's reduction: ``reduction`` applied to every byte value,
    int8 [256] by the byte's unsigned value; equal to ``Reduction.__call__``
    on every byte by construction (bit 7, MASK and the delimiter too)."""
    return reduction(np.arange(256, dtype=np.uint8).view(np.int8))


def window_offsets(lens: np.ndarray, span: int) -> np.ndarray:
    """Each sequence's first window number, int64 [n + 1]: the exclusive
    prefix of max(L - span + 1, 0); the last entry is the block's windows."""
    per = np.maximum(np.asarray(lens, np.int64) - (span - 1), 0)
    off = np.zeros(len(per) + 1, np.int64)
    np.cumsum(per, out=off[1:])
    return off


def hash_capacity(nq: int) -> int:
    """Slots of the query key set: the host pass's, the least power of two
    >= 2 nq, at least 16."""
    cap = 16
    while cap < 2 * nq:
        cap <<= 1
    return cap


def enumerate_filtered_torch(letters, table, starts, lens, shape_pos, span,
                             base, q_keys):
    """The plain version of ``enumerate_filtered``: the survivors' (keys,
    positions), int64 tensors on the letters' device."""
    dev = letters.device
    per = (lens - (span - 1)).clamp(min=0)
    n_win = int(per.sum())
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n_win == 0 or q_keys.numel() == 0:
        return empty, empty.clone()
    seq = torch.repeat_interleave(torch.arange(len(lens), device=dev), per)
    first = torch.cumsum(per, 0) - per
    pos = starts[seq] + torch.arange(n_win, device=dev) - first[seq]
    red = table.long()[letters.long() & 255]
    key = torch.zeros(n_win, dtype=torch.int64, device=dev)
    valid = torch.ones(n_win, dtype=torch.bool, device=dev)
    for c in shape_pos.tolist():
        r = red[pos + c]
        valid &= (r >= 0) & (r < base)
        key = key * base + r
    keep = valid & torch.isin(key, q_keys)
    return key[keep], pos[keep]


def _kernel():
    return _cuda.launcher("seed_enum", "seed_enum_launch",
                          "ippppqqpiipqpqppppp")


def enumerate_filtered(letters, table, starts, lens, shape_pos, span: int,
                       base: int, q_keys, plan=None):
    """The seeds of ``letters`` (int8 [N]) whose key is in ``q_keys`` (int64
    [nq], the uint64 keys' bits, in any order, duplicates allowed): (keys,
    positions), int64 tensors on the same device.  ``table``: int8 [256],
    ``reduce_table``; ``starts``, ``lens``: int64 [n], sequences inside
    ``letters``; ``shape_pos``: int32 [weight], the shape's 1 positions,
    each < ``span``.  ``plan``: ``(win_off, n_windows)``, ``window_offsets``
    on the device and its last entry (``enumerate_block`` uploads it with
    the keys); made here from ``lens`` (a sync) when not given."""
    dev = letters.device
    check_tensors(dev, ("letters", letters, torch.int8),
                  ("table", table, torch.int8),
                  ("starts", starts, torch.int64), ("lens", lens, torch.int64),
                  ("shape_pos", shape_pos, torch.int32),
                  ("q_keys", q_keys, torch.int64))
    n, weight = starts.shape[0], shape_pos.shape[0]
    if (letters.dim() != 1 or starts.dim() != 1 or lens.shape != (n,)
            or table.shape != (256,) or q_keys.dim() != 1
            or shape_pos.dim() != 1):
        raise ValueError("letters, starts, lens, q_keys and shape_pos must "
                         "be 1-D, lens shaped as starts, the table 256 long")
    if not 1 <= weight <= MAX_WEIGHT or not 1 <= base <= 127:
        raise ValueError(f"a shape samples 1 to {MAX_WEIGHT} letters and "
                         f"the base is 1 to 127")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"enumerate_filtered runs on cuda or cpu, not {dev}")
    if plan is None:
        _check_shape(shape_pos.cpu().numpy(), span)
        off = window_offsets(lens.cpu().numpy(), span)
        plan = torch.from_numpy(off).to(dev), int(off[-1])
    else:
        check_tensors(dev, ("win_off", plan[0], torch.int64))
    win_off, n_windows = plan
    nq = q_keys.shape[0]
    with kspan("kernel.seed_t", dev) as sp:
        if dev.type == "cpu":
            keys, pos = enumerate_filtered_torch(letters, table, starts, lens,
                                                 shape_pos, span, base, q_keys)
        elif n_windows and nq:
            keys, pos = _launch(letters, table, starts, win_off, n_windows,
                                shape_pos, base, q_keys)
        else:
            keys = pos = torch.zeros(0, dtype=torch.int64, device=dev)
        if sp:
            sp.fields = dict(positions=int(n_windows), q_keys=int(nq),
                             survivors=int(keys.shape[0]), weight=int(weight))
    return keys, pos


def _check_shape(shape_pos: np.ndarray, span: int) -> None:
    """A window reads its letters at the shape's positions: each in
    [0, span), or the kernel would read past its sequence."""
    if len(shape_pos) and (shape_pos.min() < 0 or shape_pos.max() >= span):
        raise ValueError(f"the shape's positions must lie in [0, {span})")


def _launch(letters, table, starts, win_off, n_windows, shape_pos, base,
            q_keys):
    dev = letters.device
    nq, cap = q_keys.shape[0], hash_capacity(q_keys.shape[0])
    n_tiles = -(-n_windows // TILE)
    hash_set = torch.empty(cap, dtype=torch.int64, device=dev)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_tiles + 1, dtype=torch.int64, device=dev)
    k = _kernel()

    def launch(phase, keys_ptr=0, pos_ptr=0):
        err = k(phase, letters.data_ptr(), table.data_ptr(),
                starts.data_ptr(), win_off.data_ptr(), starts.shape[0],
                n_windows, shape_pos.data_ptr(), shape_pos.shape[0], base,
                q_keys.data_ptr(), nq, hash_set.data_ptr(), cap,
                counts.data_ptr(), offsets.data_ptr(), keys_ptr, pos_ptr,
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"seed_enum launch failed: CUDA error {err}")

    with torch.cuda.device(dev):  # the launches go to the current device
        launch(0)
        total = int(offsets[n_tiles])  # the one sync before the write
        out = torch.empty(2 * total, dtype=torch.int64, device=dev)
        if total:
            launch(1, out.data_ptr(), out[total:].data_ptr())
    enumerate_filtered.launches += 1
    return out[:total], out[total:]


enumerate_filtered.launches = 0


@dataclass
class SeedBlock:
    """A block's letters on a device, as ``upload_block`` leaves them."""

    letters: torch.Tensor   # int8 [N]
    starts: torch.Tensor    # int64 [n]
    lens: torch.Tensor      # int64 [n]
    table: torch.Tensor     # int8 [256]
    host_lens: np.ndarray   # int64 [n], for each shape's window offsets
    base: int

    def windows(self, span: int) -> int:
        """The block's window starts for a shape of ``span`` letters."""
        return int(np.maximum(self.host_lens - (span - 1), 0).sum())


def upload_block(letters: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 table: np.ndarray, base: int, device) -> SeedBlock:
    """A host block (int8 ``letters``, its sequences' ``starts`` and
    ``lens``) on the CUDA ``device``, with the reduction's ``table``
    (``reduce_table``) and ``base`` (its size): one copy from a pinned
    staging buffer (kept between calls), no sync.  Counted in
    ``upload_block.uploads``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"upload_block uploads to a CUDA device, not {dev}")
    if table.dtype != np.int8 or table.shape != (256,):
        raise TypeError("the table must be int8 [256]")
    starts = np.asarray(starts, np.int64)
    lens = np.asarray(lens, np.int64)
    N, n = len(letters), len(lens)
    if len(starts) != n or (n and (starts.min() < 0 or (lens < 0).any()
                                   or (starts + lens).max() > N)):
        raise ValueError("every sequence must lie inside the letters")
    a0 = -(-N // 8) * 8          # starts, lens: int64
    a1 = a0 + 16 * n             # the table
    size = a1 + 256
    st = _cuda.staging(dev, "letters")  # the buffer masking uploads from
    host = st.take(size)
    host[:N] = letters.view(np.uint8)
    meta = host[a0:a1].view(np.int64)
    meta[:n], meta[n:] = starts, lens
    host[a1:size] = table.view(np.uint8)
    up = st.upload(size, dev)
    meta_d = up[a0:a1].view(torch.int64)
    upload_block.uploads += 1
    return SeedBlock(up[:N].view(torch.int8), meta_d[:n], meta_d[n:],
                     up[a1:size].view(torch.int8), lens, int(base))


upload_block.uploads = 0


def enumerate_block(blk: SeedBlock, shape_pos: np.ndarray, span: int,
                    q_keys: np.ndarray):
    """The seeds of an uploaded block for one shape (``shape_pos``, its 1
    positions; ``span``, its length) whose key is in ``q_keys`` (uint64, any
    order): (keys uint64, positions int64) numpy arrays, in the host pass's
    order.  Uploads the keys, the window offsets and the shape in one copy
    from a pinned staging buffer; one launch."""
    dev = blk.letters.device
    if dev.type != "cuda":
        raise ValueError(f"enumerate_block runs on a CUDA device, not {dev}")
    off = window_offsets(blk.host_lens, span)
    q = np.asarray(q_keys, np.uint64)
    shape_pos = np.asarray(shape_pos, np.int32)
    _check_shape(shape_pos, span)
    nq, n1, w = len(q), len(off), len(shape_pos)
    a0 = 8 * nq                  # the window offsets: int64
    a1 = a0 + 8 * n1             # the shape: int32
    size = a1 + 4 * w
    st = _cuda.staging(dev, "seed_keys")
    host = st.take(size)
    host[:a0].view(np.uint64)[:] = q
    host[a0:a1].view(np.int64)[:] = off
    host[a1:size].view(np.int32)[:] = shape_pos
    up = st.upload(size, dev)
    keys, pos = enumerate_filtered(
        blk.letters, blk.table, blk.starts, blk.lens,
        up[a1:size].view(torch.int32), span, blk.base,
        up[:a0].view(torch.int64),
        plan=(up[a0:a1].view(torch.int64), int(off[-1])))
    host_out = torch.cat((keys, pos)).cpu().numpy()
    m = len(keys)
    return host_out[:m].view(np.uint64), host_out[m:]
