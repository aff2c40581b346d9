"""tantan's repeat-probability scan and the hard mask it drives, on the card.

``tantan_mask`` masks a block's letters in place: every position of a
sequence whose repeat probability reaches ``p_mask`` becomes MASK_LETTER,
every other byte (padding between sequences included) is left as it is.
CUDA tensors launch the kernel ``tantan_mask_launch`` (CUDA C++ in
``csrc/tantan.cu``, counted in ``tantan_mask.launches``), which takes the
place of the host's native scan ``tantan_repeat_prob_many``
(``native/src/tantan.cc``) that ``search/pipeline._mask_block`` runs; it has
no Pallas counterpart.  CPU tensors run the plain PyTorch version
``tantan_mask_torch``.  ``mask_letters`` masks a host block's numpy letters
through a card: one upload from a pinned staging buffer, the kernel, and
the masked positions back.

The arithmetic is ``tantan.cc``'s, operation for operation in float32, so
that the decision ``P >= p_mask`` falls the same way on every position:
50 repeat-offset states with emission ratios
``e[i][k] = ratios[s[i]][s[i - k - 1]]`` (0 before the sequence start,
``s = letters & 31``), the forward pass ``f = (f * f2f + b * d) * e``,
``b = b * b2b + f_sum * p_repeat_end`` with a scaling by ``1 / b`` every 16
positions, the backward pass, and ``P = 1 - pb * b * zinv``; every sum of
the 50 states in numpy's pairwise order (``psum50``).  The plain version
steps all sequences of a chunk in lockstep, each op a tensor op, so no
operation is fused or reordered.
"""
from __future__ import annotations

import numpy as np
import torch

from diamond_tpu_torch.constants.alphabet import LETTER_MASK, MASK_LETTER
from diamond_tpu_torch.ops import _cuda
from diamond_tpu_torch.ops._cuda import check_tensors
from diamond_tpu_torch.utils.log import kspan

WINDOW = 50                                      # repeat-offset states
PLAIN_CELLS = {"cpu": 1 << 22, "cuda": 1 << 26}  # plain: letters a chunk
MAX_LEN = 1 << 30                                # longest sequence taken


def scan_params(masker) -> dict:
    """The scan's float32 constants from a ``masking.tantan.Tantan``:
    ratios [32, 32], d [WINDOW], b2b, f2f, p_repeat_end, p_mask."""
    return dict(ratios=np.ascontiguousarray(masker.ratios, np.float32),
                d=np.ascontiguousarray(masker.d, np.float32),
                b2b=np.float32(masker.b2b), f2f=np.float32(masker.f2f),
                pre=np.float32(masker.p_repeat_end),
                p_mask=np.float32(masker.p_mask))


def psum50(a):
    """numpy's pairwise sum over the last axis of 50 float32 values: eight
    accumulators over the first 48, each in order, their tree, then a[48]
    and a[49]."""
    r = a[..., 0:8]
    for j in range(8, 48, 8):
        r = r + a[..., j:j + 8]
    s = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
         + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
    return (s + a[..., 48]) + a[..., 49]


def _chunks(lens: np.ndarray, cells: int):
    """Sequence indices, longest first, in chunks of at most ``cells``
    padded letters (a longer sequence alone)."""
    order = np.argsort(-lens, kind="stable")
    lo = 0
    while lo < len(order):
        longest = max(int(lens[order[lo]]), 1)
        hi = lo + max(cells // longest, 1)
        yield order[lo:hi]
        lo = hi


def tantan_prob_torch(letters, starts, lens, params: dict):
    """P(repeat) of every position, float32 aligned with ``letters`` (0
    outside the sequences): the plain version of the kernel's scan.
    letters int8 [N], starts and lens int64 [n] on one device."""
    dev = letters.device
    out = torch.zeros(letters.shape[0], dtype=torch.float32, device=dev)
    lens_np = lens.cpu().numpy()
    if not len(lens_np) or lens_np.max(initial=0) == 0:
        return out
    f32 = dict(dtype=torch.float32, device=dev)
    ratios = torch.as_tensor(params["ratios"], **f32).reshape(-1)
    d = torch.as_tensor(params["d"], **f32)
    b2b, f2f, pre = (torch.tensor(float(params[k]), **f32)
                     for k in ("b2b", "f2f", "pre"))
    one = torch.tensor(1.0, **f32)
    ks = torch.arange(WINDOW, device=dev)
    for sel in _chunks(lens_np, PLAIN_CELLS.get(dev.type, 1 << 22)):
        sel_t = torch.as_tensor(sel, device=dev)
        L = lens[sel_t]
        n, Lmax = len(sel), int(lens_np[sel].max())
        if Lmax == 0:
            continue
        cols = torch.arange(Lmax, device=dev)
        inside = cols[None, :] < L[:, None]
        pos = torch.where(inside, starts[sel_t][:, None] + cols[None, :], 0)
        s = (letters[pos].long() & LETTER_MASK) * inside
        pb = torch.zeros((n, Lmax), **f32)
        scale = torch.zeros((n, (Lmax + 15) // 16), **f32)

        def emission(i):
            prev = i - 1 - ks
            e = ratios[s[:, i:i + 1] * 32 + s[:, prev.clamp(min=0)]]
            return torch.where(prev >= 0, e, torch.zeros((), **f32))

        f = torch.zeros((n, WINDOW), **f32)
        b = torch.ones(n, **f32)
        f_sum = torch.zeros(n, **f32)
        for i in range(Lmax):
            act = i < L
            f_new = (f * f2f + b[:, None] * d) * emission(i)
            f_sum_new = psum50(f_new)
            b_new = b * b2b + f_sum * pre
            if (i & 15) == 15:
                sc = one / b_new
                scale[:, i // 16] = sc
                b_new = b_new * sc
                f_new = f_new * sc[:, None]
                f_sum_new = f_sum_new * sc
            pb[:, i] = b_new
            f = torch.where(act[:, None], f_new, f)
            b = torch.where(act, b_new, b)
            f_sum = torch.where(act, f_sum_new, f_sum)
        zinv = one / (b * b2b + psum50(f) * pre)

        prob = torch.zeros((n, Lmax), **f32)
        b = b2b.expand(n).clone()
        f = pre.expand(n, WINDOW).clone()
        for i in range(Lmax - 1, -1, -1):
            act = i < L
            prob[:, i] = one - pb[:, i] * b * zinv
            bs, fs = b, f
            if (i & 15) == 15:
                bs = b * scale[:, i // 16]
                fs = f * scale[:, i // 16, None]
            fe = fs * emission(i)
            t_sum = psum50(fe * d)
            f = torch.where(act[:, None], fe * f2f + pre * bs[:, None], f)
            b = torch.where(act, b2b * bs + t_sum, b)
        out[pos[inside]] = prob[inside]
    return out


def tantan_mask_torch(letters, starts, lens, params: dict):
    """The plain version of ``tantan_mask``: masks ``letters`` in place."""
    prob = tantan_prob_torch(letters, starts, lens, params)
    letters[prob >= float(params["p_mask"])] = MASK_LETTER
    return letters


def _kernel():
    return _cuda.launcher("tantan", "tantan_mask_launch", "ppppippppppffffip")


def launch_plan(lens: np.ndarray):
    """A launch's host-side inputs from the lengths (int64 [n]): the
    sequences longest first (int32; by the lengths capped at 32767, which
    numpy sorts by radix), each one's first scale word (int64), the longest
    length and the number of letters."""
    lens = np.asarray(lens, dtype=np.int64)
    key = np.minimum(lens, np.iinfo(np.int16).max).astype(np.int16)
    order = np.argsort(-key, kind="stable").astype(np.int32)
    per = (lens + 15) // 16
    return (order, np.cumsum(per) - per, int(lens.max(initial=0)),
            int(lens.sum()))


def tantan_mask(letters, starts, lens, params: dict, probs=None, plan=None):
    """Mask ``letters`` (int8 [N]) in place: tantan over each sequence
    ``[starts[i], starts[i] + lens[i])`` (int64 [n]), positions with
    P(repeat) >= p_mask set to MASK_LETTER.  ``params``: ``scan_params``.
    ``probs``, float32 [N] on the device, takes each position's P(repeat)
    (the kernel only).  ``plan``: ``launch_plan``'s four, its arrays on the
    device (``mask_letters`` uploads them with the letters); made here from
    ``lens`` (a sync) when not given.  Sequences must lie inside
    ``letters`` and not overlap: the caller's blocks do."""
    dev = letters.device
    check_tensors(dev, ("letters", letters, torch.int8),
                  ("starts", starts, torch.int64), ("lens", lens, torch.int64))
    n = starts.shape[0]
    if letters.dim() != 1 or starts.dim() != 1 or lens.shape != (n,):
        raise ValueError("letters must be 1-D, starts and lens [n] alike")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tantan_mask runs on cuda or cpu, not {dev}")
    if probs is not None:
        check_tensors(dev, ("probs", probs, torch.float32))
        if probs.shape != letters.shape or dev.type != "cuda":
            raise ValueError("probs must be a CUDA tensor shaped as letters")
    if plan is None:
        order, scale_off, longest, n_letters = launch_plan(lens.cpu().numpy())
        order, scale_off = (torch.from_numpy(order).to(dev),
                            torch.from_numpy(scale_off).to(dev))
    else:
        order, scale_off, longest, n_letters = plan
        check_tensors(dev, ("order", order, torch.int32),
                      ("scale_off", scale_off, torch.int64))
    if longest > MAX_LEN:
        raise ValueError(f"tantan_mask takes sequences of at most {MAX_LEN} "
                         f"letters")
    with kspan("kernel.mask", dev) as sp:
        if sp:
            sp.fields = dict(letters=int(n_letters), sequences=int(n),
                             longest=int(longest), states=WINDOW)
        if dev.type == "cpu":
            return tantan_mask_torch(letters, starts, lens, params)
        if longest > 0:
            _launch(letters, starts, lens, order, scale_off, params, probs)
    return letters


def _launch(letters, starts, lens, order, scale_off, params: dict, probs):
    dev, n = letters.device, starts.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    tab = params.get("tab")  # ratios, then d, on the card
    if tab is None or tab.device != dev:
        tab = params["tab"] = torch.as_tensor(_table(params), **f32)
    pb = torch.empty(letters.shape[0], **f32)
    scale = torch.empty(letters.shape[0] // 16 + n + 1, **f32)
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = _kernel()(
            order.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            scale_off.data_ptr(), n, letters.data_ptr(), pb.data_ptr(),
            scale.data_ptr(), 0 if probs is None else probs.data_ptr(),
            tab.data_ptr(), tab[32 * 32:].data_ptr(),
            float(params["b2b"]), float(params["f2f"]), float(params["pre"]),
            float(params["p_mask"]), MASK_LETTER,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tantan_mask launch failed: CUDA error {err}")
    tantan_mask.launches += 1


tantan_mask.launches = 0


def _table(params: dict) -> np.ndarray:
    """The kernel's float32 table: the 32 x 32 ratios, then d."""
    return np.concatenate([params["ratios"].reshape(-1), params["d"]])


def mask_letters(letters: np.ndarray, starts: np.ndarray,
                 lengths: np.ndarray, masker, device, overlap=None) -> None:
    """Mask a host block's int8 ``letters`` in place through the CUDA
    ``device``: the letters, starts, lengths, the launch plan and the scan's
    table go up in one copy from a pinned staging buffer (kept between
    calls), the kernel masks the letters there, and the positions that hold
    MASK_LETTER come back and are set in ``letters`` (the same bytes as
    copying all of them back: a position masked before stays masked).
    ``overlap``, a callable, runs on the host while the card masks."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"mask_letters masks on a CUDA device, not {dev}")
    params = scan_params(masker)
    lens = np.asarray(lengths, dtype=np.int64)
    N, n = len(letters), len(lens)
    order, scale_off, longest, n_letters = launch_plan(lens)
    tab = _table(params)
    a0 = -(-N // 8) * 8             # starts, lens, scale_off: int64
    a1 = a0 + 24 * n                # order: int32
    a2 = a1 + 8 * -(-n // 2)        # the table: float32
    size = a2 + 4 * len(tab)
    st = _cuda.staging(dev, "letters")
    host = st.take(size)
    host[:N] = letters.view(np.uint8)
    meta = host[a0:a1].view(np.int64)
    meta[:n], meta[n:2 * n], meta[2 * n:] = starts, lens, scale_off
    host[a1:a1 + 4 * n].view(np.int32)[:] = order
    host[a2:size].view(np.float32)[:] = tab
    up = st.upload(size, dev)
    with torch.cuda.device(dev):
        x = up[:N].view(torch.int8)
        meta_d = up[a0:a1].view(torch.int64)
        params["tab"] = up[a2:size].view(torch.float32)
        tantan_mask(x, meta_d[:n], meta_d[n:2 * n], params, plan=(
            up[a1:a1 + 4 * n].view(torch.int32), meta_d[2 * n:], longest,
            n_letters))
        if overlap is not None:
            overlap()
        masked = torch.nonzero(x == MASK_LETTER).flatten().cpu().numpy()
    letters[masked] = MASK_LETTER
