"""Stage-1 fingerprint identity counts as a one-hot batched matrix product
(the counterpart of ``diamond_tpu/ops/stage12_jax._stage1_matmul_kernel``,
which is XLA code, not a Pallas kernel; ``Stage12Device`` is still to port,
ROADMAP.md section 1, item 14).

The reference computes the same all-vs-all byte-match popcount with SIMD
tiles (src/search/hamming/kernel.h:29-75).
"""
from __future__ import annotations

import torch

WINDOW_LEFT = 16
FP_LEN = 48
TILE_Q = 8     # query occurrences per matmul tile
TILE_S = 128   # target occurrences per matmul tile


def stage1_matmul(q_letters, s_letters, qp_tile, sp_tile, TQ: int = TILE_Q,
                  TS: int = TILE_S):
    """Identity counts of every (query, target) occurrence pair of each tile.

    q_letters / s_letters int8 letter blocks; qp_tile [G, TQ] / sp_tile
    [G, TS] integer seed positions of one seed group per tile.  Each 48-letter
    fingerprint window [pos - 16, pos + 32) becomes a 48 x 32 one-hot (bf16,
    exact for 0/1), and the counts are the [G, TQ, TS] batched product over
    the 1536-wide contracted axis (fp32 accumulation on the card; every
    partial sum is an integer <= 48, exact in bf16 as well).  Returns int32
    [G, TQ, TS], on the inputs' device."""
    offs = torch.arange(-WINDOW_LEFT, -WINDOW_LEFT + FP_LEN,
                        device=q_letters.device)
    G = qp_tile.shape[0]
    qw = q_letters[qp_tile.long()[:, :, None] + offs].long() & 31
    sw = s_letters[sp_tile.long()[:, :, None] + offs].long() & 31
    one = torch.nn.functional.one_hot
    q1 = one(qw, 32).to(torch.bfloat16).reshape(G, TQ, FP_LEN * 32)
    s1 = one(sw, 32).to(torch.bfloat16).reshape(G, TS, FP_LEN * 32)
    return torch.bmm(q1, s1.transpose(1, 2)).to(torch.int32)
