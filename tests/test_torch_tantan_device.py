"""tantan on the card's route (``ops/tantan_device``) on the CPU: the plain
PyTorch version of the kernel's scan against diamond_tpu's native host scan
(``diamond_tpu.native.tantan_repeat_prob_many`` with diamond_tpu's Tantan
constants), bit for bit, and the port's native scan against the same (it is
the reference of the kernel's test on the card, where diamond_tpu does not
run); and the CPU route of ``search/pipeline._mask_block``.  The kernel
itself runs in ``tests/test_torch_gpu.py``."""
import os
import sys

import numpy as np
import pytest
import torch

from diamond_tpu_torch import native
from diamond_tpu_torch.constants.alphabet import (DELIMITER_LETTER,
                                                 MASK_LETTER, encode)
from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.masking.tantan import Tantan
from diamond_tpu_torch.ops import tantan_device as td
from diamond_tpu_torch.search import pipeline
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
from diamond_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA = "ARNDCQEGHILKMFPSTWYV"
MASKER = Tantan(ScoreMatrix("BLOSUM62").matrix32)

# Tandem repeats whose position ``pos`` sits at the mask's edge (native
# scan): P one ulp above p_mask, P == p_mask (masked), and P one ulp below
# (not masked), each pair one letter apart.  Found by a seeded search that
# changed single letters away from the position until P reached the edge.
EDGES = (
    ("WHKPNLQKSLQTSLITSLQTSLTTSLKTSLQTSFQTSLQTSTQTSLQHSLQTSLQVGLQTSLQTIIIQ"
     "HPWS", 14, 1),
    ("ESKSGKEAAMMDNTKFAGGWVDFFNRRQATPRCETPRKETPKTEQPRKETGFKETERRVTPRKESPR"
     "KMTPTCDKCAPLKEICAGFTDKS", 69, 0),
    ("ETKSGKEAAMMDNTKFAGGWVDFFNRRQATPRCETPRKETPKTEQPRKETGFKETERRVTPRKESPR"
     "KMTPTCDKCAPLKEICAGFTDKS", 69, -1),
    ("RMKHYMTNCTTNCYTECVTECVTECVMECVTRCVTNCYRECNTELVTIHVVECVQLPAQSDECIEAR"
     "FINVK", 34, 0),
    ("RMKHYMTNCTTNCYTECVTECVTECVMECVTRCVTNCYRECNTELVTIHVVECVQLPAQSDECIEAR"
     "FINVN", 34, -1),
)
LENGTHS = (0, 1, 15, 16, 17, 31, 32, 49, 50, 51, 3000)


def _gen():
    sys.path.insert(0, os.path.join(REPO, "perfbench"))
    try:
        import gen
    finally:
        sys.path.remove(os.path.join(REPO, "perfbench"))
    return gen


def _native(letters, starts, lens):
    """The port's native scan."""
    return native.tantan_repeat_prob_many(
        letters, starts, lens, MASKER.ratios, float(MASKER.p_repeat),
        float(MASKER.p_repeat_end), float(MASKER.repeat_growth))


def _ref_masker():
    pytest.importorskip("jax")  # the reference side (absent on a card host)
    from diamond_tpu.masking.tantan import Tantan as RefTantan
    from diamond_tpu.stats.score_matrix import ScoreMatrix as RefMatrix

    return RefTantan(RefMatrix("BLOSUM62").matrix32)


def _ref(letters, starts, lens):
    """diamond_tpu's native scan with diamond_tpu's Tantan constants."""
    from diamond_tpu import native as ref_native

    m = _ref_masker()
    return ref_native.tantan_repeat_prob_many(
        letters, starts, lens, m.ratios, float(m.p_repeat),
        float(m.p_repeat_end), float(m.repeat_growth))


def test_scan_constants_are_the_references():
    m = _ref_masker()
    for k in ("ratios", "d", "p_repeat", "p_repeat_end", "repeat_growth",
              "p_mask", "b2b", "f2f"):
        a, b = np.asarray(getattr(m, k)), np.asarray(getattr(MASKER, k))
        assert a.dtype == b.dtype == np.float32, k
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), k


def _plain(letters, starts, lens):
    return td.tantan_prob_torch(
        torch.from_numpy(np.ascontiguousarray(letters, np.int8)),
        torch.from_numpy(np.asarray(starts, np.int64)),
        torch.from_numpy(np.asarray(lens, np.int64)),
        td.scan_params(MASKER)).numpy()


def _padded(seqs, rng, high_bits=False):
    """(letters, starts, lens): the sequences with 0-5 padding letters
    before each and after the last; with ``high_bits`` bits 5-7 set at
    random on every letter (the scan reads letters & 31)."""
    parts, starts, pos = [], [], 0
    for s in seqs:
        gap = rng.integers(0, 6)
        parts.append(np.full(gap, DELIMITER_LETTER, np.int8))
        pos += gap
        starts.append(pos)
        x = np.asarray(encode(s), np.int8)
        if high_bits:
            x = (x.astype(np.uint8) | (rng.integers(0, 8, len(x)) << 5)
                 .astype(np.uint8)).view(np.int8)
        parts.append(x)
        pos += len(x)
    parts.append(np.full(3, DELIMITER_LETTER, np.int8))
    lens = np.array([len(s) for s in seqs], np.int64)
    return np.concatenate(parts), np.array(starts, np.int64), lens


def _cases():
    rng = np.random.default_rng(17)
    gen = _gen()
    proteins = [s for _, s in gen.make_proteins(120, 30, seed=3,
                                                size_seed=2500)]
    by_len = ["".join(rng.choice(list(AA), n)) for n in LENGTHS]
    repeats = ["".join(rng.choice(list(AA), 12)) + unit * reps
               + "".join(rng.choice(list(AA), 9))
               for unit, reps in (("Q", 40), ("AG", 30), ("PEST", 20),
                                  ("GGSGG", 9), ("KRKRE", 12))]
    edges = [s for s, _, _ in EDGES]
    return {"generator": proteins, "lengths": by_len,
            "repeats": repeats + edges,
            "mixed": proteins[:20] + by_len + repeats + edges}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("high_bits", [False, True], ids=["plain", "high"])
def test_plain_scan_bit_equal_to_native(name, high_bits):
    rng = np.random.default_rng(len(name))
    letters, starts, lens = _padded(CASES[name], rng, high_bits)
    want = _ref(letters, starts, lens)
    got = _plain(letters, starts, lens)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    port = _native(letters, starts, lens)  # the card test's reference
    assert np.array_equal(port.view(np.int32), want.view(np.int32))
    # and the masked letters: padding untouched, high bits kept unmasked
    x = torch.from_numpy(letters.copy())
    td.tantan_mask(x, torch.from_numpy(starts), torch.from_numpy(lens),
                   td.scan_params(MASKER))
    ref = letters.copy()
    np.copyto(ref, MASK_LETTER, where=want >= MASKER.p_mask)
    assert np.array_equal(x.numpy(), ref)
    if name in ("repeats", "mixed"):
        assert (want >= MASKER.p_mask).sum() > 100


def test_edge_cases_sit_at_p_mask():
    """The frozen edge sequences still put P within one ulp of p_mask under
    diamond_tpu's native scan, on both sides, and the plain version and the
    port's native scan agree there."""
    p_mask = _ref_masker().p_mask
    for seq, pos, side in EDGES:
        x = np.asarray(encode(seq), np.int8)
        one = np.array([0], np.int64), np.array([len(x)], np.int64)
        p = _ref(x, *one)[pos]
        want = {1: np.nextafter(p_mask, np.float32(2)), 0: p_mask,
                -1: np.nextafter(p_mask, np.float32(0))}[side]
        assert p == want, (seq, p)
        assert _plain(x, *one)[pos] == p
        assert _native(x, *one)[pos] == p


def _block(seqs):
    return Block.from_sequences(seqs, [f"s{i}" for i in range(len(seqs))])


@pytest.fixture
def counters():
    was = log.enabled()
    log.enable(True)
    yield log.prof_calls
    log.enable(was)


def test_mask_block_on_cpu_keeps_the_native_scan(counters, monkeypatch):
    """On the CPU _mask_block runs the native scan, byte for byte
    diamond_tpu's, and counts its letters as host letters."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    seqs = CASES["mixed"]
    want = _block(seqs)
    probs = _ref(want.letters, want.starts, want.lengths)
    np.copyto(want.letters, MASK_LETTER, where=probs >= MASKER.p_mask)
    n = int(sum(len(s) for s in seqs))

    host = _block(seqs)
    h0, c0 = counters["mask.host_letters"], counters["mask.card_letters"]
    pipeline._mask_block(host, MASKER)
    assert np.array_equal(host.letters, want.letters)
    assert counters["mask.host_letters"] - h0 == n
    assert counters["mask.card_letters"] == c0
    assert host.unmasked is not None and host._tantan_masked
    pipeline._mask_block(host, MASKER)  # idempotent
    assert counters["mask.host_letters"] - h0 == n


def test_mask_block_device_argument_routes(counters, monkeypatch):
    """mask_block takes its device from the environment, as every route of
    a search does: "cpu" masks on the host, through the span's wrapper."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE", "cpu")
    blk = _block(CASES["lengths"])
    want = blk.letters.copy()
    probs = _ref(want, blk.starts, blk.lengths)
    np.copyto(want, MASK_LETTER, where=probs >= MASKER.p_mask)
    h0, c0 = counters["mask.host_letters"], counters["mask.card_letters"]
    pipeline.mask_block(blk, MASKER)
    assert np.array_equal(blk.letters, want)
    assert counters["mask.host_letters"] - h0 == int(blk.lengths.sum())
    assert counters["mask.card_letters"] == c0
    with pytest.raises(ValueError):  # the card's route takes only a card
        td.mask_letters(blk.letters.copy(), blk.starts, blk.lengths, MASKER,
                        "cpu")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(10, dtype=torch.int8)
    st, ln = torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.int64)
    params = td.scan_params(MASKER)
    with pytest.raises(TypeError):
        td.tantan_mask(x.int(), st, ln, params)
    with pytest.raises(TypeError):
        td.tantan_mask(x, st.int(), ln, params)
    with pytest.raises(ValueError):
        td.tantan_mask(x, st, torch.ones(2, dtype=torch.int64), params)
    with pytest.raises(ValueError):
        td.tantan_mask(x.view(2, 5), st, ln, params)
    with pytest.raises(ValueError):  # probabilities come from the kernel only
        td.tantan_mask(x, st, ln, params, probs=torch.zeros(10))
    with pytest.raises(ValueError):
        td.tantan_mask(x, st, ln, params, plan=(
            torch.zeros(1, dtype=torch.int32), st, td.MAX_LEN + 1, 1))
    with pytest.raises(TypeError):  # a plan's order is int32
        td.tantan_mask(x, st, ln, params, plan=(st, st, 1, 1))
    launches = td.tantan_mask.launches
    td.tantan_mask(x, st, ln, params)  # the CPU runs the plain version
    assert td.tantan_mask.launches == launches


def test_launch_plan_orders_longest_first():
    lens = np.array([5, 0, 300, 7, 40000, 300, 1, 2999], np.int64)
    order, scale_off, longest, n_letters = td.launch_plan(lens)
    assert order.dtype == np.int32 and scale_off.dtype == np.int64
    assert sorted(order.tolist()) == list(range(len(lens)))
    assert list(lens[order]) == sorted(lens, reverse=True)
    assert list(order[:4]) == [4, 7, 2, 5]  # ties keep their order
    per = (lens + 15) // 16
    assert list(scale_off) == list(np.cumsum(per) - per)
    assert (longest, n_letters) == (40000, int(lens.sum()))
    assert td.launch_plan(np.zeros(0, np.int64))[2:] == (0, 0)


def test_chunks_cover_every_sequence_longest_first():
    lens = np.array([5, 0, 300, 7, 300, 1, 2999], np.int64)
    got = list(td._chunks(lens, 600))
    flat = np.concatenate(got)
    assert sorted(flat.tolist()) == list(range(len(lens)))
    assert list(lens[flat]) == sorted(lens, reverse=True)
    assert all(len(c) * max(int(lens[c].max()), 1) <= 600 or len(c) == 1
               for c in got)
