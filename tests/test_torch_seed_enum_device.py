"""The query-indexed route's DB-side seed enumeration on the card's route
(``ops/seed_enum_device``) on the CPU: the plain PyTorch version of the
kernel against diamond_tpu's native fused pass
(``diamond_tpu.native.enumerate_seeds_filtered_native`` with diamond_tpu's
reduction and shapes) and diamond_tpu's sliced route
(``stages.enumerate_seeds_range`` and ``native.filter_keys_native``), key
for key and position for position, in order; the port's native fused pass
(the kernel's reference on the card, where diamond_tpu does not run)
against the same; the port's reductions and shapes against diamond_tpu's;
the kernel's reduction table against ``Reduction.__call__``; the routing
of ``search/pipeline._enumerate_t_qindex``; what the wrappers refuse.  The
kernel itself runs in ``tests/test_torch_gpu.py``."""
import os
import sys

import numpy as np
import pytest
import torch

from diamond_tpu_torch import native
from diamond_tpu_torch.constants.alphabet import (DELIMITER_LETTER,
                                                 MASK_LETTER, STOP_LETTER,
                                                 encode)
from diamond_tpu_torch.data.block import Block
from diamond_tpu_torch.masking.motifs import MOTIF_LEN, motif_keys
from diamond_tpu_torch.ops import seed_enum_device as sed
from diamond_tpu_torch.output.tabular import format_results
from diamond_tpu_torch.search import pipeline, stages
from diamond_tpu_torch.search.config import SearchConfig
from diamond_tpu_torch.seed import reduction as red_mod
from diamond_tpu_torch.seed.shapes import SHAPE_CODES, Shape
from diamond_tpu_torch.stats.score_matrix import ScoreMatrix
from diamond_tpu_torch.utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RED = red_mod.MURPHY10
# both default shapes (spans 12 and 15) and a mid-sensitive one (span 13)
SHAPES = SHAPE_CODES["default"] + [SHAPE_CODES["mid-sensitive"][1]]
LENGTHS = (0, 1, 10, 11, 12, 13, 14, 15, 16, 31, 300)


def _gen():
    sys.path.insert(0, os.path.join(REPO, "perfbench"))
    try:
        import gen
    finally:
        sys.path.remove(os.path.join(REPO, "perfbench"))
    return gen


def _layout(seqs, rng, gaps=(1, 6)):
    """(letters, starts, lens) of int8 letter arrays: 1-5 delimiters before
    each sequence and after the last (``gaps``: the range of their count)."""
    parts, starts, pos = [], [], 0
    for s in seqs:
        gap = int(rng.integers(*gaps))
        parts.append(np.full(gap, DELIMITER_LETTER, np.int8))
        pos += gap
        starts.append(pos)
        parts.append(np.asarray(s, np.int8))
        pos += len(s)
    parts.append(np.full(3, DELIMITER_LETTER, np.int8))
    return (np.concatenate(parts), np.array(starts, np.int64),
            np.array([len(s) for s in seqs], np.int64))


def _motif_seqs(rng, n=40):
    """Sequences holding one of the motif 8-mers, so that the motif ranges
    of the pipeline find something to mask."""
    motif = int(motif_keys()[7])
    word = [(motif // 20 ** (MOTIF_LEN - 1 - i)) % 20 for i in range(MOTIF_LEN)]
    out = []
    for _ in range(n):
        s = rng.integers(0, 20, int(rng.integers(40, 200))).astype(np.int8)
        at = int(rng.integers(0, len(s) - MOTIF_LEN))
        s[at:at + MOTIF_LEN] = word
        out.append(s)
    return out


def _cases():
    rng = np.random.default_rng(20)
    proteins = [encode(s) for _, s in _gen().make_proteins(
        150, 40, seed=3, size_seed=2500)]
    by_len = [rng.integers(0, 20, n).astype(np.int8) for n in LENGTHS * 3]
    # masked and high-bit letters: MASK, STOP, and bytes with bit 7 set
    odd = []
    for n in (20, 40, 80, 160):
        s = rng.integers(0, 20, n).astype(np.int8)
        at = rng.choice(n, n // 6, replace=False)
        s[at] = rng.choice(np.array([MASK_LETTER, STOP_LETTER, -1, -128,
                                     -100, 31, 25], np.int8), len(at))
        odd.append(s)
    cases = {
        "generator": _layout(proteins, rng),
        "lengths": _layout(by_len, rng),
        "masked": _layout(odd + by_len[:11], rng),
        "motif": "motif",
    }
    blk = Block.from_sequences(_motif_seqs(rng), [str(i) for i in range(40)])
    ranges = pipeline.motif_mask_ranges(blk)
    assert ranges  # the planted 8-mers are found
    pipeline.apply_ranges(blk.letters, ranges)
    cases["motif"] = (blk.letters, blk.starts, blk.lengths.astype(np.int64))
    return cases


CASES = _cases()


def _all_keys(letters, starts, lens, shape):
    blk = Block(letters, starts, lens.astype(np.int32), [])
    return stages.enumerate_seeds(blk, shape, RED)[0]


def _queries(letters, starts, lens, shape, rng, kind):
    """Query keys: some of the block's own keys (duplicated), some random."""
    if kind == "empty":
        return np.zeros(0, np.uint64)
    own = _all_keys(letters, starts, lens, shape)
    picks = rng.choice(own, min(len(own), 300)) if len(own) else own
    rand = rng.integers(0, RED.size ** shape.weight, 200).astype(np.uint64)
    q = np.concatenate([picks, picks[:50], rand])
    return q if kind == "unsorted" else np.sort(q)


def _ref():
    """diamond_tpu's modules: the reference side (imported here, so that
    tests/test_torch_gpu.py can take this module's cases on a card host)."""
    from diamond_tpu import native as ref_native
    from diamond_tpu.data.block import Block as RefBlock
    from diamond_tpu.search import stages as ref_stages
    from diamond_tpu.seed import reduction as ref_reduction
    from diamond_tpu.seed import shapes as ref_shapes

    return ref_native, RefBlock, ref_stages, ref_reduction, ref_shapes


def _ref_native(letters, starts, lens, code, qs):
    """diamond_tpu's fused pass with diamond_tpu's MURPHY10 and shape."""
    ref_native, _, _, ref_reduction, ref_shapes = _ref()
    red, shape = ref_reduction.MURPHY10, ref_shapes.Shape(code)
    return ref_native.enumerate_seeds_filtered_native(
        red(letters), starts, lens,
        np.ascontiguousarray(shape.positions, np.int64), shape.weight,
        shape.length, red.size, 0, np.sort(qs))


def _ref_sliced(letters, starts, lens, code, qs):
    """diamond_tpu's sliced route: every seed, then the key probe."""
    ref_native, RefBlock, ref_stages, ref_reduction, ref_shapes = _ref()
    red, shape = ref_reduction.MURPHY10, ref_shapes.Shape(code)
    blk = RefBlock(letters, starts, lens.astype(np.int32), [])
    k, p = ref_stages.enumerate_seeds_range(blk, shape, red, red(letters), 0,
                                            len(starts))
    if len(qs) == 0 or len(k) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    keep = ref_native.filter_keys_native(k, np.sort(qs))
    return k[keep], p[keep]


def _port_native(letters, starts, lens, shape, qs):
    """The port's fused pass: the kernel's reference on the card."""
    pos64 = np.ascontiguousarray(shape.positions, np.int64)
    return native.enumerate_seeds_filtered_native(
        RED(letters), starts, lens, pos64, shape.weight, shape.length,
        RED.size, 0, np.sort(qs))


def _plain(letters, starts, lens, shape, qs):
    keys, pos = sed.enumerate_filtered(
        torch.from_numpy(letters), torch.from_numpy(sed.reduce_table(RED)),
        torch.from_numpy(starts), torch.from_numpy(lens),
        torch.from_numpy(shape.positions.astype(np.int32)), shape.length,
        RED.size, torch.from_numpy(np.asarray(qs, np.uint64).view(np.int64)))
    return keys.numpy().view(np.uint64), pos.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("code", SHAPES)
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "empty"])
def test_plain_equals_native_and_sliced(name, code, kind):
    letters, starts, lens = CASES[name]
    shape = Shape(code)
    rng = np.random.default_rng(len(name) * 7 + len(code))
    qs = _queries(letters, starts, lens, shape, rng, kind)
    want = _ref_native(letters, starts, lens, code, qs)
    for got in (_ref_sliced(letters, starts, lens, code, qs),
                _port_native(letters, starts, lens, shape, qs),
                _plain(letters, starts, lens, shape, qs)):
        assert got[0].dtype == want[0].dtype == np.uint64
        assert got[1].dtype == want[1].dtype == np.int64
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    if kind == "empty":
        assert len(want[0]) == 0
    elif name in ("generator", "motif"):
        assert len(want[0]) > 100


def test_delimiter_on_a_zero_of_the_shape_forms_no_seed():
    """A window that runs past its sequence over one delimiter falling on a
    0 of the shape would read only valid letters; it is no seed, though its
    key is among the queries."""
    shape = Shape("111101110111")  # 0s at 4 and 8
    rng = np.random.default_rng(4)
    a = rng.integers(0, 20, 30).astype(np.int8)
    b = rng.integers(0, 20, 30).astype(np.int8)
    letters, starts, lens = _layout([a, b], rng, gaps=(1, 2))
    p = int(starts[0] + lens[0] - 4)  # the delimiter at the window's 4
    assert letters[p + 4] == DELIMITER_LETTER
    reduced = RED(letters)
    straddle = 0
    for c in shape.positions:
        straddle = straddle * RED.size + int(reduced[p + c])
    assert all(0 <= reduced[p + c] < RED.size for c in shape.positions)
    qs = np.array([straddle], np.uint64)
    want = _ref_native(letters, starts, lens, shape.code, qs)
    for got in (_plain(letters, starts, lens, shape, qs),
                _port_native(letters, starts, lens, shape, qs)):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert p not in set(want[1].tolist())


REDUCTIONS = ["MURPHY10", "STEINEGGER12", "NO_REDUCTION", "DNA"]


@pytest.mark.parametrize("name", REDUCTIONS)
def test_table_equals_the_reduction_on_every_byte(name):
    r = getattr(red_mod, name)
    table = sed.reduce_table(r)
    assert table.dtype == np.int8 and table.shape == (256,)
    every = np.arange(256, dtype=np.uint8).view(np.int8)
    for b in range(256):
        assert table[b] == r(every[b:b + 1])[0], b
    assert table[DELIMITER_LETTER] == table[MASK_LETTER] == MASK_LETTER
    assert (table[128:] == MASK_LETTER).all()  # bit 7 set


@pytest.mark.parametrize("name", REDUCTIONS)
def test_reductions_are_the_references(name):
    """The port's reduction equals diamond_tpu's on every byte, so the
    kernel's table is diamond_tpu's reduction too."""
    ref = getattr(_ref()[3], name)
    mine = getattr(red_mod, name)
    every = np.arange(256, dtype=np.uint8).view(np.int8)
    want = ref(every)
    assert want.dtype == np.int8 and ref.size == mine.size
    assert np.array_equal(mine(every), want)
    assert np.array_equal(sed.reduce_table(mine), want)


def test_shapes_are_the_references():
    ref_shapes = _ref()[4]
    assert SHAPE_CODES == ref_shapes.SHAPE_CODES
    for codes in SHAPE_CODES.values():
        for code in codes:
            a, b = Shape(code), ref_shapes.Shape(code)
            assert (a.length, a.weight) == (b.length, b.weight)
            assert np.array_equal(a.positions, b.positions)


def test_window_offsets_and_capacity():
    lens = np.array([0, 11, 12, 13, 300], np.int64)
    assert sed.window_offsets(lens, 12).tolist() == [0, 0, 0, 1, 3, 292]
    assert sed.window_offsets(np.zeros(0, np.int64), 12).tolist() == [0]
    assert [sed.hash_capacity(n) for n in (0, 1, 8, 9, 6000)] == \
        [16, 16, 16, 32, 16384]


@pytest.fixture
def counters():
    was = log.enabled()
    log.enable(True)
    yield log.prof_calls
    log.enable(was)


def _search_blocks(n_q=6, n_t=300):
    recs = _gen().make_proteins(300, 75, seed=8, size_seed=2500)
    qb = Block.from_sequences([s for _, s in recs[:n_q]],
                              [i for i, _ in recs[:n_q]])
    tb = Block.from_sequences([s for _, s in recs[:n_t]],
                              [i for i, _ in recs[:n_t]])
    return qb, tb


def test_cpu_search_keeps_the_native_pass(counters, monkeypatch):
    """device='cpu' on the query-indexed route: the host pass, its DB
    positions in seed.host_positions, nothing uploaded or launched."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE_DP", "0")
    qb, tb = _search_blocks()
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), algo="1")
    pipe = pipeline.Pipeline(cfg, qb, tb, device="cpu")
    assert pipe._query_indexed
    h0, c0 = counters["seed.host_positions"], counters["seed.card_positions"]
    u0, l0 = sed.upload_block.uploads, sed.enumerate_filtered.launches
    pipe.search()
    lens = tb.lengths.astype(np.int64)
    want = sum(int(np.maximum(lens - s.length + 1, 0).sum())
               for s in cfg.shapes.shapes)
    assert counters["seed.host_positions"] - h0 == want
    assert counters["seed.card_positions"] == c0
    assert sed.upload_block.uploads == u0
    assert sed.enumerate_filtered.launches == l0


@pytest.mark.parametrize("n_t", [30, 300])
def test_card_route_takes_blocks_of_min_letters(counters, monkeypatch, n_t):
    """With the device resolved to a card, the fused path goes to the card
    for a block of at least MIN_LETTERS letters, and a smaller block keeps
    the host pass (its positions in seed.host_positions, the native pass's
    keys and positions)."""
    from diamond_tpu_torch.utils import device as device_mod

    qb, tb = _search_blocks(n_t=n_t)
    big = len(tb.letters) >= sed.MIN_LETTERS
    assert big == (n_t == 300)
    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), algo="1")
    pipe = pipeline.Pipeline(cfg, qb, tb, device="cpu")
    card = []

    def card_route(self, shape, q_keys, table, dev):
        card.append(dev)
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)

    monkeypatch.setattr(device_mod, "resolve_device", lambda d=None: "cuda")
    monkeypatch.setattr(pipeline.Pipeline, "_enumerate_t_card", card_route)
    shape = cfg.shapes[0]
    qs = stages.enumerate_seeds(qb, shape, cfg.reduction)[0]
    h0, c0 = counters["seed.host_positions"], counters["seed.card_positions"]
    keys, pos = pipe._enumerate_t_qindex(shape, qs)
    lens = tb.lengths.astype(np.int64)
    windows = int(np.maximum(lens - shape.length + 1, 0).sum())
    assert card == (["cuda"] if big else [])
    assert counters["seed.host_positions"] - h0 == (0 if big else windows)
    assert counters["seed.card_positions"] == c0
    if not big:
        want = _port_native(tb.letters, tb.starts, lens, shape, qs)
        assert len(keys) > 0
        assert np.array_equal(keys, want[0]) and np.array_equal(pos, want[1])


def _cpu_stand_ins(monkeypatch):
    """upload_block and enumerate_block, which run on a card only, stood in
    by CPU tensors and enumerate_filtered (its plain version on the CPU);
    returns the list of the devices uploaded to."""
    uploads = []

    def upload_block(letters, starts, lens, table, base, device):
        uploads.append(device)
        lens = np.asarray(lens, np.int64)
        return sed.SeedBlock(torch.from_numpy(letters.copy()),
                             torch.from_numpy(np.asarray(starts, np.int64)),
                             torch.from_numpy(lens), torch.from_numpy(table),
                             lens, int(base))

    def enumerate_block(blk, shape_pos, span, q_keys):
        keys, pos = sed.enumerate_filtered(
            blk.letters, blk.table, blk.starts, blk.lens,
            torch.from_numpy(np.asarray(shape_pos, np.int32)), span,
            blk.base,
            torch.from_numpy(np.asarray(q_keys, np.uint64).view(np.int64)))
        return keys.numpy().view(np.uint64), pos.numpy()

    monkeypatch.setattr(sed, "upload_block", upload_block)
    monkeypatch.setattr(sed, "enumerate_block", enumerate_block)
    return uploads


def test_card_route_wiring_on_the_cpu(counters, monkeypatch):
    """_enumerate_t_card inside a whole search, the card's calls stood in
    on the CPU: every shape's keys and positions equal the host pass's,
    the letters (motif ranges applied) go up once a search to the device
    given, the DB positions land in seed.card_positions, and the results
    equal the host route's."""
    monkeypatch.setenv("DIAMOND_TPU_TORCH_DEVICE_DP", "0")
    qb, tb = _search_blocks()
    host_pass = pipeline.Pipeline._enumerate_t_qindex
    calls = []

    def card_route(self, shape, q_keys, slice_letters=4 << 20):
        want = host_pass(self, shape, q_keys)
        got = self._enumerate_t_card(shape, q_keys,
                                     sed.reduce_table(self.cfg.reduction),
                                     "cuda")
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        calls.append(len(got[0]))
        return got

    cfg = SearchConfig(matrix=ScoreMatrix("BLOSUM62"), algo="1")
    want = pipeline.Pipeline(cfg, qb, tb, device="cpu").search()
    uploads = _cpu_stand_ins(monkeypatch)
    monkeypatch.setattr(pipeline.Pipeline, "_enumerate_t_qindex", card_route)
    qb2, tb2 = _search_blocks()
    pipe = pipeline.Pipeline(cfg, qb2, tb2, device="cpu")
    c0 = counters["seed.card_positions"]
    got = pipe.search()
    assert len(calls) == len(cfg.shapes) and sum(calls) > 0
    assert uploads == ["cuda"]
    lens = tb.lengths.astype(np.int64)
    assert counters["seed.card_positions"] - c0 == sum(
        int(np.maximum(lens - s.length + 1, 0).sum())
        for s in cfg.shapes.shapes)
    assert pipe._t_card is None  # dropped after the shapes
    assert got and list(format_results(got, qb2, tb2, matrix=cfg.matrix)) \
        == list(format_results(want, qb, tb, matrix=cfg.matrix))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(40, dtype=torch.int8)
    tab = torch.from_numpy(sed.reduce_table(RED))
    st = torch.zeros(1, dtype=torch.int64)
    ln = torch.full((1,), 40, dtype=torch.int64)
    sp = torch.arange(4, dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int64)

    def call(**kw):
        a = dict(letters=x, table=tab, starts=st, lens=ln, shape_pos=sp,
                 span=4, base=RED.size, q_keys=q)
        a.update(kw)
        return sed.enumerate_filtered(**a)

    with pytest.raises(TypeError):
        call(letters=x.int())
    with pytest.raises(TypeError):
        call(starts=st.int())
    with pytest.raises(TypeError):
        call(q_keys=q.int())
    with pytest.raises(TypeError):
        call(shape_pos=sp.long())
    with pytest.raises(ValueError):  # not contiguous
        call(letters=torch.zeros(80, dtype=torch.int8)[::2])
    with pytest.raises(ValueError):  # another device
        call(table=torch.zeros(256, dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError):
        call(lens=torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        call(letters=x.view(4, 10))
    with pytest.raises(ValueError):
        call(table=tab[:128])
    with pytest.raises(ValueError):  # a shape of more than 32 letters
        call(shape_pos=torch.arange(33, dtype=torch.int32), span=33)
    with pytest.raises(ValueError):  # a position past the span
        call(span=3)
    table = sed.reduce_table(RED)
    for dev in ("cpu", "meta"):  # upload_block and enumerate_block: a card
        with pytest.raises(ValueError):
            sed.upload_block(x.numpy(), st.numpy(), ln.numpy(), table,
                             RED.size, dev)
    cpu_blk = sed.SeedBlock(x, st, ln, tab, ln.numpy(), RED.size)
    with pytest.raises(ValueError):
        sed.enumerate_block(cpu_blk, sp.numpy(), 4, np.zeros(1, np.uint64))
    with pytest.raises(TypeError):
        sed.upload_block(x.numpy(), st.numpy(), ln.numpy(),
                         table.astype(np.int16), RED.size, "cuda")
    with pytest.raises(ValueError):  # a sequence past the letters
        sed.upload_block(x.numpy(), st.numpy(), ln.numpy() + 1, table,
                         RED.size, "cuda")
    launches = sed.enumerate_filtered.launches
    call()  # the CPU runs the plain version
    assert sed.enumerate_filtered.launches == launches
