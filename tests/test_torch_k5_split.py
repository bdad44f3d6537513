"""K5's work split (``ops.quant_matmul.q8_decode_all_split``) on the CPU.

The kernel (``csrc/q8_decode_all.cu`` on ``csrc/q8_stream.cuh``) streams
each block's slab of every layer matrix, and the head in tiles, by bulk
asynchronous copies into a shared-memory ring sized by the split. The
copies below are the ones ``q8_stream.cuh`` ``request`` issues for a slab
(the int8 rows, then their f32 scales) and ``request_pairs`` for
gate_up's (its gate rows, then the same up rows, in two halves); these
tests hold them to what the kernel relies on, at
Qwen3-0.6B's widths on the H100's grids of two and of one block an SM
(264, 132) and at the small widths of ``tests/test_torch_cuda.py``.
"""

import math

import pytest

from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

QWEN3 = dict(h=1024, qd=2048, ffn=3072, kh=8, vp=152576)
SMALL = dict(h=256, qd=512, ffn=512, kh=2, vp=2048)
CASES = [(QWEN3, 264), (QWEN3, 132), (SMALL, 264), (SMALL, 132)]
IDS = ["qwen3-264", "qwen3-132", "small-264", "small-132"]
# a block's bytes of one matrix against the mean over the grid: the rows
# split evenly, so the largest slab is at most one row over the mean
BALANCE = 1.05
WARPS = 8   # q8_gemv.cuh kWarps


def _rows(w):
    nq = w["qd"] + 2 * w["kh"] * tqm.MEGA_HEAD_DIM
    return dict(qkv=nq, o=w["h"], gate_up=w["ffn"], down=w["h"],
                head=w["vp"])


def _ranges(split, m):
    s = split.starts[m].tolist()
    return list(zip(s[:-1], s[1:]))


def _copies(split, m, lo, n, ffn):
    """The bulk copies ``request`` makes of the slab of rows [lo, lo + n)
    of MEGA_MATS[m] (gate_up: ``request_pairs``, its gate and up rows in
    two halves of pairs): (segment, source byte offset, bytes, slot offset)
    with the q and d tensors' bases at 0."""
    k = split.widths[m]
    pair = ffn if tqm.MEGA_MATS[m] == "gate_up" else 0
    parts = 2 if pair else 1
    halves = [(0, n // 2), (n // 2, n)] if pair else [(0, n)]
    out = []
    for a, b in halves:
        if b == a:
            continue
        for p in range(parts):
            row = lo + a + p * pair
            at = p * n + a
            out.append(("q", row * k, (b - a) * k, at * k))
            out.append(("d", row * (k // 32) * 4, (b - a) * (k // 8),
                        n * parts * k + at * (k // 8)))
    return out


def _all_copies(split, m, ffn):
    """Every copy of MEGA_MATS[m] over the grid with its block and slab
    rows; the head's in tiles of ``head_rows``."""
    out = []
    for b, (lo, hi) in enumerate(_ranges(split, m)):
        if tqm.MEGA_MATS[m] == "head":
            for r0 in range(lo, hi, split.head_rows):
                n = min(split.head_rows, hi - r0)
                out += [(b, n, c) for c in _copies(split, m, r0, n, ffn)]
        else:
            n = hi - lo
            rows = 2 * n if tqm.MEGA_MATS[m] == "gate_up" else n
            out += [(b, rows, c) for c in _copies(split, m, lo, n, ffn)]
    return out


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_tiles_every_matrix_in_contiguous_row_ranges(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    rows = _rows(w)
    assert split.blocks == blocks
    assert tuple(split.starts.shape) == (len(tqm.MEGA_MATS), blocks + 1)
    for m, name in enumerate(tqm.MEGA_MATS):
        s = split.starts[m].tolist()
        assert s[0] == 0 and s[-1] == (rows[name] if name != "gate_up"
                                       else w["ffn"])
        assert all(a <= b for a, b in zip(s, s[1:]))


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_copies_every_weight_byte_exactly_once(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    rows = _rows(w)
    for m, name in enumerate(tqm.MEGA_MATS):
        k = split.widths[m]
        n_rows = 2 * w["ffn"] if name == "gate_up" else rows[name]
        for seg, total in (("q", n_rows * k), ("d", n_rows * k // 32 * 4)):
            spans = sorted((src, src + nb) for _, _, (s, src, nb, _)
                           in _all_copies(split, m, w["ffn"]) if s == seg)
            assert spans[0][0] == 0 and spans[-1][1] == total, (name, seg)
            for (_, end), (start, _) in zip(spans, spans[1:]):
                assert start == end, (name, seg, end, start)


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_copies_whole_q8_blocks_aligned_to_16_bytes(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    for m, name in enumerate(tqm.MEGA_MATS):
        k = split.widths[m]
        assert k % tqm.MEGA_WIDTH_MULTIPLE == 0
        for _, _, (seg, src, nb, dst) in _all_copies(split, m, w["ffn"]):
            assert src % 16 == 0 and nb % 16 == 0 and dst % 16 == 0, (
                name, seg, src, nb, dst)
            if seg == "q":      # whole rows, so whole 32-value blocks
                assert src % k == 0 and nb % k == 0 and nb % 32 == 0
            else:               # the scales of whole rows
                assert src % (k // 8) == 0 and nb % (k // 8) == 0


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_keeps_gate_row_j_with_up_row_j(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    m = tqm.MEGA_MATS.index("gate_up")
    k = split.widths[m]
    for lo, hi in _ranges(split, m):
        n = hi - lo
        for _, src, nb, dst in (c for c in _copies(split, m, lo, n, w["ffn"])
                                if c[0] == "q"):
            # slab row r < n is gate row lo + r, slab row n + r up row f +
            # lo + r: the same output column j = lo + r
            rows = range(dst // k, (dst + nb) // k)
            for r, src_row in zip(rows, range(src // k, (src + nb) // k)):
                if r < n:
                    assert src_row == lo + r
                else:
                    assert src_row == w["ffn"] + lo + r - n


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_slabs_fit_their_ring_slots(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    slot = dict(qkv=split.slot0, gate_up=split.slot0, o=split.slot1,
                down=split.slot1,
                head=tqm.mega_slab_bytes(split.head_rows, w["h"]))
    for m, name in enumerate(tqm.MEGA_MATS):
        k = split.widths[m]
        per_slab = {}
        for b, rows, (_, _, nb, dst) in _all_copies(split, m, w["ffn"]):
            assert dst + nb <= slot[name], (name, b)
            per_slab[b, rows] = per_slab.get((b, rows), 0) + nb
        for (b, rows), nb in per_slab.items():
            if name != "head":
                assert nb == tqm.mega_slab_bytes(rows, k) <= slot[name]
            # the unit sums of a slab or tile fit one buffer
            assert rows * math.ceil(k / tqm.MEGA_UNIT_COLS) <= split.red


@pytest.mark.parametrize("w,blocks", CASES, ids=IDS)
def test_split_balances_bytes_across_blocks(w, blocks):
    split = tqm.q8_decode_all_split(**w, blocks=blocks)
    for m, name in enumerate(tqm.MEGA_MATS):
        k = split.widths[m]
        pair = 2 if name == "gate_up" else 1
        got = [tqm.mega_slab_bytes(pair * (hi - lo), k)
               for lo, hi in _ranges(split, m)]
        mean = sum(got) / blocks
        assert max(got) - min(got) <= tqm.mega_slab_bytes(pair, k), name
        assert max(got) <= BALANCE * mean, (name, max(got), mean)


def test_split_gives_every_warp_work_in_every_stage_at_qwen3_widths():
    """o and down have 1024 rows, 3 or 4 a block on 264 blocks: the units
    of a slab (rows x 512-column chunks) still outnumber the warps."""
    for blocks in (264, 132):
        split = tqm.q8_decode_all_split(**QWEN3, blocks=blocks)
        for m, name in enumerate(tqm.MEGA_MATS[:4]):
            units = math.ceil(split.widths[m] / tqm.MEGA_UNIT_COLS)
            pair = 2 if name == "gate_up" else 1
            least = min(hi - lo for lo, hi in _ranges(split, m))
            assert pair * least * units >= WARPS, (name, blocks)


def test_split_ring_fits_two_blocks_an_sm_at_qwen3_widths():
    """The ring's two slots at 264 blocks: 27 KB (gate_up, 12 pairs of
    1024-wide rows) and 13.5 KB (down, 4 rows of 3072), beside the
    attention stage's ~48 KB; two blocks an SM then fit the H100's 228
    KB."""
    split = tqm.q8_decode_all_split(**QWEN3, blocks=264)
    assert split.slot0 == tqm.mega_slab_bytes(24, 1024) == 27648
    assert split.slot1 == tqm.mega_slab_bytes(4, 3072) == 13824
    assert split.red == 24 * 2
