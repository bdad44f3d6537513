"""The decode-sized q8_0 product's work split and shared-memory layout
(``ops.quant_matmul.q8_matvec_split``) on the CPU.

The kernel (``csrc/q8_matmul.cu`` ``q8_matvec_kernel``: K1 at m <= 16 and
K6, one kernel under two dot contracts) gives block b the contiguous rows
``[b n // blocks, (b + 1) n // blocks)``, requests them as a ring of
``rows``-row tiles by bulk asynchronous copies into the slots of the
layout the split gives, keeps the activation rows, two buffers of partial
tiles and the ring's mbarriers beside the ring, and shares each tile's
8-row subtiles out to its eight warps as slices of their 64-column spans.
These tests hold the split and the layout to what the kernel relies on:
every row in one block, row counts that differ by at most one, 16-byte
aligned copies where k % 128 == 0, the whole within the H100's shared
memory at the blocks an SM it is sized for (m = 1 ... 16, both contracts,
k from 32 to 3072 and the 152576-row head), work for every warp, a pure
function, and a refusal of what the kernel does not take.
"""

import pytest

from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

SMS = 132                                   # the H100's SMs
WARPS = tqm.K4_WARPS
# (n, k): the card tests' ragged widths, Qwen3-0.6B's decoder matrices
# (qkv packed, o, gate_up packed, down) and the head
SHAPES = {"k32": (61, 32), "k96": (200, 96), "qkv": (4096, 1024),
          "o": (1024, 2048), "gate_up": (6144, 1024), "down": (1024, 3072),
          "head": (152576, 1024)}
QWEN3 = ("qkv", "o", "gate_up", "down", "head")
CONTRACTS = {"k1": False, "k6": True}


def _split(shape, m, contract, per_sm=None):
    n, k = SHAPES[shape]
    per_sm = per_sm or tqm.matvec_blocks_per_sm(n, SMS)[0]
    return tqm.q8_matvec_split(n, k, m, per_sm * SMS, CONTRACTS[contract],
                               per_sm), n, k


def _ranges(split):
    s = split.starts.tolist()
    return list(zip(s[:-1], s[1:]))


def _tiles(split, lo, hi):
    """The block's ring tiles: (slot, first row, rows)."""
    lay = split.layout
    r = lay["rows"]
    return [(t % lay["depth"], lo + t * r, min(r, hi - lo - t * r))
            for t in range(-(-(hi - lo) // r))]


def _items(rows, k):
    """The kernel's items of a tile of ``rows`` rows (q8_matvec_kernel
    item_of): warp -> (8-row subtile, first span, end span)."""
    nsub, ns = -(-rows // 8), -(-k // tqm.K4_SPAN)
    out = []
    for it in range(WARPS):
        sub = it * nsub // WARPS
        f0 = (sub * WARPS + nsub - 1) // nsub
        f1 = ((sub + 1) * WARPS + nsub - 1) // nsub
        out.append((sub, (it - f0) * ns // (f1 - f0),
                    (it - f0 + 1) * ns // (f1 - f0)))
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("m", [1, 9])
def test_split_covers_every_row_once(shape, m):
    split, n, _ = _split(shape, m, "k1")
    s = split.starts.tolist()
    assert len(s) == split.blocks + 1 == split.per_sm * SMS + 1
    assert s[0] == 0 and s[-1] == n and all(a <= b for a, b in zip(s, s[1:]))
    # the kernel's own rule for block b's first row
    assert s == [b * n // split.blocks for b in range(split.blocks + 1)]
    rows = [r for lo, hi in _ranges(split)
            for _, r0, cnt in _tiles(split, lo, hi)
            for r in range(r0, r0 + cnt)]
    assert rows == list(range(n))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("m", [1, 2, 9, 16])
def test_split_row_counts_differ_by_at_most_one(shape, m):
    split, _, _ = _split(shape, m, "k6")
    counts = [hi - lo for lo, hi in _ranges(split)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("shape", ["qkv", "o", "down", "head", "k96"])
@pytest.mark.parametrize("m", [1, 9])
def test_split_bulk_copies_are_16_byte_aligned(shape, m, contract):
    """Each tile's int8 rows (and, where k % 128 == 0, its f32 scales) go
    by one bulk copy each: source offsets, destination offsets and sizes
    in whole 16-byte words. Elsewhere the scales go by plain loads."""
    split, _, k = _split(shape, m, contract)
    lay = split.layout
    assert lay["ring"] % 16 == 0 and lay["slot"] % 16 == 0
    for lo, hi in _ranges(split)[:3] + _ranges(split)[-3:]:
        for slot, r0, rows in _tiles(split, lo, hi):
            dst = lay["ring"] + slot * lay["slot"]
            assert (r0 * k) % 16 == 0 and (rows * k) % 16 == 0
            assert dst % 16 == 0 and (dst + rows * k) % 16 == 0
            assert rows * (k + k // 8) <= lay["slot"]
            if k % 128 == 0:
                assert (r0 * k // 8) % 16 == 0 and (rows * k // 8) % 16 == 0


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("shape", ["k32", "k96", "qkv", "o", "down",
                                   "head"])
@pytest.mark.parametrize("m", list(range(1, 17)))
def test_split_fits_the_cards_shared_memory(m, shape, contract, per_sm):
    """The activation rows, two partial-tile buffers, the mbarriers and
    their counts, and the ring, in that order, within a block's 227 KB,
    and the blocks an SM the split is sized for within the SM's 228 KB
    (1 KB reserved for each); the ring two slots deep where a block has
    more than one tile."""
    split, n, k = _split(shape, m, contract, per_sm)
    lay = split.layout
    assert split.per_sm == per_sm
    assert split.smem <= tqm.K4_SMEM_BLOCK
    assert per_sm * (split.smem + tqm.K4_SMEM_RESERVED) <= tqm.K4_SMEM_SM
    if CONTRACTS[contract]:
        x_bytes = tqm.k7_activation_bytes(max(m, 2), lay["xcols"])[1]
    else:
        x_bytes = m * (2 * lay["xcols"] + 16)
    assert lay["x"] == 0 and lay["red"] >= x_bytes
    stride = 128 if m > 8 else 64     # floats of a warp's partial tile
    assert lay["bars"] - lay["red"] >= 2 * 4 * WARPS * stride
    assert lay["ring"] - lay["bars"] >= tqm.K1_MISC
    assert lay["bars"] % 8 == 0
    assert split.smem == lay["ring"] + lay["depth"] * lay["slot"]
    most = -(-n // split.blocks)
    tiles = -(-most // lay["rows"])
    assert 1 <= lay["rows"] <= 8 * WARPS
    assert 1 <= lay["depth"] <= min(tiles, tqm.K1_MAX_DEPTH)
    assert lay["depth"] >= min(2, tiles)


@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16])
def test_split_sizes_the_activation_rows_and_partial_tiles(m, contract):
    """m rows of whole 64-column spans (K1 bf16 padded by 16 bytes, so the
    mma fragment loads are conflict-free; K6 q8_0 padded by 32), never cut
    into column chunks at Qwen3-0.6B's widths; eight warps' partial tiles
    (8 activation rows a tile at m <= 8, 16 above: the kernel's two
    modes)."""
    for shape in QWEN3:
        split, _, k = _split(shape, m, contract)
        lay = split.layout
        assert lay["xcols"] % tqm.K4_SPAN == 0 and lay["xcols"] >= k
        if CONTRACTS[contract]:
            assert lay["xstride"] == lay["xcols"] + 32
        else:
            assert lay["xstride"] == 2 * lay["xcols"] + 16
            assert lay["xstride"] % 32 == 16
        assert lay["bars"] - lay["red"] == 2 * 4 * WARPS * (
            128 if m > 8 else 64)


@pytest.mark.parametrize("rows", list(range(1, 65)))
def test_items_give_every_warp_work_and_every_column_once(rows):
    """Whatever a tile's rows, the eight warps' items cover each of its
    8-row subtiles' spans once, in slice order, and every warp has spans;
    a 64-row tile gives each warp one whole subtile."""
    for k in (96, 1024, 3072):
        items = _items(rows, k)
        ns = -(-k // tqm.K4_SPAN)
        for sub in range(-(-rows // 8)):
            spans = [(a, b) for s, a, b in items if s == sub]
            assert spans and spans[0][0] == 0 and spans[-1][1] == ns
            assert all(p[1] == q[0] for p, q in zip(spans, spans[1:]))
        assert all(b > a for _, a, b in items) or ns < WARPS
        if rows == 64:
            assert [s for s, _, _ in items] == list(range(WARPS))


@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("m", [1, 9])
def test_split_gives_every_warp_work_at_qwen3_widths(m, contract):
    """Every tile of every block hands each warp spans of a subtile: o and
    down have 7-8 rows a block (one block an SM), gate_up 23-24."""
    for shape in QWEN3:
        split, _, k = _split(shape, m, contract)
        for lo, hi in _ranges(split):
            for _, _, rows in _tiles(split, lo, hi):
                assert all(b > a for _, a, b in _items(rows, k)), (shape,
                                                                   rows)


def test_split_streams_the_head_through_a_ring():
    """The head's ~578 rows a block (two blocks an SM) arrive as 32-row
    tiles through a ring that wraps: more tiles than slots."""
    for m in (1, 2, 9, 16):
        for contract in CONTRACTS:
            split, n, _ = _split("head", m, contract)
            lay = split.layout
            assert split.per_sm == 2 and lay["rows"] == 32
            tiles = -(-(-(-n // split.blocks)) // lay["rows"])
            assert 2 <= lay["depth"] < tiles


def test_blocks_an_sm_give_each_block_a_subtile():
    assert tqm.matvec_blocks_per_sm(152576, SMS) == (2, 1)
    assert tqm.matvec_blocks_per_sm(4096, SMS) == (2, 1)
    assert tqm.matvec_blocks_per_sm(1024, SMS) == (1, 2)   # o, down
    assert tqm.matvec_blocks_per_sm(2 * SMS * 8, SMS) == (2, 1)
    assert tqm.matvec_blocks_per_sm(2 * SMS * 8 - 1, SMS) == (1, 2)


@pytest.mark.parametrize("contract,m,k", [("k1", 8, 16384), ("k1", 16, 8192),
                                          ("k1", 1, 65536),
                                          ("k6", 16, 16384),
                                          ("k6", 8, 32768)])
def test_split_takes_wide_rows_in_column_chunks(contract, m, k):
    """Where m rows of k columns leave the ring no room, they are taken in
    chunks of whole 64-column spans, the ring still in place."""
    split = tqm.q8_matvec_split(300, k, m, SMS, q8i=CONTRACTS[contract],
                                per_sm=1)
    lay = split.layout
    assert lay["xcols"] < k and lay["xcols"] % tqm.K4_SPAN == 0
    assert split.smem <= tqm.K4_SMEM_BLOCK and lay["depth"] >= 1


@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("shape,m", [("head", 1), ("qkv", 9), ("k96", 16)])
def test_split_is_a_pure_function(shape, m, contract):
    a, _, _ = _split(shape, m, contract)
    b, _, _ = _split(shape, m, contract)
    assert a.layout == b.layout and a.smem == b.smem and a.per_sm == b.per_sm
    assert a.starts.tolist() == b.starts.tolist()
    assert list(a.layout) == list(tqm.K1_LAYOUT)


def test_split_refuses_what_the_kernel_does_not_take():
    for m in (0, 17):
        with pytest.raises(ValueError):
            tqm.q8_matvec_split(4096, 1024, m, SMS)
    for n, k in ((0, 1024), (4096, 48), (4096, 0)):
        with pytest.raises(ValueError):
            tqm.q8_matvec_split(n, k, 1, 2 * SMS)
    with pytest.raises(ValueError):                  # no block an SM
        tqm.q8_matvec_split(4096, 1024, 1, SMS, per_sm=0)
    for q8i in (False, True):                        # no layout fits
        with pytest.raises(ValueError):
            tqm.q8_matvec_split(8, 1 << 18, 1, SMS, q8i=q8i, per_sm=1)


# ------------------------------------------------- the prefill GEMM's plan

GEMM_SHAPES = [(m, n, k) for m in (17, 63, 64, 65, 129, 200, 256, 512, 700)
               for n, k in ((4096, 1024), (1024, 2048), (6144, 1024),
                            (1024, 3072), (8, 32), (1000, 96))]


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_plan_covers_every_row_and_fits_the_kernel(m, n, k):
    # x panels of 64 or 128 rows, none empty; every weight row in a tile;
    # k split into a power of two of clusters' blocks (a portable cluster)
    # that keep whole stages and fit one wave, or no split at all
    p = tqm.q8_gemm_plan(m, n, k, SMS)
    assert p.rows in tqm.GEMM_PANELS and p.panels * p.rows >= m
    assert (p.panels - 1) * p.rows < m
    assert p.tiles * tqm.GEMM_ROWS >= n > (p.tiles - 1) * tqm.GEMM_ROWS
    assert p.splits in (1, 2, 4) and p.splits <= tqm.GEMM_MAX_SPLITS
    stages = -(-k // tqm.GEMM_STEP)
    assert p.splits == 1 or (p.blocks <= SMS and stages // p.splits
                             >= tqm.GEMM_MIN_SPLIT_STAGES)
    assert p.rows % p.splits == 0 and p.rows // p.splits >= 8


@pytest.mark.parametrize("m,want", [
    # Qwen3-0.6B's qkv, o, gate_up, down: (panel rows, panels, splits)
    (256, [(128, 2, 2), (128, 2, 4), (128, 2, 1), (128, 2, 4)]),
    (512, [(128, 4, 1), (128, 4, 4), (128, 4, 1), (128, 4, 4)]),
])
def test_gemm_plan_at_the_prefill_buckets(m, want):
    got = [tuple(tqm.q8_gemm_plan(m, n, k, SMS))[:3]
           for n, k in ((4096, 1024), (1024, 2048), (6144, 1024),
                        (1024, 3072))]
    assert got == want
