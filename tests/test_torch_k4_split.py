"""K4's and K7's work split and shared-memory layout
(``ops.quant_matmul.q8_layer_fused_split``) on the CPU.

The kernel (``csrc/q8_layer_fused.cu`` on ``csrc/q8_stream.cuh``) copies
each block's slab of o, gate_up (its gate rows, then the same up rows),
down and the next qkv by bulk asynchronous copies into the slots of the
layout the split gives, or streams K4c's head through a ring of tiles
from gate_up's slot. These tests hold the table and the layout to what
the kernel relies on: every row copied once, gate row j beside up row j,
rows balanced, slabs inside their slots, slots that overlap only where
the kernel requests the later slab after the earlier one's stage, and
the whole within the H100's shared memory at the blocks an SM the split
is sized for, at Qwen3-0.6B's widths (m = 1, 9, 16 and the other
classes' edges, K4a, K4b and K4c) and at the card tests' widths. K7
(``q8i=True``, the same kernel under the int8-dot contract) takes the
same split with q8_0 activation rows; its cases are the ``q8i*`` widths.
"""

import pytest

from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

SMS = 132                                   # the H100's SMs
QWEN3 = dict(h=1024, qd=2048, ffn=3072, nq=4096)
HEAD = dict(QWEN3, nq=152576)
LAST = dict(QWEN3, nq=0)                    # K4b: no qkv stage
SMALL = dict(h=256, qd=512, ffn=384, nq=640)      # tests/test_torch_cuda.py
RAGGED = dict(SMALL, ffn=416)               # scales not whole 16-byte words
SMALL_HEAD = dict(SMALL, nq=1536)
WIDTHS = dict(qwen3=(QWEN3, False), head=(HEAD, True), last=(LAST, False),
              small=(SMALL, False), ragged=(RAGGED, False),
              small_head=(SMALL_HEAD, True),
              # K7: K4a's / K4b's widths and the card tests' (K7_SMALL)
              q8i=(QWEN3, False), q8i_last=(LAST, False),
              q8i_small=(dict(h=256, qd=512, ffn=384, nq=640), False),
              q8i_ragged=(RAGGED, False))
CASES = [(w, m) for w in WIDTHS for m in (1, 2, 8, 9, 16)]
IDS = [f"{w}-m{m}" for w, m in CASES]


def _split(name, m):
    w, head = WIDTHS[name]
    per_sm = 2 if m == 1 else 1
    return tqm.q8_layer_fused_split(**w, m=m, blocks=per_sm * SMS,
                                    head=head,
                                    q8i=name.startswith("q8i")), w, head


def _ranges(split, i):
    s = split.starts[i].tolist()
    return list(zip(s[:-1], s[1:]))


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_covers_every_row_once(name, m):
    split, w, _ = _split(name, m)
    rows = dict(o=w["h"], gate_up=w["ffn"], down=w["h"], qkv=w["nq"])
    assert tuple(split.starts.shape) == (len(tqm.K4_MATS), split.blocks + 1)
    for i, mat in enumerate(tqm.K4_MATS):
        s = split.starts[i].tolist()
        assert s[0] == 0 and s[-1] == rows[mat]
        assert all(a <= b for a, b in zip(s, s[1:]))
        covered = [r for lo, hi in _ranges(split, i) for r in range(lo, hi)]
        assert covered == list(range(rows[mat]))


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_keeps_gate_row_j_with_up_row_j(name, m):
    """A block's gate_up slab is its pairs' gate rows [lo, hi) then up
    rows [f + lo, f + hi): every output column j meets both its rows."""
    split, w, _ = _split(name, m)
    i = tqm.K4_MATS.index("gate_up")
    for lo, hi in _ranges(split, i):
        gate = list(range(lo, hi))
        up = list(range(w["ffn"] + lo, w["ffn"] + hi))
        slab = gate + up
        n = hi - lo
        for j in range(n):
            assert slab[n + j] - slab[j] == w["ffn"]


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_row_counts_differ_by_at_most_one(name, m):
    """K7's gate_up at m > 1: whole blocks of 32 pairs, whose counts differ
    by at most one (a block quantizes the gated rows it produces)."""
    split, _, _ = _split(name, m)
    for i in range(len(tqm.K4_MATS)):
        counts = [hi - lo for lo, hi in _ranges(split, i)]
        if (name.startswith("q8i") and m > 1
                and tqm.K4_MATS[i] == "gate_up"):
            assert all(c % tqm.BLOCK == 0 for c in counts)
            counts = [c // tqm.BLOCK for c in counts]
        assert max(counts) - min(counts) <= 1


def _regions(split, w, head):
    """Each slab's (or head tile's) byte range in shared memory, and the
    stage after whose barrier the kernel requests it (0: at the start)."""
    lay = split.layout
    k = dict(zip(tqm.K4_MATS, split.widths))
    most = {mat: max(hi - lo for lo, hi in _ranges(split, i))
            for i, mat in enumerate(tqm.K4_MATS)}
    size = dict(o=tqm.mega_slab_bytes(most["o"], k["o"]),
                gate_up=tqm.mega_slab_bytes(2 * most["gate_up"],
                                            k["gate_up"]),
                down=tqm.mega_slab_bytes(most["down"], k["down"]))
    out = {mat: (lay[f"slot_{mat}"], lay[f"slot_{mat}"] + size[mat], 0)
           for mat in ("o", "gate_up", "down")}

    def when(a, b):   # the kernel's rule (q8_layer_fused.cu `when`)
        s = lay["slot_gate_up"]
        return 2 if a < s + lay["size_gate_up"] and s < b else 0

    if head:
        tb = tqm.mega_slab_bytes(lay["head_rows"], w["h"])
        for t in range(lay["head_tiles"]):
            a = lay["slot_qkv"] + t * tb
            out[f"tile{t}"] = (a, a + tb, when(a, a + tb))
    elif w["nq"]:
        a = lay["slot_qkv"]
        b = a + tqm.mega_slab_bytes(most["qkv"], k["qkv"])
        out["qkv"] = (a, b, when(a, b))
    return out


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_slabs_sit_in_their_slots(name, m):
    """Slabs (and head tiles) start 16-byte aligned after the activation
    rows, unit sums and mbarriers, end within the block's shared memory,
    and overlap only a slab whose stage ends before they are requested."""
    split, w, head = _split(name, m)
    lay = split.layout
    regions = _regions(split, w, head)
    stage = dict(o=1, gate_up=2, down=3)
    for name_a, (a0, a1, when_a) in regions.items():
        assert a0 % 16 == 0 and a0 >= lay["bars"] + tqm.K4_MISC
        assert a1 <= split.smem
        for name_b, (b0, b1, when_b) in regions.items():
            if name_a >= name_b or not (a0 < b1 and b0 < a1):
                continue
            assert not (name_a.startswith("tile")
                        and name_b.startswith("tile")), (name_a, name_b)
            # the later one is requested after the earlier one's stage
            assert (name_b in stage and when_a >= stage[name_b]) or (
                name_a in stage and when_b >= stage[name_a]), (name_a,
                                                               name_b)
    if head:
        assert lay["head_tiles"] >= 2
        # bulk copies of a tile: 16-byte sizes
        assert tqm.mega_slab_bytes(lay["head_rows"], w["h"]) % 16 == 0


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_fits_the_cards_shared_memory(name, m):
    """The layout fits a block's 227 KB, and the blocks an SM it is sized
    for fit the SM's 228 KB with 1 KB reserved for each."""
    split, _, _ = _split(name, m)
    assert split.per_sm == (2 if m == 1 else 1)
    assert split.smem <= tqm.K4_SMEM_BLOCK
    assert split.per_sm * (split.smem + tqm.K4_SMEM_RESERVED) <= (
        tqm.K4_SMEM_SM)


def _check_q8_rows(split, w, m):
    """K7's activation rows: m = 1, one int8 row of the widest matrix and
    its f32 scales; m > 1, m int8 rows of whole 64-column spans and at
    least h columns, padded by 32 bytes (8-byte fragment loads of rows g =
    0..3 then fall on distinct banks), then the scales, 8 rows a block at
    m <= 8 and 16 above: m k + m k / 8 bytes and the padding, never more
    than K4's bf16 rows."""
    lay = split.layout
    xcols = lay["xcols"]
    if m == 1:
        assert xcols == max(split.widths) and lay["xstride"] == 0
        x_bytes = xcols + xcols // 8
    else:
        assert xcols % tqm.K4_SPAN == 0 and xcols >= w["h"]
        assert lay["xstride"] == xcols + 32 and lay["xstride"] % 32 == 0
        assert len({(g * lay["xstride"] // 4 + b) % 32 for g in range(4)
                    for b in range(8)}) == 32
        x_bytes = (m * lay["xstride"]
                   + (8 if m <= 8 else 16) * 4 * (xcols // 32))
        assert x_bytes <= m * (2 * xcols + 16)
    assert (lay["xstride"], x_bytes) == tqm.k7_activation_bytes(m, xcols)
    assert lay["red"] >= x_bytes


@pytest.mark.parametrize("name,m", CASES, ids=IDS)
def test_split_sizes_the_activation_rows_and_unit_sums(name, m):
    """m = 1: one f32 row of the widest matrix; m > 1: m bf16 rows of
    whole 64-column spans and at least h columns (the normed rows are
    never chunked), 16 bytes of padding a row (conflict-free fragment
    loads); K7: q8_0 rows (``_check_q8_rows``); the unit sums hold every
    stage's items (and two head tiles')."""
    split, w, head = _split(name, m)
    lay = split.layout
    k = split.widths
    if name.startswith("q8i"):
        _check_q8_rows(split, w, m)
    elif m == 1:
        assert lay["red"] >= 4 * max(k)
    else:
        assert lay["xcols"] % tqm.K4_SPAN == 0 and lay["xcols"] >= w["h"]
        assert lay["xstride"] == 2 * lay["xcols"] + 16
        assert lay["xstride"] % 32 == 16
        assert lay["red"] >= m * lay["xstride"]
    if m == 1:
        rows = [max(hi - lo for lo, hi in _ranges(split, i)) * (
            2 if i == 1 else 1) for i in range(4)]
        if head:
            rows[3] = lay["head_rows"]
        units = [r * -(-kk // tqm.MEGA_UNIT_COLS) for r, kk in zip(rows, k)]
    else:
        stride = 128 if m > 8 else 64
        units = []
        for i, (s, kk) in enumerate(zip(
                (lay["s_o"], lay["s_gate_up"], lay["s_down"], lay["s_qkv"]),
                k)):
            rows = max(hi - lo for lo, hi in _ranges(split, i)) * (
                2 if i == 1 else 1)
            if i == 3 and head:
                rows = lay["head_rows"]
            groups = max(1, -(-rows // (tqm.K4_TILE * tqm.K4_GROUP)))
            assert 1 <= s <= -(-kk // tqm.K4_SPAN)
            units.append(groups * s * tqm.K4_GROUP * stride)
    red_bytes = lay["bars"] - lay["red"]
    assert red_bytes >= 4 * max(units)
    if head:   # a head tile's sums alternate between two buffers
        assert lay["red_floats"] >= units[3]
        assert red_bytes >= 2 * 4 * lay["red_floats"]


@pytest.mark.parametrize("name,m", [("qwen3", 1), ("head", 9),
                                    ("small", 16)])
def test_split_is_a_pure_function(name, m):
    a, _, _ = _split(name, m)
    b, _, _ = _split(name, m)
    assert a.layout == b.layout and a.smem == b.smem
    assert a.table().tolist() == b.table().tolist()
    lay = a.table()[:len(tqm.K4_LAYOUT)].tolist()
    assert lay == [a.layout[k] for k in tqm.K4_LAYOUT]
    assert a.table()[len(tqm.K4_LAYOUT):].tolist() == (
        a.starts.flatten().tolist())


def test_split_places_the_qkv_slab_at_qwen3_widths():
    """Where shared memory allows, the qkv slab has a slot of its own and
    goes out at the start (m = 1, 9); at m = 16 the activation rows leave
    it room only in gate_up's slot, requested after gate_up's barrier."""
    def place(m):
        split, w, head = _split("qwen3", m)
        return _regions(split, w, head)["qkv"][2]
    assert [place(m) for m in (1, 9, 16)] == [0, 0, 2]


def test_split_gives_every_warp_work_at_qwen3_widths():
    """o and down have 4 rows a block at m = 1 (264 blocks) and 8 at
    m > 1 (132): the units (m = 1: rows x 512-column chunks) or items
    (m > 1: 32-row groups x slices of spans) still number at least the
    warps."""
    for m in (1, 9):
        split, _, _ = _split("qwen3", m)
        for i, mat in enumerate(tqm.K4_MATS):
            k = split.widths[i]
            rows = min(hi - lo for lo, hi in _ranges(split, i)) * (
                2 if mat == "gate_up" else 1)
            if m == 1:
                work = rows * -(-k // tqm.MEGA_UNIT_COLS)
            else:
                groups = -(-rows // (tqm.K4_TILE * tqm.K4_GROUP))
                work = groups * split.layout[f"s_{mat}"]
            assert work >= tqm.K4_WARPS, (m, mat, work)


def test_split_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tqm.q8_layer_fused_split(**QWEN3, m=17, blocks=SMS)
    with pytest.raises(ValueError):                  # no layout fits
        tqm.q8_layer_fused_split(h=16384, qd=16384, ffn=16384, nq=4096, m=16,
                                 blocks=SMS)



def test_k7_split_gives_qkv_its_own_slot_at_qwen3_widths():
    """K7's q8_0 rows (55.8 KB at m = 16) leave the qkv slab a slot of its
    own at every m, where K4's bf16 rows (98.8 KB) do not at m = 16: every
    slab goes out in the launch's first instructions, and the layout is
    never cut into column chunks."""
    for m in (1, 2, 8, 9, 16):
        split, w, head = _split("q8i", m)
        assert _regions(split, w, head)["qkv"][2] == 0
        assert split.layout["xcols"] == max(split.widths)


def test_k7_split_refuses_a_head():
    with pytest.raises(ValueError):
        tqm.q8_layer_fused_split(**HEAD, m=1, blocks=2 * SMS, head=True,
                                 q8i=True)
