"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one. The module imports no jax, so it also runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes cover the ragged edges the main path's shapes do not (m, n, T not
multiples of the kernels' tiles); ``chip_smoke.py`` covers the main
path's own shapes.
"""

import time

import pytest
import torch

from fun_asr_gguf_tpu_torch.ops import flash_attention as tfa
from fun_asr_gguf_tpu_torch.ops import flash_decode as tfd
from fun_asr_gguf_tpu_torch.ops import quant_matmul as tqm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6)).item()


def _q8(dev, n, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-128, 128, (n, k), generator=g, device=dev,
                      dtype=torch.int8)
    d = (torch.rand(n, k // 32, generator=g, device=dev) * 1e-3).half().float()
    return tqm.Q8Weight(q, d)


@pytest.mark.parametrize("m", [1, 3, 16, 17, 100])
@pytest.mark.parametrize("n,k", [(64, 32), (200, 96), (1000, 512)])
def test_q8_matmul_kernel_matches_plain(dev, m, n, k):
    # same bf16 products, f32 sums in another order; one launch of the
    # decode-sized kernel (m <= 16) or of the prefill GEMM
    w = _q8(dev, n, k, seed=m + n)
    x = torch.randn(m, k, device=dev)
    before = (tqm.launches, tqm.gemm_launches)
    out = tqm.q8_matmul(x, w)
    torch.cuda.synchronize()
    assert (tqm.launches, tqm.gemm_launches) == (
        before[0] + (m <= 16), before[1] + (m > 16))
    assert _rel_err(out, tqm.q8_matmul_plain(x, w)) < 1e-4


@pytest.mark.parametrize("m", [17, 63, 64, 65, 129, 256, 512, 700])
@pytest.mark.parametrize("n,k", [(8, 3072), (1000, 96), (1024, 1024),
                                 (4096, 32), (1000, 3072)])
def test_q8_gemm_kernel_matches_plain(dev, m, n, k):
    # K1's prefill GEMM: ragged m and n edges, k = 32 and 96 (half a
    # 64-column stage), every x panel and k split the plan gives; the bf16
    # entry is the f32 entry's cast, bit for bit
    w = _q8(dev, n, k, seed=m * 7 + n + k)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    before = tqm.gemm_launches
    out = tqm.q8_matmul(x, w)
    out16 = tqm.q8_matmul(x, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert tqm.gemm_launches == before + 2
    assert out.dtype == torch.float32 and out16.dtype == torch.bfloat16
    assert _rel_err(out, tqm.q8_matmul_plain(x, w)) < 1e-4
    assert torch.equal(out16, out.to(torch.bfloat16))


@pytest.mark.parametrize("m", [64, 256])
def test_q8_gemm_kernel_repeats_bit_for_bit_at_every_split(dev, m):
    # the k split's partials meet in a fixed order: repeated calls agree
    # bit for bit, and every split agrees with the unsplit product to f32
    # rounding of the sums
    from fun_asr_gguf_tpu_torch.kernels import build
    n, k = 1024, 2048
    w = _q8(dev, n, k, seed=m)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    ref = tqm.q8_matmul_plain(x, w)
    rows = tqm.q8_gemm_plan(m, n, k).rows
    for splits in (1, 2, 4, 8):
        ys = []
        for _ in range(2):
            y = torch.empty(m, n, device=dev)
            build.check(build.lib().q8_gemm(
                build.ptr(x), build.ptr(w.q), build.ptr(w.d), build.ptr(y),
                m, n, k, 0, rows, splits, build.stream_ptr(dev)), "q8_gemm")
            ys.append(y)
        torch.cuda.synchronize()
        assert torch.equal(ys[0], ys[1])
        assert _rel_err(ys[0], ref) < 1e-4


def test_q8_gemm_refuses_what_it_does_not_take(dev):
    from fun_asr_gguf_tpu_torch.kernels import build
    w = _q8(dev, 64, 64, seed=1)
    x = torch.randn(32, 64, device=dev).to(torch.bfloat16)
    y = torch.empty(32, 64, device=dev)
    lib = build.lib()
    for rows, splits in ((192, 1), (128, 3), (128, 16)):
        assert lib.q8_gemm(build.ptr(x), build.ptr(w.q), build.ptr(w.d),
                           build.ptr(y), 32, 64, 64, 0, rows, splits,
                           build.stream_ptr(dev)) != 0
    with pytest.raises(ValueError):                 # k not a multiple of 32
        tqm.q8_matmul(x[:, :48], tqm.Q8Weight(w.q[:, :48].contiguous(),
                                              w.d[:, :1].contiguous()))


def test_q8_matmul_kernel_reads_a_stacked_layer_in_place(dev):
    stack = tqm.Q8Weight(torch.randint(-128, 128, (3, 96, 64), device=dev,
                                       dtype=torch.int8),
                         torch.rand(3, 96, 2, device=dev) * 1e-2)
    x = torch.randn(2, 64, device=dev)
    for i in range(3):
        w = tqm.layer(stack, i)
        assert w.q.data_ptr() == stack.q.data_ptr() + i * 96 * 64
        assert _rel_err(tqm.q8_matmul(x, w), tqm.q8_matmul_plain(x, w)) < 1e-4


def test_q8_matmul_kernel_refuses_bad_layouts(dev):
    w = _q8(dev, 64, 64, seed=0)
    x = torch.randn(2, 64, device=dev)
    with pytest.raises(ValueError):
        tqm.q8_matmul(x, tqm.Q8Weight(w.q.t(), w.d))        # not contiguous
    with pytest.raises(TypeError):
        tqm.q8_matmul(x, tqm.Q8Weight(w.q, w.d.half()))
    with pytest.raises(ValueError):
        tqm.q8_matmul(x, tqm.Q8Weight(w.q.cpu(), w.d.cpu()))


@pytest.mark.parametrize("t,qh,kh,s", [(1, 16, 8, 17), (1, 4, 1, 300),
                                       (2, 16, 8, 1024), (3, 8, 2, 65),
                                       (5, 16, 8, 777), (9, 16, 8, 1033)])
def test_flash_decode_kernel_matches_plain(dev, t, qh, kh, s):
    g = torch.Generator(device=dev).manual_seed(s)
    bf = torch.bfloat16
    q = (torch.randn(1, t, qh, 128, generator=g, device=dev) / 11.3).to(bf)
    k = torch.randn(1, s, kh, 128, generator=g, device=dev).to(bf)
    v = torch.randn(1, s, kh, 128, generator=g, device=dev).to(bf)
    j = torch.arange(s, device=dev)
    bias = torch.where(j < s - 3, 0.0, -1e30).float().expand(
        1, t, s).contiguous()
    before = tfd.launches
    out = tfd.flash_decode_attention(q, k, v, bias)
    assert tfd.launches == before + 1
    # bf16 output; expf and sum order move results by about one ulp
    assert _rel_err(out, tfd.flash_decode_plain(q, k, v, bias)) < 2e-2


def test_flash_decode_kernel_refuses_other_head_dims(dev):
    bf = torch.bfloat16
    q = torch.zeros(1, 1, 4, 64, device=dev, dtype=bf)
    k = torch.zeros(1, 8, 2, 64, device=dev, dtype=bf)
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(q, k, k, torch.zeros(1, 1, 8, device=dev))
    # 10 query rows x group 2 = 20 > 18 rows per block
    q = torch.zeros(1, 10, 16, 128, device=dev, dtype=bf)
    k = torch.zeros(1, 8, 8, 128, device=dev, dtype=bf)
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(q, k, k, torch.zeros(1, 10, 8, device=dev))


def _i8_cache(dev, b, s, kh, seed):
    from fun_asr_gguf_tpu_torch.models.qwen3 import _kv_quantize
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(b, s, kh, 128, generator=g, device=dev)
    v = torch.randn(b, s, kh, 128, generator=g, device=dev)
    scale = torch.rand(b, s, kh, 1, generator=g, device=dev) * 3 + 0.1
    (kq, ks), (vq, vs) = (_kv_quantize((a * scale).to(torch.bfloat16))
                          for a in (k, v))
    return kq, vq, ks, vs


@pytest.mark.parametrize("t", [1, 9])
@pytest.mark.parametrize("s", [64, 777, 1033])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_decode_i8_kernel_matches_plain(dev, t, s, b):
    g = torch.Generator(device=dev).manual_seed(s + t)
    q = (torch.randn(b, t, 16, 128, generator=g, device=dev) / 11.3).to(
        torch.bfloat16)
    kq, vq, ks, vs = _i8_cache(dev, b, s, 8, seed=s)
    j = torch.arange(s, device=dev)
    i = torch.arange(t, device=dev)[:, None]
    bias = torch.where((j >= 5) & (j <= s - t - 2 + i), 0.0,
                       -1e30).float().expand(b, t, s).contiguous()
    before = (tfd.launches, tfd.launches_i8)
    out = tfd.flash_decode_attention(q, kq, vq, bias, ks, vs)
    torch.cuda.synchronize()
    assert (tfd.launches, tfd.launches_i8) == (before[0], before[1] + 1)
    assert out.shape == (b, 16, t, 128) and out.dtype == torch.bfloat16
    # bf16 output; expf and sum order move results by about one ulp
    assert _rel_err(out, tfd.flash_decode_plain(q, kq, vq, bias, ks,
                                                vs)) < 2e-2


def test_flash_decode_i8_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 1, 16, 128, device=dev, dtype=torch.bfloat16)
    kq, vq, ks, vs = _i8_cache(dev, 1, 64, 8, seed=0)
    bias = torch.zeros(1, 1, 64, device=dev)
    with pytest.raises(TypeError):                        # f32 scales
        tfd.flash_decode_attention(q, kq, vq, bias, ks.float(), vs.float())
    with pytest.raises(TypeError):                        # bf16 cache
        tfd.flash_decode_attention(q, kq.to(torch.bfloat16), vq, bias, ks, vs)
    with pytest.raises(ValueError):                       # one scale only
        tfd.flash_decode_attention(q, kq, vq, bias, ks, None)
    wide = torch.zeros(1, 64, 8, 256, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError):                       # not contiguous
        tfd.flash_decode_attention(q, wide[..., :128], vq, bias, ks, vs)
    q10 = torch.zeros(1, 10, 16, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                       # 20 rows > 18
        tfd.flash_decode_attention(q10, kq, vq,
                                   torch.zeros(1, 10, 64, device=dev), ks, vs)


def _verify_bias(dev, b, t, s, lo=40, tail=100):
    """The verify mask: row i sees slots [lo, s - tail - t + i]."""
    j = torch.arange(s, device=dev)
    i = torch.arange(t, device=dev)[:, None]
    return torch.where((j >= lo) & (j <= s - tail - t + i), 0.0,
                       -1e30).float().expand(b, t, s).contiguous()


# the cache lengths the split-KV design opened: S = 2313 is an engine
# built with n_predict = 2048 (256 + 2048 + 9), whose first verify round
# raised before; 8192 at T = 1
LONG = [(9, 2313), (9, 2816), (9, 4105), (1, 8192)]


@pytest.mark.parametrize("t,s", LONG)
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_decode_kernels_take_long_caches(dev, t, s, cache):
    g = torch.Generator(device=dev).manual_seed(s + t)
    q = (torch.randn(1, t, 16, 128, generator=g, device=dev) / 11.3).to(
        torch.bfloat16)
    bias = _verify_bias(dev, 1, t, s)
    if cache == "int8":
        kq, vq, ks, vs = _i8_cache(dev, 1, s, 8, seed=s)
        args = (q, kq, vq, bias, ks, vs)
    else:
        args = (q, torch.randn(1, s, 8, 128, generator=g, device=dev).to(
            torch.bfloat16), torch.randn(1, s, 8, 128, generator=g,
                                         device=dev).to(torch.bfloat16), bias)
    before = (tfd.launches, tfd.launches_i8)
    out = tfd.flash_decode_attention(*args)
    torch.cuda.synchronize()
    assert (tfd.launches + tfd.launches_i8) == sum(before) + 1
    # bf16 output; expf, the chunks' rounding point and the sum order
    assert _rel_err(out, tfd.flash_decode_plain(*args)) < 2e-2


@pytest.mark.parametrize("chunk", [17, 32, 96, 1033])
@pytest.mark.parametrize("t", [1, 9])
def test_flash_decode_kernel_takes_any_chunk(dev, t, chunk):
    """One chunk per tile, several double-buffered tiles per chunk, a
    chunk below the tile, and the whole row in one chunk."""
    g = torch.Generator(device=dev).manual_seed(chunk + t)
    s = 1033
    q = (torch.randn(1, t, 16, 128, generator=g, device=dev) / 11.3).to(
        torch.bfloat16)
    k, v = (torch.randn(1, s, 8, 128, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    bias = _verify_bias(dev, 1, t, s)
    out = tfd._launch(q, k, v, bias, chunk=chunk)
    assert _rel_err(out, tfd.flash_decode_plain(q, k, v, bias)) < 2e-2
    kq, vq, ks, vs = _i8_cache(dev, 1, s, 8, seed=chunk)
    out = tfd._launch_i8(q, kq, vq, bias, ks, vs, chunk=chunk)
    assert _rel_err(out, tfd.flash_decode_plain(q, kq, vq, bias, ks,
                                                vs)) < 2e-2


def test_flash_decode_tickets_reset_between_calls(dev):
    """Back-to-back calls at different S, T and batch on one stream, with
    no sync between them: every call's last block resets its tickets, so
    each result matches its plain version and the buffer ends at zero."""
    from fun_asr_gguf_tpu_torch.kernels import build
    g = torch.Generator(device=dev).manual_seed(7)
    calls = []
    for b, t, s, cache in [(1, 1, 768, "bf16"), (1, 9, 2313, "int8"),
                           (2, 9, 777, "bf16"), (1, 1, 33, "int8"),
                           (3, 2, 4105, "bf16"), (1, 9, 1033, "bf16"),
                           (1, 1, 8192, "int8"), (1, 1, 768, "bf16")]:
        q = (torch.randn(b, t, 16, 128, generator=g, device=dev) / 11.3).to(
            torch.bfloat16)
        bias = _verify_bias(dev, b, t, s, lo=3, tail=5)
        if cache == "int8":
            kq, vq, ks, vs = _i8_cache(dev, b, s, 8, seed=s)
            args = (q, kq, vq, bias, ks, vs)
        else:
            args = (q, *(torch.randn(b, s, 8, 128, generator=g, device=dev)
                         .to(torch.bfloat16) for _ in range(2)), bias)
        calls.append(args)
    outs = [tfd.flash_decode_attention(*a) for a in calls]
    torch.cuda.synchronize()
    for a, out in zip(calls, outs):
        assert _rel_err(out, tfd.flash_decode_plain(*a)) < 2e-2
    assert int(build.tickets(dev, 1).abs().sum()) == 0


QD, H, F, NQ = 512, 256, 384, 640     # K4 test widths (all % 32 == 0)


def _chain(dev, m, seed, layers=None, ffn=F, widths=(QD, H, NQ),
           d_range=(1e-3, 3e-3)):
    """Inputs of one K4 call; with ``layers`` the weights are views of
    stacked [layers, n, k] tensors (layer 1)."""
    qd, h, nq = widths
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def q8(n, k):
        shape = (layers, n, k) if layers else (n, k)
        w = tqm.Q8Weight(
            torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8),
            (torch.rand(*shape[:-1], k // 32, generator=g, device=dev)
             * (d_range[1] - d_range[0]) + d_range[0]).half().float())
        return tqm.layer(w, 1) if layers else w

    def norm_w():
        return (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(bf)

    xm = torch.randn(m, qd, generator=g, device=dev).to(bf)
    resid = torch.randn(m, h, generator=g, device=dev).to(bf)
    return (xm, resid, norm_w(), norm_w(), q8(h, qd), q8(2 * ffn, h),
            q8(h, ffn), q8(nq, h))


# same bf16 products; f32 sums in another order can flip isolated bf16
# ulps of the normed rows and of the gated product (measured up to 2.3e-3
# at m = 16)
K4_TOL = 5e-3


@pytest.mark.parametrize("m", [1, 2, 4, 9, 16])
def test_q8_layer_fused_kernel_matches_plain(dev, m):
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, m, seed=m)
    before = tqm.fused_launches
    out, got_qkv = tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv,
                                        1e-6)
    last = tqm.q8_mlp_fused(xm, resid, pw, o, gu, dn, 1e-6)
    torch.cuda.synchronize()
    assert tqm.fused_launches == before + 2
    ref_out, ref_qkv = tqm.q8_mlp_qkv_fused_plain(xm, resid, pw, nw, o, gu,
                                                  dn, qkv, 1e-6)
    assert out.shape == (m, H) and got_qkv.shape == (m, NQ)
    assert _rel_err(out, ref_out) < K4_TOL
    assert _rel_err(got_qkv, ref_qkv) < K4_TOL
    assert _rel_err(last, tqm.q8_mlp_fused_plain(xm, resid, pw, o, gu, dn,
                                                 1e-6)) < K4_TOL


@pytest.mark.parametrize("m", [1, 3, 9])
def test_q8_layer_fused_kernel_reads_a_stacked_layer_in_place(dev, m):
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, m, seed=7, layers=3)
    assert o.q.data_ptr() == o.q.untyped_storage().data_ptr() + H * QD
    out, got_qkv = tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv,
                                        1e-6)
    ref_out, ref_qkv = tqm.q8_mlp_qkv_fused_plain(xm, resid, pw, nw, o, gu,
                                                  dn, qkv, 1e-6)
    assert _rel_err(out, ref_out) < K4_TOL
    assert _rel_err(got_qkv, ref_qkv) < K4_TOL


@pytest.mark.parametrize("m", [1, 9])
def test_q8_layer_fused_kernel_takes_widths_not_multiples_of_128(dev, m):
    """f = 416: down's rows of scales are not whole 16-byte words, so the
    kernel copies them with plain loads beside the bulk copy of the int8
    rows."""
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, m, seed=30 + m, ffn=416)
    out, got_qkv = tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv,
                                        1e-6)
    ref_out, ref_qkv = tqm.q8_mlp_qkv_fused_plain(xm, resid, pw, nw, o, gu,
                                                  dn, qkv, 1e-6)
    assert _rel_err(out, ref_out) < K4_TOL
    assert _rel_err(got_qkv, ref_qkv) < K4_TOL


@pytest.mark.parametrize("m", [1, 9])
def test_q8_layer_fused_kernel_repeats_bit_for_bit(dev, m):
    """Each row's sums are added in a fixed order whatever the blocks'
    timing: calls on the same inputs are equal bit for bit."""
    args = _chain(dev, m, seed=40 + m)
    first = tqm.q8_mlp_qkv_fused(*args, 1e-6)
    last = tqm.q8_mlp_fused(*args[:3], *args[4:7], 1e-6)
    for _ in range(3):
        for a, b in zip(first, tqm.q8_mlp_qkv_fused(*args, 1e-6)):
            assert torch.equal(a, b)
        assert torch.equal(last, tqm.q8_mlp_fused(*args[:3], *args[4:7],
                                                  1e-6))


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("form", ["qkv", "last", "head"])
def test_q8_layer_fused_stage_timer(dev, m, form):
    """The timed launch gives the untimed one's outputs bit for bit; its
    stages are positive and add up to within 10 % of block 0's span, which
    lies inside the host's clock around the launch and its read-back."""
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, m, seed=50 + m)
    if form == "head":
        qkv = _q8(dev, NV, H, seed=m)
    if form == "last":
        nw = qkv = None
    head = form == "head"
    plain = tqm._launch_fused(xm, resid, pw, nw, o, gu, dn, qkv, 1e-6,
                              head=head)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages, timed = tqm.q8_layer_fused_stage_ms(xm, resid, pw, nw, o, gu, dn,
                                                qkv, 1e-6, head=head)
    host_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(plain, timed):
        assert torch.equal(a, b)
    names = ["o", "gate_up", "down"] + ([] if form == "last" else [form])
    assert set(stages) == set(names) | {"span"}
    parts = [stages[k] for k in names]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(stages["span"], rel=0.1)
    assert 0 < stages["span"] < host_ms


# Qwen3-0.6B's widths: o 1024x2048, gate_up 6144x1024, down 1024x3072,
# next qkv 4096x1024 or the 152576-row head, with scales of a trained
# checkpoint's magnitude, on the card's own grid and layout
QWEN3_K4 = dict(widths=(2048, 1024, 4096), ffn=3072, d_range=(2e-4, 3.5e-4))


@pytest.mark.parametrize("m", [1, 8, 9, 16])
@pytest.mark.parametrize("head", [False, True])
def test_q8_layer_fused_kernel_matches_plain_at_qwen3_width(dev, m, head,
                                                            monkeypatch):
    """Every slot placement the split makes at full width: the qkv slab
    in a slot of its own (m = 1, 8, 9) or in o's (m = 16), K4c's head
    ring partly requested at the start (m = 1) or after gate_up."""
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, m, seed=60 + m,
                                               **QWEN3_K4)
    if head:
        monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "1")
        qkv = _q8(dev, 152576, 1024, seed=m)
        qkv = tqm.Q8Weight(qkv.q, qkv.d * 0.3)
        got = tqm.q8_layer_head_fused(xm, resid, pw, nw, o, gu, dn, qkv,
                                      1e-6)
        ref = tqm.q8_layer_head_fused_plain(xm, resid, pw, nw, o, gu, dn,
                                            qkv, 1e-6)
    else:
        got = tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv, 1e-6)
        ref = tqm.q8_mlp_qkv_fused_plain(xm, resid, pw, nw, o, gu, dn, qkv,
                                         1e-6)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert _rel_err(g, r) < K4_TOL


def test_q8_layer_fused_split_fits_the_cards_grid(dev):
    """Two blocks an SM at m = 1, one at m > 1, at Qwen3-0.6B's widths."""
    from fun_asr_gguf_tpu_torch.kernels import build
    sms = build.sm_count(dev)
    for m, per_sm in ((1, 2), (9, 1), (16, 1)):
        assert tqm.q8_layer_fused_grid(m, 1024, 2048, 3072, 4096) == (
            per_sm * sms)
        split = tqm.q8_layer_fused_split(1024, 2048, 3072, 4096, m,
                                         per_sm * sms)
        assert build.grid_blocks("q8_layer_fused_grid", m,
                                 split.smem) >= per_sm * sms


def test_q8_layer_fused_kernel_refuses_what_it_does_not_take(dev):
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, 17, seed=3)
    with pytest.raises(ValueError):                       # m > 16
        tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv, 1e-6)
    xm, resid = xm[:2], resid[:2]
    bad = tqm.Q8Weight(torch.zeros(QD, H, dtype=torch.int8, device=dev).t(),
                       o.d)                               # not contiguous
    assert not bad.q.is_contiguous()
    with pytest.raises(ValueError):
        tqm.q8_mlp_fused(xm, resid, pw, bad, gu, dn, 1e-6)
    with pytest.raises(TypeError):                        # f32 activations
        tqm.q8_mlp_fused(xm.float(), resid, pw, o, gu, dn, 1e-6)
    with pytest.raises(TypeError):                        # f16 scales
        tqm.q8_mlp_fused(xm, resid, pw, o, tqm.Q8Weight(gu.q, gu.d.half()),
                         dn, 1e-6)
    with pytest.raises(ValueError):                       # mixed devices
        tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn,
                             tqm.Q8Weight(qkv.q.cpu(), qkv.d.cpu()), 1e-6)


@pytest.mark.parametrize("t", [1, 63, 65, 130])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel_matches_plain(dev, t, d):
    g = torch.Generator(device=dev).manual_seed(t + d)
    bf = torch.bfloat16
    q = (torch.randn(3, t, d, generator=g, device=dev) * d ** -0.5).to(bf)
    k = torch.randn(3, t, d, generator=g, device=dev).to(bf)
    v = torch.randn(3, t, d, generator=g, device=dev).to(bf)
    mask = (torch.arange(t, device=dev) < max(1, t - 5)).float()
    bias = ((mask - 1.0) * 1e4).expand(3, t).contiguous()
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, bias)
    assert tfa.launches == before + 1
    # bf16 P.V operands against the plain f32 softmax
    assert _rel_err(out, tfa.flash_attention_plain(q, k, v, bias)) < 2e-2


@pytest.mark.parametrize("t", [1, 63, 65, 1001])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel_takes_strided_heads(dev, t, d):
    # SANM's heads: views of one packed [B, T, 3 H D] projection; the
    # strided entry agrees with the plain version and, bit for bit, with
    # the contiguous entry at the same key split
    g = torch.Generator(device=dev).manual_seed(t * d)
    b, h, bf = 2, 4, torch.bfloat16
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device=dev).to(bf)
    qv, kv, vv = qkv.split(h * d, dim=-1)

    def heads(x):
        return x.reshape(b, t, h, d).transpose(1, 2)
    qh, kh, vh = heads(qv) * d ** -0.5, heads(kv), heads(vv)
    mask = torch.stack([torch.arange(t, device=dev) < max(1, t - 9),
                        torch.ones(t, dtype=torch.bool, device=dev)]).float()
    before = tfa.launches
    out = tfa.attention_with_mask(qh, kh, vh, mask)
    assert tfa.launches == before + 1 and out.shape == (b, h, t, d)
    flat = [a.reshape(b * h, t, d).contiguous() for a in (qh, kh, vh)]
    bias = ((mask - 1.0) * 1e4).repeat_interleave(h, dim=0)
    assert _rel_err(out.reshape(b * h, t, d),
                    tfa.flash_attention_plain(*flat, bias)) < 2e-2
    # the contiguous entry ([B H, T, D], one head a batch row) splits the
    # keys of its b * h heads the same way
    assert torch.equal(out.reshape(b * h, t, d),
                       tfa.flash_attention(*flat, bias))


@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
def test_flash_attention_kernel_repeats_at_every_key_split(dev, chunks):
    # the chunks' partials meet in rank order: a split repeats bit for bit
    # and agrees with the plain version (T = 1001: 16 key tiles)
    g = torch.Generator(device=dev).manual_seed(chunks)
    t, d, bf = 1001, 128, torch.bfloat16
    q, k, v = ((torch.randn(1, 4, t, d, generator=g, device=dev)
                * (d ** -0.5 if i == 0 else 1.0)).to(bf) for i in range(3))
    bias = tfa._bias_rows(((torch.arange(t, device=dev) < 900).float()
                           - 1.0)[None] * 1e4)
    a = tfa._launch(q, k, v, bias, chunks=chunks)
    b = tfa._launch(q, k, v, bias, chunks=chunks)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = tfa.flash_attention_plain(q[0], k[0], v[0], bias.expand(4, t))
    assert _rel_err(a[0], plain) < 2e-2


def test_flash_attention_kernel_refuses_float32(dev):
    q = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q, torch.zeros(1, 8, device=dev))


NV = 1536                              # a K4c head of 1536 rows


@pytest.mark.parametrize("m", [1, 9])
def test_q8_layer_head_fused_kernel_matches_plain(dev, m, monkeypatch):
    xm, resid, pw, fw, o, gu, dn, _ = _chain(dev, m, seed=20 + m)
    head = _q8(dev, NV, H, seed=m)
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "1")
    before = (tqm.fused_launches, tqm.head_fused_launches)
    out, logits = tqm.q8_layer_head_fused(xm, resid, pw, fw, o, gu, dn, head,
                                          1e-6)
    torch.cuda.synchronize()
    assert (tqm.fused_launches, tqm.head_fused_launches) == (
        before[0], before[1] + 1)
    ref_out, ref_logits = tqm.q8_layer_head_fused_plain(
        xm, resid, pw, fw, o, gu, dn, head, 1e-6)
    assert logits.shape == (m, NV)
    assert _rel_err(out, ref_out) < K4_TOL
    assert _rel_err(logits, ref_logits) < K4_TOL
    monkeypatch.setenv("FUNASR_Q8_FUSED_HEAD", "0")
    assert tqm.q8_layer_head_fused(xm, resid, pw, fw, o, gu, dn, head,
                                   1e-6) is None


def _mega(dev, seed, s_len=256, kh=2, q_heads=4, layers=2, h=256, ffn=512,
          vp=2048, b=1, cache_dtype=torch.bfloat16, visible=(0, None),
          d_range=(1e-3, 3e-3)):
    """K5's inputs at small widths; cached slots [visible) are unmasked;
    q8_0 scales uniform in ``d_range``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf, hd = torch.bfloat16, 128
    qd = q_heads * hd

    def q8(*shape):
        return tqm.Q8Weight(
            torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8),
            (torch.rand(*shape[:-1], shape[-1] // 32, generator=g,
                        device=dev) * (d_range[1] - d_range[0])
             + d_range[0]).half().float())

    def norm(*shape):
        return (1 + 0.1 * torch.randn(*shape, generator=g, device=dev)).to(bf)

    x0 = torch.randn(b, h, generator=g, device=dev)
    nhb0 = (x0 * torch.rsqrt(x0.square().mean(-1, keepdim=True) + 1e-6)
            ).to(bf)
    pos = torch.tensor([float(s_len)], device=dev)
    inv = 1.0 / (1e4 ** (torch.arange(64, device=dev) / 64))
    ang = torch.cat([pos * inv, pos * inv])[None]
    j = torch.arange(s_len, device=dev)
    lo, hi = visible
    bias = torch.where((j >= lo) & (j < (s_len if hi is None else hi)), 0.0,
                       -1e30).float()[None]
    kc = torch.randn(layers, kh, s_len, hd, generator=g, device=dev).to(
        cache_dtype)
    vc = torch.randn(layers, kh, s_len, hd, generator=g, device=dev).to(
        cache_dtype)
    nq = qd + 2 * kh * hd
    return (x0, nhb0, norm(layers, h), norm(layers, h), norm(layers, hd),
            norm(layers, hd), ang.cos(), ang.sin(), bias, kc, vc,
            q8(layers, nq, h), q8(layers, h, qd), q8(layers, 2 * ffn, h),
            q8(layers, h, ffn), q8(vp, h), 1e-6)


def _cos_sim(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# two layers of K4's bf16 rounding points, then exp and the attention
# sums in another order
K5_TOL = 2e-2


@pytest.mark.parametrize("s_len,visible", [(256, (0, None)), (300, (7, 290)),
                                           (1024, (40, 700))])
def test_q8_decode_all_kernel_matches_plain(dev, s_len, visible):
    args = _mega(dev, seed=s_len, s_len=s_len, visible=visible)
    before = tqm.mega_launches
    logits, k_new, v_new = tqm.q8_decode_all_fused(*args)
    torch.cuda.synchronize()
    assert tqm.mega_launches == before + 1
    ref = tqm.q8_decode_all_fused_plain(*args)
    assert logits.shape == (1, 2048) and k_new.shape == (2, 2, 128)
    assert torch.isfinite(logits).all()
    assert _rel_err(logits, ref[0]) < K5_TOL
    assert _cos_sim(logits, ref[0]) > 0.9999
    assert _rel_err(k_new, ref[1]) < K5_TOL
    assert _rel_err(v_new, ref[2]) < K5_TOL


@pytest.mark.parametrize("s_len,visible", [(1024, (56, 57)),
                                           (1024, (56, 256)),
                                           (1024, (56, 1000)),
                                           (768, (0, 767))])
def test_q8_decode_all_kernel_attends_any_number_of_visible_slots(dev, s_len,
                                                                  visible):
    """1, 200, 944 and 767 visible cached slots through the split-KV
    attention items (every chunk but one masked, some, almost none)."""
    args = _mega(dev, seed=visible[1], s_len=s_len, visible=visible)
    logits, k_new, v_new = tqm.q8_decode_all_fused(*args)
    ref = tqm.q8_decode_all_fused_plain(*args)
    assert torch.isfinite(logits).all()
    assert _rel_err(logits, ref[0]) < K5_TOL
    assert _cos_sim(logits, ref[0]) > 0.9999
    assert _rel_err(v_new, ref[2]) < K5_TOL


def test_q8_decode_all_stage_timer_leaves_the_step_unchanged(dev):
    """The timed launch gives the untimed one's outputs bit for bit; its
    stages are positive and add up to block 0's span, which lies inside
    the host's clock around the launch and its read-back."""
    args = _mega(dev, seed=5, s_len=1024, visible=(40, 700))
    plain = tqm.q8_decode_all_fused(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages, timed = tqm.q8_decode_all_stage_ms(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(plain, timed):
        assert torch.equal(a, b)
    parts = [stages[k] for k in (*tqm.MEGA_STAGES, "head")]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(stages["span"], rel=1e-6)
    assert 0 < stages["span"] < host_ms


# Qwen3-0.6B at full width: 28 layers, 16 query over 8 kv heads, q8_0
# scales of a trained 0.6B checkpoint's magnitude (|w| <= 0.045, as
# chip_smoke.py's random weights)
QWEN3_MEGA = dict(kh=8, q_heads=16, layers=28, h=1024, ffn=3072, vp=152576,
                  d_range=(2e-4, 3.5e-4))
K5_COS_QWEN3 = 0.9995   # chip_smoke.py's K5_COS: 28 layers of those flips


@pytest.mark.parametrize("s_len", [768, 1024, 2313])
@pytest.mark.parametrize("span", ["one", "part", "all"])
def test_q8_decode_all_kernel_matches_plain_at_qwen3_width(dev, s_len, span):
    """The streamed GEMV stages and head on 264 (or 132) blocks at full
    width, with one visible cached slot, part of the cache, and all of it
    but the step's own slot."""
    last = s_len - 1
    visible = dict(one=(last - 1, last), part=(56, s_len // 2),
                   all=(0, last))[span]
    args = _mega(dev, seed=s_len + len(span), s_len=s_len, visible=visible,
                 **QWEN3_MEGA)
    before = tqm.mega_launches
    logits, k_new, v_new = tqm.q8_decode_all_fused(*args)
    torch.cuda.synchronize()
    assert tqm.mega_launches == before + 1
    ref = tqm.q8_decode_all_fused_plain(*args)
    assert logits.shape == (1, 152576) and k_new.shape == (28, 8, 128)
    assert torch.isfinite(logits).all()
    assert _rel_err(logits, ref[0]) < K5_TOL
    assert _cos_sim(logits, ref[0]) > K5_COS_QWEN3
    assert _rel_err(k_new, ref[1]) < K5_TOL
    assert _rel_err(v_new, ref[2]) < K5_TOL


@pytest.mark.parametrize("width", ["small", "qwen3"])
def test_q8_decode_all_kernel_repeats_and_leaves_tickets_zero(dev, width):
    """Calls on the same inputs give equal outputs bit for bit (each row's
    units are summed in order, whatever order the blocks run in), and
    each call leaves the attention items' tickets at zero."""
    from fun_asr_gguf_tpu_torch.kernels import build
    kw = QWEN3_MEGA if width == "qwen3" else {}
    args = _mega(dev, seed=11, s_len=1024, visible=(40, 700), **kw)
    first = tqm.q8_decode_all_fused(*args)
    for _ in range(3):
        again = tqm.q8_decode_all_fused(*args)
        torch.cuda.synchronize()
        assert not build.tickets(dev, args[9].shape[1]).any()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_q8_decode_all_split_fits_the_cards_grid(dev):
    """The wrapper's split is sized for the grid the card makes
    co-resident: two blocks an SM at Qwen3-0.6B's widths."""
    from fun_asr_gguf_tpu_torch.kernels import build
    sms = build.sm_count(dev)
    w = dict(h=1024, qd=2048, ffn=3072, kh=8, vp=152576)
    assert tqm.q8_decode_all_grid(**w) == 2 * sms
    split = tqm.q8_decode_all_split(**w, blocks=2 * sms)
    assert build.grid_blocks("q8_decode_all_grid", 1024, 2048, 3072,
                             split.slot0, split.slot1, split.red) >= 2 * sms


def test_q8_decode_all_kernel_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError):                       # b = 2
        tqm.q8_decode_all_fused(*_mega(dev, seed=1, b=2))
    with pytest.raises(ValueError):                       # GQA group 4
        tqm.q8_decode_all_fused(*_mega(dev, seed=1, kh=1))
    with pytest.raises(TypeError):                        # f32 cache
        tqm.q8_decode_all_fused(*_mega(dev, seed=1,
                                       cache_dtype=torch.float32))
    with pytest.raises(ValueError):                       # f % 128 != 0
        tqm.q8_decode_all_fused(*_mega(dev, seed=1, ffn=480))


def _q8dot(dev, n, k, seed, layers=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (layers, n, k) if layers else (n, k)
    return tqm.Q8DotWeight(
        torch.randint(-127, 128, shape, generator=g, device=dev,
                      dtype=torch.int8),
        (torch.rand(*shape[:-1], k // 32, generator=g, device=dev) * 2e-3
         + 1e-3).half().float())


# K6: the same integer partials; the scales and the block sum in f32, in
# another order
K6_TOL = 1e-4


@pytest.mark.parametrize("m", [1, 3, 9, 16])
@pytest.mark.parametrize("n,k", [(64, 32), (200, 96), (1000, 1024),
                                 (37, 3072)])
def test_q8dot_matmul_kernel_matches_plain(dev, m, n, k):
    w = _q8dot(dev, n, k, seed=m + n)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    before = tqm.q8dot_launches
    out = tqm.q8dot_matmul(x, w)
    torch.cuda.synchronize()
    assert tqm.q8dot_launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert _rel_err(out, tqm.q8dot_matmul_plain(x, w)) < K6_TOL


def test_q8dot_matmul_kernel_reads_a_stacked_layer_in_place(dev):
    stack = _q8dot(dev, 96, 64, seed=5, layers=3)
    x = torch.randn(2, 64, device=dev)
    for i in range(3):
        w = tqm.layer(stack, i)
        assert w.q.data_ptr() == stack.q.data_ptr() + i * 96 * 64
        assert _rel_err(tqm.q8dot_matmul(x, w),
                        tqm.q8dot_matmul_plain(x, w)) < K6_TOL


def test_q8dot_matmul_kernel_refuses_what_it_does_not_take(dev):
    w = _q8dot(dev, 64, 64, seed=0)
    with pytest.raises(ValueError):                       # m > 16
        tqm.q8dot_matmul(torch.randn(17, 64, device=dev), w)
    x = torch.randn(2, 64, device=dev)
    with pytest.raises(ValueError):                       # not contiguous
        tqm.q8dot_matmul(x, tqm.Q8DotWeight(w.q.t(), w.d))
    with pytest.raises(TypeError):                        # f16 scales
        tqm.q8dot_matmul(x, tqm.Q8DotWeight(w.q, w.d.half()))
    with pytest.raises(TypeError):                        # int activations
        tqm.q8dot_matmul(x.to(torch.int32), w)
    with pytest.raises(ValueError):                       # mixed devices
        tqm.q8dot_matmul(x, tqm.Q8DotWeight(w.q.cpu(), w.d.cpu()))


# K1 at m <= 16 and K6: one kernel under two dot contracts
# (csrc/q8_matmul.cu q8_matvec_kernel; split and layout from
# ops/quant_matmul.py q8_matvec_split). (wrapper, plain version, weight
# type, tolerance) of each contract.
MATVEC = {"k1": (tqm.q8_matmul, tqm.q8_matmul_plain, tqm.Q8Weight, 1e-4),
          "k6": (tqm.q8dot_matmul, tqm.q8dot_matmul_plain, tqm.Q8DotWeight,
                 K6_TOL)}


def _matvec_launches(contract):
    return tqm.launches if contract == "k1" else tqm.q8dot_launches


def _matvec_weight(dev, contract, n, k, seed, layers=None):
    return MATVEC[contract][2](*_q8dot(dev, n, k, seed, layers))


@pytest.mark.parametrize("contract", ["k1", "k6"])
@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("n,k", [(61, 96), (1000, 640), (20011, 1024)])
def test_q8_matvec_kernel_matches_plain_at_every_row_count(dev, contract, m,
                                                           n, k):
    """m = 1 ... 16 under both contracts; n not a multiple of a 32-row
    tile; k not a multiple of 128 (96: the scales by plain loads) or of 512
    (640: a partial unit); 20011 rows: several tiles a block, the ring
    wrapping at least once. One launch a call."""
    fn, plain, _, tol = MATVEC[contract]
    w = _matvec_weight(dev, contract, n, k, seed=m + n)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    before = _matvec_launches(contract)
    out = fn(x, w)
    torch.cuda.synchronize()
    assert _matvec_launches(contract) == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert _rel_err(out, plain(x, w)) < tol


@pytest.mark.parametrize("contract", ["k1", "k6"])
@pytest.mark.parametrize("m", [1, 2, 9, 16])
def test_q8_matvec_kernel_repeats_bit_for_bit(dev, contract, m):
    fn = MATVEC[contract][0]
    w = _matvec_weight(dev, contract, 20011, 1024, seed=3)
    x = torch.randn(m, 1024, device=dev).to(torch.bfloat16)
    first = fn(x, w)
    for _ in range(3):
        assert torch.equal(fn(x, w), first)


@pytest.mark.parametrize("contract", ["k1", "k6"])
@pytest.mark.parametrize("m", [1, 9])
def test_q8_matvec_kernel_reads_stacked_layers_in_place(dev, contract, m):
    """A layer view of a stacked [L, n, k] weight is read where it lies
    and gives what a contiguous copy of the layer gives, bit for bit."""
    fn, plain, cls, tol = MATVEC[contract]
    stack = _matvec_weight(dev, contract, 300, 256, seed=4, layers=3)
    x = torch.randn(m, 256, device=dev).to(torch.bfloat16)
    for i in range(3):
        w = tqm.layer(stack, i)
        assert w.q.data_ptr() == stack.q.data_ptr() + i * 300 * 256
        out = fn(x, w)
        assert torch.equal(out, fn(x, cls(w.q.clone(), w.d.clone())))
        assert _rel_err(out, plain(x, w)) < tol


@pytest.mark.parametrize("contract,m,k", [("k1", 2, 16384), ("k1", 16, 16384),
                                          ("k6", 2, 32768), ("k6", 16, 16384),
                                          ("k1", 1, 65536)])
def test_q8_matvec_kernel_takes_wide_rows(dev, contract, m, k):
    """Where m activation rows of k columns leave the ring no room, the
    split takes them in column chunks, again for every tile."""
    fn, plain, _, tol = MATVEC[contract]
    w = _matvec_weight(dev, contract, 300, k, seed=m)
    x = torch.randn(m, k, device=dev).to(torch.bfloat16)
    assert _rel_err(fn(x, w), plain(x, w)) < tol
    split = tqm._matvec_plan(dev, 300, k, m, contract == "k6")
    assert split.layout["xcols"] < k


def test_q8_matvec_kernel_refuses_what_it_does_not_take(dev):
    w = _q8dot(dev, 64, 64, seed=0)
    x = torch.randn(2, 64, device=dev)
    for fn, cls in ((tqm.q8_matmul, tqm.Q8Weight),
                    (tqm.q8dot_matmul, tqm.Q8DotWeight)):
        with pytest.raises(ValueError):                   # no rows
            fn(torch.randn(0, 64, device=dev), cls(*w))
        with pytest.raises(ValueError):                   # k % 32 != 0
            fn(torch.randn(2, 48, device=dev),
               cls(w.q[:, :48].contiguous(), w.d[:, :1].contiguous()))
        d = torch.empty(64 * 2 + 1, device=dev)[1:].view(64, 2)
        d.copy_(w.d)
        with pytest.raises(ValueError):                   # misaligned d
            fn(x, cls(w.q, d))
        wide = _q8dot(dev, 8, 1 << 18, seed=1)
        with pytest.raises(ValueError):                   # no layout fits
            fn(torch.randn(1, 1 << 18, device=dev), cls(*wide))
    with pytest.raises(ValueError):                       # K6: m > 16
        tqm.q8dot_matmul(torch.randn(17, 64, device=dev), tqm.Q8DotWeight(*w))


def _q8i_chain(dev, m, seed, layers=None, widths=(QD, H, F, NQ),
               d_range=(1e-3, 3e-3)):
    """One K7 call's inputs as JAX's signature takes them: q8_0 columns
    and the residual column as transposed views of row-major tensors; the
    weights of the layer (with ``layers``: views of stacked tensors)."""
    qd, h, f, nq = widths
    g = torch.Generator(device=dev).manual_seed(seed)
    aq, as_ = tqm.quantize_act_q8(torch.randn(m, qd, generator=g,
                                              device=dev))
    resid = torch.randn(m, h, generator=g, device=dev)

    def q8(n, k, s):
        gw = torch.Generator(device=dev).manual_seed(seed * 8 + s)
        shape = (layers, n, k) if layers else (n, k)
        w = tqm.Q8DotWeight(
            torch.randint(-127, 128, shape, generator=gw, device=dev,
                          dtype=torch.int8),
            (torch.rand(*shape[:-1], k // 32, generator=gw, device=dev)
             * (d_range[1] - d_range[0]) + d_range[0]).half().float())
        return tqm.layer(w, 1) if layers else w

    def norm_w():
        return (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(
            torch.bfloat16)

    return (aq.t(), as_.t(), resid.t(), norm_w(), norm_w(), q8(h, qd, 1),
            q8(2 * f, h, 2), q8(h, f, 3), q8(nq, h, 4))


def _q8i_rows(dev, m, seed, **kw):
    """The decoder's K7 inputs: the merged attention rows [m, qd] in bf16
    (unquantized, as K2 returns them), the f32 residual rows, the norms and
    weights of ``_q8i_chain``."""
    args = _q8i_chain(dev, m, seed, **kw)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    attn = torch.randn(m, args[0].shape[0], generator=g, device=dev).to(
        torch.bfloat16)
    return (attn, args[2].t(), *args[3:])


def _last(args):
    """The last layer's form of a row-entry argument list (no qkv stage)."""
    return (*args[:3], None, *args[4:7], None)


# K7: the same integer partials and f32 intermediates; f32 sums in another
# order and the kernel's IEEE 1/sqrt against the plain version's
# torch.rsqrt can flip an isolated int8 value at a .5 boundary of a
# quantized row, as K4's bf16 ulps flip
K7_TOL = 5e-3


@pytest.mark.parametrize("m", [1, 2, 4, 8, 9, 16])
def test_q8i_layer_fused_kernel_matches_plain(dev, m):
    """Both entries and both forms: the decoder's (bf16 attention rows,
    quantized in the kernel) and JAX's (q8_0 columns)."""
    args = _q8i_rows(dev, m, seed=m)
    before = tqm.q8i_launches
    out, qkv = tqm.q8i_layer_fused_rows(*args, 1e-6)
    last, none = tqm.q8i_layer_fused_rows(*_last(args), 1e-6)
    torch.cuda.synchronize()
    assert tqm.q8i_launches == before + 2 and none is None
    ref_out, ref_qkv = tqm.q8i_layer_fused_rows_plain(*args, 1e-6)
    assert out.shape == (m, H) and qkv.shape == (m, NQ)
    assert _rel_err(out, ref_out) < K7_TOL
    assert _rel_err(qkv, ref_qkv) < K7_TOL
    assert _rel_err(last, ref_out) < K7_TOL
    cols = _q8i_chain(dev, m, seed=m)
    got = tqm.q8i_layer_fused(*cols, 1e-6)
    got_last = tqm.q8i_layer_fused(*cols[:4], None, *cols[5:8], None, 1e-6,
                                   with_qkv=False)
    ref = tqm.q8i_layer_fused_plain(*cols, 1e-6)
    assert got[0].shape == (H, m) and got[1].shape == (NQ, m)
    assert got[0].t().is_contiguous()        # a view of [m, H] rows
    assert got_last[1] is None
    assert _rel_err(got[0], ref[0]) < K7_TOL
    assert _rel_err(got[1], ref[1]) < K7_TOL
    assert _rel_err(got_last[0], ref[0]) < K7_TOL


@pytest.mark.parametrize("m", [1, 2, 9, 16])
def test_q8i_layer_fused_entries_are_bit_equal(dev, m):
    """The kernel's quantization of the attention rows is
    ``quantize_act_q8``'s IEEE arithmetic: the decoder's entry and JAX's
    entry on the rows ``quantize_act_q8`` made give the same outputs bit
    for bit, in both forms."""
    args = _q8i_rows(dev, m, seed=20 + m)
    aq, as_ = tqm.quantize_act_q8(args[0])
    for form in (args, _last(args)):
        out, qkv = tqm.q8i_layer_fused_rows(*form, 1e-6)
        cols = tqm.q8i_layer_fused(aq.t(), as_.t(), form[1].t(), *form[2:],
                                   1e-6, with_qkv=form[3] is not None)
        assert torch.equal(out, cols[0].t())
        if form[3] is not None:
            assert torch.equal(qkv, cols[1].t())


@pytest.mark.parametrize("m", [1, 9])
def test_q8i_layer_fused_kernel_repeats_bit_for_bit(dev, m):
    """Each row's sums are added in a fixed order whatever the blocks'
    timing: calls on the same inputs are equal bit for bit."""
    args = _q8i_rows(dev, m, seed=40 + m)
    first = tqm.q8i_layer_fused_rows(*args, 1e-6)
    last = tqm.q8i_layer_fused_rows(*_last(args), 1e-6)[0]
    for _ in range(3):
        for a, b in zip(first, tqm.q8i_layer_fused_rows(*args, 1e-6)):
            assert torch.equal(a, b)
        assert torch.equal(last,
                           tqm.q8i_layer_fused_rows(*_last(args), 1e-6)[0])


def test_q8i_layer_fused_kernel_takes_columns_and_stacked_layers(dev):
    args = _q8i_chain(dev, 3, seed=7, layers=3)
    assert args[5].q.data_ptr() == (args[5].q.untyped_storage().data_ptr()
                                    + H * QD)
    cols = [a.contiguous() for a in args[:3]] + list(args[3:])
    assert not cols[0].t().is_contiguous()
    ref = tqm.q8i_layer_fused_plain(*args, 1e-6)
    for got in (tqm.q8i_layer_fused(*args, 1e-6),
                tqm.q8i_layer_fused(*cols, 1e-6)):
        assert _rel_err(got[0], ref[0]) < K7_TOL
        assert _rel_err(got[1], ref[1]) < K7_TOL


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("with_qkv", [True, False])
def test_q8i_layer_fused_stage_timer(dev, m, with_qkv):
    """The timed launch gives the untimed one's outputs bit for bit; its
    stages are positive and add up to within 10 % of block 0's span, which
    lies inside the host's clock around the launch and its read-back."""
    args = _q8i_rows(dev, m, seed=50 + m)
    if not with_qkv:
        args = _last(args)
    plain = tqm.q8i_layer_fused_rows(*args, 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages, timed = tqm.q8i_layer_fused_stage_ms(*args, 1e-6)
    host_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(plain[0], timed[0])
    if with_qkv:
        assert torch.equal(plain[1], timed[1])
    names = ["o", "gate_up", "down"] + (["qkv"] if with_qkv else [])
    assert set(stages) == set(names) | {"span"}
    parts = [stages[k] for k in names]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(stages["span"], rel=0.1)
    assert 0 < stages["span"] < host_ms


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16])
def test_q8i_layer_fused_kernel_matches_plain_at_qwen3_width(dev, m):
    """Qwen3-0.6B's widths (o 1024x2048, gate_up 6144x1024, down 1024x3072,
    next qkv 4096x1024) with a trained checkpoint's scale magnitude, on the
    card's own grid and layout, both forms."""
    args = _q8i_rows(dev, m, seed=60 + m, widths=(2048, 1024, 3072, 4096),
                     d_range=(2e-4, 3.5e-4))
    for form in (args, _last(args)):
        got = tqm.q8i_layer_fused_rows(*form, 1e-6)
        ref = tqm.q8i_layer_fused_rows_plain(*form, 1e-6)
        for g, r in zip(got, ref):
            if r is not None:
                assert torch.isfinite(g).all()
                assert _rel_err(g, r) < K7_TOL


def test_q8i_layer_fused_split_fits_the_cards_grid(dev):
    """Two blocks an SM at m = 1, one at m > 1, at Qwen3-0.6B's widths."""
    from fun_asr_gguf_tpu_torch.kernels import build
    sms = build.sm_count(dev)
    for m, per_sm in ((1, 2), (9, 1), (16, 1)):
        split = tqm.q8_layer_fused_split(1024, 2048, 3072, 4096, m,
                                         per_sm * sms, q8i=True)
        assert build.grid_blocks("q8i_layer_fused_grid", m,
                                 split.smem) >= per_sm * sms


def test_q8i_layer_fused_kernel_refuses_what_it_does_not_take(dev):
    args = _q8i_chain(dev, 17, seed=3)
    with pytest.raises(ValueError):                       # m > 16
        tqm.q8i_layer_fused(*args, 1e-6)
    args = list(_q8i_chain(dev, 2, seed=3))
    o = args[5]
    bad = list(args)
    bad[5] = tqm.Q8DotWeight(torch.zeros(QD, H, dtype=torch.int8,
                                         device=dev).t(), o.d)
    with pytest.raises(ValueError):                       # not contiguous
        tqm.q8i_layer_fused(*bad, 1e-6)
    bad = list(args)
    bad[1] = args[1].half()
    with pytest.raises(TypeError):                        # f16 scales
        tqm.q8i_layer_fused(*bad, 1e-6)
    bad = list(args)
    bad[2] = args[2].to(torch.bfloat16)
    with pytest.raises(TypeError):                        # bf16 residual
        tqm.q8i_layer_fused(*bad, 1e-6)
    bad = list(args)
    bad[3], bad[4] = args[3].float(), args[4].float()
    with pytest.raises(TypeError):                        # f32 norm weights
        tqm.q8i_layer_fused(*bad, 1e-6)
    bad = list(args)
    bad[6] = tqm.Q8DotWeight(args[6].q, args[6].d.half())
    with pytest.raises(TypeError):                        # f16 weight scales
        tqm.q8i_layer_fused(*bad, 1e-6)
    with pytest.raises(ValueError):                       # qkv stage halves
        tqm.q8i_layer_fused(*args[:8], None, 1e-6)
    rows = list(_q8i_rows(dev, 2, seed=3))
    bad = list(rows)
    for dtype in (torch.float16, torch.float32):
        bad[0] = rows[0].to(dtype)
        with pytest.raises(TypeError):                    # not bf16 attention
            tqm.q8i_layer_fused_rows(*bad, 1e-6)
    bad = list(rows)
    bad[0] = torch.randn(QD, 2, device=dev).to(torch.bfloat16).t()
    with pytest.raises(ValueError):                       # column view
        tqm.q8i_layer_fused_rows(*bad, 1e-6)
    bad = list(rows)
    bad[1] = rows[1].to(torch.bfloat16)
    with pytest.raises(TypeError):                        # bf16 residual
        tqm.q8i_layer_fused_rows(*bad, 1e-6)
    with pytest.raises(ValueError):                       # qkv stage halves
        tqm.q8i_layer_fused_rows(*rows[:3], None, *rows[4:], 1e-6)


def test_p12_probe_stage_matches_plain(dev):
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as p12
    args = p12.p12_inputs(dev)
    ref = p12.p12_plain(*args)
    before = p12.launches
    for n in p12.CHUNK_COUNTS:
        got = p12.p12_stage(*args, -(-p12.S // n))
        assert _rel_err(got, ref) < p12.TOL
    assert p12.launches == before + len(p12.CHUNK_COUNTS)


def test_p5_probe_kernels_match_plain(dev):
    from fun_asr_gguf_tpu_torch.probes import q8_bw_probe as p5
    shapes = (("o", 256, 1024), ("gate_up", 384, 512), ("down", 256, 1536),
              ("qkv", 320, 512))
    ws = p5.make_weights(dev, layers=3, shapes=shapes, seed=1)
    isum, fsum = p5.stream_sum(ws)
    want_i, want_f = p5.stream_sum_plain(ws)
    assert int(isum.sum()) == want_i
    assert abs(float(fsum.double().sum()) - want_f) < 1e-4 * abs(want_f)
    x = torch.randn(1, 1536, device=dev).to(torch.bfloat16)
    ref = p5.gemv_plain(ws, x)
    assert _rel_err(p5.gemv(ws, x), ref) < p5.GEMV_TOL
    ws16 = [tqm.Q8Weight(w.q, w.d.half()) for w in ws]
    assert _rel_err(p5.gemv(ws16, x), ref) < p5.GEMV_TOL


def _small_probes(dev):
    """(probe, kernel, plain, inputs on the card, tolerance) of P3, P4,
    P6–P11: exact where the kernel rounds as the plain version does, JAX's
    atol where it sums in another order."""
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as mp
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    x = torch.arange(2048, dtype=torch.float32, device=dev).reshape(1, 2048)
    q8, r, cos, sin = mp.p8_inputs(dev)
    return [
        ("p3_reshape", lambda x: qp.reshape(x, (16, 128)),
         lambda x: qp.reshape_plain(x, (16, 128)), (x,), 0.0),
        ("p4_scale_expand_f16_tiled",
         lambda q, d: mp.expand_scales(q, d, True),
         lambda q, d: mp.expand_scales_plain(q, d, True), qp.p4_inputs(dev),
         0.0),
        ("p6_scale_expand_natural",
         lambda q, d: mp.expand_scales(q, d, False),
         lambda q, d: mp.expand_scales_plain(q, d, False), mp.p6_inputs(dev),
         0.0),
        ("p7_transpose", mp.transpose, mp.transpose_plain,
         mp.p7_inputs(dev), 0.0),
        ("p8a_rope_shuffle", mp.rope_shuffle, mp.rope_shuffle_plain,
         (q8, cos, sin), 0.0),
        ("p8b_rope_matrix", mp.rope_matrix, mp.rope_matrix_plain,
         (q8, r, cos, sin), mp.SUM_TOL),
        ("p9_batched_dot", mp.batched_dot, mp.batched_dot_plain,
         mp.p9_inputs(dev), mp.SUM_TOL),
        ("p10_pair_scale", mp.pair_scale, mp.pair_scale_plain,
         mp.p10_inputs(dev), 0.0),
        ("p11_head_sum", mp.head_sum, mp.head_sum_plain, mp.p11_inputs(dev),
         0.0),
    ]


def test_small_probe_kernels_match_plain(dev):
    from fun_asr_gguf_tpu_torch.probes import probe_launches
    for name, kernel, plain, args, tol in _small_probes(dev):
        before = probe_launches[name]
        got = kernel(*args)
        torch.cuda.synchronize()
        assert probe_launches[name] == before + 1, name
        assert (got - plain(*args)).abs().max().item() <= tol, name


def test_small_probe_kernels_take_ragged_shapes(dev):
    """Shapes off the probes' own: tiles, warps and pairs cut short."""
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as mp
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = randn(37, 70)
    assert torch.equal(mp.transpose(x), x.t())
    x = randn(3, 40)
    assert torch.equal(qp.reshape(x, (8, 15)), x.reshape(8, 15))
    q = torch.randint(-128, 128, (5, 96), generator=g, device=dev,
                      dtype=torch.int8)
    for d in (torch.rand(5, 3, generator=g, device=dev),
              torch.rand(5, 3, generator=g, device=dev).half()):
        for tiled in (True, False):
            assert torch.equal(mp.expand_scales(q, d, tiled),
                               mp.expand_scales_plain(q, d, tiled))
    q8, r, cos, sin = randn(13, 128), randn(128, 128), randn(128), randn(128)
    assert torch.equal(mp.rope_shuffle(q8, cos, sin),
                       mp.rope_shuffle_plain(q8, cos, sin))
    assert _rel_err(mp.rope_matrix(q8, r, cos, sin),
                    mp.rope_matrix_plain(q8, r, cos, sin)) < 1e-5
    a, b = randn(3, 5, 128), randn(3, 77, 128)
    assert _rel_err(mp.batched_dot(a, b), mp.batched_dot_plain(a, b)) < 1e-5
    x = randn(7, 128)
    assert torch.equal(mp.pair_scale(x), mp.pair_scale_plain(x))
    kv = randn(3, 37, 128)
    assert torch.equal(mp.head_sum(kv), mp.head_sum_plain(kv))
    kv = kv.transpose(0, 1).contiguous()
    assert torch.equal(mp.head_sum(kv, slot_major=True),
                       mp.head_sum_plain(kv, slot_major=True))


def test_p11_probe_reads_a_slot_major_block(dev):
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as mp
    (kv,) = mp.p11_inputs(dev)
    kv_s = kv.transpose(0, 1).contiguous()
    assert torch.equal(mp.head_sum(kv_s, slot_major=True), mp.head_sum(kv))
    assert torch.equal(mp.head_sum(kv_s, slot_major=True),
                       mp.head_sum_plain(kv_s, slot_major=True))


@pytest.mark.parametrize("layers,dims", [(3, (256, 128, 192, 384)),
                                         (2, (96, 64, 160, 224))])
def test_p2_probe_walk_and_barrier_only_launch(dev, layers, dims):
    from fun_asr_gguf_tpu_torch.probes import probe_launches
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    xm, res, pw, nw, ws = qp.p2_inputs(dev, layers=layers, dims=dims)
    before = dict(probe_launches)
    got = qp.p2_walk(xm, res, pw, nw, ws)
    for g, r in zip(got, qp.p2_plain(xm, res, pw, nw, ws)):
        assert _rel_err(g, r) < qp.P2_TOL
    for barriers, blocks in ((9, None), (15, qp.k5_grid(dims[1]))):
        out, qkv = qp.p2_walk(xm, res, pw, nw, ws, barriers=barriers,
                              blocks=blocks)
        torch.cuda.synchronize()
        assert torch.equal(out, res) and not qkv.any()
    assert (probe_launches["p2_q8_layer_walk"]
            == before["p2_q8_layer_walk"] + 1)
    assert probe_launches["p2_barrier_only"] == before["p2_barrier_only"] + 2


def test_p2_probe_layers_leave_nothing_to_the_next(dev):
    """Every layer rewrites all of the scratch it reuses (h1, act, out,
    qkv): NaN scales in every layer but the last leave the result as it
    is with sane ones."""
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    xm, res, pw, nw, ws = qp.p2_inputs(dev, layers=3,
                                       dims=(256, 128, 192, 384))
    want = [t.clone() for t in qp.p2_walk(xm, res, pw, nw, ws)]
    bad = []
    for w in ws:
        d = w.d.clone()
        d[:-1] = float("nan")
        bad.append(tqm.Q8Weight(w.q, d))
    got = qp.p2_walk(xm, res, pw, nw, bad)
    for g, r in zip(got, want):
        assert torch.isfinite(g).all() and torch.equal(g, r)


def test_p1_probe_chain_launches_k4_per_layer(dev):
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    xm, res, pw, nw, ws = qp.p2_inputs(dev, layers=3,
                                       dims=(256, 128, 192, 384))
    before = tqm.fused_launches
    got = qp.p1_chain(xm, res, pw, nw, ws)
    assert tqm.fused_launches == before + 3
    for g, r in zip(got, qp.p1_chain(xm, res, pw, nw, ws, plain=True)):
        assert _rel_err(g, r) < qp.P1_TOL


def test_probe_kernels_refuse_what_they_do_not_take(dev):
    from fun_asr_gguf_tpu_torch.probes import q8_mega_probes as mp
    from fun_asr_gguf_tpu_torch.probes import q8_probe as qp
    q, d = mp.p6_inputs(dev)
    with pytest.raises(ValueError):                    # scales of 64 lanes
        mp.expand_scales(q, d[:, :16].contiguous(), tiled=False)
    with pytest.raises(TypeError):                     # bf16 scales
        mp.expand_scales(q, d.to(torch.bfloat16), tiled=False)
    with pytest.raises(TypeError):
        mp.transpose(mp.p7_inputs(dev)[0].double())
    q8, r, cos, sin = mp.p8_inputs(dev)
    with pytest.raises(ValueError):                    # head_dim 64
        mp.rope_shuffle(q8[:, :64].contiguous(), cos[:64].contiguous(),
                        sin[:64].contiguous())
    with pytest.raises(ValueError):                    # R on the CPU
        mp.rope_matrix(q8, r.cpu(), cos, sin)
    a, b = mp.p9_inputs(dev)
    with pytest.raises(ValueError):                    # 9 rows per batch
        mp.batched_dot(torch.randn(8, 9, 128, device=dev), b)
    with pytest.raises(ValueError):                    # not contiguous
        mp.pair_scale(torch.randn(128, 16, device=dev).t())
    with pytest.raises(ValueError):
        mp.head_sum(mp.p11_inputs(dev)[0][:, :, :64].contiguous())
    with pytest.raises(ValueError):                    # sizes differ
        qp.reshape(torch.zeros(1, 512, device=dev), (16, 128))
    xm, res, pw, nw, ws = qp.p2_inputs(dev, layers=2, dims=(64, 32, 64, 96))
    with pytest.raises(TypeError):                     # f32 xm
        qp.p2_walk(xm.float(), res, pw, nw, ws)
    with pytest.raises(ValueError):                    # qkv of another width
        qp.p2_walk(xm, res, pw, nw, ws[:3] + [tqm.layer(ws[3], 0)])


# ---------------------------------------------------------------------------
# the decode step's CUDA graph (models/decode_graph.py)
# ---------------------------------------------------------------------------

GRAPH_STEPS = 40


def _graph_setup(dev, route, kv_int8=False, seed=3):
    """Full-width params of ``route`` and a prefilled one-row state (the
    decode-graph probe's), on the card: (params, cfg, state)."""
    from fun_asr_gguf_tpu_torch.models.config import Qwen3Config
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    cfg = Qwen3Config()
    params = gp.decode_params(dev, route, cfg)
    return params, cfg, gp.prefilled(dev, params, cfg, kv_int8, seed=seed)


def _graph_tokens(dev, n, seed, vocab):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (n, 1), generator=g, device=dev)


def _same_kv(a, b):
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    return all(torch.equal(x, y)
               for x, y in zip(dg._tensors(a), dg._tensors(b)))


GRAPH_ROUTES = [("q8_0", False), ("q8_0", True), ("int8", False),
                ("int8", True), ("mega", False), ("q8i", False)]


@pytest.mark.parametrize("route,kv_int8", GRAPH_ROUTES)
def test_decode_graph_replays_are_eager_steps(dev, route, kv_int8):
    """40 replays give the logits and cache of 40 eager steps, bit for bit,
    and add to the launch counters what the eager steps add; a second
    state of the shape captures nothing."""
    from fun_asr_gguf_tpu_torch import profiling
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, first = _graph_setup(dev, route, kv_int8, seed=1)
    toks = _graph_tokens(dev, GRAPH_STEPS, 3, cfg.vocab_size)
    graphs = dg.DecodeGraphs()
    gp.graph_step(graphs, params, first, toks[0], cfg)      # captures
    eager = gp.prefilled(dev, params, cfg, kv_int8, seed=2)
    graphed = gp.clone(eager)
    assert eager.kv.head_major is (route == "mega")
    named = profiling.counters()
    launches = dg.counts()[0]
    got = []
    for t in toks:
        gp.graph_step(graphs, params, graphed, t, cfg)
        got.append(graphed.logits.clone())
    torch.cuda.synchronize()
    replayed = {k: v - launches[k] for k, v in dg.counts()[0].items()}
    after = profiling.counters()
    assert after["decode.graph_captures"] == named["decode.graph_captures"]
    assert after["decode.graph_replays"] == \
        named["decode.graph_replays"] + GRAPH_STEPS
    launches = dg.counts()[0]
    for i, t in enumerate(toks):
        gp.eager_step(params, eager, t, cfg)
        assert torch.isfinite(eager.logits).all()
        assert torch.equal(got[i], eager.logits), i
    assert _same_kv(graphed.kv, eager.kv)
    eagerly = {k: v - launches[k] for k, v in dg.counts()[0].items()}
    assert replayed == eagerly and any(eagerly.values())


def test_decode_graph_second_request_captures_nothing(dev):
    """generate_chunk on a second state of the same shape replays every
    step through the engine's graphs and captures nothing."""
    from fun_asr_gguf_tpu_torch import profiling
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.models import generate as tg
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, _ = _graph_setup(dev, "q8_0")
    graphs = dg.DecodeGraphs()
    for seed in (1, 2):
        state = gp.prefilled(dev, params, cfg, False, seed=seed)
        before = profiling.counters()
        tg.generate_chunk(params, state, cfg, 0.4, 1.0, 50, chunk_len=16,
                          stop_tokens=(), graphs=graphs)
        now = profiling.counters()
        grew = {k: now.get(k, 0) - before.get(k, 0) for k in (
            "decode.steps", "decode.graph_replays", "decode.graph_captures")}
        assert grew["decode.steps"] == grew["decode.graph_replays"] == 16
        assert grew["decode.graph_captures"] == (1 if seed == 1 else 0)


def test_decode_graph_second_live_state_keeps_its_cache(dev):
    """Two live states of one shape take turns through one graph: each
    stays equal to its own eager steps."""
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, _ = _graph_setup(dev, "q8_0")
    toks = _graph_tokens(dev, 12, 5, cfg.vocab_size)
    refs = [gp.prefilled(dev, params, cfg, False, seed=s) for s in (1, 2)]
    states = [gp.clone(r) for r in refs]
    graphs = dg.DecodeGraphs()
    for turn, k in enumerate([0, 1, 0, 1]):
        for t in toks[3 * turn:3 * turn + 3]:
            gp.eager_step(params, refs[k], t, cfg)
            gp.graph_step(graphs, params, states[k], t, cfg)
        for s, r in zip(states, refs):
            if s.step:
                assert torch.equal(s.logits, r.logits), turn
                assert _same_kv(s.kv, r.kv), turn
        assert states[1 - k].kv is not states[k].kv


def test_decode_graph_takes_the_cache_after_verify_rounds(dev):
    """Verify rounds, spec_to_gen, then replays: equal to eager steps from
    the same converted state."""
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.models import speculative as tsp
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, state = _graph_setup(dev, "q8_0", seed=4)
    spec = tsp.spec_init(state)
    draft = _graph_tokens(dev, 32, 6, cfg.vocab_size).reshape(1, 32)
    tsp.spec_generate_chunk(params, spec, draft, cfg, 0.4, 1.0, 50,
                            spec_k=8, chunk_len=16, stop_tokens=(),
                            limit=6)
    got = tsp.spec_to_gen(spec)
    ref = gp.clone(got)
    graphs = dg.DecodeGraphs()
    for t in _graph_tokens(dev, 12, 7, cfg.vocab_size):
        gp.eager_step(params, ref, t, cfg)
        gp.graph_step(graphs, params, got, t, cfg)
        assert torch.equal(got.logits, ref.logits)
    assert _same_kv(got.kv, ref.kv)


# ---------------------------------------------------------------------------
# the verify round's CUDA graph (models/speculative.py)
# ---------------------------------------------------------------------------

VERIFY_ROUNDS = 16


@pytest.mark.parametrize("temperature", [0.0, 0.4])
@pytest.mark.parametrize("route,kv_int8", [("q8_0", False), ("q8_0", True),
                                           ("int8", False), ("q8i", False)])
def test_verify_graph_replays_are_eager_rounds(dev, route, kv_int8,
                                               temperature):
    """16 replayed rounds give the tokens, carry, cache and generator state
    of 16 eager rounds, bit for bit, and add to the launch counters what
    the eager rounds add; a second state of the shape captures nothing."""
    from fun_asr_gguf_tpu_torch import profiling
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.models import speculative as tsp
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, base = _graph_setup(dev, route, kv_int8, seed=1)
    draft = gp.verify_draft(dev, cfg.vocab_size)
    graphs = dg.DecodeGraphs()
    gp.verify_chunk(graphs, params, tsp.spec_init(gp.clone(base)), draft,
                    cfg, temperature, 1)                         # captures
    graphed = tsp.spec_init(gp.clone(base))
    eager = tsp.spec_init(gp.clone(base))
    named = profiling.counters()
    launches = dg.counts()[0]
    got = gp.verify_chunk(graphs, params, graphed, draft, cfg, temperature,
                          VERIFY_ROUNDS)
    torch.cuda.synchronize()
    replayed = {k: v - launches[k] for k, v in dg.counts()[0].items()}
    after = profiling.counters()
    assert after["spec.graph_captures"] == named["spec.graph_captures"]
    assert after["spec.graph_replays"] == \
        named["spec.graph_replays"] + VERIFY_ROUNDS
    launches = dg.counts()[0]
    want = gp.verify_chunk(None, params, eager, draft, cfg, temperature,
                           VERIFY_ROUNDS)
    torch.cuda.synchronize()
    eagerly = {k: v - launches[k] for k, v in dg.counts()[0].items()}
    assert int(eager.rounds[0]) == VERIFY_ROUNDS
    assert torch.isfinite(eager.logits).all()
    assert torch.equal(got, want)
    assert gp.same_rounds(graphed, eager)
    assert replayed == eagerly and any(eagerly.values())


@pytest.mark.parametrize("temperature", [0.0, 0.4])
@pytest.mark.parametrize("route,kv_int8", [("q8_0", False), ("q8_0", True),
                                           ("int8", False), ("q8i", False)])
def test_verify_graph_rounds_are_the_parent_rounds(dev, route, kv_int8,
                                                   temperature):
    """16 replayed rounds give the tokens, carry, cache and generator state
    of 16 rounds of the eager chunk that drew inside the round and baked
    its numbers in (``tests/test_torch_verify_graph.py``'s copy): the same
    draws, and the temperature's division with the same bits."""
    from test_torch_verify_graph import parent_chunk

    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.models import speculative as tsp
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, base = _graph_setup(dev, route, kv_int8, seed=1)
    draft = gp.verify_draft(dev, cfg.vocab_size)
    graphs = dg.DecodeGraphs()
    gp.verify_chunk(graphs, params, tsp.spec_init(gp.clone(base)), draft,
                    cfg, temperature, 1)                         # captures
    graphed = tsp.spec_init(gp.clone(base))
    parent = tsp.spec_init(gp.clone(base))
    got = gp.verify_chunk(graphs, params, graphed, draft, cfg, temperature,
                          VERIFY_ROUNDS)
    want = parent_chunk(params, parent, draft, cfg, temperature, 1.0, 50,
                        spec_k=gp.SPEC_K, chunk_len=gp.CHUNK, stop_tokens=(),
                        limit=VERIFY_ROUNDS)
    assert int(parent.rounds[0]) == VERIFY_ROUNDS
    assert torch.equal(got, want)
    assert gp.same_rounds(graphed, parent)


def test_verify_graph_second_request_captures_nothing(dev):
    """spec_generate_chunk on a second state of the same shape replays
    every round through the engine's graphs and captures nothing."""
    from fun_asr_gguf_tpu_torch import profiling
    from fun_asr_gguf_tpu_torch.models import decode_graph as dg
    from fun_asr_gguf_tpu_torch.models import speculative as tsp
    from fun_asr_gguf_tpu_torch.probes import decode_graph_probe as gp
    params, cfg, _ = _graph_setup(dev, "q8_0")
    draft = gp.verify_draft(dev, cfg.vocab_size)
    graphs = dg.DecodeGraphs()
    for seed in (1, 2):
        state = tsp.spec_init(gp.prefilled(dev, params, cfg, False,
                                           seed=seed))
        before = profiling.counters()
        tsp.spec_generate_chunk(params, state, draft, cfg, 0.4, 1.0, 50,
                                spec_k=8, chunk_len=64, stop_tokens=(),
                                limit=VERIFY_ROUNDS, graphs=graphs)
        now = profiling.counters()
        grew = {k: now.get(k, 0) - before.get(k, 0) for k in (
            "spec.rounds", "spec.graph_replays", "spec.graph_captures")}
        assert grew["spec.rounds"] == VERIFY_ROUNDS
        assert grew["spec.graph_captures"] == (1 if seed == 1 else 0)
        assert grew["spec.graph_replays"] == VERIFY_ROUNDS - grew[
            "spec.graph_captures"]


def test_engine_captures_its_graphs_only_at_warm_up(dev, tmp_path):
    """An engine built with ``warmup=True`` captures its verify and decode
    graphs while it warms up; two requests after it, greedy and sampled,
    replay every verify round and decode step and capture nothing."""
    import base64
    import dataclasses

    import numpy as np

    from fun_asr_gguf_tpu_torch import create_asr_engine, profiling
    from fun_asr_gguf_tpu_torch.audio import write_wav
    from fun_asr_gguf_tpu_torch.models.config import HybridConfig
    from fun_asr_gguf_tpu_torch.models.loaders import write_random_checkpoint
    full = HybridConfig()
    small = HybridConfig(       # Qwen3-0.6B's and the encoder's widths
        encoder=dataclasses.replace(full.encoder, num_blocks=2, tp_blocks=1),
        adaptor=full.adaptor,
        ctc=dataclasses.replace(full.ctc, adaptor=dataclasses.replace(
            full.ctc.adaptor, n_layers=1)),
        llm=dataclasses.replace(full.llm, n_layers=2))
    ckpt = str(tmp_path / "ckpt")
    cfg = write_random_checkpoint(ckpt, small, seed=0)
    with open(tmp_path / "ckpt" / "tokens.txt", "w", encoding="utf-8") as f:
        for i in range(cfg.ctc.vocab_size):
            ch = chr(0x4E00 + i % 20000) if i < cfg.ctc.vocab_size - 1 \
                else "<blk>"
            f.write(f"{base64.b64encode(ch.encode()).decode()} {i}\n")
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.random.default_rng(0).normal(size=48000) * 0.05, 16000)
    names = ("spec.rounds", "spec.graph_replays", "spec.graph_captures",
             "decode.steps", "decode.graph_replays", "decode.graph_captures")
    start = profiling.counters()
    engine = create_asr_engine(ckpt, verbose=False, n_predict=24,
                               segment_pad_seconds=4.0)
    try:
        built = profiling.counters()
        for temperature in (0.0, 0.4):
            res = engine.transcribe(wav, verbose=False,
                                    temperature=temperature)
            assert res.ctc_text and isinstance(res.text, str)
        now = profiling.counters()
    finally:
        engine.cleanup()
    warm = {k: built.get(k, 0) - start.get(k, 0) for k in names}
    grew = {k: now.get(k, 0) - built.get(k, 0) for k in names}
    assert warm["spec.graph_captures"] >= 1, warm
    assert warm["decode.graph_captures"] >= 1, warm
    assert grew["spec.graph_captures"] == grew["decode.graph_captures"] == 0
    assert grew["spec.rounds"] >= 16, grew
    assert grew["spec.graph_replays"] == grew["spec.rounds"], grew
    assert grew["decode.graph_replays"] == grew["decode.steps"], grew
