"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one. The module imports no jax, so it also runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes cover the ragged edges the main path's shapes do not (m, n, T not
multiples of the kernels' tiles); ``chip_smoke.py`` covers the main
path's own shapes.
"""

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
    # same bf16 products, f32 sums in another order
    w = _q8(dev, n, k, seed=m + n)
    x = torch.randn(m, k, device=dev)
    before = tqm.launches
    out = tqm.q8_matmul(x, w)
    torch.cuda.synchronize()
    assert tqm.launches == before + 1
    assert _rel_err(out, tqm.q8_matmul_plain(x, w)) < 1e-4


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
    with pytest.raises(ValueError):                       # shared memory
        big = _i8_cache(dev, 1, 3000, 8, seed=1)
        tfd.flash_decode_attention(
            torch.zeros(1, 9, 16, 128, device=dev, dtype=torch.bfloat16),
            big[0], big[1], torch.zeros(1, 9, 3000, device=dev), *big[2:])


QD, H, F, NQ = 512, 256, 384, 640     # K4 test widths (all % 32 == 0)


def _chain(dev, m, seed, layers=None):
    """Inputs of one K4 call; with ``layers`` the weights are views of
    stacked [layers, n, k] tensors (layer 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def q8(n, k):
        shape = (layers, n, k) if layers else (n, k)
        w = tqm.Q8Weight(
            torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8),
            (torch.rand(*shape[:-1], k // 32, generator=g, device=dev)
             * 2e-3 + 1e-3).half().float())
        return tqm.layer(w, 1) if layers else w

    def norm_w():
        return (1 + 0.1 * torch.randn(H, generator=g, device=dev)).to(bf)

    xm = torch.randn(m, QD, generator=g, device=dev).to(bf)
    resid = torch.randn(m, H, generator=g, device=dev).to(bf)
    return (xm, resid, norm_w(), norm_w(), q8(H, QD), q8(2 * F, H),
            q8(H, F), q8(NQ, H))


# same bf16 products; f32 sums in another order can flip isolated bf16
# ulps of the normed rows and of the gated product (measured up to 2.3e-3
# at m = 16)
K4_TOL = 5e-3


@pytest.mark.parametrize("m", [1, 2, 9, 16])
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


def test_q8_layer_fused_kernel_reads_a_stacked_layer_in_place(dev):
    xm, resid, pw, nw, o, gu, dn, qkv = _chain(dev, 3, seed=7, layers=3)
    assert o.q.data_ptr() == o.q.untyped_storage().data_ptr() + H * QD
    out, got_qkv = tqm.q8_mlp_qkv_fused(xm, resid, pw, nw, o, gu, dn, qkv,
                                        1e-6)
    ref_out, ref_qkv = tqm.q8_mlp_qkv_fused_plain(xm, resid, pw, nw, o, gu,
                                                  dn, qkv, 1e-6)
    assert _rel_err(out, ref_out) < K4_TOL
    assert _rel_err(got_qkv, ref_qkv) < K4_TOL


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


def test_flash_attention_kernel_refuses_float32(dev):
    q = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q, torch.zeros(1, 8, device=dev))
