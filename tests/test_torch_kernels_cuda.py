"""The port's hand-written kernels on the card: each against its plain version.

These need an NVIDIA Hopper GPU (sm_90) with `nvcc`; elsewhere
they skip, deciding at run time in the `cuda` fixture. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m gpu -q

Tolerances are stated per test. Attention is held element by element to
`chip_smoke.attention_bounds` (the output's rounding plus P's rounding to the
input dtype before P.v); GroupNorm to one ulp at the reference's largest
magnitude; the w8a8 matmul to one bf16 ulp per element (its int32 sums are
exact on both sides, so it is in fact bit-equal) and its row quantization to
bit equality. The attention backward (K2, K3) is held element by element to
`chip_smoke.attention_bwd_bounds` (P and dS rounded to the input dtype before
their products, f32 sums in another order, the outputs' rounding).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    FLASH_BWD_CARD_CASES,
    FLUX_W8A8_SHAPES,
    GN_UNET_CALL,
    GN_VAE_DECODE,
    GN_VAE_ENCODE,
    W8A8_TILE_CASES,
    attention_bounds,
    attention_bwd_bounds,
    bf16_ulp,
)
from diffusers_tpu_torch.ops.attention import _auto_backend, dispatch_attention_fn
from diffusers_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dq,
    flash_attention_full,
    flash_attention_plain,
    pick_split,
)
from diffusers_tpu_torch.ops.cuda._build import sm_count
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import (
    quantize_rows,
    quantize_rows_plain,
    w8a8_matmul,
    w8a8_matmul_2d,
    w8a8_matmul_2d_plain,
)
from diffusers_tpu_torch.ops.cuda.group_norm import (
    _group_norm_cuda,
    chunk_bounds,
    group_norm,
    group_norm_bwd,
    group_norm_plain,
    plan_group_norm,
)
from diffusers_tpu_torch.quantizers import quantize_kernel_int8

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA Hopper (sm_90) GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


@pytest.mark.parametrize(
    "b,sq,sk,h,d,causal,masked,dtype",
    [
        (2, 1024, 1024, 4, 64, False, False, torch.bfloat16),
        (2, 512, 77, 4, 64, False, False, torch.bfloat16),
        (1, 300, 300, 2, 64, True, False, torch.bfloat16),
        (1, 130, 300, 2, 64, True, False, torch.bfloat16),  # causal, Sq < Sk: top-left aligned
        (2, 300, 130, 2, 128, True, True, torch.bfloat16),  # causal + mask, Sq > Sk
        (1, 200, 333, 2, 128, False, True, torch.bfloat16),
        (1, 500, 700, 3, 128, False, False, torch.float16),
        (3, 1, 5, 1, 64, False, False, torch.float16),
        (1, 4097, 77, 2, 64, False, False, torch.bfloat16),  # Sq past a 128-row tile; TMA's zero fill
        (2, 300, 1, 2, 128, False, False, torch.bfloat16),  # Sk = 1
        (1, 300, 77, 2, 64, False, False, torch.float16),
        (1, 256, 256, 2, 128, True, False, torch.float16),
        (2, 300, 200, 3, 64, False, True, torch.float16),  # broadcast mask, fp16
        # a float mask of -inf or finfo.min (the port's masked value) over the first 160 keys of every
        # other row: a whole 128-key kv tile hidden, which must give no inf - inf
        (2, 300, 333, 2, 64, False, "-inf", torch.bfloat16),
        (2, 300, 333, 2, 128, False, "finfo.min", torch.float16),
        # finfo.min over every key of query row 5: NaN out and -inf LSE there, as the plain version and
        # JAX's `_fwd_kernel` give
        (1, 128, 128, 1, 64, False, "row", torch.bfloat16),
    ],
)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, h, d, causal, masked, dtype):
    """K1 within `attention_bounds` of its plain version; where the plain
    version is NaN (a row whose every logit a finfo.min mask hides) K1 is NaN
    too, with the same -inf LSE (compared with ``equal_nan``)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (b, sq, h, d), dtype, cuda, scale=2.0)
    k = _randn(gen, (b, sk, h, d), dtype, cuda)
    v = _randn(gen, (b, sk, h, d), dtype, cuda)
    mask = None
    if masked in ("-inf", "finfo.min"):
        mask = torch.zeros((b, 1, sq, sk), device=cuda)
        mask[:, :, ::2, :160] = float("-inf") if masked == "-inf" else torch.finfo(torch.float32).min
    elif masked == "row":
        mask = torch.zeros((b, 1, sq, sk), device=cuda)
        mask[:, :, 5, :] = torch.finfo(torch.float32).min
    elif masked:
        mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=cuda) < 0.3, -1e4, 0.0)
    before = flash_attention_full.launches
    out, lse = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_full.launches == before + 1
    _, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), attn_mask=mask, is_causal=causal,
                                       return_lse=True)
    ref, bound, _ = attention_bounds(q, k, v, attn_mask=mask, is_causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isnan(out), torch.isnan(ref)) and bool(fin.any())
    assert bool(((out.float() - ref).abs() <= bound)[fin].all())
    # f32 online softmax (exp2) vs exact f32; -inf where the plain version has it
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3, equal_nan=True)


def test_flash_kernel_lse_at_flux_shape(cuda):
    """The LSE at Flux's joint attention (1, 4608, 24, 128): natural log, after
    the final rescale, against torch.logsumexp of the f32 logits (f32 online
    softmax in base 2 against exact f32: 1e-3)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (_randn(gen, (1, 4608, 24, 128), torch.bfloat16, cuda, scale=s) for s in (2.0, 1.0, 1.0))
    _, lse = flash_attention_full(q, k, v, return_lse=True)
    for h0 in range(0, 24, 6):  # the logits a few heads at a time
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, :, h0:h0 + 6].float(), k[:, :, h0:h0 + 6].float()) / 128**0.5
        assert float((lse[:, h0:h0 + 6] - torch.logsumexp(logits, dim=-1)).abs().max()) <= 1e-3


def test_flash_kernel_reads_strided_bshd(cuda):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: non-contiguous,
    read through strides without copies."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn(gen, (2, 256, 3, 4, 64), torch.bfloat16, cuda)
    q, k, v = qkv.unbind(dim=2)
    out = flash_attention_full(q, k, v)
    ref, bound, _ = attention_bounds(q, k, v)
    assert bool(((out.float() - ref).abs() <= bound).all())


@pytest.mark.parametrize("sq,sk", [(1024, 1024), (512, 77)])
def test_flash_bound_rejects_a_dropped_kv_tile(cuda, sq, sk):
    """Control: the kernel run without 64 of the keys breaks the bound."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _randn(gen, (2, sq, 4, 64), torch.bfloat16, cuda, scale=2.0)
    k = _randn(gen, (2, sk, 4, 64), torch.bfloat16, cuda)
    v = _randn(gen, (2, sk, 4, 64), torch.bfloat16, cuda)
    t0 = (sk // 2) // 64 * 64
    keep = torch.cat([torch.arange(t0, device=cuda), torch.arange(min(t0 + 64, sk), sk, device=cuda)])
    ref, bound, _ = attention_bounds(q, k, v)
    assert bool(((flash_attention_full(q, k, v).float() - ref).abs() <= bound).all())
    assert not bool(((flash_attention_full(q, k[:, keep], v[:, keep]).float() - ref).abs() <= bound).all())


def test_dispatch_routes_by_kernel_support(cuda):
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    assert _auto_backend(q, q, q) == "flash"
    big = torch.zeros(1, 64, 1, 512, device=cuda, dtype=torch.bfloat16)  # VAE mid-block head
    assert _auto_backend(big, big, big) == "native"
    before = flash_attention_full.launches
    dispatch_attention_fn(q, q, q)
    assert flash_attention_full.launches == before + 1
    # a head dim the kernel takes goes to the kernel, which refuses f32: no silent plain route on the card
    f32 = q.float()
    assert _auto_backend(f32, f32, f32) == "flash"
    with pytest.raises(ValueError, match="sm_90a"):
        dispatch_attention_fn(f32, f32, f32)
    assert flash_attention_full.launches == before + 1


@pytest.mark.parametrize("shape", [(2, 320, 32, 32), (1, 128, 256, 256), (2, 96, 7, 9), (2, 64, 1000)])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_group_norm_kernel_matches_plain(cuda, shape, silu, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    c = shape[1]
    x = _randn(gen, shape, dtype, cuda, scale=1.5) + 3.0  # a mean far from 0 against the spread
    w = _randn(gen, (c,), dtype, cuda, scale=0.1) + 1
    b = _randn(gen, (c,), dtype, cuda, scale=0.1)
    before = group_norm.launches
    out = group_norm(x, w, b, 32, 1e-6, apply_silu=silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    ref = group_norm_plain(x.float(), w.float(), b.float(), 32, 1e-6, apply_silu=silu)
    ulp = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: 2.0**-20}[dtype]
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= ulp * max(1.0, float(ref.abs().max())) + 1e-5


_GN_SHAPES = list(dict.fromkeys(shape for shape, _, _ in GN_UNET_CALL + GN_VAE_DECODE + GN_VAE_ENCODE))


@pytest.mark.parametrize("shape", _GN_SHAPES, ids=["x".join(map(str, s)) for s in _GN_SHAPES])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_kernel_at_the_main_path_shapes(cuda, shape, silu):
    """K4 at every GroupNorm shape of an SDXL UNet call, a VAE decode and a VAE encode,
    bf16 (both regimes of `plan_group_norm`): within one bf16 ulp at the
    reference's largest magnitude of the f32 plain version, one launch a
    call, and two launches bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    c = shape[1]
    x = _randn(gen, shape, torch.bfloat16, cuda, scale=1.5) + 0.5
    w = _randn(gen, (c,), torch.bfloat16, cuda, scale=0.1) + 1
    b = _randn(gen, (c,), torch.bfloat16, cuda, scale=0.1)
    before = group_norm.launches
    out = group_norm(x, w, b, 32, 1e-6, apply_silu=silu)
    assert group_norm.launches == before + 1
    again = group_norm(x, w, b, 32, 1e-6, apply_silu=silu)
    assert torch.equal(out, again)
    ref = group_norm_plain(x.float(), w.float(), b.float(), 32, 1e-6, apply_silu=silu)
    assert float((out.float() - ref).abs().max()) <= 2.0**-7 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("shape", [(2, 320, 64, 64), (1, 512, 256, 256)], ids=["cluster", "split"])
def test_group_norm_bound_rejects_a_dropped_partial(cuda, shape):
    """Control: K4 with one cluster rank's or one chunk's partial left out of
    its statistics, on inputs whose chunk of that partial is shifted by 20,
    breaks the one-ulp limit more than tenfold."""
    plan = plan_group_norm(shape, torch.bfloat16, sm_count(cuda.index or 0))
    assert plan.split == (shape[1] == 512)
    gen = torch.Generator(device=cuda).manual_seed(15)
    c = shape[1]
    x = _randn(gen, shape, torch.bfloat16, cuda, scale=1.5) + 0.5
    w = _randn(gen, (c,), torch.bfloat16, cuda, scale=0.1) + 1
    b = _randn(gen, (c,), torch.bfloat16, cuda, scale=0.1)
    span = x[0].numel() // 32
    drop = plan.parts // 2
    lo, hi = chunk_bounds(plan, span)[drop]
    x.view(-1, span)[:, lo:hi] += 20.0
    ref = group_norm_plain(x.float(), w.float(), b.float(), 32, 1e-6, apply_silu=True)
    tol = 2.0**-7 * max(1.0, float(ref.abs().max()))
    assert float((group_norm(x, w, b, 32, 1e-6, apply_silu=True).float() - ref).abs().max()) <= tol
    broken = _group_norm_cuda(x, w, b, 32, 1e-6, True, _drop_partial=drop)
    assert float((broken.float() - ref).abs().max()) > 10 * tol


def test_group_norm_kernel_rejects_non_contiguous(cuda):
    x = torch.zeros(2, 64, 8, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm(x, None, None, 32)


def test_small_pipeline_on_card_matches_cpu(cuda):
    import chip_smoke

    chip_smoke.check_small_reference("cuda")
    assert np.isfinite(chip_smoke.RESULTS["small_reference"]["max_abs_err"])


def test_flash_attention_k6_runs_k1(cuda):
    """The forward-only `flash_attention` (K6's counterpart) launches K1."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_randn(gen, (1, 512, 2, 128), torch.bfloat16, cuda) for _ in range(3))
    before = flash_attention_full.launches
    out = flash_attention(q, k, v, scale=0.2, is_causal=True)
    assert flash_attention_full.launches == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), scale=0.2, is_causal=True)
    pv = flash_attention_plain(q.float(), k.float(), v.float().abs(), scale=0.2, is_causal=True)
    assert bool(((out.float() - ref).abs() <= (2.0**-8 + 2.0**-14) * (ref.abs() + pv)).all())


@pytest.mark.parametrize("m,k,n", [s[:3] for s in FLUX_W8A8_SHAPES] + [(37, 256, 384), (130, 128, 128)])
def test_w8a8_kernels_match_plain_at_flux_shapes(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(gen, (m, k), torch.bfloat16, cuda, scale=2.0)
    qw, ws = quantize_kernel_int8(_randn(gen, (n, k), torch.float32, cuda) / k**0.5)
    bias = _randn(gen, (n,), torch.bfloat16, cuda, scale=0.1)
    before = (quantize_rows.launches, w8a8_matmul_2d.launches)
    qx, xs = quantize_rows(x)
    qx_p, xs_p = quantize_rows_plain(x)
    assert torch.equal(qx, qx_p) and torch.equal(xs, xs_p)
    y = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias)
    ref = w8a8_matmul_2d_plain(qx, qw, xs, ws, torch.bfloat16, bias)
    torch.cuda.synchronize()
    assert (quantize_rows.launches, w8a8_matmul_2d.launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    assert bool(((y.float() - ref.float()).abs() <= bf16_ulp(ref)).all())
    # control: one 64-wide K slice left out breaks the limit
    skipped = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias, _skip_k_tile=(k // 64) // 2)
    assert not bool(((skipped.float() - ref.float()).abs() <= bf16_ulp(ref)).all())


@pytest.mark.parametrize("m,n", W8A8_TILE_CASES)
def test_w8a8_kernel_is_bit_equal_for_every_tile(cuda, m, n):
    """Ragged M (TMA's zero-filled rows are not stored), at shapes that
    between them reach every tile `pick_tile` can return (checked on the CPU
    by `test_k5_tile_cases_reach_every_tile`): bit-equal to the plain version
    (exact int32 sums)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    k = 768
    qx, xs = quantize_rows_plain(_randn(gen, (m, k), torch.bfloat16, cuda, scale=2.0))
    qw, ws = quantize_kernel_int8(_randn(gen, (n, k), torch.float32, cuda))
    bias = _randn(gen, (n,), torch.bfloat16, cuda, scale=0.1)
    y = w8a8_matmul_2d(qx, qw, xs, ws, torch.bfloat16, bias)
    assert torch.equal(y, w8a8_matmul_2d_plain(qx, qw, xs, ws, torch.bfloat16, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_w8a8_matmul_other_dtypes_and_batched(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(gen, (2, 19, 384), dtype, cuda)
    qw, ws = quantize_kernel_int8(_randn(gen, (256, 384), torch.float32, cuda))
    bias = _randn(gen, (256,), dtype, cuda)
    y = w8a8_matmul(x, qw, ws, bias)
    qx, xs = quantize_rows_plain(x.reshape(-1, 384))
    ref = w8a8_matmul_2d_plain(qx, qw, xs, ws, dtype, bias).reshape(2, 19, 256)
    assert y.dtype == dtype and y.shape == (2, 19, 256)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_w8a8_kernels_refuse_what_they_do_not_take(cuda):
    qw = torch.zeros(256, 384, dtype=torch.int8, device=cuda)
    ws = torch.ones(256, device=cuda)
    qx = torch.zeros(4, 384, dtype=torch.int8, device=cuda)
    xs = torch.ones(4, 1, device=cuda)
    with pytest.raises(ValueError, match="sm_90a"):
        w8a8_matmul_2d(qx, qw, xs, ws.half(), torch.bfloat16)  # f16 scale
    with pytest.raises(ValueError, match="sm_90a"):
        w8a8_matmul_2d(qx[:, :200], qw[:, :200], xs, ws, torch.bfloat16)  # K not a multiple of 128
    with pytest.raises(ValueError, match="sm_90a"):
        quantize_rows(torch.zeros(4, 256, device=cuda)[:, :128])  # rows not contiguous


def test_small_flux_pipeline_on_card_matches_cpu(cuda):
    import chip_smoke

    chip_smoke.check_small_flux_reference("cuda")
    assert np.isfinite(chip_smoke.RESULTS["small_flux_reference"]["max_abs_err"])


def _bwd_inputs(gen, b, sq, sk, h, d, causal, masked, dtype, device):
    q = _randn(gen, (b, sq, h, d), dtype, device, scale=2.0)
    k = _randn(gen, (b, sk, h, d), dtype, device)
    v = _randn(gen, (b, sk, h, d), dtype, device)
    mask = None
    if masked in ("-inf", "finfo.min"):  # a whole first 128-key kv tile hidden in every other row
        mask = torch.zeros((b, 1, sq, sk), device=device)
        mask[:, :, ::2, :160] = float("-inf") if masked == "-inf" else torch.finfo(torch.float32).min
    elif masked == "row":  # every key of query row 5 hidden
        mask = torch.zeros((b, 1, sq, sk), device=device)
        mask[:, :, 5, :] = torch.finfo(torch.float32).min
    elif masked:
        mask = torch.where(torch.rand((b, 1, sq, sk), generator=gen, device=device) < 0.3, -1e4, 0.0)
    out, lse = flash_attention_full(q, k, v, attn_mask=mask, is_causal=causal, return_lse=True)
    grad_out = _randn(gen, (b, sq, h, d), dtype, device)
    return q, k, v, mask, out, lse, grad_out


_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


@pytest.mark.parametrize("b,sq,sk,h,d,causal,masked,dtype", FLASH_BWD_CARD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, sq, sk, h, d, causal, masked, dtype):
    """K2 (split where `pick_split` says so, `test_card_cases_reach_both_k2_paths`)
    and K3 within `attention_bwd_bounds`, finite, at SDXL's cross-attention
    shapes and with a mask of -inf or finfo.min over a row's first kv tile;
    with finfo.min over a whole row, NaN, +inf and -inf exactly where the
    plain version has them (JAX's kernels give the same) and within the bound
    elsewhere."""
    dtype = _DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, mask, out, lse, grad_out = _bwd_inputs(gen, b, sq, sk, h, d, causal, masked, dtype, cuda)
    before = (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    grads = flash_attention_bwd(q, k, v, mask, out, lse, grad_out, is_causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out, attn_mask=mask, is_causal=causal)
    for name, g, ref, bound in zip(("dq", "dk", "dv"), grads, refs, bounds):
        assert g.dtype == dtype and g.shape == ref.shape, name
        for where in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(where(g), where(ref)), name
        fin = torch.isfinite(ref)
        assert bool(((g.float() - ref).abs() <= bound)[fin].all()), name


@pytest.mark.parametrize("sk", [77, 1024], ids=["split", "whole"])
def test_flash_bwd_kernels_are_deterministic(cuda, sk):
    """Two launches give bit-identical dq, dk and dv, on K2's split path (the
    partials summed in split order) and off it; the separate wrappers give
    the same bits as the joint launch."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, mask, out, lse, grad_out = _bwd_inputs(gen, 1, 1024, sk, 20, 64, False, False, torch.bfloat16, cuda)
    assert (pick_split(1, 20, 1024, sk, sm_count(cuda.index or 0)) > 1) == (sk == 77)
    first = flash_attention_bwd(q, k, v, None, out, lse, grad_out)
    second = flash_attention_bwd(q, k, v, None, out, lse, grad_out)
    delta = (grad_out.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, None, lse, delta, grad_out, 1 / 8, False)
    apart = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkdv(*args))
    for a, b, c in zip(first, second, apart):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_flash_bwd_bound_rejects_a_zeroed_kv_tile(cuda):
    """Control: grads of inputs with one 64-key tile of k/v zeroed break the bound."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, _, out, lse, grad_out = _bwd_inputs(gen, 1, 1024, 1024, 4, 64, False, False, torch.bfloat16, cuda)
    refs, bounds, _ = attention_bwd_bounds(q, k, v, out, lse, grad_out)
    k0, v0 = k.clone(), v.clone()
    k0[:, 512:576] = 0
    v0[:, 512:576] = 0
    broken = flash_attention_bwd(q, k0, v0, None, out, lse, grad_out)
    for g, r, bd in zip(broken, refs, bounds):
        assert not bool(((g.float() - r).abs() <= bd).all())


def test_flash_attention_keeps_the_autograd_graph(cuda):
    """K1 on inputs that require grad returns an output with a grad_fn, and
    its backward launches K2 and K3 with the kernels' own grads."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (_randn(gen, (1, 256, 2, 64), torch.bfloat16, cuda).requires_grad_() for _ in range(3))
    grad_out = _randn(gen, (1, 256, 2, 64), torch.bfloat16, cuda)
    before = (flash_attention_full.launches, flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    out = flash_attention_full(q, k, v)
    assert out.requires_grad and out.grad_fn is not None
    out.backward(grad_out)
    after = (flash_attention_full.launches, flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    with torch.no_grad():
        ref_out, lse = flash_attention_full(q, k, v, return_lse=True)
        ref = flash_attention_bwd(q, k, v, None, ref_out, lse, grad_out)
    for g, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(g, r)


def test_flash_attention_under_autocast_runs_k1_k2_k3(cuda):
    """f32 projections under bf16 autocast hand bf16 q/k/v to the kernels;
    every f32 weight gets a finite gradient."""
    torch.manual_seed(0)
    proj = torch.nn.Linear(128, 3 * 128, device=cuda)
    x = torch.randn(2, 77, 128, device=cuda)
    before = (flash_attention_full.launches, flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        q, k, v = proj(x).reshape(2, 77, 3, 2, 64).unbind(dim=2)
        out = dispatch_attention_fn(q, k, v)
    assert out.dtype == torch.bfloat16
    out.float().square().mean().backward()
    after = (flash_attention_full.launches, flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    assert proj.weight.grad is not None and bool(torch.isfinite(proj.weight.grad).all())
    assert float(proj.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_keeps_the_autograd_graph(cuda, silu):
    """K4 on inputs that require grad returns an output with a grad_fn; its
    grads are `group_norm_bwd`'s and agree with autograd through the plain
    version in f32 (tolerance: the bf16 rounding of y and dx, one ulp of the
    largest magnitude)."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = (_randn(gen, (2, 64, 16, 16), torch.bfloat16, cuda, scale=1.5) + 1.0).requires_grad_()
    w = (_randn(gen, (64,), torch.float32, cuda, scale=0.1) + 1).requires_grad_()
    b = _randn(gen, (64,), torch.float32, cuda, scale=0.1).requires_grad_()
    gy = _randn(gen, (2, 64, 16, 16), torch.bfloat16, cuda)
    before = group_norm.launches
    y = group_norm(x, w, b, 32, 1e-6, apply_silu=silu)
    assert group_norm.launches == before + 1
    assert y.requires_grad and y.grad_fn is not None
    grads = torch.autograd.grad(y, (x, w, b), gy)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    expected = group_norm_bwd(x.detach(), w.detach(), b.detach(), gy, 32, 1e-6, silu)
    for g, e in zip(grads, expected):
        assert torch.equal(g, e)
    xf = x.detach().float().requires_grad_()
    refs = torch.autograd.grad(group_norm_plain(xf, w, b, 32, 1e-6, apply_silu=silu), (xf, w, b), gy.float())
    for g, r in zip(grads, refs):
        assert float((g.float() - r).abs().max()) <= 2.0**-7 * max(1.0, float(r.abs().max())), (g.shape, silu)


def test_w8a8_matmul_raises_under_grad(cuda):
    """K5 has no gradient: under grad mode with x or the bias requiring grad
    it raises instead of returning a detached output."""
    qw, ws = quantize_kernel_int8(torch.randn(256, 384, device=cuda))
    x = torch.randn(4, 384, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no gradient"):
        w8a8_matmul(x.requires_grad_(), qw, ws)
    with pytest.raises(RuntimeError, match="no gradient"):
        w8a8_matmul(x.detach(), qw, ws, bias.requires_grad_())
    with torch.no_grad():
        assert w8a8_matmul(x, qw, ws, bias).shape == (4, 256)
