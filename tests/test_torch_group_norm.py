"""K4 (GroupNorm + SiLU, `csrc/group_norm.cu`) on the CPU: its planner, its
bulk copies' alignment, and its partition and reduction order.

K4 cannot run here, so what surrounds it is checked in Python:

* `plan_group_norm` at every GroupNorm shape of an SDXL UNet call, a VAE
  decode and a VAE encode (`chip_smoke.GN_UNET_CALL`, `GN_VAE_DECODE`,
  `GN_VAE_ENCODE`, themselves checked against the models), on a card of 132 SMs (H100 SXM) and of 114
  (H100 PCIe): the regime, the cluster size, the shared memory, and that
  every bulk copy the kernel issues is 16-byte aligned in address and size.
* The kernel's two reductions, emulated in f32 with numpy: the cluster
  regime sums each CTA's chunk, adds the partial sums in rank order for the
  mean, then the partial centred squares the same way; the split regime
  keeps each chunk's (mean, M2) and merges them with Chan's formula, each of
  32 lanes a stride of chunks, then a butterfly. Both are held to the plain
  version in f32 (1e-5: sums in another order) and to JAX's Pallas kernel in
  interpret mode at the JAX test's 5e-4, as
  `tests/test_torch_ops.py::test_group_norm_plain_matches_pallas_interpret`
  holds the plain version. A control that leaves one partial out breaks the
  limit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import GN_UNET_CALL, GN_VAE_DECODE, GN_VAE_ENCODE
from diffusers_tpu.ops.pallas.group_norm import group_norm_silu_nhwc
from diffusers_tpu_torch.ops.cuda.group_norm import (
    CLUSTER_CHUNK_BYTES,
    MAX_CLUSTER,
    MAX_SMEM,
    SMEM_HEADER,
    SPLIT_CHUNK_BYTES,
    GroupNormPlan,
    chunk_bounds,
    chunk_copies,
    fast_divisor,
    group_norm,
    group_norm_plain,
    plan_group_norm,
    smem_bytes,
)
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

_SHAPES = list(dict.fromkeys(shape for shape, _, _ in GN_UNET_CALL + GN_VAE_DECODE + GN_VAE_ENCODE))


def _span(shape, groups=32):
    return shape[1] // groups * math.prod(shape[2:])


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", _SHAPES, ids=["x".join(map(str, s)) for s in _SHAPES])
def test_plan_at_the_main_path_shapes(shape, sms):
    """A span that 8 CTAs of at most CLUSTER_CHUNK_BYTES hold takes the
    cluster regime (a power of two <= 8 CTAs a cluster, one chunk each);
    a larger one the split regime. Every CTA's shared memory fits; every
    bulk copy of every CTA is 16-byte aligned at both ends and lands at a
    16-byte-aligned place inside its CTA's chunk; the chunks cover each span
    once, in order."""
    itemsize = 2
    span = _span(shape)
    plan = plan_group_norm(shape, torch.bfloat16, sms)
    assert plan.split == (span * itemsize > MAX_CLUSTER * CLUSTER_CHUNK_BYTES)
    if plan.split:
        assert plan.chunk * itemsize <= SPLIT_CHUNK_BYTES and plan.parts == -(-span // plan.chunk)
    else:
        assert plan.parts in (1, 2, 4, 8) and plan.chunk * itemsize <= CLUSTER_CHUNK_BYTES
    assert plan.chunk * itemsize % 16 == 0 and plan.parts * plan.chunk >= span
    assert plan.smem_bytes == smem_bytes(plan.chunk, itemsize) <= MAX_SMEM
    bounds = chunk_bounds(plan, span)
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for span_id in range(shape[0] * 32):
        for lo, hi in bounds:
            start, end = span_id * span + lo, span_id * span + hi
            s0, a0, a1 = chunk_copies(start, end, itemsize)
            assert s0 <= start <= a0 <= a1 <= end and s0 * itemsize % 16 == 0
            assert a1 > a0 and a0 * itemsize % 16 == 0 and a1 * itemsize % 16 == 0
            assert a0 - start < 16 // itemsize and end - a1 < 16 // itemsize
            assert SMEM_HEADER + (end - s0) * itemsize <= plan.smem_bytes


def test_plans_reach_both_regimes_on_the_main_paths():
    """The UNet's spans up to 240 KB take clusters of 8; its larger ones and
    every VAE GroupNorm take the split regime; the card tests' control shapes
    reach one regime each on either card."""
    for sms in (132, 114):
        unet = {shape: plan_group_norm(shape, torch.bfloat16, sms) for shape, _, _ in GN_UNET_CALL}
        assert {p.split for p in unet.values()} == {False, True}
        assert not plan_group_norm((2, 960, 64, 64), torch.bfloat16, sms).split
        assert plan_group_norm((2, 320, 128, 128), torch.bfloat16, sms).split
        assert all(plan_group_norm(s, torch.bfloat16, sms).split for s, _, _ in GN_VAE_DECODE if _span(s) > 2**18)
        assert not plan_group_norm((2, 320, 64, 64), torch.bfloat16, sms).split
        assert plan_group_norm((1, 512, 256, 256), torch.bfloat16, sms).split


@pytest.mark.parametrize("shape,dtype", [((2, 96, 7, 9), torch.float32), ((2, 64, 1000), torch.float16),
                                         ((1, 128, 256, 256), torch.float32), ((2, 32, 3), torch.bfloat16)])
def test_plan_for_ragged_spans(shape, dtype):
    """Spans of any length and alignment (189 elements: no 16-byte word
    boundary at a span's start; 3 elements: no bulk copy at all) get a plan
    whose chunks cover them and whose bulk copies stay aligned."""
    itemsize = torch.finfo(dtype).bits // 8
    span = _span(shape)
    plan = plan_group_norm(shape, dtype, 132)
    assert plan.chunk * itemsize % 16 == 0 and plan.parts * plan.chunk >= span
    for span_id in range(shape[0] * 32):
        for lo, hi in chunk_bounds(plan, span):
            s0, a0, a1 = chunk_copies(span_id * span + lo, span_id * span + hi, itemsize)
            assert s0 * itemsize % 16 == 0 and (a1 == a0 or (a0 * itemsize % 16 == 0 and a1 * itemsize % 16 == 0))


def test_fast_divisor_is_exact():
    """The kernel's channel of a span-local index, ``(n * magic) >> shift``,
    equals ``n // hw`` over the whole index range, at every spatial size of
    the main paths and at awkward ones."""
    rng = np.random.RandomState(0)
    for d in [1, 2, 3, 7, 63, 1000, 1024, 4096, 16384, 65536, 262144, 1 << 20, 12345, 2**31 - 1]:
        magic, shift = fast_divisor(d)
        ns = [0, 1, d - 1, d, d + 1, 2**31 - 2, 2**31 - 1] + rng.randint(0, 2**31 - 1, 500).tolist()
        assert all((n * magic) >> shift == n // d for n in ns if n >= 0), d
        assert magic < 2**33 and (2**31 - 1) * magic < 2**64


def test_group_norm_tables_match_the_models():
    """`GN_UNET_CALL`, `GN_VAE_DECODE` and `GN_VAE_ENCODE` (K4's shapes,
    SiLU flags and launches, which `chip_smoke.py` and the card tests time
    and check) are the GroupNorm calls of the SDXL UNet at 1024 px and b=2
    and of the SDXL VAE decoder to and encoder from 1024 px, counted on the
    meta device."""
    from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
    from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
    from diffusers_tpu_torch.ops import module

    seen = []

    def record(x, weight, bias, num_groups, eps=1e-5, apply_silu=False):
        seen.append((tuple(x.shape), apply_silu))
        return x

    def census(table):
        counts = {}
        for shape, silu in seen:
            counts[(shape, silu)] = counts.get((shape, silu), 0) + 1
        assert counts == {(shape, silu): n for shape, silu, n in table}
        seen.clear()

    original = module.group_norm
    module.group_norm = record
    try:
        with torch.device("meta"), torch.no_grad():
            unet = UNet2DConditionModel(**chip_smoke.SDXL_UNET)
            unet(torch.zeros(2, 4, 128, 128), torch.zeros(2), torch.zeros(2, 77, 2048),
                 added_cond_kwargs={"text_embeds": torch.zeros(2, 1280), "time_ids": torch.zeros(2, 6)})
            census(GN_UNET_CALL)
            del unet
            vae = AutoencoderKL(**chip_smoke.SDXL_VAE)
            vae.decode(torch.zeros(1, 4, 128, 128))
            census(GN_VAE_DECODE)
            vae.encode(torch.zeros(1, 3, 1024, 1024))
            census(GN_VAE_ENCODE)
    finally:
        module.group_norm = original


# ------------------------------------------------- the kernel's reductions


def _chan(a, b):
    """Chan's merge of (n, mean, M2) partials in f32, an empty side the identity."""
    (na, ma, qa), (nb, mb, qb) = a, b
    if nb == 0:
        return a
    if na == 0:
        return b
    nt = np.float32(na + nb)
    d = np.float32(mb - ma)
    return nt, np.float32(ma + d * np.float32(nb / nt)), np.float32(qa + qb + d * d * np.float32(na * nb / nt))


def _merge_split(partials):
    """The split regime's merge: lane l merges partials l, l + 32, ... in
    turn, then a butterfly where both lanes of a pair merge the lower lane's
    set with the upper's."""
    lanes = [(np.float32(0), np.float32(0), np.float32(0))] * 32
    for i, p in enumerate(partials):
        lanes[i % 32] = _chan(lanes[i % 32], p)
    off = 16
    while off:
        lanes = [_chan(lanes[min(l, l ^ off)], lanes[max(l, l ^ off)]) for l in range(32)]
        off //= 2
    return lanes[0]


def _emulate(x, weight, bias, groups, eps, silu, plan, drop=-1):
    """K4's statistics in its partition and merge order, in f32 (each CTA's
    own sum in numpy's order), then the affine and SiLU as the kernel does."""
    b, c = x.shape[:2]
    span = _span(x.shape, groups)
    xf = x.reshape(b * groups, span).astype(np.float32)
    bounds = chunk_bounds(plan, span)
    f32 = np.float32
    mean, rstd = np.empty(b * groups, np.float32), np.empty(b * groups, np.float32)
    for r, row in enumerate(xf):
        chunks = [row[lo:hi] for lo, hi in bounds]
        if plan.split:
            parts = []
            for i, ch in enumerate(chunks):
                m = f32(ch.sum(dtype=np.float32) / f32(len(ch)))
                parts.append((f32(0), f32(0), f32(0)) if i == drop else
                             (f32(len(ch)), m, ((ch - m) ** 2).sum(dtype=np.float32)))
            _, mean[r], m2 = _merge_split(parts)
        else:
            total = f32(0)
            for i, ch in enumerate(chunks):
                if i != drop:
                    total = f32(total + ch.sum(dtype=np.float32))
            mean[r] = f32(total / f32(span))
            m2 = f32(0)
            for i, ch in enumerate(chunks):
                if i != drop:
                    m2 = f32(m2 + ((ch - mean[r]) ** 2).sum(dtype=np.float32))
        rstd[r] = f32(1) / np.sqrt(f32(m2 / f32(span)) + f32(eps))
    y = (xf - mean[:, None]) * rstd[:, None]
    shape = (1, c) + (1,) * (x.ndim - 2)
    y = y.reshape(x.shape) * weight.reshape(shape) + bias.reshape(shape)
    return y / (1 + np.exp(-y)) if silu else y


def _plans(span, itemsize):
    """A cluster plan of 4 CTAs and a split plan of small, ragged chunks."""
    align = 16 // itemsize
    cluster = math.ceil(span / 4 / align) * align
    split = max(align, span // 7 // align * align)
    return {"cluster": GroupNormPlan(False, 4, cluster, smem_bytes(cluster, itemsize)),
            "split": GroupNormPlan(True, -(-span // split), split, smem_bytes(split, itemsize))}


@pytest.mark.parametrize("regime", ["cluster", "split"])
@pytest.mark.parametrize("shape,groups,silu", [((2, 16, 16, 256), 32, True), ((1, 8, 16, 128), 16, False)])
def test_emulated_reductions_match_plain_and_pallas_interpret(regime, shape, groups, silu):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)  # NHWC, as the JAX kernel takes it
    c = shape[-1]
    weight, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    ref = np.asarray(group_norm_silu_nhwc(jnp.asarray(x), jnp.asarray(weight), jnp.asarray(bias), groups,
                                          eps=1e-6, apply_silu=silu, interpret=True))
    x_nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    plan = _plans(_span(x_nchw.shape, groups), 4)[regime]
    assert plan.parts > 2 and (regime == "cluster" or _span(x_nchw.shape, groups) % plan.chunk)
    out = _emulate(x_nchw, weight, bias, groups, 1e-6, silu, plan)
    plain = group_norm_plain(torch.from_numpy(x_nchw), torch.from_numpy(weight), torch.from_numpy(bias), groups,
                             1e-6, apply_silu=silu).numpy()
    np.testing.assert_allclose(out, plain, atol=1e-5)
    np.testing.assert_allclose(out.transpose(0, 2, 3, 1), ref, atol=5e-4)


@pytest.mark.parametrize("regime", ["cluster", "split"])
@pytest.mark.parametrize("shape", [(2, 96, 7, 9), (2, 64, 1000)])
def test_emulated_reductions_on_ragged_spans(regime, shape):
    """Spans of 189 and 2,000 elements, chunked at 16-byte words: the
    emulation matches the plain version; leaving one partial out, on inputs
    whose chunk of it is shifted by 20, breaks the limit tenfold."""
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 1.5 + 3).astype(np.float32)
    c = shape[1]
    weight, bias = (rng.randn(c) * 0.1 + 1).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32)
    span = _span(shape)
    plan = _plans(span, 4)[regime]
    plain = lambda a: group_norm_plain(torch.from_numpy(a), torch.from_numpy(weight),  # noqa: E731
                                       torch.from_numpy(bias), 32, 1e-6, apply_silu=True).numpy()
    np.testing.assert_allclose(_emulate(x, weight, bias, 32, 1e-6, True, plan), plain(x), atol=1e-5)
    drop = plan.parts // 2
    lo, hi = chunk_bounds(plan, span)[drop]
    shifted = x.copy()
    shifted.reshape(-1, span)[:, lo:hi] += 20
    ref = plain(shifted)
    assert np.abs(_emulate(shifted, weight, bias, 32, 1e-6, True, plan) - ref).max() <= 1e-5 * np.abs(ref).max() + 1e-5
    broken = _emulate(shifted, weight, bias, 32, 1e-6, True, plan, drop=drop)
    assert np.abs(broken - ref).max() > 10 * (1e-5 + 2.0**-20 * np.abs(ref).max())


def test_cpu_tensors_take_the_plain_version():
    """On the CPU `group_norm` is its plain version and launches nothing."""
    x = torch.randn(2, 64, 5, 5)
    group_norm.launches = 0
    torch.testing.assert_close(group_norm(x, None, None, 32, 1e-6, True),
                               group_norm_plain(x, None, None, 32, 1e-6, True), rtol=0, atol=0)
    assert group_norm.launches == 0


@pytest.mark.parametrize("share,count", [(1, 1), (4, 4), (32 // 3, 16), (32, 32), (10**9, 32)])
def test_chip_smoke_group_slices_cover_whole_groups(share, count):
    """`chip_smoke.group_slices`, over which phase 4 runs K4's plain version
    on spans too large for one f32 reference (FramePack's decode): the
    slices cover the channels once, in order, in whole groups, each of at
    most `limit` elements where a group allows it, and GroupNorm over each
    slice is GroupNorm over the whole (1e-6: sums in another order). At the
    largest span the card checks, each slice stays within the default
    limit."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 3, 5, 7, generator=gen) * 1.5 + 0.5
    w, b = 1 + 0.1 * torch.randn(64, generator=gen), 0.1 * torch.randn(64, generator=gen)
    slices = chip_smoke.group_slices(x, 32, max(1, x.numel() // share))
    assert len(slices) == count
    assert torch.equal(torch.cat([torch.arange(64)[part] for part, _ in slices]), torch.arange(64))
    assert all((part.stop - part.start) == 2 * groups for part, groups in slices)
    out = torch.cat([group_norm_plain(x[:, part], w[part], b[part], groups, 1e-6, apply_silu=True)
                     for part, groups in slices], dim=1)
    whole = group_norm_plain(x, w, b, 32, 1e-6, apply_silu=True)
    assert float((out - whole).abs().max()) <= 1e-6
    shape = chip_smoke.GN_FRAMEPACK_VAE[0][0]
    big = chip_smoke.group_slices(torch.empty(shape, device="meta"), 32)
    assert len(big) == 16 and all(shape[0] * (p.stop - p.start) * math.prod(shape[2:]) <= 2**28 for p, _ in big)
