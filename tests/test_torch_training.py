"""The port's training slice (`diffusers_tpu_torch.training`,
`DDPMScheduler`, `ModelMixin.save_pretrained`, the GroupNorm Function) against
the JAX package on the CPU, in float32.

Tolerances, each with its reason:
  * DDPM tables exactly (both round the same float64 numpy tables to f32);
    `add_noise` / `get_velocity` 1e-6 in f32 and one bf16 ulp (2^-7 at |x| <=
    4) in bf16; a 10-step `step` loop 1e-5 (f32 FMA order);
  * LR schedules 1e-6 of the peak rate (optax evaluates in f32, the port in
    f64; 1 + cos near -1 cancels);
  * EMA decay 1e-6 (f32 against f64), shadows 1e-6;
  * SNR, SD3 weightings, the timestep density given the same draw 1e-6;
  * `save_pretrained` read back by JAX: weights bit for bit, outputs 5e-4
    (the whole-model bar of tests/test_torch_models.py).

The tiny UNet train step against `jax.value_and_grad` is in
tests/test_torch_train_step.py (its JAX compile is most of a file's budget).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, load_safetensors_state_dict
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.schedulers import DDPMScheduler as JaxDDPMScheduler
from diffusers_tpu.training import train_state as jax_train_state
from diffusers_tpu.training.ema import EMAModel as JaxEMAModel
from diffusers_tpu.training.optimization import get_scheduler as jax_get_scheduler
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.ops.cuda.w8a8_matmul import w8a8_matmul
from diffusers_tpu_torch.ops.cuda.group_norm import group_norm, group_norm_plain
from diffusers_tpu_torch.quantizers import quantize_kernel_int8
from diffusers_tpu_torch.schedulers import DDPMScheduler
from diffusers_tpu_torch.training import train_state
from diffusers_tpu_torch.training.ema import EMAModel
from diffusers_tpu_torch.training.optimization import get_scheduler, lr_lambda_scheduler
from diffusers_tpu_torch.training.train_text_to_image import TINY_UNET
from diffusers_tpu_torch.training.train_text_to_image import main as train_main
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

DDPM_CONFIGS = [
    dict(),
    dict(beta_schedule="scaled_linear", beta_start=0.00085, beta_end=0.012, steps_offset=1,
         variance_type="fixed_large", prediction_type="v_prediction", clip_sample=False),
    dict(beta_schedule="squaredcos_cap_v2", timestep_spacing="trailing", rescale_betas_zero_snr=True,
         variance_type="fixed_small_log"),
]


# ------------------------------------------------------------------ DDPM


@pytest.mark.parametrize("config", range(len(DDPM_CONFIGS)))
def test_ddpm_tables_noise_velocity_and_step_loop_match_jax(config):
    cfg = DDPM_CONFIGS[config]
    js, ts = JaxDDPMScheduler(**cfg), DDPMScheduler(**cfg)
    for steps in (None, 10):
        jstate, tstate = js.set_timesteps(steps), ts.set_timesteps(steps)
        for name in ("timesteps", "alphas_cumprod", "sqrt_alpha_prod", "sqrt_beta_prod", "inv_sqrt_alpha_prod",
                     "x0_coeff", "xt_coeff", "sigma", "min_log_var", "max_log_var"):
            np.testing.assert_array_equal(getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)), name)

    rng = np.random.RandomState(config)
    x = rng.randn(4, 4, 8, 8).astype(np.float32)
    noise = rng.randn(4, 4, 8, 8).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    for fn in ("add_noise", "get_velocity"):
        ref = getattr(js, fn)(jstate, jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
        out = getattr(ts, fn)(tstate, torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        ref = getattr(js, fn)(jstate, jnp.asarray(x, jnp.bfloat16), jnp.asarray(noise, jnp.bfloat16),
                              jnp.asarray(t))
        out = getattr(ts, fn)(tstate, torch.from_numpy(x).bfloat16(), torch.from_numpy(noise).bfloat16(),
                              torch.from_numpy(t))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2.0**-7 * 4)

    sample_j, sample_t = jnp.asarray(x), torch.from_numpy(x)
    for i, step_t in enumerate(np.asarray(jstate.timesteps)):
        model_output = rng.randn(4, 4, 8, 8).astype(np.float32)
        var_noise = rng.randn(4, 4, 8, 8).astype(np.float32)
        sample_j = js.step(jstate, jnp.asarray(model_output), int(step_t), sample_j,
                           variance_noise=jnp.asarray(var_noise)).prev_sample
        sample_t = ts.step(tstate, torch.from_numpy(model_output), int(step_t), sample_t,
                           variance_noise=torch.from_numpy(var_noise)).prev_sample
        np.testing.assert_allclose(sample_t.numpy(), np.asarray(sample_j), atol=1e-5, err_msg=f"step {i}")


# ------------------------------------------------------------------ LR schedules, EMA


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedules_match_optax(name, warmup):
    kwargs = dict(learning_rate=3e-4, num_warmup_steps=warmup, num_training_steps=23, num_cycles=1.5, power=2.0)
    jfn, tfn = jax_get_scheduler(name, **kwargs), get_scheduler(name, **kwargs)
    steps = range(0, 30)
    ref = np.array([float(jfn(jnp.asarray(s))) for s in steps])
    out = np.array([tfn(s) for s in steps])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * kwargs["learning_rate"])

    # LambdaLR drives it: the lr of update n (counted from 0) is schedule(n)
    param = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.AdamW([param], lr=kwargs["learning_rate"])
    sched = lr_lambda_scheduler(opt, tfn)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, out[:6], rtol=1e-12, atol=0)


@pytest.mark.parametrize("kwargs", [dict(), dict(use_ema_warmup=True, power=0.75, update_after_step=2, min_decay=0.1),
                                    dict(decay=0.9)])
def test_ema_matches_jax(kwargs):
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    jema = JaxEMAModel(**kwargs)
    jstate = jema.init(jax.tree.map(jnp.asarray, params))
    tparams = [torch.from_numpy(params["a"].copy()), torch.from_numpy(params["b"].copy())]
    tema = EMAModel(tparams, **kwargs)
    for step in range(1, 8):
        params = jax.tree.map(lambda p: p + rng.randn(*p.shape).astype(np.float32), params)
        jstate = jema.update(jstate, jax.tree.map(jnp.asarray, params))
        tparams[0].copy_(torch.from_numpy(params["a"]))
        tparams[1].copy_(torch.from_numpy(params["b"]))
        tema.step(tparams)
        np.testing.assert_allclose(tema.get_decay(step), float(jema.get_decay(jnp.asarray(step))), atol=1e-6)
        for s, ref in zip(tema.shadow_params, (jstate.shadow_params["a"], jstate.shadow_params["b"])):
            assert s.dtype == torch.float32
            np.testing.assert_allclose(s.numpy(), np.asarray(ref), atol=1e-6)
    target = [torch.zeros(4, 3), torch.zeros(7)]
    tema.copy_to(target)
    assert all(torch.equal(a, b) for a, b in zip(target, tema.shadow_params))


# ------------------------------------------------------------------ train_state helpers


def test_snr_weightings_density_and_buckets_match_jax():
    acp = np.cumprod(1 - np.linspace(1e-4, 0.02, 1000, dtype=np.float32)).astype(np.float32)
    t = np.array([0, 10, 500, 999])
    np.testing.assert_allclose(
        train_state.compute_snr(torch.from_numpy(acp), torch.from_numpy(t)).numpy(),
        np.asarray(jax_train_state.compute_snr(jnp.asarray(acp), jnp.asarray(t))), rtol=1e-6)

    sigmas = np.array([0.05, 0.3, 0.7, 1.0], np.float32)
    for scheme in ("sigma_sqrt", "cosmap", "none"):
        np.testing.assert_allclose(
            train_state.compute_loss_weighting_for_sd3(scheme, torch.from_numpy(sigmas)).numpy(),
            np.asarray(jax_train_state.compute_loss_weighting_for_sd3(scheme, jnp.asarray(sigmas))), rtol=1e-6)

    key = jax.random.PRNGKey(3)
    for scheme, draw_fn in (("logit_normal", jax.random.normal), ("mode", jax.random.uniform),
                            ("uniform", jax.random.uniform)):
        ref = jax_train_state.compute_density_for_timestep_sampling(scheme, 16, key, logit_mean=0.2, logit_std=1.1)
        draw = torch.from_numpy(np.array(draw_fn(key, (16,))))
        out = train_state.timestep_density_from_draw(scheme, draw, logit_mean=0.2, logit_std=1.1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        gen = torch.Generator().manual_seed(0)
        u = train_state.compute_density_for_timestep_sampling(scheme, 1000, generator=gen)
        assert u.shape == (1000,) and bool(((u > -0.5) & (u < 1.5)).all())
        u2 = train_state.compute_density_for_timestep_sampling(scheme, 1000, generator=torch.Generator().manual_seed(0))
        assert torch.equal(u, u2)
        if scheme != "mode":  # the mode density may leave (0, 1) for mode_scale > 0
            assert bool(((u > 0) & (u < 1)).all())

    assert train_state.parse_buckets_string("1024,1024; 768,1344") == jax_train_state.parse_buckets_string(
        "1024,1024; 768,1344")
    with pytest.raises(ValueError):
        train_state.parse_buckets_string("1024x1024")
    for res, div in ((1024, 16), (512, 64)):
        buckets = train_state.generate_aspect_ratio_buckets(res, div)
        assert buckets == jax_train_state.generate_aspect_ratio_buckets(res, div)
        for h, w in ((1000, 700), (300, 900), (512, 512)):
            assert train_state.find_nearest_bucket(h, w, buckets) == jax_train_state.find_nearest_bucket(h, w, buckets)


# ------------------------------------------------------------------ kernels' gradient repairs


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_function_grads_equal_autograd_through_the_plain_version(silu):
    """The GroupNorm Function's backward (PyTorch ops on the saved input;
    K4 forward on the card) against autograd through the plain version: 1e-5."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 64, 6, 5).astype(np.float32) * 2 + 1).requires_grad_()
    w = torch.from_numpy(rng.randn(64).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.randn(64).astype(np.float32)).requires_grad_()
    gy = torch.from_numpy(rng.randn(2, 64, 6, 5).astype(np.float32))
    y = group_norm(x, w, b, 32, 1e-6, apply_silu=silu)
    assert type(y.grad_fn).__name__ == "GroupNormFunctionBackward"
    grads = torch.autograd.grad(y, (x, w, b), gy)
    ref = group_norm_plain(x, w, b, 32, 1e-6, apply_silu=silu)
    ref_grads = torch.autograd.grad(ref, (x, w, b), gy)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    with torch.no_grad():
        assert group_norm(x, w, b, 32, 1e-6, apply_silu=silu).grad_fn is None


def test_w8a8_matmul_refuses_grad():
    """K5's int8 path has no gradient (nor has JAX's Pallas call): it raises
    under grad mode instead of returning a detached output."""
    qw, ws = quantize_kernel_int8(torch.randn(128, 256))
    x = torch.randn(3, 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        w8a8_matmul(x, qw, ws)
    with torch.no_grad():
        assert w8a8_matmul(x, qw, ws).shape == (3, 128)


# ------------------------------------------------------------------ checkpoints and the train step


def test_save_pretrained_reads_back_into_jax(tmp_path):
    torch.manual_seed(0)
    tm = UNet2DConditionModel(sample_size=4, **TINY_UNET)
    tm.save_pretrained(tmp_path, max_shard_size="8MB")  # 17.6 MB of f32: three shards and an index
    files = sorted(os.listdir(tmp_path))
    assert files == ["config.json", "diffusion_pytorch_model-00001-of-00003.safetensors",
                     "diffusion_pytorch_model-00002-of-00003.safetensors",
                     "diffusion_pytorch_model-00003-of-00003.safetensors",
                     "diffusion_pytorch_model.safetensors.index.json"]
    state = load_safetensors_state_dict(str(tmp_path))
    assert set(state) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy(), k)
    jm = JaxUNet2DConditionModel.from_config(JaxUNet2DConditionModel.load_config(str(tmp_path)))
    params = convert_torch_state_dict(jm, state)
    rng = np.random.RandomState(1)
    x, ehs = rng.randn(2, 4, 4, 4).astype(np.float32), rng.randn(2, 8, 64).astype(np.float32)
    forward = jax.jit(lambda p: jm(p, jnp.asarray(x), jnp.asarray([3, 700]), encoder_hidden_states=jnp.asarray(ehs)))
    ref = forward(params).sample
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.tensor([3, 700]), torch.from_numpy(ehs)).sample
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)

    tm.save_pretrained(tmp_path / "one")
    assert sorted(os.listdir(tmp_path / "one")) == ["config.json", "diffusion_pytorch_model.safetensors"]


def test_trainer_runs_on_the_cpu_and_writes_checkpoints(tmp_path, monkeypatch):
    seen = []
    result = train_main(["--device", "cpu", "--max_train_steps", "2", "--batch_size", "1", "--checkpointing_steps",
                         "1", "--use_ema", "--output_dir", str(tmp_path)],
                        callback=lambda step, unet, loss: seen.append(
                            all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in unet.parameters())))
    assert seen == [True, True]
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-1", "checkpoint-2", "unet"]
    assert os.path.isfile(tmp_path / "unet" / "diffusion_pytorch_model.safetensors")
    # the default device is the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--max_train_steps", "1", "--output_dir", str(tmp_path / "x")])
