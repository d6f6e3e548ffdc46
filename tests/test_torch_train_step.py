"""One train step of the port against the JAX package on the CPU: the JAX
trainer's own tiny UNet (`examples/text_to_image/train_text_to_image_tpu.py`
`:57-67`), its DDPM epsilon MSE loss and `optax.adamw(lr, weight_decay=1e-2)`,
against the port's trainer pieces (`make_loss_fn`, `make_train_step`,
`torch.optim.AdamW`, the LR schedule through LambdaLR), in float32, with the
same weights (a seeded port UNet, carried into a JAX tree and back into a
fresh port UNet with `load_jax_params`) and the same 3 synthetic batches.

Tolerances, each with its reason: losses 1e-5 relative and grads 1e-4 of each
tensor's largest |grad| (f32 sums in other orders through a 4.4 M-parameter
UNet and its backward); weights after 3 AdamW steps within 2 * sum(lr_t) +
1e-6 per element (the most Adam's normalized update, m / (sqrt(v) + eps), can
move where a near-zero grad's sign differs between the two) and their total
update within 1e-3 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from diffusers_tpu.models.modeling_utils import convert_torch_state_dict, flatten_to_torch_state_dict
from diffusers_tpu.models.unets.unet_2d_condition import UNet2DConditionModel as JaxUNet2DConditionModel
from diffusers_tpu.schedulers import DDPMScheduler as JaxDDPMScheduler
from diffusers_tpu.training.optimization import get_scheduler as jax_get_scheduler
from diffusers_tpu_torch.models.modeling_utils import load_jax_params
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.schedulers import DDPMScheduler
from diffusers_tpu_torch.training.optimization import get_scheduler, lr_lambda_scheduler
from diffusers_tpu_torch.training.train_state import make_train_step
from diffusers_tpu_torch.training.train_text_to_image import TINY_UNET, make_loss_fn, synthetic_batch

torch.set_num_threads(1)


def test_tiny_unet_train_step_matches_jax():
    jm = JaxUNet2DConditionModel(sample_size=4, **TINY_UNET)
    torch.manual_seed(0)
    seeded = UNet2DConditionModel(sample_size=4, **TINY_UNET)
    params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in seeded.state_dict().items()})
    tm = load_jax_params(UNet2DConditionModel(sample_size=4, **TINY_UNET), jax.device_get(params))

    lr = 1e-3
    jsched, tsched = JaxDDPMScheduler(), DDPMScheduler()
    jstate, tstate = jsched.set_timesteps(), tsched.set_timesteps()
    schedule_j = jax_get_scheduler("constant_with_warmup", lr, 1, 3)
    optimizer = optax.adamw(schedule_j, weight_decay=1e-2)

    def jloss(p, batch):  # the JAX trainer's loss_fn
        noisy = jsched.add_noise(jstate, batch["latents"], batch["noise"], batch["timesteps"])
        pred = jm(p, noisy, batch["timesteps"], encoder_hidden_states=batch["embeds"]).sample
        return jnp.mean(jnp.square(pred.astype(jnp.float32) - batch["noise"].astype(jnp.float32)))

    @jax.jit
    def jstep(p, o, batch):  # the JAX trainer's train_step, also returning the grads
        loss, grads = jax.value_and_grad(jloss)(p, batch)
        updates, o = optimizer.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, grads

    topt = torch.optim.AdamW(tm.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    step = make_train_step(make_loss_fn(tsched, tstate), topt,
                           lr_lambda_scheduler(topt, get_scheduler("constant_with_warmup", lr, 1, 3)))

    w0 = {k: v.detach().clone() for k, v in tm.named_parameters()}
    opt_state = optimizer.init(params)
    rng = np.random.RandomState(0)
    for i in range(3):
        batch = synthetic_batch(rng, "tiny", 2, 32)
        params, opt_state, jloss_v, jgrads = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        tloss = step(tm, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), float(jloss_v), rtol=1e-5)
        ref_grads = flatten_to_torch_state_dict(jm, jgrads)
        named = dict(tm.named_parameters())
        assert set(ref_grads) == set(named)
        for name, g in ref_grads.items():
            g = np.asarray(g)
            np.testing.assert_allclose(named[name].grad.numpy(), g, atol=1e-4 * max(float(np.abs(g).max()), 1e-12),
                                       err_msg=f"step {i}: {name}")

    ref_w = flatten_to_torch_state_dict(jm, params)
    bound = 2 * sum(float(schedule_j(n)) for n in range(3)) + 1e-6
    num = den = 0.0
    for name, p in tm.named_parameters():
        ref = np.asarray(ref_w[name])
        delta, ref_delta = p.detach().numpy() - w0[name].numpy(), ref - w0[name].numpy()
        assert float(np.abs(p.detach().numpy() - ref).max()) <= bound, name
        num += float(np.square(delta - ref_delta).sum())
        den += float(np.square(ref_delta).sum())
    assert (num / den) ** 0.5 <= 1e-3
