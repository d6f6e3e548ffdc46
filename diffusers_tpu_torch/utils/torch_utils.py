"""Random draws for the pipelines and the VAE's latent sample.

Port of `randn_tensor` of `diffusers_tpu/utils/jax_utils.py` with a
`torch.Generator` in place of a PRNG key. Every standard-normal draw of a
pipeline (its initial noise, the VAE encoder's sample) goes through this one
function, looked up on this module at call time, so a test can stand JAX's
draws in for it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def randn_tensor(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """A float32 standard-normal tensor of `shape` on `device`, drawn on the
    generator's device (so a CPU generator gives the same numbers whatever
    `device` is)."""
    draw_device = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator, device=draw_device, dtype=torch.float32).to(device)
