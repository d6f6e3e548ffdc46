"""FreeU (arXiv:2309.11497): amplify the backbone features and attenuate the
low frequencies of the skip features in the UNet's two highest-level up
blocks.

Port of `diffusers_tpu/utils/freeu_utils.py`. Activations here are NCHW (JAX
is NHWC): the channel split is on dim 1 and the FFT runs over the last two
dims, in float32 (cuFFT takes no bf16; JAX upcasts too). The FFT is
`torch.fft` on the card, as it is an XLA op in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred ``2 threshold`` square of the 2-D spectrum. x: [B, C, H, W]."""
    orig_dtype = x.dtype
    h, w = x.shape[-2], x.shape[-1]
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(-2, -1)), dim=(-2, -1))
    crow, ccol = h // 2, w // 2
    mask = torch.ones((h, w), dtype=torch.float32, device=x.device)
    mask[crow - threshold:crow + threshold, ccol - threshold:ccol + threshold] = scale
    x_freq = torch.fft.ifftshift(x_freq * mask, dim=(-2, -1))
    return torch.fft.ifftn(x_freq, dim=(-2, -1)).real.to(orig_dtype)


def apply_freeu(
    resolution_idx: int,
    hidden_states: torch.Tensor,
    res_hidden_states: torch.Tensor,
    freeu: Dict[str, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up block `resolution_idx` 0 or 1: scale the first half of the
    backbone channels by b1 / b2 and filter the skip features with s1 / s2;
    other blocks pass through."""
    if resolution_idx not in (0, 1):
        return hidden_states, res_hidden_states
    b, s = (freeu["b1"], freeu["s1"]) if resolution_idx == 0 else (freeu["b2"], freeu["s2"])
    half = hidden_states.shape[1] // 2
    hidden_states = torch.cat([hidden_states[:, :half] * b, hidden_states[:, half:]], dim=1)
    return hidden_states, fourier_filter(res_hidden_states, threshold=1, scale=s)
