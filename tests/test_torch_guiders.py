"""The port's `guiders` package against the JAX package on the CPU.

Each guider (CFG, CFG-Zero*, APG, APG-Mix, AutoGuidance, FDG, MAMBO-G, PAG,
SLG, SEG, TCFG, and `rescale_noise_cfg` of `guider_utils`) on the same
numpy predictions as JAX's, at steps before, inside and after its start /
stop window, with `guidance_rescale` > 0 where the guider reads it, the step
given as a Python int and as a tensor; APG's and APG-Mix's momentum carried
over three steps; SEG's blur (`seg_gaussian_blur_2d`) on grids narrower than
its pad, at infinite sigma and on a grid that is not square; the
`guider_config.json` each side writes read by the other.

Tolerances: 2e-5 max-abs, relative to the reference's largest value (the
same float32 formulas; FDG's pyramid and SEG's blur are float32
convolutions), TCFG 1e-4 (an SVD from another LAPACK).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusers_tpu.guiders as jg
import diffusers_tpu_torch.guiders as tg
from diffusers_tpu_torch.guiders.smoothed_energy_guidance import reflect_indices, reflect_pad_2d
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

ATOL = 2e-5
SVD_ATOL = 1e-4
RNG = np.random.RandomState(7)
COND, UNCOND, SKIP = (RNG.randn(2, 4, 8, 8).astype(np.float32) for _ in range(3))
NUM_STEPS = 10
WINDOW = dict(start=0.2, stop=0.7)

GUIDERS = {
    "cfg": ("ClassifierFreeGuidance", dict(guidance_scale=6.0, guidance_rescale=0.4, **WINDOW), 2),
    "cfg_original": ("ClassifierFreeGuidance", dict(guidance_scale=3.0, use_original_formulation=True), 2),
    "cfg_zero_star": ("ClassifierFreeZeroStarGuidance",
                      dict(guidance_scale=5.0, zero_init_steps=4, guidance_rescale=0.3, **WINDOW), 2),
    "apg": ("AdaptiveProjectedGuidance", dict(guidance_scale=7.0, eta=0.6, adaptive_projected_guidance_rescale=4.0,
                                              **WINDOW), 2),
    "apg_mix": ("AdaptiveProjectedMixGuidance", dict(adaptive_projected_guidance_start_step=5, guidance_rescale=0.2,
                                                     **WINDOW), 2),
    "auto": ("AutoGuidance", dict(guidance_scale=4.0, auto_guidance_layers=[1, 2], guidance_rescale=0.5, **WINDOW), 2),
    "fdg_freq": ("FrequencyDecoupledGuidance", dict(guidance_scales=(9.0, 4.0), guidance_rescale=(0.3, 0.0),
                                                    parallel_weights=(1.0, 0.5), start=(0.0, 0.2), stop=(0.7, 1.0)), 2),
    "fdg_data": ("FrequencyDecoupledGuidance", dict(guidance_scales=(8.0, 6.0, 2.0), guidance_rescale=0.25,
                                                    guidance_rescale_space="data", **WINDOW), 2),
    "mambo": ("MagnitudeAwareGuidance", dict(guidance_scale=9.0, alpha=2.0, guidance_rescale=0.3, **WINDOW), 2),
    "mambo_original": ("MagnitudeAwareGuidance", dict(alpha=1.0, use_original_formulation=True), 2),
    "pag": ("PerturbedAttentionGuidance", dict(perturbed_guidance_scale=2.0, perturbed_guidance_start=0.3,
                                               perturbed_guidance_stop=0.9, guidance_rescale=0.4, **WINDOW), 3),
    "slg": ("SkipLayerGuidance", dict(skip_layer_guidance_scale=3.0, skip_layer_guidance_start=0.1,
                                      skip_layer_guidance_stop=0.5, skip_layer_indices=[7, 8, 9],
                                      guidance_rescale=0.2), 3),
    "seg": ("SmoothedEnergyGuidance", dict(seg_guidance_scale=2.5, seg_guidance_start=0.3, seg_guidance_stop=0.8,
                                           guidance_rescale=0.3, **WINDOW), 3),
    "tcfg": ("TangentialClassifierFreeGuidance", dict(guidance_scale=5.0, guidance_rescale=0.3, **WINDOW), 2),
}


def _diff(out, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(out) - ref))) / max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("name", list(GUIDERS))
def test_guider_matches_jax(name):
    cls_name, config, n_preds = GUIDERS[name]
    jguider, tguider = getattr(jg, cls_name)(**config), getattr(tg, cls_name)(**config)
    assert tguider.num_conditions == jguider.num_conditions and tguider._input_predictions == jguider._input_predictions
    preds = (COND, UNCOND, SKIP)[:n_preds]
    atol = SVD_ATOL if name == "tcfg" else ATOL
    for step in (0, 3, 5, 8):
        ref = jax.jit(lambda *p: jguider(*p, step=step, num_steps=NUM_STEPS))(*map(jnp.asarray, preds))
        out = tguider(*map(torch.from_numpy, preds), step=step, num_steps=NUM_STEPS)
        as_tensor = tguider(*map(torch.from_numpy, preds), step=torch.tensor(step), num_steps=NUM_STEPS)
        assert out.shape == COND.shape and _diff(out, ref) <= atol, (step, _diff(out, ref))
        torch.testing.assert_close(as_tensor, out, rtol=0, atol=0)
    if n_preds == 3:  # without the perturbed prediction: CFG alone, as in JAX
        ref = jguider(jnp.asarray(COND), jnp.asarray(UNCOND), step=4, num_steps=NUM_STEPS)
        assert _diff(tguider(torch.from_numpy(COND), torch.from_numpy(UNCOND), step=4, num_steps=NUM_STEPS),
                     ref) <= ATOL


def test_rescale_noise_cfg_and_window_match_jax():
    for rescale in (0.0, 0.7, 1.0):
        ref = jg.rescale_noise_cfg(jnp.asarray(COND), jnp.asarray(UNCOND), rescale)
        assert _diff(tg.rescale_noise_cfg(torch.from_numpy(COND), torch.from_numpy(UNCOND), rescale), ref) <= ATOL
    # the window's float32 edges: step 2 of 10 is 0.2 and opens a window that starts at 0.2; 7 of 10 closes it
    jcfg, tcfg = jg.ClassifierFreeGuidance(**WINDOW), tg.ClassifierFreeGuidance(**WINDOW)
    for step in range(NUM_STEPS + 1):
        jax_open = bool(jcfg._enabled(jnp.float32(step), NUM_STEPS))
        assert bool(tcfg._enabled(step, NUM_STEPS)) == jax_open == (2 <= step < 7)
    assert bool(tg.ClassifierFreeGuidance()._enabled(0, 0)) == bool(jg.ClassifierFreeGuidance()._enabled(0.0, 0))


@pytest.mark.parametrize("name", ["apg", "apg_mix"])
def test_apg_momentum_over_three_steps_matches_jax(name):
    cls_name, config, _ = GUIDERS[name]
    config = dict(config, adaptive_projected_guidance_momentum=-0.5, start=0.0, stop=1.0,
                  **({"adaptive_projected_guidance_start_step": 1} if name == "apg_mix" else {}))
    jguider, tguider = getattr(jg, cls_name)(**config), getattr(tg, cls_name)(**config)
    jm, tm = jguider.init_momentum(COND.shape), tguider.init_momentum(COND.shape)
    assert tm.dtype == torch.float32 and not tm.any()
    rng = np.random.RandomState(3)
    for step in range(3):
        cond, uncond = (rng.randn(*COND.shape).astype(np.float32) for _ in range(2))
        ref, jm = jguider(jnp.asarray(cond), jnp.asarray(uncond), step=step, num_steps=3, momentum=jm)
        out, tm = tguider(torch.from_numpy(cond), torch.from_numpy(uncond), step=step, num_steps=3, momentum=tm)
        assert _diff(out, ref) <= ATOL and _diff(tm, jm) <= ATOL
    assert tg.AdaptiveProjectedGuidance().init_momentum(COND.shape) is None  # no momentum configured


@pytest.mark.parametrize("grid,sigma", [((2, 2), 1.0), ((8, 8), 3.0), ((5, 5), 0.7), ((1, 1), 2.0),
                                        ((3, 4), 1.0), ((4, 4), 9999999.0)])
def test_seg_blur_matches_jax(grid, sigma):
    """JAX pads by reflecting again and again where the pad passes the grid
    (`F.pad(mode="reflect")` would raise); a grid that is not square is
    left as it is; infinite sigma gives the mean."""
    h, w = grid
    query = RNG.randn(2, h * w, 6).astype(np.float32)
    ks = tg.smoothed_energy_guidance.seg_kernel_size(sigma) if sigma < 9999.9 else 3
    ref = jg.seg_gaussian_blur_2d(jnp.asarray(query), ks, sigma)
    out = tg.seg_gaussian_blur_2d(torch.from_numpy(query), ks, sigma)
    assert out.shape == query.shape and _diff(out, ref) <= ATOL
    if h == w and sigma < 9999.9:  # rows in memory, so each head's features keep a unit stride for K1
        assert out.is_contiguous()
    if h != w:
        np.testing.assert_array_equal(out.numpy(), query)


@pytest.mark.parametrize("n,pad", [(1, 4), (2, 3), (3, 9), (8, 9), (16, 2)])
def test_reflect_padding_is_jax_pad(n, pad):
    x = RNG.randn(2, 3, n, n + 1).astype(np.float32)
    ref = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")
    np.testing.assert_array_equal(reflect_pad_2d(torch.from_numpy(x), pad).numpy(), np.asarray(ref))
    assert len(reflect_indices(n, pad)) == n + 2 * pad
    if pad >= n:
        with pytest.raises(RuntimeError):
            torch.nn.functional.pad(torch.from_numpy(x), (pad,) * 4, mode="reflect")


@pytest.mark.parametrize("name", ["cfg", "apg", "fdg_freq", "slg", "seg", "auto"])
def test_guider_config_json_crosses_both_ways(tmp_path, name):
    cls_name, config, _ = GUIDERS[name]
    tguider, jguider = getattr(tg, cls_name)(**config), getattr(jg, cls_name)(**config)
    tguider.save_config(tmp_path / "port")
    jguider.save_config(tmp_path / "jax")
    assert (tmp_path / "port" / "guider_config.json").is_file()
    from_port = getattr(jg, cls_name).from_config(getattr(jg, cls_name).load_config(tmp_path / "port"))
    from_jax = getattr(tg, cls_name).from_pretrained(tmp_path / "jax")

    def plain(guider):
        return json.loads(json.dumps({k: v for k, v in dict(guider.config).items() if not k.startswith("_")}))

    assert plain(from_port) == plain(tguider) == plain(jguider) == plain(from_jax)
    out = from_jax(torch.from_numpy(COND), torch.from_numpy(UNCOND), step=4, num_steps=NUM_STEPS)
    ref = from_port(jnp.asarray(COND), jnp.asarray(UNCOND), step=4, num_steps=NUM_STEPS)
    assert _diff(out, ref) <= ATOL


def test_auto_guidance_needs_layers():
    with pytest.raises(ValueError, match="auto_guidance_layers"):
        tg.AutoGuidance()
