"""diffusers_tpu_torch — the PyTorch + CUDA port of `diffusers_tpu`.

The JAX package (`diffusers_tpu/`) is the reference; this package mirrors its
file layout and class names, speaks PyTorch's idiom (`nn.Module`s with
upstream diffusers' state-dict names, NCHW activations, an explicit `device`,
`torch.Generator` randomness, eager Python denoise loops), and replaces each
Pallas TPU kernel on its path with a kernel written by hand for NVIDIA Hopper
(CUDA C++ under `csrc/`, bound from `ops/cuda/`).

Importing this package never imports `jax` or `diffusers_tpu`, and builds no
kernel: kernels compile on first launch on a CUDA tensor.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "DiffusionPipeline": "diffusers_tpu_torch.pipelines.pipeline_utils",
    "StableDiffusionXLPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion_xl",
    "StableDiffusionPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion",
    "StableDiffusionImg2ImgPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion",
    "StableDiffusionInpaintPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion",
    "StableDiffusionInstructPix2PixPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion",
    "StableDiffusionUpscalePipeline": "diffusers_tpu_torch.pipelines.stable_diffusion",
    "StableDiffusionXLInstructPix2PixPipeline": "diffusers_tpu_torch.pipelines.stable_diffusion_xl",
    "LatentConsistencyModelPipeline": "diffusers_tpu_torch.pipelines.latent_consistency_models",
    "TCDPipeline": "diffusers_tpu_torch.pipelines.tcd",
    "StableDiffusionAdapterPipeline": "diffusers_tpu_torch.pipelines.t2i_adapter",
    "StableDiffusionControlNetPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionControlNetImg2ImgPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionControlNetInpaintPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetImg2ImgPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetInpaintPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetUnionPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetUnionImg2ImgPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusionXLControlNetUnionInpaintPipeline": "diffusers_tpu_torch.pipelines.controlnet",
    "StableDiffusion3ControlNetPipeline": "diffusers_tpu_torch.pipelines.controlnet_sd3",
    "ControlNetModel": "diffusers_tpu_torch.models.controlnets",
    "ControlNetUnionModel": "diffusers_tpu_torch.models.controlnets",
    "MultiControlNetModel": "diffusers_tpu_torch.models.controlnets",
    "MultiControlNetUnionModel": "diffusers_tpu_torch.models.controlnets",
    "SD3ControlNetModel": "diffusers_tpu_torch.models.controlnets",
    "SD3MultiControlNetModel": "diffusers_tpu_torch.models.controlnets",
    "T2IAdapter": "diffusers_tpu_torch.models.adapter",
    "MultiAdapter": "diffusers_tpu_torch.models.adapter",
    "PNDMScheduler": "diffusers_tpu_torch.schedulers",
    "DDIMScheduler": "diffusers_tpu_torch.schedulers",
    "DDPMScheduler": "diffusers_tpu_torch.schedulers",
    "LCMScheduler": "diffusers_tpu_torch.schedulers",
    "TCDScheduler": "diffusers_tpu_torch.schedulers",
    "FluxPipeline": "diffusers_tpu_torch.pipelines.flux.pipeline_flux",
    "FluxImg2ImgPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxInpaintPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxFillPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxKontextPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxKontextInpaintPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlImg2ImgPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlInpaintPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlNetPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlNetImg2ImgPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxControlNetInpaintPipeline": "diffusers_tpu_torch.pipelines.flux",
    "FluxPriorReduxPipeline": "diffusers_tpu_torch.pipelines.flux",
    "ReduxImageEncoder": "diffusers_tpu_torch.pipelines.flux",
    "FluxTransformer2DModel": "diffusers_tpu_torch.models.transformers.transformer_flux",
    "FluxControlNetModel": "diffusers_tpu_torch.models.controlnets.controlnet_flux",
    "FluxMultiControlNetModel": "diffusers_tpu_torch.models.controlnets.controlnet_flux",
    "SiglipVisionModel": "diffusers_tpu_torch.models.text_encoders.siglip",
    "StableDiffusion3Pipeline": "diffusers_tpu_torch.pipelines.stable_diffusion_3",
    "WanPipeline": "diffusers_tpu_torch.pipelines.wan",
    "WanImageToVideoPipeline": "diffusers_tpu_torch.pipelines.wan",
    "WanVideoToVideoPipeline": "diffusers_tpu_torch.pipelines.wan",
    "WanVACEPipeline": "diffusers_tpu_torch.pipelines.wan",
    "WanAnimatePipeline": "diffusers_tpu_torch.pipelines.wan",
    "SkyReelsV2Pipeline": "diffusers_tpu_torch.pipelines.skyreels_v2",
    "CLIPVisionModel": "diffusers_tpu_torch.models.text_encoders.clip",
    "CLIPVisionModelWithProjection": "diffusers_tpu_torch.models.text_encoders.clip",
    "VideoProcessor": "diffusers_tpu_torch.video_processor",
    "WanTransformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_wan",
    "WanVACETransformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_wan_vace",
    "WanAnimateTransformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_wan_animate",
    "SkyReelsV2Transformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_skyreels_v2",
    "AutoencoderKLWan": "diffusers_tpu_torch.models.autoencoders.autoencoder_kl_wan",
    "UMT5EncoderModel": "diffusers_tpu_torch.models.text_encoders.t5",
    "UniPCMultistepScheduler": "diffusers_tpu_torch.schedulers",
    "Int8DynamicActConfig": "diffusers_tpu_torch.quantizers",
    "Int8WeightOnlyConfig": "diffusers_tpu_torch.quantizers",
    "Fp8WeightOnlyConfig": "diffusers_tpu_torch.quantizers",
    "Int4WeightOnlyConfig": "diffusers_tpu_torch.quantizers",
    "PipelineQuantizationConfig": "diffusers_tpu_torch.quantizers",
}


def __getattr__(name):
    """The pipelines and models exported from the root load on first use, so
    importing the package stays light."""
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
