"""DiffusionPipeline: component container, loading and saving.

Port of `diffusers_tpu/pipelines/pipeline_utils.py`: `register_modules`,
config, `components`, the class registry and `resolve_component_class`
(`:42-265`), `from_pretrained` over `model_index.json` (`:294-404`),
`from_pipe` (`:407-427`), `save_pretrained` (`:429-447`) and FreeU
(`enable_freeu` / `disable_freeu`, `:522-536`), with `custom_pipeline`
(`:329-343`) and LoRA (`PipelineLoraMixin`, `loaders/lora.py`). JAX pipelines
hold ``(module, params)`` pairs; here a weight-bearing component is one
`nn.Module`, and `.to(device, dtype)` moves them all. A pipeline runs on the
card unless its caller asks for the CPU: every pipeline takes ``device``
(default ``"cuda"``) and moves its components there when it is built, and it
raises there if no CUDA device is visible. `from_pretrained` loads each
component straight onto that device. `enable_cache` / `disable_cache` store
a config from `diffusers_tpu_torch.hooks` that the pipeline's denoise loop
honours.

`_cfg_predict` is the step's guidance: the model's prediction on the CFG
batch (uncond first) combined by classifier-free guidance. The pipelines'
denoise loops route their model call through it with the step's (index,
count), and the PAG pipelines (`pipelines.pag.pag_utils.PAGMixin`) override
it to add the perturbed forward.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import tempfile
from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from .. import __version__
from ..configuration_utils import ConfigMixin
from ..loaders.lora import PipelineLoraMixin
from ..models.modeling_utils import ModelMixin
from ..quantizers.auto import PipelineQuantizationConfig
from ..utils import logging

logger = logging.get_logger(__name__)

PIPELINE_CONFIG_NAME = "model_index.json"

# model_index.json class name -> the port's class (the classes the port has)
_CLASS_REGISTRY: Dict[str, str] = {
    "UNet2DConditionModel": "diffusers_tpu_torch.models.unets.unet_2d_condition.UNet2DConditionModel",
    "AutoencoderKL": "diffusers_tpu_torch.models.autoencoders.autoencoder_kl.AutoencoderKL",
    "ControlNetModel": "diffusers_tpu_torch.models.controlnets.controlnet.ControlNetModel",
    "ControlNetUnionModel": "diffusers_tpu_torch.models.controlnets.controlnet_union.ControlNetUnionModel",
    "SD3ControlNetModel": "diffusers_tpu_torch.models.controlnets.controlnet_sd3.SD3ControlNetModel",
    "FluxControlNetModel": "diffusers_tpu_torch.models.controlnets.controlnet_flux.FluxControlNetModel",
    "ReduxImageEncoder": "diffusers_tpu_torch.pipelines.flux.modeling_flux.ReduxImageEncoder",
    "FluxTransformer2DModel": "diffusers_tpu_torch.models.transformers.transformer_flux.FluxTransformer2DModel",
    "SD3Transformer2DModel": "diffusers_tpu_torch.models.transformers.transformer_sd3.SD3Transformer2DModel",
    "WanTransformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_wan.WanTransformer3DModel",
    "WanVACETransformer3DModel":
        "diffusers_tpu_torch.models.transformers.transformer_wan_vace.WanVACETransformer3DModel",
    "WanAnimateTransformer3DModel":
        "diffusers_tpu_torch.models.transformers.transformer_wan_animate.WanAnimateTransformer3DModel",
    "SkyReelsV2Transformer3DModel":
        "diffusers_tpu_torch.models.transformers.transformer_skyreels_v2.SkyReelsV2Transformer3DModel",
    "AutoencoderKLWan": "diffusers_tpu_torch.models.autoencoders.autoencoder_kl_wan.AutoencoderKLWan",
    "QwenImageTransformer2DModel":
        "diffusers_tpu_torch.models.transformers.transformer_qwenimage.QwenImageTransformer2DModel",
    "AutoencoderKLQwenImage":
        "diffusers_tpu_torch.models.autoencoders.autoencoder_kl_qwenimage.AutoencoderKLQwenImage",
    "Qwen2_5_VLForConditionalGeneration": "diffusers_tpu_torch.models.text_encoders.qwen2_vl.Qwen2_5_VLTextEncoder",
    "Qwen2_5_VLTextEncoder": "diffusers_tpu_torch.models.text_encoders.qwen2_vl.Qwen2_5_VLTextEncoder",
    "LlamaModel": "diffusers_tpu_torch.models.text_encoders.llama.LlamaModel",
    "LTXVideoTransformer3DModel": "diffusers_tpu_torch.models.transformers.transformer_ltx.LTXVideoTransformer3DModel",
    "AutoencoderKLLTXVideo": "diffusers_tpu_torch.models.autoencoders.autoencoder_kl_ltx.AutoencoderKLLTXVideo",
    "LTXLatentUpsamplerModel": "diffusers_tpu_torch.pipelines.ltx.modeling_latent_upsampler.LTXLatentUpsamplerModel",
    "HunyuanVideoTransformer3DModel":
        "diffusers_tpu_torch.models.transformers.transformer_hunyuan_video.HunyuanVideoTransformer3DModel",
    "HunyuanVideoFramepackTransformer3DModel": "diffusers_tpu_torch.models.transformers."
                                               "transformer_hunyuan_video_framepack.HunyuanVideoFramepackTransformer3DModel",
    "AutoencoderKLHunyuanVideo":
        "diffusers_tpu_torch.models.autoencoders.autoencoder_kl_hunyuan_video.AutoencoderKLHunyuanVideo",
    "QwenImageControlNetModel":
        "diffusers_tpu_torch.models.controlnets.controlnet_qwenimage.QwenImageControlNetModel",
    "EulerDiscreteScheduler": "diffusers_tpu_torch.schedulers.scheduling_euler_discrete.EulerDiscreteScheduler",
    "FlowMatchEulerDiscreteScheduler":
        "diffusers_tpu_torch.schedulers.scheduling_flow_match_euler_discrete.FlowMatchEulerDiscreteScheduler",
    "UniPCMultistepScheduler": "diffusers_tpu_torch.schedulers.scheduling_unipc_multistep.UniPCMultistepScheduler",
    "DDPMScheduler": "diffusers_tpu_torch.schedulers.scheduling_ddpm.DDPMScheduler",
    "PNDMScheduler": "diffusers_tpu_torch.schedulers.scheduling_pndm.PNDMScheduler",
    "DDIMScheduler": "diffusers_tpu_torch.schedulers.scheduling_ddim.DDIMScheduler",
    "LCMScheduler": "diffusers_tpu_torch.schedulers.scheduling_lcm.LCMScheduler",
    "TCDScheduler": "diffusers_tpu_torch.schedulers.scheduling_tcd.TCDScheduler",
    "T2IAdapter": "diffusers_tpu_torch.models.adapter.T2IAdapter",
    "CLIPTextModel": "diffusers_tpu_torch.models.text_encoders.clip.CLIPTextModel",
    "CLIPTextModelWithProjection": "diffusers_tpu_torch.models.text_encoders.clip.CLIPTextModelWithProjection",
    "CLIPVisionModel": "diffusers_tpu_torch.models.text_encoders.clip.CLIPVisionModel",
    "CLIPVisionModelWithProjection": "diffusers_tpu_torch.models.text_encoders.clip.CLIPVisionModelWithProjection",
    "T5EncoderModel": "diffusers_tpu_torch.models.text_encoders.t5.T5EncoderModel",
    "UMT5EncoderModel": "diffusers_tpu_torch.models.text_encoders.t5.UMT5EncoderModel",
    "SiglipVisionModel": "diffusers_tpu_torch.models.text_encoders.siglip.SiglipVisionModel",
}

# loaded with transformers' own from_pretrained (host-side preprocessing; JAX `_TOKENIZER_CLASSES`)
_TOKENIZER_CLASSES = {
    "CLIPTokenizer", "CLIPTokenizerFast", "T5Tokenizer", "T5TokenizerFast", "AutoTokenizer",
    "GemmaTokenizer", "GemmaTokenizerFast", "Qwen2Tokenizer", "Qwen2TokenizerFast",
    "CLIPImageProcessor", "CLIPFeatureExtractor", "Gemma3Processor", "Qwen2VLProcessor",
    "ByT5Tokenizer", "XLMRobertaTokenizer", "XLMRobertaTokenizerFast", "SiglipImageProcessor",
}


def resolve_component_class(library: Optional[str], class_name: str):
    """(class, kind) of a model_index.json entry: kind "model" (weights), "config"
    (a scheduler) or "tokenizer" (from `transformers`, imported here so the
    package imports where it is absent). The library is not consulted: the
    class name decides, as in the JAX package."""
    if class_name in _CLASS_REGISTRY:
        module_name, _, name = _CLASS_REGISTRY[class_name].rpartition(".")
        cls = getattr(importlib.import_module(module_name), name)
        return cls, "model" if issubclass(cls, ModelMixin) else "config"
    if class_name in _TOKENIZER_CLASSES:
        import transformers

        return getattr(transformers, class_name), "tokenizer"
    raise ValueError(f"{class_name!r} ({library}) is not a class the port has; it loads "
                     f"{sorted(_CLASS_REGISTRY)} and the transformers tokenizers {sorted(_TOKENIZER_CLASSES)}")


def _pipeline_class(root: str):
    """The pipeline class a directory's `model_index.json` names
    (``_class_name``), among the pipelines the package exports."""
    from .. import _EXPORTS

    with open(os.path.join(root, PIPELINE_CONFIG_NAME)) as f:
        name = json.load(f).get("_class_name")
    if name in _EXPORTS:
        pipeline_cls = getattr(importlib.import_module(_EXPORTS[name]), name)
        if isinstance(pipeline_cls, type) and issubclass(pipeline_cls, DiffusionPipeline):
            return pipeline_cls
    raise ValueError(f"{root}: model_index.json names {name!r}, not a pipeline the port has")


def _custom_pipeline_class(root: str, custom_pipeline: str, trust_remote_code: bool):
    """The `DiffusionPipeline` subclass of `custom_pipeline`: a ``.py`` file or
    a folder holding ``pipeline.py`` (as given), else a module name inside
    the checkpoint folder `root`. A hub id raises."""
    from ..utils.dynamic_modules_utils import get_class_from_dynamic_module

    if os.path.isdir(custom_pipeline) or custom_pipeline.endswith(".py"):
        location, module_file = custom_pipeline, "pipeline.py"
    elif "/" in custom_pipeline:
        raise EnvironmentError(f"custom_pipeline={custom_pipeline!r} is not a local file or folder (custom "
                               "pipelines from the hub are not ported)")
    else:
        location, module_file = root, f"{custom_pipeline.removesuffix('.py')}.py"
    return get_class_from_dynamic_module(location, module_file=module_file, trust_remote_code=trust_remote_code,
                                         base_class=DiffusionPipeline)


class DiffusionPipeline(ConfigMixin, PipelineLoraMixin):
    """Base pipeline. Subclasses declare components via `register_modules` in
    __init__ and implement `__call__`. LoRA adapters load onto the
    ``transformer``, ``unet`` and text encoders (`PipelineLoraMixin`)."""

    config_name = PIPELINE_CONFIG_NAME
    _optional_components: list = []
    # components a published model_index.json may name that the port does not have: loaded as None
    _unported_components: tuple = ()

    def register_modules(self, **kwargs):
        for name, module in kwargs.items():
            if module is None:
                register_dict = {name: (None, None)}
            else:
                library = "diffusers_tpu_torch"
                cls_name = module.__class__.__name__
                if cls_name.endswith(("Tokenizer", "TokenizerFast", "ImageProcessor", "ImageProcessorPil")):
                    library = "transformers"
                    # transformers 5 picks an image processor's backend when it loads one: record the public name
                    cls_name = cls_name.removesuffix("Pil")
                register_dict = {name: (library, cls_name)}
            self.register_to_config(**register_dict)
            setattr(self, name, module)

    def _register_image_encoder(self, image_encoder, feature_extractor) -> None:
        """Register the optional IP-Adapter components (published
        model_index.json files list them as ``[null, null]`` or name a CLIP
        vision tower and a `CLIPImageProcessor`): `image_encoder` must be the
        port's `CLIPVisionModelWithProjection` (or None); `feature_extractor`
        a transformers CLIP image processor whose numbers
        `clip_image_preprocess` takes (or None)."""
        from ..models.text_encoders.clip import CLIPVisionModelWithProjection

        if image_encoder is not None and not isinstance(image_encoder, CLIPVisionModelWithProjection):
            raise TypeError(f"{type(self).__name__}: image_encoder must be a CLIPVisionModelWithProjection, got "
                            f"{type(image_encoder).__name__}")
        self.register_modules(image_encoder=image_encoder, feature_extractor=feature_extractor)

    @classmethod
    def _component_names(cls) -> set:
        """The constructor's arguments, less `device`."""
        return set(inspect.signature(cls.__init__).parameters) - {"self", "device"}

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: Union[str, os.PathLike],
        dtype: Optional[torch.dtype] = None,
        variant: Optional[str] = None,
        quantization_config=None,
        device: Union[str, torch.device] = "cuda",
        mesh=None,
        custom_pipeline: Optional[str] = None,
        trust_remote_code: bool = False,
        **kwargs,
    ):
        """Build the pipeline from a local diffusers-format directory (its
        `model_index.json` and one subfolder a component) or a `.dduf`
        archive of one, loading each component straight onto `device`.

        As in the JAX package: a component passed as a keyword argument is
        used as it is and not loaded (``tokenizer=...`` needs no
        `transformers`); a ``[null, null]`` entry loads as None; a plain
        entry (``force_zeros_for_empty_prompt``) passes through; an entry
        the constructor does not take is dropped, and one of
        `_unported_components` (SD's ``safety_checker``) loads as None; `_optional_components`
        missing from the file are None. Models and text encoders load with
        `ModelMixin.from_pretrained(dtype=, variant=, quantization_config=)`
        (`quantization_config` is a `PipelineQuantizationConfig`, read per
        component with `config_for`, or one config for every weight-bearing
        component); schedulers from their config; tokenizers with
        `transformers`' `from_pretrained`.

        `custom_pipeline` builds the pipeline class of outside code, as JAX
        does (`utils.dynamic_modules_utils`, gated by
        ``trust_remote_code=True``): a ``.py`` file, a folder holding
        ``pipeline.py``, or the name of a ``.py`` inside the checkpoint
        folder; the one `DiffusionPipeline` subclass it defines loads the
        checkpoint. Hub ids (for the checkpoint or the custom pipeline) and
        `mesh` are not ported: they raise."""
        if mesh is not None:
            raise NotImplementedError(f"{cls.__name__}.from_pretrained: `mesh` (sharded loading) is not ported "
                                      "yet (ROADMAP A8)")
        root = str(pretrained_model_name_or_path)
        if root.endswith(".dduf") and os.path.isfile(root):
            from ..utils.dduf import extract_dduf

            with tempfile.TemporaryDirectory(prefix="dduf_") as extracted:
                return cls.from_pretrained(extract_dduf(root, extracted), dtype=dtype, variant=variant,
                                           quantization_config=quantization_config, device=device,
                                           custom_pipeline=custom_pipeline, trust_remote_code=trust_remote_code,
                                           **kwargs)
        if not os.path.isdir(root):
            raise EnvironmentError(f"{cls.__name__}.from_pretrained: {root} is not a local directory or a .dduf "
                                   "file (loading from the hub is not ported)")
        if custom_pipeline is not None:
            return _custom_pipeline_class(root, str(custom_pipeline), trust_remote_code).from_pretrained(
                root, dtype=dtype, variant=variant, quantization_config=quantization_config, device=device,
                **kwargs)
        if cls is DiffusionPipeline:  # the class model_index.json names, among the package's pipelines
            return _pipeline_class(root).from_pretrained(root, dtype=dtype, variant=variant,
                                                         quantization_config=quantization_config, device=device,
                                                         **kwargs)
        expected = cls._component_names()
        init_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in expected}  # passed components win
        if kwargs:
            raise TypeError(f"{cls.__name__}.from_pretrained got unexpected arguments {sorted(kwargs)}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{cls.__name__}.from_pretrained: no CUDA device is visible; pass device='cpu' to "
                               "load on the CPU")

        with open(os.path.join(root, PIPELINE_CONFIG_NAME)) as f:
            config_dict = json.load(f)
        for name, value in config_dict.items():
            if name.startswith("_") or name not in expected or name in init_kwargs:
                continue
            if not isinstance(value, (list, tuple)) or len(value) != 2:
                init_kwargs[name] = value  # plain config flag (e.g. force_zeros_for_empty_prompt)
                continue
            if value[0] is None:
                init_kwargs[name] = None
                continue
            if name in cls._unported_components:
                logger.warning(f"{cls.__name__}.from_pretrained: {name} ({value[1]}) is not ported; loaded as None")
                init_kwargs[name] = None
                continue
            component_cls, kind = resolve_component_class(*value)
            if kind == "tokenizer":
                init_kwargs[name] = component_cls.from_pretrained(os.path.join(root, name))
            elif kind == "model":
                component_quant = quantization_config
                if isinstance(quantization_config, PipelineQuantizationConfig):
                    component_quant = quantization_config.config_for(name)
                init_kwargs[name] = component_cls.from_pretrained(
                    root, subfolder=name, dtype=dtype, variant=variant, device=device,
                    quantization_config=component_quant)
            else:
                init_kwargs[name] = component_cls.from_pretrained(root, subfolder=name)

        for name in expected - set(init_kwargs):  # optional components absent from the file
            if name in cls._optional_components:
                init_kwargs[name] = None
        return cls(**init_kwargs, device=device)

    @classmethod
    def from_pipe(cls, pipeline: "DiffusionPipeline", **overrides):
        """Re-bind an existing pipeline's components into a sibling task
        pipeline on the same device with no extra memory: components are
        shared by reference; `overrides` replaces or adds components by
        name."""
        kwargs = {}
        for name in cls._component_names():
            if name in overrides:
                kwargs[name] = overrides.pop(name)
                continue
            comp = getattr(pipeline, name, None)
            if comp is not None:
                kwargs[name] = comp
            elif name in cls._optional_components:
                kwargs[name] = None
        device = overrides.pop("device", pipeline.device)
        if overrides:
            raise ValueError(f"from_pipe got components {list(overrides)} not accepted by {cls.__name__}")
        return cls(**kwargs, device=device)

    def save_pretrained(self, save_directory: Union[str, os.PathLike], max_shard_size: Union[int, str, None] = None):
        """Write `model_index.json` (`_class_name`, `_diffusers_version`, then
        ``[library, class]`` for each component and the plain flags) and each
        component into its subfolder through its own `save_pretrained`:
        models in the diffusers layout, text encoders in the transformers
        layout (both with `max_shard_size` when given),
        schedulers their config, tokenizers through `transformers`. A
        component without `save_pretrained` (a stand-in tokenizer) is
        listed and not written: pass it to `from_pretrained` again."""
        os.makedirs(save_directory, exist_ok=True)
        config = dict(self.config)
        for name in config:
            component = None if name.startswith("_") else getattr(self, name, None)
            sub_dir = os.path.join(save_directory, name)
            if isinstance(component, ModelMixin):
                component.save_pretrained(sub_dir, max_shard_size=max_shard_size)
            elif hasattr(component, "save_pretrained"):
                component.save_pretrained(sub_dir)
            elif component is not None and isinstance(config[name], (list, tuple)):
                logger.warning(f"{name} ({type(component).__name__}) has no save_pretrained: not written")
        config["_class_name"] = type(self).__name__
        config["_diffusers_version"] = __version__
        with open(os.path.join(save_directory, PIPELINE_CONFIG_NAME), "w") as f:
            json.dump({k: list(v) if isinstance(v, tuple) else v for k, v in config.items()}, f, indent=2)
        logger.info(f"Pipeline saved to {save_directory}")

    @property
    def device(self) -> torch.device:
        """The device of the pipeline's models (its first `nn.Module` component's)."""
        for module in self.components.values():
            if isinstance(module, nn.Module):
                return next(module.parameters()).device
        return torch.device("cpu")

    @property
    def components(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.config.keys() if not k.startswith("_")}

    def _place(self, device: Union[str, torch.device]) -> None:
        """Move the components to `device` at construction; a CUDA device
        with no card visible raises (pass ``device="cpu"`` to run on the CPU)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: no CUDA device is visible; pass device='cpu' to run this pipeline on the CPU"
            )
        self.to(device=device)

    def to(self, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None):
        """Move every `nn.Module` component to `device` and/or `dtype`."""
        for module in self.components.values():
            if isinstance(module, nn.Module):
                module.to(device=device, dtype=dtype)
        return self

    # ---------------------------------------------------------------- caches
    # cache-config class names this pipeline's denoise loop honours
    _supported_cache_configs: tuple = ()
    _cache_config = None

    def enable_cache(self, config):
        """Enable a timestep cache for the denoise loop. `config` is one of
        the frozen configs of `diffusers_tpu_torch.hooks`. Raises TypeError
        when this pipeline's loop does not honour it."""
        name = type(config).__name__
        if name not in self._supported_cache_configs:
            raise TypeError(
                f"{type(self).__name__} does not support cache config {name}; "
                f"supported here: {list(self._supported_cache_configs) or 'none'}"
            )
        self._cache_config = config

    def disable_cache(self):
        self._cache_config = None

    # -------------------------------------------------------------- guidance
    def _cfg_predict(self, model_fn, guidance_scale: float, cfg: bool, step, *inputs) -> torch.Tensor:
        """``model_fn(*inputs)``, combined as ``uncond + g (text - uncond)``
        when `cfg` (the inputs then hold the CFG batch, uncond first).
        `step` is the denoise step's (index, count), or None."""
        noise_pred = model_fn(*inputs)
        if not cfg:
            return noise_pred
        uncond, text = noise_pred.chunk(2, dim=0)
        return uncond + guidance_scale * (text - uncond)

    # ----------------------------------------------------------------- FreeU
    def enable_freeu(self, s1: float, s2: float, b1: float, b2: float):
        """FreeU on the UNet's up blocks (`UNet2DConditionModel.enable_freeu`).
        SD 1.5's suggested factors: s1=0.9, s2=0.2, b1=1.2, b2=1.4; SDXL's:
        s1=0.6, s2=0.4, b1=1.1, b2=1.2."""
        unet = getattr(self, "unet", None)
        if unet is None or not hasattr(unet, "enable_freeu"):
            raise AttributeError(f"{type(self).__name__} has no FreeU-capable unet")
        unet.enable_freeu(s1, s2, b1, b2)

    def disable_freeu(self):
        unet = getattr(self, "unet", None)
        if unet is not None and hasattr(unet, "disable_freeu"):
            unet.disable_freeu()
