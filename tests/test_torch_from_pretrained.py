"""`ModelMixin.from_pretrained` of the port: round trips through the port's
and the JAX package's `save_pretrained`, on the CPU.

The models are the tiny SDXL UNet of tests/test_torch_pipeline_sdxl.py and
the tiny SDXL ControlNet of tests/test_torch_controlnet.py, with the port's
seeded weights. Tolerance: bit-equal state dicts (the loader copies bytes,
casting only where `dtype` asks), in both directions between the packages;
equal weights give equal outputs, as tests/test_torch_controlnet.py holds
the two ControlNets to each other. The port reads safetensors with its own
reader: it loads with the `safetensors` package made unimportable.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from diffusers_tpu.models.controlnets.controlnet import ControlNetModel as JaxControlNetModel
from diffusers_tpu.models.modeling_utils import flatten_to_torch_state_dict
from diffusers_tpu.schedulers import EulerDiscreteScheduler as JaxEulerDiscreteScheduler
from diffusers_tpu_torch.configuration_utils import ConfigMixin, register_to_config
from diffusers_tpu_torch.models.controlnets import ControlNetModel
from diffusers_tpu_torch.models.modeling_utils import ModelMixin, iter_safetensors, save_safetensors
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.pipelines.stable_diffusion_xl import StableDiffusionXLPipeline
from diffusers_tpu_torch.schedulers import EulerDiscreteScheduler
from test_torch_controlnet import CN
from test_torch_pipeline_sdxl import EULER, UNET
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _unet(seed=0):
    torch.manual_seed(seed)
    return UNet2DConditionModel(**UNET).eval()


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("max_shard_size, dtype, variant", [
    ("10GB", torch.float32, None),
    ("20KB", torch.float32, None),
    ("10GB", torch.bfloat16, None),
    ("20KB", torch.bfloat16, "fp16"),
], ids=["f32", "f32-sharded", "bf16", "bf16-sharded-fp16-variant"])
def test_port_round_trip(tmp_path, max_shard_size, dtype, variant):
    model = _unet().to(dtype)
    model.save_pretrained(tmp_path, max_shard_size=max_shard_size, variant=variant)
    names = os.listdir(tmp_path)
    sharded = max_shard_size == "20KB"
    assert any(n.endswith(".index.json") for n in names) == sharded
    assert all((f".{variant}" in n) == bool(variant) for n in names if n != "config.json")
    loaded = UNet2DConditionModel.from_pretrained(tmp_path, variant=variant, device="cpu")
    _assert_same_state(model, loaded)
    assert json.loads(loaded.to_json_string()) == json.loads(model.to_json_string())
    assert not loaded.training and all(p.device.type == "cpu" for p in loaded.parameters())
    if dtype == torch.bfloat16:  # `dtype` casts on load
        upcast = UNet2DConditionModel.from_pretrained(tmp_path, variant=variant, device="cpu", dtype=torch.float32)
        assert upcast.dtype == torch.float32
        assert all(torch.equal(a.float(), b) for a, b in zip(model.state_dict().values(),
                                                               upcast.state_dict().values()))


def _controlnet():
    torch.manual_seed(4)
    return ControlNetModel(**CN).eval()


def test_port_save_then_jax_load(tmp_path):
    model = _controlnet()
    model.save_pretrained(tmp_path, max_shard_size="50KB")
    jm, params = JaxControlNetModel.from_pretrained(str(tmp_path))
    ref = flatten_to_torch_state_dict(jm, params)
    state = model.state_dict()
    assert sorted(ref) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(ref[k]), v.numpy(), err_msg=k)
    assert jm.config.conditioning_embedding_out_channels == list(CN["conditioning_embedding_out_channels"])


def test_jax_save_then_port_load(tmp_path, monkeypatch):
    jm = JaxControlNetModel(**CN)
    from diffusers_tpu.models.modeling_utils import convert_torch_state_dict

    params = convert_torch_state_dict(jm, {k: v.numpy() for k, v in _controlnet().state_dict().items()})
    params = jax.tree_util.tree_map(lambda a: a + 0.25, params)  # weights the port has not seen
    jm.save_pretrained(str(tmp_path), params, max_shard_size="50KB", variant="fp16")
    monkeypatch.setitem(sys.modules, "safetensors", None)  # the port's own reader
    loaded = ControlNetModel.from_pretrained(tmp_path, variant="fp16", device="cpu")
    ref = flatten_to_torch_state_dict(jm, params)
    state = loaded.state_dict()
    assert sorted(ref) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)
    assert loaded.config.conditioning_embedding_out_channels == list(CN["conditioning_embedding_out_channels"])


def test_subfolder_and_scheduler_and_pipeline_components(tmp_path):
    unet = _unet(1)
    unet.save_pretrained(tmp_path / "unet")
    EulerDiscreteScheduler(**EULER, use_karras_sigmas=True).save_pretrained(tmp_path / "scheduler")
    loaded = UNet2DConditionModel.from_pretrained(tmp_path, subfolder="unet", device="cpu", sample_size=16)
    _assert_same_state(unet, loaded)
    assert loaded.config.sample_size == 16  # keyword arguments override the config
    sched = EulerDiscreteScheduler.from_pretrained(tmp_path, subfolder="scheduler")
    assert sched.config.use_karras_sigmas and sched.config.steps_offset == 1
    # JAX reads the port's scheduler config too
    assert JaxEulerDiscreteScheduler.from_pretrained(str(tmp_path), subfolder="scheduler").config.use_karras_sigmas
    # the pipeline-level loader reads the subfolders model_index.json names; components passed in are not loaded
    (tmp_path / "model_index.json").write_text(json.dumps({
        "_class_name": "StableDiffusionXLPipeline", "unet": ["diffusers", "UNet2DConditionModel"],
        "scheduler": ["diffusers", "EulerDiscreteScheduler"], "force_zeros_for_empty_prompt": False}))
    pipe = StableDiffusionXLPipeline.from_pretrained(tmp_path, device="cpu", vae=None, text_encoder=None,
                                                     text_encoder_2=None, tokenizer=None, tokenizer_2=None)
    _assert_same_state(unet, pipe.unet)
    assert pipe.scheduler.config.use_karras_sigmas and pipe.config.force_zeros_for_empty_prompt is False


def _rewrite_weights(path, edit):
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    assert len(files) == 1
    state = dict((k, v.clone()) for k, v in iter_safetensors(os.path.join(path, files[0])))
    edit(state)
    save_safetensors(state, os.path.join(path, files[0]))


class _WithScratch(ModelMixin, ConfigMixin):
    """A model with a non-persistent buffer: outside the state dict, so no
    checkpoint can fill it."""

    @register_to_config
    def __init__(self, width: int = 4):
        super().__init__()
        self.proj = torch.nn.Linear(width, width)
        self.register_buffer("scratch", torch.zeros(width), persistent=False)


def test_mismatched_checkpoints_raise(tmp_path, monkeypatch):
    _unet(2).save_pretrained(tmp_path / "missing")
    _rewrite_weights(tmp_path / "missing", lambda s: s.pop("conv_in.bias"))
    with pytest.raises(ValueError, match=r"missing \['conv_in.bias'\]"):
        UNet2DConditionModel.from_pretrained(tmp_path / "missing", device="cpu")

    _unet(2).save_pretrained(tmp_path / "extra")
    _rewrite_weights(tmp_path / "extra", lambda s: s.update(stray=torch.zeros(3)))
    with pytest.raises(ValueError, match=r"unexpected \['stray'\]"):
        UNet2DConditionModel.from_pretrained(tmp_path / "extra", device="cpu")

    _unet(2).save_pretrained(tmp_path / "shape")
    _rewrite_weights(tmp_path / "shape", lambda s: s.update({"conv_in.bias": torch.zeros(3)}))
    with pytest.raises(ValueError, match="conv_in.bias has shape"):
        UNet2DConditionModel.from_pretrained(tmp_path / "shape", device="cpu")

    _WithScratch().save_pretrained(tmp_path / "meta")
    with pytest.raises(ValueError, match=r"left on the meta device .*scratch"):
        _WithScratch.from_pretrained(tmp_path / "meta", device="cpu")

    with open(tmp_path / "missing" / "config.json") as f:
        assert json.load(f)["_class_name"] == "UNet2DConditionModel"
    for kwarg in ("gguf_file", "mesh"):  # quantization_config: tests/test_torch_pipeline_loading.py
        with pytest.raises(NotImplementedError, match=kwarg):
            UNet2DConditionModel.from_pretrained(tmp_path / "extra", device="cpu", **{kwarg: object()})
    with pytest.raises(EnvironmentError):
        UNet2DConditionModel.from_pretrained(tmp_path / "nowhere", device="cpu")
    # the default device is the card: without one, loading raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNet2DConditionModel.from_pretrained(tmp_path / "extra")
