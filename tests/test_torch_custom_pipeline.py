"""Custom pipelines (`diffusers_tpu_torch.utils.dynamic_modules_utils` through
`DiffusionPipeline.from_pretrained(custom_pipeline=...)`) and the port's CLI
(`diffusers_tpu_torch.commands.diffusers_cli`) on the CPU.

A custom pipeline file written by the test (the port's counterpart of JAX's
`tests/fixtures/custom_pipeline/pipeline.py`) loads from a ``.py`` path, a
folder holding ``pipeline.py`` and a module name inside the checkpoint
folder, behind JAX's two gates (``trust_remote_code`` and
``DIFFUSERS_TPU_DISABLE_REMOTE_CODE``), which refuse the same inputs as
JAX's with the same errors; a hub id raises. The CLI: `env`, `convert` (an
LDM single file written with `chip_smoke.py`'s inverse maps -> a diffusers
folder that loads bit-equal), `fp16_safetensors` (bit-equal to JAX's
command on the same files), `schema`, and `bench` / `custom_blocks`, which
raise.
"""

import argparse
import json
import os
import shutil

import pytest
import torch

import chip_smoke
from diffusers_tpu.commands import diffusers_cli as jcli
from diffusers_tpu.utils import dynamic_modules_utils as jdyn
from diffusers_tpu_torch import DiffusionPipeline
from diffusers_tpu_torch.commands import diffusers_cli as cli
from diffusers_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL
from diffusers_tpu_torch.models.modeling_utils import iter_safetensors
from diffusers_tpu_torch.models.text_encoders.clip import CLIPTextModel
from diffusers_tpu_torch.models.unets.unet_2d_condition import UNet2DConditionModel
from diffusers_tpu_torch.schedulers import DDPMScheduler
from diffusers_tpu_torch.utils import dynamic_modules_utils as dyn
from test_torch_models import CLIP_TINY, SD_TINY
from test_torch_single_file import VAE4

torch.set_num_threads(1)

PIPELINE_PY = '''"""A custom local pipeline: one denoiser call a step, and a marker showing the custom class ran."""

import torch

from diffusers_tpu_torch import DiffusionPipeline


class CustomLocalPipeline(DiffusionPipeline):
    def __init__(self, unet, scheduler, device="cuda"):
        super().__init__()
        self.register_modules(unet=unet, scheduler=scheduler)
        self._place(device)

    @torch.no_grad()
    def __call__(self, num_inference_steps: int = 2, generator=None):
        cfg = self.unet.config
        latents = torch.randn(1, cfg.in_channels, cfg.sample_size, cfg.sample_size, generator=generator)
        context = torch.zeros(1, 4, cfg.cross_attention_dim)
        for t in (999, 500)[:num_inference_steps]:
            latents = latents - 0.1 * self.unet(latents, t, context).sample
        return latents, "This is a local test"
'''


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    UNet2DConditionModel(**SD_TINY).save_pretrained(root / "unet")
    DDPMScheduler(num_train_timesteps=1000).save_pretrained(root / "scheduler")
    (root / "model_index.json").write_text(json.dumps({
        "_class_name": "CustomLocalPipeline", "unet": ["diffusers_tpu_torch", "UNet2DConditionModel"],
        "scheduler": ["diffusers_tpu_torch", "DDPMScheduler"]}))
    code = tmp_path_factory.mktemp("code")
    (code / "pipeline.py").write_text(PIPELINE_PY)
    return str(root), str(code)


@pytest.mark.parametrize("where", ["file", "folder", "inside_checkpoint"])
def test_custom_pipeline_loads_and_runs(checkpoint, where, tmp_path):
    root, code = checkpoint
    if where == "inside_checkpoint":
        local = tmp_path / "ckpt"
        shutil.copytree(root, local)
        shutil.copyfile(os.path.join(code, "pipeline.py"), local / "my_pipeline.py")
        root, custom = str(local), "my_pipeline"
    else:
        custom = os.path.join(code, "pipeline.py") if where == "file" else code
    pipe = DiffusionPipeline.from_pretrained(root, custom_pipeline=custom, trust_remote_code=True, device="cpu")
    assert type(pipe).__name__ == "CustomLocalPipeline" and isinstance(pipe, DiffusionPipeline)
    latents, marker = pipe(generator=torch.Generator().manual_seed(0))
    assert marker == "This is a local test" and latents.shape == (1, 4, 16, 16) and torch.isfinite(latents).all()


def test_custom_pipeline_gates_refuse_as_jax(checkpoint, monkeypatch):
    root, code = checkpoint
    with pytest.raises(ValueError, match="trust_remote_code"):
        DiffusionPipeline.from_pretrained(root, custom_pipeline=code, device="cpu")
    with pytest.raises(EnvironmentError, match="hub"):
        DiffusionPipeline.from_pretrained(root, custom_pipeline="someone/custom-pipeline", trust_remote_code=True,
                                          device="cpu")
    for module in (jdyn, dyn):  # the same inputs refused with the same errors
        with pytest.raises(ValueError, match="trust_remote_code"):
            module.load_dynamic_module(code, trust_remote_code=False)
        with pytest.raises(EnvironmentError, match="No custom module"):
            module.load_dynamic_module(root, "missing.py", trust_remote_code=True)
    monkeypatch.setenv("DIFFUSERS_TPU_DISABLE_REMOTE_CODE", "1")
    for module in (jdyn, dyn):
        with pytest.raises(ValueError, match="DIFFUSERS_TPU_DISABLE_REMOTE_CODE"):
            module.load_dynamic_module(code, trust_remote_code=True)
    with pytest.raises(ValueError, match="DIFFUSERS_TPU_DISABLE_REMOTE_CODE"):
        DiffusionPipeline.from_pretrained(root, custom_pipeline=code, trust_remote_code=True, device="cpu")


def test_get_class_by_name_and_base_class(checkpoint):
    _, code = checkpoint
    by_name = dyn.get_class_from_dynamic_module(code, class_name="CustomLocalPipeline", trust_remote_code=True)
    by_base = dyn.get_class_from_dynamic_module(code, base_class=DiffusionPipeline, trust_remote_code=True)
    assert by_name is by_base and by_name.__module__.startswith(dyn.DYNAMIC_MODULE_NAME)
    with pytest.raises(ValueError, match="class_name or base_class"):
        dyn.get_class_from_dynamic_module(code, trust_remote_code=True)


# ------------------------------------------------------------------ the CLI

def test_env_schema_and_the_unported_commands(checkpoint, capsys):
    cli.main(["env"])
    info = json.loads(capsys.readouterr().out)
    assert info["torch"] == torch.__version__ and info["cuda_available"] == torch.cuda.is_available()
    root, _ = checkpoint
    cli.main(["schema", root])
    schema = json.loads(capsys.readouterr().out)
    assert schema["model_index"]["_class_name"] == "CustomLocalPipeline"
    assert schema["unet"]["block_out_channels"] == list(SD_TINY["block_out_channels"])
    assert "scheduler" not in schema  # its config is scheduler_config.json
    with pytest.raises(NotImplementedError, match="A1"):
        cli.main(["bench"])
    with pytest.raises(NotImplementedError, match="A5.3"):
        cli.main(["custom_blocks", "MyBlock"])


def test_convert_writes_a_diffusers_folder(tmp_path, capsys):
    from diffusers_tpu_torch.models.modeling_utils import save_safetensors

    torch.manual_seed(1)
    models = {"unet": UNet2DConditionModel(**SD_TINY), "vae": AutoencoderKL(**VAE4),
              "text_encoder": CLIPTextModel(**CLIP_TINY)}
    config = tmp_path / "config"
    for name, model in models.items():
        model.save_config(config / name)
    (config / "model_index.json").write_text("{}")
    single = tmp_path / "sd.safetensors"
    save_safetensors({**chip_smoke.ldm_unet_keys(models["unet"].state_dict(), SD_TINY["layers_per_block"]),
                      **chip_smoke.ldm_vae_keys(models["vae"].state_dict()),
                      **chip_smoke.ldm_clip_keys(models["text_encoder"].state_dict(), "cond_stage_model.transformer.")},
                     single)
    out = tmp_path / "out"
    cli.main(["convert", str(single), str(out), "--config", str(config)])
    assert "converted ['unet', 'vae', 'text_encoder']" in capsys.readouterr().out
    assert (out / "model_index.json").exists()
    for name, model in models.items():
        loaded = type(model).from_pretrained(out / name, device="cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (name, k)


def test_fp16_safetensors_matches_jax(tmp_path):
    torch.manual_seed(2)
    model = UNet2DConditionModel(**SD_TINY)
    for side in ("jax", "port"):
        model.save_pretrained(tmp_path / side / "unet")
    jcli.fp16_safetensors_command(argparse.Namespace(path=str(tmp_path / "jax"), variant="fp16"))
    cli.main(["fp16_safetensors", str(tmp_path / "port"), "--variant", "fp16"])
    name = "unet/diffusion_pytorch_model.fp16.safetensors"
    ref, out = dict(iter_safetensors(tmp_path / "jax" / name)), dict(iter_safetensors(tmp_path / "port" / name))
    assert sorted(ref) == sorted(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype == torch.float16 and torch.equal(ref[k], out[k]), k
    loaded = UNet2DConditionModel.from_pretrained(tmp_path / "port" / "unet", variant="fp16", device="cpu")
    assert all(torch.equal(v, model.state_dict()[k].half()) for k, v in loaded.state_dict().items())
