from .modeling_latent_upsampler import LTXLatentUpsamplerModel
from .pipeline_ltx import LTXPipeline, LTXPipelineOutput
from .pipeline_ltx_condition import LTXConditionPipeline, LTXVideoCondition
from .pipeline_ltx_image2video import LTXImageToVideoPipeline
from .pipeline_ltx_latent_upsample import LTXLatentUpsamplePipeline

__all__ = ["LTXLatentUpsamplerModel", "LTXPipeline", "LTXPipelineOutput", "LTXConditionPipeline", "LTXVideoCondition",
           "LTXImageToVideoPipeline", "LTXLatentUpsamplePipeline"]
