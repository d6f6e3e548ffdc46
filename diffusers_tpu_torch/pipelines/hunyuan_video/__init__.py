from .pipeline_hunyuan_video import DEFAULT_PROMPT_TEMPLATE, HunyuanVideoPipeline, HunyuanVideoPipelineOutput
from .pipeline_hunyuan_video_framepack import FramepackSamplingType, HunyuanVideoFramepackPipeline

__all__ = ["DEFAULT_PROMPT_TEMPLATE", "HunyuanVideoPipeline", "HunyuanVideoPipelineOutput", "FramepackSamplingType",
           "HunyuanVideoFramepackPipeline"]
