from .pipeline_hunyuan_video1_5 import HunyuanVideo15Pipeline, HunyuanVideo15PipelineOutput
from .pipeline_hunyuan_video1_5_image2video import HunyuanVideo15ImageToVideoPipeline

__all__ = ["HunyuanVideo15Pipeline", "HunyuanVideo15PipelineOutput", "HunyuanVideo15ImageToVideoPipeline"]
