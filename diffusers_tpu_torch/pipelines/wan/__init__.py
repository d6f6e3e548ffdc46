from .pipeline_wan import WanPipeline, WanPipelineOutput
