from .pipeline_tcd import TCDPipeline
