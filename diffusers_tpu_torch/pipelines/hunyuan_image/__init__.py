from .pipeline_hunyuanimage import HunyuanImagePipeline, HunyuanImagePipelineOutput, extract_glyph_text

__all__ = ["HunyuanImagePipeline", "HunyuanImagePipelineOutput", "extract_glyph_text"]
