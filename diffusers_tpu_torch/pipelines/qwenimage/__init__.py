from .pipeline_qwenimage import QwenImagePipeline, QwenImagePipelineOutput
from .pipeline_qwenimage_img2img import QwenImageImg2ImgPipeline
from .pipeline_qwenimage_inpaint import QwenImageInpaintPipeline

__all__ = ["QwenImagePipeline", "QwenImagePipelineOutput", "QwenImageImg2ImgPipeline", "QwenImageInpaintPipeline"]
