from .quantize import quantize_kernel_int8, quantize_w8a8
