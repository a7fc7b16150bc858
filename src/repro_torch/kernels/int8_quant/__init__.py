from repro_torch.kernels.int8_quant.ops import (  # noqa: F401
    GROUP, group_size, int8_dequantize, int8_dequantize_many, int8_quantize,
    int8_quantize_many)
